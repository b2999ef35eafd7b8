"""Debug & test toolkit.

Mirrors the reference's ``python/pathway/debug/__init__.py``
(``table_from_markdown:446``, ``table_from_pandas:358``, ``table_from_rows:327``,
``compute_and_print:222``, ``table_to_pandas``, ``compute_and_print_update_stream``):
static fixtures in, captured results out — the core unit-testing surface.
"""

from __future__ import annotations

import re
from typing import Any, Iterable

import numpy as np

from pathway_tpu_torch.engine import operators as ops
from pathway_tpu_torch.engine.runtime import Runtime
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals.keys import row_keys, sequential_keys
from pathway_tpu_torch.internals.logical import LogicalNode
from pathway_tpu_torch.internals.table import Table, table_from_static_data


def _parse_value(tok: str) -> Any:
    if tok == "" or tok == "None":
        return None
    if tok in ("True", "true"):
        return True
    if tok in ("False", "false"):
        return False
    try:
        return int(tok)
    except ValueError:
        pass
    try:
        return float(tok)
    except ValueError:
        pass
    if len(tok) >= 2 and tok[0] == tok[-1] and tok[0] in "\"'":
        return tok[1:-1]
    return tok


def table_from_markdown(
    table_def: str,
    *,
    id_from: list[str] | None = None,
    unsafe_trusted_ids: bool = False,
    schema: schema_mod.SchemaMetaclass | None = None,
    _stream_times: dict | None = None,
) -> Table:
    """Parse a whitespace- or pipe-separated table literal into a static table."""
    lines = [ln.strip() for ln in table_def.strip().splitlines()]
    lines = [ln for ln in lines if ln and not re.fullmatch(r"[|\s:-]+", ln)]
    rows_tok: list[list[str]] = []
    for ln in lines:
        if "|" in ln:
            toks = [t.strip() for t in ln.strip("|").split("|")]
        else:
            import shlex

            try:
                toks = shlex.split(ln, posix=False)
            except ValueError:
                toks = ln.split()
        rows_tok.append(toks)
    header = rows_tok[0]
    body = rows_tok[1:]
    columns = [h for h in header]
    # reference style: empty leading header cell = id column ("  | a | b" over
    # rows "1 | x | y"); detect by body rows carrying one extra token
    if body and all(len(r) == len(columns) + 1 for r in body) and "id" not in columns:
        columns = ["id"] + columns
    parsed = [[_parse_value(t) for t in row] for row in body]

    id_idx = columns.index("id") if "id" in columns else None
    time_idx = columns.index("__time__") if "__time__" in columns else None
    diff_idx = columns.index("__diff__") if "__diff__" in columns else None
    special = {i for i in (id_idx, time_idx, diff_idx) if i is not None}
    data_cols = [c for i, c in enumerate(columns) if i not in special]

    if schema is not None:
        sch = schema
        dtypes = sch.dtypes()
    else:
        dtypes = {}
        for i, c in enumerate(columns):
            if i in special:
                continue
            vals = [row[i] for row in parsed]
            d: dt.DType = dt.ANY
            non_null = [v for v in vals if v is not None]
            if non_null:
                cand = dt.dtype_of_value(non_null[0])
                if all(dt.dtype_of_value(v) == cand for v in non_null):
                    d = cand
                elif all(isinstance(v, (int, float)) for v in non_null):
                    d = dt.FLOAT
            if any(v is None for v in vals):
                d = dt.Optional(d)
            dtypes[c] = d
        sch = schema_mod.schema_from_dtypes(dtypes, primary_keys=id_from)

    rows = [tuple(row[columns.index(c)] for c in data_cols) for row in parsed]
    # keys
    if id_idx is not None:
        from pathway_tpu_torch.internals.keys import stable_hash_obj

        def label_key(v: Any) -> int:
            if isinstance(v, (int, np.integer)) and 0 <= int(v) < 2**64:
                return int(np.uint64(v))
            return int(stable_hash_obj(v))

        keys = [label_key(row[id_idx]) for row in parsed]
    elif id_from:
        cols_for_id = []
        for c in id_from:
            ci = data_cols.index(c)
            arr = np.empty(len(rows), dtype=object)
            arr[:] = [r[ci] for r in rows]
            cols_for_id.append(arr)
        keys = [int(k) for k in row_keys(cols_for_id, n=len(rows))]
    elif time_idx is not None:
        # stream fixture: keys derive from row values so a later retraction row
        # addresses the same engine row it inserted
        arrays = []
        for ci in range(len(data_cols)):
            a = np.empty(len(rows), dtype=object)
            a[:] = [r[ci] for r in rows]
            arrays.append(a)
        keys = [int(k) for k in row_keys(arrays, n=len(rows))]
    else:
        keys = [int(k) for k in sequential_keys(0, len(rows))]

    if time_idx is not None:
        # streamed fixture: rows arrive at given logical times with given diffs
        from pathway_tpu_torch.io.python import _StaticStreamSubject, read_subject

        events = []
        for key, row_raw, row in zip(keys, parsed, rows):
            t = int(row_raw[time_idx])
            diff = int(row_raw[diff_idx]) if diff_idx is not None else 1
            events.append((t, key, row, diff))
        events.sort(key=lambda e: e[0])
        return read_subject(_StaticStreamSubject(events, data_cols), schema=sch)
    return table_from_static_data(keys, rows, sch)


def parse_to_table(*args: Any, **kwargs: Any) -> Table:
    return table_from_markdown(*args, **kwargs)


def table_from_rows(
    schema: schema_mod.SchemaMetaclass,
    rows: list[tuple],
    unsafe_trusted_ids: bool = False,
    is_stream: bool = False,
) -> Table:
    cols = schema.column_names()
    pks = schema.primary_key_columns()
    if is_stream:
        # rows are (…values, time, diff)
        from pathway_tpu_torch.io.python import _StaticStreamSubject, read_subject

        seq_keys = None if pks else sequential_keys(0, len(rows))
        events = []
        for i, r in enumerate(rows):
            values, t, diff = r[: len(cols)], r[-2], r[-1]
            if pks:
                key = int(row_keys([np.asarray([values[cols.index(pk)]], dtype=object) for pk in pks], n=1)[0])
            else:
                key = int(seq_keys[i])
            events.append((int(t), key, tuple(values), int(diff)))
        events.sort(key=lambda e: e[0])
        return read_subject(_StaticStreamSubject(events, cols), schema=schema)
    if pks:
        keys = [
            int(
                row_keys(
                    [np.asarray([r[cols.index(pk)]], dtype=object) for pk in pks], n=1
                )[0]
            )
            for r in rows
        ]
    else:
        keys = [int(k) for k in sequential_keys(0, len(rows))]
    return table_from_static_data(keys, [tuple(r[: len(cols)]) for r in rows], schema)


def table_from_pandas(
    df: "pd.DataFrame",
    *,
    id_from: list[str] | None = None,
    unsafe_trusted_ids: bool = False,
    schema: schema_mod.SchemaMetaclass | None = None,
) -> Table:
    if schema is None:
        schema = schema_mod.schema_from_pandas(df, id_from=id_from)
    cols = schema.column_names()
    rows = []
    for _, r in df.iterrows():
        rows.append(tuple(_from_pandas_value(r[c]) for c in cols))
    if id_from:
        arrays = []
        for c in id_from:
            arr = np.empty(len(rows), dtype=object)
            arr[:] = [r[cols.index(c)] for r in rows]
            arrays.append(arr)
        keys = [int(k) for k in row_keys(arrays, n=len(rows))]
    else:
        keys = [int(k) for k in sequential_keys(0, len(rows))]
    return table_from_static_data(keys, rows, schema)


def _from_pandas_value(v: Any) -> Any:
    import pandas as pd

    if isinstance(v, np.generic):
        return v.item()
    if v is pd.NaT:
        return None
    if isinstance(v, float) and np.isnan(v):
        return None
    if isinstance(v, pd.Timestamp):
        return np.datetime64(v.to_datetime64())
    if isinstance(v, pd.Timedelta):
        return np.timedelta64(v.to_timedelta64())
    return v


class CapturedTable:
    def __init__(self, columns: list[str], node: ops.CaptureNode):
        self.columns = columns
        self._node = node

    @property
    def rows(self) -> dict[int, tuple]:
        return self._node.current

    @property
    def deltas(self) -> list[tuple[int, int, int, tuple]]:
        return self._node.deltas


def _capture(table: Table, **run_kwargs: Any) -> CapturedTable:
    cols = table.column_names()
    holder: dict[str, ops.CaptureNode] = {}

    def factory() -> ops.CaptureNode:
        node = ops.CaptureNode(cols)
        holder["node"] = node
        return node

    lnode = LogicalNode(factory, [table._node], name="capture")
    from pathway_tpu_torch.internals.run import make_runtime

    runtime = make_runtime(
        n_workers=run_kwargs.pop("n_workers", None),
        autocommit_duration_ms=run_kwargs.pop("autocommit_duration_ms", 5),
    )
    # debug capture always inspects ERROR values rather than aborting —
    # regardless of what policy an earlier pw.run left behind
    from pathway_tpu_torch.internals import errors as _errors

    prev_policy = _errors.get_error_policy()
    _errors.set_error_policy(False)
    try:
        runtime.run([lnode])
    finally:
        _errors.set_error_policy(prev_policy)
    return CapturedTable(cols, holder["node"])


def _fmt_value(v: Any) -> str:
    if isinstance(v, np.uint64) or (isinstance(v, int) and v > 2**53):
        return f"^{int(v):016X}"[:13]
    if isinstance(v, np.generic):
        v = v.item()
    if isinstance(v, float):
        return repr(v)
    if v is None:
        return ""
    return str(v)


def compute_and_print(
    table: Table,
    *,
    include_id: bool = True,
    short_pointers: bool = True,
    n_rows: int | None = None,
    **kwargs: Any,
) -> None:
    cap = _capture(table)
    cols = cap.columns
    items = sorted(cap.rows.items(), key=lambda kv: kv[0])
    if n_rows is not None:
        items = items[:n_rows]
    header = (["id", "|"] + cols) if include_id else cols
    lines = []
    for key, row in items:
        cells = ([f"^{key:016X}"[:9], "|"] if include_id else []) + [
            _fmt_value(v) for v in row
        ]
        lines.append(cells)
    widths = [
        max(len(str(h)), *(len(r[i]) for r in lines)) if lines else len(str(h))
        for i, h in enumerate(header)
    ]
    print(" ".join(str(h).ljust(w) for h, w in zip(header, widths)).rstrip())
    for cells in lines:
        print(" ".join(c.ljust(w) for c, w in zip(cells, widths)).rstrip())


def compute_and_print_update_stream(table: Table, **kwargs: Any) -> None:
    cap = _capture(table)
    cols = cap.columns + ["__time__", "__diff__"]
    print(" | ".join(["id"] + cols))
    for time, key, diff, row in cap.deltas:
        print(" | ".join([f"^{key:016X}"[:9]] + [_fmt_value(v) for v in row] + [str(time), str(diff)]))


def table_to_pandas(table: Table, include_id: bool = True) -> "pd.DataFrame":
    import pandas as pd

    cap = _capture(table)
    items = sorted(cap.rows.items(), key=lambda kv: kv[0])
    data = {c: [row[i] for _, row in items] for i, c in enumerate(cap.columns)}
    if include_id:
        return pd.DataFrame(data, index=[k for k, _ in items])
    return pd.DataFrame(data)


def table_to_dicts(table: Table):
    cap = _capture(table)
    keys = list(cap.rows.keys())
    columns = {
        c: {k: cap.rows[k][i] for k in keys} for i, c in enumerate(cap.columns)
    }
    return keys, columns


def diff_tables(expected: Table, actual: Table) -> bool:
    e = _capture(expected)
    a = _capture(actual)
    return e.rows == a.rows
