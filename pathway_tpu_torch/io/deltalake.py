"""Delta Lake connector (reference ``python/pathway/io/deltalake`` over the
Rust ``DeltaBatchWriter``, ``src/connectors/data_lake/delta.rs:126``).

Implemented directly against the open Delta transaction protocol — a
``_delta_log/`` directory of ordered JSON commits plus parquet data files —
using ``pyarrow`` for parquet. Tables written here carry a
protocol/metaData commit and per-batch ``add`` actions with the standard
Spark ``schemaString``, so delta-rs/Spark readers consume them directly; the
reader replays the commit log (``add``/``remove`` actions) and, in streaming
mode, polls for new versions — each appended version's rows enter the
dataflow with their recorded ``diff``.

Output rows carry the engine's ``time``/``diff`` columns like every other
diff-stream sink (the reference writes the same columns)."""

from __future__ import annotations

import json as _json
import os
import time as _time
import uuid
from typing import Any

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals.table import Table, table_from_static_data

_LOG_DIR = "_delta_log"


def _delta_type(d) -> str:
    d = dt.unoptionalize(d)
    if d == dt.INT:
        return "long"
    if d == dt.FLOAT:
        return "double"
    if d == dt.BOOL:
        return "boolean"
    if d == dt.BYTES:
        return "binary"
    return "string"


def _schema_string(cols: list[str], dtypes: dict) -> str:
    fields = [
        {
            "name": c,
            "type": _delta_type(dtypes.get(c, dt.STR)),
            "nullable": True,
            "metadata": {},
        }
        for c in cols
    ]
    fields += [
        {"name": "time", "type": "long", "nullable": True, "metadata": {}},
        {"name": "diff", "type": "long", "nullable": True, "metadata": {}},
    ]
    return _json.dumps({"type": "struct", "fields": fields})


def _log_path(uri: str, version: int) -> str:
    return os.path.join(uri, _LOG_DIR, f"{version:020d}.json")


def _existing_versions(uri: str) -> list[int]:
    log_dir = os.path.join(uri, _LOG_DIR)
    if not os.path.isdir(log_dir):
        return []
    out = []
    for fn in os.listdir(log_dir):
        stem = fn.split(".")[0]
        if fn.endswith(".json") and stem.isdigit():
            out.append(int(stem))
    return sorted(out)


def write(table: Table, uri: str, *, name: str | None = None, **kwargs: Any) -> None:
    import pyarrow as pa
    import pyarrow.parquet as pq

    from pathway_tpu_torch.engine import operators as ops
    from pathway_tpu_torch.internals.logical import LogicalNode

    cols = table.column_names()
    if "time" in cols or "diff" in cols:
        raise ValueError(
            "pw.io.deltalake.write adds its own time/diff columns; rename the "
            "table's 'time'/'diff' columns before writing"
        )
    dtypes = dict(table._schema.dtypes())
    os.makedirs(os.path.join(uri, _LOG_DIR), exist_ok=True)
    state = {"version": (max(_existing_versions(uri), default=-1))}

    def commit(actions: list[dict]) -> None:
        # Delta's optimistic concurrency: the version file must be CREATED,
        # never overwritten — on conflict, re-scan and retry the next version
        while True:
            state["version"] += 1
            version = state["version"]
            acts = actions
            if version == 0:
                acts = [
                    {
                        "protocol": {"minReaderVersion": 1, "minWriterVersion": 2}
                    },
                    {
                        "metaData": {
                            "id": str(uuid.uuid4()),
                            "format": {"provider": "parquet", "options": {}},
                            "schemaString": _schema_string(cols, dtypes),
                            "partitionColumns": [],
                            "configuration": {},
                            "createdTime": int(_time.time() * 1000),
                        }
                    },
                ] + actions
            payload = "\n".join(_json.dumps(a) for a in acts) + "\n"
            # write the FULL content to a temp file, then atomically link it
            # into place — put-if-absent with content, so a concurrent reader
            # can never observe an empty/truncated version file
            tmp = _log_path(uri, version) + f".tmp{os.getpid()}"
            with open(tmp, "w") as fh:
                fh.write(payload)
            try:
                os.link(tmp, _log_path(uri, version))
            except FileExistsError:
                os.unlink(tmp)
                state["version"] = max(_existing_versions(uri), default=-1)
                continue
            os.unlink(tmp)
            return

    # columns whose dtype maps to Delta "string" get stringified at write so
    # the parquet column type always matches the declared schemaString;
    # _stringify writes the canonical form that read()'s _coerce_back parses
    stringly = {
        c
        for c in cols
        if _delta_type(dtypes.get(c, dt.STR)) == "string"
    }

    def on_batch(batch, columns) -> None:
        from pathway_tpu_torch.engine.blocks import column_to_list

        n = len(batch)
        if not n:
            return
        arrays: dict[str, list] = {}
        for c in cols:  # one C-speed pass per column, no per-row loop
            vals = column_to_list(batch.data[c])
            if c in stringly:
                vals = [_stringify(v) for v in vals]
            arrays[c] = vals
        arrays["time"] = [batch.time] * n
        arrays["diff"] = batch.diffs.tolist()
        part = f"part-{state['version'] + 1:05d}-{uuid.uuid4()}.snappy.parquet"
        fpath = os.path.join(uri, part)
        pq.write_table(pa.table(arrays), fpath)
        commit(
            [
                {
                    "add": {
                        "path": part,
                        "partitionValues": {},
                        "size": os.path.getsize(fpath),
                        "modificationTime": int(_time.time() * 1000),
                        "dataChange": True,
                    }
                }
            ]
        )

    LogicalNode(
        lambda: ops.CallbackOutputNode(cols, on_batch),
        [table._node],
        name=name or f"deltalake_write:{uri}",
    )._register_as_output()


def _plain(v):
    """Numpy-free canonical form of a cell for tuple stringification: the
    result's ``repr`` must survive ``ast.literal_eval`` (numpy-2 scalar reprs
    like ``np.int64(1)`` do not)."""
    import numpy as np

    if isinstance(v, np.datetime64):
        return str(v.astype("datetime64[ns]"))
    if isinstance(v, np.timedelta64):
        return int(v.astype("timedelta64[ns]").astype(np.int64))
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, (tuple, list)):
        return tuple(_plain(e) for e in v)
    return v


def _stringify(v) -> str | None:
    """Canonical string form for a Delta 'string'-typed cell, chosen so
    ``_coerce_back`` can recover the original value: durations as integer
    nanoseconds, datetimes as numpy ISO, Json as compact JSON, tuples as
    literal_eval-able reprs of plain-Python elements."""
    import numpy as np

    if v is None:
        return None
    if isinstance(v, np.timedelta64):
        return str(int(v.astype("timedelta64[ns]").astype(np.int64)))
    if isinstance(v, (tuple, list)):
        return repr(_plain(v))
    return str(v)


def _make_coercer(d):
    """One converter per column dtype (not per cell): the inverse of the
    write-side stringification (round-trips must not silently
    yield str where the schema says datetime/duration/tuple/JSON)."""
    import numpy as np

    from pathway_tpu_torch.io._format import coerce_scalar

    d = dt.unoptionalize(d)
    if d in (dt.DATE_TIME_NAIVE, dt.DATE_TIME_UTC):
        def conv(v):
            try:
                return np.datetime64(v)
            except ValueError:
                return v
        return conv
    if d == dt.DURATION:
        def conv(v):
            try:
                return np.timedelta64(int(v), "ns")
            except (ValueError, TypeError):
                return v
        return conv
    if isinstance(d, dt.Tuple):
        import ast

        # element-wise coercers for fixed-arity tuples (ANY_TUPLE has none)
        elem_convs = [_make_coercer(a) for a in d.args] if d.args else None

        def conv(v):
            try:
                parsed = ast.literal_eval(v)
            except (ValueError, SyntaxError):
                return v
            if not isinstance(parsed, (tuple, list)):
                return v
            parsed = tuple(parsed)
            if elem_convs is not None and len(elem_convs) == len(parsed):
                return tuple(c(e) for c, e in zip(elem_convs, parsed))
            return parsed
        return conv
    return lambda v: coerce_scalar(v, d)


def _version_rows(
    uri: str, version: int, schema_cols: list[str], dtypes: dict | None = None
) -> list[tuple]:
    """(values-tuple, diff) rows added by one commit version, coerced back to
    the declared schema dtypes."""
    import pyarrow.parquet as pq

    dtypes = dtypes or {}
    # columns needing value coercion (everything Delta stores as 'string'
    # except true STR columns, plus ints/floats pyarrow may widen)
    coercers = {
        c: _make_coercer(dtypes[c])
        for c in schema_cols
        if c in dtypes and dt.unoptionalize(dtypes[c]) not in (dt.STR, dt.ANY)
    }
    rows: list[tuple] = []
    with open(_log_path(uri, version)) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            action = _json.loads(line)
            if "add" in action:
                t = pq.read_table(os.path.join(uri, action["add"]["path"]))
                data = {c: t.column(c).to_pylist() for c in t.column_names}
                n = t.num_rows
                diffs = data.get("diff") or [1] * n
                col_lists = [data.get(c) or [None] * n for c in schema_cols]
                for c_idx, c in enumerate(schema_cols):
                    conv = coercers.get(c)
                    if conv is not None and data.get(c) is not None:
                        col_lists[c_idx] = [
                            None if v is None else conv(v) for v in col_lists[c_idx]
                        ]
                rows.extend(
                    zip(zip(*col_lists) if col_lists else [()] * n, map(int, diffs))
                )
    return rows


def read(
    uri: str,
    *,
    schema: schema_mod.SchemaMetaclass,
    mode: str = "streaming",
    autocommit_duration_ms: int | None = None,
    name: str | None = None,
    **kwargs: Any,
) -> Table:
    cols = schema.column_names()
    if mode not in ("static", "streaming"):
        raise ValueError(f"unknown deltalake read mode {mode!r}")

    if mode == "static":
        from pathway_tpu_torch.io.fs import _keys_for

        net: dict[tuple, int] = {}
        order: list[tuple] = []
        for v in _existing_versions(uri):
            for r, d in _version_rows(uri, v, cols, schema.dtypes()):
                if r not in net:
                    order.append(r)
                net[r] = net.get(r, 0) + d
        all_rows = [r for r in order for _ in range(max(net[r], 0))]
        keys = _keys_for(all_rows, schema, salt=hash(uri) & 0xFFFF)
        return table_from_static_data(keys, all_rows, schema)

    from pathway_tpu_torch.internals.keys import stable_hash_obj
    from pathway_tpu_torch.io.fs import _keys_for
    from pathway_tpu_torch.io.python import ConnectorSubject, read as py_read

    pks = schema.primary_key_columns()

    class _DeltaSubject(ConnectorSubject):
        def __init__(self) -> None:
            super().__init__()
            self._next_version = 0
            self._stop = False
            self._bounded = kwargs.get("_bounded", False)

        def run(self) -> None:
            while not self._stop:
                versions = [
                    v for v in _existing_versions(uri) if v >= self._next_version
                ]
                found = False
                for v in versions:
                    found = True
                    vrows = _version_rows(uri, v, cols, schema.dtypes())
                    if not vrows:
                        self._next_version = v + 1
                        continue
                    values_list = [r for r, _d in vrows]
                    if pks:
                        # primary-key keys: streaming and static modes agree,
                        # and updates surface as in-place retract+insert
                        keys_ = _keys_for(values_list, schema, salt=0)
                    else:
                        # content-derived: a replayed retraction must net
                        # against its insert (sequential keys never match)
                        keys_ = [int(stable_hash_obj(r)) for r in values_list]
                    assert self._node is not None
                    self._node.push_many(
                        (int(k), r, d)
                        for k, (r, d) in zip(keys_, vrows)
                    )
                    self._next_version = v + 1
                if self._bounded and not found:
                    return
                _time.sleep(0.1)

        # persistence contract: the committed version is the offset
        def offset_state(self) -> dict:
            return {"next_version": self._next_version, "seq": self._seq}

        def seek(self, state: dict) -> None:
            self._next_version = int(state.get("next_version", 0))
            self._seq = int(state.get("seq", 0))

        def on_stop(self) -> None:
            self._stop = True

    return py_read(
        _DeltaSubject(),
        schema=schema,
        autocommit_duration_ms=autocommit_duration_ms,
        name=name or f"deltalake:{uri}",
    )
