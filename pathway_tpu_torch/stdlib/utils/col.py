"""Column utilities (reference: ``python/pathway/stdlib/utils/col.py``:
``unpack_col``, ``apply_all_rows``, ``multiapply_all_rows``,
``groupby_reduce_majority``).

Carried from ``pathway_tpu/stdlib/utils/col.py``.
"""

from __future__ import annotations

from collections import Counter
from typing import Callable, Sequence

import pathway_tpu_torch as pw


def unpack_col(column, *unpacked_columns, schema=None):
    """Expand a tuple-valued column into one column per element.

    ``unpacked_columns`` are output names (or column refs whose names are
    used); alternatively pass ``schema`` to name+type the outputs.
    """
    if schema is not None and unpacked_columns:
        raise ValueError("unpack_col: pass either unpacked_columns or schema, not both")
    if schema is not None:
        names = schema.column_names()
    else:
        names = [c if isinstance(c, str) else c.name for c in unpacked_columns]
    table = column.table
    kwargs = {
        name: pw.apply(lambda t, i=i: t[i], column) for i, name in enumerate(names)
    }
    return table.select(**kwargs)


def apply_all_rows(
    *cols, fun: Callable[..., Sequence], result_col_name: str
) -> "pw.Table":
    """Apply ``fun`` to entire columns at once (lists, one per column); the
    returned list maps back onto the original rows."""
    return multiapply_all_rows(
        *cols, fun=lambda *cs: (fun(*cs),), result_col_names=[result_col_name]
    )


def multiapply_all_rows(
    *cols, fun: Callable[..., Sequence[Sequence]], result_col_names: list
) -> "pw.Table":
    """Like ``apply_all_rows`` but ``fun`` returns several output columns."""
    assert cols, "multiapply_all_rows needs at least one column"
    table = cols[0].table
    names = [c if isinstance(c, str) else c.name for c in result_col_names]

    tmp = table.select(id_and_cols=pw.apply(lambda i, *vs: (i, *vs), table.id, *cols))
    reduced = tmp.reduce(ids_and_cols=pw.reducers.sorted_tuple(tmp.id_and_cols))

    def fun_wrapped(ids_and_cols):
        ids, *col_lists = zip(*ids_and_cols)
        res = fun(*col_lists)
        return tuple(zip(ids, *res))

    applied = reduced.select(ids_and_res=pw.apply(fun_wrapped, reduced.ids_and_cols))
    flat = applied.flatten(applied.ids_and_res)
    unpacked = unpack_col(flat.ids_and_res, "idd", *names)
    rekeyed = unpacked.with_id(unpacked.idd)
    out = rekeyed.select(**{n: rekeyed[n] for n in names})
    return out.with_universe_of(table)


def groupby_reduce_majority(column_group, column_val):
    """Per group: the most frequent value of ``column_val``
    (reference ``col.py:309``)."""
    table = column_group.table
    pairs = table.groupby(column_group).reduce(
        group=column_group, vals=pw.reducers.tuple(column_val)
    )
    return pairs.select(
        group=pairs.group,
        majority=pw.apply(lambda vs: Counter(vs).most_common(1)[0][0], pairs.vals),
    )
