"""``@pw.pandas_transformer`` (reference: ``stdlib/utils/pandas_transformer.py``)
— run a pandas function over whole tables, re-entering the dataflow as a table.

The function receives each input table as a ``pandas.DataFrame`` (indexed by
row key) and returns a DataFrame; the output table is keyed by the returned
index. Like the reference, this materializes the full table per update — meant
for small control-plane tables, not the hot path.

Carried from ``pathway_tpu/stdlib/utils/pandas_transformer.py``.
"""

from __future__ import annotations

from typing import Any, Callable

import pathway_tpu_torch as pw


def pandas_transformer(
    output_schema: Any, output_universe: Any = None
) -> Callable:
    """Decorator: ``fn(*dataframes) -> DataFrame`` becomes
    ``fn(*tables) -> Table`` with ``output_schema``."""
    if output_universe is not None:
        raise NotImplementedError(
            "pandas_transformer: output_universe pinning is not supported yet "
            "(the output is keyed by the returned DataFrame index)"
        )

    def wrapper(fn: Callable) -> Callable:
        def transformer(*tables: "pw.Table") -> "pw.Table":
            import pandas as pd

            packed = []
            for t in tables:
                cols = t.column_names()
                tmp = t.select(
                    packed=pw.apply(lambda i, *vs: (i, *vs), t.id, *[t[c] for c in cols])
                )
                packed.append(
                    (cols, tmp.reduce(rows=pw.reducers.sorted_tuple(tmp.packed)))
                )
            if len(packed) > 1:
                raise NotImplementedError(
                    "pandas_transformer over multiple tables is not supported yet"
                )
            cols, reduced = packed[0]
            out_cols = output_schema.column_names()

            def run(rows):
                idx = [r[0] for r in rows]
                df = pd.DataFrame(
                    {c: [r[1 + j] for r in rows] for j, c in enumerate(cols)},
                    index=idx,
                )
                result = fn(df)
                return tuple(
                    (int(i),) + tuple(result.iloc[pos][c] for c in out_cols)
                    for pos, i in enumerate(result.index)
                )

            applied = reduced.select(out=pw.apply(run, reduced.rows))
            flat = applied.flatten(applied.out)
            unpacked = flat.select(
                idd=pw.apply(lambda r: r[0], flat.out),
                **{
                    c: pw.apply(lambda r, j=j: r[1 + j], flat.out)
                    for j, c in enumerate(out_cols)
                },
            )
            rekeyed = unpacked.with_id(unpacked.idd)
            return rekeyed.select(**{c: rekeyed[c] for c in out_cols}).update_types(
                **output_schema.typehints()
            )

        return transformer

    return wrapper
