"""Row-filtering helpers (role of the reference's
``python/pathway/stdlib/utils/filtering.py``: keep, per group, only the row where
``what`` is extreme).

Implementation here: a single extremal reduce drives ``ix`` lookups back into the
source table — the winner row is re-materialized by pointer rather than by
restricting the original universe, so the result's ids are the *group* ids (stable
under winner churn), and no subset promise is needed.

Carried from ``pathway_tpu/stdlib/utils/filtering.py``.
"""

from __future__ import annotations

import pathway_tpu_torch as pw


def _extremal_rows(table: pw.Table, on, what, reducer) -> pw.Table:
    champions = table.groupby(*on).reduce(winner=reducer(what))
    return champions.select(
        **{name: table.ix(champions.winner)[name] for name in table.column_names()}
    )


def argmax_rows(table: pw.Table, *on: pw.ColumnReference, what) -> pw.Table:
    """One row per group of ``on``: the row maximizing ``what``."""
    return _extremal_rows(table, on, what, pw.reducers.argmax)


def argmin_rows(table: pw.Table, *on: pw.ColumnReference, what) -> pw.Table:
    """One row per group of ``on``: the row minimizing ``what``."""
    return _extremal_rows(table, on, what, pw.reducers.argmin)
