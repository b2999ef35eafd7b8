"""Ordered utilities: ``Table.diff`` (reference ``stdlib/ordered/diff.py``).

``diff(timestamp, *values)`` computes, per row, ``value - previous value`` in
``timestamp`` order (per ``instance``), via the sorted prev/next structure
(``internals/sorting.py``) and pointer chasing with ``ix``.

Carried from ``pathway_tpu/stdlib/ordered/__init__.py``.
"""

from __future__ import annotations


def diff_impl(table, timestamp, *values, instance=None):
    ts = table._bind(timestamp)
    inst = table._bind(instance) if instance is not None else None
    sorted_ptrs = table.sort(ts, instance=inst) if inst is not None else table.sort(ts)
    with_prev = table.with_columns(__prev=sorted_ptrs.prev)
    prev_rows = table.ix(with_prev["__prev"], optional=True)
    out = {}
    for v in values:
        ref = table._bind(v)
        out[f"diff_{ref.name}"] = ref - prev_rows[ref.name]  # reference naming
    return table.select(**out)


__all__ = ["diff_impl"]
