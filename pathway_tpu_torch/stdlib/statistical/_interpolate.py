"""Linear interpolation over a timestamp-ordered column
(reference: ``python/pathway/stdlib/statistical/_interpolate.py``).

Design difference from the reference: its fixed point copies the nearest known
value one *hop* per round (O(gap) rounds for a gap of missing rows). Here each
round also **jumps the pointer** to the neighbor's pointer (pointer doubling),
so a gap of g rows converges in O(log g) rounds of the ``pw.iterate`` engine —
the classic parallel list-ranking trick, which matters when the fixed point is
a dataflow round, not a loop iteration.

Carried from ``pathway_tpu/stdlib/statistical/_interpolate.py``. It runs the
fixed point of ``internals/iterate.py`` (``pw.iterate``) directly.
"""

from __future__ import annotations

from enum import Enum

import pathway_tpu_torch as pw
from pathway_tpu_torch.internals.iterate import iterate


class InterpolateMode(Enum):
    LINEAR = 0


def _missing(v) -> bool:
    # Optional[float] columns store None as NaN; both mean "no value here"
    return v is None or (isinstance(v, float) and v != v)


def _propagate(t: pw.Table) -> pw.Table:
    prev_row = t.ix(t.prev_ptr, optional=True)
    next_row = t.ix(t.next_ptr, optional=True)
    return t.select(
        # adopt the neighbor's known (t, v) when ours is missing
        prev_t=pw.coalesce(t.prev_t, prev_row.prev_t),
        prev_v=pw.coalesce(t.prev_v, prev_row.prev_v),
        next_t=pw.coalesce(t.next_t, next_row.next_t),
        next_v=pw.coalesce(t.next_v, next_row.next_v),
        # pointer doubling: if still unresolved, look twice as far next round
        prev_ptr=pw.if_else(t.prev_v.is_not_none(), t.prev_ptr, prev_row.prev_ptr),
        next_ptr=pw.if_else(t.next_v.is_not_none(), t.next_ptr, next_row.next_ptr),
    )


def _nearest_known(table: pw.Table, ts_ref, value_ref) -> pw.Table:
    """Per row: timestamp+value of the nearest known (non-None) row on each
    side, itself included — rows with a value resolve to themselves, which is
    fine because ``lerp`` short-circuits on them."""
    ordered = table.sort(key=ts_ref)
    known_t = pw.apply(lambda t, v: None if _missing(v) else float(t), ts_ref, value_ref)
    known_v = pw.apply(lambda v: None if _missing(v) else float(v), value_ref)
    seeded = ordered.select(
        prev_ptr=ordered.prev,
        next_ptr=ordered.next,
        prev_t=known_t,
        prev_v=known_v,
        next_t=known_t,
        next_v=known_v,
    )
    # iterate preserves row keys; re-assert the universe for same-universe selects
    return iterate(_propagate, t=seeded).with_universe_of(table)


def interpolate(
    self: pw.Table,
    timestamp,
    *values,
    mode: InterpolateMode = InterpolateMode.LINEAR,
):
    """Fill None values of ``*values`` columns by linear interpolation between
    the nearest known neighbors in ``timestamp`` order; boundary gaps take the
    single known neighbor."""
    if mode != InterpolateMode.LINEAR:
        raise ValueError(
            "interpolate: Invalid mode. Only InterpolateMode.LINEAR is currently available."
        )
    ts_ref = self._bind(timestamp)
    out = self
    for v in values:
        v_ref = self._bind(v)
        near = _nearest_known(self, ts_ref, v_ref)

        def lerp(t, v, t_prev, v_prev, t_next, v_next):
            if not _missing(v):
                return float(v)
            if _missing(v_prev) and _missing(v_next):
                return None
            if _missing(v_prev):
                return v_next
            if _missing(v_next):
                return v_prev
            if t_next == t_prev:
                return v_prev
            return v_prev + (float(t) - t_prev) * (v_next - v_prev) / (t_next - t_prev)

        filled = pw.apply(
            lerp, ts_ref, v_ref, near.prev_t, near.prev_v, near.next_t, near.next_v
        )
        out = out.with_columns(**{v_ref.name: filled})
    return out
