"""Window join: pair rows whose times fall in the same window.

Reference ``stdlib/temporal/_window_join.py:156``: assign tumbling/sliding windows
to both sides' time columns, then equi-join on (window, *on). Built from the same
assignment program as ``windowby`` plus the standard hash join.

Carried from ``pathway_tpu/stdlib/temporal/_window_join.py``.
"""

from __future__ import annotations

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.expression import ColumnExpression, ColumnReference
from pathway_tpu_torch.stdlib.temporal._window import _SlidingWindow, _TumblingWindow


def _rebind(e, old_table, new_table):
    if isinstance(e, ColumnReference):
        if e.table is old_table:
            return new_table[e.name]
        return e
    args = e._args()
    if not args:
        return e
    return e._with_args(tuple(_rebind(a, old_table, new_table) for a in args))


def window_join(left, right, left_time, right_time, window, *on, how="inner"):
    import pathway_tpu_torch as pw

    if isinstance(window, _TumblingWindow):
        hop, duration, origin = window.duration, window.duration, window.origin
    elif isinstance(window, _SlidingWindow):
        hop, duration, origin = window.hop, window.duration, window.origin
    else:
        raise ValueError("window_join supports tumbling/sliding windows")

    def assign(t):
        if t is None:
            return ()
        base = 0 if origin is None else origin
        last_k = int((t - base) // hop)
        first_k = last_k - int(duration // hop) - 1
        out = []
        for k in range(first_k, last_k + 2):
            start = base + k * hop
            if start <= t < start + duration and (origin is None or start >= origin):
                out.append((start, start + duration))
        return tuple(out)

    def widen(table, time_expr):
        t = table.with_columns(
            _pw_window=pw.apply_with_type(
                assign, dt.List(dt.Tuple(dt.ANY, dt.ANY)), table._bind(time_expr)
            )
        )
        t = t.flatten(t._pw_window)
        return t.with_columns(
            _pw_window_start=pw.this._pw_window.get(0),
            _pw_window_end=pw.this._pw_window.get(1),
        )

    lw = widen(left, left_time)
    rw = widen(right, right_time)
    conds = [lw._pw_window_start == rw._pw_window_start]
    for cond in on:
        if isinstance(cond, ColumnReference):
            conds.append(lw[cond.name] == rw[cond.name])
        else:
            conds.append(_rebind(_rebind(cond, left, lw), right, rw))
    return _WindowJoinResult(lw.join(rw, *conds, how=how), left, lw, right, rw)


class _WindowJoinResult:
    """Delegates to the widened-tables JoinResult, rebinding user expressions that
    reference the ORIGINAL tables onto the widened copies."""

    def __init__(self, inner, left, lw, right, rw):
        self._inner = inner
        self._pairs = [(left, lw), (right, rw)]

    def _map(self, e):
        for old, new in self._pairs:
            if hasattr(e, "_args") or isinstance(e, ColumnReference):
                e = _rebind(e, old, new)
        return e

    def select(self, *args, **kwargs):
        args = [self._map(a) if isinstance(a, ColumnExpression) else a for a in args]
        kwargs = {
            n: self._map(e) if isinstance(e, ColumnExpression) else e
            for n, e in kwargs.items()
        }
        return self._inner.select(*args, **kwargs)

    def filter(self, e):
        return _WindowJoinResult(
            self._inner.filter(self._map(e) if isinstance(e, ColumnExpression) else e),
            *[x for p in self._pairs for x in p],
        )

    def reduce(self, *args, **kwargs):
        args = [self._map(a) if isinstance(a, ColumnExpression) else a for a in args]
        kwargs = {
            n: self._map(e) if isinstance(e, ColumnExpression) else e
            for n, e in kwargs.items()
        }
        return self._inner.reduce(*args, **kwargs)


def window_join_inner(left, right, lt, rt, window, *on):
    return window_join(left, right, lt, rt, window, *on, how="inner")


def window_join_left(left, right, lt, rt, window, *on):
    return window_join(left, right, lt, rt, window, *on, how="left")


def window_join_right(left, right, lt, rt, window, *on):
    return window_join(left, right, lt, rt, window, *on, how="right")


def window_join_outer(left, right, lt, rt, window, *on):
    return window_join(left, right, lt, rt, window, *on, how="outer")
