"""Windows: tumbling, sliding, session, intervals_over + ``windowby``.

Behavior parity with the reference's ``stdlib/temporal/_window.py:588-855`` windows,
built block-engine-first: tumbling/sliding assignment is a vectorized rowwise program
(each row → list of ``(instance, start, end)`` tuples) followed by ``flatten`` and an
incremental ``groupby`` — all batch-oriented engine ops. Session windows, whose
assignment depends on neighboring rows, are a dedicated stateful engine node that
re-derives the touched instance's sessions per tick and emits row-level deltas.

After ``windowby(...).reduce(...)`` the grouping columns ``_pw_window``,
``_pw_instance``, ``_pw_window_start``, ``_pw_window_end`` are available, as in the
reference.

Carried from ``pathway_tpu/stdlib/temporal/_window.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np

from pathway_tpu_torch.engine.blocks import DeltaBatch
from pathway_tpu_torch.engine.graph import Node
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.logical import LogicalNode
from pathway_tpu_torch.stdlib.temporal.behaviors import (
    Behavior,
    CommonBehavior,
    ExactlyOnceBehavior,
)


class Window:
    def _apply(self, table, key, behavior, instance):
        raise NotImplementedError


@dataclass
class _TumblingWindow(Window):
    duration: Any
    origin: Any = None

    def _apply(self, table, key, behavior, instance):
        return _apply_fixed_window(
            table, key, behavior, instance,
            hop=self.duration, duration=self.duration, origin=self.origin,
        )


@dataclass
class _SlidingWindow(Window):
    hop: Any
    duration: Any
    origin: Any = None

    def _apply(self, table, key, behavior, instance):
        return _apply_fixed_window(
            table, key, behavior, instance,
            hop=self.hop, duration=self.duration, origin=self.origin,
        )


@dataclass
class _SessionWindow(Window):
    predicate: Callable | None = None
    max_gap: Any = None

    def _apply(self, table, key, behavior, instance):
        return _apply_session_window(table, key, behavior, instance, self)


@dataclass
class _IntervalsOverWindow(Window):
    at: Any  # ColumnReference into the query-points table
    lower_bound: Any
    upper_bound: Any
    is_outer: bool = True


def tumbling(duration, origin=None) -> Window:
    """Non-overlapping fixed windows of ``duration`` starting at ``origin + k*duration``
    (reference ``_window.py`` tumbling)."""
    return _TumblingWindow(duration, origin)


def sliding(hop, duration=None, ratio=None, origin=None) -> Window:
    """Overlapping windows of ``duration`` (or ``hop*ratio``) every ``hop``."""
    if (duration is None) == (ratio is None):
        raise ValueError("provide exactly one of duration / ratio")
    return _SlidingWindow(hop, duration if duration is not None else hop * ratio, origin)


def session(*, predicate=None, max_gap=None) -> Window:
    """Group adjacent entries: ``predicate(a, b)`` or ``b - a < max_gap``."""
    if (predicate is None) == (max_gap is None):
        raise ValueError("provide exactly one of predicate / max_gap")
    return _SessionWindow(predicate, max_gap)


def intervals_over(*, at, lower_bound, upper_bound, is_outer: bool = True) -> Window:
    """For each time point in ``at``, a window ``[t+lower_bound, t+upper_bound]``
    gathering the data rows inside (powers ``statistical.interpolate``)."""
    return _IntervalsOverWindow(at, lower_bound, upper_bound, is_outer)


# ------------------------------------------------------------------ tumbling/sliding


def _apply_fixed_window(table, key, behavior, instance, *, hop, duration, origin):
    import pathway_tpu_torch as pw

    origin_val = origin

    def assign(inst, t):
        if t is None:
            return ()
        base = 0 if origin_val is None else origin_val
        last_k = int((t - base) // hop)
        first_k = last_k - int(duration // hop) - 1
        out = []
        for k in range(first_k, last_k + 2):
            start = base + k * hop
            end = start + duration
            if start <= t < end and (origin_val is None or start >= origin_val):
                out.append((inst, start, end))
        return tuple(out)

    target = table.with_columns(
        _pw_window=pw.apply_with_type(
            assign,
            dt.List(dt.Tuple(dt.ANY, dt.ANY, dt.ANY)),
            instance,
            key,
        ),
        _pw_key=key,
    )
    target = target.flatten(target._pw_window)
    target = target.with_columns(
        _pw_instance=pw.this._pw_window.get(0),
        _pw_window_start=pw.this._pw_window.get(1),
        _pw_window_end=pw.this._pw_window.get(2),
    )
    target = _apply_window_behavior(target, behavior)
    return _window_groupby(target)


def _apply_window_behavior(target, behavior):
    import pathway_tpu_torch as pw

    if behavior is None:
        return target
    if isinstance(behavior, ExactlyOnceBehavior):
        # exactly-once: hold everything until window end + shift, then freeze
        shift = behavior.shift if behavior.shift is not None else 0
        target = target._buffer(
            pw.this._pw_window_end + shift, pw.this._pw_key
        )
        target = target._freeze(
            pw.this._pw_window_end + shift, pw.this._pw_key
        )
        return target
    if not isinstance(behavior, CommonBehavior):
        raise ValueError(f"behavior {behavior!r} unsupported for this window")
    if behavior.cutoff is not None:
        target = target._freeze(
            pw.this._pw_window_end + behavior.cutoff, pw.this._pw_key
        )
    if behavior.delay is not None:
        target = target._buffer(
            pw.this._pw_window_start + behavior.delay, pw.this._pw_key
        )
    if behavior.cutoff is not None and not behavior.keep_results:
        # keep_results=True in the reference forgets upstream state but filters the
        # forgetting retractions out of the output (results stay); here state stays
        # and results stay — same observable behavior, memory release deferred
        target = target._forget(
            pw.this._pw_window_end + behavior.cutoff,
            pw.this._pw_key,
            behavior.keep_results,
        )
    return target


def _window_groupby(target):
    grouped = target.groupby(
        target._pw_window,
        target._pw_instance,
        target._pw_window_start,
        target._pw_window_end,
    )
    return grouped


# ------------------------------------------------------------------ session windows


class SessionAssignNode(Node):
    """Stateful session assignment: per instance, sort rows by time and merge
    adjacent entries per predicate/max_gap; emit rows + (start, end) deltas."""

    name = "session_assign"

    def exchange_key(self, port):
        # session state is independent per instance: shard by instance hash
        # (the reference keys its session arrangement the same way,
        # time_column.rs) — one instance's rows always co-locate, so sharded
        # runs are byte-identical to serial
        from pathway_tpu_torch.internals.keys import hash_column

        return lambda batch: hash_column(batch.data["__inst"])

    def __init__(self, columns: list[str], predicate, max_gap):
        super().__init__(n_inputs=1)
        self.columns = columns  # input column names (incl. __t/__inst materialized)
        self.predicate = predicate
        self.max_gap = max_gap
        self._rows: dict[int, tuple] = {}  # key -> row values
        self._info: dict[int, tuple[Any, Any]] = {}  # key -> (inst, t)
        self._by_instance: dict[Any, set[int]] = {}
        self._emitted: dict[int, tuple] = {}  # key -> emitted (row + start + end)

    def _grouped(self, a, b) -> bool:
        if self.predicate is not None:
            return bool(self.predicate(a, b))
        return bool(b - a < self.max_gap)

    def process(self, inputs, time):
        batch = inputs[0]
        if batch is None:
            return []
        t_col = batch.data["__t"]
        inst_col = batch.data["__inst"]
        cols = [batch.data[n] for n in self.columns]
        touched: set = set()
        for i in range(len(batch)):
            k = int(batch.keys[i])
            if batch.diffs[i] > 0:
                self._rows[k] = tuple(c[i] for c in cols)
                self._info[k] = (inst_col[i], t_col[i])
                self._by_instance.setdefault(inst_col[i], set()).add(k)
                touched.add(inst_col[i])
            else:
                info = self._info.pop(k, None)
                self._rows.pop(k, None)
                if info is not None:
                    self._by_instance.get(info[0], set()).discard(k)
                    touched.add(info[0])

        out_keys: list[int] = []
        out_diffs: list[int] = []
        out_rows: list[tuple] = []
        for inst in touched:
            members = sorted(
                self._by_instance.get(inst, ()), key=lambda k: (self._info[k][1], k)
            )
            # walk in time order, splitting where adjacent rows don't group
            sessions: list[list[int]] = []
            for k in members:
                if sessions and self._grouped(
                    self._info[sessions[-1][-1]][1], self._info[k][1]
                ):
                    sessions[-1].append(k)
                else:
                    sessions.append([k])
            assigned: dict[int, tuple] = {}
            for sess in sessions:
                start = self._info[sess[0]][1]
                end = self._info[sess[-1]][1]
                for k in sess:
                    assigned[k] = (start, end)
            for k, (start, end) in assigned.items():
                new_row = self._rows[k] + ((inst, start, end), inst, start, end)
                old = self._emitted.get(k)
                if old == new_row:
                    continue
                if old is not None:
                    out_keys.append(k)
                    out_diffs.append(-1)
                    out_rows.append(old)
                out_keys.append(k)
                out_diffs.append(+1)
                out_rows.append(new_row)
                self._emitted[k] = new_row
        # retract emissions of deleted rows
        for i in range(len(batch)):
            k = int(batch.keys[i])
            if batch.diffs[i] < 0 and k not in self._rows:
                old = self._emitted.pop(k, None)
                if old is not None:
                    out_keys.append(k)
                    out_diffs.append(-1)
                    out_rows.append(old)
        if not out_keys:
            return []
        names = self.columns + ["_pw_window", "_pw_instance", "_pw_window_start", "_pw_window_end"]
        return [DeltaBatch.from_rows(out_keys, out_rows, names, time, diffs=out_diffs)]


def _apply_session_window(table, key, behavior, instance, window: _SessionWindow):
    from pathway_tpu_torch.internals import schema as schema_mod
    from pathway_tpu_torch.internals.table import Table

    base_cols = table.column_names()
    pre = table.with_columns(__t=key, __inst=instance if instance is not None else 0)
    col_names = pre.column_names()
    node = LogicalNode(
        lambda: SessionAssignNode(col_names, window.predicate, window.max_gap),
        [pre._node],
        name="session_window",
    )
    dtypes = dict(pre._schema.dtypes())
    dtypes["_pw_window"] = dt.Tuple(dt.ANY, dt.ANY, dt.ANY)
    dtypes["_pw_instance"] = dt.ANY
    dtypes["_pw_window_start"] = dtypes["__t"]
    dtypes["_pw_window_end"] = dtypes["__t"]
    from pathway_tpu_torch.internals.universe import Universe

    assigned = Table(node, schema_mod.schema_from_dtypes(dtypes), Universe())
    if behavior is not None:
        assigned = assigned.with_columns(_pw_key=assigned["__t"])
        assigned = _apply_window_behavior(assigned, behavior)
    return _window_groupby(assigned)


# ------------------------------------------------------------------ intervals_over


def _apply_intervals_over(table, key, behavior, window: _IntervalsOverWindow):
    """Each query point ``p`` (from ``window.at``) gathers data rows with
    ``key ∈ [p+lower, p+upper]``: bucketed equi-join + filter + groupby."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.internals.expression import ColumnReference

    at_ref = window.at
    if not isinstance(at_ref, ColumnReference):
        raise ValueError("intervals_over needs at=<column reference>")
    points = at_ref.table.select(__p=at_ref)
    lo, up = window.lower_bound, window.upper_bound
    width = up - lo
    if width <= 0:
        raise ValueError("intervals_over requires upper_bound > lower_bound")

    def point_buckets(p):
        b0 = int(np.floor((p + lo) / width))
        b1 = int(np.floor((p + up) / width))
        return tuple(sorted({b0, b1}))

    pts = points.with_columns(
        __b=pw.apply_with_type(point_buckets, dt.List(dt.INT), pw.this["__p"])
    )
    pts = pts.flatten(pts["__b"], origin_id="__point_id")

    def row_bucket(t):
        return int(np.floor(t / width))

    data = table.with_columns(
        __t=key, __b=pw.apply_with_type(row_bucket, dt.INT, key)
    )
    jr = pts.join(data, pts["__b"] == data["__b"], how="inner").filter(
        (pw.right["__t"] >= pw.left["__p"] + lo)
        & (pw.right["__t"] <= pw.left["__p"] + up)
    )
    sel = {}
    for n in table.column_names():
        sel[n] = pw.right[n]
    window_cols = dict(
        _pw_window=pw.apply_with_type(
            lambda p: (None, p + lo, p + up),
            dt.Tuple(dt.ANY, dt.ANY, dt.ANY),
            pw.left["__p"],
        ),
        _pw_instance=pw.declare_type(dt.ANY, None),
        _pw_window_location=pw.left["__p"],
        _pw_window_start=pw.left["__p"] + lo,
        _pw_window_end=pw.left["__p"] + up,
    )
    joined = jr.select(__point_id=pw.left["__point_id"], **window_cols, **sel)
    if window.is_outer:
        # points whose window matched nothing still produce a (padded) window:
        # antijoin via groupby keyed by the point id, then set-difference
        matched = joined.groupby(
            joined["__point_id"], id=joined["__point_id"]
        ).reduce(__c=pw.reducers.count())
        unmatched = points.difference(matched)
        pads = unmatched.select(
            __point_id=pw.this.id,
            _pw_window=pw.apply_with_type(
                lambda p: (None, p + lo, p + up),
                dt.Tuple(dt.ANY, dt.ANY, dt.ANY),
                pw.this["__p"],
            ),
            _pw_instance=pw.declare_type(dt.ANY, None),
            _pw_window_location=pw.this["__p"],
            _pw_window_start=pw.this["__p"] + lo,
            _pw_window_end=pw.this["__p"] + up,
            **{n: pw.declare_type(dt.Optional(table._schema.dtypes()[n]), None) for n in table.column_names()},
        )
        joined = joined.concat_reindex(pads)
    grouped = joined.groupby(
        joined._pw_window,
        joined._pw_instance,
        joined._pw_window_location,
        joined._pw_window_start,
        joined._pw_window_end,
    )
    return grouped


def windowby_impl(table, time_expr, *, window: Window, instance=None, behavior=None, **kwargs):
    key = table._bind(time_expr)
    inst = table._bind(instance) if instance is not None else None
    if isinstance(window, _IntervalsOverWindow):
        if behavior is not None:
            raise NotImplementedError(
                "behavior is not yet supported for intervals_over windows"
            )
        return _apply_intervals_over(table, key, behavior, window)
    return window._apply(table, key, behavior, inst)
