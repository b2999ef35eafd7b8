"""Temporal joins: interval_join, asof_join, asof_now_join.

Behavior parity with the reference's ``stdlib/temporal/_interval_join.py:577-1404``
and ``_asof_join.py:479-1000`` / ``_asof_now_join.py``, re-designed for the block
engine: one stateful ``TemporalJoinNode`` holds both sides' rows grouped by join key
(plus a time bucket for interval joins, bounding recompute), re-derives the touched
groups' matched pairs per tick, and emits only the delta vs what it previously
emitted. Outer modes track per-row match counts and maintain padded emissions
(reference: outer interval joins via universe subtraction; here it's node-local
bookkeeping). ``asof_now_join`` is a separate append-only-left node: each query row
is answered against the right state at its arrival tick and never revised
(the as-of-now discipline that makes request/response serving work, SURVEY §3.3).

The result objects subclass ``JoinResult`` so ``select``/``filter`` with
``pw.left``/``pw.right`` work unchanged.

Carried from ``pathway_tpu/stdlib/temporal/_temporal_join.py``.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np

from pathway_tpu_torch.engine.blocks import DeltaBatch
from pathway_tpu_torch.engine.graph import Node
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import expression as expr_mod
from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals import thisclass
from pathway_tpu_torch.internals.joins import JoinResult
from pathway_tpu_torch.internals.logical import LogicalNode
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.internals.universe import Universe
from pathway_tpu_torch.stdlib.temporal.behaviors import CommonBehavior, apply_temporal_behavior

_PAIR_SALT = np.uint64(0x9E3779B97F4A7C15)


def _mix_pair(a: int, b: int) -> int:
    from pathway_tpu_torch.internals.keys import combine_keys

    return int(combine_keys(np.asarray([a], np.uint64), np.asarray([b], np.uint64))[0])


@np.errstate(over="ignore")
def _pad_key(k: int, side: int) -> int:
    return _mix_pair(k, side ^ int(_PAIR_SALT))


class _Side:
    __slots__ = ("rows", "info")

    def __init__(self):
        self.rows: dict[int, tuple] = {}  # key -> values
        self.info: dict[int, tuple[Any, Any]] = {}  # key -> (jk, t)


class TemporalJoinNode(Node):
    """Matcher-parameterized incremental two-input temporal join."""

    name = "temporal_join"

    snapshot_attrs = (
        "left", "right", "_groups", "_group_pairs", "_pair_rows",
        "_match_count_l", "_match_count_r", "_pads_l", "_pads_r",
    )

    def exchange_key(self, port):
        return lambda batch: batch.data["__jk__"].astype(np.uint64)

    def __init__(
        self,
        n_left_cols: int,
        n_right_cols: int,
        how: str,
        matcher: str,  # "interval" | "asof"
        lower: Any = None,
        upper: Any = None,
        direction: str = "backward",
    ):
        super().__init__(n_inputs=2)
        self.n_left_cols = n_left_cols
        self.n_right_cols = n_right_cols
        self.how = how
        self.matcher = matcher
        self.lower = lower
        self.upper = upper
        self.direction = direction
        self.left = _Side()
        self.right = _Side()
        # group key -> (set of left keys, set of right keys)
        self._groups: dict[Any, tuple[set, set]] = {}
        # pair bookkeeping
        self._group_pairs: dict[Any, set[int]] = {}  # group -> emitted pair ids
        self._pair_rows: dict[int, tuple] = {}
        self._match_count_l: dict[int, int] = {}
        self._match_count_r: dict[int, int] = {}
        self._pads_l: dict[int, tuple] = {}
        self._pads_r: dict[int, tuple] = {}

    # -- group assignment ---------------------------------------------------
    def _left_groups(self, jk, t) -> list:
        if self.matcher == "asof":
            return [jk]
        width = self.upper - self.lower
        b0 = int(np.floor((t + self.lower) / width))
        b1 = int(np.floor((t + self.upper) / width))
        return [(jk, b) for b in sorted({b0, b1})]

    def _right_groups(self, jk, t) -> list:
        if self.matcher == "asof":
            return [jk]
        width = self.upper - self.lower
        return [(jk, int(np.floor(t / width)))]

    # -- matchers ------------------------------------------------------------
    def _match_interval(self, lkeys: set, rkeys: set, group) -> list[tuple[int, int]]:
        out = []
        for lk in lkeys:
            _, tl = self.left.info[lk]
            for rk in rkeys:
                _, tr = self.right.info[rk]
                # pair discovered only in the group of tr's bucket (unique)
                if self.matcher == "interval" and self._right_groups(
                    self.right.info[rk][0], tr
                )[0] != group:
                    continue
                if self.lower <= tr - tl <= self.upper:
                    out.append((lk, rk))
        return out

    def _match_asof(self, lkeys: set, rkeys: set, group) -> list[tuple[int, int]]:
        rs = sorted(((self.right.info[rk][1], rk) for rk in rkeys))
        times = [t for t, _ in rs]
        out = []
        import bisect

        for lk in lkeys:
            _, tl = self.left.info[lk]
            pick = None
            if self.direction == "backward":
                pos = bisect.bisect_right(times, tl) - 1
                if pos >= 0:
                    pick = rs[pos][1]
            elif self.direction == "forward":
                pos = bisect.bisect_left(times, tl)
                if pos < len(rs):
                    pick = rs[pos][1]
            else:  # nearest
                pos = bisect.bisect_right(times, tl) - 1
                cands = []
                if pos >= 0:
                    cands.append(rs[pos])
                if pos + 1 < len(rs):
                    cands.append(rs[pos + 1])
                if cands:
                    pick = min(cands, key=lambda c: (abs(c[0] - tl), c[0]))[1]
            if pick is not None:
                out.append((lk, pick))
        return out

    # -- tick processing -----------------------------------------------------
    def _apply_delta(self, side: _Side, batch: DeltaBatch, is_left: bool, touched: set):
        jks = batch.data["__jk__"]
        ts = batch.data["__t__"]
        n_vals = self.n_left_cols if is_left else self.n_right_cols
        val_cols = [batch.data[f"__v{i}"] for i in range(n_vals)]
        group_of = self._left_groups if is_left else self._right_groups
        for i in range(len(batch)):
            k = int(batch.keys[i])
            if batch.diffs[i] > 0:
                side.rows[k] = tuple(c[i] for c in val_cols)
                side.info[k] = (jks[i], ts[i])
                for g in group_of(jks[i], ts[i]):
                    entry = self._groups.setdefault(g, (set(), set()))
                    (entry[0] if is_left else entry[1]).add(k)
                    touched.add(g)
            else:
                info = side.info.pop(k, None)
                side.rows.pop(k, None)
                if info is None:
                    continue
                for g in group_of(info[0], info[1]):
                    entry = self._groups.get(g)
                    if entry:
                        (entry[0] if is_left else entry[1]).discard(k)
                    touched.add(g)

    def process(self, inputs, time):
        touched: set = set()
        if inputs[0] is not None:
            self._apply_delta(self.left, inputs[0], True, touched)
        if inputs[1] is not None:
            self._apply_delta(self.right, inputs[1], False, touched)
        if not touched:
            return []

        out_keys: list[int] = []
        out_diffs: list[int] = []
        out_rows: list[tuple] = []

        def emit(key, row, diff):
            out_keys.append(key)
            out_diffs.append(diff)
            out_rows.append(row)

        match = self._match_interval if self.matcher == "interval" else self._match_asof
        affected_l: set[int] = set()
        affected_r: set[int] = set()
        for g in touched:
            entry = self._groups.get(g, (set(), set()))
            new_pairs = {}
            for lk, rk in match(entry[0], entry[1], g):
                pid = _mix_pair(lk, rk)
                new_pairs[pid] = (lk, rk)
            old_ids = self._group_pairs.get(g, set())
            new_ids = set(new_pairs)
            for pid in old_ids - new_ids:
                row, lk, rk = self._pair_rows.pop(pid)
                emit(pid, row, -1)
                self._match_count_l[lk] -= 1
                self._match_count_r[rk] -= 1
                affected_l.add(lk)
                affected_r.add(rk)
            for pid in new_ids - old_ids:
                lk, rk = new_pairs[pid]
                row = (lk, rk) + self.left.rows[lk] + self.right.rows[rk]
                self._pair_rows[pid] = (row, lk, rk)
                emit(pid, row, +1)
                self._match_count_l[lk] = self._match_count_l.get(lk, 0) + 1
                self._match_count_r[rk] = self._match_count_r.get(rk, 0) + 1
                affected_l.add(lk)
                affected_r.add(rk)
            if new_ids:
                self._group_pairs[g] = new_ids
            else:
                self._group_pairs.pop(g, None)
            affected_l.update(entry[0])
            affected_r.update(entry[1])

        # outer padding reconciliation
        if self.how in ("left", "outer"):
            none_r = (None,) * self.n_right_cols
            for lk in affected_l:
                live = lk in self.left.rows
                want = live and self._match_count_l.get(lk, 0) == 0
                have = lk in self._pads_l
                if want and not have:
                    row = (lk, None) + self.left.rows[lk] + none_r
                    self._pads_l[lk] = row
                    emit(_pad_key(lk, 1), row, +1)
                elif have and not want:
                    emit(_pad_key(lk, 1), self._pads_l.pop(lk), -1)
        if self.how in ("right", "outer"):
            none_l = (None,) * self.n_left_cols
            for rk in affected_r:
                live = rk in self.right.rows
                want = live and self._match_count_r.get(rk, 0) == 0
                have = rk in self._pads_r
                if want and not have:
                    row = (None, rk) + none_l + self.right.rows[rk]
                    self._pads_r[rk] = row
                    emit(_pad_key(rk, 2), row, +1)
                elif have and not want:
                    emit(_pad_key(rk, 2), self._pads_r.pop(rk), -1)

        if not out_keys:
            return []
        names = self._out_names()
        return [DeltaBatch.from_rows(out_keys, out_rows, names, time, diffs=out_diffs)]

    def _out_names(self) -> list[str]:
        return (
            ["__left_id__", "__right_id__"]
            + [f"__lv{i}" for i in range(self.n_left_cols)]
            + [f"__rv{i}" for i in range(self.n_right_cols)]
        )


class AsofNowJoinNode(Node):
    """Append-only left (queries) joined against right state as of arrival."""

    name = "asof_now_join"

    snapshot_attrs = ("right", "_right_by_jk", "_answered")

    def exchange_key(self, port):
        # right state and query answering are both keyed by join key: shard by
        # __jk__ like TemporalJoinNode (queries meet exactly the right-state
        # shard they need; as-of-now answers are per-query-row)
        return lambda batch: batch.data["__jk__"].astype(np.uint64)

    def __init__(self, n_left_cols: int, n_right_cols: int, how: str):
        super().__init__(n_inputs=2)
        self.n_left_cols = n_left_cols
        self.n_right_cols = n_right_cols
        self.how = how
        self.right = _Side()
        self._right_by_jk: dict[Any, set[int]] = {}
        self._answered: dict[int, list[tuple[int, tuple]]] = {}  # lk -> emissions
        self._pending: list[DeltaBatch] = []  # queries awaiting the frontier

    def process(self, inputs, time):
        # right updates apply immediately; queries BUFFER until the frontier.
        # Under sharded sweeps a same-tick right update can arrive from
        # another worker after the query batch — answering at the frontier
        # (global quiescence) keeps "queries see every update of their tick"
        # deterministic regardless of sweep interleaving (the serial engine's
        # topo order gave this for free).
        if inputs[1] is not None:
            batch = inputs[1]
            jks = batch.data["__jk__"]
            val_cols = [batch.data[f"__v{i}"] for i in range(self.n_right_cols)]
            for i in range(len(batch)):
                k = int(batch.keys[i])
                if batch.diffs[i] > 0:
                    self.right.rows[k] = tuple(c[i] for c in val_cols)
                    self.right.info[k] = (jks[i], None)
                    self._right_by_jk.setdefault(jks[i], set()).add(k)
                else:
                    info = self.right.info.pop(k, None)
                    self.right.rows.pop(k, None)
                    if info is not None:
                        self._right_by_jk.get(info[0], set()).discard(k)
        if inputs[0] is not None:
            self._pending.append(inputs[0])
        return []

    def on_frontier(self, time):
        if not self._pending:
            return []
        batches, self._pending = self._pending, []
        out_keys: list[int] = []
        out_diffs: list[int] = []
        out_rows: list[tuple] = []
        for batch in batches:
            jks = batch.data["__jk__"]
            val_cols = [batch.data[f"__v{i}"] for i in range(self.n_left_cols)]
            for i in range(len(batch)):
                lk = int(batch.keys[i])
                if batch.diffs[i] > 0:
                    lrow = tuple(c[i] for c in val_cols)
                    matches = sorted(self._right_by_jk.get(jks[i], ()))
                    emits: list[tuple[int, tuple]] = []
                    if matches:
                        for rk in matches:
                            row = (lk, rk) + lrow + self.right.rows[rk]
                            emits.append((_mix_pair(lk, rk), row))
                    elif self.how == "left":
                        emits.append(
                            (_pad_key(lk, 1), (lk, None) + lrow + (None,) * self.n_right_cols)
                        )
                    for key, row in emits:
                        out_keys.append(key)
                        out_diffs.append(+1)
                        out_rows.append(row)
                    self._answered.setdefault(lk, []).extend(emits)
                else:
                    # query retracted (e.g. by upstream forget_immediately): retract
                    # exactly what it produced
                    for key, row in self._answered.pop(lk, []):
                        out_keys.append(key)
                        out_diffs.append(-1)
                        out_rows.append(row)
        if not out_keys:
            return []
        names = (
            ["__left_id__", "__right_id__"]
            + [f"__lv{i}" for i in range(self.n_left_cols)]
            + [f"__rv{i}" for i in range(self.n_right_cols)]
        )
        return [DeltaBatch.from_rows(out_keys, out_rows, names, time, diffs=out_diffs)]


# ----------------------------------------------------------------- result wrappers


class _TemporalJoinResult(JoinResult):
    """JoinResult whose materialization runs a temporal node instead of JoinNode."""

    def __init__(
        self,
        left: Table,
        right: Table,
        left_time,
        right_time,
        on: tuple,
        how: str,
        node_factory: Callable[[int, int, str], Node],
        behavior: CommonBehavior | None = None,
    ):
        super().__init__(left, right, on, how=how)
        self._lt = thisclass.bind_expression(expr_mod.wrap(left_time), left) if left_time is not None else None
        self._rt = thisclass.bind_expression(expr_mod.wrap(right_time), right) if right_time is not None else None
        self._node_factory = node_factory
        self._behavior = behavior
        self._defaults: dict = {}

    def _rewrite(self, e, joined):
        out = super()._rewrite(e, joined)
        if isinstance(e, expr_mod.ColumnReference) and self._defaults:
            for ref, val in self._defaults.items():
                if ref.table is e.table and ref.name == e.name:
                    from pathway_tpu_torch.internals.expression import coalesce

                    # `out` already references the joined table — no re-rewrite
                    return coalesce(out, val)
        return out

    def _materialize(self) -> Table:
        if self._joined is not None:
            return self._joined
        left, right = self.left, self.right
        l_cols = left.column_names()
        r_cols = right.column_names()
        # no equality conditions → one global group (PointerExpression with no
        # args would degenerate to the row's own id)
        l_jk = expr_mod.PointerExpression(left, *self.left_on) if self.left_on else 0
        r_jk = expr_mod.PointerExpression(right, *self.right_on) if self.right_on else 0
        pre_l = left.select(
            **{f"__v{i}": left[n] for i, n in enumerate(l_cols)},
            __jk__=l_jk,
            __t__=self._lt if self._lt is not None else 0,
        )
        pre_r = right.select(
            **{f"__v{i}": right[n] for i, n in enumerate(r_cols)},
            __jk__=r_jk,
            __t__=self._rt if self._rt is not None else 0,
        )
        if self._behavior is not None:
            pre_l = apply_temporal_behavior(pre_l, self._behavior, "__t__")
            pre_r = apply_temporal_behavior(pre_r, self._behavior, "__t__")
        nl, nr = len(l_cols), len(r_cols)
        how = self.how
        factory = self._node_factory
        node = LogicalNode(
            lambda: factory(nl, nr), [pre_l._node, pre_r._node], name="temporal_join"
        )
        l_opt = how in ("right", "outer")
        r_opt = how in ("left", "outer")
        dtypes: dict[str, dt.DType] = {
            "__left_id__": dt.Optional(dt.POINTER) if l_opt else dt.POINTER,
            "__right_id__": dt.Optional(dt.POINTER) if r_opt else dt.POINTER,
        }
        renames: dict[str, str] = {}
        for i, n in enumerate(l_cols):
            d = left._schema.dtypes()[n]
            dtypes[f"__lv{i}"] = dt.Optional(d) if l_opt else d
            renames[f"__l__{n}"] = f"__lv{i}"
        for i, n in enumerate(r_cols):
            d = right._schema.dtypes()[n]
            dtypes[f"__rv{i}"] = dt.Optional(d) if r_opt else d
            renames[f"__r__{n}"] = f"__rv{i}"
        raw = Table(node, schema_mod.schema_from_dtypes(dtypes), Universe())
        # JoinResult._rewrite expects __l__<name>/__r__<name> columns
        sel = {"__left_id__": raw["__left_id__"], "__right_id__": raw["__right_id__"]}
        for pub, priv in renames.items():
            sel[pub] = raw[priv]
        self._joined = raw.select(**sel)
        return self._joined


def interval(lower_bound, upper_bound):
    """The interval of an interval join (reference ``temporal.interval``)."""
    return _Interval(lower_bound, upper_bound)


class _Interval:
    def __init__(self, lower_bound, upper_bound):
        if upper_bound <= lower_bound:
            raise ValueError("interval upper_bound must exceed lower_bound")
        self.lower_bound = lower_bound
        self.upper_bound = upper_bound


def _interval_join_impl(left, right, left_time, right_time, iv, on, how, behavior=None):
    if not isinstance(iv, _Interval):
        raise ValueError("pass interval=pw.temporal.interval(lower, upper)")
    lo, up = iv.lower_bound, iv.upper_bound
    return _TemporalJoinResult(
        left, right, left_time, right_time, on, how,
        lambda nl, nr, h=how: TemporalJoinNode(
            nl, nr, h, matcher="interval", lower=lo, upper=up
        ),
        behavior=behavior,
    )


def interval_join(left, right, left_time, right_time, iv, *on, how="inner", behavior=None):
    """Rows pair when ``lower ≤ right_time − left_time ≤ upper`` (plus equality
    conditions). Reference ``_interval_join.py:577``."""
    return _interval_join_impl(left, right, left_time, right_time, iv, on, how, behavior)


def interval_join_inner(left, right, lt, rt, iv, *on, behavior=None):
    return _interval_join_impl(left, right, lt, rt, iv, on, "inner", behavior)


def interval_join_left(left, right, lt, rt, iv, *on, behavior=None):
    return _interval_join_impl(left, right, lt, rt, iv, on, "left", behavior)


def interval_join_right(left, right, lt, rt, iv, *on, behavior=None):
    return _interval_join_impl(left, right, lt, rt, iv, on, "right", behavior)


def interval_join_outer(left, right, lt, rt, iv, *on, behavior=None):
    return _interval_join_impl(left, right, lt, rt, iv, on, "outer", behavior)


class Direction:
    BACKWARD = "backward"
    FORWARD = "forward"
    NEAREST = "nearest"


def asof_join(
    left,
    right,
    left_time,
    right_time,
    *on,
    how="left",
    direction: str = "backward",
    behavior=None,
    defaults: dict | None = None,
):
    """Each left row matches the single right row closest in time per ``direction``
    (backward: latest right ≤ left). Reference ``_asof_join.py:479``."""
    direction = getattr(direction, "value", direction)
    res = _TemporalJoinResult(
        left, right, left_time, right_time, on, how,
        lambda nl, nr, h=how: TemporalJoinNode(
            nl, nr, h, matcher="asof", direction=direction
        ),
        behavior=behavior,
    )
    if defaults:
        res._defaults = dict(defaults)
    return res


def asof_join_left(left, right, lt, rt, *on, **kw):
    return asof_join(left, right, lt, rt, *on, how="left", **kw)


def asof_join_right(left, right, lt, rt, *on, **kw):
    return asof_join(left, right, lt, rt, *on, how="right", **kw)


def asof_join_outer(left, right, lt, rt, *on, **kw):
    return asof_join(left, right, lt, rt, *on, how="outer", **kw)


def asof_now_join(left, right, *on, how="inner", **kw):
    """Join where the left side is an append-only query stream answered against
    the right side's state at arrival; answers are never revised when the right
    side later changes (reference ``_asof_now_join.py``)."""
    if how not in ("inner", "left"):
        raise ValueError("asof_now_join supports how='inner' or 'left'")
    return _TemporalJoinResult(
        left, right, None, None, on, how,
        lambda nl, nr, h=how: AsofNowJoinNode(nl, nr, h),
    )


def asof_now_join_inner(left, right, *on, **kw):
    return asof_now_join(left, right, *on, how="inner", **kw)


def asof_now_join_left(left, right, *on, **kw):
    return asof_now_join(left, right, *on, how="left", **kw)
