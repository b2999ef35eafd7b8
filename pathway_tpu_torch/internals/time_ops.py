"""Temporal behavior primitives: buffer, forget, freeze (+ forget_immediately).

Block-engine counterparts of the reference's custom timely operators in
``src/engine/dataflow/operators/time_column.rs`` (driven from
``internals/table.py:670-754``): each tracks a **watermark** — the max value of the
``current_time`` column over all rows seen — and compares it to each row's
``threshold`` column when the frontier advances:

- **buffer**: rows with ``threshold > watermark`` are held back (consolidated in the
  buffer) and released once the watermark passes their threshold. Rows already past
  threshold flow through immediately.
- **forget**: rows are passed through, then retracted once the watermark passes
  their threshold; late rows (arriving already past threshold) are dropped.
- **freeze**: once the watermark passes a row's threshold the row is immutable —
  subsequent updates/retractions for it are dropped, as are late arrivals.
- **forget_immediately**: every row is retracted at the end of its own tick
  (serves the as-of-now request/response pattern, reference
  ``internals/table.py`` ``_forget_immediately``).

Watermark updates follow the reference's discipline (temporal_behavior.py docstring):
the recorded time advances only after the whole input batch of a tick is processed,
so simultaneous arrivals all see the pre-tick watermark.

Carried from ``pathway_tpu/internals/time_ops.py``.
"""

from __future__ import annotations

import threading
from typing import Any, Callable

import numpy as np

from pathway_tpu_torch.engine.blocks import DeltaBatch, consolidate
from pathway_tpu_torch.engine.graph import END_OF_STREAM, Node
from pathway_tpu_torch.internals.logical import LogicalNode


class _SharedWatermark:
    """One watermark cell shared by all worker shards of a temporal node.

    The reference broadcasts the frontier to every worker over timely's
    progress channels; here the logical node creates ONE of these at graph
    definition time and every worker's node copy folds its local per-tick max
    into it, so row state can shard by key while the watermark stays global.
    Across PROCESSES the cluster runtime merges each node's per-process tick
    maxima through a barrier before every frontier round
    (``ClusterRuntime._sync_watermarks`` — the watermark-gossip analogue of
    timely's progress broadcast)."""

    __slots__ = ("lock", "watermark", "tick_max")

    def __init__(self):
        self.lock = threading.Lock()
        self.watermark: Any = None
        self.tick_max: Any = None


class _WatermarkNode(Node):
    """Shared machinery: evaluate threshold/current-time per row, keep watermark.

    The watermark starts as ``None`` (no data seen) rather than ``-inf`` so time
    columns of any comparable dtype (ints, floats, datetime64) work.

    Row state (held/live/frozen rows) is keyed by row key and shards across
    workers with the default row-key exchange; only the watermark is global
    (``_SharedWatermark``), which keeps sharded behavior bit-identical to the
    serial node: a row's hold/release/drop decision depends only on (its
    threshold, the global watermark)."""

    #: multi-process runtimes without watermark gossip must run these serial
    global_watermark = True

    def __init__(
        self,
        threshold_fn: Callable[[DeltaBatch], np.ndarray],
        current_time_fn: Callable[[DeltaBatch], np.ndarray],
        shared: _SharedWatermark | None = None,
    ):
        super().__init__(n_inputs=1)
        self.threshold_fn = threshold_fn
        self.current_time_fn = current_time_fn
        self._shared = shared if shared is not None else _SharedWatermark()

    # watermark/_tick_max live in the shared cell; exposed as attributes so
    # snapshot_attrs (plain values) and existing call sites stay unchanged
    @property
    def watermark(self) -> Any:
        return self._shared.watermark

    @watermark.setter
    def watermark(self, value: Any) -> None:
        with self._shared.lock:
            self._shared.watermark = value

    @property
    def _tick_max(self) -> Any:
        return self._shared.tick_max

    @_tick_max.setter
    def _tick_max(self, value: Any) -> None:
        with self._shared.lock:
            self._shared.tick_max = value

    def _observe(self, batch: DeltaBatch) -> np.ndarray:
        """Track the batch's max current-time (applied to the watermark at frontier);
        return per-row thresholds."""
        cur = self.current_time_fn(batch)
        if len(cur):
            m = np.max(cur)
            with self._shared.lock:
                if self._shared.tick_max is None or m > self._shared.tick_max:
                    self._shared.tick_max = m
        return self.threshold_fn(batch)

    def _past(self, threshold: Any) -> bool:
        """Has the watermark passed this threshold?"""
        wm = self._shared.watermark
        return wm is not None and threshold <= wm

    def _advance_watermark(self) -> None:
        with self._shared.lock:
            s = self._shared
            if s.tick_max is not None and (
                s.watermark is None or s.tick_max > s.watermark
            ):
                s.watermark = s.tick_max


class BufferNode(_WatermarkNode):
    name = "buffer"
    snapshot_attrs = ("watermark", "_tick_max", "_held", "_columns")

    def __init__(self, threshold_fn, current_time_fn, shared=None):
        super().__init__(threshold_fn, current_time_fn, shared)
        # key -> [threshold, values, net_diff]
        self._held: dict[int, list] = {}
        # set on first batch; snapshotted so a restored shard can release its
        # held rows even if the post-restart suffix never touches it
        self._columns: list[str] | None = None

    def process(self, inputs, time):
        batch = inputs[0]
        if batch is None:
            return []
        thresholds = self._observe(batch)
        pass_idx: list[int] = []
        cols = list(batch.data.values())
        for i in range(len(batch)):
            thr = thresholds[i]
            if self._past(thr):
                pass_idx.append(i)
                continue
            key = int(batch.keys[i])
            entry = self._held.get(key)
            row = tuple(c[i] for c in cols)
            if entry is None:
                self._held[key] = [thr, row, int(batch.diffs[i])]
            else:
                entry[0] = thr
                entry[2] += int(batch.diffs[i])
                if batch.diffs[i] > 0:
                    entry[1] = row
                if entry[2] == 0:
                    del self._held[key]
        if not pass_idx:
            return []
        return [batch.take(np.asarray(pass_idx, dtype=np.int64))]

    def _release(self, time: int) -> list[DeltaBatch]:
        if time == END_OF_STREAM:
            due = list(self._held.items())  # close: flush everything (reference
            # flushes buffers when input ends so no data is lost)
        else:
            due = [(k, e) for k, e in self._held.items() if self._past(e[0])]
        if not due:
            return []
        for k, _ in due:
            del self._held[k]
        keys = [k for k, _ in due]
        rows = [e[1] for _, e in due]
        diffs = [e[2] for _, e in due]
        columns = list(self._columns)
        return [
            consolidate(
                DeltaBatch.from_rows(keys, rows, columns, time, diffs=diffs)
            )
        ]

    def on_frontier(self, time):
        self._advance_watermark()
        # column names aren't known until the first batch arrives
        if not self._held or self._columns is None:
            return []
        return self._release(time)

    def accept(self, port, batch):
        if self._columns is None:
            self._columns = list(batch.data.keys())
        super().accept(port, batch)


class ForgetNode(_WatermarkNode):
    name = "forget"
    snapshot_attrs = ("watermark", "_tick_max", "_live", "_columns")

    def __init__(self, threshold_fn, current_time_fn, mark_forgetting_records=False, shared=None):
        super().__init__(threshold_fn, current_time_fn, shared)
        self.mark = mark_forgetting_records
        # key -> [threshold, values, net_diff] of rows currently downstream
        self._live: dict[int, list] = {}
        self._columns: list[str] | None = None

    def process(self, inputs, time):
        batch = inputs[0]
        if batch is None:
            return []
        if self._columns is None:
            self._columns = list(batch.data.keys())
        thresholds = self._observe(batch)
        keep_idx: list[int] = []
        cols = list(batch.data.values())
        for i in range(len(batch)):
            if self._past(thresholds[i]):
                continue  # late: already forgotten territory
            keep_idx.append(i)
            key = int(batch.keys[i])
            entry = self._live.get(key)
            row = tuple(c[i] for c in cols)
            if entry is None:
                self._live[key] = [thresholds[i], row, int(batch.diffs[i])]
            else:
                entry[0] = thresholds[i]
                entry[2] += int(batch.diffs[i])
                if batch.diffs[i] > 0:
                    entry[1] = row
                if entry[2] == 0:
                    del self._live[key]
        if not keep_idx:
            return []
        return [batch.take(np.asarray(keep_idx, dtype=np.int64))]

    def on_frontier(self, time):
        self._advance_watermark()
        if self._columns is None or time == END_OF_STREAM:
            return []  # closing the stream does NOT forget remaining rows
        due = [(k, e) for k, e in self._live.items() if self._past(e[0])]
        if not due:
            return []
        for k, _ in due:
            del self._live[k]
        keys = [k for k, _ in due]
        rows = [e[1] for _, e in due]
        diffs = [-e[2] for _, e in due]
        return [DeltaBatch.from_rows(keys, rows, self._columns, time, diffs=diffs)]


class FreezeNode(_WatermarkNode):
    name = "freeze"
    snapshot_attrs = ("watermark", "_tick_max", "_frozen", "_pending_freeze")

    def __init__(self, threshold_fn, current_time_fn, shared=None):
        super().__init__(threshold_fn, current_time_fn, shared)
        self._frozen: set[int] = set()
        # key -> threshold of rows passed but not yet frozen
        self._pending_freeze: dict[int, Any] = {}

    def process(self, inputs, time):
        batch = inputs[0]
        if batch is None:
            return []
        thresholds = self._observe(batch)
        keep_idx: list[int] = []
        for i in range(len(batch)):
            key = int(batch.keys[i])
            if key in self._frozen or self._past(thresholds[i]):
                continue  # frozen row or late arrival: drop the update
            keep_idx.append(i)
            self._pending_freeze[key] = thresholds[i]
        if not keep_idx:
            return []
        return [batch.take(np.asarray(keep_idx, dtype=np.int64))]

    def on_frontier(self, time):
        self._advance_watermark()
        newly = [k for k, thr in self._pending_freeze.items() if self._past(thr)]
        for k in newly:
            self._frozen.add(k)
            del self._pending_freeze[k]
        return []


class ForgetImmediatelyNode(Node):
    name = "forget_immediately"

    def exchange_key(self, port):
        # no cross-row state at all: negate each tick's batches wherever they
        # were produced — fully parallel
        return None

    def __init__(self):
        super().__init__(n_inputs=1)
        self._this_tick: list[DeltaBatch] = []

    def process(self, inputs, time):
        batch = inputs[0]
        if batch is None:
            return []
        self._this_tick.append(batch)
        return [batch]

    def on_frontier(self, time):
        out = [b.negated() for b in self._this_tick]
        self._this_tick = []
        return out


# ---------------------------------------------------------------- table-level impls


def _impl(table, threshold_column, current_time_column, node_cls, **kw):
    from pathway_tpu_torch.internals.table import Table, _compile_single

    thr_fn = _compile_single(table._bind(threshold_column), table)
    cur_fn = _compile_single(table._bind(current_time_column), table)
    # one shared watermark cell per LOGICAL node: every worker's copy folds
    # into it, so row state shards while the watermark stays global
    shared = _SharedWatermark()

    def make():
        # builds happen before any processing (and before snapshot restore),
        # so resetting here gives every RUN of this logical graph a fresh
        # watermark — the cell outlives runs, its contents must not
        with shared.lock:
            shared.watermark = None
            shared.tick_max = None
        return node_cls(thr_fn, cur_fn, shared=shared, **kw)

    node = LogicalNode(make, [table._node], name=node_cls.name)
    return Table(node, table._schema, table._universe.subset())


def buffer_impl(table, threshold_column, current_time_column):
    return _impl(table, threshold_column, current_time_column, BufferNode)


def forget_impl(table, threshold_column, current_time_column, mark_forgetting_records=False):
    return _impl(
        table,
        threshold_column,
        current_time_column,
        ForgetNode,
        mark_forgetting_records=mark_forgetting_records,
    )


def freeze_impl(table, threshold_column, current_time_column):
    return _impl(table, threshold_column, current_time_column, FreezeNode)


def forget_immediately_impl(table):
    from pathway_tpu_torch.internals.table import Table

    node = LogicalNode(ForgetImmediatelyNode, [table._node], name="forget_immediately")
    return Table(node, table._schema, table._universe.subset())
