"""Engine dataflow graph and the tick scheduler.

Role of the reference's worker main loop (``src/engine/dataflow.rs:6202-6255``:
``loop { probers; flushers; pollers; worker.step_or_park }``): a topologically-ordered
DAG of engine nodes processes **delta blocks** tick by tick. Each logical timestamp is
one tick; within a tick the scheduler sweeps nodes in topo order until quiescent, then
advances the frontier (notifying temporal operators: buffers, forget, windows), then
sweeps again — so all downstream consequences of a timestamp are drained before the
next timestamp starts, giving the reference's "every output reflects a known prefix of
inputs" consistency model.

Carried from ``pathway_tpu/engine/graph.py``. The reference's sweep also feeds
the live-tracing, request, audit and device-profiling planes and the fault
plan's input corruption; those planes are not ported yet (ROADMAP Queue 1), so
their hooks are cut and the sweep keeps only the per-node row and time stats
and the per-phase attribution (``observability/engine_phases.py``).
"""

from __future__ import annotations

import heapq
import time as _time
from typing import Callable

import numpy as np

from pathway_tpu_torch.engine.blocks import DeltaBatch, concat_batches
from pathway_tpu_torch.internals.trace import run_annotated as _run_annotated
from pathway_tpu_torch.observability import engine_phases as _phases

END_OF_STREAM = np.iinfo(np.int64).max  # frontier value after all input closed


SOLO = "solo"  # exchange marker: route every row to worker 0 (serial operator)

BROADCAST = "broadcast"  # exchange marker: deliver every row to EVERY worker
# (replicated consumers, e.g. index queries fanned out over doc shards)


class Node:
    """Engine operator. Subclasses implement ``process`` and optionally
    ``on_frontier``.

    ``exchange_key(port)`` declares how a multi-worker runtime must partition
    this node's input rows (the reference's exchange-by-shard contract,
    ``src/engine/dataflow/shard.rs``): ``None`` = no co-location requirement
    (stateless; process rows where they are produced), a callable
    ``batch -> uint64[n]`` = co-locate rows by that key's shard, ``SOLO`` =
    the operator is serial (global watermark / external index / output order) and
    runs entirely on worker 0."""

    name: str = "node"

    #: attribute names that constitute this node's operator state; empty =
    #: stateless. The operator-persistence layer (``persistence/snapshots.py``,
    #: reference ``src/persistence/operator_snapshot.rs:21-342``) pickles these
    #: at snapshot ticks and restores them on restart, making recovery
    #: O(state) instead of O(history).
    snapshot_attrs: tuple[str, ...] = ()

    def snapshot_state(self) -> dict | None:
        """Operator state for persistence, or None when stateless."""
        if not self.snapshot_attrs:
            return None
        return {a: getattr(self, a) for a in self.snapshot_attrs}

    def restore_state(self, state: dict) -> None:
        for a, v in state.items():
            setattr(self, a, v)

    #: True when this node's state keys live on the worker the shard map says
    #: owns them (keyed-exchange discipline) — an O(moved-state) migration may
    #: then read only the old shards whose ranges overlap the new worker's.
    #: Nodes whose state placement follows something OTHER than key ownership
    #: (e.g. a partitioned source's per-partition slice) set this False and a
    #: migration reads every old shard for them instead.
    migrate_aligned: bool = True

    def migrate_mode(self) -> str | None:
        """How an O(moved-state) rescale may move this node's persisted shard:
        ``"keyed"`` — state is key-addressed; merge overlapping old shards via
        :meth:`migrate_restore`. ``"solo"`` — the node runs serially on global
        worker 0 under every shape, so its single shard restores positionally.
        ``None`` — neither holds; the whole restore must fall back to
        reshard-by-replay."""
        if type(self).migrate_restore is not Node.migrate_restore:
            return "keyed"
        if self.exchange_key(0) == SOLO:
            return "solo"
        return None

    def migrate_restore(self, shards: list[dict], keep) -> dict | None:
        """Merge old per-worker snapshot states into THIS worker's state for an
        O(moved-state) rescale (``PATHWAY_SHARDMAP_MIGRATION``).

        ``shards`` are the ``snapshot_state()`` dicts of every old worker whose
        owned key ranges overlap this worker's new ranges; ``keep`` maps a
        ``uint64`` key array to a boolean mask of keys this worker owns under
        the NEW shard map. Returns a state dict for :meth:`restore_state`, or
        ``None`` when the merged state is empty.

        The default (this method not overridden) means the node does NOT
        support keyed migration — the restore falls back to reshard-by-replay
        for the whole pipeline (``persistence/snapshots.py``)."""
        raise NotImplementedError

    def exchange_key(self, port: int):
        # stateful nodes keyed by row key need co-location by row key; stateless
        # subclasses override with None, specially-keyed ones with their key fn
        return lambda batch: batch.keys

    def __init__(self, n_inputs: int = 1):
        self.n_inputs = n_inputs
        self.node_index: int = -1  # set by EngineGraph
        self._buffers: list[list[DeltaBatch]] = [[] for _ in range(n_inputs)]
        self.stats_rows_in = 0
        self.stats_rows_out = 0
        self.stats_time_ns = 0
        # per-operator probes (reference: Prober / OperatorStats{latency,lag},
        # src/engine/dataflow.rs:678-806, graph.rs:497-527): queue latency =
        # wall time a pending input set waited before this node drained it;
        # last processed logical time feeds the lag computation in monitoring
        self.stats_latency_ms = 0.0  # last drain
        self.stats_latency_ewma_ms = 0.0
        self.stats_last_time = -1
        self._pending_since: int | None = None

    # -- scheduler interface --
    def accept(self, port: int, batch: DeltaBatch) -> None:
        if not batch.is_empty:
            if self._pending_since is None:
                self._pending_since = _time.perf_counter_ns()
            self._buffers[port].append(batch)

    def has_pending(self) -> bool:
        return any(self._buffers)

    def drain(self) -> list[DeltaBatch | None]:
        if self._pending_since is not None:
            lat = (_time.perf_counter_ns() - self._pending_since) / 1e6
            self.stats_latency_ms = lat
            self.stats_latency_ewma_ms = (
                lat
                if self.stats_latency_ewma_ms == 0.0
                else 0.8 * self.stats_latency_ewma_ms + 0.2 * lat
            )
            self._pending_since = None
        out: list[DeltaBatch | None] = []
        for port in range(self.n_inputs):
            out.append(concat_batches(self._buffers[port]))
            self._buffers[port] = []
        for b in out:
            if (
                b is not None
                and b.time is not None
                and b.time != END_OF_STREAM  # the close tick is not a logical time
                and b.time > self.stats_last_time
            ):
                self.stats_last_time = b.time
        return out

    # -- operator interface --
    def poll(self, time: int) -> list[DeltaBatch]:
        """Called at tick start; source nodes emit their pending input here."""
        return []

    def process(self, inputs: list[DeltaBatch | None], time: int) -> list[DeltaBatch]:
        """Consume one round of input batches, return emissions (all at ``time``)."""
        return []

    def on_frontier(self, time: int) -> list[DeltaBatch]:
        """Called when the frontier passes ``time`` (end of tick). May emit."""
        return []

    def on_tick_complete(self, time: int) -> None:
        """Called once per tick AFTER the frontier loop settles — everything
        emitted at ``time`` has been routed. Side effects only (sinks,
        callbacks); emissions are not possible here."""

    def on_end(self) -> None:
        """Stream closed — release resources, fire final callbacks."""


class EngineGraph:
    def __init__(self) -> None:
        self.nodes: list[Node] = []
        # edges[i] = list of (consumer_index, port)
        self.edges: dict[int, list[tuple[int, int]]] = {}

    def add_node(self, node: Node, inputs: list[Node]) -> Node:
        node.node_index = len(self.nodes)
        self.nodes.append(node)
        assert len(inputs) == node.n_inputs, f"{node.name}: wrong input arity"
        for port, src in enumerate(inputs):
            assert src.node_index >= 0 and src.node_index < node.node_index, (
                f"{node.name}: inputs must be added before consumers (topo order)"
            )
            self.edges.setdefault(src.node_index, []).append((node.node_index, port))
        return node


class Scheduler:
    """Drives the engine graph tick by tick.

    The sweep is PLAN-driven (``engine/fusion.py``). Fused chains execute as
    single steps, idle nodes are never visited — routing marks the consumer's
    step dirty, and a sweep drains the dirty set in topological order (edges
    only point forward, so one drain reaches quiescence). The tick's
    poll/frontier/complete loops visit only nodes that actually override
    those hooks."""

    def __init__(self, graph: EngineGraph, transient: bool = False):
        self.graph = graph
        self.current_time = 0
        self.on_tick_done: list[Callable[[int], None]] = []
        self.transient = transient
        from pathway_tpu_torch.engine import fusion as _fusion

        # transient = a short-lived inner graph rebuilt per use: chain fusion
        # still applies
        self.plan = _fusion.build_plan(graph, exchange_aware=False, transient=transient)
        # dirty step positions; during a sweep, forward marks go straight
        # onto the active heap (all edges point forward, so a marked step is
        # always still ahead of the cursor)
        self._dirty: set[int] = set()
        self._heap: list[int] | None = None

    def _mark(self, pos: int) -> None:
        h = self._heap
        if h is not None:
            heapq.heappush(h, pos)
        else:
            self._dirty.add(pos)

    def _route(self, producer: Node, batches: list[DeltaBatch]) -> bool:
        routed = False
        consumers = self.graph.edges.get(producer.node_index, [])
        plan = self.plan
        for batch in batches:
            if batch is None or batch.is_empty:
                continue
            producer.stats_rows_out += len(batch)
            for ci, port in consumers:
                self.graph.nodes[ci].accept(port, batch)
                if plan is not None:
                    self._mark(plan.pos_of[ci])
                routed = True
        return routed

    def _run_node(self, node: Node, time: int) -> None:
        inputs = node.drain()
        node.stats_rows_in += sum(len(b) for b in inputs if b is not None)
        t0 = _time.perf_counter_ns()
        out = _run_annotated(node, node.process, inputs, time)
        node.stats_time_ns += _time.perf_counter_ns() - t0
        self._route(node, out)

    def _sweep_legacy(self, time: int) -> bool:
        """One full topo scan, one node per step. Active under
        ``PATHWAY_FUSE=off`` (plan is None)."""
        any_work = False
        for node in self.graph.nodes:
            if not node.has_pending():
                continue
            self._run_node(node, time)
            any_work = True
        return any_work

    def _sweep(self, time: int) -> bool:
        """Drain the dirty steps in topo order; returns True if any step did
        work. Quiescence check is O(1): an empty dirty set."""
        if self.plan is None:
            return self._sweep_legacy(time)
        dirty = self._dirty
        if not dirty:
            return False
        heap = sorted(dirty)
        dirty.clear()
        self._heap = heap
        any_work = False
        by_pos = self.plan.by_pos
        last = -1
        try:
            while heap:
                pos = heapq.heappop(heap)
                if pos == last:
                    continue  # duplicate marks collapse (ascending pops)
                last = pos
                step = by_pos[pos]
                chain = step.chain
                if chain is not None:
                    if self._run_chain(chain, time):
                        any_work = True
                    continue
                node = step.node
                if not node.has_pending():
                    continue
                self._run_node(node, time)
                any_work = True
        finally:
            self._heap = None
        return any_work

    def _run_chain(self, chain, time: int) -> bool:
        """One fused-chain step: drain, hand off member to member, route the
        tail."""
        t0 = _time.perf_counter_ns()
        tok = _phases.start()
        try:
            out, processed, _rows_in, _rows_out = chain.execute(time, None)
        finally:
            _phases.stop(tok, "fused")
        if not processed:
            return False
        chain.tail.stats_time_ns += _time.perf_counter_ns() - t0
        self._route(chain.tail, out)
        return True

    def run_tick(self, time: int) -> None:
        """Process everything pending at logical ``time`` to quiescence, then
        advance the frontier past it."""
        self.current_time = time
        plan = self.plan
        pollers = self.graph.nodes if plan is None else plan.pollers
        for node in pollers:
            polled = _run_annotated(node, node.poll, time)
            self._route(node, polled)
        while self._sweep(time):
            pass
        # frontier phase: notify in topo order; emissions re-enter the same
        # tick (only nodes that override on_frontier are visited)
        frontier = self.graph.nodes if plan is None else plan.frontier_nodes
        progressed = True
        while progressed:
            progressed = False
            for node in frontier:
                out = _run_annotated(node, node.on_frontier, time)
                if self._route(node, out):
                    progressed = True
            if progressed:
                while self._sweep(time):
                    pass
        complete = self.graph.nodes if plan is None else plan.tick_complete_nodes
        for node in complete:
            _run_annotated(node, node.on_tick_complete, time)
        for cb in self.on_tick_done:
            cb(time)

    def close(self) -> None:
        """Input exhausted: flush temporal buffers and fire end callbacks."""
        self.run_tick(END_OF_STREAM)
        for node in self.graph.nodes:
            node.on_end()
