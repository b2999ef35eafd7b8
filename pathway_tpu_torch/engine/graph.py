"""Engine dataflow graph and the tick scheduler.

Role of the reference's worker main loop (``src/engine/dataflow.rs:6202-6255``:
``loop { probers; flushers; pollers; worker.step_or_park }``): a topologically-ordered
DAG of engine nodes processes **delta blocks** tick by tick. Each logical timestamp is
one tick; within a tick the scheduler sweeps nodes in topo order until quiescent, then
advances the frontier (notifying temporal operators: buffers, forget, windows), then
sweeps again — so all downstream consequences of a timestamp are drained before the
next timestamp starts, giving the reference's "every output reflects a known prefix of
inputs" consistency model.

Carried from ``pathway_tpu/engine/graph.py``. The sweep feeds the per-node row
and time stats, the per-phase attribution (``observability/engine_phases.py``)
and the live-tracing, request, device-profiling and audit planes, and the
fault plan corrupts freshly polled blocks before the audit monitors see
them, as the reference's does.
"""

from __future__ import annotations

import heapq
import time as _time
from typing import Callable

import numpy as np

from pathway_tpu_torch.engine.blocks import DeltaBatch, concat_batches
from pathway_tpu_torch.internals.trace import run_annotated as _run_annotated
from pathway_tpu_torch.observability import audit as _audit
from pathway_tpu_torch.observability import device as _device_prof
from pathway_tpu_torch.observability import engine_phases as _phases
from pathway_tpu_torch.observability import requests as _requests
from pathway_tpu_torch.resilience import faults as _faults

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
        # live tracing (observability plane): None when PATHWAY_TRACE=off —
        # the hot loops below pay exactly one is-not-None test per guard
        self.tracer = None
        self._trace_active = False
        # request-scoped tracing (observability/requests.py): the installed
        # plane while a request is in flight this tick, else None — sweep
        # steps pay one is-None test
        self._rp = None
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

    def _run_node(self, node: Node, time: int, aud) -> None:
        """One node step: drain, process, route — with the sweep span, the
        request plane's stage event and, on an audit-edge-sampled tick
        (``aud`` non-None), the edge's cardinality recording."""
        inputs = node.drain()
        rows_in = sum(len(b) for b in inputs if b is not None)
        node.stats_rows_in += rows_in
        trace = self._trace_active
        rp = self._rp
        if trace or rp is not None:
            w0 = _time.time_ns()
            # host/device split: traced dispatches inside this node
            # accumulate their device wait on sampled ticks
            dev0 = _device_prof.thread_device_wait_ns() if trace else 0
        t0 = _time.perf_counter_ns()
        out = _run_annotated(node, node.process, inputs, time)
        elapsed_ns = _time.perf_counter_ns() - t0
        node.stats_time_ns += elapsed_ns
        if trace or rp is not None:
            w1 = _time.time_ns()
            if rp is not None and (
                rows_in or any(b is not None and not b.is_empty for b in out)
            ):
                # a no-op visit (nothing drained, nothing emitted) touched
                # no request's rows — don't spend the per-tick ring budget
                rp.note_stage(time, f"sweep/{node.name}", w0, w1, rows_in)
        if trace:
            dev_ns = _device_prof.thread_device_wait_ns() - dev0
            self.tracer.span(
                f"sweep/{node.name}",
                w0,
                w1,
                {
                    "pathway.operator.id": node.node_index,
                    "pathway.rows_in": rows_in,
                    "pathway.rows_out": sum(len(b) for b in out if b is not None),
                    "pathway.device_ms": round(dev_ns / 1e6, 3),
                },
            )
            if dev_ns:
                _device_prof.stats().note_span_split(
                    f"sweep/{node.name}", max(0, elapsed_ns - dev_ns), dev_ns
                )
        if aud is not None:
            # audit plane: per-edge cardinality/selectivity counters
            aud.note_edge(node, inputs, out)
        self._route(node, out)

    def _sweep_legacy(self, time: int) -> bool:
        """One full topo scan, one node per step. Active under
        ``PATHWAY_FUSE=off`` (plan is None)."""
        any_work = False
        aud = self._edge_audit()
        for node in self.graph.nodes:
            if not node.has_pending():
                continue
            self._run_node(node, time, aud)
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
        aud = self._edge_audit()
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
                    if self._run_chain(chain, time, aud):
                        any_work = True
                    continue
                node = step.node
                if not node.has_pending():
                    continue
                self._run_node(node, time, aud)
                any_work = True
        finally:
            self._heap = None
        return any_work

    @staticmethod
    def _edge_audit():
        """The audit plane when this tick records edge cardinality, else
        None: the recording rides the plane's deterministic tick sample, so
        an unsampled tick pays this one flag read."""
        aud = _audit.current()
        return aud if aud is not None and aud.edge_sampled else None

    def _run_chain(self, chain, time: int, aud) -> bool:
        """One fused-chain step: drain, hand off member to member, route the
        tail. Span + host/device attribution is per CHAIN — the device wait
        AND any inner traced cold wall are subtracted from the host share so
        cold seconds stay counted once."""
        trace = self._trace_active
        rp = self._rp
        if trace or rp is not None:
            w0 = _time.time_ns()
            dev0 = _device_prof.thread_device_wait_ns() if trace else 0
            cold0 = _device_prof.thread_cold_s() if trace else 0.0
        t0 = _time.perf_counter_ns()
        tok = _phases.start()
        try:
            out, processed, rows_in, rows_out = chain.execute(time, None, aud)
        finally:
            _phases.stop(tok, "fused")
        if not processed:
            return False
        elapsed_ns = _time.perf_counter_ns() - t0
        chain.tail.stats_time_ns += elapsed_ns
        if rp is not None:
            rp.note_stage(
                time, f"sweep/chain{{{chain.label}}}", w0, _time.time_ns(), rows_in
            )
        if trace:
            dev_ns = _device_prof.thread_device_wait_ns() - dev0
            cold_ns = int((_device_prof.thread_cold_s() - cold0) * 1e9)
            name = f"sweep/chain{{{chain.label}}}"
            attrs = {
                "pathway.operator.id": chain.operator_ids(),
                "pathway.chain.nodes": len(chain.members),
                "pathway.rows_in": rows_in,
                "pathway.rows_out": rows_out,
                "pathway.device_ms": round(dev_ns / 1e6, 3),
            }
            if cold_ns:
                attrs["pathway.compile_ms"] = round(cold_ns / 1e6, 3)
            self.tracer.span(name, w0, _time.time_ns(), attrs)
            if dev_ns:
                _device_prof.stats().note_span_split(
                    name, max(0, elapsed_ns - dev_ns - cold_ns), dev_ns
                )
        self._route(chain.tail, out)
        return True

    def run_tick(self, time: int) -> None:
        """Process everything pending at logical ``time`` to quiescence, then
        advance the frontier past it."""
        self.current_time = time
        # device plane: steps an armed profiler window, stamps the flight
        # recorder's tick ring (two global reads when profiling is off)
        _device_prof.tick_hook(time)
        tracer = self.tracer
        tick_token = tracer.begin_tick(time) if tracer is not None else None
        self._trace_active = tick_token is not None
        # request plane: active for this tick only while a request is in
        # flight (one global read + one flag read); transient inner graphs
        # keep their own tick numbering out of the ring
        rp = None if self.transient else _requests.current()
        if rp is not None and (not rp.hot or time == END_OF_STREAM):
            rp = None
        self._rp = rp
        if rp is not None:
            rp.note_tick(time)
        aud = _audit.current()
        if aud is not None:
            aud.begin_tick(time)
        plan = self.plan
        pollers = self.graph.nodes if plan is None else plan.pollers
        for node in pollers:
            polled = _run_annotated(node, node.poll, time)
            if polled:
                # fault plan (flip_diff/drop_retract) corrupts BEFORE the
                # audit monitors observe — the tripwire sees exactly what the
                # engine will
                polled = _faults.corrupt_polled(0, time, polled)
                if aud is not None:
                    aud.observe_input(node, polled, time)
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
        if tick_token is not None:
            self._trace_active = False
            tracer.end_tick(time, tick_token)

    def close(self) -> None:
        """Input exhausted: flush temporal buffers and fire end callbacks."""
        self.run_tick(END_OF_STREAM)
        for node in self.graph.nodes:
            node.on_end()
