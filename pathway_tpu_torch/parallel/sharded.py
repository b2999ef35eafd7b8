"""Multi-worker sharded execution of the engine graph.

The reference's worker model (SURVEY §2.9, ``worker-architecture.md``): every
worker builds the IDENTICAL dataflow; records are exchanged between workers by
key shard before stateful operators; progress (the tick frontier) advances in
lockstep. This module is the block-engine version:

- ``ShardedRuntime(n_workers)`` builds one engine graph per worker from the same
  logical outputs (node indices align across workers by construction).
- At routing time, a consumer's :meth:`Node.exchange_key` decides placement:
  ``None`` → stay on the producing worker (stateless op); a key function →
  split the block by ``shard_of_keys`` and deliver each piece to its owner —
  numeric blocks may instead ride the on-device exchange plane
  (``parallel/device_plane.py``, ``PATHWAY_DEVICE_EXCHANGE``); ``SOLO`` →
  everything to worker 0 (serial operators: non-partitioned sources,
  unsharded sinks, sort's global order, non-shardable external indexes).
  Partitioned sources (``local_source`` nodes, e.g. Kafka) poll on their OWN
  worker with disjoint partition slices, and ``fs.write(sharded=True)`` sinks
  write per-worker shards with an ordered merge-commit (reference
  ``worker-architecture.md:36-47``). The temporal plane
  shards: temporal/asof-now joins by join key, session windows by instance,
  buffer/forget/freeze row state by row key with one shared watermark cell
  per logical node (``internals/time_ops._SharedWatermark``).
- Each tick runs sweep rounds: all workers sweep concurrently (threads), then
  meet at a barrier; the tick ends when a round does no work anywhere. The
  frontier phase runs the same way, so every worker passes timestamp t before
  any sees t+1 — the global consistency frontier.

Worker threads parallelize the host-side state machinery (hash joins, group
state); the FLOP-heavy work inside nodes (embedders, rerankers, KNN
searches) launches on the card from each worker's thread. The same exchange
contract carries to multi-process in ``parallel/cluster.py`` (blocks
serialized between processes instead of handed between threads).

Carried from ``pathway_tpu/parallel/sharded.py``, with the hooks the port's
single ``Runtime`` has: the fault plan (``drop_poll`` skips a tick), the
health plane's ready/draining marks, the refusal of an exactly-once sink
without persistence, and the persistence, flow, audit, timeline, request and
device planes as in the reference.
"""

from __future__ import annotations

import heapq
import threading
from typing import Any

import numpy as np

from pathway_tpu_torch.engine import fusion as _fusion
from pathway_tpu_torch.engine.blocks import DeltaBatch
from pathway_tpu_torch.engine.graph import BROADCAST, END_OF_STREAM, SOLO, EngineGraph, Node
from pathway_tpu_torch.internals.logical import BuildContext, LogicalNode
from pathway_tpu_torch.internals.trace import run_annotated
from pathway_tpu_torch.observability import audit as _audit
from pathway_tpu_torch.observability import engine_phases as _phases
from pathway_tpu_torch.observability import requests as _requests
from pathway_tpu_torch.parallel.mesh import shard_of_keys
from pathway_tpu_torch.resilience import faults as _faults


class _Worker:
    def __init__(self, index: int, graph: EngineGraph):
        self.index = index
        self.graph = graph
        self.lock = threading.Lock()  # guards cross-worker accepts
        # fused-chain sweep plan (interior links restricted to exchange-free
        # consumers: fusing across an exchange would move rows off the worker
        # the unfused routing would have placed them on)
        self.plan = _fusion.build_plan(graph, exchange_aware=True)
        #: dirty step positions (guarded by ``lock`` — marks arrive from any
        #: worker thread routing into this worker's graph)
        self.dirty: set[int] = set()
        #: the active sweep's heap — only this worker's own thread touches it
        self.sweep_heap: list[int] | None = None

    def mark_dirty_locked(self, node_index: int) -> None:
        """Mark the step owning ``node_index`` dirty. Caller holds ``lock``.
        No-op in legacy (PATHWAY_FUSE=off) mode — the full-scan sweep finds
        pending work by walking every node."""
        if self.plan is not None:
            self.dirty.add(self.plan.pos_of[node_index])


class ShardedRuntime:
    """Drives W aligned engine graphs tick by tick with key-shard exchange.

    API-compatible with ``engine.runtime.Runtime`` where the single-worker
    code paths touch it (connectors, persistence hooks are worker-0 concerns).
    """

    def __init__(
        self,
        n_workers: int = 2,
        monitoring_level: Any = None,
        autocommit_duration_ms: int | None = 20,
    ):
        if n_workers < 1:
            raise ValueError("need at least one worker")
        self.n_workers = n_workers
        self.autocommit_duration_ms = autocommit_duration_ms
        self.monitoring_level = monitoring_level
        self.connectors: list[Any] = []
        self.persistence: Any = None
        self.workers: list[_Worker] = []
        self._stop_requested = False
        self.streaming = False  # set after build (see engine.runtime.Runtime)
        self.current_time = 0
        self.on_tick_done: list[Any] = []
        # arrival-driven tick scheduling (REST serving plane wakeups)
        from pathway_tpu_torch.engine.runtime import TickWakeup

        self.wakeup = TickWakeup()
        # live tracing (observability): installed in run(), None when off
        self.tracer = None
        self._trace_active = False
        # request-scoped tracing: the plane while a request is in flight this
        # tick, else None (see engine.graph.Scheduler)
        self._rp = None
        # on-device key exchange for numeric blocks (None = host-only;
        # see parallel/device_plane.py and PATHWAY_DEVICE_EXCHANGE)
        from pathway_tpu_torch.parallel.device_plane import make_device_plane

        self.device_plane = make_device_plane(n_workers)

    def register_connector(self, driver) -> None:
        self.connectors.append(driver)

    def request_stop(self) -> None:
        self._stop_requested = True

    # ---------------------------------------------------------------- build
    def _build(self, outputs: list[LogicalNode]) -> None:
        # peers build first, worker 0 LAST: node factories may capture the built
        # node into shared holders (connector subjects, rest holders) — the last
        # build must be the one whose sources actually receive events and poll
        self.workers = [None] * self.n_workers  # type: ignore[list-item]
        for w in list(range(1, self.n_workers)) + [0]:
            ctx = BuildContext(
                runtime=self if w == 0 else None,
                worker_index=w,
                n_workers=self.n_workers,
                register=self.register_connector,
                shared_runtime=self,
            )
            for out in outputs:
                ctx.resolve(out)
            if w == 0:
                ctx.finish()
                self._ctx0 = ctx
            self.workers[w] = _Worker(w, ctx.graph)
        sizes = {len(w.graph.nodes) for w in self.workers}
        assert len(sizes) == 1, "worker graphs misaligned"

    # ---------------------------------------------------------------- routing
    def _accept_local(self, worker: _Worker, ci: int, port: int, batch) -> None:
        """Same-worker accept from the worker's own thread: a mid-sweep mark
        goes straight onto the active heap (edges only point forward), so
        the consumer runs in this same sweep — exactly the scan order the
        full-walk sweep had."""
        worker.graph.nodes[ci].accept(port, batch)
        if worker.plan is None:
            return  # legacy mode: the full scan finds it
        h = worker.sweep_heap
        if h is not None:
            heapq.heappush(h, worker.plan.pos_of[ci])
        else:
            with worker.lock:
                worker.mark_dirty_locked(ci)

    def _route(self, worker: _Worker, producer: Node, batches: list[DeltaBatch]) -> bool:
        routed = False
        consumers = worker.graph.edges.get(producer.node_index, [])
        for batch in batches:
            if batch is None or batch.is_empty:
                continue
            producer.stats_rows_out += len(batch)
            for ci, port in consumers:
                consumer = worker.graph.nodes[ci]
                key_fn = consumer.exchange_key(port)
                if key_fn is None:
                    self._accept_local(worker, ci, port, batch)
                    routed = True
                elif key_fn == SOLO:
                    target = self.workers[0]
                    dest = target.graph.nodes[ci]
                    with target.lock:
                        dest.accept(port, batch)
                        target.mark_dirty_locked(ci)
                    routed = True
                elif key_fn == BROADCAST:
                    for target in self.workers:
                        dest = target.graph.nodes[ci]
                        with target.lock:
                            dest.accept(port, batch)
                            target.mark_dirty_locked(ci)
                    routed = True
                else:
                    if self.n_workers == 1:
                        self._accept_local(worker, ci, port, batch)
                        routed = True
                        continue
                    route_keys = np.asarray(key_fn(batch), dtype=np.uint64)
                    if (
                        self.device_plane is not None
                        and self.device_plane.should_stage(batch)
                    ):
                        # numeric fast lane: the block rides the mesh at the
                        # next flush instead of host-splitting here
                        self.device_plane.stage(
                            ci, port, worker.index, route_keys, batch
                        )
                        routed = True
                        continue
                    shards = shard_of_keys(route_keys, self.n_workers)
                    for w_idx in np.unique(shards):
                        piece = batch.take(np.flatnonzero(shards == w_idx))
                        target = self.workers[int(w_idx)]
                        dest = target.graph.nodes[ci]
                        with target.lock:
                            dest.accept(port, piece)
                            target.mark_dirty_locked(ci)
                        routed = True
        return routed

    # ---------------------------------------------------------------- ticking
    def _sweep_worker_legacy(self, worker: _Worker, time: int) -> bool:
        """The per-worker full-scan sweep (PATHWAY_FUSE=off)."""
        import time as _t

        any_work = False
        trace = self._trace_active
        rp = self._rp
        aud = _audit.current()
        aud_note = aud is not None and aud.edge_sampled
        for node in worker.graph.nodes:
            with worker.lock:
                if not node.has_pending():
                    continue
                inputs = node.drain()
            rows_in = sum(len(b) for b in inputs if b is not None)
            node.stats_rows_in += rows_in
            if trace or rp is not None:
                from pathway_tpu_torch.observability import device as _dev_prof

                w0 = _t.time_ns()
                dev0 = _dev_prof.thread_device_wait_ns() if trace else 0
            out = run_annotated(node, node.process, inputs, time)
            if trace or rp is not None:
                w1 = _t.time_ns()
                if rp is not None and (
                    rows_in
                    or any(b is not None and not b.is_empty for b in out)
                ):
                    # a no-op visit (nothing drained, nothing emitted) touched
                    # no request's rows — don't spend the per-tick ring budget
                    rp.note_stage(time, f"sweep/{node.name}", w0, w1, rows_in)
            if trace:
                dev_ns = _dev_prof.thread_device_wait_ns() - dev0
                self.tracer.span(
                    f"sweep/{node.name}",
                    w0,
                    w1,
                    {
                        "pathway.operator.id": node.node_index,
                        "pathway.worker": worker.index,
                        "pathway.rows_in": rows_in,
                        "pathway.device_ms": round(dev_ns / 1e6, 3),
                    },
                )
                if dev_ns:
                    _dev_prof.stats().note_span_split(
                        f"sweep/{node.name}", max(0, w1 - w0 - dev_ns), dev_ns
                    )
            if aud_note:
                aud.note_edge(node, inputs, out)
            if self._route(worker, node, out):
                any_work = True
            any_work = any_work or any(b is not None for b in inputs)
        return any_work

    def _sweep_worker(self, worker: _Worker, time: int) -> bool:
        import time as _t

        if worker.plan is None:
            return self._sweep_worker_legacy(worker, time)
        with worker.lock:
            if not worker.dirty:
                return False
            heap = sorted(worker.dirty)
            worker.dirty.clear()
        worker.sweep_heap = heap
        any_work = False
        trace = self._trace_active
        rp = self._rp
        aud = _audit.current()
        aud_note = aud is not None and aud.edge_sampled
        by_pos = worker.plan.by_pos
        last = -1
        try:
            while heap:
                pos = heapq.heappop(heap)
                if pos == last:
                    continue
                last = pos
                step = by_pos[pos]
                chain = step.chain
                if chain is not None:
                    if self._run_chain(worker, chain, time, trace, aud if aud_note else None):
                        any_work = True
                    continue
                node = step.node
                with worker.lock:
                    if not node.has_pending():
                        continue
                    inputs = node.drain()
                rows_in = sum(len(b) for b in inputs if b is not None)
                node.stats_rows_in += rows_in
                if trace or rp is not None:
                    from pathway_tpu_torch.observability import device as _dev_prof

                    w0 = _t.time_ns()
                    dev0 = _dev_prof.thread_device_wait_ns() if trace else 0
                out = run_annotated(node, node.process, inputs, time)
                if trace or rp is not None:
                    w1 = _t.time_ns()
                    if rp is not None and (
                        rows_in
                        or any(b is not None and not b.is_empty for b in out)
                    ):
                        # a no-op visit (nothing drained, nothing emitted) touched
                        # no request's rows — don't spend the per-tick ring budget
                        rp.note_stage(time, f"sweep/{node.name}", w0, w1, rows_in)
                if trace:
                    dev_ns = _dev_prof.thread_device_wait_ns() - dev0
                    self.tracer.span(
                        f"sweep/{node.name}",
                        w0,
                        w1,
                        {
                            "pathway.operator.id": node.node_index,
                            "pathway.worker": worker.index,
                            "pathway.rows_in": rows_in,
                            "pathway.device_ms": round(dev_ns / 1e6, 3),
                        },
                    )
                    if dev_ns:
                        _dev_prof.stats().note_span_split(
                            f"sweep/{node.name}", max(0, w1 - w0 - dev_ns), dev_ns
                        )
                if aud_note:
                    # per-edge cardinality counters (node instances are
                    # per-worker, so no cross-thread contention; read side
                    # sums by position)
                    aud.note_edge(node, inputs, out)
                self._route(worker, node, out)
                any_work = True
        finally:
            worker.sweep_heap = None
        return any_work

    def _run_chain(self, worker: _Worker, chain, time: int, trace: bool, aud) -> bool:
        """One fused-chain step on this worker (see Scheduler._run_chain:
        per-chain span, device wait AND inner traced-jit cold walls
        subtracted from the host share)."""
        import time as _t

        from pathway_tpu_torch.observability import device as _dev_prof

        rp = self._rp
        if trace or rp is not None:
            w0 = _t.time_ns()
            dev0 = _dev_prof.thread_device_wait_ns() if trace else 0
            cold0 = _dev_prof.thread_cold_s() if trace else 0.0
        t0 = _t.perf_counter_ns()
        tok = _phases.start()
        try:
            out, processed, rows_in, rows_out = chain.execute(
                time, worker.lock, aud
            )
        finally:
            _phases.stop(tok, "fused")
        if not processed:
            return False
        elapsed_ns = _t.perf_counter_ns() - t0
        chain.tail.stats_time_ns += elapsed_ns
        if rp is not None:
            rp.note_stage(
                time, f"sweep/chain{{{chain.label}}}", w0, _t.time_ns(), rows_in
            )
        if trace:
            w1 = _t.time_ns()
            dev_ns = _dev_prof.thread_device_wait_ns() - dev0
            cold_ns = int((_dev_prof.thread_cold_s() - cold0) * 1e9)
            name = f"sweep/chain{{{chain.label}}}"
            attrs = {
                "pathway.operator.id": chain.operator_ids(),
                "pathway.worker": worker.index,
                "pathway.chain.nodes": len(chain.members),
                "pathway.rows_in": rows_in,
                "pathway.rows_out": rows_out,
                "pathway.device_ms": round(dev_ns / 1e6, 3),
            }
            if cold_ns:
                attrs["pathway.compile_ms"] = round(cold_ns / 1e6, 3)
            self.tracer.span(name, w0, w1, attrs)
            if dev_ns:
                _dev_prof.stats().note_span_split(
                    name, max(0, elapsed_ns - dev_ns - cold_ns), dev_ns
                )
        self._route(worker, chain.tail, out)
        return True

    def _parallel(self, fn) -> list:
        """Run fn(worker) on every worker concurrently; collect results.
        A worker exception (e.g. terminate_on_error aborting a batch) is
        re-raised here so the run fails loudly instead of silently dropping
        that worker's batch."""
        results = [None] * self.n_workers
        if self.n_workers == 1:
            results[0] = fn(self.workers[0])
            return results
        errors: list[BaseException | None] = [None] * self.n_workers
        threads = []
        for i, w in enumerate(self.workers):
            def target(i=i, w=w):
                try:
                    results[i] = fn(w)
                except BaseException as e:  # noqa: BLE001 — transported to caller
                    errors[i] = e

            t = threading.Thread(target=target)
            t.start()
            threads.append(t)
        for t in threads:
            t.join()
        for e in errors:
            if e is not None:
                raise e
        return results

    def _deliver(self, worker: int, ci: int, port: int, batch: DeltaBatch) -> None:
        target = self.workers[worker]
        with target.lock:
            target.graph.nodes[ci].accept(port, batch)
            target.mark_dirty_locked(ci)

    def _sweep_round(self, time: int) -> bool:
        """All workers sweep concurrently, then the device plane flushes its
        staged blocks through one collective per group — the exchange lands
        as new pending work, picked up by the next round."""
        any_work = any(self._parallel(lambda w: self._sweep_worker(w, time)))
        if self.device_plane is not None and self.device_plane.flush(
            self._deliver, time
        ):
            any_work = True
        return any_work

    def run_tick(self, time: int) -> None:
        self.current_time = time
        from pathway_tpu_torch.observability import device as _dev_prof

        _dev_prof.tick_hook(time)
        tracer = self.tracer
        tick_token = tracer.begin_tick(time) if tracer is not None else None
        self._trace_active = tick_token is not None
        rp = _requests.current()
        if rp is not None and (not rp.hot or time == END_OF_STREAM):
            rp = None
        self._rp = rp
        if rp is not None:
            rp.note_tick(time)
        # non-partitioned sources live on worker 0 only — peers' copies never
        # poll (polling them would duplicate every input row per worker);
        # partitioned sources (``local_source``) poll on their OWN worker,
        # each subject owning a disjoint partition slice (reference
        # worker-architecture.md:36-47)
        aud = _audit.current()
        if aud is not None:
            aud.begin_tick(time)

        def _polled(w, node):
            polled = run_annotated(node, node.poll, time)
            if polled:
                # corruption faults apply before the audit monitors observe
                polled = _faults.corrupt_polled(0, time, polled)
                if aud is not None:
                    aud.observe_input(node, polled, time)
            return polled

        def _nodes(w, kind):
            if w.plan is None:
                return w.graph.nodes
            return getattr(w.plan, kind)

        w0 = self.workers[0]
        for node in _nodes(w0, "pollers"):
            self._route(w0, node, _polled(w0, node))
        for w in self.workers[1:]:
            for node in _nodes(w, "pollers"):
                if getattr(node, "local_source", False):
                    self._route(w, node, _polled(w, node))
        while self._sweep_round(time):
            pass
        progressed = True
        while progressed:
            progressed = False
            for w in self.workers:
                for node in _nodes(w, "frontier_nodes"):
                    out = run_annotated(node, node.on_frontier, time)
                    if self._route(w, node, out):
                        progressed = True
            if progressed:
                while self._sweep_round(time):
                    pass
        for w in self.workers:
            for node in _nodes(w, "tick_complete_nodes"):
                run_annotated(node, node.on_tick_complete, time)
        for cb in self.on_tick_done:
            cb(time)
        if tick_token is not None:
            self._trace_active = False
            tracer.end_tick(time, tick_token)

    # ---------------------------------------------------------------- run loop
    def run(self, outputs: list[LogicalNode]):
        import time as _time

        from pathway_tpu_torch import flow as _flow
        from pathway_tpu_torch import observability as _obs

        _faults.install_from_env()  # fault plan resets per run (as in Runtime)
        _obs.install_from_env(self)
        _flow.install_from_env(self)  # before build: gates attach to inputs
        try:
            self.tracer = _obs.current()
            return self._run_inner(outputs)
        except BaseException as e:
            _obs.device.on_run_error(e, self)  # flight-recorder post-mortem
            raise
        finally:
            self.tracer = None
            _obs.shutdown()
            _flow.shutdown()

    def _run_inner(self, outputs: list[LogicalNode]):
        import time as _time

        from pathway_tpu_torch.engine.runtime import check_connector_failures, refuse_unpersisted_delivery
        from pathway_tpu_torch.observability import health as _health

        self._build(outputs)
        self.streaming = bool(self.connectors)
        refuse_unpersisted_delivery(self.persistence, self.workers[0].graph.nodes)
        if self.persistence is not None:
            self.persistence.on_graph_built(self._ctx0)
            self.on_tick_done.append(self.persistence.on_tick_done)

        from pathway_tpu_torch import flow as _flow

        plane = _flow.current()
        if plane is not None:
            self.on_tick_done.append(lambda t: plane.on_tick_complete(self, t))
        for driver in self.connectors:
            driver.start()
        # connectors live, graphs built: this door may receive traffic
        _health.mark_ready()
        if not self.connectors:
            _faults.on_tick_start(0, 0)
            self.run_tick(0)
            self.close()
            return self
        tick = 0
        period = (self.autocommit_duration_ms or 20) / 1000.0
        all_virtual = all(getattr(d, "virtual", False) for d in self.connectors)
        try:
            while not self._stop_requested:
                t0 = _time.perf_counter()
                if _faults.on_tick_start(0, tick):
                    # drop_poll fault: this tick is skipped entirely — events
                    # keep buffering in the input nodes for the next tick
                    tick += 1
                    _time.sleep(period)
                    continue
                self.run_tick(tick)
                tick += 1
                check_connector_failures(self.connectors)
                if all(d.is_finished() for d in self.connectors):
                    self.run_tick(tick)
                    break
                if not all_virtual:
                    elapsed = _time.perf_counter() - t0
                    if elapsed < period:
                        self.wakeup.wait(period - elapsed)
        finally:
            # doors answer 503 + Retry-After from here on
            _health.mark_draining("shutdown")
            for driver in self.connectors:
                driver.stop()
        # re-check: a subject may error between the in-loop check and the
        # is_finished break (see engine.runtime.Runtime.run)
        check_connector_failures(self.connectors)
        self.close()
        return self

    def close(self) -> None:
        self.run_tick(END_OF_STREAM)
        for w in self.workers:
            for node in w.graph.nodes:
                node.on_end()
        if self.persistence is not None:
            self.persistence.on_close()

    # Runtime API used by debug capture
    @property
    def scheduler(self):
        return self
