"""Multi-process cluster execution — cross-process block exchange.

Role of the reference's timely ``CommunicationConfig::Cluster`` (intra-process
channels + inter-process TCP with length-delimited frames,
``external/timely-dataflow/communication/src/networking.rs``,
``src/engine/dataflow/config.rs:63-120``): the global worker space is
``threads × processes``; worker ``w`` lives on process ``w // threads``. Every
process builds the identical dataflow for its local workers; a batch routed to a
remote worker is serialized (length-prefixed pickle) to the owning process.

Progress is coordinated, not gossiped: process 0 runs a tick coordinator. A tick
is a sequence of rounds — each process sweeps its local workers to quiescence,
reports ``(did_work, n_sent, n_received)``, and the coordinator declares the
round set done when nobody worked and global sent == received (simple
termination detection standing in for timely's distributed progress tracking —
correct here because ticks are globally ordered and sends only happen inside
rounds). The same barrier runs the frontier phase, so every process passes
timestamp t before any sees t+1.

This plane carries only control + relational blocks; the FLOP-heavy work
(embedders, rerankers, KNN searches) stays on each process's card. The design
keeps the two planes independent, like the reference keeps connector I/O
threads out of the timely workers.

Carried from ``pathway_tpu/parallel/cluster.py``. Port layout: the coordinator
listens on ``PATHWAY_FIRST_PORT``, process ``p``'s block links on
``first_port + 1 + p``, the heartbeat monitor on ``first_port + processes +
1``, the serving fabric's transport (``PATHWAY_FABRIC=on``) on ``first_port +
processes + 2 + p``. ``PATHWAY_SHARDMAP=on`` places keys by the versioned
shard map (``internals/shardmap.py``). The elasticity plane
(``PATHWAY_ELASTIC``) rides the continuation barrier: a rescale decision
quiesces the pod to one committed epoch, and every process exits with
``elastic.RESCALE_EXIT_CODE`` for a supervisor to relaunch at the new shape.
"""

from __future__ import annotations

import pickle
import select
import socket
import struct
import threading
import time as _time
from typing import Any

import numpy as np

from pathway_tpu_torch.engine.blocks import DeltaBatch
from pathway_tpu_torch.engine import fusion as _fusion
from pathway_tpu_torch.engine.graph import BROADCAST, END_OF_STREAM, SOLO, Node
from pathway_tpu_torch.internals.config import get_pathway_config
from pathway_tpu_torch.internals.errors import OtherWorkerError
from pathway_tpu_torch.internals.logical import BuildContext, LogicalNode
from pathway_tpu_torch.internals.trace import run_annotated
from pathway_tpu_torch.observability import audit as _audit
from pathway_tpu_torch.observability import engine_phases as _phases
from pathway_tpu_torch.observability import requests as _requests
from pathway_tpu_torch.parallel.mesh import shard_of_keys
from pathway_tpu_torch.resilience import faults as _faults

import heapq


def cluster_env() -> tuple[int, int, int, int]:
    """(threads, processes, process_id, first_port) from PathwayConfig."""
    cfg = get_pathway_config()
    return cfg.threads, cfg.processes, cfg.process_id, cfg.first_port


def barrier_timeout() -> float:
    """Seconds a barrier participant waits before declaring a peer dead."""
    return get_pathway_config().barrier_timeout


def _send_msg(sock: socket.socket, obj: Any) -> None:
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(struct.pack("<Q", len(payload)) + payload)


def _recv_msg(sock: socket.socket) -> Any:
    header = _recv_exact(sock, 8)
    if header is None:
        return None
    (n,) = struct.unpack("<Q", header)
    payload = _recv_exact(sock, n)
    if payload is None:
        return None
    return pickle.loads(payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes | None:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


class _PeerLinks:
    """Pairwise TCP links between processes with a receiver thread per peer."""

    def __init__(self, pid: int, n_proc: int, first_port: int, on_block, host: str = "127.0.0.1"):
        self.pid = pid
        self.n_proc = n_proc
        self.first_port = first_port
        self.host = host
        self.on_block = on_block  # callback(worker, node_index, port, batch)
        self.sent = 0
        self.received = 0
        # counter lock is never held across socket I/O; each peer socket has its
        # own send lock so a full TCP buffer on one link can't stall the others
        # (or the receiver threads, which only need the counter lock)
        self._counter_lock = threading.Lock()
        self._conn_lock = threading.Lock()
        self._out: dict[int, socket.socket] = {}
        self._send_locks: dict[int, threading.Lock] = {}
        self.error: BaseException | None = None
        self._closed = False
        self._threads: list[threading.Thread] = []
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, first_port + 1 + pid))
        self._listener.listen(n_proc)
        # start the accept thread LAST: it reads instance attributes immediately
        self._accepting = threading.Thread(target=self._accept_loop, daemon=True)
        self._accepting.start()

    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            t = threading.Thread(target=self._recv_loop, args=(conn,), daemon=True)
            t.start()
            self._threads.append(t)

    def _recv_loop(self, conn: socket.socket) -> None:
        try:
            while True:
                msg = _recv_msg(conn)
                if msg is None:
                    return
                kind, worker, node_index, port, payload = msg
                if kind != "block":
                    raise RuntimeError(f"unexpected cluster message kind {kind!r}")
                keys, diffs, data, t = payload
                batch = DeltaBatch(keys, diffs, data, t)
                self.on_block(worker, node_index, port, batch)
                with self._counter_lock:
                    self.received += 1
        except BaseException as exc:  # surface to the main loop; don't die silently
            if not self._closed:
                self.error = exc
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def check_error(self) -> None:
        if self.error is not None:
            raise RuntimeError("cluster peer link failed") from self.error

    def _conn_to(self, peer: int) -> tuple[socket.socket, threading.Lock]:
        with self._conn_lock:
            sock = self._out.get(peer)
            if sock is not None:
                return sock, self._send_locks[peer]
        deadline = _time.time() + 30
        while True:
            try:
                sock = socket.create_connection(
                    (self.host, self.first_port + 1 + peer), timeout=5
                )
                break
            except OSError:
                if _time.time() > deadline:
                    raise
                _time.sleep(0.05)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        with self._conn_lock:
            if peer in self._out:  # lost the race; use the winner's socket
                try:
                    sock.close()
                except OSError:
                    pass
                return self._out[peer], self._send_locks[peer]
            self._out[peer] = sock
            lock = self._send_locks[peer] = threading.Lock()
        return sock, lock

    def send_block(self, peer: int, worker: int, node_index: int, port: int, batch: DeltaBatch) -> None:
        sock, lock = self._conn_to(peer)
        with lock:
            _send_msg(
                sock,
                ("block", worker, node_index, port, (batch.keys, batch.diffs, batch.data, batch.time)),
            )
        with self._counter_lock:
            self.sent += 1

    def counters(self) -> tuple[int, int]:
        with self._counter_lock:
            return self.sent, self.received

    def close(self) -> None:
        self._closed = True
        try:
            self._listener.close()
        except OSError:
            pass
        for s in self._out.values():
            try:
                s.close()
            except OSError:
                pass


#: select() granularity while waiting on a barrier — how often the failure
#: detector is consulted, NOT an added latency (a ready socket returns at once)
_BARRIER_POLL_S = 0.2


class _Coordinator:
    """Process 0's barrier service: collects per-round reports, answers
    continue/advance/close decisions to every process (including itself).

    Peers identify themselves with a ``("join", pid)`` handshake, so a dead
    barrier connection maps to a process id. While waiting for reports the
    coordinator polls the heartbeat monitor (``resilience/heartbeat.py``):
    a peer that died (socket EOF) or went silent past ``heartbeat_timeout``
    surfaces as a structured ``OtherWorkerError`` naming the process and its
    last-known tick — broadcast to the surviving peers before raising, so the
    whole cluster fails with the same diagnosis instead of a cascade of bare
    timeouts (the reference's worker-panic propagation, SURVEY §5.3)."""

    def __init__(
        self, n_proc: int, first_port: int, host: str = "127.0.0.1", monitor: Any = None
    ):
        self.n_proc = n_proc
        self.monitor = monitor
        self._server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._server.bind((host, first_port))
        self._server.listen(n_proc)
        self._conns: dict[int, socket.socket] = {}

    def wait_connections(self) -> None:
        deadline = _time.monotonic() + barrier_timeout()
        self._server.settimeout(_BARRIER_POLL_S)
        while len(self._conns) < self.n_proc - 1:
            try:
                conn, _ = self._server.accept()
            except socket.timeout:
                if _time.monotonic() > deadline:
                    missing = sorted(set(range(1, self.n_proc)) - set(self._conns))
                    raise OtherWorkerError(
                        f"cluster startup timed out: process(es) {missing} never "
                        f"joined ({len(self._conns) + 1}/{self.n_proc} up)",
                        process_id=missing[0] if missing else None,
                        reason="never-joined",
                    ) from None
                continue
            conn.settimeout(barrier_timeout())
            msg = _recv_msg(conn)
            if not (isinstance(msg, tuple) and len(msg) == 2 and msg[0] == "join"):
                raise RuntimeError(f"unexpected cluster join message {msg!r}")
            self._conns[int(msg[1])] = conn

    def _peer_failed(self, pid: int | None, tick: int | None, reason: str) -> None:
        """Broadcast the failure diagnosis to survivors, then raise."""
        fail = {"__fail__": {"process_id": pid, "tick": tick, "reason": reason}}
        for conn in self._conns.values():
            try:
                _send_msg(conn, fail)
            except OSError:
                pass
        at = f" (last alive at tick {tick})" if tick is not None else ""
        raise OtherWorkerError(
            f"cluster process {pid} failed: {reason}{at}",
            process_id=pid,
            tick=tick,
            reason=reason,
        )

    def _check_detector(self) -> None:
        if self.monitor is None:
            return
        dead = self.monitor.dead_peer()
        if dead is not None:
            pid, tick, reason = dead
            self._peer_failed(pid, tick, reason)

    def _recv_report(self, pid: int, conn: socket.socket, deadline: float) -> Any:
        while True:
            self._check_detector()
            try:
                readable, _, _ = select.select([conn], [], [], _BARRIER_POLL_S)
            except OSError:
                self._peer_failed(pid, self._last_tick(pid), "disconnected")
            if readable:
                break
            if _time.monotonic() > deadline:
                self._peer_failed(pid, self._last_tick(pid), "barrier-timeout")
        # readable: the full frame follows promptly (the sender uses sendall);
        # keep a generous timeout as a backstop against a torn write
        conn.settimeout(max(5.0, deadline - _time.monotonic()))
        try:
            msg = _recv_msg(conn)
        except socket.timeout:
            self._peer_failed(pid, None, "barrier-timeout")
        except OSError:
            # a SIGKILLed peer with unread data queued sends RST — a reset is
            # the same diagnosis as clean EOF: the peer is gone
            self._peer_failed(pid, self._last_tick(pid), "disconnected")
        if msg is None:
            self._peer_failed(pid, self._last_tick(pid), "disconnected")
        return msg

    def _last_tick(self, pid: int) -> int | None:
        return self.monitor.seen_peers().get(pid) if self.monitor else None

    def barrier(self, my_report: Any, decide) -> Any:
        """Collect one report from every peer + self, apply ``decide`` over the
        list, broadcast and return the decision."""
        reports = [my_report]
        deadline = _time.monotonic() + barrier_timeout()
        for pid, conn in self._conns.items():
            reports.append(self._recv_report(pid, conn, deadline))
        decision = decide(reports)
        for pid, conn in self._conns.items():
            try:
                _send_msg(conn, decision)
            except OSError:
                # the peer died after reporting: surface the structured
                # diagnosis (and tell the other survivors) instead of dying
                # on a bare broken pipe
                self._peer_failed(pid, self._last_tick(pid), "disconnected")
        return decision

    def close(self) -> None:
        for c in self._conns.values():
            try:
                c.close()
            except OSError:
                pass
        try:
            self._server.close()
        except OSError:
            pass


class _CoordinatorClient:
    def __init__(
        self, pid: int, first_port: int, host: str = "127.0.0.1", hb_client: Any = None
    ):
        self.pid = pid
        self.hb = hb_client  # HeartbeatClient: flags a vanished coordinator
        deadline = _time.time() + 30
        while True:
            try:
                self._sock = socket.create_connection((host, first_port), timeout=5)
                break
            except OSError:
                if _time.time() > deadline:
                    raise
                _time.sleep(0.05)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        _send_msg(self._sock, ("join", pid))

    def _coordinator_lost(self, reason: str) -> None:
        raise OtherWorkerError(
            f"cluster coordinator (process 0) lost: {reason}",
            process_id=0,
            reason=reason,
        )

    def barrier(self, my_report: Any, decide=None) -> Any:
        try:
            _send_msg(self._sock, my_report)
        except OSError:
            self._coordinator_lost("disconnected")
        deadline = _time.monotonic() + barrier_timeout()
        while True:
            if self.hb is not None and self.hb.coordinator_lost:
                self._coordinator_lost("coordinator-lost")
            try:
                readable, _, _ = select.select([self._sock], [], [], _BARRIER_POLL_S)
            except OSError:
                self._coordinator_lost("disconnected")
            if readable:
                break
            if _time.monotonic() > deadline:
                self._coordinator_lost("barrier-timeout")
        self._sock.settimeout(max(5.0, deadline - _time.monotonic()))
        try:
            decision = _recv_msg(self._sock)
        except socket.timeout:
            self._coordinator_lost("barrier-timeout")
        except OSError:
            self._coordinator_lost("disconnected")  # RST counts as gone
        if decision is None:
            self._coordinator_lost("disconnected")
        if isinstance(decision, dict) and "__fail__" in decision:
            f = decision["__fail__"]
            at = f" (last alive at tick {f['tick']})" if f["tick"] is not None else ""
            raise OtherWorkerError(
                f"cluster process {f['process_id']} failed: {f['reason']}{at}",
                process_id=f["process_id"],
                tick=f["tick"],
                reason=f["reason"],
            )
        return decision

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


class _LocalWorker:
    def __init__(self, global_index: int, graph):
        self.index = global_index
        self.graph = graph
        self.lock = threading.Lock()
        # fused-chain sweep plan (exchange-aware: see parallel/sharded.py)
        self.plan = _fusion.build_plan(graph, exchange_aware=True)
        #: dirty step positions, guarded by ``lock`` (marks arrive from peer
        #: link reader threads and sibling worker threads)
        self.dirty: set[int] = set()
        #: the active sweep's forward-insertion heap (own thread only)
        self.sweep_heap: list[int] | None = None

    def mark_dirty_locked(self, node_index: int) -> None:
        # no-op in legacy (PATHWAY_FUSE=off) mode: the full scan finds work
        if self.plan is not None:
            self.dirty.add(self.plan.pos_of[node_index])


class ClusterRuntime:
    """Sharded runtime spanning multiple processes.

    Worker ``w``'s graph exists only on its owning process; routing resolves the
    target worker by shard, then delivers locally or over the peer link. Every
    process must execute the same program (same logical graph), like the
    reference's per-worker ``logic`` closure.
    """

    def __init__(
        self,
        monitoring_level: Any = None,
        autocommit_duration_ms: int | None = 20,
    ):
        threads, processes, pid, first_port = cluster_env()
        self.threads = threads
        self.n_proc = processes
        self.pid = pid
        self.first_port = first_port
        self.n_workers = threads * processes
        self.autocommit_duration_ms = autocommit_duration_ms
        self.monitoring_level = monitoring_level
        self.connectors: list[Any] = []
        self.persistence: Any = None
        self.on_tick_done: list[Any] = []
        self._stop_requested = False
        self.streaming = False  # set after build (see engine.runtime.Runtime)
        self.current_time = 0
        # arrival-driven tick scheduling: the coordinator (pid 0) owns the
        # inter-tick sleep, so REST wakeups there drive the whole pod
        from pathway_tpu_torch.engine.runtime import TickWakeup

        self.wakeup = TickWakeup()
        # elasticity plane (PATHWAY_ELASTIC): set when the continuation
        # barrier broadcast carries a rescale decision — the pod quiesces to
        # one final committed epoch and exits with the rescale status
        self._rescale_decision: dict | None = None
        # shard-map plane (PATHWAY_SHARDMAP): the versioned ownership table
        # every placement decision consults; None keeps the derived modulo
        # rule. Set in run() after the elastic plane installs (the map's
        # version rides the membership version)
        self.shardmap = None
        # live tracing (observability): installed in run(), None when off
        self.tracer = None
        self._trace_active = False
        # request-scoped tracing: the plane while a request is in flight this
        # tick, else None (see engine.graph.Scheduler)
        self._rp = None
        self.local_workers: dict[int, _LocalWorker] = {}
        #: the cluster-wide "every source exhausted" verdict of the last
        #: sweep barrier (see :meth:`sources_finished`)
        self._sources_done = False
        # intra-process rows ride the local mesh; cross-process rows take the
        # TCP links (the ICI/DCN split — see parallel/device_plane.py)
        from pathway_tpu_torch.parallel.device_plane import make_cluster_device_plane

        self.device_plane = make_cluster_device_plane(self.n_workers, threads, pid)
        self.links = _PeerLinks(pid, processes, first_port, self._on_remote_block)
        # failure detection (resilience subsystem): a dedicated heartbeat link
        # per peer on port first_port + processes + 1; with the serving
        # fabric on, per-process fabric transports follow at
        # first_port + processes + 2 + pid — the cluster occupies
        # [first_port, first_port + 2*processes + 1]
        cfg = get_pathway_config()
        self.hb_monitor = None
        self.hb_client = None
        if processes > 1 and cfg.heartbeat_interval > 0:
            from pathway_tpu_torch.resilience.heartbeat import (
                HeartbeatClient,
                HeartbeatMonitor,
            )

            hb_port = first_port + processes + 1
            if pid == 0:
                self.hb_monitor = HeartbeatMonitor(
                    processes, hb_port, timeout=cfg.heartbeat_timeout
                )
            else:
                self.hb_client = HeartbeatClient(
                    pid, hb_port, cfg.heartbeat_interval
                )
        if pid == 0:
            self.coord = _Coordinator(processes, first_port, monitor=self.hb_monitor)
        else:
            self.coord = None
        self.client = None  # set in run()

    # ------------------------------------------------------------------ build
    def sources_finished(self) -> bool:
        """True once every process's sources are exhausted, as the last sweep
        barrier of this tick found. Cross-tick accumulators (the microbatch
        UDF buffers) drain on it: a process's own connectors cannot say, as
        non-partitioned sources live on process 0 only. The reference reads
        each process's own connectors, so a peer without any flushes at every
        frontier while process 0 holds its buffers to the drain tick, and an
        as-of-now query embedded on the peer can reach the index before the
        last docs do."""
        return self._sources_done

    def owner_of(self, worker: int) -> int:
        return worker // self.threads

    def register_connector(self, driver) -> None:
        self.connectors.append(driver)

    def request_stop(self) -> None:
        self._stop_requested = True

    def _build(self, outputs: list[LogicalNode]) -> None:
        my_workers = range(self.pid * self.threads, (self.pid + 1) * self.threads)
        # build in reverse so global worker 0 (on process 0) builds LAST — its
        # nodes must own any shared holders (connector subjects, rest servers)
        for w in sorted(my_workers, reverse=True):
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
            self._ctx_local = ctx  # any local context (non-0 processes have no
            # global worker 0; persistence reads only the graph shape from it)
            self.local_workers[w] = _LocalWorker(w, ctx.graph)

    # ---------------------------------------------------------------- routing
    def _on_remote_block(self, worker: int, node_index: int, port: int, batch: DeltaBatch) -> None:
        lw = self.local_workers[worker]
        with lw.lock:
            lw.graph.nodes[node_index].accept(port, batch)
            lw.mark_dirty_locked(node_index)

    def _deliver(self, worker: int, node_index: int, port: int, batch: DeltaBatch) -> None:
        owner = self.owner_of(worker)
        if owner == self.pid:
            lw = self.local_workers[worker]
            with lw.lock:
                lw.graph.nodes[node_index].accept(port, batch)
                lw.mark_dirty_locked(node_index)
        else:
            self.links.send_block(owner, worker, node_index, port, batch)

    def _accept_local(self, lw: _LocalWorker, ci: int, port: int, batch) -> None:
        """Same-worker accept from the worker's own thread (see
        parallel/sharded.py: a mid-sweep mark rides the active heap)."""
        lw.graph.nodes[ci].accept(port, batch)
        if lw.plan is None:
            return  # legacy mode: the full scan finds it
        h = lw.sweep_heap
        if h is not None:
            heapq.heappush(h, lw.plan.pos_of[ci])
        else:
            with lw.lock:
                lw.mark_dirty_locked(ci)

    def _route(self, lw: _LocalWorker, producer: Node, batches: list[DeltaBatch]) -> bool:
        routed = False
        consumers = lw.graph.edges.get(producer.node_index, [])
        for batch in batches:
            if batch is None or batch.is_empty:
                continue
            producer.stats_rows_out += len(batch)
            for ci, port in consumers:
                consumer = lw.graph.nodes[ci]
                key_fn = consumer.exchange_key(port)
                if key_fn is None:
                    self._accept_local(lw, ci, port, batch)
                elif key_fn == SOLO:
                    self._deliver(0, ci, port, batch)
                elif key_fn == BROADCAST:
                    for w_idx in range(self.n_workers):
                        self._deliver(w_idx, ci, port, batch)
                else:
                    route_keys = np.asarray(key_fn(batch), dtype=np.uint64)
                    if (
                        self.device_plane is not None
                        and self.device_plane.should_stage(batch)
                    ):
                        self.device_plane.stage(
                            ci, port, lw.index, route_keys, batch
                        )
                        routed = True
                        continue
                    shards = shard_of_keys(
                        route_keys, self.n_workers, shard_map=self.shardmap
                    )
                    for w_idx in np.unique(shards):
                        piece = batch.take(np.flatnonzero(shards == w_idx))
                        self._deliver(int(w_idx), ci, port, piece)
                routed = True
        return routed

    # ---------------------------------------------------------------- ticking
    def _sweep_worker_legacy(self, lw: _LocalWorker, time: int) -> bool:
        """The per-worker full-scan sweep (PATHWAY_FUSE=off)."""
        any_work = False
        trace = self._trace_active
        rp = self._rp
        aud = _audit.current()
        aud_note = aud is not None and aud.edge_sampled
        for node in lw.graph.nodes:
            with lw.lock:
                if not node.has_pending():
                    continue
                inputs = node.drain()
            rows_in = sum(len(b) for b in inputs if b is not None)
            node.stats_rows_in += rows_in
            if trace or rp is not None:
                from pathway_tpu_torch.observability import device as _dev_prof

                w0 = _time.time_ns()
                dev0 = _dev_prof.thread_device_wait_ns() if trace else 0
            out = run_annotated(node, node.process, inputs, time)
            if trace or rp is not None:
                w1 = _time.time_ns()
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
                        "pathway.worker": lw.index,
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
            self._route(lw, node, out)
            any_work = True
        return any_work

    def _sweep_worker(self, lw: _LocalWorker, time: int) -> bool:
        if lw.plan is None:
            return self._sweep_worker_legacy(lw, time)
        with lw.lock:
            if not lw.dirty:
                return False
            heap = sorted(lw.dirty)
            lw.dirty.clear()
        lw.sweep_heap = heap
        any_work = False
        trace = self._trace_active
        rp = self._rp
        aud = _audit.current()
        aud_note = aud is not None and aud.edge_sampled
        by_pos = lw.plan.by_pos
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
                    if self._run_chain(lw, chain, time, trace, aud if aud_note else None):
                        any_work = True
                    continue
                node = step.node
                with lw.lock:
                    if not node.has_pending():
                        continue
                    inputs = node.drain()
                rows_in = sum(len(b) for b in inputs if b is not None)
                node.stats_rows_in += rows_in
                if trace or rp is not None:
                    from pathway_tpu_torch.observability import device as _dev_prof

                    w0 = _time.time_ns()
                    dev0 = _dev_prof.thread_device_wait_ns() if trace else 0
                out = run_annotated(node, node.process, inputs, time)
                if trace or rp is not None:
                    w1 = _time.time_ns()
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
                            "pathway.worker": lw.index,
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
                self._route(lw, node, out)
                any_work = True
        finally:
            lw.sweep_heap = None
        return any_work

    def _run_chain(self, lw: _LocalWorker, chain, time: int, trace: bool, aud) -> bool:
        """One fused-chain step (see Scheduler._run_chain: per-chain span,
        device wait and traced-jit cold walls subtracted from host share)."""
        from pathway_tpu_torch.observability import device as _dev_prof

        rp = self._rp
        if trace or rp is not None:
            w0 = _time.time_ns()
            dev0 = _dev_prof.thread_device_wait_ns() if trace else 0
            cold0 = _dev_prof.thread_cold_s() if trace else 0.0
        t0 = _time.perf_counter_ns()
        tok = _phases.start()
        try:
            out, processed, rows_in, rows_out = chain.execute(time, lw.lock, aud)
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
            w1 = _time.time_ns()
            dev_ns = _dev_prof.thread_device_wait_ns() - dev0
            cold_ns = int((_dev_prof.thread_cold_s() - cold0) * 1e9)
            name = f"sweep/chain{{{chain.label}}}"
            attrs = {
                "pathway.operator.id": chain.operator_ids(),
                "pathway.worker": lw.index,
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
        self._route(lw, chain.tail, out)
        return True

    def _sweep_all_local(self, time: int) -> bool:
        workers = list(self.local_workers.values())
        if len(workers) == 1:
            did = False
            while self._sweep_worker(workers[0], time):
                did = True
            return did
        did_any = False
        while True:
            results = [False] * len(workers)
            # a worker's exception (terminate_on_error aborting a batch) is
            # re-raised here, as ShardedRuntime._parallel does: the reference
            # lets the thread die and its batch drop silently
            errors: list[BaseException | None] = [None] * len(workers)
            threads = []
            for i, lw in enumerate(workers):
                def target(i=i, lw=lw):
                    try:
                        results[i] = self._sweep_worker(lw, time)
                    except BaseException as e:  # noqa: BLE001 — transported to the caller
                        errors[i] = e

                t = threading.Thread(target=target)
                t.start()
                threads.append(t)
            for t in threads:
                t.join()
            for e in errors:
                if e is not None:
                    raise e
            if not any(results):
                return did_any
            did_any = True

    def _barrier(self, report: Any, decide) -> Any:
        _faults.before_barrier(self.pid, self.current_time)
        phase = report[0] if isinstance(report, tuple) and report else "barrier"
        # request-trace piggyback: peers ship their stage-event outbox on
        # barrier reports; the coordinator merges them and broadcasts the
        # live-request table with the decision — one request's flight path
        # stitches across processes with zero extra sockets or rounds. Both
        # directions are pay-as-you-go: an empty outbox ships nothing, and
        # the broadcast rides only while requests are live (one trailing
        # empty broadcast clears peers), so a cluster job with no traffic
        # adds no barrier payload at all
        rp = _requests.current()
        if rp is not None:
            outbox = rp.wire_out()
            if outbox is not None:
                report = ("__rt__", report, outbox)
            if self.pid == 0 and decide is not None:
                inner_decide = decide

                def decide(reports, _inner=inner_decide, _rp=rp):
                    # unwrap is per-report and tag-based: wrapped and bare
                    # reports mix freely (peers wrap only when shipping)
                    base = []
                    for r in reports:
                        if (
                            isinstance(r, tuple)
                            and len(r) == 3
                            and r[0] == "__rt__"
                        ):
                            _rp.wire_merge(r[2])
                            base.append(r[1])
                        else:
                            base.append(r)
                    d = _inner(base)
                    if isinstance(d, dict):
                        bc = _rp.wire_broadcast()
                        if bc is not None:
                            d = dict(d)
                            d["__rt_bc__"] = bc
                    return d

        if not self._trace_active:
            if self.pid == 0:
                decision = self.coord.barrier(report, decide)
            else:
                decision = self.client.barrier(report)
        else:
            # sampled tick: record the barrier round as a child span — wait
            # time at barriers IS the cluster's skew/critical-path signal
            # (SnailTrail)
            w0 = _time.time_ns()
            if self.pid == 0:
                decision = self.coord.barrier(report, decide)
            else:
                decision = self.client.barrier(report)
            self.tracer.span(
                f"cluster/barrier/{phase}",
                w0,
                _time.time_ns(),
                {"pathway.process_id": self.pid, "pathway.tick": self.current_time},
            )
        if rp is not None and self.pid != 0 and isinstance(decision, dict):
            rp.wire_apply(decision.get("__rt_bc__"))
        return decision

    def _round_until_quiescent(self, time: int, phase: str) -> None:
        """Sweep-report rounds until globally quiescent (no work anywhere and
        all in-flight messages delivered)."""
        while True:
            self.links.check_error()
            did = self._sweep_all_local(time)
            if self.device_plane is not None and self.device_plane.flush(
                self._deliver, time
            ):
                did = True
            sent, received = self.links.counters()
            # pending is read AFTER the counters: a block that lands between
            # sweep and here is visible either as sent>recv or as pending.
            # Pending nodes are re-marked dirty (idempotent) so the plan
            # sweep can never strand a buffered block.
            pending = False
            for lw in self.local_workers.values():
                for node in lw.graph.nodes:
                    if node.has_pending():
                        pending = True
                        with lw.lock:
                            lw.mark_dirty_locked(node.node_index)
            # every process's sources, read at each round: the last round's
            # verdict is what the frontier phase after it sees
            local_done = all(d.is_finished() for d in self.connectors)
            report = (phase, did or pending, sent, received, local_done)

            def decide(reports):
                any_work = any(r[1] for r in reports)
                total_sent = sum(r[2] for r in reports)
                total_recv = sum(r[3] for r in reports)
                return {
                    "again": any_work or total_sent != total_recv,
                    "sources_done": all(r[4] for r in reports),
                }

            decision = self._barrier(report, decide)
            self._sources_done = decision["sources_done"]
            if not decision["again"]:
                return

    def _sync_watermarks(self) -> None:
        """Cross-process watermark gossip (the reference's frontier broadcast
        over timely's progress channels): merge every global-watermark node's
        per-process tick maximum so sharded buffer/forget/freeze shards all
        see the GLOBAL clock before releasing/dropping rows. Runs before each
        frontier round — frontier-phase emissions can advance the clock
        mid-tick, and the serial engine would observe those too."""
        local: dict[int, Any] = {}
        wm_nodes = []
        for lw in self.local_workers.values():
            for node in lw.graph.nodes:
                if getattr(node, "global_watermark", False):
                    wm_nodes.append(node)
                    tm = node._shared.tick_max
                    if tm is not None:
                        prev = local.get(node.node_index)
                        if prev is None or tm > prev:
                            local[node.node_index] = tm
        # graphs are aligned across processes, so this skip is symmetric —
        # every process sees the same wm_nodes emptiness and barrier count
        if not wm_nodes:
            return

        def decide(reports):
            merged: dict[int, Any] = {}
            for _tag, wm in reports:
                for idx, tm in wm.items():
                    if idx not in merged or tm > merged[idx]:
                        merged[idx] = tm
            return {"wm": merged}

        decision = self._barrier(("wmsync", local), decide)
        merged = decision["wm"]
        for node in wm_nodes:
            tm = merged.get(node.node_index)
            if tm is not None:
                with node._shared.lock:
                    if node._shared.tick_max is None or tm > node._shared.tick_max:
                        node._shared.tick_max = tm

    def run_tick(self, time: int, skip_poll: bool = False) -> None:
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
        if self.hb_client is not None:
            self.hb_client.tick = time
        # non-partitioned sources poll on global worker 0 only; partitioned
        # sources (local_source) poll on every owning worker — including
        # workers hosted by peer processes. ``skip_poll`` is the drop_poll
        # fault-injection point: buffered events stay upstream for this tick.
        aud = _audit.current()
        if aud is not None:
            aud.begin_tick(time)

        def _polled(node):
            polled = run_annotated(node, node.poll, time)
            if polled:
                # corruption faults (flip_diff/drop_retract) apply before the
                # audit monitors observe, keyed by THIS process id
                polled = _faults.corrupt_polled(self.pid, time, polled)
                if aud is not None:
                    aud.observe_input(node, polled, time)
            return polled

        def _nodes(lw, kind):
            if lw.plan is None:
                return lw.graph.nodes
            return getattr(lw.plan, kind)

        if not skip_poll and 0 in self.local_workers:
            lw0 = self.local_workers[0]
            for node in _nodes(lw0, "pollers"):
                self._route(lw0, node, _polled(node))
        if not skip_poll:
            for gi, lw in self.local_workers.items():
                if gi == 0:
                    continue
                for node in _nodes(lw, "pollers"):
                    if getattr(node, "local_source", False) or getattr(
                        node, "fabric_ingest", False
                    ):
                        # fabric_ingest: zero-hop doors push REST rows into
                        # THIS process's copy of the route input node, so
                        # peers must poll it like a partitioned source
                        self._route(lw, node, _polled(node))
        self._round_until_quiescent(time, "sweep")
        while True:
            self._sync_watermarks()
            progressed = False
            for lw in self.local_workers.values():
                for node in _nodes(lw, "frontier_nodes"):
                    if self._route(lw, node, run_annotated(node, node.on_frontier, time)):
                        progressed = True

            def decide(reports):
                return {"again": any(r[1] for r in reports)}

            decision = self._barrier(("frontier", progressed, 0, 0), decide)
            if not decision["again"]:
                break
            self._round_until_quiescent(time, "sweep")
        for lw in self.local_workers.values():
            for node in _nodes(lw, "tick_complete_nodes"):
                run_annotated(node, node.on_tick_complete, time)
        for cb in self.on_tick_done:
            cb(time)
        if tick_token is not None:
            self._trace_active = False
            tracer.end_tick(time, tick_token)

    def _peer_flows(self) -> dict[int, dict]:
        """pid → flow-plane gate summary from each peer's heartbeats (empty
        when failure detection is off — single-host pressure still applies)."""
        if self.hb_monitor is None:
            return {}
        return self.hb_monitor.peer_flow()

    # ---------------------------------------------------------------- run loop
    def run(self, outputs: list[LogicalNode]):
        from pathway_tpu_torch import elastic as _elastic
        from pathway_tpu_torch import flow as _flow
        from pathway_tpu_torch import observability as _obs

        _faults.install_from_env()
        _obs.install_from_env(self)
        _flow.install_from_env(self)  # before build: gates attach to inputs
        # after persistence attach (pw.run order), so the plane finds the
        # backend the membership table lives in
        _elastic.install_from_env(self)
        eplane = _elastic.current()
        if get_pathway_config().shardmap == "on":
            # shard-map plane: derive (and, coordinator, commit) the versioned
            # ownership table BEFORE build/persistence — restores and door
            # routing both consult it. Derivation is deterministic from the
            # stored map + pod shape, so every process agrees without a
            # barrier; without a backend the equal initial split is used.
            from pathway_tpu_torch.internals import shardmap as _shardmap

            backend = getattr(self.persistence, "backend", None)
            version = (
                eplane.membership.version
                if eplane is not None and eplane.membership is not None
                else 0
            )
            self.shardmap, _prev = _shardmap.ensure_shardmap(
                backend, self.n_workers, version, commit=(self.pid == 0)
            )
            if self.device_plane is not None:
                self.device_plane.shard_map = self.shardmap
        if eplane is not None and eplane.membership is not None and self.hb_monitor is not None:
            # stale-membership guard: heartbeat summaries stamped with an
            # older membership version (a retired process's last gasp) are
            # rejected instead of polluting the coordinator's merged state
            self.hb_monitor.set_membership_version(eplane.membership.version)
        self.tracer = _obs.current()
        if self.hb_client is not None:
            # telemetry summaries ride the existing heartbeat messages, so the
            # coordinator's /status can show this peer's tick/watermark/backlog
            # (and, flow plane on, its gate occupancy for the credit merge)
            self.hb_client.summary_fn = lambda: _obs.aggregate.local_summary(self)
        try:
            return self._run_inner(outputs)
        except BaseException as e:
            # flight-recorder post-mortem: on an OtherWorkerError the dump
            # names the dead peer and its last known tick (the survivors are
            # where the post-mortem evidence lives — the dead process wrote
            # nothing). A ClusterRescale is a coordinated exit, not a
            # failure: no post-mortem
            if not isinstance(e, _elastic.ClusterRescale):
                _obs.device.on_run_error(e, self)
            raise
        finally:
            self.tracer = None
            from pathway_tpu_torch import fabric as _fabric

            _fabric.shutdown()
            _obs.shutdown()
            _flow.shutdown()
            _elastic.shutdown()

    def _run_inner(self, outputs: list[LogicalNode]):
        from pathway_tpu_torch import elastic as _elastic
        from pathway_tpu_torch import flow as _flow
        from pathway_tpu_torch.engine.runtime import check_connector_failures, refuse_unpersisted_delivery
        from pathway_tpu_torch.observability import health as _health

        self._build(outputs)
        self.streaming = bool(self.connectors)
        refuse_unpersisted_delivery(
            self.persistence, [n for lw in self.local_workers.values() for n in lw.graph.nodes]
        )
        plane = _flow.current()
        eplane = _elastic.current()
        if plane is not None:
            self.on_tick_done.append(lambda t: plane.on_tick_complete(self, t))
        if self.pid == 0:
            self.coord.wait_connections()
        else:
            self.client = _CoordinatorClient(
                self.pid, self.first_port, hb_client=self.hb_client
            )
        # the run streams when any process has a live connector (the
        # reference reads this process's own: a peer without connectors
        # would treat a streaming run as one static tick)
        decision = self._barrier(
            ("streaming", self.streaming),
            lambda reports: {"streaming": any(r[1] for r in reports)},
        )
        self.streaming = bool(decision["streaming"])
        if self.persistence is not None:
            # every process participates: input snapshots live with the
            # sources on process 0, peers persist their own partitioned source
            # slices, operator mode additionally snapshots/restores every
            # process's worker shards, and the per-tick epoch barrier commits
            # a global manifest (barrier-coordinated, see snapshots.py) — so
            # the hooks must run in lockstep on ALL processes
            self.persistence.on_graph_built(getattr(self, "_ctx0", self._ctx_local))
            self.on_tick_done.append(self.persistence.on_tick_done)
        # every process starts ITS OWN connectors: process 0 owns the
        # non-partitioned sources, peers own their workers' partition slices
        for driver in self.connectors:
            driver.start()
        # serving fabric (PATHWAY_FABRIC=on): AFTER connectors — the owner's
        # webserver and route states are live — and BEFORE the first tick, so
        # every peer's transport is accepting before the owner's first
        # replica cast (the startup barrier orders the two)
        from pathway_tpu_torch import fabric as _fabric

        fplane = _fabric.install_from_env(self)
        if fplane is not None:
            self.on_tick_done.append(fplane.on_tick_done)
        # connectors live + fabric doors accepting: this door is ready
        # (health plane: starting → ready; a replica resync will demote it
        # to syncing until the gap closes)
        _health.mark_ready()

        period = (self.autocommit_duration_ms or 20) / 1000.0
        tick = 0
        try:
            while True:
                t0 = _time.perf_counter()
                drop_poll = _faults.on_tick_start(self.pid, tick)
                self.run_tick(tick, skip_poll=drop_poll)
                tick += 1
                check_connector_failures(self.connectors)
                # continuation: done when EVERY process's sources are
                # exhausted (partitioned ingest spreads sources across
                # processes) — or when ANY process requested a stop (streaming
                # subjects never self-finish, so the stop flag must propagate
                # to peers through the barrier, not wait on their is_finished)
                local_done = all(d.is_finished() for d in self.connectors)
                report = ("cont", local_done, self._stop_requested, 0)
                if self.pid == 0:
                    all_virtual = not self.connectors or all(
                        getattr(d, "virtual", False) for d in self.connectors
                    )

                    def decide(reports, _tick=tick):
                        d = {
                            "done": any(r[2] for r in reports)
                            or all(r[1] for r in reports)
                        }
                        if plane is not None:
                            # cluster credit propagation: merge every peer's
                            # heartbeat-piggybacked gate occupancy into one
                            # pod-wide pressure and broadcast it with the
                            # continue decision — a slow peer throttles every
                            # producer instead of OOMing one host
                            d["flow"] = plane.cluster_signal(self._peer_flows())
                        if eplane is not None and not d["done"]:
                            # elasticity: manual scale requests + the
                            # autoscaler consult here, fed the SAME merged
                            # pod pressure the flow broadcast carries; a
                            # decision rides the continue verdict so every
                            # process quiesces at the same tick boundary
                            resc = eplane.maybe_decide(
                                self, _tick, (d.get("flow") or {}).get("pressure")
                            )
                            if resc is not None:
                                d["rescale"] = resc
                        return d

                    decision = self.coord.barrier(report, decide)
                else:
                    decision = self.client.barrier(report)
                    all_virtual = True
                if plane is not None:
                    plane.apply_cluster_signal(decision.get("flow"))
                resc = decision.get("rescale")
                if resc is not None:
                    # readiness before the pause: every door flips to
                    # draining (503 + Retry-After on /readyz) BEFORE the
                    # quiesce drain tick, so a load balancer stops sending
                    # traffic into the rescale window
                    self._rescale_decision = resc
                    _health.mark_draining("rescale")
                if decision["done"] or resc is not None:
                    if decision["done"]:
                        _health.mark_draining("shutdown")
                    self.run_tick(tick)  # drain final events
                    break
                if self.pid == 0 and self.connectors and not all_virtual:
                    elapsed = _time.perf_counter() - t0
                    if elapsed < period:
                        self.wakeup.wait(period - elapsed)
        finally:
            for driver in self.connectors:
                driver.stop()
        # re-check: a subject may error between the in-loop check and the
        # is_finished break (see engine.runtime.Runtime.run)
        check_connector_failures(self.connectors)
        self.close()
        if self._rescale_decision is not None:
            # the pod is quiesced and its final epoch is committed (close()
            # ran the coordinated at-close snapshot): publish the new
            # membership version and leave with the rescale status so a
            # Supervisor relaunches the cluster at the new shape
            if eplane is not None:
                eplane.finalize_rescale(self, self._rescale_decision)
            raise _elastic.ClusterRescale(  # peers without a plane still exit 75
                int(self._rescale_decision["target"]),
                int(self._rescale_decision["version"]),
                str(self._rescale_decision["reason"]),
            )
        return self

    def close(self) -> None:
        self.run_tick(END_OF_STREAM)
        for lw in self.local_workers.values():
            for node in lw.graph.nodes:
                node.on_end()
        if self.persistence is not None:
            self.persistence.on_close()
        # heartbeats outlive the last persistence barrier (a peer dying inside
        # on_close must still be detected); the goodbye marks this exit clean
        if self.hb_client is not None:
            self.hb_client.goodbye()
        if self.hb_monitor is not None:
            self.hb_monitor.close()
        if self.client is not None:
            self.client.close()
        if self.coord is not None:
            self.coord.close()
        self.links.close()

    @property
    def scheduler(self):
        return self
