"""Cluster failure detection: heartbeats on the control plane.

The cluster's barrier protocol (``parallel/cluster.py``) only learns about a
dead peer when a barrier read times out after the full ``barrier_timeout`` —
and then it can't say WHICH peer died. This module adds the reference's
worker-liveness signal (SURVEY §5.3: a dead worker surfaces as
``OtherWorkerError`` naming the failure) as a dedicated heartbeat link per
peer:

- every non-coordinator process runs a :class:`HeartbeatClient` — a daemon
  thread holding one TCP connection to process 0 and sending
  ``("hb", pid, tick)`` every ``heartbeat_interval`` seconds;
- process 0 runs the :class:`HeartbeatMonitor` — it tracks per-peer last-seen
  times and last-known ticks, and answers :meth:`HeartbeatMonitor.dead_peer`
  for the barrier loops.

Detection is two-tier: a peer whose PROCESS dies (SIGKILL, OOM, crash) closes
its socket, so the monitor sees EOF within milliseconds; a peer that is alive
but wedged trips the ``heartbeat_timeout`` miss threshold. Either way the
barrier raises a structured ``OtherWorkerError(process_id=…, tick=…)`` instead
of a bare timeout. Clean shutdown sends ``("bye", pid)`` first so normal exits
never read as failures.

Carried from ``pathway_tpu/resilience/heartbeat.py`` unchanged.
"""

from __future__ import annotations

import pickle
import socket
import struct
import threading
import time as _time

from pathway_tpu_torch.internals.telemetry import record_event


# same length-prefixed-pickle framing as the cluster plane (cluster.py), kept
# local so the detector has no import-order coupling with the runtime it guards
def _send(sock: socket.socket, obj) -> None:
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(struct.pack("<Q", len(payload)) + payload)


def _recv(sock: socket.socket):
    buf = b""
    while len(buf) < 8:
        chunk = sock.recv(8 - len(buf))
        if not chunk:
            return None
        buf += chunk
    (n,) = struct.unpack("<Q", buf)
    payload = b""
    while len(payload) < n:
        chunk = sock.recv(n - len(payload))
        if not chunk:
            return None
        payload += chunk
    return pickle.loads(payload)


class _PeerState:
    __slots__ = ("last_seen", "tick", "eof", "clean", "summary")

    def __init__(self) -> None:
        self.last_seen = _time.monotonic()
        self.tick: int | None = None
        self.eof = False
        self.clean = False
        # latest telemetry summary shipped on the heartbeat (observability
        # plane: tick/watermark/backlog/sink-latency) — None until one arrives
        self.summary: dict | None = None


class HeartbeatMonitor:
    """Process 0's failure detector: accepts one heartbeat connection per peer."""

    def __init__(
        self,
        n_proc: int,
        port: int,
        host: str = "127.0.0.1",
        timeout: float = 10.0,
    ):
        self.n_proc = n_proc
        self.timeout = timeout
        self._lock = threading.Lock()
        self._peers: dict[int, _PeerState] = {}
        self._reported: set[int] = set()
        # elasticity hardening: peers retired by a drain decision — late
        # messages from them are dropped (warned once), never treated as
        # state or death
        self._retired: set[int] = set()
        self._stale_warned: set[int] = set()
        #: current membership version (elastic plane); summaries stamped with
        #: an older version are rejected as coming from before the reshard
        self.membership_version: int | None = None
        self._conns: list[socket.socket] = []
        self._closed = False
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(n_proc)
        self.port = self._listener.getsockname()[1]
        threading.Thread(target=self._accept_loop, daemon=True).start()

    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            self._conns.append(conn)
            threading.Thread(target=self._recv_loop, args=(conn,), daemon=True).start()

    def _recv_loop(self, conn: socket.socket) -> None:
        pid: int | None = None
        try:
            while True:
                msg = _recv(conn)
                if msg is None:
                    break  # EOF
                # 3-tuple = bare heartbeat; 4-tuple appends the telemetry
                # summary (observability plane) — both generations accepted
                kind, peer, tick = msg[0], msg[1], msg[2]
                summary = msg[3] if len(msg) > 3 else None
                if pid is None:
                    pid = int(peer)
                with self._lock:
                    if pid in self._retired:
                        # a just-retired peer's in-flight message: drop it
                        # with one structured warning — it must neither
                        # resurrect the peer state nor read as a death
                        if pid not in self._stale_warned:
                            self._stale_warned.add(pid)
                            record_event(
                                "elastic.stale_peer_message",
                                process_id=pid,
                                message_kind=str(kind),
                            )
                        return
                    st = self._peers.setdefault(pid, _PeerState())
                    st.last_seen = _time.monotonic()
                    if tick is not None:
                        st.tick = int(tick)
                    if summary is not None and self._summary_current(pid, summary):
                        st.summary = summary
                    if kind == "bye":
                        st.clean = True
                if kind == "bye":
                    break
        except Exception:
            pass  # a torn message counts as EOF below
        finally:
            if pid is not None:
                with self._lock:
                    st = self._peers.get(pid)
                    if st is not None and not st.clean:
                        st.eof = True
            try:
                conn.close()
            except OSError:
                pass

    def _summary_current(self, pid: int, summary: dict) -> bool:
        """Reject summaries stamped with a membership version older than the
        coordinator's (the sender predates the last reshard). Structured
        warning once per (peer, version); liveness is unaffected — only the
        telemetry payload is dropped. Caller holds ``self._lock``."""
        if self.membership_version is None or not isinstance(summary, dict):
            return True
        from pathway_tpu_torch.elastic.membership import check_version

        return check_version(
            self.membership_version,
            summary.get("membership_version"),
            f"heartbeat:p{pid}",
        )

    def set_membership_version(self, version: int) -> None:
        with self._lock:
            self.membership_version = version

    def retire_peer(self, pid: int) -> None:
        """Elasticity drain: remove a peer from the failure detector and the
        flow merge — its clean (or abrupt) departure is expected, and its
        queue occupancy must stop scaling the pod's credit."""
        with self._lock:
            self._retired.add(pid)
            existed = self._peers.pop(pid, None) is not None
            self._reported.discard(pid)
        if existed:
            record_event("elastic.peer_retired", process_id=pid)

    def seen_peers(self) -> dict[int, int | None]:
        """pid → last-known tick, for every peer that ever connected."""
        with self._lock:
            return {pid: st.tick for pid, st in self._peers.items()}

    def peer_summaries(self) -> dict[int, dict | None]:
        """pid → latest telemetry summary shipped on that peer's heartbeats
        (None for peers that never sent one) — the coordinator's /status
        cluster section reads this."""
        with self._lock:
            return {pid: st.summary for pid, st in self._peers.items()}

    def peer_serving(self) -> dict[int, dict]:
        """pid → the per-route serving-counter block piggybacked on that
        peer's heartbeats (fabric front doors count their own ingress
        traffic). Empty entries are dropped; the serving /status rollup and
        the pod-wide shed/auth-failure totals read this."""
        with self._lock:
            out = {}
            for pid, st in self._peers.items():
                serving = (st.summary or {}).get("serving")
                if serving:
                    out[pid] = serving
            return out

    def peer_replica_index(self) -> dict[int, dict]:
        """pid → the replica-index health block (route → rows/lag/local/
        fallbacks/gaps/resyncs) piggybacked on that peer's heartbeats.
        Retired peers are gone from ``_peers``, so a drained door's stale
        lag never alarms the coordinator's rollup."""
        with self._lock:
            out = {}
            for pid, st in self._peers.items():
                ri = (st.summary or {}).get("replica_index")
                if ri:
                    out[pid] = ri
            return out

    def peer_flow(self) -> dict[int, dict]:
        """pid → the flow-plane credit/occupancy block piggybacked on that
        peer's heartbeats ({} until one arrives). The coordinator merges these
        into the pod-wide pressure it broadcasts on the tick barrier, which is
        what makes backpressure CLUSTER-wide: a peer whose ingest queues fill
        shrinks every process's effective credit. Drained peers (clean
        goodbye or retired by an elastic drain) drop out: a gone process's
        stale occupancy must not keep throttling the survivors."""
        with self._lock:
            return {
                pid: (st.summary or {}).get("flow") or {}
                for pid, st in self._peers.items()
                if not st.clean and not st.eof
            }

    def dead_peer(self) -> tuple[int, int | None, str] | None:
        """(pid, last_tick, reason) of a failed peer, else None. EOF beats a
        heartbeat miss (it is definitive); each miss is recorded once."""
        if self._closed:
            return None
        now = _time.monotonic()
        with self._lock:
            for pid, st in self._peers.items():
                if st.clean:
                    continue
                if st.eof:
                    return pid, st.tick, "disconnected"
            for pid, st in self._peers.items():
                if st.clean or st.eof:
                    continue
                if now - st.last_seen > self.timeout:
                    if pid not in self._reported:
                        self._reported.add(pid)
                        record_event(
                            "resilience.heartbeat_miss",
                            process_id=pid,
                            tick=st.tick if st.tick is not None else -1,
                            silent_s=round(now - st.last_seen, 3),
                        )
                    return pid, st.tick, "heartbeat-timeout"
        return None

    def close(self) -> None:
        self._closed = True
        try:
            self._listener.close()
        except OSError:
            pass
        for conn in self._conns:
            try:
                conn.close()
            except OSError:
                pass


class HeartbeatClient:
    """A peer's side: one connection + a daemon sender thread. The runtime
    bumps ``self.tick`` each tick; ``coordinator_lost`` flips when sends start
    failing after a successful connect (process 0 is gone)."""

    def __init__(
        self,
        pid: int,
        port: int,
        interval: float,
        host: str = "127.0.0.1",
        connect_timeout: float = 30.0,
    ):
        self.pid = pid
        self.interval = interval
        self.tick = 0
        self.coordinator_lost = False
        # optional telemetry provider (observability plane): when set, each
        # heartbeat carries its summary so process 0 aggregates the cluster
        self.summary_fn = None
        self._closed = False
        self._sock: socket.socket | None = None
        self._host = host
        self._port = port
        self._connect_timeout = connect_timeout
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        deadline = _time.monotonic() + self._connect_timeout
        while not self._closed:
            try:
                self._sock = socket.create_connection(
                    (self._host, self._port), timeout=5
                )
                break
            except OSError:
                if _time.monotonic() > deadline:
                    return  # no monitor (e.g. heartbeats disabled on pid 0)
                _time.sleep(0.05)
        while not self._closed:
            summary = None
            fn = self.summary_fn
            if fn is not None:
                try:
                    summary = fn()
                except Exception:
                    summary = None  # telemetry must never kill the heartbeat
            try:
                _send(self._sock, ("hb", self.pid, self.tick, summary))
            except OSError:
                if not self._closed:
                    self.coordinator_lost = True
                    record_event(
                        "resilience.heartbeat_miss",
                        process_id=0,
                        tick=self.tick,
                        silent_s=0.0,
                    )
                return
            _time.sleep(self.interval)

    def goodbye(self) -> None:
        """Clean shutdown: tell the monitor this exit is intentional."""
        self._closed = True
        sock = self._sock
        if sock is not None:
            try:
                _send(sock, ("bye", self.pid, self.tick))
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass
