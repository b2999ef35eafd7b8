"""The fabric plane: every cluster process becomes a front door.

Without the fabric, a REST route lives on the coordinator alone — the
process hosting global worker 0 starts the webserver, and every client
funnels through one event loop that is also running the engine. The fabric turns the route
table (populated identically on every process at graph-definition time —
every process executes the same program) into a pod-wide serving surface:

- **Peer front doors.** Each non-owner process starts a mirror webserver per
  registered ``PathwayWebserver`` (port offset by
  ``PATHWAY_FABRIC_PORT_STRIDE × pid``; stride 0 on multi-host pods where
  every host binds the same port). Engine-backed routes get a *forwarding*
  handler; ``serve_table`` routes get a *replica* handler; ``/_schema`` and
  404 semantics come from the same ``PathwayWebserver`` machinery, so every
  door presents the same API surface.
- **Forwarding.** An ingress door runs the full front-door gauntlet locally
  — auth, token bucket, in-flight budget, payload parse, request_validator —
  then mints the request key (pid-salted, so the request id and its derived
  trace id are pod-unique), registers the flight with the request-trace
  plane, and calls the owning process over the fabric transport. The owner
  injects the parsed row into the route's serving state through the SAME
  admission/coalesce/response machinery the coordinator's own door uses, so
  the answer is byte-identical to hitting the coordinator; the ingress door
  relays status, body and ``Retry-After`` verbatim and stamps
  ``X-Pathway-Fabric: forwarded:p<owner>``. The engine's own key-range
  exchange does the scatter/gather across worker shards once the row is in.
- **Tracing.** Ingress and owner both register the SAME request id, so both
  sides' kept traces materialize under one derived trace id: the ingress
  contributes ``serve/admission`` + ``fabric/forward`` spans, the owner the
  engine decomposition — one flight, stitched across processes.
- **Ownership.** Route inputs are SOLO sources on global worker 0, so the
  owning process is the one hosting worker 0 (pid 0 — confirmed against the
  membership table when the elastic plane is live; replica casts carry
  the membership version and stale-generation payloads are dropped).
- **Zero-hop mode (``PATHWAY_SHARDMAP=on``).** With the shard map
  live, ownership is per KEY RANGE, not per process, and the forward hop
  disappears from the serving hot path entirely: every door mints request
  keys it owns (``mint_local_key``), pushes them into its OWN copy of the
  route input (keyed exchange keeps the row local), and the response
  subscribe — also routed by key — resolves the future on the same process.
  Doors stamp ``X-Pathway-Fabric: owner:p<pid>`` because each one IS the
  owner of every request it admits; the only cross-process traffic left is
  the rate-limited tick nudge to the coordinator (pid 0 owns the inter-tick
  sleep) and the replica feed, which becomes all-to-all: each process casts
  the changelog slice it owns, replicas track freshness per source, and a
  stale lookup forwards to the *key's* owner — never a fixed pid 0.

Carried from ``pathway_tpu/fabric/routing.py``. Doors serve on the port's own
HTTP/1.1 layer (``io/http/_wire.py``), where the reference uses aiohttp; the
bytes a door answers are the same.
"""

from __future__ import annotations

import asyncio
import sys
import threading
import time as _time
from typing import Any

import numpy as np

from pathway_tpu_torch.fabric import index_replica as _ireplica
from pathway_tpu_torch.fabric import replica as _replica
from pathway_tpu_torch.fabric.transport import FabricNode, FabricUnavailable
from pathway_tpu_torch.internals.telemetry import record_event

#: minimum seconds between owner frontier casts while tables are idle — the
#: replica staleness clock must keep advancing without data
_FRONTIER_INTERVAL_S = 0.25


def _dumps(obj: Any) -> str:
    import json

    return json.dumps(obj)


class FabricPlane:
    """Per-run fabric state on one process (installed by the cluster runtime
    after connectors start, torn down with the run)."""

    def __init__(self, runtime: Any, cfg: Any):
        self.runtime = runtime
        self.pid = cfg.process_id
        self.n_proc = cfg.processes
        self.stride = cfg.fabric_port_stride
        self.timeout = cfg.fabric_timeout
        self.max_staleness_s = cfg.fabric_max_staleness_ms / 1000.0
        self.owner_pid = 0  # the process hosting global worker 0
        #: shard-map mode: the runtime's versioned ownership table, or None —
        #: None keeps the single-owner behaviour bit-for-bit
        self.shardmap = getattr(runtime, "shardmap", None)
        self.threads = max(1, int(getattr(runtime, "threads", 1)))
        self.node = FabricNode(self.pid, self.n_proc, cfg.first_port)
        self.doors: list[Any] = []
        self._route_states: dict[str, Any] = {}
        self._table_routes: dict[str, _replica.TableRoute] = {}
        #: replica-served retrieval: per-route changelog-fed index
        #: replicas; every door answers KNN locally within the staleness bound
        self._index_routes: dict[str, Any] = {}
        self.replica_max_staleness_s = cfg.replica_max_staleness_ms / 1000.0
        self._memo_share = cfg.replica_memo_share == "on"
        self.memo_casts_total = 0
        self.memo_entries_out = 0
        self.memo_entries_in = 0
        self._loop: asyncio.AbstractEventLoop | None = None
        self._outbox: dict[str, list] = {}
        self._outbox_lock = threading.Lock()
        self._last_cast = 0.0
        self._last_nudge = 0.0
        self._resyncing: set = set()  # route (single owner) or (route, src) (shard map)
        self.forward_errors_total = 0
        self.casts_total = 0
        self.nudges_total = 0

    # ------------------------------------------------------------------ install
    def install(self) -> None:
        from pathway_tpu_torch.internals.parse_graph import G
        from pathway_tpu_torch.io.http import _server as S

        gen = G.generation
        for rs in list(S._ROUTES):
            if rs.graph_gen == gen:
                self._route_states[rs.route] = rs
        for tr in _replica.live_table_routes():
            self._table_routes[tr.route] = tr
        for ir in _ireplica.live_index_routes():
            self._index_routes[ir.route] = ir
            if ir.replica is not None:
                # every process authors the changelog slice for the doc keys
                # the engine's keyed exchange placed on it
                ir.replica.self_src = self.pid
        self.node.req_handlers["serve"] = self._handle_serve
        self.node.req_handlers["canary"] = self._handle_canary
        self.node.req_handlers["table_lookup"] = self._handle_table_lookup
        self.node.req_handlers["replica_snapshot"] = self._handle_replica_snapshot
        self.node.req_handlers["index_snapshot"] = self._handle_index_snapshot
        self.node.cast_handlers["replica"] = self._handle_replica_cast
        self.node.cast_handlers["wakeup"] = self._handle_wakeup
        if self.shardmap is not None:
            # zero-hop mode: every process is an authoritative changelog
            # source for its key ranges, and peer doors must be able to wake
            # the coordinator's tick loop when they admit a request
            for tr in self._table_routes.values():
                tr.store.self_src = self.pid
            if self.pid != 0:
                self.runtime.coord_nudge = self._nudge_coordinator
        if self.pid == self.owner_pid:
            loop = asyncio.new_event_loop()
            self._loop = loop
            threading.Thread(
                target=loop.run_forever, name="fabric-serve", daemon=True
            ).start()
        else:
            # bind this process's door states to the run so /status, limits
            # and the heartbeat rollup see them (the driver hook only fires
            # on the owner)
            for rs in self._route_states.values():
                rs.runtime = self.runtime
                rs.configure()
            for tr in self._table_routes.values():
                if tr.state.route not in self._route_states:
                    tr.state.runtime = self.runtime
                    tr.state.configure()
            self._build_doors()
            for tr in self._table_routes.values():
                if self.shardmap is not None:
                    # per-source slices: pull each peer's authoritative ranges
                    for peer in range(self.n_proc):
                        if peer != self.pid:
                            self._resync(tr, wait=False, src=peer)
                else:
                    self._resync(tr, wait=False)
        # index replicas are all-to-all regardless of ownership mode (every
        # process authors its doc shard's slice): pull each peer's slice now
        # to catch up after a restart; a fresh pod converges via first casts
        # (every slice starts at seq 0, so there is no gap to detect)
        for ir in self._index_routes.values():
            if ir.replica is None:
                continue
            for peer in range(self.n_proc):
                if peer != self.pid:
                    self._resync_index(ir, peer, wait=False)
        record_event(
            "fabric.installed",
            process_id=self.pid,
            routes=len(self._route_states),
            tables=len(self._table_routes),
            index_routes=len(self._index_routes),
            doors=len(self.doors),
        )

    def _build_doors(self) -> None:
        from pathway_tpu_torch.io.http import _server as S

        live = {id(rs) for rs in self._route_states.values()}
        live |= {id(tr.state) for tr in self._table_routes.values()}
        live_servers = []
        for ws in list(S._WEBSERVERS):
            if getattr(ws, "_fabric_door", False):
                continue
            metas = [m for _r, _m, _h, m in ws._routes if m is not None]
            if any(id(m.get("serving")) in live for m in metas):
                live_servers.append(ws)
        # a webserver's door band is [port, port + (n_proc-1)*stride]: two
        # servers on nearby ports would silently assign the same door port to
        # different servers — fail with the fix instead of a bind crash
        if self.stride > 0 and len(live_servers) > 1:
            span = (self.n_proc - 1) * self.stride
            ports = sorted(ws.port for ws in live_servers)
            for a, b in zip(ports, ports[1:]):
                if b - a <= span:
                    raise RuntimeError(
                        f"fabric door bands overlap: webservers on ports {a} "
                        f"and {b} each need {span + 1} consecutive ports with "
                        f"{self.n_proc} processes at PATHWAY_FABRIC_PORT_STRIDE="
                        f"{self.stride} — space the webserver ports at least "
                        f"{span + 1} apart, or set the stride to 0 on "
                        f"multi-host pods"
                    )
        for ws in live_servers:
            door = S.PathwayWebserver(
                host=ws.host, port=ws.port + self.pid * self.stride
            )
            door._fabric_door = True
            for route, methods, _handler, meta in ws._routes:
                if meta is None:
                    continue
                troute = meta.get("table_route")
                if troute is not None:
                    handler = self._make_table_handler(troute)
                elif self.shardmap is not None:
                    # zero-hop: the route's ORIGINAL handler already does the
                    # whole job on any process (locally-owned mint, local
                    # push, local future resolution) — the door only stamps
                    # the fabric header asserting no forward hop happened
                    handler = self._make_zerohop_handler(_handler)
                else:
                    rs = meta["serving"]
                    ir = self._index_routes.get(route)
                    if ir is not None and ir.state is rs:
                        # replica-served retrieval: answer KNN from the local
                        # changelog-fed index, forward when stale/resyncing
                        handler = self._make_retrieve_handler(ir, rs)
                    else:
                        handler = self._make_forward_handler(rs)
                door._add_route(route, list(methods), handler, meta)
            door.start()
            self.doors.append(door)

    # ---------------------------------------------------------- ingress (peers)
    def _shed_web(self, rs: Any, reason: str):
        from pathway_tpu_torch.io.http import _wire

        from pathway_tpu_torch.io.http import _server as S

        rs.shed_total += 1
        S._door_event(rs, reason)
        status = 503 if reason == "shutting_down" else 429
        return _wire.json_response(
            {"error": "overloaded", "reason": reason},
            status=status,
            headers={"Retry-After": "1"},
        )

    def _make_forward_handler(self, rs: Any):
        from pathway_tpu_torch.io.http import _wire

        from pathway_tpu_torch.io.http import _server as S
        from pathway_tpu_torch.observability import requests as _req_trace

        async def handler(request: _wire.Request) -> _wire.Response:
            from pathway_tpu_torch.observability import health as _health

            hp = _health.current()
            if hp is not None and request.headers.get("X-Pathway-Canary"):
                # synthetic self-probe: answered from the door state machine
                # BEFORE counters, gauntlet or the forward hop — canaries must
                # never show up as traffic or reach the owner's engine
                status, doc = hp.canary_response(rs.route)
                return _wire.json_response(doc, status=status)
            rs.requests_total += 1
            gated = S.gate_check(rs, request.headers)
            if gated is not None:
                status, body, hdrs = gated
                return _wire.json_response(body, status=status, headers=hdrs or None)
            shed = rs.try_admit()
            if shed is not None:
                return self._shed_web(rs, shed)
            payload = await S.extract_payload(rs, request)
            if rs.request_validator is not None:
                try:
                    rs.request_validator(payload)
                except Exception as e:
                    rs.errors_total += 1
                    return _wire.json_response({"error": str(e)}, status=400)
            values = S.build_row_values(rs, payload)
            arrival_ns = _time.time_ns()
            return await self._forward_values(rs, values, arrival_ns)

        return handler

    async def _forward_values(self, rs: Any, values: tuple, arrival_ns: int):
        """Forward one validated request row to the owning process and relay
        its answer — the post-gauntlet core of :meth:`_make_forward_handler`,
        shared with the replica-served retrieval path's stale fallback."""
        from pathway_tpu_torch.io.http import _wire

        from pathway_tpu_torch.io.http import _server as S
        from pathway_tpu_torch.observability import requests as _req_trace

        # re-check the budget under the lock AT the point it grows: any
        # number of handlers can suspend in extract_payload between the
        # arrival-time try_admit and here (the coordinator handler's
        # registration-lock discipline, applied to fwd_inflight)
        with rs.lock:
            if rs.closed:
                shed_reason = "shutting_down"
            elif len(rs.futures) + rs.fwd_inflight >= rs.max_inflight:
                shed_reason = "max_inflight"
            else:
                shed_reason = None
                rs.fwd_inflight += 1
        if shed_reason is not None:
            return self._shed_web(rs, shed_reason)
        key = S.mint_request_key()
        rp = _req_trace.current()
        request_id = rp.begin(key, rs.route, arrival_ns) if rp is not None else None
        rs.forwarded_out_total += 1
        t0 = _time.time_ns()
        loop = asyncio.get_running_loop()
        try:
            status, body, hdrs = await loop.run_in_executor(
                None,
                lambda: self.node.call(
                    self.owner_pid,
                    "serve",
                    {
                        "route": rs.route,
                        "key": key,
                        "values": values,
                        "arrival_ns": arrival_ns,
                    },
                    self.timeout,
                ),
            )
        except FabricUnavailable as e:
            self.forward_errors_total += 1
            if rp is not None:
                rp.complete(key, "error")
            return _wire.json_response(
                {"error": "fabric forward failed", "reason": str(e)},
                status=503,
            )
        except asyncio.CancelledError:
            # client disconnected mid-forward (doors run with
            # handler_cancellation=True): the registered flight record
            # must not leak in the live table (it would pin plane.hot
            # forever) — the owner still answers and cleans up its side
            if rp is not None:
                rp.complete(key, "cancelled")
            raise
        finally:
            with rs.lock:
                rs.fwd_inflight -= 1
        t1 = _time.time_ns()
        headers = dict(hdrs or {})
        if request_id is not None:
            headers["X-Pathway-Request-Id"] = request_id
        headers["X-Pathway-Fabric"] = f"forwarded:p{self.owner_pid}"
        if rp is not None:
            rp.note_boundary(
                key, "fabric/forward", t0, t1, {"owner": self.owner_pid}
            )
            label = (
                "ok"
                if status == 200
                else "timeout"
                if status == 504
                else "shed"
                if status in (429, 503)
                else "error"
            )
            rp.complete(key, label, t1, _time.time_ns())
        if status == 200:
            # the OWNER's resolution pass already counted this response
            # (responses_total is where-the-answer-was-computed, so the
            # pod rollup stays exact); the ingress door keeps the
            # client-observed latency, which includes the forward hop
            rs.latency.observe((t1 - arrival_ns) / 1e9)
        return _wire.Response(status, body.encode("utf-8"), _wire.JSON, headers)

    # -------------------------------------------------- replica-served retrieval
    def _replica_unready(self, ir: Any) -> str | None:
        """Why this door must forward instead of answering from its replica
        index, or None when the replica is serveable. Never answer past the
        bound: staleness is measured against the WORST peer slice — a replica
        is only as fresh as its most-lagged source."""
        rep = ir.replica
        if rep is None or ir.composite:
            return "unarmed"
        if not rep.self_authoritative:
            # this process restored from an operator snapshot: its own slice
            # can't be re-derived, so its answers (and its snapshot RPC) are
            # off until fresh ops rebuild authority
            return "restored"
        if any(
            isinstance(tok, tuple) and len(tok) == 3 and tok[:2] == ("ix", ir.route)
            for tok in self._resyncing
        ):
            return "resync"
        lag = rep.remote_lag_s(self.n_proc)
        if lag is None:
            return "never_synced"
        if lag > self.replica_max_staleness_s:
            return "stale"
        return None

    def _make_retrieve_handler(self, ir: Any, rs: Any):
        from pathway_tpu_torch.io.http import _wire

        from pathway_tpu_torch.io.http import _server as S
        from pathway_tpu_torch.observability import requests as _req_trace

        async def handler(request: _wire.Request) -> _wire.Response:
            from pathway_tpu_torch.observability import health as _health

            hp = _health.current()
            if hp is not None and request.headers.get("X-Pathway-Canary"):
                # synthetic self-probe: state-machine answer only, no engine
                # or replica work, no user-facing counters
                status, doc = hp.canary_response(rs.route)
                return _wire.json_response(doc, status=status)
            rs.requests_total += 1
            gated = S.gate_check(rs, request.headers)
            if gated is not None:
                status, body, hdrs = gated
                return _wire.json_response(body, status=status, headers=hdrs or None)
            shed = rs.try_admit()
            if shed is not None:
                return self._shed_web(rs, shed)
            payload = await S.extract_payload(rs, request)
            if rs.request_validator is not None:
                try:
                    rs.request_validator(payload)
                except Exception as e:
                    rs.errors_total += 1
                    return _wire.json_response({"error": str(e)}, status=400)
            values = S.build_row_values(rs, payload)
            arrival_ns = _time.time_ns()
            reason = self._replica_unready(ir)
            if reason is None:
                vals = dict(zip(rs.schema_columns, values))
                key = S.mint_request_key()
                rp = _req_trace.current()
                request_id = (
                    rp.begin(key, rs.route, arrival_ns) if rp is not None else None
                )
                loop = asyncio.get_running_loop()
                res = await loop.run_in_executor(
                    None, lambda: _ireplica.local_retrieve_response(ir, vals)
                )
                if res is not None:
                    body, spans = res
                    t1 = _time.time_ns()
                    lag = ir.replica.remote_lag_s(self.n_proc) or 0.0
                    headers = {
                        "X-Pathway-Fabric": f"replica:p{self.pid}",
                        "X-Pathway-Replica-Lag-Ms": str(round(lag * 1e3, 1)),
                    }
                    if request_id is not None:
                        headers["X-Pathway-Request-Id"] = request_id
                    if rp is not None:
                        for name, s0, s1, attrs in spans:
                            rp.note_boundary(key, name, s0, s1, attrs)
                        rp.complete(key, "ok", t1, _time.time_ns())
                    ir.local_answers += 1
                    rs.responses_total += 1
                    rs.latency.observe((t1 - arrival_ns) / 1e9)
                    return _wire.Response(200, body.encode("utf-8"), _wire.JSON, headers)
                # unanswerable locally (async embedder, payload-less rows, …):
                # release the flight record and take the forward hop
                reason = "unanswerable"
                if rp is not None:
                    rp.drop(key)
            ir.fallbacks += 1
            ir.fallback_reasons[reason] = ir.fallback_reasons.get(reason, 0) + 1
            return await self._forward_values(rs, values, arrival_ns)

        return handler

    # ------------------------------------------------------ shard-map helpers
    def owner_pid_of_key(self, key: int) -> int:
        """Process owning engine key ``key`` per the shard map (owner worker
        // threads-per-process); the fixed owner pid without a map."""
        sm = self.shardmap
        if sm is None:
            return self.owner_pid
        owner = int(sm.owner_of_keys(np.asarray([key], dtype=np.uint64))[0])
        return owner // self.threads

    def table_owner_pid(self, value: Any) -> int:
        """Process owning a served table's lookup key: the query-param string
        hashes exactly like the changelog's ``route_by`` (both reduce to
        ``stable_hash_obj`` of the stringified value), so door-side routing
        and engine-side placement agree byte-for-byte."""
        if self.shardmap is None:
            return self.owner_pid
        from pathway_tpu_torch.internals.keys import stable_hash_obj

        return self.owner_pid_of_key(stable_hash_obj(str(value)))

    def _make_zerohop_handler(self, inner):
        
        async def handler(request):
            resp = await inner(request)
            # the assertion the zero-hop tests (and curious operators) read:
            # this door answered as the owner — no forward hop
            resp.headers = {**(resp.headers or {}), "X-Pathway-Fabric": f"owner:p{self.pid}"}
            return resp

        return handler

    def _handle_wakeup(self, payload: dict) -> None:
        wakeup = getattr(self.runtime, "wakeup", None)
        if wakeup is not None:
            wakeup.request(float(payload.get("delay") or 0.0))

    def _nudge_coordinator(self, delay: float) -> None:
        """Peer-door tick scheduling: pid 0 owns the inter-tick sleep, so a
        peer that admitted a request casts it a wakeup. Rate-limited to one
        cast per millisecond — coalescing happens at the wakeup itself, the
        fabric only needs to keep the clock honest."""
        now = _time.monotonic()
        if now - self._last_nudge < 0.001:
            return
        self._last_nudge = now
        if self.node.cast(0, "wakeup", {"delay": delay}, connect_timeout=0.2):
            self.nudges_total += 1

    async def serve_table_lookup(
        self, troute: _replica.TableRoute, key: str | None
    ) -> tuple[int, str, dict]:
        """Shard-map lookup path shared by every door (including the owner's
        original webserver): answer authoritatively for locally-owned keys,
        from the replica within the staleness bound for peer-owned keys, and
        forward to the KEY'S owner — never a fixed pid — when stale."""
        if key is None:
            status, body = _replica.lookup_response(troute, key)
            return status, body, {"X-Pathway-Fabric": f"owner:p{self.pid}"}
        owner = self.table_owner_pid(key)
        if owner == self.pid:
            status, body = _replica.lookup_response(troute, key)
            troute.local_answers += 1
            return status, body, {
                "X-Pathway-Fabric": f"owner:p{self.pid}",
                "X-Pathway-Replica-Lag-Ms": "0.0",
            }
        lag = troute.store.lag_from(owner)
        if lag is not None and lag <= self.max_staleness_s:
            status, body = _replica.lookup_response(troute, key)
            troute.local_answers += 1
            return status, body, {
                "X-Pathway-Fabric": f"replica:p{self.pid}",
                "X-Pathway-Replica-Lag-Ms": str(round(lag * 1e3, 1)),
            }
        # stale (or never-synced) for THIS source's slice: never answer past
        # the bound — one hop to the authoritative process, then catch up
        troute.fallbacks += 1
        loop = asyncio.get_running_loop()
        try:
            status, body, _hdrs = await loop.run_in_executor(
                None,
                lambda: self.node.call(
                    owner,
                    "table_lookup",
                    {"route": troute.route, "key": key},
                    self.timeout,
                ),
            )
        except FabricUnavailable as e:
            self.forward_errors_total += 1
            return (
                503,
                _dumps({"error": "fabric forward failed", "reason": str(e)}),
                {},
            )
        self._resync(troute, wait=False, src=owner)
        return status, body, {"X-Pathway-Fabric": f"forwarded:p{owner}"}

    def _make_table_handler(self, troute: _replica.TableRoute):
        from pathway_tpu_torch.io.http import _wire

        from pathway_tpu_torch.io.http import _server as S

        async def handler(request: _wire.Request) -> _wire.Response:
            rs = troute.state
            rs.requests_total += 1
            gated = S.gate_check(rs, request.headers)
            if gated is not None:
                status, body, hdrs = gated
                return _wire.json_response(body, status=status, headers=hdrs or None)
            t0 = _time.time_ns()
            key = _wire.query_get(request, troute.key_column)
            if self.shardmap is not None:
                status, body, headers = await self.serve_table_lookup(troute, key)
                if status == 200:
                    rs.responses_total += 1
                    rs.latency.observe((_time.time_ns() - t0) / 1e9)
                else:
                    rs.errors_total += 1
                return _wire.Response(status, body.encode("utf-8"), _wire.JSON, headers)
            lag = troute.store.lag_s()
            if lag is not None and lag <= self.max_staleness_s:
                status, body = _replica.lookup_response(troute, key)
                troute.local_answers += 1
                headers = {
                    "X-Pathway-Fabric": f"replica:p{self.pid}",
                    "X-Pathway-Replica-Lag-Ms": str(round(lag * 1e3, 1)),
                }
            else:
                # stale (or never-synced) replica: never answer past the
                # bound — forward the lookup to the authoritative store
                troute.fallbacks += 1
                loop = asyncio.get_running_loop()
                try:
                    status, body, _hdrs = await loop.run_in_executor(
                        None,
                        lambda: self.node.call(
                            self.owner_pid,
                            "table_lookup",
                            {"route": troute.route, "key": key},
                            self.timeout,
                        ),
                    )
                except FabricUnavailable as e:
                    self.forward_errors_total += 1
                    return _wire.json_response(
                        {"error": "fabric forward failed", "reason": str(e)},
                        status=503,
                    )
                headers = {"X-Pathway-Fabric": f"forwarded:p{self.owner_pid}"}
                self._resync(troute, wait=False)
            if status == 200:
                rs.responses_total += 1
                rs.latency.observe((_time.time_ns() - t0) / 1e9)
            else:
                rs.errors_total += 1
            return _wire.Response(status, body.encode("utf-8"), _wire.JSON, headers)

        return handler

    # ------------------------------------------------------------ owner serving
    def _handle_canary(self, payload: dict, reply) -> None:
        """Health-plane link canary: a tiny echo over the real request
        transport — no engine work, no user-facing counters — so the prober
        measures exactly the path real forwards take."""
        from pathway_tpu_torch.observability import health as _health

        plane = _health.current()
        reply(
            {
                "ok": True,
                "pid": self.pid,
                "state": plane.door_state() if plane is not None else None,
                "from": payload.get("from"),
            }
        )

    def _handle_serve(self, payload: dict, reply) -> None:
        rs = self._route_states.get(payload.get("route"))
        loop = self._loop
        if rs is None or loop is None or rs.node is None:
            reply((404, _dumps({"error": "unknown route"}), {}))
            return
        rs.forwarded_in_total += 1
        asyncio.run_coroutine_threadsafe(self._serve_one(rs, payload, reply), loop)

    async def _serve_one(self, rs: Any, payload: dict, reply) -> None:
        from pathway_tpu_torch.io.http import _server as S
        from pathway_tpu_torch.observability import requests as _req_trace

        key = int(payload["key"])
        values = tuple(payload["values"])
        arrival_ns = int(payload["arrival_ns"])

        def shed(reason: str):
            rs.shed_total += 1
            S._door_event(rs, reason)
            status = 503 if reason == "shutting_down" else 429
            reply(
                (
                    status,
                    _dumps({"error": "overloaded", "reason": reason}),
                    {"Retry-After": "1"},
                )
            )

        fut = asyncio.get_running_loop().create_future()
        with rs.lock:
            if rs.closed:
                shed("shutting_down")
                return
            if len(rs.futures) + rs.fwd_inflight >= rs.max_inflight:
                shed("max_inflight")
                return
            rs.futures[key] = (fut, asyncio.get_running_loop(), arrival_ns, values)
        # the owner registers the SAME request id the ingress minted, so the
        # two processes' kept traces stitch under one derived trace id
        rp = _req_trace.current()
        if rp is not None:
            rp.begin(key, rs.route, arrival_ns)
        if not rs.push_admitted(key, values):
            with rs.lock:
                rs.futures.pop(key, None)
            if rp is not None:
                rp.drop(key)
            shed("no_ingest_credit")
            return
        rs.schedule_tick()
        try:
            result = await asyncio.wait_for(fut, timeout=S._REQUEST_TIMEOUT_S)
        except asyncio.TimeoutError:
            with rs.lock:
                ent = rs.futures.pop(key, None)
            rs.timeouts_total += 1
            if rp is not None:
                rp.complete(key, "timeout")
            if ent is not None and rs.delete_completed and rs.node is not None:
                rs.node._append_events([(key, values, -1)])
                rs.schedule_tick()
            reply((504, _dumps({"error": "timeout"}), {}))
            return
        if result is S._SHUTDOWN:
            if rp is not None:
                rp.drop(key)
            reply((503, _dumps({"error": "engine shutting down"}), {}))
            return
        # the response writer's resolution pass completed the owner-side
        # flight (engine decomposition) and counted the response; only the
        # bytes remain — identical to web.json_response's json.dumps
        reply((200, _dumps(S._jsonable(result)), {}))

    def _handle_table_lookup(self, payload: dict, reply) -> None:
        troute = self._table_routes.get(payload.get("route"))
        if troute is None:
            reply((404, _dumps({"error": "unknown route"}), {}))
            return
        status, body = _replica.lookup_response(troute, payload.get("key"))
        reply((status, body, {}))

    def _handle_replica_snapshot(self, payload: dict, reply) -> None:
        troute = self._table_routes.get(payload.get("route"))
        if troute is None:
            reply(None)
            return
        store = troute.store
        with store._lock:
            rows = dict(store.rows)
            seq = store.seq
            ts = store.synced_unix or _time.time()
        if self.shardmap is not None:
            # only this process's authoritative slice: the requester installs
            # it per source, and replicated peer rows here may themselves lag
            rows = {
                k: v for k, v in rows.items() if self.table_owner_pid(k) == self.pid
            }
        reply({"rows": rows, "seq": seq, "ts": ts, "src": self.pid})

    # ------------------------------------------------------------- replica feed
    def replica_publish(self, troute: _replica.TableRoute, deltas: list) -> None:
        """Owner tick-end hook (from serve_table's subscribe): queue one
        tick's changelog batch for the next cast. ``prev_seq`` records the
        sequence a replica must already hold for the accumulated deltas to
        suffice — several ticks may coalesce into one cast."""
        with self._outbox_lock:
            ent = self._outbox.get(troute.route)
            if ent is None:
                # the store's seq was bumped by the apply() that preceded
                # this publish, so the required predecessor is seq - 1
                ent = self._outbox[troute.route] = {
                    "deltas": [],
                    "prev_seq": troute.store.seq - 1,
                }
            ent["deltas"].extend(deltas)

    def _membership_version(self) -> int | None:
        from pathway_tpu_torch import elastic as _elastic

        eplane = _elastic.current()
        if eplane is not None and eplane.membership is not None:
            return eplane.membership.version
        return None

    def on_tick_done(self, tick: int) -> None:
        """Tick-end cast: pending table changelog batches (owner only in single-owner
        mode, every process under the shard map), this process's INDEX
        changelog slice (always all-to-all — doc rows shard by key, so every
        process authors ops), freshly-encoded memo entries — or, at least
        every ``_FRONTIER_INTERVAL_S``, an empty frontier stamp so replica
        lag keeps measuring freshness while the pipeline is idle."""
        has_tables = bool(self._table_routes) and (
            self.shardmap is not None or self.pid == self.owner_pid
        )
        has_index = bool(self._index_routes)
        if not has_tables and not has_index:
            return
        now = _time.time()
        outbox: dict[str, Any] = {}
        if has_tables:
            with self._outbox_lock:
                outbox, self._outbox = self._outbox, {}
        index_pending = has_index and any(
            ir.outbox_pending() for ir in self._index_routes.values()
        )
        memo_out = self._drain_memo_out() if self._memo_share else None
        if (
            not outbox
            and not index_pending
            and not memo_out
            and now - self._last_cast < _FRONTIER_INTERVAL_S
        ):
            return
        self._last_cast = now
        payload: dict[str, Any] = {
            "ts": now,
            "mv": self._membership_version(),
            "src": self.pid,
        }
        if has_tables:
            tables = {}
            for route, troute in self._table_routes.items():
                ent = outbox.get(route)
                tables[route] = {
                    "deltas": ent["deltas"] if ent else [],
                    "prev_seq": ent["prev_seq"] if ent else None,
                    "seq": troute.store.seq,
                }
                troute.casts_out += 1
            payload["tables"] = tables
        if has_index:
            index = {}
            for route, ir in self._index_routes.items():
                ops, prev, seq = ir.drain_ops()
                index[route] = {"ops": ops, "prev_seq": prev, "seq": seq}
                ir.casts_out += 1
            payload["index"] = index
        if memo_out:
            payload["memo"] = memo_out
            self.memo_casts_total += 1
            self.memo_entries_out += sum(len(v) for v in memo_out.values())
        for peer in range(self.n_proc):
            if peer != self.pid:
                self.node.cast(peer, "replica", payload, connect_timeout=1.0)
        self.casts_total += 1

    def _handle_replica_cast(self, payload: dict) -> None:
        from pathway_tpu_torch import elastic as _elastic
        from pathway_tpu_torch.elastic.membership import check_version

        eplane = _elastic.current()
        if eplane is not None and eplane.membership is not None:
            if not check_version(
                eplane.membership.version,
                payload.get("mv"),
                f"fabric:replica:p{self.pid}",
            ):
                return  # a pre-reshard zombie's cast: drop it
        ts = float(payload.get("ts") or 0.0)
        src = payload.get("src")
        for route, entry in (payload.get("tables") or {}).items():
            troute = self._table_routes.get(route)
            if troute is None:
                continue
            deltas = entry.get("deltas") or []
            seq = int(entry.get("seq") or 0)
            store = troute.store
            if self.shardmap is not None and src is not None:
                # shard-map mode: the cast carries ONE source's slice;
                # sequence continuity and freshness are per source
                src = int(src)
                if deltas:
                    prev = int(entry.get("prev_seq") or 0)
                    if store.src_gap(src, prev):
                        self._resync(troute, wait=False, src=src)
                    store.apply_from(src, deltas, seq, ts)
                else:
                    if seq > store.src_seq.get(src, 0):
                        self._resync(troute, wait=False, src=src)
                    store.frontier_from(src, seq, ts)
                continue
            if deltas:
                prev = int(entry.get("prev_seq") or 0)
                if prev > store.seq:
                    # missed at least one cast (joined late / send failure):
                    # these deltas don't connect to local state — pull a
                    # snapshot; still apply them (last write wins converges)
                    self._resync(troute, wait=False)
                store.apply(deltas, seq, ts)
            else:
                if seq > store.seq:
                    self._resync(troute, wait=False)
                store.frontier(seq, ts)
        if src is not None:
            s = int(src)
            for route, entry in (payload.get("index") or {}).items():
                ir = self._index_routes.get(route)
                rep = ir.replica if ir is not None else None
                if rep is None or s == rep.self_src:
                    continue
                ops = entry.get("ops") or []
                seq = int(entry.get("seq") or 0)
                if ops:
                    prev = int(entry.get("prev_seq") or 0)
                    if prev == 0 and seq < rep.src_seq.get(s, 0):
                        # the source RESTARTED: its counter reset below the
                        # position we hold, which would wedge gap detection
                        # (every future seq looks "old") — rewind our cursor
                        # and let the ops + next resync converge the slice
                        rep.reset_src(s)
                    if rep.src_gap(s, prev):
                        rep.gaps_total += 1
                        self._resync_index(ir, s, wait=False)
                    rep.apply_ops(s, ops, seq, ts)
                else:
                    if seq > rep.src_seq.get(s, 0):
                        rep.gaps_total += 1
                        self._resync_index(ir, s, wait=False)
                    rep.frontier_from(s, seq, ts)
        memo = payload.get("memo")
        if memo:
            self._apply_memo_in(memo)

    def _resync(
        self, troute: _replica.TableRoute, wait: bool, src: int | None = None
    ) -> None:
        """Pull a snapshot from the authoritative process (thread — never on
        the transport recv loop); convergent under concurrent delta casts.
        Shard-map mode pulls per SOURCE slice; otherwise the pid-0 owner's
        full store."""
        if src is None:
            src = self.owner_pid
        token = (troute.route, src) if self.shardmap is not None else troute.route
        if token in self._resyncing:
            return
        self._resyncing.add(token)
        # readiness: this door serves the route from a replica that just
        # gapped — demote it to syncing until the snapshot lands
        from pathway_tpu_torch.observability import health as _health

        _health.door_syncing(token)

        def pull() -> None:
            try:
                snap = self.node.call(
                    src,
                    "replica_snapshot",
                    {"route": troute.route},
                    timeout=min(5.0, self.timeout),
                )
                if snap is not None and self.shardmap is not None:
                    troute.store.install_slice(
                        int(snap.get("src", src)),
                        snap["rows"],
                        snap["seq"],
                        snap["ts"],
                        lambda k: self.table_owner_pid(k) == src,
                    )
                elif snap is not None:
                    troute.store.install_snapshot(
                        snap["rows"], snap["seq"], snap["ts"]
                    )
            except FabricUnavailable:
                pass  # stays stale; lookups keep falling back to the owner
            finally:
                self._resyncing.discard(token)
                _health.door_synced(token)

        if wait:
            pull()
        else:
            threading.Thread(target=pull, daemon=True).start()

    # ----------------------------------------------------- index replica feed
    def _handle_index_snapshot(self, payload: dict, reply) -> None:
        ir = self._index_routes.get(payload.get("route"))
        rep = ir.replica if ir is not None else None
        if rep is None or not rep.self_authoritative:
            # restored-from-snapshot processes can't vouch for their slice
            # (ops were never re-derived): answering would hand the peer a
            # silently-empty slice it would then serve from — refuse instead
            reply(None)
            return
        rows, seq, ts = rep.self_slice()
        reply({"rows": rows, "seq": seq, "ts": ts, "src": self.pid})

    def _resync_index(self, ir: Any, src: int, wait: bool = False) -> None:
        """Pull one peer's authoritative index slice (thread — never on the
        transport recv loop); convergent under concurrent op casts."""
        rep = ir.replica
        if rep is None:
            return
        token = ("ix", ir.route, src)
        if token in self._resyncing:
            return
        self._resyncing.add(token)
        from pathway_tpu_torch.observability import health as _health

        _health.door_syncing(token)

        def pull() -> None:
            try:
                snap = self.node.call(
                    src,
                    "index_snapshot",
                    {"route": ir.route},
                    timeout=min(5.0, self.timeout),
                )
                if snap is not None:
                    rep.install_slice(
                        int(snap.get("src", src)),
                        snap["rows"],
                        snap["seq"],
                        snap["ts"],
                    )
                    rep.resyncs_total += 1
                else:
                    # the peer disclaimed its slice (restored, not yet
                    # re-authoritative): poison it so lag reads None and the
                    # route forwards until fresh ops arrive from that peer
                    rep.poison(src)
            except FabricUnavailable:
                pass  # stays unsynced; the route keeps forwarding
            finally:
                self._resyncing.discard(token)
                _health.door_synced(token)

        if wait:
            pull()
        else:
            threading.Thread(target=pull, daemon=True).start()

    # --------------------------------------------------------- shared memo tier
    def _drain_memo_out(self) -> dict | None:
        """Pop locally-encoded query embeddings for the cast. sys.modules
        gate: the fabric must not import xpacks — no embedders module loaded
        means no memoizing embedders exist."""
        mod = sys.modules.get("pathway_tpu_torch.xpacks.llm.embedders")
        if mod is None:
            return None
        out = mod.drain_shared_memo(limit=64)
        return out or None

    def _apply_memo_in(self, memo: dict) -> None:
        mod = sys.modules.get("pathway_tpu_torch.xpacks.llm.embedders")
        if mod is None:
            return
        n = 0
        for fp, entries in memo.items():
            n += mod.apply_shared_memo(fp, entries)
        self.memo_entries_in += n

    # ------------------------------------------------------------------- status
    def status(self) -> dict[str, Any]:
        return {
            "enabled": True,
            "process_id": self.pid,
            "owner_pid": self.owner_pid,
            "shardmap_version": (
                None if self.shardmap is None else self.shardmap.version
            ),
            "transport_port": self.node.port,
            "doors": [
                {
                    "host": d.host,
                    "port": d.port,
                    "routes": sorted(r for r, _m, _h, _meta in d._routes),
                }
                for d in self.doors
            ],
            "forward_errors_total": self.forward_errors_total,
            "replica_casts_total": self.casts_total,
            "replica": {
                route: troute.replica_snapshot()
                for route, troute in sorted(self._table_routes.items())
            },
            "index": {
                route: ir.replica_snapshot(self.n_proc)
                for route, ir in sorted(self._index_routes.items())
            },
            "memo_share": {
                "enabled": self._memo_share,
                "casts": self.memo_casts_total,
                "entries_out": self.memo_entries_out,
                "entries_in": self.memo_entries_in,
            },
        }

    def close(self) -> None:
        for door in self.doors:
            try:
                door.stop()
            except Exception:
                pass
        self.doors = []
        loop = self._loop
        if loop is not None:
            try:
                loop.call_soon_threadsafe(loop.stop)
            except RuntimeError:
                pass
            self._loop = None
        self.node.close()
