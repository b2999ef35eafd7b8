"""REST request/response connector — the production query-serving plane.

Carried from ``pathway_tpu/io/http/_server.py``, which mirrors the
reference's ``python/pathway/io/http/_server.py`` (``PathwayWebserver``
``:329``, ``rest_connector`` ``:624``, ``RestServerSubject`` ``:490``): an
HTTP request becomes a row in a streaming queries table (keyed by a request
id); the paired ``response_writer`` subscribes to a result table and resolves
the stored future for that id, completing the HTTP response. Queries are
append-only ("as-of-now" discipline) — results for a request are served once
and not retracted.

The serving tier:

- **Admission**: every route carries a bounded in-flight budget
  (``PATHWAY_SERVE_MAX_INFLIGHT``) and, with the flow plane on, checks its
  input's ``interactive``-class :class:`~pathway_tpu_torch.flow.credit.IngestGate`
  for credit; overload is shed with a fast ``429`` +
  ``Retry-After`` and an exact counter instead of an unbounded futures dict.
  Per-route token buckets and API keys (``fabric/limits.py``) run first.
- **Arrival-driven query ticks**: arrival schedules an engine tick through
  the runtime's :class:`~pathway_tpu_torch.engine.runtime.TickWakeup` after a
  short coalesce window (``PATHWAY_SERVE_COALESCE_MS``, immediate once
  ``PATHWAY_SERVE_COALESCE_ROWS`` requests wait), so concurrent requests
  coalesce into ONE tick and ride the microbatch path together.
- **Vectorized responses**: the response writer collects the tick's emissions
  and resolves all of its futures in one pass per event loop
  (``on_time_end``), not one ``call_soon_threadsafe`` per row.
- **OpenAPI**: the route schemas and ``documentation`` generate an OpenAPI 3
  document served at ``/_schema``.
- **Lifecycle**: ``PathwayWebserver.stop()`` closes the server and joins its
  thread (back-to-back runs can reuse the port); engine shutdown flushes
  still-pending request futures with ``503`` instead of leaving clients
  hanging for the request timeout.

The HTTP/1.1 server under it is the port's own (``_wire.py``, on the
standard library), answering as aiohttp answers the reference. The handlers
consult the observability planes as the reference's do: the request-trace
plane mints a request id per admitted request (``X-Pathway-Request-Id`` on
every answer), records its flight path and completes it; the health plane
answers ``/healthz`` and ``/readyz`` from its door state machine and its
canaries (``X-Pathway-Canary``) short-circuit before any counter or
admission; the live tracer gets door and respond events; with the flow
plane on, ``push_admitted`` takes the route input's ingest credit. On a
cluster run the serving fabric (``fabric/routing.py``) mirrors every route at
each process's door; with the shard map (``PATHWAY_SHARDMAP=on``) every door
mints keys it owns and serves them itself (zero-hop).
"""

from __future__ import annotations

import asyncio
import itertools
import json as _json
import logging
import threading
import time as _time_mod
import weakref
from dataclasses import dataclass, field
from typing import Any

import numpy as np

from pathway_tpu_torch.engine import operators as ops
from pathway_tpu_torch.engine.graph import Node
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals.json import Json
from pathway_tpu_torch.internals.keys import splitmix64
from pathway_tpu_torch.internals.logical import LogicalNode
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.internals.universe import Universe
from pathway_tpu_torch.io.http import _wire

_log = logging.getLogger(__name__)

#: request future resolution values that are NOT payloads
_SHUTDOWN = object()  # engine stopped with the request still pending -> 503

#: client-facing request timeout (the engine answered nothing for this long)
_REQUEST_TIMEOUT_S = 120.0


def _jsonable(v: Any) -> Any:
    if isinstance(v, Json):
        return v.value
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, (tuple, list)):
        return [_jsonable(x) for x in v]
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    return v


@dataclass
class EndpointDocumentation:
    """Human-facing route metadata woven into the generated OpenAPI document
    (reference ``_server.py`` EndpointDocumentation). Every field is optional;
    an undocumented route still appears in ``/_schema`` with its schema."""

    summary: str | None = None
    description: str | None = None
    tags: list[str] = field(default_factory=list)


# --------------------------------------------------------------------- serving


class _RouteServing:
    """Per-route serving state: the request futures, the admission budget and
    the exact counters ``/status``'s serving section reports."""

    def __init__(self, route: str, methods: tuple[str, ...], schema):
        from pathway_tpu_torch.internals.parse_graph import G
        from pathway_tpu_torch.observability.metrics import Histogram

        self.route = route
        self.methods = tuple(methods)
        self.schema = schema
        # hoisted once per route: the payload-parse helpers run per request
        # at every door, and schema dict materialization is not free there
        if schema is not None:
            self.schema_columns = schema.column_names()
            self.schema_dtypes = schema.dtypes()
            self.schema_defaults = schema.default_values()
        else:
            self.schema_columns, self.schema_dtypes, self.schema_defaults = (
                [],
                {},
                {},
            )
        self.lock = threading.Lock()
        self.node: ops.StreamInputNode | None = None
        self.runtime: Any = None
        #: graph generation this route was defined under — registries outlive
        #: graphs, so the fabric (and cleanup) must tell current from leftover
        self.graph_gen = G.generation
        #: the route's request_validator, exposed so fabric front doors on
        #: peer processes validate at ingress exactly like the owner's door
        self.request_validator: Any = None
        #: key -> (future, owning event loop, arrival time_ns, row values)
        self.futures: dict[int, tuple] = {}
        self.closed = True  # open between driver.start() and flush_pending()
        self.delete_completed = True
        # admission knobs, re-read per run in configure()
        self.max_inflight = 1024
        self.coalesce_s = 0.002
        self.coalesce_rows = 64
        self.tick_mode = "arrival"
        self.arrivals_since_wake = 0
        self._wake_window_t0 = 0.0
        # front-door protection (fabric/limits): per-route token bucket +
        # API-key guard, built in configure() from env or per-route overrides
        self.rate_limit_override: float | None = None
        self.api_keys_override: tuple[str, ...] | None = None
        self.limiter: Any = None
        self.auth: Any = None
        #: ingress-side forwarded requests currently awaiting the owner
        #: (fabric front doors; bounded by the same max_inflight budget)
        self.fwd_inflight = 0
        # counters (exact; the shed path is only acceptable because of them)
        self.requests_total = 0
        self.responses_total = 0
        self.shed_total = 0
        self.errors_total = 0  # 4xx validation/parse failures
        self.timeouts_total = 0
        self.limited_total = 0  # 429s from the token bucket
        self.unauthorized_total = 0  # 401s (no API key presented)
        self.forbidden_total = 0  # 403s (wrong API key)
        self.forwarded_out_total = 0  # ingress -> owner fabric forwards
        self.forwarded_in_total = 0  # owner side: requests arriving via fabric
        self.batches_total = 0  # response-resolution passes (~= serving ticks)
        self.batched_rows_total = 0  # responses resolved by those passes
        self.latency = Histogram()
        #: optional extra /status fields (serve_table attaches its replica
        #: store's rows/lag/seq here)
        self.extra_snapshot: Any = None

    # ---------------------------------------------------------------- lifecycle
    def configure(self) -> None:
        """Per-run admission/coalesce knobs (called by the connector driver's
        ``start`` so env changes between runs take effect)."""
        from pathway_tpu_torch.internals.config import get_pathway_config

        from pathway_tpu_torch.fabric.limits import ApiKeyGuard, TokenBucket

        cfg = get_pathway_config()
        self.max_inflight = cfg.serve_max_inflight
        self.coalesce_s = cfg.serve_coalesce_ms / 1000.0
        self.coalesce_rows = cfg.serve_coalesce_rows
        self.tick_mode = cfg.serve_tick
        rate = (
            self.rate_limit_override
            if self.rate_limit_override is not None
            else cfg.serve_rate
        )
        self.limiter = TokenBucket(rate, cfg.serve_burst or None) if rate > 0 else None
        keys = (
            self.api_keys_override
            if self.api_keys_override is not None
            else cfg.serve_api_keys
        )
        self.auth = ApiKeyGuard(keys) if keys else None
        self.closed = False

    def flush_pending(self) -> int:
        """Engine shutdown: resolve every still-pending request future with
        the shutdown sentinel so handlers answer ``503`` now instead of
        timing out after ``_REQUEST_TIMEOUT_S``. Returns how many flushed."""
        with self.lock:
            self.closed = True
            pending, self.futures = self.futures, {}
        from pathway_tpu_torch.observability import requests as _req_trace

        rp = _req_trace.current()
        if rp is not None:
            for key in pending:
                rp.drop(key)
        by_loop: dict[Any, list] = {}
        for fut, loop, _arrival_ns, _values in pending.values():
            by_loop.setdefault(loop, []).append((fut, _SHUTDOWN))
        for loop, items in by_loop.items():
            try:
                loop.call_soon_threadsafe(_set_results, items)
            except RuntimeError:
                pass  # loop already closed; the client connection is gone too
        return len(pending)

    # ---------------------------------------------------------------- admission
    def try_admit(self) -> str | None:
        """Admission check at request arrival: returns a shed reason, or None
        when the request may proceed to parsing. The in-flight budget bounds
        the futures dict; the flow plane's credit is taken atomically at push
        time (:meth:`push_admitted`)."""
        with self.lock:
            if self.closed:
                return "shutting_down"
            if len(self.futures) + self.fwd_inflight >= self.max_inflight:
                return "max_inflight"
        return None

    def push_admitted(self, key: int, values: tuple) -> bool:
        """Push one admitted query row into the engine. With the flow plane
        on, the route input's ``interactive``-class ``IngestGate`` credit is
        taken NON-BLOCKINGLY first — a saturated pod sheds here (fast,
        counted, explicit 429) rather than silently dropping a row whose
        response future is already registered, or stalling the shared event
        loop on the blocking credit path. The append itself bypasses
        ``push``'s gating (the credit is already ours)."""
        node = self.node
        assert node is not None, "rest_connector: engine not running"
        gate = getattr(node, "flow_gate", None)
        if gate is not None and not gate.try_admit(1):
            return False
        node._append_events([(key, values, 1)])
        return True

    def schedule_tick(self) -> None:
        """Arrival-driven tick scheduling with coalescing: the first arrival
        arms a wakeup ``coalesce_s`` out so concurrent requests share one
        engine tick; a full coalesce bucket wakes the loop immediately."""
        if self.tick_mode != "arrival":
            return
        wakeup = getattr(self.runtime, "wakeup", None)
        if wakeup is None:
            return
        now = _time_mod.monotonic()
        with self.lock:
            # the count is scoped to ONE coalesce window: arrivals older than
            # the window were drained by an intervening tick, so carrying
            # them over would eventually force every arrival to wake the
            # loop immediately and defeat coalescing
            if now - self._wake_window_t0 > self.coalesce_s:
                self.arrivals_since_wake = 0
                self._wake_window_t0 = now
            self.arrivals_since_wake += 1
            immediate = self.arrivals_since_wake >= self.coalesce_rows
            if immediate:
                self.arrivals_since_wake = 0
                self._wake_window_t0 = now
        delay = 0.0 if immediate else self.coalesce_s
        nudge = getattr(self.runtime, "coord_nudge", None)
        if nudge is not None:
            # zero-hop peer door: the coordinator (pid 0) owns the inter-tick
            # sleep, so this process's arrivals wake it over the fabric
            nudge(delay)
        else:
            wakeup.request(delay)

    # ---------------------------------------------------------------- telemetry
    def snapshot(self) -> dict[str, Any]:
        from pathway_tpu_torch.observability.metrics import Histogram

        snap = self.latency.snapshot()

        def _q(q):
            v = Histogram.quantile(snap, q)
            return None if v is None or v == float("inf") else v

        with self.lock:
            inflight = len(self.futures) + self.fwd_inflight
        return {
            "route": self.route,
            "methods": list(self.methods),
            "in_flight": inflight,
            "max_inflight": self.max_inflight,
            "requests_total": self.requests_total,
            "responses_total": self.responses_total,
            "shed_total": self.shed_total,
            "errors_total": self.errors_total,
            "timeouts_total": self.timeouts_total,
            "limited_total": self.limited_total,
            "unauthorized_total": self.unauthorized_total,
            "forbidden_total": self.forbidden_total,
            "forwarded_out_total": self.forwarded_out_total,
            "forwarded_in_total": self.forwarded_in_total,
            "rate_limit": self.limiter.rate if self.limiter is not None else None,
            "auth": self.auth is not None,
            "batches_total": self.batches_total,
            "mean_batch": round(
                self.batched_rows_total / self.batches_total, 2
            )
            if self.batches_total
            else None,
            "latency_p50_s": _q(0.5),
            "latency_p99_s": _q(0.99),
            "tick_mode": self.tick_mode,
        }


def _set_results(items: list[tuple]) -> None:
    """One event-loop callback resolving a whole tick's futures (the
    vectorized response pass — was one ``call_soon_threadsafe`` per row)."""
    for fut, value in items:
        if not fut.done():
            fut.set_result(value)


#: every constructed route's serving state; weak so finished graphs release
#: their routes (the monitoring plane filters by the queried runtime)
_ROUTES: "weakref.WeakSet[_RouteServing]" = weakref.WeakSet()

#: every constructed webserver; the fabric plane walks this to build peer
#: front doors mirroring each server's route table (weak: finished graphs
#: release their servers)
_WEBSERVERS: "weakref.WeakSet[PathwayWebserver]" = weakref.WeakSet()

#: process-wide request-key mint shared by every route: a route-local counter
#: would hand the Nth request of two routes the SAME engine key — and the
#: request-trace plane keys its live table (and mints request/trace ids) by
#: that raw key, so colliding keys would cross-wire two requests' flights
_KEY_SEQ = itertools.count(1)


def mint_request_key() -> int:
    """Process-unique engine key for one admitted request. The sequence is
    salted with the process id BEFORE hashing: with the fabric on, every
    process's front door mints keys, and two processes' Nth requests must
    never collide (the request id — and so the derived trace id — IS the
    key). Process 0 hashes the bare sequence, so single-door runs mint the
    exact pre-fabric keys."""
    from pathway_tpu_torch.internals.config import get_pathway_config

    salted = (get_pathway_config().process_id << 48) ^ next(_KEY_SEQ)
    return int(splitmix64(np.asarray([salted], dtype=np.uint64))[0])


def mint_local_key(state: "_RouteServing") -> int:
    """Engine key for one admitted request, constrained (under the shard map)
    to a key THIS process owns. Zero-hop serving hinges on this: the request
    row, its engine work, the subscribe callback and the response future must
    all live on the door that accepted the request, and the shard map routes
    rows by key — so the door rejection-samples the mint until the key's
    owner is itself. Expected tries = n_processes (geometric); the 4096-try
    bound exists only to turn a corrupted map into a loud error. Without a
    shard map this is exactly :func:`mint_request_key`."""
    rt = state.runtime
    sm = getattr(rt, "shardmap", None)
    if sm is None:
        return mint_request_key()
    pid = int(getattr(rt, "pid", 0))
    threads = max(1, int(getattr(rt, "threads", 1)))
    for _ in range(4096):
        key = mint_request_key()
        owner = int(sm.owner_of_keys(np.asarray([key], dtype=np.uint64))[0])
        if owner // threads == pid:
            return key
    raise RuntimeError(
        "shardmap: could not mint a locally-owned request key "
        f"(pid={pid}, map v{sm.version})"
    )


def _zerohop_owner_headers() -> dict | None:
    """``X-Pathway-Fabric: owner:p<pid>`` when the shard-map fabric is live.

    Under zero-hop routing EVERY door — the coordinator's original webserver
    included, which never passes through a fabric door wrapper — answers as
    the owner of the key it minted, and the header must say so truthfully on
    all of them."""
    from pathway_tpu_torch import fabric as _fabric

    plane = _fabric._plane
    if plane is not None and plane.shardmap is not None:
        return {"X-Pathway-Fabric": f"owner:p{plane.pid}"}
    return None


def _door_event(state: "_RouteServing", reason: str) -> None:
    """Trace/request-plane breadcrumbs for a request rejected at the door."""
    from pathway_tpu_torch import observability as _obs
    from pathway_tpu_torch.observability import requests as _req_trace

    tracer = _obs.current()
    if tracer is not None:
        tracer.event(
            "serve/shed", {"pathway.route": state.route, "pathway.reason": reason}
        )
    rp = _req_trace.current()
    if rp is not None:
        rp.note_shed(state.route, reason)


def gate_check(
    state: "_RouteServing", headers: Any
) -> tuple[int, dict, dict[str, str]] | None:
    """Front-door protection shared by EVERY door serving this route — the
    route's handler and (with the fabric) each peer door: API-key auth
    (401 no key / 403 wrong key), then the per-route token bucket (429 with
    an exact Retry-After). Returns ``(status, body, headers)`` on rejection,
    else None. Runs before admission and before the body is read, so a
    hostile flood costs one header inspection per request. Counters are
    exact per process."""
    from pathway_tpu_torch.fabric import limits as _limits

    auth = state.auth
    if auth is not None:
        verdict = auth.check(_limits.extract_api_key(headers))
        if verdict == _limits.UNAUTHORIZED:
            state.unauthorized_total += 1
            _door_event(state, "unauthorized")
            return 401, {"error": "missing api key"}, {}
        if verdict == _limits.FORBIDDEN:
            state.forbidden_total += 1
            _door_event(state, "forbidden")
            return 403, {"error": "invalid api key"}, {}
    limiter = state.limiter
    if limiter is not None:
        wait = limiter.try_take()
        if wait > 0.0:
            state.limited_total += 1
            _door_event(state, "rate_limited")
            return (
                429,
                {"error": "rate limited", "reason": "rate_limit"},
                {"Retry-After": _limits.retry_after_header(wait)},
            )
    return None


async def extract_payload(state: "_RouteServing", request: Any) -> dict:
    """Request → payload dict, identically at every door (GET params coerced
    to schema dtypes, POST bodies parsed as JSON with a raw-text fallback) —
    the fabric forwards parsed VALUES, so ingress parsing must match the
    owner's byte for byte."""
    dtypes = state.schema_dtypes
    if request.method == "GET":
        # keep EVERY query param (request_validator may inspect extras);
        # coerce only the schema-typed ones
        return {
            k: _coerce(v, dtypes[k]) if k in dtypes else v
            for k, v in request.query_items()
        }
    try:
        return await request.json()
    except Exception:
        return {"query": await request.text()}


def build_row_values(state: "_RouteServing", payload: dict) -> tuple:
    """Payload dict → the schema-ordered values tuple pushed into the engine
    (defaults applied, JSON columns boxed) — shared by the route handler
    and (with the fabric) its ingress doors."""
    columns = state.schema_columns
    dtypes = state.schema_dtypes
    defaults = state.schema_defaults
    values = []
    for c in columns:
        v = payload.get(c, defaults.get(c))
        d = dt.unoptionalize(dtypes[c])
        if d == dt.JSON and v is not None and not isinstance(v, Json):
            v = Json(v)
        values.append(v)
    return tuple(values)


#: the per-route counter block piggybacked on heartbeats and rolled up
#: pod-wide (exact sheds/auth failures are the contract of shedding at all)
_COMPACT_FIELDS = (
    ("requests", "requests_total"),
    ("responses", "responses_total"),
    ("shed", "shed_total"),
    ("limited", "limited_total"),
    ("unauthorized", "unauthorized_total"),
    ("forbidden", "forbidden_total"),
    ("errors", "errors_total"),
    ("timeouts", "timeouts_total"),
    ("forwarded_out", "forwarded_out_total"),
    ("forwarded_in", "forwarded_in_total"),
)


def _compact_counters(rs: "_RouteServing") -> dict[str, int]:
    return {name: getattr(rs, attr) for name, attr in _COMPACT_FIELDS}


def serving_heartbeat_summary(runtime) -> dict[str, dict] | None:
    """route → compact counters for this process's live doors — rides the
    heartbeat telemetry block so the coordinator's /status can roll serving
    up cluster-wide (fabric peers count their own ingress traffic)."""
    routes = {
        rs.route: _compact_counters(rs)
        for rs in list(_ROUTES)
        if rs.runtime is runtime
    }
    return routes or None


def serving_status(runtime) -> dict[str, Any] | None:
    """The ``/status`` serving section for one runtime's live routes, or None
    when the run serves nothing. On a cluster coordinator with fabric peers
    reporting, a ``cluster`` block adds the pod-wide per-route rollup."""
    local = [rs for rs in list(_ROUTES) if rs.runtime is runtime]
    rows = sorted((rs.snapshot() for rs in local), key=lambda r: r["route"])
    if not rows:
        return None
    out = {
        "routes": rows,
        "requests_total": sum(r["requests_total"] for r in rows),
        "responses_total": sum(r["responses_total"] for r in rows),
        "shed_total": sum(r["shed_total"] for r in rows),
    }
    monitor = getattr(runtime, "hb_monitor", None)
    peers = monitor.peer_serving() if hasattr(monitor, "peer_serving") else {}
    if peers:
        merged: dict[str, dict[str, int]] = {
            rs.route: _compact_counters(rs) for rs in local
        }
        for summary in peers.values():
            for route, counters in (summary or {}).items():
                agg = merged.setdefault(
                    route, {name: 0 for name, _ in _COMPACT_FIELDS}
                )
                for name, _attr in _COMPACT_FIELDS:
                    agg[name] = agg.get(name, 0) + int(counters.get(name, 0))
        out["cluster"] = {
            "n_reporting": 1 + len(peers),
            "routes": {r: merged[r] for r in sorted(merged)},
        }
    return out


def serving_prometheus_lines(runtime) -> list[str]:
    """``pathway_serve_*`` exposition lines for ``/metrics``."""
    from pathway_tpu_torch.internals.monitoring import escape_label_value
    from pathway_tpu_torch.observability.metrics import BUCKET_BOUNDS_S

    routes = [rs for rs in list(_ROUTES) if rs.runtime is runtime]
    if not routes:
        return []
    routes.sort(key=lambda r: r.route)
    lines: list[str] = []
    counters = (
        ("pathway_serve_requests_total", "Requests received by a REST route", "requests_total", "counter"),
        ("pathway_serve_responses_total", "Responses served by a REST route", "responses_total", "counter"),
        ("pathway_serve_shed_total", "Requests shed (429) by a REST route's admission", "shed_total", "counter"),
        ("pathway_serve_errors_total", "Requests rejected (4xx) by a REST route", "errors_total", "counter"),
        ("pathway_serve_limited_total", "Requests shed (429) by a REST route's token bucket", "limited_total", "counter"),
        ("pathway_serve_unauthorized_total", "Requests rejected 401 (no API key) by a REST route", "unauthorized_total", "counter"),
        ("pathway_serve_forbidden_total", "Requests rejected 403 (wrong API key) by a REST route", "forbidden_total", "counter"),
        ("pathway_serve_forwarded_total", "Requests this door forwarded to the owning process over the fabric", "forwarded_out_total", "counter"),
        ("pathway_serve_inflight", "Requests admitted but not yet answered", None, "gauge"),
    )
    for name, help_text, attr, mtype in counters:
        lines.append(f"# HELP {name} {help_text}")
        lines.append(f"# TYPE {name} {mtype}")
        for rs in routes:
            label = f'route="{escape_label_value(rs.route)}"'
            value = (
                len(rs.futures) + rs.fwd_inflight
                if attr is None
                else getattr(rs, attr)
            )
            lines.append(f"{name}{{{label}}} {value}")
    lines.append("# HELP pathway_serve_latency_seconds Arrival-to-response latency per REST route")
    lines.append("# TYPE pathway_serve_latency_seconds histogram")
    for rs in routes:
        label = f'route="{escape_label_value(rs.route)}"'
        snap = rs.latency.snapshot()
        cum = 0
        for bound, c in zip(BUCKET_BOUNDS_S, snap["counts"]):
            cum += c
            lines.append(
                f'pathway_serve_latency_seconds_bucket{{{label},le="{bound!r}"}} {cum}'
            )
        cum += snap["counts"][-1]
        lines.append(
            f'pathway_serve_latency_seconds_bucket{{{label},le="+Inf"}} {cum}'
        )
        lines.append(f"pathway_serve_latency_seconds_sum{{{label}}} {snap['sum_s']}")
        lines.append(f"pathway_serve_latency_seconds_count{{{label}}} {snap['count']}")
    return lines


# --------------------------------------------------------------------- OpenAPI


def _openapi_type(d: dt.DType) -> dict[str, Any]:
    base = dt.unoptionalize(d)
    if base == dt.INT:
        return {"type": "integer"}
    if base == dt.FLOAT:
        return {"type": "number"}
    if base == dt.BOOL:
        return {"type": "boolean"}
    if base == dt.STR:
        return {"type": "string"}
    if base == dt.JSON:
        return {}  # any JSON value
    return {}


def openapi_spec(webserver: "PathwayWebserver") -> dict[str, Any]:
    """OpenAPI 3 document generated from the registered routes' Pathway
    schemas + ``documentation`` metadata (served at ``/_schema``)."""
    paths: dict[str, dict] = {}
    for route, methods, _handler, meta in webserver._routes:
        if meta is None:
            continue
        schema = meta.get("schema")
        doc = meta.get("documentation")
        props: dict[str, Any] = {}
        required: list[str] = []
        if schema is not None:
            for name, cdef in schema.columns().items():
                spec = _openapi_type(cdef.dtype)
                if cdef.has_default and cdef.default_value is not None:
                    spec = {**spec, "default": _jsonable(cdef.default_value)}
                props[name] = spec
                if not cdef.has_default and not isinstance(cdef.dtype, dt.Optional):
                    required.append(name)
        body_schema: dict[str, Any] = {"type": "object", "properties": props}
        if required:
            body_schema["required"] = required
        responses = {
            "200": {
                "description": "query answered as-of-now",
                "content": {"application/json": {"schema": {}}},
            },
            "400": {"description": "malformed payload or request_validator rejection"},
            "429": {
                "description": "admission shed (in-flight budget or ingest credit exhausted); retry after the Retry-After seconds",
            },
            "503": {"description": "engine shutting down; request not processed"},
            "504": {"description": "engine produced no answer within the request timeout"},
        }
        item: dict[str, Any] = {}
        for m in methods:
            op: dict[str, Any] = {
                "operationId": f"{m.lower()}_{route.strip('/').replace('/', '_') or 'root'}",
                "responses": responses,
            }
            if doc is not None:
                summary = getattr(doc, "summary", None) or (
                    doc.get("summary") if isinstance(doc, dict) else None
                )
                description = getattr(doc, "description", None) or (
                    doc.get("description") if isinstance(doc, dict) else None
                )
                tags = getattr(doc, "tags", None) or (
                    doc.get("tags") if isinstance(doc, dict) else None
                )
                if summary:
                    op["summary"] = summary
                if description:
                    op["description"] = description
                if tags:
                    op["tags"] = list(tags)
            if m.upper() == "GET":
                op["parameters"] = [
                    {
                        "name": name,
                        "in": "query",
                        "required": name in required,
                        "schema": spec,
                    }
                    for name, spec in props.items()
                ]
            else:
                op["requestBody"] = {
                    "required": bool(required),
                    "content": {"application/json": {"schema": body_schema}},
                }
            item[m.lower()] = op
        paths[route] = item
    return {
        "openapi": "3.0.3",
        "info": {"title": "pathway_tpu serving plane", "version": "1"},
        "paths": paths,
    }


# ------------------------------------------------------------------- webserver


class PathwayWebserver:
    """One HTTP server shared by many rest_connector routes (reference
    ``_server.py:329``), on the port's own HTTP/1.1 layer (``_wire.py``).
    ``stop()`` is synchronous and complete: it flushes pending request
    futures, shuts the server down on its loop (the listening socket closes,
    the requests being answered finish writing, every connection closes) and
    joins the thread — the port is free when it returns, so two back-to-back
    runs can bind the same address."""

    def __init__(self, host: str = "0.0.0.0", port: int = 8080, with_cors: bool = False):
        self.host = host
        self.port = port
        self.with_cors = with_cors
        _WEBSERVERS.add(self)
        #: (route, methods, handler, meta) — meta carries schema/documentation
        #: for OpenAPI generation and the serving state for lifecycle flushes
        self._routes: list[tuple[str, list[str], Any, dict | None]] = []
        self._started = threading.Event()
        self._loop: asyncio.AbstractEventLoop | None = None
        self._thread: threading.Thread | None = None
        self._server: _wire.HttpServer | None = None
        self._start_error: BaseException | None = None

    def _add_route(
        self, route: str, methods: list[str], handler: Any, meta: dict | None = None
    ) -> None:
        self._routes.append((route, methods, handler, meta))

    def _route_states(self) -> list[_RouteServing]:
        return [
            m["serving"]
            for _r, _m, _h, m in self._routes
            if m is not None and m.get("serving") is not None
        ]

    def _route_table(self) -> dict[str, dict[str, Any]]:
        """path → method → handler: the user routes, ``/_schema``, and
        ``/healthz`` / ``/readyz`` unless a user route takes the name."""
        table: dict[str, dict[str, Any]] = {}
        for route, methods, handler, _meta in self._routes:
            for m in methods:
                table.setdefault(route, {})[m.upper()] = handler

        async def schema_handler(_request: _wire.Request) -> _wire.Response:
            return _wire.json_response(openapi_spec(self))

        # every door serves liveness/readiness from the health plane's door
        # state machine (unconditional 200s when the plane is off) — the
        # contract a load balancer probes; user routes win a name collision
        async def healthz_handler(_request: _wire.Request) -> _wire.Response:
            from pathway_tpu_torch.observability import health as _health

            status, doc = _health.healthz_payload()
            return _wire.json_response(doc, status=status)

        async def readyz_handler(_request: _wire.Request) -> _wire.Response:
            from pathway_tpu_torch.observability import health as _health

            status, doc, headers = _health.readyz_payload()
            return _wire.json_response(doc, status=status, headers=headers or None)

        table.setdefault("/_schema", {}).setdefault("GET", schema_handler)
        for path, h in (("/healthz", healthz_handler), ("/readyz", readyz_handler)):
            if path not in table:
                table[path] = {"GET": h}
        return table

    def start(self) -> None:
        if self._thread is not None:
            return
        server = _wire.HttpServer(self._route_table())
        self._started.clear()
        self._start_error = None

        def serve() -> None:
            loop = asyncio.new_event_loop()
            asyncio.set_event_loop(loop)
            self._loop = loop
            try:
                loop.run_until_complete(server.start(self.host, self.port))
            except BaseException as e:  # bind failure -> surface in start()
                self._start_error = e
                self._started.set()
                loop.close()
                return
            self._server = server
            self._started.set()
            loop.run_forever()
            # stop() already awaited server.shutdown() on this loop
            loop.close()

        self._thread = threading.Thread(target=serve, daemon=True)
        self._thread.start()
        self._started.wait(timeout=10)
        if self._start_error is not None:
            err, self._start_error = self._start_error, None
            self._thread = None
            self._loop = None
            raise RuntimeError(
                f"PathwayWebserver failed to bind {self.host}:{self.port}: {err!r}"
            ) from err

    def stop(self) -> None:
        thread, loop = self._thread, self._loop
        if thread is None or loop is None:
            return
        # unblock waiting clients first: their handlers answer 503 while the
        # server is still accepting writes
        for rs in self._route_states():
            rs.flush_pending()
        server = self._server
        if server is not None:
            try:
                # graceful: waits for the requests being answered, closes the
                # listening socket — the port is released here, not at
                # thread death
                asyncio.run_coroutine_threadsafe(server.shutdown(), loop).result(timeout=15)
            except Exception:
                _log.exception("PathwayWebserver %s:%s: shutdown", self.host, self.port)
        try:
            loop.call_soon_threadsafe(loop.stop)
        except RuntimeError:
            pass
        thread.join(timeout=10)
        self._thread = None
        self._loop = None
        self._server = None
        self._started.clear()


class _RestDriver:
    """Connector driver: the server lives for the duration of the run."""

    virtual = False

    def __init__(self, webserver: PathwayWebserver, state: _RouteServing):
        self.webserver = webserver
        self.state = state

    def start(self) -> None:
        self.state.configure()
        self.webserver.start()

    def is_finished(self) -> bool:
        return False  # unbounded; stopped via runtime.request_stop()

    def stop(self) -> None:
        # flush BEFORE the server goes down so every pending client gets a
        # fast 503 through a still-open connection, then release the port
        self.state.flush_pending()
        self.webserver.stop()


# --------------------------------------------------------------- rest_connector


def _coerce(v: Any, d: dt.DType) -> Any:
    """GET query params arrive as strings; coerce to the schema dtype the
    POST/JSON path would have produced."""
    base = dt.unoptionalize(d)
    if v is None or not isinstance(v, str) or base == dt.STR:
        return v
    try:
        if base == dt.INT:
            return int(v)
        if base == dt.FLOAT:
            return float(v)
        if base == dt.BOOL:
            return v.strip().lower() not in ("", "0", "false", "no")
        if base == dt.JSON:
            return _json.loads(v)
    except (ValueError, TypeError):
        return v  # schema validation downstream reports it
    return v


def rest_connector(
    host: str = "0.0.0.0",
    port: int = 8080,
    *,
    webserver: PathwayWebserver | None = None,
    route: str = "/",
    schema: schema_mod.SchemaMetaclass | None = None,
    methods: tuple[str, ...] = ("POST",),
    autocommit_duration_ms: int | None = 20,
    keep_queries: bool = False,
    delete_completed_queries: bool | None = None,
    request_validator: Any = None,
    documentation: Any = None,
    rate_limit: float | None = None,
    api_keys: Any = None,
) -> tuple[Table, Any]:
    """Returns ``(queries_table, response_writer)``.

    ``delete_completed_queries`` / ``keep_queries``: once a query's response
    is served, its row is retracted from the queries table (so downstream
    state doesn't grow with request history) unless ``keep_queries=True``;
    an explicit ``delete_completed_queries`` wins over ``keep_queries``.

    ``rate_limit`` / ``api_keys`` override the ``PATHWAY_SERVE_RATE`` /
    ``PATHWAY_SERVE_API_KEYS`` front-door protection for THIS route
    (``rate_limit=0`` disables the bucket, ``api_keys=()`` disables auth);
    both apply at every door serving the route, fabric peers included.
    """
    ws = webserver or PathwayWebserver(host=host, port=port)
    if schema is None:
        schema = schema_mod.schema_from_types(query=str)
    columns = schema.column_names()
    np_dtypes = schema.np_dtypes()
    state = _RouteServing(route, methods, schema)
    state.delete_completed = (
        delete_completed_queries
        if delete_completed_queries is not None
        else not keep_queries
    )
    state.request_validator = request_validator
    if rate_limit is not None:
        state.rate_limit_override = float(rate_limit)
    if api_keys is not None:
        state.api_keys_override = tuple(api_keys)
    _ROUTES.add(state)

    def _shed_response(reason: str) -> _wire.Response:
        state.shed_total += 1
        _door_event(state, reason)
        status = 503 if reason == "shutting_down" else 429
        return _wire.json_response(
            {"error": "overloaded", "reason": reason},
            status=status,
            headers={"Retry-After": "1"},
        )

    async def handler(request: _wire.Request) -> _wire.Response:
        from pathway_tpu_torch.observability import health as _health

        hp = _health.current()
        if hp is not None and request.headers.get("X-Pathway-Canary"):
            # synthetic self-probe: answer from the door state machine and
            # return BEFORE any user-facing counter or engine work — canaries
            # must never show up as traffic
            status, doc = hp.canary_response(route)
            return _wire.json_response(doc, status=status)
        state.requests_total += 1
        gated = gate_check(state, request.headers)
        if gated is not None:
            status, body, hdrs = gated
            return _wire.json_response(body, status=status, headers=hdrs or None)
        shed = state.try_admit()
        if shed is not None:
            return _shed_response(shed)
        payload = await extract_payload(state, request)
        if request_validator is not None:
            try:
                request_validator(payload)
            except Exception as e:
                state.errors_total += 1
                return _wire.json_response({"error": str(e)}, status=400)
        values = build_row_values(state, payload)
        arrival_ns = _time_mod.time_ns()
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        loop = fut.get_loop()
        with state.lock:
            if state.closed:
                return _shed_response("shutting_down")
            if len(state.futures) >= state.max_inflight:
                # re-check under the registration lock: the arrival-time check
                # ran BEFORE the payload was parsed, and any number of
                # handlers can interleave there — the budget must bind where
                # the futures dict actually grows
                return _shed_response("max_inflight")
            key = mint_local_key(state)
            state.futures[key] = (fut, loop, arrival_ns, values)
        # request-scoped tracing: the admitted query row's engine key IS the
        # request id. Registration happens BEFORE the push makes the row
        # visible to the engine — a fast tick could otherwise resolve (and
        # try to complete) the request before begin() ran, leaking it in the
        # live table
        from pathway_tpu_torch.observability import requests as _req_trace

        rp = _req_trace.current()
        request_id = rp.begin(key, route, arrival_ns) if rp is not None else None
        rid_headers = (
            {"X-Pathway-Request-Id": request_id} if request_id is not None else None
        )
        fabric_headers = _zerohop_owner_headers()
        if fabric_headers is not None:
            rid_headers = {**(rid_headers or {}), **fabric_headers}
        if not state.push_admitted(key, values):
            with state.lock:
                state.futures.pop(key, None)
            if rp is not None:
                rp.drop(key)  # never reached the engine; no flight to trace
            return _shed_response("no_ingest_credit")
        state.schedule_tick()
        try:
            result = await asyncio.wait_for(fut, timeout=_REQUEST_TIMEOUT_S)
        except asyncio.CancelledError:
            # client disconnected: the connection cancels the handler task —
            # the one exit where neither the response side nor the timeout
            # branch runs, which would leak the in-flight slot and the query
            # row. Clean up like a timeout; futures.pop is the ownership
            # token (ent None = the response side won the race and owns the
            # retraction)
            with state.lock:
                ent = state.futures.pop(key, None)
            if ent is not None:
                if rp is not None:
                    rp.complete(key, "cancelled")
                if state.delete_completed and state.node is not None:
                    state.node._append_events([(key, values, -1)])
                    state.schedule_tick()
            raise
        except asyncio.TimeoutError:
            with state.lock:
                ent = state.futures.pop(key, None)
            state.timeouts_total += 1
            if rp is not None:
                # a timed-out request is exactly what tail sampling exists
                # for — its flight path is kept unconditionally
                rp.complete(key, "timeout")
            # ent None = the response side won the race and already owns the
            # retraction; retracting again would push an unpaired -1
            if ent is not None and state.delete_completed and state.node is not None:
                # nobody is waiting anymore: retract the query row so the
                # engine doesn't keep dead-request state forever (the normal
                # retraction happens at response time, which never came)
                state.node._append_events([(key, values, -1)])
                state.schedule_tick()
            return _wire.json_response({"error": "timeout"}, status=504, headers=rid_headers)
        if result is _SHUTDOWN:
            if rp is not None:
                rp.drop(key)  # no flight to decompose; the client got a 503
            return _wire.json_response(
                {"error": "engine shutting down"}, status=503, headers=rid_headers
            )
        return _wire.json_response(_jsonable(result), headers=rid_headers)

    ws._add_route(
        route,
        list(methods),
        handler,
        meta={"schema": schema, "documentation": documentation, "serving": state},
    )

    def factory() -> Node:
        from pathway_tpu_torch.internals.config import get_pathway_config

        node = ops.StreamInputNode(columns, np_dtypes)
        node.input_name = f"rest:{route}"
        if get_pathway_config().shardmap == "on":
            # zero-hop serving: every fabric door pushes into its own copy of
            # this node; keyed exchange keeps each request on its minting door
            node.fabric_ingest = True
        state.node = node
        return node

    def hook(node: Node, runtime: Any) -> None:
        if runtime is not None:
            state.runtime = runtime
            runtime.register_connector(_RestDriver(ws, state))

    lnode = LogicalNode(factory, [], name=f"rest:{route}", runtime_hook=hook)
    queries = Table(lnode, schema, Universe())

    def response_writer(result_table: Table) -> None:
        cols = result_table.column_names()
        collected: list[tuple[int, dict]] = []

        def on_change(key: int, row: dict, time: int, is_addition: bool) -> None:
            if is_addition:
                collected.append((int(key), row))

        def on_time_end(time: int) -> None:
            if not collected:
                return
            batch = collected[:]
            collected.clear()
            now_ns = _time_mod.time_ns()
            resolved: list[tuple[tuple, int, dict]] = []
            with state.lock:
                for key, row in batch:
                    ent = state.futures.pop(key, None)
                    if ent is not None:
                        resolved.append((ent, key, row))
                state.arrivals_since_wake = 0
            if not resolved:
                return
            # one vectorized resolution pass per event loop, not a
            # call_soon_threadsafe per row
            by_loop: dict[Any, list] = {}
            oldest_ns = now_ns
            retracts: list[tuple[int, tuple, int]] = []
            for (fut, loop, arrival_ns, values), key, row in resolved:
                value = (
                    row["result"] if "result" in row and len(cols) <= 2 else row
                )
                by_loop.setdefault(loop, []).append((fut, value))
                state.latency.observe((now_ns - arrival_ns) / 1e9)
                oldest_ns = min(oldest_ns, arrival_ns)
                if state.delete_completed:
                    retracts.append((key, values, -1))
            for loop, items in by_loop.items():
                try:
                    loop.call_soon_threadsafe(_set_results, items)
                except RuntimeError:
                    pass  # server stopping; flush_pending owns these clients
            state.responses_total += len(resolved)
            state.batches_total += 1
            state.batched_rows_total += len(resolved)
            from pathway_tpu_torch import observability as _obs
            from pathway_tpu_torch.observability import requests as _req_trace

            rp = _req_trace.current()
            if rp is not None:
                # completion runs the tail-based keep decision per request;
                # the respond span covers this resolution pass
                done_ns = _time_mod.time_ns()
                for _ent, key, _row in resolved:
                    rp.complete(key, "ok", now_ns, done_ns)
            tracer = _obs.current()
            if tracer is not None:
                tracer.span(
                    "serve/respond",
                    oldest_ns,
                    now_ns,
                    {
                        "pathway.route": route,
                        "pathway.responses": len(resolved),
                        "pathway.tick": time,
                    },
                )
            if retracts and state.node is not None:
                # retract served query rows (delete_completed_queries): the
                # server's own bookkeeping, bounded by the in-flight budget,
                # pushed from the engine thread; the rows drain on the next
                # tick
                state.node._append_events(retracts)

        from pathway_tpu_torch.internals.config import get_pathway_config
        from pathway_tpu_torch.io._subscribe import subscribe

        # zero-hop serving: each response row goes to the door that minted its
        # key (the shard map places the key on that door's process)
        route_by = (lambda batch: batch.keys) if get_pathway_config().shardmap == "on" else None
        subscribe(result_table, on_change, on_time_end=on_time_end, route_by=route_by)

    return queries, response_writer


def response_writer(*args: Any, **kwargs: Any) -> None:
    raise RuntimeError("use the response_writer returned by rest_connector")
