"""Request-scoped tracing: end-to-end query flight paths with tail sampling.

The span plane (``spans.py``) head-samples TICKS by a deterministic tick
hash — a slow or failed query is *less* likely to be captured than a fast one,
and nothing in the system answers "why was THIS query slow?". This module is
the Dapper-style request plane the serving tier needs:

- the REST front door (``io/http/_server.py``) mints a ``request_id`` per
  admitted request (the hex of the query row's engine key — the id literally
  IS the handle the dataflow routes by, so it crosses the cluster wire for
  free) and registers the in-flight request here;
- while any request is in flight, the engine loops append **stage events**
  (per-chain sweep time, per-node sweep time, microbatch launches with pad
  share and cold-compile attribution, index searches) to a bounded per-tick
  ring — one ``hot`` flag read per step when idle, one tuple append per step
  that did work;
- on a cluster, peers ship their stage events to the coordinator piggybacked
  on the barrier rounds the tick already pays (and learn the live-request
  table the same way), so one request's flight path stitches across
  processes with zero extra sockets;
- on completion the trace is decided **tail-based**: kept iff the request was
  slow (``PATHWAY_REQUEST_TRACE_SLOW_MS``), errored/timed out, or falls in a
  small deterministic always-keep hash slice
  (``PATHWAY_REQUEST_TRACE_KEEP``). Kept traces materialize as OTLP spans
  under a per-request trace id (derived from the request id, so every
  process would derive the same), flushed to the span buffer/file sink
  when ``PATHWAY_TRACE`` is on, and queryable via the monitoring server's
  ``/request?id=`` endpoint (the reference's ``trace`` CLI is not ported).

Overhead discipline: ``PATHWAY_REQUEST_TRACE=off`` installs **no plane at
all** — every call site guards on a single ``is None`` test and zero rings
are allocated. With the plane on but no request in flight, engine loops pay
one attribute read per step. All OTLP materialization happens at keep time,
never on the tick path.

Carried from ``pathway_tpu/observability/requests.py`` with imports rewritten.
The port runs one process, so the reference's cluster side (peers' stage
events riding the barrier rounds to the coordinator, ``wire_*``) is left
out.
"""

from __future__ import annotations

import hashlib
import threading
import time as _time
from collections import OrderedDict
from typing import Any

#: per-request bounded boundary-event list (admission/coalesce/respond plus
#: shed/timeout markers) — requests cannot grow unbounded state
_REQ_EVENTS_MAX = 32

#: per-tick engine stage-event cap and tick-window ring length: one request's
#: flight window is reconstructed from these, so they bound both memory and
#: the per-completion scan
_TICK_EVENTS_MAX = 128
_TICK_RING = 256

#: slowest-request exemplars surfaced on /status's serving section
_SLOWEST_MAX = 8


def derive_request_trace_id(request_id: str) -> str:
    """Deterministic 16-byte OTLP trace id for one request — any process
    holding the request id derives the same, so spans stitch without
    coordination."""
    return hashlib.sha256(("pathway-request:" + request_id).encode()).hexdigest()[:32]


def _span_id(request_id: str, i: int) -> str:
    return hashlib.sha256(f"pathway-request-span:{request_id}:{i}".encode()).hexdigest()[:16]


def keep_hash_sampled(request_id: str, frac: float) -> bool:
    """Deterministic always-keep slice membership for a request id."""
    if frac >= 1.0:
        return True
    if frac <= 0.0:
        return False
    h = int(hashlib.sha256(("pathway-keep:" + request_id).encode()).hexdigest()[:13], 16)
    return h / float(1 << 52) < frac


class _Req:
    """One in-flight request's bounded flight-path state."""

    __slots__ = (
        "key",
        "request_id",
        "route",
        "arrival_ns",
        "push_ns",
        "first_tick",
        "first_tick_ns",
        "events",
    )

    def __init__(self, key: int, request_id: str, route: str, arrival_ns: int):
        self.key = key
        self.request_id = request_id
        self.route = route
        self.arrival_ns = arrival_ns
        self.push_ns = _time.time_ns()
        self.first_tick: int | None = None
        self.first_tick_ns: int | None = None
        #: boundary events: (stage, t0_ns, t1_ns, attrs | None)
        self.events: list[tuple] = [
            ("serve/admission", arrival_ns, self.push_ns, None)
        ]


class RequestTracePlane:
    """Per-run request tracing state (one per process).

    Hot-path contract: ``note_stage``/``note_tick`` are called only behind
    the caller's ``hot`` check (``plane.hot`` is a plain attribute — one
    read). Everything else runs on serving/monitoring threads.
    """

    def __init__(self, cfg) -> None:
        from pathway_tpu_torch.observability.metrics import Histogram

        self.process_id = cfg.process_id
        self.slow_ms = cfg.request_trace_slow_ms
        self.keep_frac = cfg.request_trace_keep
        self.kept_cap = cfg.request_trace_kept
        self._lock = threading.Lock()
        #: engine row key -> _Req (front-door side: the process whose REST
        #: route admitted the request — requests complete where they began)
        self.live: dict[int, _Req] = {}
        #: ONE attribute read per engine step when idle
        self.hot: bool = False
        #: tick -> [(stage, t0_ns, t1_ns, process_id, attrs | None)]; guarded
        #: by ``_ring_lock`` (sharded workers append concurrently, and a
        #: timeout completion may scan from an aiohttp thread mid-tick)
        self._ring_lock = threading.Lock()
        self._tick_events: "OrderedDict[int, list]" = OrderedDict()
        self._cur_tick: int | None = None
        #: kept traces, request_id -> trace doc (bounded, oldest first)
        self.kept: "OrderedDict[str, dict]" = OrderedDict()
        self.slowest: list[dict] = []
        self.stage_hist: dict[str, Histogram] = {}
        self._hist_cls = Histogram
        self.completed_total = 0
        self.kept_total = 0
        self.shed_total = 0
        self.status_totals: dict[str, int] = {}

    # ------------------------------------------------------------- front door
    def begin(self, key: int, route: str, arrival_ns: int) -> str:
        """Register one admitted request; returns its request id (the hex of
        the query row's engine key)."""
        request_id = f"{key & ((1 << 64) - 1):016x}"
        rec = _Req(int(key), request_id, route, arrival_ns)
        with self._lock:
            self.live[int(key)] = rec
            self.hot = True
        return request_id

    def note_shed(self, route: str, reason: str) -> None:
        """A request shed at the door never flew — counted, not traced."""
        with self._lock:
            self.shed_total += 1

    def note_boundary(
        self,
        key: int,
        stage: str,
        t0_ns: int,
        t1_ns: int,
        attrs: dict | None = None,
    ) -> None:
        """Attach one serving-side boundary event to an in-flight request
        (fabric ingress doors record their forward round-trip here — the
        owner's engine decomposition arrives under the same derived trace id
        from the owner's completion)."""
        with self._lock:
            rec = self.live.get(int(key))
            if rec is not None and len(rec.events) < _REQ_EVENTS_MAX:
                rec.events.append((stage, t0_ns, t1_ns, attrs))

    def drop(self, key: int) -> None:
        """Forget a request without completing it (engine shutdown flush —
        the client got a 503; there is no flight to decompose)."""
        with self._lock:
            self.live.pop(int(key), None)
            if not self.live:
                self.hot = False

    # ------------------------------------------------------------ engine side
    def note_tick(self, tick: int) -> None:
        """Engine tick start (called behind the ``hot`` check, engine thread
        only): stamps the tick-start wall clock and resolves which tick first
        drained each just-pushed request (its coalesce boundary)."""
        now = _time.time_ns()
        self._cur_tick = tick
        if self.live:
            with self._lock:
                for rec in self.live.values():
                    if rec.first_tick is None and rec.push_ns <= now:
                        rec.first_tick = tick
                        rec.first_tick_ns = now

    def note_stage(
        self,
        tick: int | None,
        stage: str,
        t0_ns: int,
        t1_ns: int,
        rows: int = 0,
        attrs: dict | None = None,
    ) -> None:
        """One engine stage execution (chain sweep, node sweep, microbatch
        launch, index search). ``tick=None`` uses the current engine tick
        (callers without the tick in hand, e.g. the microbatch dispatcher)."""
        if tick is None:
            tick = self._cur_tick
            if tick is None:
                return
        if rows and attrs is None:
            attrs = {"rows": rows}
        elif rows:
            attrs = dict(attrs, rows=rows)
        ev = (stage, t0_ns, t1_ns, self.process_id, attrs)
        with self._ring_lock:
            evs = self._tick_events.get(tick)
            if evs is None:
                evs = self._tick_events.setdefault(tick, [])
                while len(self._tick_events) > _TICK_RING:
                    self._tick_events.popitem(last=False)
            if len(evs) < _TICK_EVENTS_MAX:
                evs.append(ev)

    # -------------------------------------------------------------- completion
    def complete(
        self,
        key: int,
        status: str,
        resolve_t0_ns: int | None = None,
        resolve_t1_ns: int | None = None,
    ) -> dict | None:
        """Request finished (answered / timed out / errored): compute its
        stage decomposition, feed the stage histograms, and apply the
        tail-based keep decision. Returns the kept trace doc, or None."""
        with self._lock:
            rec = self.live.pop(int(key), None)
            if not self.live:
                self.hot = False
        if rec is None:
            return None
        now = resolve_t1_ns if resolve_t1_ns is not None else _time.time_ns()
        if resolve_t0_ns is not None and len(rec.events) < _REQ_EVENTS_MAX:
            rec.events.append(("serve/respond", resolve_t0_ns, now, None))
        duration_ms = (now - rec.arrival_ns) / 1e6
        decomp, engine_events = self._decompose(rec, now)
        keep = (
            status != "ok"
            or (duration_ms >= self.slow_ms)
            or keep_hash_sampled(rec.request_id, self.keep_frac)
        )
        exemplar = {
            "request_id": rec.request_id,
            "route": rec.route,
            "status": status,
            "duration_ms": round(duration_ms, 3),
            "decomposition_ms": {k: round(v, 3) for k, v in decomp.items()},
        }
        # counters, histograms and the exemplar list mutate under the lock:
        # completions arrive from every webserver event loop plus timeout
        # paths, and list.sort with a python key callback is not atomic
        with self._lock:
            self.completed_total += 1
            self.status_totals[status] = self.status_totals.get(status, 0) + 1
            hist = self.stage_hist
            for stage, ms in decomp.items():
                h = hist.get(stage)
                if h is None:
                    h = hist.setdefault(stage, self._hist_cls())
                h.observe(ms / 1e3)
            slow = self.slowest
            slow.append(exemplar)
            slow.sort(key=lambda e: -e["duration_ms"])
            del slow[_SLOWEST_MAX:]
        if not keep:
            return None
        doc = self._materialize(rec, status, duration_ms, decomp, engine_events, now)
        with self._lock:
            self.kept[rec.request_id] = doc
            while len(self.kept) > self.kept_cap:
                self.kept.popitem(last=False)
            self.kept_total += 1
        self._flush_otlp(doc)
        return doc

    def _decompose(self, rec: _Req, now_ns: int) -> tuple[dict[str, float], list]:
        """(stage -> total ms, engine events in the request's tick window).
        Engine attribution is tick-scoped: a request shares its coalesced
        tick's stage events with the requests it coalesced with — the honest
        granularity, since they rode the same launches."""
        decomp: dict[str, float] = {}
        for stage, t0, t1, _attrs in rec.events:
            decomp[stage] = decomp.get(stage, 0.0) + (t1 - t0) / 1e6
        first_tick = rec.first_tick
        if rec.first_tick_ns is not None:
            decomp["serve/coalesce"] = (
                decomp.get("serve/coalesce", 0.0)
                + max(0, rec.first_tick_ns - rec.push_ns) / 1e6
            )
        engine_events: list[tuple] = []
        window: list[tuple] = []
        with self._ring_lock:
            for tick, evs in self._tick_events.items():
                if first_tick is not None and tick >= first_tick:
                    window.append((tick, list(evs)))
                else:
                    # ticks before first_tick (or all ticks when no tick
                    # boundary was observed after the push) are TIME-scoped:
                    # a request admitted mid-tick T can be drained and swept
                    # during T yet only resolve in T+1 — first_tick lands on
                    # T+1, but T's engine stages that started after the push
                    # belong to this flight (the stage that drained the row
                    # necessarily started after it was pushed)
                    sel = [ev for ev in evs if ev[1] >= rec.push_ns]
                    if sel:
                        window.append((tick, sel))
        for tick, evs in window:
            for ev in evs:
                stage, t0, t1, _pid, _attrs = ev
                if t1 > now_ns:
                    continue  # after this request resolved — not its flight
                decomp[stage] = decomp.get(stage, 0.0) + (t1 - t0) / 1e6
                engine_events.append((tick, ev))
        return decomp, engine_events

    def _materialize(
        self,
        rec: _Req,
        status: str,
        duration_ms: float,
        decomp: dict[str, float],
        engine_events: list,
        now_ns: int,
    ) -> dict:
        trace_id = derive_request_trace_id(rec.request_id)
        root_id = _span_id(rec.request_id, 0)
        spans: list[tuple] = [
            (
                "request",
                root_id,
                None,
                rec.arrival_ns,
                now_ns,
                {
                    "pathway.request_id": rec.request_id,
                    "pathway.route": rec.route,
                    "pathway.status": status,
                    "pathway.process_id": self.process_id,
                },
            )
        ]
        i = 1
        for stage, t0, t1, attrs in rec.events:
            a = {"pathway.process_id": self.process_id}
            if attrs:
                a.update(attrs)
            spans.append((stage, _span_id(rec.request_id, i), root_id, t0, t1, a))
            i += 1
        if rec.first_tick_ns is not None and rec.first_tick_ns > rec.push_ns:
            spans.append(
                (
                    "serve/coalesce",
                    _span_id(rec.request_id, i),
                    root_id,
                    rec.push_ns,
                    rec.first_tick_ns,
                    {
                        "pathway.process_id": self.process_id,
                        "pathway.tick": rec.first_tick,
                    },
                )
            )
            i += 1
        for tick, (stage, t0, t1, pid, attrs) in engine_events:
            a = {"pathway.tick": tick, "pathway.process_id": pid}
            if attrs:
                a.update({f"pathway.{k}": v for k, v in attrs.items()})
            spans.append((stage, _span_id(rec.request_id, i), root_id, t0, t1, a))
            i += 1
        return {
            "request_id": rec.request_id,
            "trace_id": trace_id,
            "route": rec.route,
            "status": status,
            "arrival_unix_ns": rec.arrival_ns,
            "duration_ms": round(duration_ms, 3),
            "first_tick": rec.first_tick,
            "decomposition_ms": {k: round(v, 3) for k, v in decomp.items()},
            "spans": [
                {
                    "traceId": trace_id,
                    "spanId": sid,
                    **({"parentSpanId": pid_} if pid_ is not None else {}),
                    "name": name,
                    "kind": 1,
                    "startTimeUnixNano": str(t0),
                    "endTimeUnixNano": str(t1),
                    "attributes": [
                        _box_attr(k, v) for k, v in (attrs or {}).items()
                    ],
                }
                for name, sid, pid_, t0, t1, attrs in spans
            ],
            "_records": spans,
        }

    def _flush_otlp(self, doc: dict) -> None:
        """Append the kept trace's spans to the span buffer (ring +
        rotating OTLP-JSON file sink) under the per-request trace id, so a
        collector tailing the live file sees request traces stitched next to
        the head-sampled tick spans."""
        from pathway_tpu_torch import observability as _obs

        tracer = _obs.current()
        if tracer is None:
            return
        tid = doc["trace_id"]
        for name, sid, parent, t0, t1, attrs in doc["_records"]:
            tracer.buffer.append((name, sid, parent, t0, t1, attrs, tid))

    # ---------------------------------------------------------------- reading
    def get_trace(self, request_id: str) -> dict:
        with self._lock:
            doc = self.kept.get(request_id)
            if doc is not None:
                out = {k: v for k, v in doc.items() if k != "_records"}
                return {"ok": True, "kept": True, **out}
            rec = None
            for r in self.live.values():
                if r.request_id == request_id:
                    rec = r
                    break
        if rec is not None:
            return {
                "ok": True,
                "kept": False,
                "in_flight": True,
                "request_id": request_id,
                "route": rec.route,
                "elapsed_ms": round((_time.time_ns() - rec.arrival_ns) / 1e6, 3),
                "stage": self._stage_reached(rec),
            }
        with self._lock:
            known = list(self.kept)[-32:]
        return {"ok": False, "error": f"unknown request {request_id!r}", "kept_ids": known}

    def _stage_reached(self, rec: _Req) -> str:
        """Last engine stage observed in the request's tick window — the
        post-mortem 'how far did it get' field (computed at read time, never
        on the tick path)."""
        last = rec.events[-1][0] if rec.events else "admitted"
        ft = rec.first_tick
        if ft is None:
            return last
        with self._ring_lock:
            for tick, evs in self._tick_events.items():
                if tick < ft:
                    continue
                if evs:
                    last = evs[-1][0]
        return last

    def inflight_table(self) -> list[dict]:
        """The in-flight request table for flight-recorder dumps: which user
        queries were mid-flight (and how far they got) when the process
        died."""
        now = _time.time_ns()
        with self._lock:
            recs = list(self.live.values())
        return [
            {
                "request_id": r.request_id,
                "route": r.route,
                "stage": self._stage_reached(r),
                "elapsed_ms": round((now - r.arrival_ns) / 1e6, 3),
                "first_tick": r.first_tick,
            }
            for r in recs
        ]

    def slowest_exemplars(self) -> list[dict]:
        with self._lock:
            return list(self.slowest)

    def kept_ids(self) -> list[str]:
        with self._lock:
            return list(self.kept)

    def status_summary(self) -> dict[str, Any]:
        with self._lock:
            in_flight = len(self.live)
            kept = len(self.kept)
        return {
            "enabled": True,
            "in_flight": in_flight,
            "completed_total": self.completed_total,
            "kept_total": self.kept_total,
            "kept_buffered": kept,
            "shed_total": self.shed_total,
            "by_status": dict(self.status_totals),
            "slow_ms": self.slow_ms,
            "keep_frac": self.keep_frac,
        }

    def stage_snapshot(self) -> dict[str, dict]:
        """Per-stage latency summaries (seconds) — the BENCH json's p99 stage
        decomposition."""
        H = self._hist_cls
        out = {}
        for stage, h in sorted(self.stage_hist.items()):
            snap = h.snapshot()

            def _q(q):
                v = H.quantile(snap, q)
                return None if v is None or v == float("inf") else v

            out[stage] = {
                "count": snap["count"],
                "sum_s": round(snap["sum_s"], 6),
                "p50_s": _q(0.5),
                "p99_s": _q(0.99),
            }
        return out

    def prometheus_lines(self) -> list[str]:
        from pathway_tpu_torch.internals.monitoring import escape_label_value
        from pathway_tpu_torch.observability.metrics import BUCKET_BOUNDS_S

        lines = [
            "# HELP pathway_requests_completed_total Requests completed by the request-trace plane",
            "# TYPE pathway_requests_completed_total counter",
            f"pathway_requests_completed_total {self.completed_total}",
            "# HELP pathway_request_traces_kept_total Request traces kept by tail sampling",
            "# TYPE pathway_request_traces_kept_total counter",
            f"pathway_request_traces_kept_total {self.kept_total}",
            "# HELP pathway_request_stage_seconds Per-request stage latency decomposition",
            "# TYPE pathway_request_stage_seconds histogram",
        ]
        for stage, h in sorted(self.stage_hist.items()):
            label = f'stage="{escape_label_value(stage)}"'
            snap = h.snapshot()
            cum = 0
            for bound, c in zip(BUCKET_BOUNDS_S, snap["counts"]):
                cum += c
                lines.append(
                    f'pathway_request_stage_seconds_bucket{{{label},le="{bound!r}"}} {cum}'
                )
            cum += snap["counts"][-1]
            lines.append(
                f'pathway_request_stage_seconds_bucket{{{label},le="+Inf"}} {cum}'
            )
            lines.append(
                f"pathway_request_stage_seconds_sum{{{label}}} {snap['sum_s']}"
            )
            lines.append(
                f"pathway_request_stage_seconds_count{{{label}}} {snap['count']}"
            )
        return lines


def _box_attr(key: str, value: Any) -> dict:
    if value is True or value is False:
        v: dict = {"boolValue": value}
    elif isinstance(value, int):
        v = {"intValue": str(value)}
    elif isinstance(value, float):
        v = {"doubleValue": value}
    else:
        v = {"stringValue": str(value)}
    return {"key": key, "value": v}


# --------------------------------------------------------------- run lifecycle

_plane: RequestTracePlane | None = None
#: the previous run's plane, readable after shutdown (benches/tests inspect
#: stage decompositions once the run has torn down)
_last: RequestTracePlane | None = None


def current() -> RequestTracePlane | None:
    """The installed request-trace plane, or None when off — the one global
    read every hot call site guards on."""
    return _plane


def last() -> RequestTracePlane | None:
    return _last


def install_from_env(runtime=None) -> RequestTracePlane | None:
    global _plane
    from pathway_tpu_torch.internals.config import get_pathway_config

    cfg = get_pathway_config()
    if cfg.request_trace == "off":
        _plane = None
        return None
    _plane = RequestTracePlane(cfg)
    return _plane


def shutdown() -> None:
    global _plane, _last
    if _plane is not None:
        _last = _plane
    _plane = None
