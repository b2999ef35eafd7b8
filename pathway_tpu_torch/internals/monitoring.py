"""Monitoring: per-operator stats, console dashboard, HTTP/Prometheus endpoint.

Role of the reference's monitoring stack (``internals/monitoring.py:22-271``
dashboard + ``src/engine/http_server.rs:25-77`` metrics server): engine nodes
already count rows in/out and processing time; this module aggregates them into

- a console summary (``monitoring_level`` AUTO/IN_OUT/ALL — AUTO prints only on
  a TTY, NONE is silent),
- ``/status`` (JSON) and ``/metrics`` (Prometheus text exposition) served by a
  daemon-thread HTTP server while the run is live (``with_http_server=True``;
  port from ``PATHWAY_MONITORING_HTTP_PORT``, default 20000).

Carried from ``pathway_tpu/internals/monitoring.py`` with imports rewritten.
The sections of planes the port has not carried yet (delivery, cluster
aggregation, elastic, fabric, the embedding memo) are absent from
``/status`` and ``/metrics``, as in a reference run with those planes off;
``/scale`` answers 501 with the ``later slice`` message.
"""

from __future__ import annotations

import json
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any


def scheduler_stats(scheduler) -> list[dict[str, Any]]:
    """Per-operator counters from a live or finished scheduler. Sharded and
    cluster runtimes expose per-worker graphs; their counters aggregate by
    node position."""
    from pathway_tpu_torch.observability.metrics import iter_graphs

    graphs = iter_graphs(scheduler)
    agg: dict[int, dict[str, Any]] = {}
    for g in graphs:
        for node in g.nodes:
            o = agg.get(node.node_index)
            if o is None:
                agg[node.node_index] = o = {
                    "id": node.node_index,
                    "operator": node.name,
                    "rows_in": 0,
                    "rows_out": 0,
                    "time_ms": 0.0,
                    "latency_ms": 0.0,
                    "last_time": -1,
                }
            o["rows_in"] += node.stats_rows_in
            o["rows_out"] += node.stats_rows_out
            o["time_ms"] = round(o["time_ms"] + node.stats_time_ns / 1e6, 3)
            # worker shards: worst (max) queue latency, most advanced tick
            o["latency_ms"] = round(
                max(o["latency_ms"], node.stats_latency_ewma_ms), 3
            )
            o["last_time"] = max(o["last_time"], node.stats_last_time)
    ops = [agg[i] for i in sorted(agg)]
    # lag (reference OperatorStats.lag): logical ticks behind the
    # most-advanced operator; operators that never saw data report no lag
    frontier = max((o["last_time"] for o in ops), default=-1)
    for o in ops:
        o["lag"] = (frontier - o["last_time"]) if o["last_time"] >= 0 else None
    return ops


#: operators shown at the in_out/auto levels: sources, sinks, and writers
_EDGE_OPERATORS = {"stream_input", "static_input", "subscribe", "capture", "output"}


def _visible_operators(ops: list[dict], level: str) -> list[dict]:
    """The operator rows a given monitoring level displays — shared by the
    live dashboard and the end-of-run summary so the two can never drift."""
    if level in ("in_out", "auto"):
        shown = [
            o
            for o in ops
            if o["operator"] in _EDGE_OPERATORS
            or o["operator"].split(":")[0].endswith("_write")
        ]
        return shown or ops
    return ops


def run_stats(runtime) -> dict[str, Any]:
    from pathway_tpu_torch import observability as _obs
    from pathway_tpu_torch.internals.telemetry import resilience_summary
    from pathway_tpu_torch.observability.metrics import Histogram

    scheduler = getattr(runtime, "scheduler", None)
    ops = scheduler_stats(scheduler)
    def _q(snap, q):
        v = Histogram.quantile(snap, q)
        # the +Inf overflow bucket has no finite upper bound — keep /status
        # strict JSON (no Infinity literal)
        return None if v is None or v == float("inf") else v

    sink_lat = {}
    for label, snap in _obs.run_metrics().sink_snapshots().items():
        sink_lat[label] = {
            "count": snap["count"],
            "sum_s": round(snap["sum_s"], 6),
            "p50_s": _q(snap, 0.5),
            "p99_s": _q(snap, 0.99),
        }
    stats = {
        "alive": True,
        "current_time": getattr(scheduler, "current_time", None),
        "operators": ops,
        "rows_in_total": sum(o["rows_in"] for o in ops),
        "rows_out_total": sum(o["rows_out"] for o in ops),
        # live observability plane: per-input watermarks, queue/microbatch
        # backlogs, per-sink end-to-end latency summaries
        "watermarks": _obs.input_watermarks(scheduler),
        "backlogs": _obs.backlog_gauges(scheduler),
        "sink_latency": sink_lat,
        # recovery observability: heartbeat misses, committed checkpoint
        # epochs, replayed events and supervised restarts, from the same
        # event log the OTLP exports consume (``internals/telemetry.py``)
        "resilience": resilience_summary(),
    }
    # flow-control plane (PATHWAY_FLOW=on): per-input credit/occupancy/shed
    # counters and the AIMD controller's recent decisions — shedding is only
    # acceptable because every drop is visible here
    from pathway_tpu_torch import flow as _flow

    flow_status = _flow.status(runtime)
    if flow_status is not None:
        stats["flow"] = flow_status
    # device profiling plane: per-callable compile/shape telemetry, pad-waste
    # ratios, memory attribution, host/device time split, recompile-storm
    # warnings (PATHWAY_PROFILE, on by default)
    stats["device"] = _obs.device.status_summary(runtime)
    # data-plane audit (PATHWAY_AUDIT, on by default): invariant violations,
    # shadow-audit divergences, per-operator-edge cardinality/selectivity,
    # lineage ring occupancy
    aud = _obs.audit.current()
    stats["audit"] = (
        aud.status_summary(runtime)
        if aud is not None
        else {"enabled": False, "mode": "off"}
    )
    # tiered-index plane: hot/cold residency, exact hot-hit ratio and
    # promotion/demotion counters (present only while a tiered index lives)
    ts = _obs.device.index_tier_stats()
    if ts is not None:
        stats["index"] = ts
    # REST serving plane: per-route request/response/shed counters, in-flight
    # occupancy vs budget, coalesced batch sizes and arrival-to-response
    # latency quantiles (present only while rest_connector routes are live)
    from pathway_tpu_torch.io.http import _server as _rest_serve

    serving = _rest_serve.serving_status(runtime)
    if serving is not None:
        stats["serving"] = serving
    # request-scoped tracing plane: tail-sampling counters + the slowest-
    # request exemplars (id + per-stage latency decomposition) — the serving
    # section's "which queries are slow and where" answer
    rp = _obs.requests.current()
    if rp is not None:
        stats["request_trace"] = rp.status_summary()
        if serving is not None:
            stats["serving"]["slowest"] = rp.slowest_exemplars()
    # live error log: per-operator row-level failure counts (UDF raises under
    # terminate_on_error=False — previously only visible via pw.global_error_log())
    from pathway_tpu_torch.internals import error_log as _error_log

    stats["errors"] = _error_log.summary()
    tracer = _obs.current()
    if tracer is not None:
        stats["trace"] = {
            "trace_id": tracer.trace_id,
            "sample": tracer.sample,
            "spans": tracer.buffer._seq,
        }
    server = getattr(runtime, "monitoring_server", None)
    if server is not None:
        stats["monitoring"] = {"host": server.host, "port": server.port}
    # pod health & SLO plane (PATHWAY_HEALTH): door state machine, canary
    # probes, burn rates and the active-alert set
    from pathway_tpu_torch.observability import health as _health

    health = _health.status(runtime)
    if health is not None:
        stats["health"] = health
    # pod timeline plane (PATHWAY_TIMELINE): ring occupancy + the ranked
    # bottleneck verdict (the series themselves are served by /timeline)
    from pathway_tpu_torch.observability import bottleneck as _bottleneck
    from pathway_tpu_torch.observability import timeline as _timeline

    tplane = _timeline.current()
    if tplane is not None:
        stats["timeline"] = tplane.status_summary()
        verdict = _bottleneck.status(runtime)
        if verdict is not None:
            stats["bottleneck"] = verdict
    return stats


def escape_label_value(value: Any) -> str:
    r"""Prometheus exposition label-value escaping: ``\`` → ``\\``, ``"`` →
    ``\"``, newline → ``\n`` (the spec's exhaustive list). Operator names come
    from user pipelines (UDF/table names ride along), so they can contain any
    of the three."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _fmt_label(**labels: Any) -> str:
    return ",".join(f'{k}="{escape_label_value(v)}"' for k, v in labels.items())


def prometheus_text(runtime) -> str:
    """Prometheus exposition format (``http_server.rs`` metric names adapted),
    extended with the live plane: per-input watermarks, backlog gauges and
    per-sink end-to-end latency histograms (fixed log-2 buckets)."""
    from pathway_tpu_torch import observability as _obs
    from pathway_tpu_torch.observability.metrics import BUCKET_BOUNDS_S

    stats = run_stats(runtime)
    metrics = [
        ("pathway_operator_rows_in_total", "Rows consumed by an operator", "rows_in", "counter"),
        ("pathway_operator_rows_out_total", "Rows emitted by an operator", "rows_out", "counter"),
        ("pathway_operator_time_ms", "Time spent inside an operator", "time_ms", "counter"),
        ("pathway_operator_latency_ms", "Input queue latency (EWMA) of an operator", "latency_ms", "gauge"),
        ("pathway_operator_lag", "Logical ticks behind the most-advanced operator", "lag", "gauge"),
    ]
    labels = [
        _fmt_label(operator=o["operator"], id=o["id"]) for o in stats["operators"]
    ]
    lines = []
    for name, help_text, field, mtype in metrics:
        lines.append(f"# HELP {name} {help_text}")
        lines.append(f"# TYPE {name} {mtype}")
        for o, label in zip(stats["operators"], labels):
            if o[field] is None:
                continue
            lines.append(f"{name}{{{label}}} {o[field]}")
    # ---- watermarks + ingest counters per input connector -------------------
    wms = stats["watermarks"]
    if wms:
        lines.append("# HELP pathway_input_watermark_unix_seconds Event-time (or ingest-time) watermark of an input connector")
        lines.append("# TYPE pathway_input_watermark_unix_seconds gauge")
        for w in wms:
            if w["watermark"] is not None:
                lines.append(
                    f'pathway_input_watermark_unix_seconds{{{_fmt_label(input=w["input"])}}} {w["watermark"]}'
                )
        lines.append("# HELP pathway_input_watermark_lag_seconds Now minus the input watermark")
        lines.append("# TYPE pathway_input_watermark_lag_seconds gauge")
        for w in wms:
            if w["lag_s"] is not None:
                lines.append(
                    f'pathway_input_watermark_lag_seconds{{{_fmt_label(input=w["input"])}}} {w["lag_s"]}'
                )
        lines.append("# HELP pathway_input_rows_ingested_total Rows ingested by an input connector")
        lines.append("# TYPE pathway_input_rows_ingested_total counter")
        for w in wms:
            lines.append(
                f'pathway_input_rows_ingested_total{{{_fmt_label(input=w["input"])}}} {w["rows_ingested"]}'
            )
    # ---- backlog gauges (connector queues + cross-tick microbatch buffers) --
    backlogs = stats["backlogs"]
    if backlogs:
        lines.append("# HELP pathway_backlog_rows Rows buffered in a connector queue or microbatch buffer")
        lines.append("# TYPE pathway_backlog_rows gauge")
        for b in backlogs:
            lines.append(
                f'pathway_backlog_rows{{{_fmt_label(queue=b["queue"])}}} {b["rows"]}'
            )
    # ---- flow-control plane (credits, sheds, controller) --------------------
    flow = stats.get("flow")
    if flow:
        lines.append("# HELP pathway_flow_queued_rows Rows holding credit in a connector ingest queue")
        lines.append("# TYPE pathway_flow_queued_rows gauge")
        for g in flow["inputs"]:
            lines.append(
                f'pathway_flow_queued_rows{{{_fmt_label(input=g["input"], service_class=g["service_class"])}}} {g["queued"] + g["in_flight"]}'
            )
        lines.append("# HELP pathway_flow_credits_available Remaining ingest credits of a connector queue")
        lines.append("# TYPE pathway_flow_credits_available gauge")
        for g in flow["inputs"]:
            avail = max(0, g["effective_bound"] - g["queued"] - g["in_flight"])
            lines.append(
                f'pathway_flow_credits_available{{{_fmt_label(input=g["input"])}}} {avail}'
            )
        lines.append("# HELP pathway_flow_shed_rows_total Rows dropped by the shed overflow policy")
        lines.append("# TYPE pathway_flow_shed_rows_total counter")
        for g in flow["inputs"]:
            lines.append(
                f'pathway_flow_shed_rows_total{{{_fmt_label(input=g["input"])}}} {g["shed_rows"]}'
            )
        lines.append("# HELP pathway_flow_target_batch Microbatch launch bucket chosen by the AIMD controller")
        lines.append("# TYPE pathway_flow_target_batch gauge")
        lines.append(f'pathway_flow_target_batch {flow["controller"]["target_batch"]}')
        lines.append("# HELP pathway_flow_pressure Flow-control pressure in [0,1] (latency-vs-SLO blended with queue occupancy)")
        lines.append("# TYPE pathway_flow_pressure gauge")
        lines.append(f'pathway_flow_pressure {flow["pressure"]}')
    # ---- per-sink end-to-end latency histograms -----------------------------
    snaps = _obs.run_metrics().sink_snapshots()
    if snaps:
        lines.append("# HELP pathway_sink_latency_seconds End-to-end ingest-to-emit latency per sink")
        lines.append("# TYPE pathway_sink_latency_seconds histogram")
        for label, snap in snaps.items():
            cum = 0
            for bound, c in zip(BUCKET_BOUNDS_S, snap["counts"]):
                cum += c
                lines.append(
                    f'pathway_sink_latency_seconds_bucket{{{_fmt_label(sink=label, le=repr(bound))}}} {cum}'
                )
            cum += snap["counts"][-1]
            lines.append(
                f'pathway_sink_latency_seconds_bucket{{{_fmt_label(sink=label)},le="+Inf"}} {cum}'
            )
            lines.append(
                f'pathway_sink_latency_seconds_sum{{{_fmt_label(sink=label)}}} {snap["sum_s"]}'
            )
            lines.append(
                f'pathway_sink_latency_seconds_count{{{_fmt_label(sink=label)}}} {snap["count"]}'
            )
    # ---- REST serving plane (per-route requests/sheds/latency) --------------
    from pathway_tpu_torch.io.http import _server as _rest_serve

    lines.extend(_rest_serve.serving_prometheus_lines(runtime))
    # ---- request-scoped tracing (per-stage latency decomposition) -----------
    rp = _obs.requests.current()
    if rp is not None:
        lines.extend(rp.prometheus_lines())
    # ---- device profiling plane (compiles, pad waste, memory, FLOPs) --------
    lines.extend(_obs.device.prometheus_lines(runtime))
    # ---- data-plane audit (edge cardinality, violations, divergences) -------
    aud = _obs.audit.current()
    if aud is not None:
        lines.extend(aud.prometheus_lines(runtime))
    # ---- cluster membership: the elastic plane is not carried, and the port
    # runs one process (``make_runtime`` refuses more) — only the gauge the
    # reference always emits
    from pathway_tpu_torch.internals.config import get_pathway_config

    lines.append("# HELP pathway_cluster_processes Processes in the current cluster membership")
    lines.append("# TYPE pathway_cluster_processes gauge")
    lines.append(f"pathway_cluster_processes {get_pathway_config().processes}")
    # ---- pod health & SLO plane (door state, canaries, burn rates, alerts) --
    from pathway_tpu_torch.observability import health as _health

    lines.extend(_health.prometheus_lines(runtime))
    # ---- pod timeline plane (recorder counters + bottleneck verdict) --------
    from pathway_tpu_torch.observability import timeline as _timeline

    tplane = _timeline.current()
    if tplane is not None:
        lines.append("# HELP pathway_timeline_samples_total Timeline recorder steps taken")
        lines.append("# TYPE pathway_timeline_samples_total counter")
        lines.append(f"pathway_timeline_samples_total {tplane.samples_total}")
        top = (tplane.bottleneck or {}).get("top")
        if top is not None:
            lines.append("# HELP pathway_bottleneck_score Score of the current top throughput-bound-by verdict")
            lines.append("# TYPE pathway_bottleneck_score gauge")
            lines.append(
                f'pathway_bottleneck_score{{{_fmt_label(cause=top["cause"])}}} {top["score"]}'
            )
    # ---- per-operator row-level error counters ------------------------------
    from pathway_tpu_torch.internals import error_log as _error_log

    err_counts = _error_log.operator_error_counts()
    lines.append("# HELP pathway_operator_errors_total Row-level failures logged per operator")
    lines.append("# TYPE pathway_operator_errors_total counter")
    for op in sorted(err_counts):
        lines.append(
            f'pathway_operator_errors_total{{{_fmt_label(op=op)}}} {err_counts[op]}'
        )
    return "\n".join(lines) + "\n"


def _profile_payload(query: str) -> bytes:
    """``/profile?ticks=N[&dir=...]``: arm a live ``torch.profiler`` capture
    window on the running pipeline (dir defaults to ``PATHWAY_PROFILE_DIR``).
    With no query arguments, reports the current window state instead."""
    from urllib.parse import parse_qs, unquote

    from pathway_tpu_torch.observability import device as _device

    qs = parse_qs(query)
    if not qs:
        return json.dumps(
            {"ok": True, "window": _device._profile_state()}
        ).encode()
    ticks = None
    try:
        ticks = int(qs["ticks"][0])
    except (KeyError, ValueError, IndexError):
        pass
    path = unquote(qs["dir"][0]) if qs.get("dir") else None
    return json.dumps(_device.request_profile(ticks, path)).encode()


def _explain_payload(runtime, query: str) -> bytes:
    """``/explain?sink=<label>&key=<output key>``: walk the operator graph
    backward from a sink row through the lineage rings — contributing input
    rows, operator path, originating trace span ids. Requires the audit
    plane's lineage store (``PATHWAY_AUDIT=on`` + ``PATHWAY_LINEAGE_KEYS>0``)."""
    from urllib.parse import parse_qs, unquote

    from pathway_tpu_torch.observability import lineage as _lineage

    qs = parse_qs(query)
    store = _lineage.current()
    if store is None:
        return json.dumps(
            {
                "ok": False,
                "error": "lineage is off (PATHWAY_AUDIT=off or PATHWAY_LINEAGE_KEYS=0)",
            }
        ).encode()
    sink = unquote(qs["sink"][0]) if qs.get("sink") else None
    if not sink:
        return json.dumps(
            {"ok": False, "error": "missing sink=", "sinks": store.sink_labels()}
        ).encode()
    try:
        key = int(qs["key"][0], 0)
    except (KeyError, ValueError, IndexError):
        return json.dumps({"ok": False, "error": "missing or non-integer key="}).encode()
    doc = store.explain(getattr(runtime, "scheduler", None), sink, key)
    return json.dumps(doc, default=str).encode()


def _trace_payload(query: str) -> bytes:
    """``/trace?since=<cursor>`` body: live spans recorded after the cursor
    (OTLP span dicts) + the next cursor, so a poller tails the span stream
    incrementally. Empty when tracing is off (``PATHWAY_TRACE=off``)."""
    from urllib.parse import parse_qs

    from pathway_tpu_torch import observability as _obs

    since = 0
    try:
        since = int(parse_qs(query).get("since", ["0"])[0])
    except (ValueError, TypeError):
        pass
    tracer = _obs.current()
    if tracer is None:
        doc = {"enabled": False, "spans": [], "next": since}
    else:
        spans, next_seq = tracer.buffer.since(since)
        doc = {
            "enabled": True,
            "traceId": tracer.trace_id,
            "sample": tracer.sample,
            "spans": spans,
            "next": next_seq,
        }
    return json.dumps(doc).encode()


def _timeline_payload(query: str) -> bytes:
    """``/timeline?metric=&since=&step=&proc=`` body: the timeline plane's
    cursor response (``proc=<pid>`` = that process's ring, default = this
    process). ``{"enabled": false}`` with the plane off."""
    from urllib.parse import parse_qs

    from pathway_tpu_torch.observability import timeline as _timeline

    plane = _timeline.current()
    if plane is None:
        return json.dumps({"enabled": False, "points": [], "next": None}).encode()
    return json.dumps(plane.payload(parse_qs(query))).encode()


#: routes of planes the port has not carried yet: 501 with the later-slice
#: message (the reference serves it from its elastic plane)
_LATER_SLICE_ROUTES = {
    "/scale": "elastic",
}


def _alerts_payload() -> tuple[int, dict, dict[str, str]]:
    """``/alerts``: the structured active-alert set, recent resolutions,
    per-alert fired counters and sink delivery counters."""
    from pathway_tpu_torch.observability import alerts as _alerts

    registry = _alerts.current()
    if registry is None:
        return (
            200,
            {"ok": False, "error": "health plane is off (PATHWAY_HEALTH=off)"},
            {},
        )
    doc = {"ok": True, **registry.status_summary()}
    return 200, doc, {}


def _request_payload(query: str) -> bytes:
    """``/request?id=<request_id>``: one request's kept flight-path trace
    (OTLP spans + per-stage latency decomposition), or its in-flight status.
    With no ``id``, lists the kept trace ids and the in-flight table."""
    from urllib.parse import parse_qs, unquote

    from pathway_tpu_torch.observability import requests as _requests

    plane = _requests.current()
    if plane is None:
        return json.dumps(
            {"ok": False, "error": "request tracing is off (PATHWAY_REQUEST_TRACE=off)"}
        ).encode()
    qs = parse_qs(query)
    rid = unquote(qs["id"][0]) if qs.get("id") else None
    if not rid:
        return json.dumps(
            {
                "ok": True,
                "kept_ids": plane.kept_ids(),
                "in_flight": plane.inflight_table(),
                "summary": plane.status_summary(),
            }
        ).encode()
    return json.dumps(plane.get_trace(rid), default=str).encode()


class MonitoringHttpServer:
    """``/status`` + ``/metrics`` + ``/trace`` over a daemon thread for the
    run's lifetime. Binds ``PATHWAY_MONITORING_HTTP_HOST`` (default loopback;
    multi-host TPU-VM pods set an external address so peers are scrapable)."""

    def __init__(self, runtime, port: int | None = None, host: str | None = None):
        import os

        from pathway_tpu_torch.internals.config import get_pathway_config

        self.runtime = runtime
        if port is None:
            base = int(os.environ.get("PATHWAY_MONITORING_HTTP_PORT", "20000"))
            # multi-process runs inherit one env: offset by process id so
            # workers don't collide on the bind (reference http_server.rs)
            port = 0 if base == 0 else base + int(os.environ.get("PATHWAY_PROCESS_ID", "0"))
        self.port = port
        self.host = host if host is not None else get_pathway_config().monitoring_http_host
        self._stopped = False
        rt = runtime

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # quiet
                pass

            def do_GET(self):
                from pathway_tpu_torch.observability import health as _health

                path, _, query = self.path.partition("?")
                if path.rstrip("/") in ("/healthz", "/readyz", "/alerts"):
                    # door endpoints: served even while draining — liveness
                    # and the active-alert set are exactly what an operator
                    # needs when the pod is quiescing
                    if path.rstrip("/") == "/healthz":
                        status, doc = _health.healthz_payload()
                        hdrs = {}
                    elif path.rstrip("/") == "/readyz":
                        status, doc, hdrs = _health.readyz_payload()
                    else:
                        status, doc, hdrs = _alerts_payload()
                    body = json.dumps(doc, default=str).encode()
                    self.send_response(status)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    for k, v in hdrs.items():
                        self.send_header(k, v)
                    self.end_headers()
                    self.wfile.write(body)
                    return
                if path.rstrip("/") in ("/metrics", "/status") and _health.quiescing():
                    # monitoring consistent with readiness: while the pod
                    # quiesces to a rescale epoch, half-merged numbers would
                    # mislead a scraper — answer 503 like the doors do
                    plane = _health.current()
                    body = json.dumps(
                        {
                            "ok": False,
                            "state": "draining",
                            "reason": plane.drain_reason() if plane else None,
                        }
                    ).encode()
                    self.send_response(503)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.send_header("Retry-After", "5")
                    self.end_headers()
                    self.wfile.write(body)
                    return
                if path.rstrip("/") == "/metrics":
                    body = prometheus_text(rt).encode()
                    ctype = "text/plain; version=0.0.4"
                elif path.rstrip("/") == "/status":
                    body = json.dumps(run_stats(rt)).encode()
                    ctype = "application/json"
                elif path.rstrip("/") == "/trace":
                    body = _trace_payload(query)
                    ctype = "application/json"
                elif path.rstrip("/") == "/profile":
                    body = _profile_payload(query)
                    ctype = "application/json"
                elif path.rstrip("/") == "/request":
                    body = _request_payload(query)
                    ctype = "application/json"
                elif path.rstrip("/") == "/explain":
                    body = _explain_payload(rt, query)
                    ctype = "application/json"
                elif path.rstrip("/") == "/timeline":
                    body = _timeline_payload(query)
                    ctype = "application/json"
                elif path.rstrip("/") in _LATER_SLICE_ROUTES:
                    from pathway_tpu_torch.internals.later_slice import later_slice

                    plane = _LATER_SLICE_ROUTES[path.rstrip("/")]
                    body = json.dumps({"ok": False, "error": str(later_slice(plane))}).encode()
                    self.send_response(501)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.server = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self.server.server_address[1]
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)

    def start(self) -> "MonitoringHttpServer":
        self.thread.start()
        return self

    def stop(self) -> None:
        # idempotent + exception-safe: runs in ``finally`` blocks after failed
        # runs, possibly twice (interactive handle + run teardown)
        if self._stopped:
            return
        self._stopped = True
        try:
            self.server.shutdown()
        finally:
            self.server.server_close()
        self.thread.join(timeout=5.0)


class LiveDashboard:
    """Live console dashboard during a streaming run (reference:
    ``internals/monitoring.py:22-271`` — the rich-based table of per-connector
    message counts and per-operator latency, refreshed while the run lives).

    Renders the same per-operator stats table as :func:`print_summary` plus
    latency/lag probes, redrawing in place with ANSI cursor control every
    ``refresh_s``. Starts only when the output stream is a TTY (or
    ``force=True`` for tests) — exactly when a human is watching."""

    def __init__(self, runtime, level: str, file=None, refresh_s: float = 1.0, force: bool = False):
        self.runtime = runtime
        self.level = level
        self.file = file or sys.stderr
        self.refresh_s = refresh_s
        self.force = force
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._last_lines = 0
        self.failed = False

    def should_run(self) -> bool:
        if self.level in (None, "none"):
            return False
        return self.force or getattr(self.file, "isatty", lambda: False)()

    def _render(self) -> str:
        stats = run_stats(self.runtime)
        shown = _visible_operators(stats["operators"], self.level)
        width = max([len(o["operator"]) for o in shown] + [8])
        head = (
            f"{'operator':<{width}}  {'rows_in':>10}  {'rows_out':>10}  "
            f"{'latency_ms':>10}  {'lag':>5}"
        )
        lines = [
            f"tick {stats['current_time']}  rows_in {stats['rows_in_total']}  "
            f"rows_out {stats['rows_out_total']}",
            head,
        ]
        for o in shown:
            lag = "-" if o.get("lag") is None else str(o["lag"])
            lines.append(
                f"{o['operator']:<{width}}  {o['rows_in']:>10}  {o['rows_out']:>10}  "
                f"{o['latency_ms']:>10.2f}  {lag:>5}"
            )
        return "\n".join(lines)

    def _draw(self) -> None:
        text = self._render()
        lines = text.count("\n") + 1
        out = ""
        if self._last_lines:
            out += f"\x1b[{self._last_lines}F\x1b[J"  # up N lines, clear below
        out += text + "\n"
        self.file.write(out)
        getattr(self.file, "flush", lambda: None)()
        self._last_lines = lines

    def start(self) -> "LiveDashboard":
        if not self.should_run():
            return self

        def loop() -> None:
            try:
                while not self._stop.wait(self.refresh_s):
                    self._draw()
                self._draw()  # final state
            except Exception:
                # never let the dashboard kill a run; the run-end summary
                # still prints because `failed` records the dead display
                self.failed = True

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)


def print_summary(runtime, level: str, file=None) -> str | None:
    """Console dashboard at run end (reference's monitoring table, condensed).

    AUTO prints only when attached to a TTY; IN_OUT shows connector/sink rows;
    ALL shows every operator.
    """
    file = file or sys.stderr
    if level in (None, "none"):
        return None
    if level == "auto" and not getattr(file, "isatty", lambda: False)():
        return None
    stats = run_stats(runtime)
    # summary semantics: auto shows everything (one final table); the LIVE
    # dashboard narrows auto to the edge operators instead
    ops = _visible_operators(stats["operators"], "all" if level == "auto" else level)
    width = max([len(o["operator"]) for o in ops] + [8])
    lines = [f"{'operator':<{width}}  {'rows_in':>10}  {'rows_out':>10}  {'time_ms':>10}"]
    for o in ops:
        lines.append(
            f"{o['operator']:<{width}}  {o['rows_in']:>10}  {o['rows_out']:>10}  {o['time_ms']:>10.1f}"
        )
    text = "\n".join(lines)
    print(text, file=file)
    return text
