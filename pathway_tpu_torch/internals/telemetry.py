"""OTLP-shaped trace + metrics export (span-per-run + span-per-operator,
gauge-per-probe).

Offline counterpart of the reference's OpenTelemetry pipeline
(``src/engine/telemetry.rs:42-47`` builds OTLP trace+metrics exporters over
tonic/gRPC; ``graph_runner/telemetry.py`` opens ``graph_runner.run`` spans with
graph-statistics attributes). This image has zero egress, so instead of a
collector endpoint the run writes one OTLP/JSON document
(``ExportTraceServiceRequest`` shape — the same JSON an OTLP file exporter or
``otlp-json`` collector receiver consumes) to a file:

- root span ``pathway.run`` carrying run-level attributes (workers, operator
  count, row totals),
- one child span per operator with its rows/busy-time/latency/lag probes
  (the ``OperatorStats`` analogue, ``src/engine/graph.rs:497-527``).

Metrics export alongside (the reference ships OTLP traces
AND metrics, ``telemetry.rs:42-47``): an ``ExportMetricsServiceRequest``-shaped
JSON document with per-operator rows/busy/latency/lag gauges plus run totals,
the same data the Prometheus endpoint renders as text.

Enable with ``pw.set_monitoring_config(trace_file=..., metrics_file=...)`` or
``PATHWAY_TRACE_FILE=...`` / ``PATHWAY_METRICS_FILE=...``.

Carried from ``pathway_tpu/internals/telemetry.py`` with imports rewritten; the
documents name the service ``pathway_tpu_torch``. ``export_spans``, the
reference's export for a ``resilience.Supervisor`` parent, waits for that
plane.
"""

from __future__ import annotations

import json
import os
import secrets
from typing import Any

_UNSET = object()
_DISABLED = object()

_trace_file_override: Any = _UNSET
_metrics_file_override: Any = _UNSET

# -- resilience event log ------------------------------------------------------
# Cross-cutting recovery events (heartbeat-miss, checkpoint-epoch-committed,
# replay, fault injection, supervised restart) recorded by whichever subsystem
# observes them and exported through the SAME OTLP trace/metrics documents as
# the operator stats — so a recovery is visible in the run's own telemetry
# (reference: telemetry.rs exports trace AND metrics).

import threading as _threading
import time as _time_mod

#: bound on the retained raw events — long streaming runs commit an epoch per
#: tick with moving offsets (~50/s at the default autocommit), so the raw log
#: keeps only the most recent window while the counters below stay exact
_EVENTS_MAX = 4096

_events: list[dict] = []
_events_lock = _threading.Lock()
_counters: dict[str, int] = {}
_last_epoch: int | None = None
_replayed_total = 0


def record_event(kind: str, **attrs: Any) -> dict:
    """Record one resilience/lifecycle event. ``kind`` is a dotted name like
    ``resilience.heartbeat_miss``; attrs must be OTLP-attribute-friendly
    scalars. The raw log is bounded (oldest dropped past ``_EVENTS_MAX``);
    per-kind counters and the epoch/replay aggregates are exact regardless."""
    global _last_epoch, _replayed_total
    ev = {"kind": kind, "ts_ns": _time_mod.time_ns(), "attrs": dict(attrs)}
    with _events_lock:
        _events.append(ev)
        if len(_events) > _EVENTS_MAX:
            del _events[: len(_events) - _EVENTS_MAX]
        _counters[kind] = _counters.get(kind, 0) + 1
        if kind == "resilience.epoch_committed":
            _last_epoch = attrs.get("epoch", _last_epoch)
        elif kind == "resilience.replay":
            _replayed_total += int(attrs.get("events", 0))
    return ev


def events(kind: str | None = None) -> list[dict]:
    with _events_lock:
        snap = list(_events)
    if kind is None:
        return snap
    return [e for e in snap if e["kind"] == kind]


def clear_events() -> None:
    """Reset the event log and aggregates — called at the start of every
    ``pw.run`` so /status and the exported documents describe THIS run."""
    global _last_epoch, _replayed_total
    with _events_lock:
        _events.clear()
        _counters.clear()
        _last_epoch = None
        _replayed_total = 0


def resilience_summary() -> dict[str, Any]:
    """Aggregate view of the recorded events (monitoring /status + metrics)."""
    with _events_lock:
        counters = dict(_counters)
        last_epoch = _last_epoch
        replayed = _replayed_total
    return {
        "heartbeat_misses": counters.get("resilience.heartbeat_miss", 0),
        "last_committed_epoch": last_epoch,
        "replayed_events": replayed,
        "restarts": counters.get("resilience.restart", 0),
        "faults_injected": sum(
            v for k, v in counters.items() if k.startswith("resilience.fault")
        ),
        "events": sum(counters.values()),
    }


def set_monitoring_config(*, trace_file: Any = _UNSET, metrics_file: Any = _UNSET) -> None:
    """Runtime override of the trace/metrics destinations (reference:
    ``pw.set_monitoring_config(monitoring_server=...)``). Only explicitly
    passed knobs change their setting — calls configuring other knobs leave
    the rest untouched. An explicit ``None`` DISABLES that export even when
    the corresponding ``PATHWAY_*_FILE`` env var is set."""
    global _trace_file_override, _metrics_file_override
    if trace_file is not _UNSET:
        _trace_file_override = _DISABLED if trace_file is None else trace_file
    if metrics_file is not _UNSET:
        _metrics_file_override = _DISABLED if metrics_file is None else metrics_file


def trace_file() -> str | None:
    if _trace_file_override is _DISABLED:
        return None
    if _trace_file_override is not _UNSET:
        return _trace_file_override
    return os.environ.get("PATHWAY_TRACE_FILE") or None


def metrics_file() -> str | None:
    if _metrics_file_override is _DISABLED:
        return None
    if _metrics_file_override is not _UNSET:
        return _metrics_file_override
    return os.environ.get("PATHWAY_METRICS_FILE") or None


def maybe_export_run_trace(runtime, start_ns: int) -> None:
    """Shared run-end hook (both the batch and interactive pw.run paths):
    write the OTLP trace/metrics documents if destinations are configured,
    never raise."""
    import time as _time

    from pathway_tpu_torch.internals.config import get_pathway_config

    cfg = get_pathway_config()

    def ranked(path: str) -> str:
        # multi-process cluster runs share one env: suffix by process id so
        # ranks don't clobber one file (same rule as the monitoring HTTP port)
        return f"{path}.p{cfg.process_id}" if cfg.processes > 1 else path

    path = trace_file()
    if path:
        try:
            export_run_trace(runtime, ranked(path), start_ns, _time.time_ns())
        except Exception:
            import logging

            logging.getLogger(__name__).warning(
                "trace export to %s failed", path, exc_info=True
            )
    mpath = metrics_file()
    if mpath:
        try:
            export_run_metrics(runtime, ranked(mpath), _time.time_ns())
        except Exception:
            import logging

            logging.getLogger(__name__).warning(
                "metrics export to %s failed", mpath, exc_info=True
            )


def _attr(key: str, value: Any) -> dict:
    if isinstance(value, bool):
        v = {"boolValue": value}
    elif isinstance(value, int):
        v = {"intValue": str(value)}
    elif isinstance(value, float):
        v = {"doubleValue": value}
    else:
        v = {"stringValue": str(value)}
    return {"key": key, "value": v}


def export_run_trace(
    runtime, path: str, start_ns: int, end_ns: int
) -> dict:
    """Write one OTLP/JSON trace document for a finished (or stopping) run;
    returns the document (tests introspect it)."""
    from pathway_tpu_torch import observability as _obs
    from pathway_tpu_torch.internals.config import get_pathway_config
    from pathway_tpu_torch.internals.monitoring import run_stats

    stats = run_stats(runtime)
    # trace id derives from PATHWAY_RUN_ID when set (spawn exports one per
    # cluster launch), so every process's offline doc — and the live span
    # plane — stitch under ONE trace; the deterministic root-span id lets
    # peers parent their subtree to process 0's root without coordination
    cfg = get_pathway_config()
    trace_id = _obs.run_trace_id()
    shared_root = _obs.spans.derive_root_span_id(trace_id)
    if cfg.processes > 1 and cfg.process_id != 0 and cfg.run_id:
        # only with a shared run id does process 0 emit the span this parent
        # id names — without one, trace ids are per-process random and a
        # parent link would dangle (orphaned subtree in Perfetto)
        root_id = secrets.token_hex(8)
        root_span = {
            "traceId": trace_id,
            "spanId": root_id,
            "parentSpanId": shared_root,
            "name": f"pathway.run.p{cfg.process_id}",
        }
    else:
        root_id = shared_root
        root_span = {"traceId": trace_id, "spanId": root_id, "name": "pathway.run"}
    root_span.update(
        {
            "kind": 1,  # SPAN_KIND_INTERNAL
            "startTimeUnixNano": str(start_ns),
            "endTimeUnixNano": str(end_ns),
            "attributes": [
                _attr("pathway.n_operators", len(stats["operators"])),
                _attr("pathway.rows_in_total", stats["rows_in_total"]),
                _attr("pathway.rows_out_total", stats["rows_out_total"]),
                _attr("pathway.process_id", cfg.process_id),
                _attr(
                    "pathway.n_workers",
                    len(getattr(runtime, "workers", None) or []) or 1,
                ),
            ],
        }
    )
    spans = [root_span]
    for op in stats["operators"]:
        attrs = [
            _attr("pathway.operator.id", op["id"]),
            _attr("pathway.operator.rows_in", op["rows_in"]),
            _attr("pathway.operator.rows_out", op["rows_out"]),
            _attr("pathway.operator.busy_ms", op["time_ms"]),
            _attr("pathway.operator.latency_ms", op["latency_ms"]),
        ]
        if op.get("lag") is not None:
            attrs.append(_attr("pathway.operator.lag", op["lag"]))
        spans.append(
            {
                "traceId": trace_id,
                "spanId": secrets.token_hex(8),
                "parentSpanId": root_id,
                "name": f"operator/{op['operator']}",
                "kind": 1,
                "startTimeUnixNano": str(start_ns),
                "endTimeUnixNano": str(end_ns),
                "attributes": attrs,
            }
        )
    # resilience events ride the same trace as zero-duration child spans so a
    # recovery (replay, heartbeat miss, epoch commit) is visible inline with
    # the operators it affected
    for ev in events():
        spans.append(
            {
                "traceId": trace_id,
                "spanId": secrets.token_hex(8),
                "parentSpanId": root_id,
                "name": f"event/{ev['kind']}",
                "kind": 1,
                "startTimeUnixNano": str(ev["ts_ns"]),
                "endTimeUnixNano": str(ev["ts_ns"]),
                "attributes": [_attr(k, v) for k, v in ev["attrs"].items()],
            }
        )
    doc = {
        "resourceSpans": [
            {
                "resource": {
                    "attributes": [
                        _attr("service.name", "pathway_tpu_torch"),
                        _attr("process.pid", os.getpid()),
                    ]
                },
                "scopeSpans": [
                    {
                        "scope": {"name": "pathway_tpu_torch.run", "version": "1"},
                        "spans": spans,
                    }
                ],
            }
        ]
    }
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "w") as fh:
        json.dump(doc, fh)
    os.replace(tmp, path)
    return doc


def export_run_metrics(runtime, path: str, ts_ns: int) -> dict:
    """Write one OTLP/JSON metrics document (``ExportMetricsServiceRequest``
    shape — the file/collector form of the reference's OTLP metrics pipeline,
    ``src/engine/telemetry.rs:42-47``): per-operator rows/busy/latency/lag
    gauges + run totals. Returns the document (tests introspect it)."""
    from pathway_tpu_torch.internals.monitoring import run_stats

    stats = run_stats(runtime)
    t = str(ts_ns)

    def point(value: Any, attrs: list[dict]) -> dict:
        key = "asInt" if isinstance(value, int) else "asDouble"
        v: Any = str(value) if isinstance(value, int) else float(value)
        return {"timeUnixNano": t, key: v, "attributes": attrs}

    def gauge(name: str, unit: str, points: list[dict]) -> dict:
        return {"name": name, "unit": unit, "gauge": {"dataPoints": points}}

    per_op: dict[str, list[dict]] = {
        "pathway.operator.rows_in": [],
        "pathway.operator.rows_out": [],
        "pathway.operator.busy_ms": [],
        "pathway.operator.latency_ms": [],
        "pathway.operator.lag": [],
    }
    for op in stats["operators"]:
        attrs = [
            _attr("pathway.operator", op["operator"]),
            _attr("pathway.operator.id", op["id"]),
        ]
        per_op["pathway.operator.rows_in"].append(point(int(op["rows_in"]), attrs))
        per_op["pathway.operator.rows_out"].append(point(int(op["rows_out"]), attrs))
        per_op["pathway.operator.busy_ms"].append(point(float(op["time_ms"]), attrs))
        per_op["pathway.operator.latency_ms"].append(
            point(float(op["latency_ms"]), attrs)
        )
        if op.get("lag") is not None:
            per_op["pathway.operator.lag"].append(point(int(op["lag"]), attrs))
    metrics = [
        gauge("pathway.rows_in_total", "{rows}", [point(int(stats["rows_in_total"]), [])]),
        gauge("pathway.rows_out_total", "{rows}", [point(int(stats["rows_out_total"]), [])]),
        gauge("pathway.operator.rows_in", "{rows}", per_op["pathway.operator.rows_in"]),
        gauge("pathway.operator.rows_out", "{rows}", per_op["pathway.operator.rows_out"]),
        gauge("pathway.operator.busy_ms", "ms", per_op["pathway.operator.busy_ms"]),
        gauge(
            "pathway.operator.latency_ms", "ms", per_op["pathway.operator.latency_ms"]
        ),
    ]
    if per_op["pathway.operator.lag"]:
        metrics.append(gauge("pathway.operator.lag", "1", per_op["pathway.operator.lag"]))
    res = resilience_summary()
    if res["events"]:
        metrics.append(
            gauge(
                "pathway.resilience.heartbeat_misses",
                "1",
                [point(int(res["heartbeat_misses"]), [])],
            )
        )
        metrics.append(
            gauge(
                "pathway.resilience.replayed_events",
                "{rows}",
                [point(int(res["replayed_events"]), [])],
            )
        )
        metrics.append(
            gauge(
                "pathway.resilience.restarts", "1", [point(int(res["restarts"]), [])]
            )
        )
        if res["last_committed_epoch"] is not None:
            metrics.append(
                gauge(
                    "pathway.resilience.last_committed_epoch",
                    "1",
                    [point(int(res["last_committed_epoch"]), [])],
                )
            )
    doc = {
        "resourceMetrics": [
            {
                "resource": {
                    "attributes": [
                        _attr("service.name", "pathway_tpu_torch"),
                        _attr("process.pid", os.getpid()),
                    ]
                },
                "scopeMetrics": [
                    {
                        "scope": {"name": "pathway_tpu_torch.run", "version": "1"},
                        "metrics": metrics,
                    }
                ],
            }
        ]
    }
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "w") as fh:
        json.dump(doc, fh)
    os.replace(tmp, path)
    return doc
