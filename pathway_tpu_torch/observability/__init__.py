"""Live telemetry planes: device profiling, request tracing, health and
alerts, streaming spans, watermarks and latency histograms.

The offline exports (``internals/telemetry.py``) write one OTLP document at
run END; this package watches the pipeline *while it runs*:

- ``device``   — per-callable calls and cold shapes, kernel builds, pad and
  FLOP accounting, device bytes per component, CUDA-event host/device splits,
  the flight recorder and ``torch.profiler`` windows (``PATHWAY_PROFILE``,
  on by default);
- ``requests`` — per-request flight paths with tail-based keep
  (``PATHWAY_REQUEST_TRACE``, on by default);
- ``audit``    — invariant monitors at operator edges, per-edge cardinality,
  sampled shadow audits, with row ``lineage`` for ``/explain``
  (``PATHWAY_AUDIT``, on by default);
- ``timeline`` — the recorder thread's derived rate and quantile points for
  ``/timeline``, with the ``bottleneck`` verdict (``PATHWAY_TIMELINE``, on
  by default);
- ``health``   — the door state machine, canaries, SLO burn rates and
  detectors, with ``alerts`` (``PATHWAY_HEALTH``, on by default);
- ``spans``    — head-sampled tick/operator/device spans, ring-buffered for
  ``/trace?since=`` and appended to a rotating OTLP-JSON file
  (``PATHWAY_TRACE=on``; off by default);
- ``metrics``  — per-input watermarks, per-sink end-to-end latency
  histograms, backlog gauges; ``engine_phases`` — per-phase tick attribution
  (``PATHWAY_ENGINE_PHASES``);
- ``aggregate``— peers ship summaries to the coordinator on the heartbeat
  link; the coordinator's ``/status`` shows the whole cluster.

Lifecycle: the runtime's ``run()`` calls :func:`install_from_env` and
:func:`shutdown` in its run wrapper; ``current()`` is the hot-path accessor —
**None when tracing is off**, so engine loops pay one ``is None`` test.

Carried from ``pathway_tpu/observability/__init__.py``; the planes install
and shut down in the reference's order.
"""

from __future__ import annotations

import secrets

from pathway_tpu_torch.observability import (
    aggregate,
    alerts,
    audit,
    bottleneck,
    device,
    engine_phases,
    health,
    lineage,
    metrics,
    requests,
    spans,
    timeline,
)
from pathway_tpu_torch.observability.metrics import (
    BUCKET_BOUNDS_S,
    Histogram,
    backlog_gauges,
    input_watermarks,
    run_metrics,
)
from pathway_tpu_torch.observability.spans import (
    RotatingTraceSink,
    SpanBuffer,
    Tracer,
    derive_trace_id,
)

_tracer: Tracer | None = None


def current() -> Tracer | None:
    """The installed live tracer, or None when tracing is off."""
    return _tracer


def run_trace_id() -> str:
    """The trace id this run's spans carry: derived deterministically from
    ``PATHWAY_RUN_ID`` when set, else random per process."""
    from pathway_tpu_torch.internals.config import get_pathway_config

    run_id = get_pathway_config().run_id
    if run_id:
        return derive_trace_id(run_id)
    return secrets.token_hex(16)


def install_from_env(runtime=None) -> Tracer | None:
    """Install the run's live telemetry (called by the runtime's ``run``):
    reset the per-run metrics state, install the device, audit,
    request-trace, health and timeline planes, and build a tracer when ``PATHWAY_TRACE`` is on.
    Idempotent per run — a previous run's tracer is closed first."""
    global _tracer
    from pathway_tpu_torch.internals.config import get_pathway_config

    metrics.reset()
    # device profiling plane (call/build/pad/memory accounting, flight
    # recorder, profiler windows) — on by default, independent of PATHWAY_TRACE
    device.install_from_env(runtime)
    # data-plane audit (invariant monitors, cardinality gauges, shadow audits,
    # row lineage) — on by default, independent of the other planes
    audit.install_from_env(runtime)
    # request-scoped tracing (per-request flight paths, tail-based sampling) —
    # on by default; off installs no plane, hot loops pay one is-None test
    requests.install_from_env(runtime)
    # host-side per-phase tick attribution (PATHWAY_ENGINE_PHASES=on) —
    # totals persist across runs until reset() so one bench process can
    # aggregate several pipelines
    engine_phases.install_from_env()
    # pod health & SLO plane (door state machine, canaries, burn-rate alerts,
    # incident bundles) — on by default; off installs nothing
    health.install_from_env(runtime)
    # pod timeline plane (history rings, segment spill, bottleneck
    # attribution) — on by default; off constructs no plane. After health so
    # the recorder can sample canary/alert state from step one.
    timeline.install_from_env(runtime)
    if _tracer is not None:
        try:
            _tracer.close(emit_root=False)
        except Exception:
            pass
        _tracer = None
    cfg = get_pathway_config()
    if cfg.trace_mode == "off":
        return None
    sink = None
    path = cfg.trace_live_file
    if path:
        if cfg.processes > 1:
            path = f"{path}.p{cfg.process_id}"
        sink = RotatingTraceSink(path, rotate_bytes=cfg.trace_rotate_mb * 1024 * 1024)
    _tracer = Tracer(
        trace_id=run_trace_id(),
        process_id=cfg.process_id,
        sample=cfg.trace_sample,
        buffer=SpanBuffer(max_spans=cfg.trace_buffer_spans, sink=sink),
    )
    return _tracer


def shutdown() -> None:
    """Stop the planes and close the live tracer (flush + root span + file
    sink). The device plane's profiler window closes here: a CUDA error
    there propagates; nothing else raises."""
    global _tracer
    timeline.shutdown()
    health.shutdown()
    try:
        device.shutdown()
    finally:
        audit.shutdown()
        requests.shutdown()
        if _tracer is not None:
            try:
                _tracer.close()
            except Exception:
                pass
            _tracer = None


__all__ = [
    "aggregate",
    "BUCKET_BOUNDS_S",
    "Histogram",
    "RotatingTraceSink",
    "SpanBuffer",
    "Tracer",
    "alerts",
    "audit",
    "backlog_gauges",
    "bottleneck",
    "current",
    "derive_trace_id",
    "device",
    "engine_phases",
    "health",
    "input_watermarks",
    "lineage",
    "install_from_env",
    "metrics",
    "requests",
    "run_metrics",
    "run_trace_id",
    "shutdown",
    "spans",
    "timeline",
]
