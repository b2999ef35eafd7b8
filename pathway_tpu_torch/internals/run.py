"""``pw.run`` / ``pw.run_all``.

Mirrors the reference's ``internals/run.py`` → GraphRunner flow
(``internals/graph_runner/__init__.py:111-246``): collect requested outputs from the
global graph, tree-shake, instantiate the engine dataflow, and drive it to completion
(streaming sources run until exhausted or stopped).

Carried from ``pathway_tpu/internals/run.py`` with the monitoring server, the
live dashboard, the run-end summary and the OTLP trace export. The planes that
are not ported yet (multi-worker runtimes, persistence, interactive mode) are
cut: asking for one raises ``NotImplementedError("later slice: <plane>")``.
"""

from __future__ import annotations

import os
from typing import Any

from pathway_tpu_torch.engine.runtime import Runtime
from pathway_tpu_torch.internals.config import get_pathway_config
from pathway_tpu_torch.internals.later_slice import later_slice
from pathway_tpu_torch.internals.parse_graph import G


class MonitoringLevel:
    AUTO = "auto"
    NONE = "none"
    IN_OUT = "in_out"
    ALL = "all"


_last_runtime: Runtime | None = None


def resolved_n_workers(n_workers: int | None = None) -> int:
    """kwarg beats env ``PATHWAY_THREADS`` beats 1 (reference: ``PathwayConfig``
    threads resolution, ``internals/config.py``)."""
    if n_workers is not None:
        return max(1, int(n_workers))
    return get_pathway_config().threads


def make_runtime(
    *,
    n_workers: int | None = None,
    monitoring_level: Any = None,
    autocommit_duration_ms: int | None = 20,
):
    """The single-worker ``Runtime``. The reference's multi-process
    (``parallel.cluster``) and thread-sharded (``parallel.sharded``) runtimes
    are not ported yet: asking for them raises."""
    if get_pathway_config().processes > 1:
        raise later_slice("parallel.cluster")
    if resolved_n_workers(n_workers) > 1:
        raise later_slice("parallel.sharded")
    return Runtime(
        monitoring_level=monitoring_level,
        autocommit_duration_ms=autocommit_duration_ms,
    )


def run(
    *,
    monitoring_level: Any = MonitoringLevel.AUTO,
    with_http_server: bool = False,
    autocommit_duration_ms: int | None = 20,
    persistence_config: Any = None,
    runtime_typechecking: bool | None = None,
    terminate_on_error: bool | None = None,
    n_workers: int | None = None,
    **kwargs: Any,
) -> None:
    """Execute every output (sink/subscribe/debug) registered so far.

    The run installs the device-profiling, request-trace and health planes
    (``PATHWAY_PROFILE``, ``PATHWAY_REQUEST_TRACE``, ``PATHWAY_HEALTH``, each
    on by default, as in the reference). ``with_http_server=True`` serves
    ``/status``, ``/metrics``, ``/trace``, ``/request?id=``, ``/profile``,
    ``/healthz``, ``/readyz`` and ``/alerts`` from
    :class:`~pathway_tpu_torch.internals.monitoring.MonitoringHttpServer`
    while the run lives (port ``PATHWAY_MONITORING_HTTP_PORT``, default
    20000; its bound address is on ``/status`` under ``monitoring``). The
    reference's persistence and interactive mode are planes not ported yet:
    asking for persistence raises."""
    global _last_runtime
    if not G.outputs:
        import warnings

        warnings.warn("pw.run(): no outputs registered; nothing to do")
        return
    cfg = get_pathway_config()
    if persistence_config is not None or cfg.replay_storage or (
        cfg.persistent_storage and os.environ.get("PATHWAY_RECORD")
    ):
        raise later_slice("persistence")
    # per-run telemetry: the resilience event log (and its exports/status
    # views) describes THIS run, not every run this process ever did
    from pathway_tpu_torch.internals import telemetry as _telemetry

    _telemetry.clear_events()
    runtime = make_runtime(
        n_workers=n_workers,
        monitoring_level=monitoring_level,
        autocommit_duration_ms=autocommit_duration_ms,
    )
    _last_runtime = runtime
    from pathway_tpu_torch.internals import errors as _errors

    http_server = None
    if with_http_server:
        from pathway_tpu_torch.internals.monitoring import MonitoringHttpServer

        http_server = MonitoringHttpServer(runtime)
        # run_stats reports the bound host:port (a port of 0 binds a free
        # one — this is where a scraper learns the real one); set before the
        # server answers its first /status
        runtime.monitoring_server = http_server
        http_server.start()
    if terminate_on_error is None:
        # kwarg beats PATHWAY_TERMINATE_ON_ERROR beats True
        terminate_on_error = cfg.terminate_on_error
    prev_policy = _errors.get_error_policy()
    _errors.set_error_policy(terminate_on_error)

    import time as _time

    from pathway_tpu_torch.internals.monitoring import LiveDashboard, print_summary

    t_start_ns = _time.time_ns()
    level = monitoring_level if isinstance(monitoring_level, str) else "auto"
    dashboard = LiveDashboard(runtime, level).start()
    try:
        runtime.run(list(G.outputs))
    finally:
        _errors.set_error_policy(prev_policy)
        if http_server is not None:
            http_server.stop()
        dashboard.stop()
        _telemetry.maybe_export_run_trace(runtime, t_start_ns)
        if dashboard._thread is None or dashboard.failed:
            # no dashboard ran (no TTY) or its display died: print the summary
            print_summary(runtime, level)
    return None


run_all = run


def current_runtime() -> Runtime | None:
    return _last_runtime
