"""``pw.run`` / ``pw.run_all``.

Mirrors the reference's ``internals/run.py`` → GraphRunner flow
(``internals/graph_runner/__init__.py:111-246``): collect requested outputs from the
global graph, tree-shake, instantiate the engine dataflow, and drive it to completion
(streaming sources run until exhausted or stopped).

Carried from ``pathway_tpu/internals/run.py`` with the monitoring server, the
live dashboard, the run-end summary, the OTLP trace export, persistence
(``persistence_config``, and the recording roots ``PATHWAY_REPLAY_STORAGE`` /
``PATHWAY_PERSISTENT_STORAGE`` + ``PATHWAY_RECORD``), interactive mode and the
multi-worker runtimes: ``pw.run(n_workers=N)`` / ``PATHWAY_THREADS=N`` runs the
thread-sharded ``ShardedRuntime``, ``PATHWAY_PROCESSES>1`` the multi-process
``ClusterRuntime``.
"""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.engine.runtime import Runtime
from pathway_tpu_torch.internals.config import get_pathway_config
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
    """Runtime factory honoring the worker count (single-worker ``Runtime``,
    thread-sharded ``ShardedRuntime``, or the multi-process
    ``ClusterRuntime``)."""
    if get_pathway_config().processes > 1:
        from pathway_tpu_torch.parallel.cluster import ClusterRuntime

        return ClusterRuntime(
            monitoring_level=monitoring_level,
            autocommit_duration_ms=autocommit_duration_ms,
        )
    w = resolved_n_workers(n_workers)
    if w > 1:
        from pathway_tpu_torch.parallel.sharded import ShardedRuntime

        return ShardedRuntime(
            n_workers=w,
            monitoring_level=monitoring_level,
            autocommit_duration_ms=autocommit_duration_ms,
        )
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
) -> "InteractiveRunHandle | None":
    """Execute every output (sink/subscribe/debug) registered so far.

    Returns ``None``, except in interactive mode where the run continues on a
    daemon thread and an ``InteractiveRunHandle`` is returned.

    The run installs the device-profiling, request-trace and health planes
    (``PATHWAY_PROFILE``, ``PATHWAY_REQUEST_TRACE``, ``PATHWAY_HEALTH``, each
    on by default, as in the reference). ``with_http_server=True`` serves
    ``/status``, ``/metrics``, ``/trace``, ``/request?id=``, ``/profile``,
    ``/healthz``, ``/readyz`` and ``/alerts`` from
    :class:`~pathway_tpu_torch.internals.monitoring.MonitoringHttpServer`
    while the run lives (port ``PATHWAY_MONITORING_HTTP_PORT``, default
    20000; its bound address is on ``/status`` under ``monitoring``).
    ``persistence_config=pw.persistence.Config(...)`` logs inputs and, in
    ``operator_persisting`` mode, snapshots operator state, so a restart
    resumes where the last run committed (``persistence/snapshots.py``)."""
    global _last_runtime
    if not G.outputs:
        import warnings

        warnings.warn("pw.run(): no outputs registered; nothing to do")
        return
    cfg = get_pathway_config()
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
    if persistence_config is None:
        # CLI contract: `spawn --record` / `replay` point PATHWAY_PERSISTENT_STORAGE /
        # PATHWAY_REPLAY_STORAGE at a recording root (reference: cli.py:253 + config.py)
        import os as _os

        auto_root = cfg.replay_storage or (
            cfg.persistent_storage if _os.environ.get("PATHWAY_RECORD") else None
        )
        if auto_root is not None:
            from pathway_tpu_torch import persistence as _p

            persistence_config = _p.Config(
                backend=_p.Backend.filesystem(auto_root),
                continue_after_replay=cfg.continue_after_replay,
            )
    if persistence_config is not None:
        from pathway_tpu_torch.persistence import attach_persistence

        attach_persistence(runtime, persistence_config)
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
    from pathway_tpu_torch.internals import interactive as _interactive

    if _interactive.is_interactive_mode_enabled():
        # notebook mode: the runtime loops on a daemon thread; LiveTables
        # update as ticks land and the handle stops the run
        import threading as _threading
        import time as _time

        outputs = list(G.outputs)
        t_start_ns = _time.time_ns()

        def _bg():
            ok = False
            try:
                runtime.run(outputs)
                ok = True
            finally:
                if not ok:
                    from pathway_tpu_torch.internals.exported import fail_close_exports

                    fail_close_exports(runtime)
                # the error policy is NOT restored here (restoring a
                # process-global from a daemon thread would race a later
                # pw.run on the main thread) — the handle restores it from
                # stop()/join(), i.e. on the thread that owns the policy
                if http_server is not None:
                    http_server.stop()
                _telemetry.maybe_export_run_trace(runtime, t_start_ns)

        th = _threading.Thread(target=_bg, daemon=True)
        th.start()

        def _restore():
            # restore only if the policy is still the one THIS run set —
            # a later pw.run (or another handle) may own the global by now
            if _errors.get_error_policy() == terminate_on_error:
                _errors.set_error_policy(prev_policy)

        return _interactive.InteractiveRunHandle(runtime, th, on_finish=_restore)

    import time as _time

    from pathway_tpu_torch.internals.monitoring import LiveDashboard, print_summary

    t_start_ns = _time.time_ns()
    level = monitoring_level if isinstance(monitoring_level, str) else "auto"
    dashboard = LiveDashboard(runtime, level).start()
    ok = False
    try:
        runtime.run(list(G.outputs))
        ok = True
    finally:
        if not ok:
            from pathway_tpu_torch.internals.exported import fail_close_exports

            fail_close_exports(runtime)
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
