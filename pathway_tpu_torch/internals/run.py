"""``pw.run`` / ``pw.run_all``.

Mirrors the reference's ``internals/run.py`` → GraphRunner flow
(``internals/graph_runner/__init__.py:111-246``): collect requested outputs from the
global graph, tree-shake, instantiate the engine dataflow, and drive it to completion
(streaming sources run until exhausted or stopped).

Carried from ``pathway_tpu/internals/run.py`` with the planes that are not
ported yet (multi-worker runtimes, persistence, monitoring, interactive mode)
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

    The reference's persistence, monitoring server, live dashboard, trace
    export and interactive mode are planes not ported yet: asking for
    persistence or the HTTP server raises, and no dashboard or summary is
    printed."""
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
    if with_http_server:
        raise later_slice("monitoring")
    runtime = make_runtime(
        n_workers=n_workers,
        monitoring_level=monitoring_level,
        autocommit_duration_ms=autocommit_duration_ms,
    )
    _last_runtime = runtime
    from pathway_tpu_torch.internals import errors as _errors

    if terminate_on_error is None:
        # kwarg beats PATHWAY_TERMINATE_ON_ERROR beats True
        terminate_on_error = cfg.terminate_on_error
    prev_policy = _errors.get_error_policy()
    _errors.set_error_policy(terminate_on_error)
    try:
        runtime.run(list(G.outputs))
    finally:
        _errors.set_error_policy(prev_policy)
    return None


run_all = run


def current_runtime() -> Runtime | None:
    return _last_runtime
