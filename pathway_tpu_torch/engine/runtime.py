"""Run loop: ticks, autocommit, connector lifecycle.

Role of the reference's ``run_with_new_dataflow_graph`` main loop
(``src/engine/dataflow.rs:6111-6324``): build the engine graph from requested
outputs, then either run one batch tick (static mode) or loop — poll connector
threads, advance the logical time on autocommit ticks (``autocommit_duration_ms``),
drain the dataflow — until every input is exhausted, then flush and close.

Carried from ``pathway_tpu/engine/runtime.py``. The run installs the fault
plan (``PATHWAY_FAULT_PLAN``) and the observability planes
(``observability.install_from_env``: device profiling, audit, request
tracing, health, timeline, the live tracer), marks the door ready once the
connectors start and draining before they stop, and skips a tick a
``drop_poll`` fault names, as the reference does. It installs the flow
plane (``PATHWAY_FLOW``) before the graph builds, steps it after every tick
and shuts it down in its ``finally``. The reference's run also replays
persistence; that plane is not ported yet (ROADMAP Queue 1), so its hook is
cut.
"""

from __future__ import annotations

import threading
import time as _time
from typing import Any, Protocol

from pathway_tpu_torch.engine.graph import Scheduler
from pathway_tpu_torch.internals.logical import LogicalNode, build_engine_graph


class TickWakeup:
    """Arrival-driven tick scheduling (the serving plane's latency lever).

    The streaming loops sleep the remainder of the autocommit period between
    ticks, so before r14 a REST query arriving right after a tick waited the
    whole poll interval before the engine even saw it. Connectors call
    :meth:`request` when work arrives: ``delay_s=0`` wakes the loop NOW (a
    full coalesce bucket is waiting), a positive delay bounds how long the
    arrival may coalesce with concurrent requests
    (``PATHWAY_SERVE_COALESCE_MS``) before a tick is forced. The loop's
    :meth:`wait` replaces its fixed sleep — an un-requested wait degrades to
    exactly the old autocommit sleep, so non-serving pipelines are unchanged.
    """

    __slots__ = ("_cond", "_immediate", "_deadline")

    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._immediate = False
        #: perf_counter deadline of the earliest delayed request, or None
        self._deadline: float | None = None

    def request(self, delay_s: float = 0.0) -> None:
        """Schedule a tick at most ``delay_s`` seconds from now (0 = now).
        Called from connector/handler threads; never blocks. A delayed
        request landing while the loop is already asleep re-arms the sleep
        with the shorter target (the condition variable wakes it to
        recompute), so the coalesce bound holds regardless of arrival phase."""
        with self._cond:
            if delay_s <= 0.0:
                self._immediate = True
            else:
                deadline = _time.perf_counter() + delay_s
                if self._deadline is not None and deadline >= self._deadline:
                    return  # an earlier wakeup is already armed
                self._deadline = deadline
            self._cond.notify_all()

    def wait(self, timeout: float) -> None:
        """Sleep until ``timeout`` elapses, a pending coalesce deadline
        passes, or an immediate tick is requested — whichever is first. Both
        request states are consumed on return: the tick that follows this
        wait drains every queue, satisfying all requests made before it."""
        end = _time.perf_counter() + timeout
        with self._cond:
            while not self._immediate:
                now = _time.perf_counter()
                target = end if self._deadline is None else min(end, self._deadline)
                remaining = target - now
                if remaining <= 0:
                    break
                self._cond.wait(remaining)
            self._immediate = False
            self._deadline = None


class ConnectorDriver(Protocol):
    """A live input source. ``start`` may spawn a thread pushing events into its
    StreamInputNode; ``is_finished`` signals the source is exhausted (bounded
    sources); unbounded sources stay alive until ``stop``."""

    def start(self) -> None: ...

    def is_finished(self) -> bool: ...

    def stop(self) -> None: ...


def check_connector_failures(connectors) -> None:
    """Surface captured connector-thread exceptions in the run loop (the
    reference's ErrorReporter channel → driver abort, SURVEY §5.3)."""
    for d in connectors:
        fail = getattr(d, "failure", None)
        if fail is None:
            continue
        e = fail()
        if e is not None:
            raise RuntimeError(f"input connector failed: {e!r}") from e


class Runtime:
    def __init__(
        self,
        monitoring_level: Any = None,
        autocommit_duration_ms: int | None = 20,
    ):
        self.connectors: list[ConnectorDriver] = []
        self.autocommit_duration_ms = autocommit_duration_ms
        self.monitoring_level = monitoring_level
        self.scheduler: Scheduler | None = None
        self._stop_requested = False
        # arrival-driven tick scheduling: connectors (the REST serving plane)
        # request a wakeup instead of waiting out the autocommit poll
        self.wakeup = TickWakeup()
        #: set once the graph is built: live-connector runs tick repeatedly, so
        #: cross-tick accumulators (microbatch UDF buffers) may hold rows until
        #: their autocommit deadline; static runs have exactly one tick and
        #: must flush at its frontier
        self.streaming = False

    def register_connector(self, driver: ConnectorDriver) -> None:
        self.connectors.append(driver)

    def request_stop(self) -> None:
        self._stop_requested = True

    def run(self, outputs: list[LogicalNode]) -> Scheduler:
        from pathway_tpu_torch import flow as _flow
        from pathway_tpu_torch import observability as _obs
        from pathway_tpu_torch.resilience import faults as _faults

        _faults.install_from_env()
        _obs.install_from_env(self)
        # flow plane before the graph builds: ingest gates attach as the
        # StreamInputNodes are constructed
        _flow.install_from_env(self)
        try:
            return self._run(outputs, _obs.current())
        except BaseException as e:
            # flight recorder post-mortem (device plane): recent ticks +
            # device events dumped to PATHWAY_FLIGHT_DIR before the error
            # propagates
            _obs.device.on_run_error(e, self)
            raise
        finally:
            _obs.shutdown()
            # closing the gates wakes producers blocked on credit, so
            # connector threads can exit even after a failed run
            _flow.shutdown()

    def _run(self, outputs: list[LogicalNode], tracer) -> Scheduler:
        from pathway_tpu_torch.observability import health as _health
        from pathway_tpu_torch.resilience import faults as _faults

        ctx = build_engine_graph(outputs, runtime=self)
        self.streaming = bool(self.connectors)
        scheduler = Scheduler(ctx.graph)
        scheduler.tracer = tracer
        self.scheduler = scheduler

        from pathway_tpu_torch import flow as _flow

        plane = _flow.current()
        if plane is not None:
            # after the tick settles: replenish ingest credits, step the AIMD
            # controller, plan the next tick's admission budgets
            scheduler.on_tick_done.append(
                lambda t: plane.on_tick_complete(self, t)
            )

        for driver in self.connectors:
            driver.start()
        # connectors are live and the graph is built: this door may now
        # receive traffic (health plane: starting → ready)
        _health.mark_ready()

        if not self.connectors:
            # static mode: single batch tick
            _faults.on_tick_start(0, 0)
            scheduler.run_tick(0)
            scheduler.close()
            return scheduler

        tick = 0
        period = (self.autocommit_duration_ms or 20) / 1000.0
        all_virtual = all(getattr(d, "virtual", False) for d in self.connectors)
        try:
            while not self._stop_requested:
                t0 = _time.perf_counter()
                if _faults.on_tick_start(0, tick):
                    # drop_poll fault: this tick is skipped entirely — events
                    # keep buffering in the input nodes for the next tick
                    tick += 1
                    _time.sleep(period)
                    continue
                scheduler.run_tick(tick)
                tick += 1
                check_connector_failures(self.connectors)
                if all(d.is_finished() for d in self.connectors):
                    scheduler.run_tick(tick)  # drain any final events
                    break
                if not all_virtual:
                    elapsed = _time.perf_counter() - t0
                    if elapsed < period:
                        self.wakeup.wait(period - elapsed)
        finally:
            # doors answer 503 + Retry-After from here on: drain before the
            # connector stop flushes pending request futures
            _health.mark_draining("shutdown")
            for driver in self.connectors:
                driver.stop()
        # a subject may error and close between the failure check and the
        # all(is_finished) break within one iteration — re-check so the run
        # can't exit cleanly on silently truncated input
        check_connector_failures(self.connectors)
        scheduler.close()
        return scheduler
