"""Supervised cluster restart: run the pipeline as child processes, relaunch
on failure from the last committed checkpoint epoch.

The reference's recovery story (SURVEY §5.3–5.4) is "worker dies → restart the
cluster → persistence replays to the last finalized time". The
:class:`Supervisor` is that restart loop as a first-class object: it owns the
child processes (one per ``PATHWAY_PROCESS_ID``, the same env contract as
``python -m pathway_tpu spawn`` in the reference), detects any child failing (non-zero exit or
death by signal), tears the survivors down, waits an exponential backoff, and
relaunches the whole cluster. Recovery state lives entirely in the persistence
backend — a relaunched cluster finds the newest fully-committed epoch
(``persistence/snapshots.py`` epoch manifest) and resumes from it, so the
supervisor itself is stateless across its own restarts.

Fault injection composes: set ``PATHWAY_FAULT_PLAN`` (see ``faults.py``) in the
supervisor env and the injected kill exercises exactly this path. By default
the plan is dropped from child envs after the first failure so a "kill at tick
N" fault doesn't re-fire forever on every relaunch.

Carried from ``pathway_tpu/resilience/supervisor.py``. A relaunch at a new
shape after an elastic rescale reads the membership table
(``elastic/membership.py``) the pod committed before it exited 75.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time as _time
from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

from pathway_tpu_torch.internals.config import get_pathway_config
from pathway_tpu_torch.internals.telemetry import record_event


class SupervisorGaveUp(RuntimeError):
    """The restart budget is exhausted; ``attempts`` holds per-attempt info."""

    def __init__(self, message: str, attempts: list[dict]):
        super().__init__(message)
        self.attempts = attempts


#: exit status of a coordinated elastic rescale (``elastic.RESCALE_EXIT_CODE``
#: — duplicated here so the supervisor has no import-order coupling with the
#: plane it relaunches; an assertion in tests pins the two together)
RESCALE_EXIT_CODE = 75


@dataclass
class SupervisorResult:
    restarts: int
    attempts: list[dict] = field(default_factory=list)
    log_paths: list[str] = field(default_factory=list)
    rescales: int = 0


class Supervisor:
    """Run ``program`` as a ``processes``-wide cluster with bounded restarts.

    Parameters mirror the CLI spawn contract; unset values come from the
    ``PATHWAY_*`` environment (``PathwayConfig``). ``log_dir`` captures each
    child's combined stdout/stderr to ``attempt<k>-p<pid>.log`` (otherwise
    children inherit the supervisor's streams). ``on_restart(attempt, codes)``
    runs after a failed attempt is torn down and before the backoff sleep —
    tests use it to snapshot output files at the crash point.
    """

    def __init__(
        self,
        program: Sequence[str],
        *,
        processes: int | None = None,
        threads: int | None = None,
        first_port: int | None = None,
        max_restarts: int | None = None,
        backoff_s: float | None = None,
        backoff_max_s: float = 30.0,
        env: dict[str, str] | None = None,
        log_dir: str | None = None,
        clear_fault_plan_after_failure: bool = True,
        poll_interval: float = 0.05,
        term_grace_s: float = 5.0,
        on_restart: Callable[[int, list[int | None]], Any] | None = None,
        storage: str | None = None,
        on_rescale: Callable[[int, int], Any] | None = None,
    ):
        cfg = get_pathway_config()
        self.program = list(program)
        if not self.program:
            raise ValueError("Supervisor needs a program argv")
        self.processes = processes if processes is not None else cfg.processes
        self.threads = threads if threads is not None else cfg.threads
        self.first_port = first_port if first_port is not None else cfg.first_port
        self.max_restarts = (
            max_restarts if max_restarts is not None else cfg.supervisor_max_restarts
        )
        self.backoff_s = backoff_s if backoff_s is not None else cfg.supervisor_backoff_s
        self.backoff_max_s = backoff_max_s
        self.env = dict(env) if env is not None else dict(os.environ)
        self.log_dir = log_dir
        self.clear_fault_plan_after_failure = clear_fault_plan_after_failure
        self.poll_interval = poll_interval
        self.term_grace_s = term_grace_s
        self.on_restart = on_restart
        #: persistence root holding the elastic membership table (defaults to
        #: the child env's PATHWAY_PERSISTENT_STORAGE) — read when an attempt
        #: exits with the rescale status to learn the new process count
        self.storage = storage if storage is not None else self.env.get(
            "PATHWAY_PERSISTENT_STORAGE"
        )
        self.on_rescale = on_rescale
        self.restarts = 0
        self.rescales = 0
        self.attempts: list[dict] = []

    # -- internals ------------------------------------------------------------
    def _child_env(self, pid: int, attempt: int) -> dict[str, str]:
        env = dict(self.env)
        env["PATHWAY_THREADS"] = str(self.threads)
        env["PATHWAY_PROCESSES"] = str(self.processes)
        env["PATHWAY_PROCESS_ID"] = str(pid)
        env["PATHWAY_FIRST_PORT"] = str(self.first_port)
        env["PATHWAY_SUPERVISOR_ATTEMPT"] = str(attempt)
        return env

    def _launch(self, attempt: int) -> tuple[list[subprocess.Popen], list[str]]:
        procs: list[subprocess.Popen] = []
        logs: list[str] = []
        for pid in range(self.processes):
            out: Any = None
            if self.log_dir is not None:
                os.makedirs(self.log_dir, exist_ok=True)
                path = os.path.join(self.log_dir, f"attempt{attempt}-p{pid}.log")
                logs.append(path)
                out = open(path, "w")
            try:
                procs.append(
                    subprocess.Popen(
                        self.program,
                        env=self._child_env(pid, attempt),
                        stdout=out,
                        stderr=subprocess.STDOUT if out is not None else None,
                    )
                )
            finally:
                if out is not None:
                    out.close()  # the child holds its own fd
        return procs, logs

    def _wait_attempt(
        self, procs: list[subprocess.Popen]
    ) -> tuple[list[int | None], list[int]]:
        """Block until all children exit cleanly or any fails; on failure,
        terminate the survivors (TERM, grace, KILL). Returns (final exit
        codes, processes that failed ON THEIR OWN) — the failed set is
        captured BEFORE the teardown, so survivors the supervisor itself
        SIGTERMs are not misreported as the cause.

        ``RESCALE_EXIT_CODE`` is not a failure: it is the coordinated
        elastic-rescale status every process adopts at the same barrier, so
        the loop simply waits for the stragglers (they are finishing the same
        quiesce) and returns clean."""
        while True:
            codes = [p.poll() for p in procs]
            failed = [
                i for i, c in enumerate(codes) if c not in (None, 0, RESCALE_EXIT_CODE)
            ]
            if failed:
                for p in procs:
                    if p.poll() is None:
                        p.terminate()
                deadline = _time.monotonic() + self.term_grace_s
                for p in procs:
                    if p.poll() is None:
                        timeout = max(0.0, deadline - _time.monotonic())
                        try:
                            p.wait(timeout=timeout)
                        except subprocess.TimeoutExpired:
                            p.kill()
                            p.wait()
                return [p.returncode for p in procs], failed
            if all(c is not None for c in codes):
                return codes, []
            _time.sleep(self.poll_interval)

    # -- public ---------------------------------------------------------------
    def run(self) -> SupervisorResult:
        all_logs: list[str] = []
        attempt = 0
        while True:
            t0_ns = _time.time_ns()
            procs, logs = self._launch(attempt)
            all_logs.extend(logs)
            codes, failed = self._wait_attempt(procs)
            rescale = not failed and any(c == RESCALE_EXIT_CODE for c in codes)
            info = {
                "attempt": attempt,
                "exit_codes": codes,
                "failed_processes": failed,
                "rescale": rescale,
                "start_ns": t0_ns,
                "end_ns": _time.time_ns(),
            }
            self.attempts.append(info)
            if rescale:
                # coordinated elastic rescale: the pod quiesced to a committed
                # epoch and published a new membership — relaunch at the new
                # shape immediately, spending neither restart budget nor
                # backoff (nothing failed)
                new_processes = self._rescale_target()
                record_event(
                    "elastic.rescale",
                    attempt=attempt,
                    from_processes=self.processes,
                    to_processes=new_processes,
                    rescales_so_far=self.rescales,
                )
                if self.on_rescale is not None:
                    self.on_rescale(self.processes, new_processes)
                self.processes = new_processes
                self.rescales += 1
                attempt += 1
                continue
            if not failed:
                self._export_trace()
                return SupervisorResult(
                    restarts=self.restarts,
                    attempts=self.attempts,
                    log_paths=all_logs,
                    rescales=self.rescales,
                )
            record_event(
                "resilience.restart",
                attempt=attempt,
                failed_process=failed[0],
                exit_code=int(codes[failed[0]] or 0),
                restarts_so_far=self.restarts,
            )
            # flight-recorder post-mortem (device plane): the supervisor is
            # the surviving authority on WHICH process failed and when —
            # dumped before the relaunch overwrites the evidence
            from pathway_tpu_torch.observability import device as _dev_prof

            _dev_prof.flight_note(
                "supervisor_restart",
                attempt=attempt,
                failed=failed,
                exit_codes=[c for c in codes],
            )
            _dev_prof.flight_dump(
                "supervisor_restart",
                extra={
                    "attempt": attempt,
                    "failed_processes": failed,
                    "exit_codes": codes,
                    "restarts_so_far": self.restarts,
                },
            )
            # rescale attempts spend no restart budget: only FAILED attempts
            # count against it
            failures = sum(1 for a in self.attempts if a["failed_processes"])
            if failures - 1 >= self.max_restarts:
                self._export_trace()
                raise SupervisorGaveUp(
                    f"cluster failed {failures} time(s) "
                    f"(processes {failed} exited {[codes[i] for i in failed]}); "
                    f"restart budget of {self.max_restarts} exhausted",
                    self.attempts,
                )
            if self.clear_fault_plan_after_failure:
                self.env.pop("PATHWAY_FAULT_PLAN", None)
            if self.on_restart is not None:
                self.on_restart(attempt, codes)
            delay = min(self.backoff_s * (2**attempt), self.backoff_max_s)
            if delay > 0:
                _time.sleep(delay)
            self.restarts += 1
            attempt += 1

    def _rescale_target(self) -> int:
        """New process count from the committed membership table (the
        coordinator published it before exiting with the rescale status).
        ``storage`` may be a filesystem path (the PATHWAY_PERSISTENT_STORAGE
        default), a ``persistence.Backend`` config (S3 and friends), or a raw
        ``KVBackend``."""
        if self.storage is None or self.storage == "":
            raise SupervisorGaveUp(
                "cluster exited with the elastic rescale status but the "
                "supervisor has no persistence root to read the membership "
                "table from; pass storage= (path, persistence.Backend, or "
                "KVBackend) or set PATHWAY_PERSISTENT_STORAGE in the child "
                "environment",
                self.attempts,
            )
        from pathway_tpu_torch.elastic import read_membership
        from pathway_tpu_torch.persistence.backends import (
            FileBackend,
            KVBackend,
            backend_from_config,
        )

        if isinstance(self.storage, KVBackend):
            backend = self.storage
        elif isinstance(self.storage, str):
            backend = FileBackend(self.storage)
        else:
            backend = backend_from_config(self.storage)
        m = read_membership(backend)
        if m is None:
            raise SupervisorGaveUp(
                f"cluster exited with the elastic rescale status but "
                f"{self.storage!r} holds no membership table — the "
                "coordinator died between the decision and the commit; "
                "relaunch at the previous shape manually",
                self.attempts,
            )
        return m.processes

    def _export_trace(self) -> None:
        """One span per attempt in an OTLP/JSON doc next to the run traces."""
        from pathway_tpu_torch.internals import telemetry as _telemetry

        path = _telemetry.trace_file()
        if not path or not self.attempts:
            return
        try:
            spans = [
                (
                    "supervisor.attempt",
                    a["start_ns"],
                    a["end_ns"],
                    {
                        "pathway.supervisor.attempt": a["attempt"],
                        "pathway.supervisor.failed": bool(a["failed_processes"]),
                        "pathway.supervisor.exit_codes": str(a["exit_codes"]),
                    },
                )
                for a in self.attempts
            ]
            _telemetry.export_spans(
                f"{path}.supervisor", spans, root_name="pathway.supervise"
            )
        except Exception:
            import logging

            logging.getLogger(__name__).warning(
                "supervisor trace export failed", exc_info=True
            )


def supervise(program: Sequence[str], **kwargs: Any) -> SupervisorResult:
    """Convenience wrapper: ``resilience.supervise([sys.executable, "p.py"])``."""
    return Supervisor(program, **kwargs).run()


def main(argv: Sequence[str] | None = None) -> int:  # pragma: no cover - CLI glue
    argv = list(sys.argv[1:] if argv is None else argv)
    try:
        Supervisor(argv).run()
        return 0
    except SupervisorGaveUp as e:
        print(f"pathway_tpu_torch supervisor: {e}", file=sys.stderr)
        return 1
