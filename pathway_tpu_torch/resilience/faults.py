"""Fault injection for recovery testing (``PATHWAY_FAULT_PLAN``).

The reference tests fault tolerance by killing a worker subprocess mid-run
(``integration_tests/wordcount`` recovery harness, SURVEY §5.4). This module
makes that reproducible and scriptable: a :class:`FaultPlan` names exact
injection points the runtimes consult on their hot paths, so both the recovery
test-suite and users chaos-testing a deployment can drive the SAME machinery.

Plan syntax (``;``-separated steps, each ``action:key=val,key=val``)::

    kill:proc=1,tick=40              # SIGKILL process 1 at the start of tick 40
    drop_poll:proc=0,tick=3,count=2  # drop connector polls for 2 ticks from t=3
    delay_barrier:proc=0,tick=4,ms=250,count=1  # delay 1 barrier call >=t4
    flip_diff:proc=0,tick=3          # negate one polled row's diff sign at t>=3
    drop_retract:proc=0,tick=3       # drop one polled retraction row at t>=3
    kill_point:point=delivery_staged  # SIGKILL at the Nth (count=) pass of a
                                      # named code point (faults.at_point)

Semantics:

- ``kill`` fires when the process's run loop reaches EXACTLY ``tick`` (ticks
  are sequential integers, so the match is deterministic) and SIGKILLs the
  process — no atexit, no flush: the hard-crash case.
- ``drop_poll`` suppresses connector polling for ``count`` consecutive ticks
  starting at ``tick`` (events buffer upstream; the pipeline sees a stalled
  source, the latency/recovery path a burst).
- ``delay_barrier`` sleeps ``ms`` before the next ``count`` barrier
  participations at or after ``tick`` (simulates a slow/hung peer without
  killing it — the heartbeat-timeout detection path).
- ``kill_point`` SIGKILLs at a NAMED code point instead of a tick boundary —
  subsystems bracket their crash windows with ``faults.at_point("<name>")``
  (e.g. the delivery plane's ``delivery_staged`` between the durable output
  stage and the manifest commit). ``count=N`` fires on the Nth pass.
- ``flip_diff`` / ``drop_retract`` are **data-plane corruptions** for testing
  the audit plane (``PATHWAY_AUDIT``) end-to-end: applied to freshly polled
  input blocks AFTER the connector/upsert machinery but BEFORE the audit
  monitors and the engine see them — exactly where a real corruption bug
  would live. ``flip_diff`` negates one row's diff sign (an insert becomes an
  unmatched retraction); ``drop_retract`` removes one retraction row (its
  insert stays live downstream forever). Each fires ``count`` times (default
  1), at the first eligible poll at or after ``tick`` — ``drop_retract``
  keeps scanning later ticks until a retraction actually appears.

``proc`` omitted means "any process". Every fired fault records a
``resilience.fault_*`` telemetry event (except ``kill``, which can only
print to stderr before dying).

Carried from ``pathway_tpu/resilience/faults.py`` unchanged.
"""

from __future__ import annotations

import os
import signal
import sys
import time as _time
from dataclasses import dataclass, field


@dataclass
class FaultSpec:
    action: str  # kill | drop_poll | delay_barrier | kill_point | ...
    proc: int | None = None  # None = any process
    tick: int = 0
    count: int = 1
    ms: float = 0.0
    point: str = ""  # kill_point: the named code point to fire at
    remaining: int = field(default=-1, repr=False)  # -1 = init from count

    def __post_init__(self) -> None:
        if self.remaining < 0:
            self.remaining = self.count

    def matches_proc(self, proc: int) -> bool:
        return self.proc is None or self.proc == proc


_ACTIONS = (
    "kill",
    "drop_poll",
    "delay_barrier",
    "flip_diff",
    "drop_retract",
    "kill_point",
)


class FaultPlan:
    """A parsed list of :class:`FaultSpec` steps with firing state."""

    def __init__(self, specs: list[FaultSpec] | None = None):
        self.specs = list(specs or [])

    # -- construction ---------------------------------------------------------
    @classmethod
    def parse(cls, text: str | None) -> "FaultPlan":
        specs: list[FaultSpec] = []
        for step in (text or "").split(";"):
            step = step.strip()
            if not step:
                continue
            action, _, kvs = step.partition(":")
            action = action.strip()
            if action not in _ACTIONS:
                raise ValueError(
                    f"unknown fault action {action!r} (expected one of {_ACTIONS})"
                )
            kwargs: dict = {}
            for kv in kvs.split(","):
                kv = kv.strip()
                if not kv:
                    continue
                k, _, v = kv.partition("=")
                k = k.strip()
                if k == "proc":
                    kwargs["proc"] = int(v)
                elif k == "tick":
                    kwargs["tick"] = int(v)
                elif k == "count":
                    kwargs["count"] = int(v)
                elif k == "ms":
                    kwargs["ms"] = float(v)
                elif k == "point":
                    kwargs["point"] = v.strip()
                else:
                    raise ValueError(f"unknown fault option {k!r} in {step!r}")
            if action == "kill_point" and not kwargs.get("point"):
                raise ValueError(f"kill_point requires point= in {step!r}")
            specs.append(FaultSpec(action=action, **kwargs))
        return cls(specs)

    @classmethod
    def from_env(cls) -> "FaultPlan | None":
        text = os.environ.get("PATHWAY_FAULT_PLAN")
        if not text:
            return None
        return cls.parse(text)

    def to_env(self) -> str:
        """Serialize back to the ``PATHWAY_FAULT_PLAN`` syntax (for Supervisor
        child envs)."""
        steps = []
        for s in self.specs:
            kvs = []
            if s.proc is not None:
                kvs.append(f"proc={s.proc}")
            if s.action == "kill_point":
                kvs.append(f"point={s.point}")
            else:
                kvs.append(f"tick={s.tick}")
            if s.count != 1:
                kvs.append(f"count={s.count}")
            if s.ms:
                kvs.append(f"ms={s.ms:g}")
            steps.append(f"{s.action}:{','.join(kvs)}")
        return ";".join(steps)

    # -- firing ---------------------------------------------------------------
    def should_kill(self, proc: int, tick: int) -> bool:
        return any(
            s.action == "kill" and s.matches_proc(proc) and tick == s.tick
            for s in self.specs
        )

    def should_drop_poll(self, proc: int, tick: int) -> FaultSpec | None:
        for s in self.specs:
            if (
                s.action == "drop_poll"
                and s.matches_proc(proc)
                and s.tick <= tick < s.tick + s.count
            ):
                return s
        return None

    def take_corruption(self, proc: int, tick: int, has_retract: bool) -> FaultSpec | None:
        """One data-corruption firing for this (proc, tick), or None.
        ``drop_retract`` only fires when the polled block actually carries a
        retraction (it keeps waiting at later ticks otherwise)."""
        for s in self.specs:
            if (
                s.action in ("flip_diff", "drop_retract")
                and s.matches_proc(proc)
                and tick >= s.tick
                and s.remaining > 0
            ):
                if s.action == "drop_retract" and not has_retract:
                    continue
                s.remaining -= 1
                return s
        return None

    def take_point_kill(self, name: str, proc: int) -> FaultSpec | None:
        """One ``kill_point`` firing for this named code point (``count=N``
        fires on the Nth pass), or None."""
        for s in self.specs:
            if (
                s.action == "kill_point"
                and s.point == name
                and s.matches_proc(proc)
                and s.remaining > 0
            ):
                s.remaining -= 1
                if s.remaining == 0:
                    return s
        return None

    def take_barrier_delay(self, proc: int, tick: int) -> FaultSpec | None:
        for s in self.specs:
            if (
                s.action == "delay_barrier"
                and s.matches_proc(proc)
                and tick >= s.tick
                and s.remaining > 0
            ):
                s.remaining -= 1
                return s
        return None


# -- per-process active plan ---------------------------------------------------
# The run loops install the env plan at start (re-parsed each run, so firing
# state resets); hooks are no-ops when no plan is active (a single attribute
# read on the hot path). A manually installed plan (tests) takes precedence
# until cleared with install(None).

_active: FaultPlan | None = None
_manual = False


def install_from_env(force: bool = False) -> FaultPlan | None:
    global _active
    if _manual and not force:
        return _active
    _active = FaultPlan.from_env()
    return _active


def install(plan: FaultPlan | None) -> None:
    """Tests: install a plan directly (bypassing the env)."""
    global _active, _manual
    _active = plan
    _manual = plan is not None


def active() -> FaultPlan | None:
    return _active


def on_tick_start(proc: int, tick: int) -> bool:
    """Run-loop hook: may SIGKILL this process; returns True when connector
    polling should be dropped for this tick."""
    plan = _active
    if plan is None:
        return False
    if plan.should_kill(proc, tick):
        print(
            f"pathway_tpu_torch fault injection: SIGKILL process {proc} at tick {tick}",
            file=sys.stderr,
            flush=True,
        )
        os.kill(os.getpid(), signal.SIGKILL)
    spec = plan.should_drop_poll(proc, tick)
    if spec is not None:
        from pathway_tpu_torch.internals.telemetry import record_event

        record_event("resilience.fault_drop_poll", proc=proc, tick=tick)
        return True
    return False


def at_point(name: str, proc: int | None = None) -> None:
    """Named-crash-window hook: SIGKILLs this process when the active plan has
    a matching ``kill_point`` step. Subsystems call this to bracket windows
    that tick-addressed kills cannot hit deterministically (e.g. between the
    delivery plane's durable stage and the manifest commit). No plan = one
    attribute read."""
    plan = _active
    if plan is None:
        return
    if proc is None:
        proc = int(os.environ.get("PATHWAY_PROCESS_ID", "0") or 0)
    spec = plan.take_point_kill(name, proc)
    if spec is not None:
        print(
            f"pathway_tpu_torch fault injection: SIGKILL process {proc} "
            f"at point {name!r}",
            file=sys.stderr,
            flush=True,
        )
        os.kill(os.getpid(), signal.SIGKILL)


def corrupt_polled(proc: int, tick: int, batches: list) -> list:
    """Data-corruption hook on freshly polled input blocks (every runtime's
    poll loop): applies at most one ``flip_diff`` / ``drop_retract`` firing.
    No plan (the overwhelmingly common case) is one attribute read."""
    plan = _active
    if plan is None or not batches:
        return batches
    has_retract = any(
        b is not None and len(b) and bool((b.diffs < 0).any()) for b in batches
    )
    spec = plan.take_corruption(proc, tick, has_retract)
    if spec is None:
        return batches
    import numpy as _np

    from pathway_tpu_torch.internals.telemetry import record_event

    out = []
    pending = spec.action
    for b in batches:
        if pending is None or b is None or not len(b):
            out.append(b)
            continue
        if pending == "flip_diff":
            diffs = b.diffs.copy()
            diffs[0] = -diffs[0]
            b = type(b)(b.keys, diffs, b.data, b.time)
            record_event(
                "resilience.fault_flip_diff", proc=proc, tick=tick,
                key=int(b.keys[0]),
            )
            pending = None
        elif pending == "drop_retract":
            rets = _np.flatnonzero(b.diffs < 0)
            if len(rets):
                key = int(b.keys[rets[0]])
                keep = _np.ones(len(b), dtype=bool)
                keep[rets[0]] = False
                b = b.take(_np.flatnonzero(keep))
                record_event(
                    "resilience.fault_drop_retract", proc=proc, tick=tick, key=key
                )
                pending = None
        out.append(b)
    return out


def before_barrier(proc: int, tick: int) -> None:
    """Barrier hook: may delay this process's barrier participation."""
    plan = _active
    if plan is None:
        return
    spec = plan.take_barrier_delay(proc, tick)
    if spec is not None and spec.ms > 0:
        from pathway_tpu_torch.internals.telemetry import record_event

        record_event(
            "resilience.fault_delay_barrier", proc=proc, tick=tick, ms=spec.ms
        )
        _time.sleep(spec.ms / 1000.0)
