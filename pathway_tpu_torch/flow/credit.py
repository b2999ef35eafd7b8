"""Credit-based bounded ingest queues.

The reference's connector queues (and this repo's ``StreamInputNode._pending``
before r9) grow without limit: a stalled or slow graph lets a fast producer
take host memory down. This module is the credit half of the flow plane
(cf. Naiad's progress-driven backpressure, Murray et al., SOSP '13): every
connector input owns an :class:`IngestGate` with ``bound`` credits —

- a push **consumes** one credit per row; with the ``block`` policy the
  producer thread waits for credit (classic backpressure), with ``shed`` the
  overflow is dropped and **counted** (explicit, telemetry-visible load
  shedding instead of silent memory growth);
- ``poll`` moves drained rows from *queued* to *in-flight*;
- credits **replenish when the tick that drained the rows completes** — the
  whole downstream consequence of the rows has been processed, so admitting
  more cannot grow memory beyond ``queued + in_flight <= bound``;
- a retraction that cancels a still-queued insert *returns* the insert's
  credit (the pair never reaches the engine, so it never held real work);
- a remote-pressure scale (set from cluster heartbeat aggregation) shrinks the
  effective bound so a slow peer throttles every producer in the pod instead
  of OOMing one host.

Locking: the gate's condition variable is never held while touching the
node's ``_lock`` and vice versa — producers acquire credit first, then append
under the node lock; the drain path updates counters after releasing it.

Carried from ``pathway_tpu/flow/credit.py`` with imports rewritten.
"""

from __future__ import annotations

import threading
import time as _time
from typing import Any

#: producer wait granularity while blocked on credit — also the latency with
#: which a closed gate (run teardown) releases a blocked connector thread
_BLOCK_POLL_S = 0.05


class IngestGate:
    """Bounded credit queue guarding one connector input node."""

    __slots__ = (
        "node",
        "bound",
        "policy",
        "queued",
        "in_flight",
        "admitted_rows",
        "shed_rows",
        "cancelled_rows",
        "blocked_ns",
        "budget",
        "remote_scale",
        "closed",
        "_cond",
    )

    def __init__(self, node: Any, bound: int, policy: str):
        self.node = node
        self.bound = int(bound)
        self.policy = policy  # "block" | "shed"
        self.queued = 0  # rows currently in the node's pending queue
        self.in_flight = 0  # rows drained at poll, tick not yet complete
        self.admitted_rows = 0
        self.shed_rows = 0
        self.cancelled_rows = 0
        self.blocked_ns = 0  # total producer wait for credit (telemetry)
        #: per-tick admission budget set by the scheduler (None = admit all);
        #: read by ``StreamInputNode.poll``, written by ``AdmissionScheduler``
        self.budget: int | None = None
        #: cluster pressure scale in (0, 1]: effective bound = bound * scale
        self.remote_scale = 1.0
        self.closed = False
        self._cond = threading.Condition()

    # ------------------------------------------------------------------ sizing
    def effective_bound(self) -> int:
        return max(1, int(self.bound * self.remote_scale))

    def available(self) -> int:
        return self.effective_bound() - self.queued - self.in_flight

    def chunk_rows(self) -> int:
        """Largest push chunk that can ever fit: block-policy producers wait
        for the WHOLE chunk's credit, so a chunk must not exceed the bound."""
        return self.effective_bound()

    # ----------------------------------------------------------------- produce
    def admit(self, n: int) -> int:
        """Acquire credit for ``n`` rows (``n <= chunk_rows()``): returns how
        many the caller may append. ``block``: waits until all ``n`` fit (or
        the gate closes — teardown admits unconditionally so producers never
        deadlock a shutdown). ``shed``: admits what fits now, counts the rest
        as shed."""
        if n <= 0:
            return 0
        with self._cond:
            if self.policy == "shed" and not self.closed:
                take = min(n, max(0, self.available()))
                self.shed_rows += n - take
                self.queued += take
                self.admitted_rows += take
                return take
            t0 = None
            # wait target capped at the CURRENT effective bound: cluster
            # pressure may shrink it below a chunk sized under the old bound,
            # and waiting for more room than the bound allows would deadlock
            # the producer (transient occupancy then peaks at the old bound)
            while not self.closed and self.available() < min(
                n, self.effective_bound()
            ):
                if t0 is None:
                    t0 = _time.perf_counter_ns()
                self._cond.wait(_BLOCK_POLL_S)
            if t0 is not None:
                self.blocked_ns += _time.perf_counter_ns() - t0
            self.queued += n
            self.admitted_rows += n
            return n

    def try_admit(self, n: int = 1) -> bool:
        """Non-blocking admission for latency-bound callers (the REST front
        door's event loop must neither wait for credit nor have a push shed
        silently after registering a response future): take ``n`` credits if
        available RIGHT NOW, else refuse — the caller sheds with an explicit
        429. A refused caller has consumed nothing."""
        with self._cond:
            if self.closed or self.available() < n:
                return False
            self.queued += n
            self.admitted_rows += n
            return True

    def admit_retract(self) -> int:
        """Admit a retraction without ever DROPPING it: the matching insert is
        already in downstream state, so a shed retract would leave a phantom
        row forever. Block policy waits for ordinary credit (a retract then
        occupies one slot like any event). Shed policy admits past the bound
        up to 2× of it — retracts shrink downstream state, so modest overflow
        is safe — and BLOCKS beyond that, keeping memory bounded even under a
        retract storm against a stalled graph (the queued+in_flight invariant
        for shed mode is therefore ``<= 2 * bound``)."""
        if not self.closed and self.policy != "shed":
            return self.admit(1)
        t0 = None
        with self._cond:
            while (
                not self.closed
                and self.queued + self.in_flight >= 2 * self.effective_bound()
            ):
                if t0 is None:
                    t0 = _time.perf_counter_ns()
                self._cond.wait(_BLOCK_POLL_S)
            if t0 is not None:
                self.blocked_ns += _time.perf_counter_ns() - t0
            self.queued += 1
            self.admitted_rows += 1
            return 1

    def note_absorbed_retract(self) -> None:
        """A retract of a SHED insert was absorbed before reaching the queue
        (see ``StreamInputNode._absorb_shed_retract``): count it as shed so
        ``produced == admitted + shed`` stays exact."""
        with self._cond:
            self.shed_rows += 1

    def cancel(self, n: int = 1) -> None:
        """A still-queued insert was cancelled by its retraction: return its
        credit immediately (the pair never consumed downstream capacity)."""
        with self._cond:
            self.queued = max(0, self.queued - n)
            self.cancelled_rows += n
            self._cond.notify_all()

    # ------------------------------------------------------------------- drain
    def on_drain(self, n: int) -> None:
        """``poll`` moved ``n`` rows out of the queue into the running tick."""
        if n <= 0:
            return
        with self._cond:
            self.queued = max(0, self.queued - n)
            self.in_flight += n

    def on_tick_complete(self) -> None:
        """The tick that drained the in-flight rows ran to quiescence: their
        credits return and blocked producers wake."""
        with self._cond:
            if self.in_flight or self.closed:
                self.in_flight = 0
                self._cond.notify_all()

    def set_remote_scale(self, scale: float) -> None:
        """Cluster pressure propagation: shrink (or restore) the effective
        bound. Growing it frees credit, so blocked producers are notified."""
        scale = min(1.0, max(0.05, float(scale)))
        with self._cond:
            grew = scale > self.remote_scale
            self.remote_scale = scale
            if grew:
                self._cond.notify_all()

    # ---------------------------------------------------------------- lifecycle
    def close(self) -> None:
        with self._cond:
            self.closed = True
            self._cond.notify_all()

    # ---------------------------------------------------------------- telemetry
    def snapshot(self) -> dict[str, Any]:
        node = self.node
        return {
            "input": f"{getattr(node, 'input_name', None) or getattr(node, 'name', 'input')}"
            f":{getattr(node, 'node_index', -1)}",
            "service_class": getattr(node, "service_class", "interactive"),
            "bound": self.bound,
            "effective_bound": self.effective_bound(),
            "queued": self.queued,
            "in_flight": self.in_flight,
            "admitted_rows": self.admitted_rows,
            "shed_rows": self.shed_rows,
            "cancelled_rows": self.cancelled_rows,
            "blocked_ms": round(self.blocked_ns / 1e6, 3),
            "budget": self.budget,
        }
