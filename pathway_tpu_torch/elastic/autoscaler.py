"""Pressure-driven autoscaling policy: when to grow, when to shrink.

The r9 flow plane already *measures* saturation — the coordinator merges every
peer's heartbeat-piggybacked gate occupancy with its own AIMD controller into
one pod-pressure scalar each tick, and the r8 metrics plane keeps cumulative
sink-latency histograms. This module closes the loop the ROADMAP asked for:
the Supervisor-facing policy that turns those signals into join/drain
decisions, with the three stabilizers any production autoscaler needs:

- **hysteresis** — separate high/low thresholds with a no-decision band
  between them, and a decision fires only after ``sustain_ticks`` consecutive
  readings beyond a threshold (one flooded tick is noise, a run is a trend;
  a single in-band reading resets the streak);
- **bounds** — ``min_processes``/``max_processes`` clamp every decision;
- **cooldown** — after any decision (including a manual one) the policy
  sleeps ``cooldown_s``: a freshly relaunched pod replays state and its
  early pressure readings mean nothing.

Sink p99 vs the latency SLO joins pressure as an OR'd saturation signal: a pod
whose queues are shallow but whose interactive p99 breached the SLO is still
saturated where it matters. The p99 is the positional delta of the cumulative
log-2 histograms (the r9 controller's windowing trick), tracked with this
module's own cursor so it never perturbs the AIMD controller's window.

Decisions are *advisory*: the policy returns a target process count; the
elastic plane turns it into a membership commit + coordinated rescale exit
(``elastic/__init__.py``), and every decision lands in a bounded ring for
/status and the live trace.
"""

from __future__ import annotations

import time as _time
from collections import deque
from typing import Any


class AutoscalerPolicy:
    def __init__(
        self,
        *,
        min_processes: int = 1,
        max_processes: int = 8,
        high_pressure: float = 0.75,
        low_pressure: float = 0.05,
        sustain_ticks: int = 50,
        cooldown_s: float = 30.0,
        slo_ms: float = 250.0,
        decisions_kept: int = 64,
    ):
        if low_pressure >= high_pressure:
            raise ValueError(
                f"low_pressure ({low_pressure}) must sit below high_pressure "
                f"({high_pressure}) — the band between them is the hysteresis zone"
            )
        self.min_processes = max(1, int(min_processes))
        self.max_processes = max(self.min_processes, int(max_processes))
        self.high_pressure = high_pressure
        self.low_pressure = low_pressure
        self.sustain_ticks = max(1, int(sustain_ticks))
        self.cooldown_s = max(0.0, cooldown_s)
        self.slo_s = slo_ms / 1000.0
        self.high_streak = 0
        self.low_streak = 0
        self.last_decision_at: float | None = None
        self.decisions: deque[dict[str, Any]] = deque(maxlen=decisions_kept)
        # windowed-p99 cursor over the cumulative sink histograms — OWN state,
        # disjoint from the AIMD controller's (both consume positional deltas
        # of the same monotonic counters, so neither perturbs the other)
        self._last_counts: dict[str, list[int]] = {}

    # ---------------------------------------------------------------- signals
    @staticmethod
    def _pad_sum(a: list[int], b: list[int], sign: int = 1) -> list[int]:
        """Element-wise a + sign*b, zero-padded to the longer list — counts
        lists can grow as observations land in new high buckets, and a
        truncating zip would drop exactly the tail a p99 measures."""
        n = max(len(a), len(b))
        a = a + [0] * (n - len(a))
        b = b + [0] * (n - len(b))
        return [x + sign * y for x, y in zip(a, b)]

    def windowed_p99_s(self) -> float | None:
        """p99 of sink latency observed since the last call (positional delta
        of the cumulative log-2 histograms in ``run_metrics()``)."""
        from pathway_tpu_torch.observability.metrics import Histogram, run_metrics

        merged: list[int] | None = None
        for label, snap in run_metrics().sink_snapshots().items():
            prev = self._last_counts.get(label)
            counts = list(snap["counts"])
            delta = counts if prev is None else self._pad_sum(counts, prev, -1)
            self._last_counts[label] = counts
            merged = delta if merged is None else self._pad_sum(merged, delta)
        if merged is None:
            return None
        total = sum(merged)
        if total <= 0:
            return None
        v = Histogram.quantile({"counts": merged, "count": total}, 0.99)
        return None if v is None or v == float("inf") else v

    # --------------------------------------------------------------- decision
    def observe(
        self,
        n_processes: int,
        pressure: float | None,
        p99_s: float | None = None,
        now: float | None = None,
        tick: int | None = None,
    ) -> dict[str, Any] | None:
        """Fold one tick's signals; return ``{"target", "reason", ...}`` when a
        scale decision fires, else None."""
        if pressure is None:
            return None
        now = _time.monotonic() if now is None else now
        saturated = pressure >= self.high_pressure or (
            p99_s is not None and p99_s > self.slo_s
        )
        idle = pressure <= self.low_pressure and (
            p99_s is None or p99_s <= self.slo_s
        )
        if (
            self.last_decision_at is not None
            and now - self.last_decision_at < self.cooldown_s
        ):
            # streaks hold at zero through the cooldown: a decision right at
            # expiry must rest on FRESH sustained evidence, not on readings
            # taken while the relaunched pod was still warming
            self.high_streak = 0
            self.low_streak = 0
            return None
        self.high_streak = self.high_streak + 1 if saturated else 0
        self.low_streak = self.low_streak + 1 if idle else 0
        decision: dict[str, Any] | None = None
        if self.high_streak >= self.sustain_ticks and n_processes < self.max_processes:
            decision = {
                "target": n_processes + 1,
                "reason": "autoscale_join",
                "streak": self.high_streak,
            }
        elif self.low_streak >= self.sustain_ticks and n_processes > self.min_processes:
            decision = {
                "target": n_processes - 1,
                "reason": "autoscale_drain",
                "streak": self.low_streak,
            }
        if decision is None:
            return None
        decision.update(
            {
                "from": n_processes,
                "pressure": round(pressure, 4),
                "p99_ms": round(p99_s * 1000.0, 3) if p99_s is not None else None,
                "tick": tick,
                "at_unix": _time.time(),
            }
        )
        self.note_decision(now)
        self.decisions.append(decision)
        return decision

    def note_decision(self, now: float | None = None) -> None:
        """Start the cooldown (manual decisions call this too, so an operator
        scale isn't immediately second-guessed by the policy)."""
        self.last_decision_at = _time.monotonic() if now is None else now
        self.high_streak = 0
        self.low_streak = 0

    def status(self) -> dict[str, Any]:
        return {
            "min_processes": self.min_processes,
            "max_processes": self.max_processes,
            "high_pressure": self.high_pressure,
            "low_pressure": self.low_pressure,
            "sustain_ticks": self.sustain_ticks,
            "cooldown_s": self.cooldown_s,
            "high_streak": self.high_streak,
            "low_streak": self.low_streak,
            "cooling_down": (
                self.last_decision_at is not None
                and _time.monotonic() - self.last_decision_at < self.cooldown_s
            ),
            "decisions": list(self.decisions),
        }
