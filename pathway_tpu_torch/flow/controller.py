"""Feedback-tuned microbatching: the AIMD bucket controller.

r6 fixed the microbatch launch shape at ``PATHWAY_MICROBATCH_MAX_BATCH`` —
right for throughput, wrong when a latency objective exists: holding rows to
fill a 512-bucket adds queueing delay exactly when sinks are already close to
their SLO. This controller closes the loop the r8 observability plane opened,
the way DS2 (Kalavri et al., OSDI '18) derives rate decisions from *measured*
operator throughput rather than static configuration:

- **inputs**, read once per tick: the recent-window p99 of the interactive
  sinks' end-to-end latency histograms (delta of the cumulative log-2 bucket
  counts since the last step — a sliding window without extra hot-path
  bookkeeping), total backlog rows (ingest queues + cross-tick microbatch
  buffers), and ingest-queue occupancy ratio;
- **output**: ``target`` — the microbatch launch bucket the dispatcher may
  use this tick, a power of two in ``[min_bucket, max_bucket]`` — and
  ``pressure`` in [0, 1], consumed by the admission scheduler and (via the
  cluster heartbeat plane) by every peer's gates.

AIMD in log-bucket space: one bucket step **up** (×2) when backlog outgrows
the current target while latency is healthy (throughput mode — bigger
launches amortize dispatch), one step **down** (÷2) when the windowed p99
crosses the SLO (latency mode — smaller launches flush sooner). The buckets
are the power-of-two launch shapes the microbatcher already uses, and the
port's ops give a row the same bits in any of them
(``tools/batch_invariance.py``), so retuning changes launch shapes, never
values.

Every decision is recorded (bounded ring, ``/status``) and emitted as a
``flow/controller`` span when the tick is sampled, so ``/trace`` shows *why*
each bucket choice was made.

Carried from ``pathway_tpu/flow/controller.py`` with imports rewritten.
"""

from __future__ import annotations

import time as _time
from collections import deque
from typing import Any

from pathway_tpu_torch.observability.metrics import Histogram

#: latency ratio above which backlog growth no longer triggers an increase —
#: the guard band that keeps AIMD from oscillating straight through the SLO
_INCREASE_GUARD = 0.8


class AimdController:
    def __init__(
        self,
        slo_ms: float,
        min_bucket: int = 8,
        max_bucket: int = 512,
        decisions_kept: int = 256,
    ):
        self.slo_s = slo_ms / 1000.0
        self.min_bucket = max(1, int(min_bucket))
        self.max_bucket = max(self.min_bucket, int(max_bucket))
        # start at max = the static r6 behavior, so an unpressured pipeline
        # with the plane on is byte-identical in launch shapes to plane-off
        self.target = self.max_bucket
        self.pressure = 0.0
        self.decisions: deque[dict[str, Any]] = deque(maxlen=decisions_kept)
        self._last_counts: dict[str, list[int]] = {}
        # watched-label cache: the graph (and every sink's service class) is
        # immutable for the life of a run, so the O(graph) walk runs once
        self._watched_cache: set[str] | None = None
        self._watched_resolved = False

    # ------------------------------------------------------------------ probes
    def _watched_sink_labels(self, scheduler) -> set[str] | None:
        """Sinks whose latency the SLO governs: the ``interactive``-class
        subscribe/output nodes. None (no graph information, e.g. unit
        contexts) = watch every sink; a graph whose sinks are ALL bulk yields
        an empty set — no sink drags the bucket down."""
        if self._watched_resolved:
            return self._watched_cache
        from pathway_tpu_torch.observability.metrics import iter_graphs

        labels: set[str] = set()
        saw_sink = False
        for g in iter_graphs(scheduler):
            for node in g.nodes:
                if getattr(node, "is_sink", False):
                    saw_sink = True
                    if getattr(node, "service_class", "interactive") == "interactive":
                        labels.add(f"{node.name}:{node.node_index}")
        result = labels if saw_sink else None
        if scheduler is not None:
            # cache only once a real graph was inspected (unit contexts pass
            # None and must not pin the no-graph fallback)
            self._watched_cache = result
            self._watched_resolved = True
        return result

    def _window_p99_s(self, scheduler) -> float | None:
        """p99 over the sink-latency observations recorded SINCE the last
        step: positional delta of the cumulative histogram counts (fixed
        log-2 buckets, so the delta is itself a histogram)."""
        from pathway_tpu_torch.observability.metrics import run_metrics

        watched = self._watched_sink_labels(scheduler)
        merged: list[int] | None = None
        snaps = run_metrics().sink_snapshots()
        for label, snap in snaps.items():
            if watched is not None and label not in watched:
                continue
            prev = self._last_counts.get(label)
            counts = snap["counts"]
            delta = (
                list(counts)
                if prev is None
                else [c - p for c, p in zip(counts, prev)]
            )
            self._last_counts[label] = list(counts)
            if merged is None:
                merged = delta
            else:
                merged = [a + b for a, b in zip(merged, delta)]
        if merged is None:
            return None
        total = sum(merged)
        if total <= 0:
            return None
        return Histogram.quantile({"counts": merged, "count": total}, 0.99)

    # -------------------------------------------------------------------- step
    def step(self, scheduler, tick: int, gates: list[Any], tracer=None) -> None:
        from pathway_tpu_torch.observability.metrics import backlog_gauges

        backlog = sum(b["rows"] for b in backlog_gauges(scheduler))
        p99_s = self._window_p99_s(scheduler)
        lat_ratio = None if p99_s is None else p99_s / self.slo_s
        # occupancy pressure counts INTERACTIVE gates only: a bulk queue
        # sitting at its bound is normal steady-state backpressure (the bound
        # already caps memory), and letting it feed pressure would make a
        # pure-backfill pipeline throttle ITSELF to the bulk minimum forever
        queue_ratio = 0.0
        for g in gates:
            if getattr(g.node, "service_class", "interactive") != "interactive":
                continue
            # ratio against the UNSCALED bound: dividing by the cluster-scaled
            # effective bound would make a scale-down inflate the reported
            # ratio, ratcheting pod pressure to 1.0 from moderate load
            # (positive feedback through the heartbeat merge)
            if g.bound > 0:
                queue_ratio = max(queue_ratio, (g.queued + g.in_flight) / g.bound)

        old = self.target
        if lat_ratio is not None and lat_ratio > 1.0:
            # multiplicative decrease: sinks past the objective — flush smaller
            self.target = max(self.min_bucket, self.target // 2)
            action = "decrease"
        elif (
            backlog > self.target
            and self.target < self.max_bucket
            and (lat_ratio is None or lat_ratio <= _INCREASE_GUARD)
        ):
            # one bucket step up: backlog outgrew the launch shape and latency
            # has headroom — amortize dispatch over bigger launches
            self.target = min(self.max_bucket, self.target * 2)
            action = "increase"
        else:
            action = "hold"

        # pressure: how endangered the deadline is, blended with how full the
        # ingest queues are (either alone can OOM/violate first)
        self.pressure = max(
            min(1.0, lat_ratio) if lat_ratio is not None else 0.0,
            min(1.0, queue_ratio),
        )

        decision = {
            "tick": tick,
            "action": action,
            "target": self.target,
            "prev_target": old,
            "p99_ms": None if p99_s is None else round(p99_s * 1e3, 3),
            "backlog_rows": backlog,
            "queue_ratio": round(queue_ratio, 4),
            "pressure": round(self.pressure, 4),
        }
        self.decisions.append(decision)
        if tracer is not None and tracer.tick_span_id is not None:
            now = _time.time_ns()
            tracer.span(
                "flow/controller",
                now,
                now,
                {
                    "pathway.flow.action": action,
                    "pathway.flow.target": self.target,
                    "pathway.flow.pressure": round(self.pressure, 4),
                    "pathway.flow.backlog_rows": backlog,
                    "pathway.flow.p99_ms": decision["p99_ms"] or 0.0,
                },
            )

    # --------------------------------------------------------------- telemetry
    def snapshot(self) -> dict[str, Any]:
        return {
            "target_batch": self.target,
            "min_bucket": self.min_bucket,
            "max_bucket": self.max_bucket,
            "pressure": round(self.pressure, 4),
            "slo_ms": self.slo_s * 1e3,
            "decisions": list(self.decisions)[-16:],
        }
