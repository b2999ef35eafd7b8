"""Watermarks, end-to-end latency histograms, backlog gauges.

The per-operator counters (``internals/monitoring.py``) say how much work each
node did; this module answers the operator-on-call questions for a LIVE
pipeline (reference: per-operator Prometheus metrics, ``http_server.rs``):

- **watermarks** — per input connector: the event-time high-water mark when
  the source declares an event-time column, else the wall clock of the last
  ingested event (a processing-time watermark), plus ingest counts and queue
  backlog, read directly off each ``StreamInputNode``;
- **end-to-end latency** — per sink: wall time from the oldest event ingested
  for a tick to the tick's emission at that sink, accumulated into fixed
  log-2-bucketed histograms exported as Prometheus histograms on ``/metrics``;
- **backlogs** — rows queued in connector input queues and in the cross-tick
  microbatch buffers (``MicrobatchApplyNode.waiting``).

Everything here is per-run state: ``reset()`` runs at run start (same
discipline as ``telemetry.clear_events``), so ``/metrics`` describes THIS run.

Carried from ``pathway_tpu/observability/metrics.py`` unchanged. In the port
the REST serving plane (``io/http/_server.py``) keeps each route's latency in
a :class:`Histogram`; the monitoring server that exports the rest is a later
slice.
"""

from __future__ import annotations

import threading
import time as _time
from typing import Any

#: fixed log-2 histogram bucket upper bounds, seconds: 0.24 ms … 32 s.
#: Fixed (not adaptive) so snapshots from different processes merge by
#: positional add — the cluster aggregation path depends on it.
BUCKET_BOUNDS_S: tuple[float, ...] = tuple(2.0**e for e in range(-12, 6))

#: per-tick ingest stamps retained; a streaming run ticks ~50/s at the default
#: autocommit, so this window covers minutes of in-flight ticks
_TICK_STAMPS_MAX = 4096


class Histogram:
    """Fixed-bucket latency histogram (thread-safe, mergeable)."""

    __slots__ = ("counts", "sum_s", "count", "_lock")

    def __init__(self) -> None:
        self.counts = [0] * (len(BUCKET_BOUNDS_S) + 1)  # +inf tail
        self.sum_s = 0.0
        self.count = 0
        self._lock = threading.Lock()

    def observe(self, seconds: float) -> None:
        i = 0
        for bound in BUCKET_BOUNDS_S:
            if seconds <= bound:
                break
            i += 1
        with self._lock:
            self.counts[i] += 1
            self.sum_s += seconds
            self.count += 1

    def snapshot(self) -> dict[str, Any]:
        with self._lock:
            return {
                "counts": list(self.counts),
                "sum_s": self.sum_s,
                "count": self.count,
            }

    @staticmethod
    def merge(snapshots: list[dict]) -> dict[str, Any]:
        """Positional bucket-count sum. Tolerates snapshots with missing,
        short, or over-long ``counts`` (cluster peers may run a different
        build generation with a different bucket table): short lists
        contribute what they have, extra tail buckets extend the result —
        merge stays associative and order-independent either way."""
        counts = [0] * (len(BUCKET_BOUNDS_S) + 1)
        total_sum = 0.0
        total_count = 0
        for s in snapshots:
            for i, c in enumerate(s.get("counts") or ()):
                if i >= len(counts):
                    counts.extend([0] * (i + 1 - len(counts)))
                counts[i] += c
            total_sum += s.get("sum_s", 0.0)
            total_count += s.get("count", 0)
        return {"counts": counts, "sum_s": total_sum, "count": total_count}

    @staticmethod
    def quantile(snapshot: dict, q: float) -> float | None:
        """Bucket-resolution quantile (upper bound of the bucket holding the
        q-th observation) for /status summaries."""
        total = snapshot.get("count", 0)
        if total <= 0:
            return None
        rank = q * total
        seen = 0
        for i, c in enumerate(snapshot.get("counts") or ()):
            seen += c
            if seen >= rank and c:
                if i < len(BUCKET_BOUNDS_S):
                    return BUCKET_BOUNDS_S[i]
                return float("inf")
        return float("inf")


class RunMetrics:
    """Per-run mutable metrics state shared by inputs, sinks and exporters."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.sink_latency: dict[str, Histogram] = {}
        # tick -> earliest ingest time_ns among events drained at that tick;
        # sinks subtract it from their emission time for the e2e histogram
        self._tick_ingest: dict[int, int] = {}

    # ------------------------------------------------------------ tick stamps
    def note_tick_ingest(self, tick: int, ts_ns: int) -> None:
        with self._lock:
            prev = self._tick_ingest.get(tick)
            if prev is None or ts_ns < prev:
                self._tick_ingest[tick] = ts_ns
            # ticks arrive in increasing order, so insertion order == tick
            # order and evicting the FIRST key is O(1) — this runs on every
            # input poll even with tracing off, so no sorting here
            while len(self._tick_ingest) > _TICK_STAMPS_MAX:
                del self._tick_ingest[next(iter(self._tick_ingest))]

    def tick_ingest_ns(self, tick: int) -> int | None:
        with self._lock:
            return self._tick_ingest.get(tick)

    # ------------------------------------------------------------------ sinks
    def observe_sink_latency(self, label: str, seconds: float) -> None:
        h = self.sink_latency.get(label)
        if h is None:
            with self._lock:
                h = self.sink_latency.setdefault(label, Histogram())
        h.observe(seconds)

    def sink_snapshots(self) -> dict[str, dict]:
        return {label: h.snapshot() for label, h in sorted(self.sink_latency.items())}


_metrics = RunMetrics()


def run_metrics() -> RunMetrics:
    return _metrics


def reset() -> None:
    """Fresh per-run state — called when a run installs observability."""
    global _metrics
    _metrics = RunMetrics()


# --------------------------------------------------------------------- probes
# Live probes read straight off the engine graph(s) — no extra bookkeeping in
# the hot loops beyond what the nodes already track.


def iter_graphs(scheduler) -> list:
    """Engine graphs of any runtime shape: single (``.graph``), thread-sharded
    (``.workers``), or cluster (``.local_workers`` — this process's shard)."""
    if scheduler is None:
        return []
    graph = getattr(scheduler, "graph", None)
    if graph is not None:
        return [graph]
    workers = getattr(scheduler, "workers", None)
    if workers:
        return [w.graph for w in workers if getattr(w, "graph", None) is not None]
    local = getattr(scheduler, "local_workers", None)
    if local:
        return [lw.graph for lw in local.values()]
    return []


def input_watermarks(scheduler) -> list[dict[str, Any]]:
    """Per-input-connector watermark rows (deduped by node position across
    worker shards — inputs are SOLO or partitioned, so max-merge is correct)."""
    now_unix = _time.time()
    agg: dict[int, dict[str, Any]] = {}
    for g in iter_graphs(scheduler):
        for node in g.nodes:
            if not hasattr(node, "wm_rows"):
                continue
            wm_ns = node.wm_ingest_ns
            row = agg.get(node.node_index)
            if row is None:
                agg[node.node_index] = row = {
                    "input": f"{getattr(node, 'input_name', None) or node.name}:{node.node_index}",
                    "watermark": None,
                    "lag_s": None,
                    "rows_ingested": 0,
                    "backlog_rows": 0,
                }
            row["rows_ingested"] += node.wm_rows
            row["backlog_rows"] += len(getattr(node, "_pending", ()))
            et = node.wm_event_time
            if et is not None:
                if row["watermark"] is None or et > row["watermark"]:
                    row["watermark"] = float(et)
            elif wm_ns is not None:
                # no event-time column: processing-time watermark — the wall
                # clock (unix seconds) of the newest ingested event
                ingest_unix = wm_ns / 1e9
                if row["watermark"] is None or ingest_unix > row["watermark"]:
                    row["watermark"] = ingest_unix
    rows = [agg[i] for i in sorted(agg)]
    for row in rows:
        if row["watermark"] is not None:
            row["lag_s"] = round(max(0.0, now_unix - row["watermark"]), 6)
            row["watermark"] = round(row["watermark"], 6)
    return rows


def backlog_gauges(scheduler) -> list[dict[str, Any]]:
    """Rows waiting in connector queues and cross-tick microbatch buffers."""
    agg: dict[str, int] = {}
    for g in iter_graphs(scheduler):
        for node in g.nodes:
            if hasattr(node, "wm_rows"):  # stream inputs
                q = f"input:{node.node_index}"
                agg[q] = agg.get(q, 0) + len(getattr(node, "_pending", ()))
            elif node.name == "microbatch_select":
                q = f"microbatch:{node.node_index}"
                agg[q] = agg.get(q, 0) + len(getattr(node, "waiting", ()))
    return [{"queue": q, "rows": n} for q, n in sorted(agg.items())]


def min_watermark(scheduler) -> float | None:
    wms = [w["watermark"] for w in input_watermarks(scheduler) if w["watermark"] is not None]
    return min(wms) if wms else None
