"""Cluster-wide telemetry aggregation over the heartbeat control plane.

Peers already send ``("hb", pid, tick)`` to process 0 every
``heartbeat_interval`` seconds (``resilience/heartbeat.py``); this module
piggybacks a compact telemetry summary on that same message — no new sockets,
no new threads — so the coordinator's ``/status`` shows the WHOLE cluster:
per-process tick, watermark minimum, backlog, row totals, sink-latency
histogram snapshots (merged positionally — fixed buckets), and resilience
counters. The reference's monitoring server is per-process; aggregating at
process 0 is what a multi-host pod actually needs (one scrape target).

Carried from ``pathway_tpu/observability/aggregate.py``; with the
elasticity plane on, each summary carries its sender's
``membership_version``.
"""

from __future__ import annotations

import time as _time
from typing import Any

from pathway_tpu_torch.observability import metrics as _metrics


def local_summary(runtime) -> dict[str, Any]:
    """This process's telemetry summary — small (rides every heartbeat), built
    from probes the engine already maintains. Safe to call from the heartbeat
    thread mid-tick: readers tolerate torn counters (monitoring reads race the
    engine the same way)."""
    from pathway_tpu_torch.internals.telemetry import resilience_summary

    scheduler = getattr(runtime, "scheduler", None)
    rows_in = 0
    rows_out = 0
    backlog = 0
    for g in _metrics.iter_graphs(scheduler):
        for node in g.nodes:
            if hasattr(node, "wm_rows"):
                rows_in += node.wm_rows
                backlog += len(getattr(node, "_pending", ()))
            elif node.name == "microbatch_select":
                backlog += len(getattr(node, "waiting", ()))
            if node.name in ("subscribe", "capture", "output"):
                rows_out += node.stats_rows_in
    summary = {
        "tick": getattr(scheduler, "current_time", None),
        "watermark": _metrics.min_watermark(scheduler),
        "backlog_rows": backlog,
        "rows_in": rows_in,
        "rows_out": rows_out,
        "sink_latency": _metrics.run_metrics().sink_snapshots(),
        "resilience": resilience_summary(),
        "ts_unix": round(_time.time(), 3),
    }
    # elasticity plane: stamp the sender's membership version so the
    # coordinator can reject summaries from before the last reshard (a
    # retired process's final heartbeat racing the membership commit)
    from pathway_tpu_torch import elastic as _elastic

    eplane = _elastic.current()
    if eplane is not None and eplane.membership is not None:
        summary["membership_version"] = eplane.membership.version
    # flow plane: gate occupancy rides the heartbeat so the coordinator can
    # merge a pod-wide pressure (credit piggyback — no new sockets)
    from pathway_tpu_torch import flow as _flow

    plane = _flow.current()
    if plane is not None:
        summary["flow"] = plane.heartbeat_summary()
    # device plane: compile/pad/memory rollup so the coordinator's /status
    # attributes device cost across the whole pod
    from pathway_tpu_torch.observability import device as _device

    dev = _device.heartbeat_summary()
    if dev is not None:
        summary["device"] = dev
    # audit plane: violation/divergence counts ride the same heartbeat so a
    # data-plane tripwire firing on ANY process is visible on the coordinator
    from pathway_tpu_torch.observability import audit as _audit

    plane = _audit.current()
    if plane is not None:
        summary["audit"] = plane.heartbeat_summary()
    # serving plane: this process's per-route front-door counters (fabric
    # peers serve traffic of their own) so the coordinator's /status rolls
    # requests/sheds/auth failures up pod-wide with exact totals
    from pathway_tpu_torch.io.http import _server as _rest_serve

    serving = _rest_serve.serving_heartbeat_summary(runtime)
    if serving is not None:
        summary["serving"] = serving
    # replica-served retrieval: this door's per-route index-replica health
    # (rows, worst-peer lag, local answers vs fallbacks, gap/resync counts)
    from pathway_tpu_torch import fabric as _fabric
    from pathway_tpu_torch.fabric import index_replica as _index_replica

    fplane = _fabric.current()
    n_proc = fplane.n_proc if fplane is not None and fplane.runtime is runtime else None
    replica_index = _index_replica.heartbeat_summary(runtime, n_proc)
    if replica_index is not None:
        summary["replica_index"] = replica_index
    # health plane: this door's readiness state + active alerts ride the
    # heartbeat so the coordinator sees which doors are syncing/draining and
    # which alerts are firing anywhere in the pod
    from pathway_tpu_torch.observability import health as _health

    hb = _health.heartbeat_summary()
    if hb is not None:
        summary["health"] = hb
    # timeline plane: the last few derived points ride the heartbeat so the
    # coordinator holds a merged pod timeline (dedup on t — resends are free)
    from pathway_tpu_torch.observability import timeline as _timeline

    tplane = _timeline.current()
    if tplane is not None:
        summary["timeline"] = tplane.heartbeat_summary()
    # exactly-once delivery plane: staged/published totals, uncommitted-epoch
    # depth and the oldest unpublished stage time ride the heartbeat so the
    # coordinator sees a stalling sink on any process (only process 0 binds
    # sinks today, but the rollup is shape-agnostic)
    from pathway_tpu_torch import delivery as _delivery

    dlv = _delivery.heartbeat_summary(runtime)
    if dlv is not None:
        summary["delivery"] = dlv
    return summary


def cluster_status(runtime) -> dict[str, Any] | None:
    """Coordinator view: every process's latest summary (self computed live,
    peers from their heartbeats) + cluster-level rollups. None off-cluster or
    on non-coordinator processes (their /status stays process-local)."""
    monitor = getattr(runtime, "hb_monitor", None)
    if monitor is None or not hasattr(monitor, "peer_summaries"):
        return None
    processes: dict[str, Any] = {"0": local_summary(runtime)}
    for pid, summary in sorted(monitor.peer_summaries().items()):
        if summary is not None:
            processes[str(pid)] = summary
    ticks = [p["tick"] for p in processes.values() if p.get("tick") is not None]
    wms = [p["watermark"] for p in processes.values() if p.get("watermark") is not None]
    merged_sinks: dict[str, list] = {}
    for p in processes.values():
        for label, snap in (p.get("sink_latency") or {}).items():
            merged_sinks.setdefault(label, []).append(snap)
    out = {
        "processes": processes,
        "n_reporting": len(processes),
        "tick_min": min(ticks) if ticks else None,
        "tick_max": max(ticks) if ticks else None,
        "watermark_min": min(wms) if wms else None,
        "backlog_rows": sum(p.get("backlog_rows") or 0 for p in processes.values()),
        "sink_latency": {
            label: _metrics.Histogram.merge(snaps)
            for label, snaps in sorted(merged_sinks.items())
        },
    }
    flows = {pid: p.get("flow") for pid, p in processes.items() if p.get("flow")}
    if flows:
        out["flow"] = {
            "shed_rows": sum(f.get("shed_rows") or 0 for f in flows.values()),
            "occupied": sum(f.get("occupied") or 0 for f in flows.values()),
            "bound": sum(f.get("bound") or 0 for f in flows.values()),
            "pressure_max": max(f.get("pressure") or 0.0 for f in flows.values()),
        }
    from pathway_tpu_torch.observability import device as _device

    dev = _device.merge_heartbeat_summaries(
        [p.get("device") for p in processes.values()]
    )
    if dev is not None:
        out["device"] = dev
    from pathway_tpu_torch.observability import audit as _audit

    aud = _audit.merge_heartbeat_summaries(
        [p.get("audit") for p in processes.values()]
    )
    if aud is not None:
        out["audit"] = aud
    # replica-served retrieval rollup: per route, the worst peer lag across
    # doors and the pod-wide local-answer / fallback / gap / resync totals —
    # one look answers "is every door actually serving locally, and how stale"
    merged_ri: dict[str, dict] = {}
    for p in processes.values():
        for route, ent in (p.get("replica_index") or {}).items():
            agg = merged_ri.setdefault(
                route,
                {
                    "doors": 0,
                    "rows_min": None,
                    "lag_max_s": None,
                    "unsynced": 0,
                    "local": 0,
                    "fallbacks": 0,
                    "gaps": 0,
                    "resyncs": 0,
                },
            )
            agg["doors"] += 1
            rows = ent.get("rows") or 0
            agg["rows_min"] = (
                rows if agg["rows_min"] is None else min(agg["rows_min"], rows)
            )
            lag = ent.get("lag_s")
            if lag is None:
                agg["unsynced"] += 1
            elif agg["lag_max_s"] is None or lag > agg["lag_max_s"]:
                agg["lag_max_s"] = lag
            for k in ("local", "fallbacks", "gaps", "resyncs"):
                agg[k] += ent.get(k) or 0
    if merged_ri:
        out["replica_index"] = merged_ri
    # health rollup: per-door readiness states + the union of active alerts —
    # "is the whole pod ready, and is anything firing" in one look
    doors: dict[str, str] = {}
    active_alerts: set[str] = set()
    fired = 0
    canary = {"requests": 0, "failed": 0}
    for pid, p in processes.items():
        h = p.get("health")
        if not h:
            continue
        doors[pid] = h.get("state") or "unknown"
        active_alerts.update(h.get("active") or ())
        fired += h.get("fired") or 0
        canary["requests"] += h.get("canary") or 0
        canary["failed"] += h.get("canary_failed") or 0
    if doors:
        out["health"] = {
            "doors": doors,
            "all_ready": all(s == "ready" for s in doors.values()),
            "active_alerts": sorted(active_alerts),
            "alerts_fired": fired,
            "canary": canary,
        }
    # timeline rollup: who is reporting history and how fresh — the merged
    # series itself is served by /timeline (too big for every /status)
    tls = {
        pid: p.get("timeline") for pid, p in processes.items() if p.get("timeline")
    }
    if tls:
        last = [t.get("last_t") for t in tls.values() if t.get("last_t") is not None]
        out["timeline"] = {
            "reporting": sorted(tls),
            "samples": sum(t.get("samples") or 0 for t in tls.values()),
            "last_t": max(last) if last else None,
        }
    # delivery rollup: pod-wide staged/published totals, the deepest
    # uncommitted-epoch backlog and the oldest unpublished stage time
    dlvs = [p.get("delivery") for p in processes.values() if p.get("delivery")]
    if dlvs:
        oldest = [
            d["oldest_unpublished_unix"]
            for d in dlvs
            if d.get("oldest_unpublished_unix") is not None
        ]
        out["delivery"] = {
            "sinks": sum(d.get("sinks") or 0 for d in dlvs),
            "depth_max": max(d.get("depth") or 0 for d in dlvs),
            "staged_rows": sum(d.get("staged") or 0 for d in dlvs),
            "published_rows": sum(d.get("published") or 0 for d in dlvs),
            "publish_failures": sum(d.get("failures") or 0 for d in dlvs),
            "oldest_unpublished_unix": min(oldest) if oldest else None,
        }
    return out
