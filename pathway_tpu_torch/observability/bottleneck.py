"""Bottleneck attribution — "what bounds throughput right now, and which knob
moves it".

Folds the six per-plane cost decompositions the system already maintains —
request stage split, engine phase timers, device split + pad
waste, flow pressure, fabric forward share, delivery
publish stalls, ingest backlog — into ONE ranked
``throughput-bound-by`` verdict, each candidate carrying the specific knob
to turn. Operates on the timeline plane's raw-sample window deltas (no new
instrumentation; the recorder already holds the history), so the verdict is
"over the last minute", not "since process start".

Surfaced as the ``bottleneck`` /status section, a ``bottleneck/top`` trace
event on every top-cause change, and attached (with the pre-incident
timeline window) to incident bundles.

Carried from ``pathway_tpu/observability/bottleneck.py`` with imports
rewritten. The flow-pressure, fabric-forward and delivery-stall candidates
read samples the port's timeline does not take yet (those planes are not
carried), so they never score, as in a reference run with the planes off.
"""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.observability.timeline import _hist_delta, _q99

#: attribution window: long enough to smooth one slow tick, short enough that
#: the verdict tracks a live regime change
WINDOW_S = 60.0

#: candidates scoring under this are noise, not bottlenecks
MIN_SCORE = 0.05

#: stage-family → remediation knob (the decomposition names stages like
#: ``serve/v1/answer`` and ``sweep/v1/answer``; advice keys on the family)
_STAGE_KNOBS = {
    "serve": "raise PATHWAY_SERVE_MAX_INFLIGHT or add doors (/scale)",
    "coalesce": "tune PATHWAY_SERVE_COALESCE_MS / PATHWAY_SERVE_COALESCE_ROWS",
    "sweep": "profile the UDF / enable PATHWAY_FUSE whole-tick compilation",
    "microbatch": "raise the microbatch window (serve_tick) so launches batch wider",
    "index": "check index tiering (PATHWAY_INDEX_HOT_ROWS) and replica serving",
    "respond": "raise PATHWAY_SERVE_COALESCE_ROWS so responses batch wider",
    "forward": "enable PATHWAY_SHARDMAP for zero-hop routing",
}

_PHASE_KNOBS = {
    "kernel": "lower PATHWAY_FUSE_JAX_MIN_ROWS so more runs hit the jitted tier",
    "exchange": "enable PATHWAY_DEVICE_EXCHANGE_FUSED / check shard skew",
    "consolidate": "enable PATHWAY_FUSE so chains consolidate once per tick",
    "rehash": "pre-sort inputs or raise tick size (fewer key-store compactions)",
    "probe": "raise tick size: probe cost amortizes over wider ticks",
    "groupby": "check group cardinality (PATHWAY_AUDIT cardinality gauges)",
    "realloc": "raise PATHWAY_FLOW_BULK_MAX_ROWS so blocks grow fewer times",
    "capture": "batch subscribers (serve_coalesce_rows) to cut fold passes",
    "join": "check join key skew; consider PATHWAY_SHARDMAP re-balancing",
}


def _stage_family(stage: str) -> str:
    return stage.split("/", 1)[0]


def attribute(plane) -> dict[str, Any] | None:
    """Rank every plane's candidate cause over the attribution window.
    Returns ``{"top", "ranked", "window_s"}`` (top is None when nothing
    scores — an idle pipeline has no bottleneck), or None before two
    samples exist."""
    new, old = plane.window_edges(WINDOW_S)
    if new is None or old is None:
        return None
    dt = max(1e-6, new["t"] - old["t"])
    cands: list[dict[str, Any]] = []

    # ---- request stage decomposition: share of total stage time
    st_new, st_old = new.get("stages") or {}, old.get("stages") or {}
    stage_sums: dict[str, float] = {}
    for stage, snap in st_new.items():
        d = _hist_delta(snap, st_old.get(stage))
        if d and d.get("sum_s", 0.0) > 0 and d.get("count", 0) > 0:
            stage_sums[stage] = d["sum_s"]
    total_stage = sum(stage_sums.values())
    if total_stage > 0:
        stage, s = max(stage_sums.items(), key=lambda kv: kv[1])
        share = s / total_stage
        d = _hist_delta(st_new[stage], st_old.get(stage))
        p99 = _q99(d)
        fam = _stage_family(stage)
        cands.append({
            "cause": f"stage:{stage}",
            "score": round(share, 4),
            "verdict": f"request {fam}-bound: stage {stage} takes "
                       f"{share:.0%} of request time"
                       + (f" (p99 {p99 * 1e3:.0f} ms)" if p99 else ""),
            "knob": _STAGE_KNOBS.get(fam, "inspect /request stage decomposition"),
            "evidence": {"stage_share": round(share, 4), "stage_p99_s": p99},
        })

    # ---- engine phase timers: busy fraction of the window per phase
    ph_new, ph_old = new.get("phases") or {}, old.get("phases") or {}
    phase_ms = {
        k: ph_new[k] - (ph_old.get(k) or 0.0)
        for k in ph_new
        if ph_new[k] - (ph_old.get(k) or 0.0) > 0
    }
    if phase_ms:
        phase, ms = max(phase_ms.items(), key=lambda kv: kv[1])
        busy = ms / (dt * 1000.0)
        cands.append({
            "cause": f"phase:{phase}",
            "score": round(min(1.5, busy), 4),
            "verdict": f"tick {phase}-bound: {ms:.0f} ms of {phase} this window "
                       f"({busy:.0%} of wall time)",
            "knob": _PHASE_KNOBS.get(phase, "see PATHWAY_ENGINE_PHASES breakdown"),
            "evidence": {"phase_ms": round(ms, 1), "busy_frac": round(busy, 4)},
        })

    # ---- flow pressure
    fl = new.get("flow") or {}
    pressure = fl.get("pressure") or 0.0
    if pressure > 0:
        cands.append({
            "cause": "flow:pressure",
            "score": round(pressure, 4),
            "verdict": f"admission-bound: interactive gates at "
                       f"{pressure:.0%} occupancy",
            "knob": "raise PATHWAY_SERVE_MAX_INFLIGHT or scale out (/scale)",
            "evidence": {"pressure": round(pressure, 4),
                         "occupied": fl.get("occupied") or 0},
        })

    # ---- device split: pad waste + recompile storms
    dev_new, dev_old = new.get("device") or {}, old.get("device") or {}
    pn = dev_new.get("pad_rows") or [0, 0]
    po = dev_old.get("pad_rows") or [0, 0]
    useful, padded = max(0, pn[0] - po[0]), max(0, pn[1] - po[1])
    if useful + padded > 0:
        waste = padded / (useful + padded)
        if waste > 0.2:
            cands.append({
                "cause": "device:pad_waste",
                "score": round(waste, 4),
                "verdict": f"pad-waste-bound: {waste:.0%} of device rows are "
                           "padding",
                "knob": "check length bucketing / batch shape stability",
                "evidence": {"pad_waste": round(waste, 4),
                             "padded_rows": padded, "useful_rows": useful},
            })
    compile_s = (dev_new.get("process_compile_s") or 0.0) - (
        dev_old.get("process_compile_s") or 0.0
    )
    if compile_s > 0:
        frac = compile_s / dt
        if frac > 0.1:
            cands.append({
                "cause": "device:recompile",
                "score": round(min(1.5, frac), 4),
                "verdict": f"compile-bound: {compile_s:.1f} s recompiling this "
                           "window (shape storm)",
                "knob": "stabilize batch shapes; see /status device.storm",
                "evidence": {"compile_s": round(compile_s, 3)},
            })

    # ---- fabric forward share
    sv_new, sv_old = new.get("serving") or {}, old.get("serving") or {}
    req_d = fwd_d = 0
    for route, c in sv_new.items():
        o = sv_old.get(route) or {}
        req_d += max(0, (c.get("requests") or 0) - (o.get("requests") or 0))
        fwd_d += max(0, (c.get("forwarded_out") or 0) - (o.get("forwarded_out") or 0))
    if req_d > 0 and fwd_d / req_d > 0.1:
        share = fwd_d / req_d
        cands.append({
            "cause": "fabric:forward",
            "score": round(share, 4),
            "verdict": f"fabric forward-bound: {share:.0%} of requests pay an "
                       "owner hop",
            "knob": "enable PATHWAY_SHARDMAP (zero-hop doors)",
            "evidence": {"forward_share": round(share, 4),
                         "forwarded": fwd_d, "requests": req_d},
        })

    # ---- delivery publish stalls
    dlv = new.get("delivery") or {}
    oldest = dlv.get("oldest_unpublished_unix")
    if oldest is not None:
        age = max(0.0, new["t"] - oldest)
        stall_s = max(1.0, plane.cfg.alert_sink_stall_s)
        if age > stall_s * 0.5:
            cands.append({
                "cause": "delivery:publish_stall",
                "score": round(min(1.5, age / stall_s), 4),
                "verdict": f"sink-publish-bound: oldest staged epoch unpublished "
                           f"for {age:.0f} s (ledger depth {dlv.get('depth') or 0})",
                "knob": "check the sink transport; ledger backpressure at "
                        "PATHWAY_DELIVERY_MAX_STAGED_EPOCHS",
                "evidence": {"oldest_age_s": round(age, 1),
                             "depth": dlv.get("depth") or 0},
            })

    # ---- ingest backlog (growing queue = sources outrun the engine)
    backlog = new.get("backlog") or 0
    grew = backlog - (old.get("backlog") or 0)
    bound = max(1, plane.cfg.alert_backlog_rows)
    if backlog > 0 and grew > 0:
        cands.append({
            "cause": "ingest:backlog",
            "score": round(min(1.5, backlog / bound), 4),
            "verdict": f"ingest-bound: backlog {backlog} rows and rising "
                       f"(+{grew} this window)",
            "knob": "raise PATHWAY_INPUT_QUEUE_ROWS or scale out (/scale)",
            "evidence": {"backlog_rows": backlog, "grew_rows": grew},
        })

    ranked = sorted(
        (c for c in cands if c["score"] >= MIN_SCORE),
        key=lambda c: -c["score"],
    )
    return {
        "top": ranked[0] if ranked else None,
        "ranked": ranked,
        "window_s": round(dt, 3),
    }


def status(runtime=None) -> dict[str, Any] | None:
    """The /status ``bottleneck`` section (None with the timeline off or
    before attribution has data)."""
    from pathway_tpu_torch.observability import timeline as _timeline

    plane = _timeline.current()
    if plane is None:
        return None
    return plane.bottleneck
