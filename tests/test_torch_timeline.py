"""The port's timeline plane and bottleneck attribution
(``pathway_tpu_torch/observability/{timeline,bottleneck}.py``) and the
monitoring server's ``/timeline`` against the reference's, on the same
inputs.

Mirrors ``tests/test_timeline.py`` case by case: the knobs and the off mode;
``derive_point`` on the same raw samples (the reference's hand-made pair and
a seeded random series) gives equal points; the segment sink writes files
that read back as equal points; ``diff_summary``; the ``/timeline`` cursor,
metric projection and step downsampling answer equal payloads; the pod
rollup of one process; the bottleneck verdicts on the same raw windows; the
burn-rate ladder; the incident bundles' lead-up windows; the seeded stall
on a served route. A recorder step over a finished run on a fixed clock
gives equal points, verdicts and payloads. Segment lines carry each
package's own service name (``pathway_tpu`` / ``pathway_tpu_torch``), as the
span exports do; everything else in them is equal.

The pod merge of peers' heartbeat series and the coordinator's rollup
(``test_pod_merge_rules_and_peer_retirement``,
``test_heartbeat_piggyback_and_cluster_rollup``) run on both packages too.
Left out of the reference's file, with the plane each needs (ROADMAP
Queue 1): ``test_fabric_link_canaries_feed_slo_and_flap_detector`` and
``test_fabric_canary_req_handler_registered`` (the fabric, item 7) and the
three ``cli`` cases (``pathway_tpu top`` and ``timeline diff``, item 7; the
``diff_summary`` they print is compared here).
"""

from __future__ import annotations

import json
import os
import threading
import time
import urllib.request

import numpy as np
import pytest

import pathway_tpu
import pathway_tpu_torch
from pathway_tpu.internals import monitoring as ref_mon
from pathway_tpu.observability import alerts as ref_alerts
from pathway_tpu.observability import bottleneck as ref_bottleneck
from pathway_tpu.observability import health as ref_health
from pathway_tpu.observability import timeline as ref_timeline
from pathway_tpu_torch.internals import monitoring as port_mon
from pathway_tpu_torch.observability import alerts as port_alerts
from pathway_tpu_torch.observability import bottleneck as port_bottleneck
from pathway_tpu_torch.observability import health as port_health
from pathway_tpu_torch.observability import timeline as port_timeline
from torch_http_helpers import free_port, release_port, wait_ready

SIDES = {
    "ref": (pathway_tpu, ref_timeline, ref_bottleneck, ref_mon, ref_health, ref_alerts),
    "port": (pathway_tpu_torch, port_timeline, port_bottleneck, port_mon, port_health, port_alerts),
}

_TIMELINE_KNOBS = (
    "PATHWAY_TIMELINE",
    "PATHWAY_TIMELINE_WINDOW_S",
    "PATHWAY_TIMELINE_STEP_MS",
    "PATHWAY_TIMELINE_DIR",
    "PATHWAY_TIMELINE_ROTATE_MB",
    "PATHWAY_SLO_BURN_TICKET_FAST",
    "PATHWAY_SLO_BURN_TICKET_SLOW",
)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in _TIMELINE_KNOBS:
        monkeypatch.delenv(k, raising=False)
    yield
    for pw, timeline, *_ in SIDES.values():
        timeline.shutdown()
        pw.G.clear()


def _cfg(pw):
    return pw.internals.config.get_pathway_config()


class _RT:
    scheduler = None


class _HB:
    def __init__(self):
        self.peers: dict[int, dict | None] = {}

    def peer_summaries(self):
        return dict(self.peers)


class _ClusterRT:
    scheduler = None

    def __init__(self):
        self.hb_monitor = _HB()


def _get_json(url: str, timeout: float = 15.0) -> dict:
    return json.loads(urllib.request.urlopen(url, timeout=timeout).read())


# ------------------------------------------------------------------- knobs


def test_knob_defaults_and_validation(monkeypatch):
    out = {}
    for name, (pw, *_rest) in SIDES.items():
        for k in _TIMELINE_KNOBS:
            monkeypatch.delenv(k, raising=False)
        cfg = _cfg(pw)
        got = [cfg.timeline, cfg.timeline_window_s, cfg.timeline_step_ms, cfg.timeline_dir,
               cfg.timeline_rotate_mb, cfg.slo_burn_ticket_fast, cfg.slo_burn_ticket_slow]
        d = cfg.to_dict()
        got.append(sorted(k for k in d if k.startswith(("timeline", "slo_burn_ticket"))))
        monkeypatch.setenv("PATHWAY_TIMELINE", "maybe")
        with pytest.raises(ValueError):
            cfg.timeline
        monkeypatch.setenv("PATHWAY_TIMELINE_STEP_MS", "5")
        monkeypatch.setenv("PATHWAY_TIMELINE_ROTATE_MB", "0.0001")
        got += [cfg.timeline_step_ms, cfg.timeline_rotate_mb]  # clamped
        out[name] = got
    assert out["port"] == out["ref"]
    assert out["port"][:7] == ["on", 600.0, 1000.0, None, 32.0, 6.0, 1.0]
    assert out["port"][-2:] == [100, 0.05]


def test_off_mode_constructs_no_plane(monkeypatch):
    monkeypatch.setenv("PATHWAY_TIMELINE", "off")
    out = {}
    for name, (_pw, timeline, _b, mon, *_r) in SIDES.items():
        assert timeline.install_from_env(None) is None
        assert timeline.current() is None
        out[name] = json.loads(mon._timeline_payload(""))
    assert out["port"] == out["ref"] == {"enabled": False, "points": [], "next": None}


def test_timeline_and_planes_install_with_the_run(monkeypatch):
    """``PATHWAY_TIMELINE=on`` (the default) starts the recorder with the
    run and stops it at the run's end; ``/status`` carries its section
    meanwhile, and the recorder's thread is gone after."""
    for name, (pw, timeline, _b, mon, *_r) in SIDES.items():
        seen: dict = {}

        class Subj(pw.io.python.ConnectorSubject):
            def run(self):
                for i in range(4):
                    self.next(x=i)
                    time.sleep(0.05)
                plane = timeline.current()
                seen["plane"] = plane
                seen["status"] = mon.run_stats(pw.internals.run.current_runtime()).get("timeline")

        pw.G.clear()
        t = pw.io.python.read(Subj(), schema=pw.schema_from_types(x=int))
        pw.io.subscribe(t, on_change=lambda **k: None)
        pw.run(monitoring_level="none")
        plane = seen["plane"]
        assert plane is not None and timeline.current() is None, name
        assert seen["status"]["step_ms"] == 1000 and seen["status"]["samples"] >= 1, name
        assert plane._thread is not None and not plane._thread.is_alive(), name
        assert plane.samples_total >= 2, name  # the baseline and the closing sample


# ------------------------------------------------------------- derive_point


def _hist(pw, counts_at: dict[int, int]) -> dict:
    bounds = pw.observability.metrics.BUCKET_BOUNDS_S
    counts = [0] * (len(bounds) + 1)
    for i, n in counts_at.items():
        counts[i] = n
    return {"counts": counts, "sum_s": 0.0, "count": sum(counts)}


def _reference_pair(pw):
    old = {
        "t": 100.0, "tick": 10, "rows_in": 1000, "rows_out": 500, "backlog": 0, "wm_lag_s": None, "sinks": {},
        "serving": {"/q": {"requests": 0, "responses": 0, "shed": 0, "errors": 0, "timeouts": 0,
                           "forwarded_out": 0, "latency": _hist(pw, {})}},
        "stages": {"sweep/q": _hist(pw, {}), "serve/q": _hist(pw, {})},
        "phases": {"probe": 100.0},
        "flow": {"pressure": 0.0, "occupied": 0, "shed_rows": 0},
        "health": {"canary_failed": 0, "active": []},
    }
    new = {
        "t": 110.0, "tick": 60, "rows_in": 2000, "rows_out": 1500, "backlog": 7, "wm_lag_s": 1.25, "sinks": {},
        "serving": {"/q": {"requests": 100, "responses": 100, "shed": 5, "errors": 1, "timeouts": 2,
                           "forwarded_out": 20, "latency": _hist(pw, {11: 100})}},
        "stages": {"sweep/q": dict(_hist(pw, {11: 10}), sum_s=5.0), "serve/q": dict(_hist(pw, {6: 90}), sum_s=1.0)},
        "phases": {"probe": 600.0},
        "flow": {"pressure": 0.5, "occupied": 3, "shed_rows": 10},
        "health": {"canary_failed": 2, "active": ["slo_latency_burn:/q"]},
    }
    return new, old


def test_derive_point_rates_and_quantiles():
    out = {}
    for name, (pw, timeline, *_r) in SIDES.items():
        new, old = _reference_pair(pw)
        out[name] = timeline.derive_point(new, old)
    assert out["port"] == out["ref"]
    p = out["port"]
    assert p["t"] == 110.0 and p["tick"] == 60
    assert p["tick_rate"] == pytest.approx(5.0) and p["rows_in_per_s"] == pytest.approx(100.0)
    assert p["route_qps:/q"] == pytest.approx(10.0) and p["route_p99_s:/q"] == pytest.approx(0.5)
    assert p["stage_share:sweep/q"] == pytest.approx(5 / 6, abs=1e-3)
    assert p["phase_ms:probe"] == pytest.approx(500.0) and p["alerts_active"] == 1


def _seeded_raws(pw, seed: int, n: int) -> list[dict]:
    """A seeded series of raw samples: monotonic counters, histograms,
    phases, the device block and health counters."""
    rng = np.random.default_rng(seed)
    nb = len(pw.observability.metrics.BUCKET_BOUNDS_S) + 1
    raws, acc = [], {}
    t, tick = 1000.0, 0
    lat = np.zeros(nb, dtype=np.int64)
    st = {s: np.zeros(nb, dtype=np.int64) for s in ("serve/v1/retrieve", "sweep/chain{x}", "index/search")}
    st_sum = dict.fromkeys(st, 0.0)
    for i in range(n):
        t += float(rng.uniform(0.5, 1.5))
        tick += int(rng.integers(0, 40))
        for k in ("rows_in", "rows_out", "requests", "responses", "shed", "errors", "timeouts", "compiles",
                  "canary_failed", "pad_useful", "pad_pad"):
            acc[k] = acc.get(k, 0) + int(rng.integers(0, 50))
        lat += rng.integers(0, 5, size=nb)
        for s in st:
            st[s] += rng.integers(0, 4, size=nb)
            st_sum[s] += float(rng.uniform(0, 2))
        raws.append({
            "t": round(t, 6), "tick": tick, "rows_in": acc["rows_in"], "rows_out": acc["rows_out"],
            "backlog": int(rng.integers(0, 100)), "wm_lag_s": float(rng.uniform(0, 3)) if i % 3 else None,
            "sinks": {"subscribe:5": {"counts": lat.tolist(), "sum_s": float(i), "count": int(lat.sum())}},
            "serving": {"/v1/retrieve": {"requests": acc["requests"], "responses": acc["responses"],
                                         "shed": acc["shed"], "errors": acc["errors"], "timeouts": acc["timeouts"],
                                         "forwarded_out": 0,
                                         "latency": {"counts": lat.tolist(), "sum_s": float(i) * 0.1,
                                                     "count": int(lat.sum())}}},
            "stages": {s: {"counts": c.tolist(), "sum_s": st_sum[s], "count": int(c.sum())} for s, c in st.items()},
            "phases": {"fused": float(i * 30 + rng.uniform(0, 20)), "consolidate": float(i * 5)},
            "device": {"compiles": acc["compiles"], "pad_rows": [acc["pad_useful"], acc["pad_pad"]],
                       "host_ms": float(i * 3.5), "device_ms": float(i * 1.25), "process_compile_s": 0.0},
            "health": {"canary_failed": acc["canary_failed"], "active": ["a"] * (i % 2)},
        })
    return raws


def test_derive_point_on_a_seeded_series():
    out = {}
    for name, (pw, timeline, *_r) in SIDES.items():
        raws = _seeded_raws(pw, seed=17, n=40)
        out[name] = [timeline.derive_point(b, a) for a, b in zip(raws, raws[1:])]
    assert out["port"] == out["ref"]
    assert len(out["port"]) == 39
    assert any("stage_p99_s:sweep/chain{x}" in p and "route_p99_s:/v1/retrieve" in p for p in out["port"])


# ------------------------------------------------------------ segment spill


def test_segment_sink_rotation_roundtrip_and_crash_survival(tmp_path):
    n = 40
    out = {}
    for name, (_pw, timeline, *_r) in SIDES.items():
        d = tmp_path / name
        path = str(d / "timeline-p0.jsonl")
        sink = timeline.TimelineSegmentSink(path, 0, rotate_bytes=1)  # min 4096
        for i in range(n):
            sink.write({"t": 1000.0 + i, "serve_qps": float(i), "tick": i})
        sink.close()
        assert os.path.exists(path + ".1"), "segment never rotated"
        pts = timeline.read_segments(str(d))
        lines = [json.loads(line) for f in (path + ".1", path) for line in open(f)]
        metrics = [[m for m in doc["resourceMetrics"][0]["scopeMetrics"][0]["metrics"]] for doc in lines]
        service = lines[0]["resourceMetrics"][0]["resource"]["attributes"][0]
        # crash case: a torn final line (killed mid-write) must not lose the rest
        with open(path, "a", encoding="utf-8") as fh:
            fh.write('{"resourceMetrics": [{"resou')
        survived = timeline.read_segments(str(d))
        out[name] = (pts, metrics, survived, os.path.getsize(path + ".1") > 0, service)
    *rest_p, service_p = out["port"]
    *rest_r, service_r = out["ref"]
    assert rest_p == rest_r
    assert service_r["value"]["stringValue"] == "pathway_tpu"
    assert service_p["value"]["stringValue"] == "pathway_tpu_torch"
    pts = out["port"][0]
    ticks = [p["tick"] for p in pts]
    assert ticks[-1] == n - 1 and ticks == [ticks[0] + i for i in range(len(ticks))] and len(pts) < n
    assert [p["tick"] for p in out["port"][2]] == ticks


def test_diff_summary_orders_worst_regression_first():
    a = [{"t": 1.0, "phase_ms:probe": 10.0, "phase_ms:kernel": 50.0, "stage_p99_s:sweep/q": 0.1}]
    b = [{"t": 2.0, "phase_ms:probe": 30.0, "phase_ms:kernel": 40.0, "stage_p99_s:sweep/q": 0.1}]
    rows = port_timeline.diff_summary(a, b)
    assert rows == ref_timeline.diff_summary(a, b)
    assert rows[0]["metric"] == "phase_ms:probe" and rows[0]["regression_pct"] == pytest.approx(200.0)
    assert rows[-1]["metric"] == "phase_ms:kernel" and rows[-1]["regression_pct"] == pytest.approx(-20.0)


# --------------------------------------------------------- /timeline cursor


def test_timeline_endpoint_cursor_metric_and_step(monkeypatch):
    monkeypatch.setenv("PATHWAY_TIMELINE", "on")
    # a huge step keeps the background thread from interleaving samples
    monkeypatch.setenv("PATHWAY_TIMELINE_STEP_MS", "60000")
    out = {}
    for name, (_pw, timeline, _b, mon, *_r) in SIDES.items():
        plane = timeline.install_from_env(_RT())
        try:
            for i in range(10):
                plane.points.append({"t": 1000.0 + i, "serve_qps": float(i), "backlog_rows": i})
            port = free_port()
            release_port(port)
            srv = mon.MonitoringHttpServer(_RT(), port=port).start()
            try:
                base = f"http://127.0.0.1:{srv.port}"
                body = _get_json(f"{base}/timeline")
                got = [body,
                       _get_json(f"{base}/timeline?since={body['next'] - 3}"),
                       _get_json(f"{base}/timeline?since={body['next']}"),
                       _get_json(f"{base}/timeline?metric=serve_qps&since=1007.5"),
                       _get_json(f"{base}/timeline?step=5"),
                       _get_json(f"{base}/status")["timeline"]]
            finally:
                srv.stop()
        finally:
            timeline.shutdown()
        out[name] = got
    assert out["port"] == out["ref"]
    body, page, empty, proj, coarse, status = out["port"]
    assert body["enabled"] is True and body["proc"] == "0" and body["procs"] == ["0"]
    assert len(body["points"]) == 10 and body["next"] == pytest.approx(1009.0)
    assert [p["t"] for p in page["points"]] == [1007.0, 1008.0, 1009.0]
    assert empty["points"] == [] and empty["next"] == pytest.approx(1009.0)
    assert proj["points"] == [{"t": 1008.0, "v": 8.0}, {"t": 1009.0, "v": 9.0}]
    assert [p["t"] for p in coarse["points"]] == [1000.0, 1005.0]
    assert status["points"] == 10 and status["step_ms"] == 60000


# ---------------------------------------------------------------- pod series


def test_pod_points_of_one_process(monkeypatch):
    """The pod rollup over this process's points on step buckets (two points
    in one bucket: rates sum, quantiles take the worst, ``tick`` the
    slowest) and ``proc`` selection, with no peers on either side."""
    monkeypatch.setenv("PATHWAY_TIMELINE", "on")
    out = {}
    for name, (pw, timeline, *_r) in SIDES.items():
        plane = timeline.TimelinePlane(_cfg(pw), _RT())
        plane.points.append({"t": 1000.0, "tick": 30, "serve_qps": 5.0, "route_p99_s:/q": 0.010,
                             "phase_ms:probe": 100.0})
        plane.points.append({"t": 1000.1, "tick": 20, "serve_qps": 7.0, "route_p99_s:/q": 0.050,
                             "phase_ms:probe": 40.0})
        plane.points.append({"t": 1002.0, "tick": 40, "serve_qps": 1.0})
        out[name] = [plane.procs(), plane.pod_points(), plane.pod_points(since=1001.0),
                     plane.payload({"proc": ["pod"]}), plane.payload({"proc": ["1"]}), plane.status_summary()]
    assert out["port"] == out["ref"]
    procs, pod, later, payload, other, status = out["port"]
    assert procs == ["0"] and len(pod) == 2 and [b["t"] for b in later] == [1002.0]
    b = pod[0]
    assert b["procs"] == 1 and b["serve_qps"] == pytest.approx(12.0)  # rates sum
    assert b["route_p99_s:/q"] == pytest.approx(0.050) and b["tick"] == 20  # worst p99, slowest frontier
    assert b["phase_ms:probe"] == pytest.approx(140.0)
    assert payload["proc"] == "pod" and payload["points"] == pod
    assert other["points"] == [] and status["peers"] == {}


# ----------------------------------------------------- bottleneck attribution


def test_bottleneck_ranks_dominant_stage_with_knob(monkeypatch):
    monkeypatch.setenv("PATHWAY_TIMELINE", "on")
    out = {}
    for name, (pw, timeline, bottleneck, *_r) in SIDES.items():
        plane = timeline.TimelinePlane(_cfg(pw), None)
        plane._raws.append({"t": 100.0, "stages": {"sweep/q": _hist(pw, {}), "serve/q": _hist(pw, {})}})
        plane._raws.append({"t": 110.0, "stages": {"sweep/q": dict(_hist(pw, {11: 4}), sum_s=2.0),
                                                   "serve/q": dict(_hist(pw, {6: 40}), sum_s=0.4)}})
        out[name] = bottleneck.attribute(plane)
    assert out["port"] == out["ref"]
    top = out["port"]["top"]
    assert top["cause"] == "stage:sweep/q" and top["score"] == pytest.approx(2.0 / 2.4, abs=1e-3)
    assert "sweep-bound" in top["verdict"] and "PATHWAY_FUSE" in top["knob"]


def test_bottleneck_phase_backlog_and_idle(monkeypatch):
    monkeypatch.setenv("PATHWAY_TIMELINE", "on")
    out = {}
    for name, (pw, timeline, bottleneck, *_r) in SIDES.items():
        plane = timeline.TimelinePlane(_cfg(pw), None)
        plane._raws.append({"t": 100.0, "phases": {"rehash": 0.0}, "backlog": 10})
        plane._raws.append({"t": 110.0, "phases": {"rehash": 8000.0}, "backlog": 500})
        idle = timeline.TimelinePlane(_cfg(pw), None)
        idle._raws.append({"t": 100.0})
        idle._raws.append({"t": 110.0})
        one = timeline.TimelinePlane(_cfg(pw), None)
        one._raws.append({"t": 100.0})
        out[name] = (bottleneck.attribute(plane), bottleneck.attribute(idle), bottleneck.attribute(one))
    assert out["port"] == out["ref"]
    verdict, idle, one = out["port"]
    causes = [c["cause"] for c in verdict["ranked"]]
    assert causes[0] == "phase:rehash"  # 80% busy outranks the small backlog
    assert verdict["top"]["evidence"]["busy_frac"] == pytest.approx(0.8)
    assert idle["top"] is None and idle["ranked"] == [] and one is None


def test_bottleneck_verdicts_on_a_seeded_series(monkeypatch):
    """Every window of the seeded series: the same ranked verdicts (stage,
    phase, pad waste, backlog candidates), through ``sample_now``'s path."""
    monkeypatch.setenv("PATHWAY_TIMELINE", "on")
    out = {}
    for name, (pw, timeline, bottleneck, *_r) in SIDES.items():
        plane = timeline.TimelinePlane(_cfg(pw), None)
        verdicts = []
        for raw in _seeded_raws(pw, seed=29, n=30):
            plane._raws.append(raw)
            verdicts.append(bottleneck.attribute(plane))
        out[name] = verdicts
    assert out["port"] == out["ref"]
    assert out["port"][0] is None and all(v["ranked"] for v in out["port"][2:])


def test_recorder_step_over_a_finished_run_on_a_fixed_clock(monkeypatch):
    """Two recorder steps around a finished run, on a fixed clock: the raw
    probes read the same counters (rows in and out, the tick, the serving
    and request planes absent), so the points, the verdict and the
    ``/timeline`` payload are equal."""
    monkeypatch.setenv("PATHWAY_TIMELINE", "on")
    monkeypatch.setenv("PATHWAY_AUDIT", "off")
    out = {}
    for name, (pw, timeline, bottleneck, *_r) in SIDES.items():
        pw.G.clear()
        t = pw.debug.table_from_rows(pw.schema_from_types(x=int), [(i, i // 8, 1) for i in range(64)], is_stream=True)
        g = t.groupby(m=t.x % 3).reduce(s=pw.reducers.sum(pw.this.x)) if False else \
            t.with_columns(m=t.x % 3).groupby(pw.this.m).reduce(s=pw.reducers.sum(pw.this.x))
        pw.io.subscribe(g, on_change=lambda **k: None)
        pw.run(monitoring_level="none")
        finished = pw.internals.run.current_runtime().scheduler
        rt = _RT()
        clock = iter([1000.0, 1010.0, 1020.0])

        class Clock:
            @staticmethod
            def time():
                return next(clock)

        monkeypatch.setattr(timeline, "_time", Clock)
        plane = timeline.TimelinePlane(_cfg(pw), rt)
        first = plane.sample_now()
        rt.scheduler = finished
        second = plane.sample_now()
        third = plane.sample_now()
        keep = ("t", "tick", "tick_rate", "rows_in_per_s", "rows_out_per_s", "backlog_rows")
        points = [{k: p[k] for k in keep if k in p} for p in (second, third)]
        out[name] = (first, points, plane.bottleneck, plane.payload({"metric": ["rows_in_per_s"]}),
                     plane.status_summary())
        monkeypatch.undo()
        monkeypatch.setenv("PATHWAY_TIMELINE", "on")
        monkeypatch.setenv("PATHWAY_AUDIT", "off")
        pw.G.clear()
    assert out["port"] == out["ref"]
    first, points, _verdict, payload, _status = out["port"]
    assert first is None
    assert points[0]["rows_in_per_s"] == pytest.approx(6.4) and points[1]["rows_in_per_s"] == 0.0
    assert payload["points"] == [{"t": 1010.0, "v": 6.4}, {"t": 1020.0, "v": 0.0}]


# ------------------------------------------------------- burn-rate ladder


def _mk_sample(pw, t, responses=0, timeouts=0, canary=None, hb_misses=0):
    return {
        "t": t,
        "routes": {"/q": {"requests": 0, "responses": responses, "errors": 0, "timeouts": timeouts,
                          "latency": _hist(pw, {})}},
        "canary": canary or {},
        "hb_misses": hb_misses,
    }


def test_burn_ladder_ticket_rung_then_escalates_to_page(monkeypatch):
    """A sustained burn between the ticket and page thresholds files a
    ticket-severity alert; crossing the page rung later upgrades the SAME
    active entry in place and never demotes."""
    monkeypatch.setenv("PATHWAY_SLO_AVAILABILITY", "0.999")
    out = {}
    for name, (pw, _t, _b, _m, health, alerts) in SIDES.items():
        plane = health.HealthPlane(_cfg(pw))
        plane.registry = alerts.AlertRegistry(plane.cfg)
        samples = iter([
            _mk_sample(pw, 0.0),
            _mk_sample(pw, 30.0, responses=992, timeouts=8),  # burn 8: ticket rung
            _mk_sample(pw, 31.0, responses=800, timeouts=200),  # burn 200: page rung
            _mk_sample(pw, 32.0, responses=992, timeouts=8),  # back to the ticket band
        ])
        monkeypatch.setattr(plane, "_sample", lambda samples=samples: next(samples))
        trail = []
        for _ in range(4):
            plane.evaluate()
            trail.append([(a["alert"], a["severity"], a["summary"]) for a in plane.registry.active_alerts()])
        out[name] = (trail, dict(plane.registry.fired_total))
    assert out["port"] == out["ref"]
    trail, fired = out["port"]
    assert trail[1][0][1] == "ticket" and "ticket thresholds 6.0/1.0" in trail[1][0][2]
    assert trail[2][0][1] == trail[3][0][1] == "page"  # never demoted while active
    assert fired == {"slo_availability_burn": 1}


# -------------------------------------------------- pod incident bundles


def test_pod_bundle_merges_fragments_once_with_timeline_window(monkeypatch, tmp_path):
    monkeypatch.setenv("PATHWAY_TIMELINE", "on")
    monkeypatch.setenv("PATHWAY_TIMELINE_STEP_MS", "60000")
    now = time.time()
    out = {}
    for name, (pw, timeline, _b, _m, _h, alerts) in SIDES.items():
        monkeypatch.setenv("PATHWAY_INCIDENT_DIR", str(tmp_path / name))
        alerts._pod_bundled.clear()
        registry = alerts.AlertRegistry(_cfg(pw))
        registry.fragments.append({"alert": "slo_latency_burn", "fingerprint": "/q", "severity": "ticket",
                                   "summary": "local", "fired_unix": now, "bundle": None, "process_id": 0})
        rt = _ClusterRT()
        rt.hb_monitor.peers = {1: {"health": {"fragments": [
            {"alert": "slo_latency_burn", "fingerprint": "/q", "severity": "page", "summary": "peer",
             "fired_unix": now + 0.2, "bundle": "/tmp/x.json", "process_id": 1}
        ]}}}
        tplane = timeline.install_from_env(rt)
        try:
            tplane.points.append({"t": now - 10.0, "serve_qps": 3.0})
            written = alerts.merge_pod_bundles(rt, registry)
            assert len(written) == 1, name
            doc = json.loads(open(written[0]).read())
            doc.pop("captured_unix")
            again = alerts.merge_pod_bundles(rt, registry)  # same activation: deduped
            out[name] = (doc, os.path.basename(written[0]).rsplit("-", 1)[0], again)
        finally:
            timeline.shutdown()
    assert out["port"] == out["ref"]
    doc, stem, again = out["port"]
    assert doc["kind"] == "pathway_pod_incident_bundle" and doc["severity"] == "page"
    assert doc["processes"] == [0, 1] and doc["pod_timeline_window"][0]["serve_qps"] == 3.0
    assert stem == "pod-incident-slo_latency_burn-_q-page" and again == []


def test_incident_bundle_carries_the_local_window(monkeypatch, tmp_path):
    monkeypatch.setenv("PATHWAY_TIMELINE", "on")
    monkeypatch.setenv("PATHWAY_TIMELINE_STEP_MS", "60000")
    out = {}
    for name, (_pw, timeline, _b, _m, _h, alerts) in SIDES.items():
        tplane = timeline.install_from_env(_RT())
        try:
            for i in range(5):
                tplane.points.append({"t": 1000.0 + 60 * i, "serve_qps": float(i)})
            tplane.bottleneck = {"top": None, "ranked": [], "window_s": 60.0}
            path = alerts.write_incident_bundle({"alert": "x", "fingerprint": "/q", "severity": "page"}, _RT(),
                                                str(tmp_path / name))
            doc = json.loads(open(path).read())
        finally:
            timeline.shutdown()
        out[name] = (doc["timeline_window"], doc["bottleneck"])
    assert out["port"] == out["ref"]
    assert [p["t"] for p in out["port"][0]] == [1120.0, 1180.0, 1240.0]  # the last 120 s of points


# ------------------------------------------- seeded stall (e2e, the needle)


def test_seeded_stall_attribution_and_pod_bundle(monkeypatch, tmp_path):
    """A 0.4 s injected stage delay makes the bottleneck attributor name that
    stage as the top cause on both sides, ``/status`` shows the same verdict,
    and the activation leaves one pod bundle carrying the lead-up window."""
    needle = "needle-313"
    for k, v in {"PATHWAY_HEALTH": "on", "PATHWAY_HEALTH_EVAL_MS": "100", "PATHWAY_CANARY_INTERVAL_MS": "0",
                 "PATHWAY_REQUEST_TRACE": "on", "PATHWAY_REQUEST_TRACE_SLOW_MS": "150",
                 "PATHWAY_SERVE_COALESCE_MS": "2", "PATHWAY_TIMELINE": "on",
                 "PATHWAY_TIMELINE_STEP_MS": "100"}.items():
        monkeypatch.setenv(k, v)
    out = {}
    for name, (pw, timeline, _b, mon, health, _a) in SIDES.items():
        incidents = tmp_path / name / "incidents"
        monkeypatch.setenv("PATHWAY_INCIDENT_DIR", str(incidents))
        monkeypatch.setenv("PATHWAY_TIMELINE_DIR", str(tmp_path / name / "segments"))
        port = free_port()
        health.reset_slos()
        pw.set_slo(p99_ms=125.0)
        pw.G.clear()
        queries, respond = pw.io.http.rest_connector(host="127.0.0.1", port=port,
                                                     schema=pw.schema_from_types(query=str))

        def work(q: str) -> str:
            if q == needle:
                time.sleep(0.4)  # the injected stage delay
            return q.upper()

        respond(queries.select(result=pw.apply(work, queries.query)))
        got: dict = {}

        def orchestrate(port=port, got=got, incidents=incidents, timeline=timeline, mon=mon, pw=pw):
            try:
                wait_ready(port, pw)
                for i in range(6):
                    q = needle if i == 3 else f"q-{i}"
                    req = urllib.request.Request(f"http://127.0.0.1:{port}/", data=json.dumps({"query": q}).encode(),
                                                 headers={"Content-Type": "application/json"})
                    assert json.loads(urllib.request.urlopen(req, timeout=60).read()) == q.upper()
                deadline = time.monotonic() + 15
                while time.monotonic() < deadline:
                    plane = timeline.current()
                    top = ((plane.bottleneck if plane is not None else None) or {}).get("top")
                    if top and top["cause"].startswith("stage:sweep/") and list(incidents.glob("pod-incident-*.json")):
                        break
                    time.sleep(0.05)
                plane = timeline.current()
                got["verdict"] = dict(plane.bottleneck or {})
                got["status_bn"] = mon.run_stats(pw.internals.run.current_runtime()).get("bottleneck")
            except Exception as e:  # surfaced by the asserts below
                got["error"] = repr(e)
            finally:
                pw.internals.run.current_runtime().request_stop()

        th = threading.Thread(target=orchestrate)
        th.start()
        try:
            pw.run(monitoring_level="none")
        finally:
            th.join()
            pw.G.clear()
            health.reset_slos()
        assert "error" not in got, (name, got)
        top = got["verdict"].get("top")
        assert top and top["cause"].startswith("stage:sweep/"), (name, got["verdict"])
        assert got["status_bn"] and got["status_bn"]["top"]["cause"] == top["cause"], name
        pod_files = sorted(incidents.glob("pod-incident-slo_latency_burn-*.json"))
        assert len(pod_files) == 1, (name, pod_files)
        doc = json.loads(pod_files[0].read_text())
        (proc_file,) = incidents.glob("incident-slo_latency_burn-*.json")
        proc_doc = json.loads(proc_file.read_text())
        segs = timeline.read_segments(str(tmp_path / name / "segments"))
        assert segs, f"{name}: no timeline segments spilled"
        out[name] = (top["cause"], top["knob"], doc["severity"], doc["processes"],
                     doc["bottleneck"]["top"]["cause"].split(":")[0], "timeline_window" in proc_doc)
    assert out["port"] == out["ref"]
    cause, knob, severity, procs, bundle_cause, window = out["port"]
    assert "PATHWAY_FUSE" in knob and severity == "page" and procs == [0]
    assert bundle_cause == "stage" and window


def test_pod_merge_rules_and_peer_retirement(monkeypatch):
    """A peer's heartbeat points fold into the coordinator's pod rollup
    (rates and phase ms sum, p99 takes the worst process, the tick the
    slowest) and drop out when the monitor forgets the peer: the same
    rollups in both packages."""
    monkeypatch.setenv("PATHWAY_TIMELINE", "on")
    out = {}
    for name, (pw, timeline, *_rest) in SIDES.items():
        rt = _ClusterRT()
        plane = timeline.TimelinePlane(_cfg(pw), rt)
        plane.points.append(
            {"t": 1000.0, "tick": 30, "serve_qps": 5.0, "route_p99_s:/q": 0.010, "phase_ms:probe": 100.0}
        )
        rt.hb_monitor.peers = {
            1: {"timeline": {"points": [
                {"t": 1000.1, "tick": 20, "serve_qps": 7.0, "route_p99_s:/q": 0.050, "phase_ms:probe": 40.0}
            ], "samples": 3, "last_t": 1000.1}}
        }
        plane._merge_peers()
        merged = (plane.procs(), plane.pod_points(), plane.payload({"proc": ["pod"]}))
        rt.hb_monitor.peers = {}
        plane._merge_peers()
        out[name] = (merged, plane.procs(), plane.pod_points())
    assert out["port"] == out["ref"]
    (procs, pod, body), procs_after, pod_after = out["port"]
    assert procs == ["0", "1"] and len(pod) == 1
    b = pod[0]
    assert b["procs"] == 2 and b["tick"] == 20
    assert b["serve_qps"] == pytest.approx(12.0)
    assert b["route_p99_s:/q"] == pytest.approx(0.050)
    assert b["phase_ms:probe"] == pytest.approx(140.0)
    assert body["proc"] == "pod" and body["points"][0]["procs"] == 2
    assert procs_after == ["0"] and pod_after[0]["procs"] == 1


def test_heartbeat_piggyback_and_cluster_rollup(monkeypatch):
    """``aggregate.local_summary`` carries the compressed series block; the
    coordinator's ``cluster_status`` rolls the reporting pids and sample
    counts up — the same in both packages."""
    monkeypatch.setenv("PATHWAY_TIMELINE", "on")
    monkeypatch.setenv("PATHWAY_TIMELINE_STEP_MS", "60000")
    from pathway_tpu.observability import aggregate as ref_agg
    from pathway_tpu_torch.observability import aggregate as port_agg

    out = {}
    for name, agg in (("ref", ref_agg), ("port", port_agg)):
        timeline = SIDES[name][1]
        rt = _ClusterRT()
        plane = timeline.install_from_env(rt)
        try:
            plane.points.append({"t": 1000.0, "serve_qps": 1.0})
            local = agg.local_summary(rt)
            rt.hb_monitor.peers = {
                1: {"timeline": {"points": [{"t": 1000.5, "serve_qps": 2.0}], "samples": 9, "last_t": 1000.5}}
            }
            cluster = agg.cluster_status(rt)
            out[name] = (local["timeline"]["points"][-1], local["timeline"]["samples"] - plane.samples_total,
                         cluster["timeline"]["reporting"], cluster["timeline"]["samples"] - plane.samples_total,
                         cluster["timeline"]["last_t"])
        finally:
            timeline.shutdown()
    assert out["port"] == out["ref"] == ({"t": 1000.0, "serve_qps": 1.0}, 0, ["0", "1"], 9, 1000.5)
