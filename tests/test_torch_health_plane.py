"""The port's health plane and alert registry (``pathway_tpu_torch/
observability/{health,alerts}.py``) against the reference's, on the same
inputs.

Mirrors ``tests/test_health_plane.py``'s single-process cases: the door state
machine's transitions, ``healthz_payload`` / ``readyz_payload`` bodies (equal
with their clock fields dropped), multi-window burn rates over injected
samples (the evaluator's clock is the samples' ``t``), the detectors, SLO
declarations, the alert registry (fire, refresh, resolve, sync, sinks with
retry and dedupe), incident bundles, and one served run: canaries never count
as traffic, both the door and the monitoring server answer ``/healthz``,
``/readyz`` and ``/alerts``, and a draining pod answers ``/readyz``,
``/status`` and ``/metrics`` with 503 and ``Retry-After``. The port has no
Slack connector yet: asking for the Slack sink raises ``later_slice``.

Reference runs set ``PATHWAY_AUDIT=off`` and ``PATHWAY_TIMELINE=off``
through ``monkeypatch``, which both packages read. Every server binds a port
reserved by ``torch_http_helpers.free_port``.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request

import pytest

import pathway_tpu
import pathway_tpu_torch
from pathway_tpu.internals.config import get_pathway_config as ref_config
from pathway_tpu.observability import alerts as ref_alerts
from pathway_tpu.observability import health as ref_health
from pathway_tpu_torch.internals.config import get_pathway_config as port_config
from pathway_tpu_torch.observability import alerts as port_alerts
from pathway_tpu_torch.observability import health as port_health
from torch_http_helpers import free_port, release_port, wait_ready

SIDES = {
    "ref": (ref_health, ref_alerts, ref_config),
    "port": (port_health, port_alerts, port_config),
}
#: fields that hold a clock reading, or a path named by one
_CLOCK = ("since_unix", "t_unix", "fired_unix", "last_seen_unix", "resolved_unix", "captured_unix", "last_s",
          "bundle")


def _drop_clock(x):
    if isinstance(x, dict):
        return {k: _drop_clock(v) for k, v in x.items() if k not in _CLOCK}
    if isinstance(x, (list, tuple)):
        return type(x)(_drop_clock(v) for v in x)
    return x


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("PATHWAY_AUDIT", "off")
    monkeypatch.setenv("PATHWAY_TIMELINE", "off")
    for k in ("PATHWAY_HEALTH", "PATHWAY_SLO_AVAILABILITY", "PATHWAY_SLO_P99_MS", "PATHWAY_INCIDENT_DIR",
              "PATHWAY_ALERT_ERROR_RATE", "PATHWAY_ALERT_HEARTBEAT_FLAPS", "PATHWAY_CANARY_INTERVAL_MS",
              "PATHWAY_HEALTH_EVAL_MS", "PATHWAY_ALERT_SLACK_CHANNEL", "PATHWAY_ALERT_SLACK_TOKEN"):
        monkeypatch.delenv(k, raising=False)
    for health, _alerts, _cfg in SIDES.values():
        health.reset_slos()
    yield
    for health, _alerts, _cfg in SIDES.values():
        health.reset_slos()


def _mk_sample(t, responses=0, timeouts=0, requests=0, errors=0,
               slow_count=0, fast_count=0, canary=None, hb_misses=0):
    """One synthetic evaluator sample for route /q: ``fast_count`` requests in
    the 2^-6 s bucket, ``slow_count`` in the 2^-1 s bucket."""
    from pathway_tpu_torch.observability.metrics import BUCKET_BOUNDS_S

    counts = [0] * (len(BUCKET_BOUNDS_S) + 1)
    counts[6] = fast_count
    counts[11] = slow_count
    return {
        "t": t,
        "routes": {"/q": {"requests": requests, "responses": responses, "errors": errors,
                          "timeouts": timeouts,
                          "latency": {"counts": counts, "sum_s": 0.0, "count": sum(counts)}}},
        "canary": canary or {},
        "hb_misses": hb_misses,
    }


# ----------------------------------------------------------- state machine


def _walk(health, cfg):
    plane = health.HealthPlane(cfg())
    states = [plane.door_state()]
    plane.door_syncing(("ix", "/r", 1))
    states.append(plane.door_state())
    plane.mark_ready()
    states.append(plane.door_state())
    plane.door_synced(("ix", "/r", 1))
    states.append(plane.door_state())
    plane.door_syncing("a")
    plane.door_syncing("b")
    plane.door_synced("a")
    states += [plane.door_state(), tuple(plane.syncing_tokens())]
    plane.door_synced("b")
    plane.mark_draining("rescale")
    plane.mark_ready()
    plane.mark_draining("other")
    states += [plane.door_state(), plane.drain_reason(), plane.quiescing()]
    plane.mark_stopped()
    states += [plane.door_state(), [s for s, _t in plane.transitions]]
    return states


def test_door_state_machine_transitions_match():
    port, ref = (_walk(h, c) for h, _a, c in (SIDES["port"], SIDES["ref"]))
    assert port == ref
    assert port[-1] == ["starting", "ready", "draining", "stopped"]


def test_healthz_readyz_payloads_match(monkeypatch):
    seq = {}
    for name, (health, _alerts, cfg) in SIDES.items():
        out = []
        monkeypatch.setattr(health, "_plane", None)
        out += [health.healthz_payload(), health.readyz_payload(), health.status(None),
                health.prometheus_lines(None), health.heartbeat_summary()]
        plane = health.HealthPlane(cfg())
        monkeypatch.setattr(health, "_plane", plane)
        out.append(health.readyz_payload())
        plane.mark_ready()
        out += [health.readyz_payload(), health.healthz_payload()]
        plane.door_syncing(("ix", "/v1", 0))
        out.append(health.readyz_payload())
        plane.door_synced(("ix", "/v1", 0))
        plane.mark_draining("rescale")
        out += [health.readyz_payload(), health.healthz_payload(), health.quiescing()]
        plane.mark_stopped()
        out += [health.healthz_payload(), _drop_clock(plane.status()), plane.heartbeat_summary()]
        seq[name] = out
    assert seq["port"] == seq["ref"]
    assert seq["port"][0] == (200, {"alive": True, "health": "off"})
    assert seq["port"][5] == (503, {"ready": False, "state": "starting"}, {"Retry-After": "1"})
    assert seq["port"][9][0] == 503 and seq["port"][9][2] == {"Retry-After": "5"}


def test_install_off_and_on(monkeypatch):
    monkeypatch.setenv("PATHWAY_HEALTH", "off")
    assert port_health.install_from_env(None) is None and port_alerts.current() is None
    monkeypatch.setenv("PATHWAY_HEALTH", "on")
    monkeypatch.setenv("PATHWAY_CANARY_INTERVAL_MS", "0")
    monkeypatch.setenv("PATHWAY_HEALTH_EVAL_MS", "10000")
    try:
        plane = port_health.install_from_env(None)
        assert plane is port_health.current() and plane.registry is port_alerts.current() is not None
    finally:
        port_health.shutdown()
    assert port_health.current() is None and port_alerts.current() is None
    for k in ("health", "health_eval_ms", "canary_interval_ms", "canary_timeout_ms", "slo_availability",
              "slo_p99_ms", "slo_fast_window_s", "slo_slow_window_s", "slo_burn_fast", "slo_burn_slow"):
        assert getattr(port_config(), k) == getattr(ref_config(), k)


# ------------------------------------------------------------ burn rates


@pytest.mark.parametrize(
    "case",
    ["availability", "latency", "canary_only", "below_threshold"],
)
def test_window_burns_match(case, monkeypatch):
    monkeypatch.setenv("PATHWAY_SLO_AVAILABILITY", "0.99")
    burns = {}
    for name, (health, _alerts, cfg) in SIDES.items():
        if case == "latency":
            health.set_slo(route="/q", p99_ms=100.0)
        plane = health.HealthPlane(cfg())
        plane._samples.append(_mk_sample(0.0))
        plane._samples.append({
            "availability": _mk_sample(100.0, responses=80, timeouts=20),
            "latency": _mk_sample(100.0, responses=50, fast_count=45, slow_count=5),
            "canary_only": _mk_sample(100.0, canary={"/q": (10, 2)}),
            "below_threshold": _mk_sample(100.0, responses=100),
        }[case])
        burns[name] = (plane._window_burns(60.0), plane._window_burns(3600.0))
        health.reset_slos()
    assert burns["port"] == burns["ref"]
    expect = {"availability": ("availability", 0.2 / 0.01), "latency": ("latency:/q", 10.0),
              "canary_only": ("availability", (2 / 10) / 0.01), "below_threshold": ("availability", 0.0)}[case]
    assert burns["port"][0][expect[0]] == pytest.approx(expect[1])


def test_evaluate_fires_resolves_and_bundles_once(monkeypatch, tmp_path):
    """Availability burn over injected samples: both windows over threshold
    fire ``slo_availability_burn`` (page), a refresh writes no second bundle,
    recovery auto-resolves — the same sequence on both sides."""
    from pathway_tpu.observability import requests as ref_req
    from pathway_tpu_torch.observability import requests as port_req

    monkeypatch.setenv("PATHWAY_SLO_AVAILABILITY", "0.999")
    # the probable stage reads the last request plane of this process: none
    for req in (ref_req, port_req):
        monkeypatch.setattr(req, "_plane", None)
        monkeypatch.setattr(req, "_last", None)
    seq = {}
    for name, (health, alerts, cfg) in SIDES.items():
        monkeypatch.setenv("PATHWAY_INCIDENT_DIR", str(tmp_path / name))
        plane = health.HealthPlane(cfg())
        plane.registry = alerts.AlertRegistry(plane.cfg)
        samples = iter([
            _mk_sample(0.0),
            _mk_sample(100.0, responses=80, timeouts=20),
            _mk_sample(101.0, responses=80, timeouts=20),
            _mk_sample(200.0, responses=80, timeouts=20),
        ])
        monkeypatch.setattr(plane, "_sample", lambda s=samples: next(s))
        out = []
        for _ in range(4):
            breaches = plane.evaluate()
            out.append((_drop_clock(breaches), dict(plane.burn), dict(plane.budget_remaining),
                        _drop_clock(plane.registry.active_alerts())))
        bundles = sorted((tmp_path / name).glob("incident-*.json"))
        doc = json.loads(bundles[0].read_text())
        out.append((len(bundles), doc["kind"], doc["alert"]["alert"], "flight" in doc,
                    plane.registry.fired_total))
        seq[name] = out
    assert seq["port"] == seq["ref"]
    assert seq["port"][-1] == (1, "pathway_incident_bundle", "slo_availability_burn", True,
                               {"slo_availability_burn": 1})
    assert seq["port"][3][3] == []  # resolved after recovery


def test_detectors_and_slo_declarations_match(monkeypatch):
    monkeypatch.setenv("PATHWAY_ALERT_ERROR_RATE", "0.10")
    monkeypatch.setenv("PATHWAY_ALERT_HEARTBEAT_FLAPS", "3")
    monkeypatch.setenv("PATHWAY_SLO_AVAILABILITY", "0.999")
    monkeypatch.setenv("PATHWAY_SLO_P99_MS", "250")
    out = {}
    for name, (health, _alerts, cfg) in SIDES.items():
        plane = health.HealthPlane(cfg())
        plane._samples.append(_mk_sample(0.0))
        plane._samples.append(_mk_sample(10.0, requests=40, responses=30, errors=8, timeouts=2, hb_misses=4))
        hot = plane._detectors()
        plane2 = health.HealthPlane(cfg())
        plane2._samples.append(_mk_sample(0.0))
        plane2._samples.append(_mk_sample(10.0, requests=40, responses=40))
        before = plane._objectives()
        health.set_slo(route="/v1", p99_ms=50, availability=0.995)
        out[name] = (hot, plane2._detectors(), before, plane._objectives(),
                     [ln for ln in plane.prometheus_lines() if "slo_target" in ln])
        health.reset_slos()
    assert out["port"] == out["ref"]
    assert {b["alert"] for b in out["port"][0]} == {"error_rate_spike", "heartbeat_flap"}
    assert out["port"][1] == []
    assert out["port"][2] == (0.999, {None: 250.0}) and out["port"][3] == (0.995, {"/v1": 50.0})


# -------------------------------------------------------------- the registry


def test_alert_registry_and_sinks_match(monkeypatch):
    out = {}
    for name, (_health, alerts, cfg) in SIDES.items():
        reg = alerts.AlertRegistry(cfg())
        sent: list[dict] = []
        reg.sinks = [alerts.NotificationSink(transport=sent.append)]
        steps = [reg.fire("watermark_stall", fingerprint="docs:0", summary="120s behind")["count"]]
        steps.append(reg.fire("watermark_stall", fingerprint="docs:0")["count"])
        steps += [len(sent), dict(reg.fired_total), reg.prometheus_lines(), _drop_clock(reg.heartbeat_summary())]
        steps += [reg.resolve("watermark_stall", "docs:0"), reg.resolve("watermark_stall", "docs:0")]
        reg.sync([{"alert": "error_rate_spike", "fingerprint": "/q", "summary": "x"}])
        steps.append([e["alert"] for e in reg.active_alerts()])
        reg.sync([])
        steps += [reg.active_alerts(), _drop_clock(reg.status_summary())]
        # a failing transport: bounded retry with doubling backoff, then dedupe
        calls, sleeps = [], []

        def flaky(payload, calls=calls):
            calls.append(payload)
            raise OSError("down")

        sink = alerts.NotificationSink(max_retries=2, backoff_s=0.1, transport=flaky)
        sink._sleep = sleeps.append
        steps += [sink.notify({"alert": "a", "fingerprint": "f"}), len(calls), sleeps, sink.counters()]
        ok = alerts.NotificationSink(transport=lambda p: None)
        steps += [ok.notify({"alert": "a", "fingerprint": "f"}), ok.notify({"alert": "a", "fingerprint": "f"}),
                  ok.counters()]
        out[name] = steps
    assert out["port"] == out["ref"]
    assert out["port"][:3] == [1, 2, 1]


def test_storm_alert_reaches_the_registry_and_slack_is_a_later_slice(monkeypatch):
    monkeypatch.setenv("PATHWAY_HEALTH", "on")
    from pathway_tpu.observability import device as ref_dev
    from pathway_tpu_torch.observability import device as port_dev

    active = {}
    for name, (_health, alerts, _cfg), dev in (("ref", SIDES["ref"], ref_dev), ("port", SIDES["port"], port_dev)):
        try:
            reg = alerts.install_from_env(None)
            dev._storm_alert("embed", 12)
            reg.sync([])  # not detector-managed: a sweep never resolves it
            active[name] = _drop_clock(reg.active_alerts())
        finally:
            alerts.shutdown()
    assert active["port"] == active["ref"]
    assert [(a["alert"], a["fingerprint"], a["auto"]) for a in active["port"]] == [("recompile_storm", "embed", False)]
    monkeypatch.setenv("PATHWAY_ALERT_SLACK_CHANNEL", "#ops")
    monkeypatch.setenv("PATHWAY_ALERT_SLACK_TOKEN", "t")
    with pytest.raises(NotImplementedError, match="later slice: io.slack"):
        port_alerts.install_from_env(None)
    port_alerts.shutdown()


# ------------------------------------------------------------ a served run


def _get(url: str, headers: dict | None = None):
    req = urllib.request.Request(url, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=15) as r:
            raw, hdrs, status = r.read().decode(), dict(r.headers), r.status
    except urllib.error.HTTPError as e:
        with e:
            raw, hdrs, status = e.read().decode(), dict(e.headers), e.code
    try:
        return status, json.loads(raw), hdrs
    except ValueError:
        return status, raw, hdrs


def _post(url: str, payload: dict, headers: dict | None = None):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
    )
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        with e:
            return e.code, json.loads(e.read()), dict(e.headers)


def test_canaries_door_endpoints_and_quiesce_503(monkeypatch):
    """Canaries probe the door without counting as traffic; the door and the
    monitoring server answer the health endpoints; draining answers 503 with
    ``Retry-After`` on ``/readyz``, ``/status`` and ``/metrics`` while
    ``/healthz`` and ``/alerts`` stay up."""
    from pathway_tpu_torch.io.http import _server as srv_mod

    pw = pathway_tpu_torch
    port, mon_port = free_port(), free_port()
    release_port(mon_port)  # the monitoring server binds before the run
    monkeypatch.setenv("PATHWAY_HEALTH", "on")
    monkeypatch.setenv("PATHWAY_HEALTH_EVAL_MS", "100")
    monkeypatch.setenv("PATHWAY_CANARY_INTERVAL_MS", "50")
    monkeypatch.setenv("PATHWAY_MONITORING_HTTP_PORT", str(mon_port))
    pw.G.clear()
    queries, respond = pw.io.http.rest_connector(host="127.0.0.1", port=port, schema=pw.schema_from_types(query=str))
    respond(queries.select(result=pw.apply(str.upper, queries.query)))
    out: dict = {}
    errors: list[BaseException] = []

    def target():
        try:
            pw.run(monitoring_level="none", with_http_server=True)
        except BaseException as e:  # surfaced below
            errors.append(e)

    th = threading.Thread(target=target, daemon=True)
    th.start()
    try:
        wait_ready(port)
        rt = pw.internals.run.current_runtime()
        for i in range(3):
            _post(f"http://127.0.0.1:{port}/", {"query": f"q{i}"})
        plane = port_health.current()
        deadline = time.monotonic() + 10
        while plane.canary_snapshot().get("/", {}).get("requests", 0) < 5 and time.monotonic() < deadline:
            time.sleep(0.05)
        rs = next(r for r in list(srv_mod._ROUTES) if r.route == "/" and r.runtime is rt)
        out["requests_total"] = rs.requests_total
        out["canary"] = plane.canary_snapshot()
        before = rs.requests_total
        out["manual_canary"] = _post(f"http://127.0.0.1:{port}/", {}, headers={"X-Pathway-Canary": "1"})[:2]
        out["counter_after_manual"] = rs.requests_total - before
        for where, p in (("door", port), ("mon", mon_port)):
            out[f"{where}_healthz"] = _get(f"http://127.0.0.1:{p}/healthz")
            out[f"{where}_readyz"] = _get(f"http://127.0.0.1:{p}/readyz")
        out["alerts"] = _get(f"http://127.0.0.1:{mon_port}/alerts")
        out["status"] = _get(f"http://127.0.0.1:{mon_port}/status")
        out["metrics"] = _get(f"http://127.0.0.1:{mon_port}/metrics")[1]
        plane.mark_draining("rescale")
        out["status_draining"] = _get(f"http://127.0.0.1:{mon_port}/status")
        out["metrics_draining"] = _get(f"http://127.0.0.1:{mon_port}/metrics")
        out["readyz_draining"] = _get(f"http://127.0.0.1:{port}/readyz")
        out["alerts_draining"] = _get(f"http://127.0.0.1:{mon_port}/alerts")
        out["healthz_draining"] = _get(f"http://127.0.0.1:{mon_port}/healthz")
    finally:
        rt = pw.internals.run.current_runtime()
        if rt is not None:
            rt.request_stop()
        th.join(timeout=60)
        pw.G.clear()
    assert not th.is_alive() and not errors, errors
    assert out["requests_total"] == 3
    assert out["canary"]["/"]["requests"] >= 5 and out["canary"]["/"]["failed"] == 0
    assert out["manual_canary"] == (200, {"canary": True, "state": "ready", "route": "/"})
    assert out["counter_after_manual"] == 0
    for where in ("door", "mon"):
        assert out[f"{where}_healthz"][:2] == (200, {"alive": True, "state": "ready"})
        assert out[f"{where}_readyz"][:2] == (200, {"ready": True, "state": "ready"})
    assert out["alerts"][0] == 200 and out["alerts"][1]["ok"] is True
    assert out["status"][0] == 200 and out["status"][1]["health"]["state"] == "ready"
    for series in ("pathway_door_ready 1", 'pathway_door_state{state="ready"} 1',
                   'pathway_slo_target{slo="availability"}', 'pathway_canary_requests_total{route="/"}'):
        assert series in out["metrics"]
    assert out["status_draining"][0] == 503 and out["status_draining"][1]["reason"] == "rescale"
    assert out["status_draining"][2]["Retry-After"] == "5"
    assert out["metrics_draining"][0] == 503
    assert out["readyz_draining"][0] == 503 and out["readyz_draining"][1]["reason"] == "rescale"
    assert out["readyz_draining"][2]["Retry-After"] == "5"
    assert out["alerts_draining"][0] == 200 and out["healthz_draining"][0] == 200
