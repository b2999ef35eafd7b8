"""The port's request-trace plane (``pathway_tpu_torch/observability/
requests.py``) against the reference's, on the same inputs.

Mirrors ``tests/test_request_trace.py``'s single-process cases: the derived
trace ids and the keep-hash slice, off mode and the knobs, one served
pipeline's kept flight path (stage names and order, span ids, parents and
trace ids, the same under both packages), the ``X-Pathway-Request-Id`` header
(the hex of the query row's engine key, unique across routes), the
``/request?id=`` endpoint of the monitoring server, the kept ring's eviction,
timeout and client-disconnect completions, and the plane's Prometheus series.
Times are never compared: decompositions and span times are wall clocks.

Every server binds a port reserved by ``torch_http_helpers.free_port`` and
is talked to once ``wait_ready`` holds; every ``pw.run`` thread is joined
with a bound. Both sides run with ``PATHWAY_AUDIT=off`` and
``PATHWAY_TIMELINE=off``, as before the port carried those planes
(``tests/test_torch_http_parity.py`` serves a route at every plane's
default).
"""

from __future__ import annotations

import json
import socket
import threading
import time
import urllib.error
import urllib.request

import pytest

import pathway_tpu
import pathway_tpu_torch
from pathway_tpu.internals.config import get_pathway_config as ref_config
from pathway_tpu.observability import requests as ref_req
from pathway_tpu.observability import spans as ref_spans
from pathway_tpu_torch.internals.config import get_pathway_config as port_config
from pathway_tpu_torch.observability import requests as port_req
from pathway_tpu_torch.observability import spans as port_spans
from torch_http_helpers import free_port, wait_ready

RUN_TIMEOUT = 60.0
PACKAGES = {"ref": (pathway_tpu, ref_req), "port": (pathway_tpu_torch, port_req)}


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("PATHWAY_AUDIT", "off")
    monkeypatch.setenv("PATHWAY_TIMELINE", "off")
    for k in ("PATHWAY_REQUEST_TRACE", "PATHWAY_REQUEST_TRACE_SLOW_MS", "PATHWAY_REQUEST_TRACE_KEEP",
              "PATHWAY_REQUEST_TRACE_KEPT", "PATHWAY_TRACE"):
        monkeypatch.delenv(k, raising=False)
    yield
    for pw, _mod in PACKAGES.values():
        pw.G.clear()


def _post(port: int, payload: dict, route: str = "/", timeout: float = 30.0):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{route}",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read()), dict(resp.headers)


def _get_json(url: str):
    try:
        with urllib.request.urlopen(url, timeout=10) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        with e:
            return e.code, json.loads(e.read())


def serve(pw, build, drive, port: int, **run_kwargs):
    """``build(pw, port)``; ``pw.run`` in a thread; ``drive(port)`` once the
    server is ready; the run stopped whatever ``drive`` does."""
    pw.G.clear()
    build(pw, port)
    errors: list[BaseException] = []

    def target():
        try:
            pw.run(monitoring_level="none", **run_kwargs)
        except BaseException as e:  # surfaced below
            errors.append(e)

    th = threading.Thread(target=target, daemon=True)
    th.start()
    try:
        wait_ready(port, pw)
        return drive(port)
    finally:
        deadline = time.monotonic() + 10
        while pw.internals.run.current_runtime() is None and time.monotonic() < deadline:
            time.sleep(0.01)
        pw.internals.run.current_runtime().request_stop()
        th.join(timeout=RUN_TIMEOUT)
        assert not th.is_alive(), "pw.run did not stop"
        if errors:
            raise errors[0]


def _upper(pw, port, route="/", webserver=None):
    class Q(pw.Schema):
        query: str

    kw = {"webserver": webserver} if webserver is not None else {"host": "127.0.0.1", "port": port}
    queries, respond = pw.io.http.rest_connector(route=route, schema=Q, **kw)
    respond(queries.select(result=pw.apply(str.upper, queries.query)))


# --------------------------------------------------------------- the hashes


@pytest.mark.parametrize("frac", [0.0, 0.01, 0.25, 1.0])
def test_trace_ids_and_keep_slice_equal_the_reference(frac):
    ids = [f"{k:016x}" for k in (1, 2, 3, 0xDEADBEEF, 2**63 + 5, 2**64 - 1)] + [f"{i:016x}" for i in range(200)]
    for rid in ids:
        assert port_req.derive_request_trace_id(rid) == ref_req.derive_request_trace_id(rid)
        assert port_req._span_id(rid, 3) == ref_req._span_id(rid, 3)
        assert port_req.keep_hash_sampled(rid, frac) == ref_req.keep_hash_sampled(rid, frac)
    for tick in range(300):
        assert port_spans.tick_hash_sampled(tick, frac) == ref_spans.tick_hash_sampled(tick, frac)
    assert port_spans.derive_trace_id("run-7") == ref_spans.derive_trace_id("run-7")
    assert port_spans.derive_root_span_id("ab" * 16) == ref_spans.derive_root_span_id("ab" * 16)


def test_off_mode_installs_no_plane_and_knobs_match(monkeypatch):
    for k in ("request_trace", "request_trace_slow_ms", "request_trace_keep", "request_trace_kept"):
        assert getattr(port_config(), k) == getattr(ref_config(), k)
    assert port_config().request_trace == "on"
    monkeypatch.setenv("PATHWAY_REQUEST_TRACE", "off")
    assert port_req.install_from_env() is None and port_req.current() is None
    from pathway_tpu_torch.engine.graph import EngineGraph, Scheduler

    sched = Scheduler(EngineGraph())
    sched.run_tick(0)
    assert sched._rp is None
    monkeypatch.setenv("PATHWAY_REQUEST_TRACE", "maybe")
    with pytest.raises(ValueError):
        port_config().request_trace


# ------------------------------------------------------- unit-driven flights


def _flight(mod, n: int, kept: int, statuses=None) -> tuple[list, dict]:
    """``n`` flights driven through a fresh plane with fixed stage times."""
    plane = mod.RequestTracePlane(port_config() if mod is port_req else ref_config())
    plane.kept_cap = kept
    docs = []
    for i in range(n):
        key = 1000 + i
        t0 = time.time_ns()
        plane.begin(key, "/r", t0)
        plane.note_tick(i)
        plane.note_stage(i, "sweep/select", t0 + 10, t0 + 20, rows=1)
        plane.note_stage(i, "index/search", t0 + 20, t0 + 30, rows=1)
        status = (statuses or {}).get(i, "ok")
        docs.append(plane.complete(key, status))
    return docs, plane


def _shape(doc):
    """The deterministic part of a kept trace: ids, names, parents, non-time
    attributes."""
    spans = [
        (s["name"], s["spanId"], s.get("parentSpanId"), s["traceId"],
         sorted((a["key"], json.dumps(a["value"])) for a in s["attributes"]))
        for s in doc["spans"]
    ]
    return doc["request_id"], doc["trace_id"], doc["route"], doc["status"], doc["first_tick"], spans


def test_kept_flights_and_ring_eviction_equal_the_reference(monkeypatch):
    monkeypatch.setenv("PATHWAY_REQUEST_TRACE_SLOW_MS", "0")  # keep everything
    (rdocs, rplane), (pdocs, pplane) = (_flight(m, 5, kept=3) for m in (ref_req, port_req))
    assert [_shape(d) for d in pdocs] == [_shape(d) for d in rdocs]
    names = [s["name"] for s in pdocs[0]["spans"]]
    assert names[:2] == ["request", "serve/admission"]
    assert names[-2:] == ["sweep/select", "index/search"]
    assert pplane.kept_ids() == rplane.kept_ids() == [f"{1000 + i:016x}" for i in (2, 3, 4)]
    summary = lambda p: {k: v for k, v in p.status_summary().items()}  # noqa: E731
    assert summary(pplane) == summary(rplane)
    unknown = "00000000000000ff"
    assert pplane.get_trace(unknown) == rplane.get_trace(unknown)
    assert pplane.get_trace(unknown)["ok"] is False


def test_timeout_and_cancel_are_kept_whatever_the_slow_bound(monkeypatch):
    monkeypatch.setenv("PATHWAY_REQUEST_TRACE_SLOW_MS", "100000")
    monkeypatch.setenv("PATHWAY_REQUEST_TRACE_KEEP", "0")
    out = {}
    for name, mod in (("ref", ref_req), ("port", port_req)):
        docs, plane = _flight(mod, 3, kept=8, statuses={1: "timeout", 2: "cancelled"})
        out[name] = ([d is not None for d in docs], plane.status_summary()["by_status"])
    assert out["port"] == out["ref"] == ([False, True, True], {"ok": 1, "timeout": 1, "cancelled": 1})


def test_stage_histogram_series_equal_the_reference(monkeypatch):
    monkeypatch.setenv("PATHWAY_REQUEST_TRACE_SLOW_MS", "0")
    series = {}
    for name, mod in (("ref", ref_req), ("port", port_req)):
        _docs, plane = _flight(mod, 4, kept=8)
        series[name] = [ln.rsplit(" ", 1)[0] for ln in plane.prometheus_lines()]
    assert series["port"] == series["ref"]
    assert any('stage="index/search"' in ln for ln in series["port"])


# -------------------------------------------------------- a served pipeline


def _one_request(pw, mod):
    out = {}

    def drive(port):
        body, headers = _post(port, {"query": "hello"})
        rid = headers["X-Pathway-Request-Id"]
        plane = mod.current()
        deadline = time.monotonic() + 10
        while rid not in plane.kept_ids() and time.monotonic() < deadline:
            time.sleep(0.01)
        out.update(body=body, rid=rid, doc=plane.get_trace(rid))
        return out

    return serve(pw, _upper, drive, free_port())


def test_served_flight_path_stage_names_equal_the_reference(monkeypatch):
    """One request through ``rest_connector`` → ``select(apply)`` →
    response: the kept flight path names the same stages in the same order
    under both packages, every span parented to the request root under one
    derived trace id."""
    monkeypatch.setenv("PATHWAY_REQUEST_TRACE_SLOW_MS", "0")
    runs = {name: _one_request(pw, mod) for name, (pw, mod) in PACKAGES.items()}
    names = {}
    for name, run in runs.items():
        doc = run["doc"]
        assert run["body"] == "HELLO"
        assert doc["ok"] and doc["kept"] and doc["status"] == "ok"
        assert doc["trace_id"] == ref_req.derive_request_trace_id(run["rid"])
        root = doc["spans"][0]
        assert root["name"] == "request"
        for s in doc["spans"][1:]:
            assert s["traceId"] == doc["trace_id"] and s["parentSpanId"] == root["spanId"]
        names[name] = [s["name"] for s in doc["spans"]]
    assert names["port"] == names["ref"]
    assert "serve/admission" in names["port"] and "serve/respond" in names["port"]
    assert any(n.startswith("sweep/") for n in names["port"])


def test_request_id_header_is_the_engine_key_and_unique_across_routes(monkeypatch):
    from pathway_tpu_torch.io.http import _server as S

    monkeypatch.setenv("PATHWAY_REQUEST_TRACE_SLOW_MS", "0")
    keys: list[int] = []
    mint = S.mint_request_key

    def recording_mint() -> int:
        key = mint()
        keys.append(key)
        return key

    monkeypatch.setattr(S, "mint_request_key", recording_mint)
    pw = pathway_tpu_torch

    def build(pw, port):
        ws = pw.io.http.PathwayWebserver(host="127.0.0.1", port=port)
        _upper(pw, port, route="/a", webserver=ws)
        _upper(pw, port, route="/b", webserver=ws)

    def drive(port):
        ids = []
        for i in range(4):
            for route in ("/a", "/b"):
                body, headers = _post(port, {"query": f"q{i}"}, route=route)
                assert body == f"Q{i}"
                ids.append(headers["X-Pathway-Request-Id"])
        plane = port_req.current()
        deadline = time.monotonic() + 10
        while plane.status_summary()["completed_total"] < 8 and time.monotonic() < deadline:
            time.sleep(0.01)
        return ids, plane.status_summary(), plane.kept_ids()

    ids, summary, kept = serve(pw, build, drive, free_port())
    assert len(set(ids)) == len(ids) == 8
    assert ids == [f"{k & (2**64 - 1):016x}" for k in keys]
    assert summary["completed_total"] == 8 and set(ids) <= set(kept)


def test_request_endpoint_on_the_monitoring_server(monkeypatch):
    """``/request``, ``/request?id=`` (kept and unknown), ``/status``'s
    ``request_trace`` and slowest exemplars, ``/metrics``' stage histograms."""
    monkeypatch.setenv("PATHWAY_REQUEST_TRACE_SLOW_MS", "0")
    mon_port = free_port()
    monkeypatch.setenv("PATHWAY_MONITORING_HTTP_PORT", str(mon_port))
    from torch_http_helpers import release_port

    release_port(mon_port)  # the monitoring server binds it before the run

    def drive(port):
        body, headers = _post(port, {"query": "hello"})
        rid = headers["X-Pathway-Request-Id"]
        deadline = time.monotonic() + 10
        while rid not in port_req.current().kept_ids() and time.monotonic() < deadline:
            time.sleep(0.01)
        base = f"http://127.0.0.1:{mon_port}"
        with urllib.request.urlopen(f"{base}/metrics", timeout=10) as resp:
            metrics = resp.read().decode()
        return (
            rid,
            _get_json(f"{base}/request"),
            _get_json(f"{base}/request?id={rid}"),
            _get_json(f"{base}/request?id=00000000000000ff"),
            _get_json(f"{base}/status"),
            metrics,
        )

    rid, listing, doc, unknown, status, metrics = serve(
        pathway_tpu_torch, _upper, drive, free_port(), with_http_server=True
    )
    assert listing[0] == 200 and rid in listing[1]["kept_ids"]
    assert doc[0] == 200 and doc[1]["ok"] and doc[1]["kept"] and doc[1]["request_id"] == rid
    assert unknown[1]["ok"] is False and unknown[1]["error"] == "unknown request '00000000000000ff'"
    assert status[1]["request_trace"]["completed_total"] >= 1
    assert status[1]["serving"]["slowest"][0]["decomposition_ms"]
    assert "pathway_request_stage_seconds_bucket" in metrics
    assert 'stage="serve/admission"' in metrics and "pathway_request_traces_kept_total" in metrics


def test_client_disconnect_completes_cancelled_flight(monkeypatch):
    monkeypatch.setenv("PATHWAY_REQUEST_TRACE_SLOW_MS", "100000")
    pw = pathway_tpu_torch

    def build(pw, port):
        class Q(pw.Schema):
            query: str

        queries, respond = pw.io.http.rest_connector(host="127.0.0.1", port=port, schema=Q)
        answered = queries.filter(queries.query != "blackhole")
        respond(answered.select(result=pw.apply(str.upper, answered.query)))

    def drive(port):
        body = json.dumps({"query": "blackhole"}).encode()
        s = socket.create_connection(("127.0.0.1", port), timeout=5)
        s.sendall(
            b"POST / HTTP/1.1\r\nHost: x\r\nContent-Type: application/json\r\n"
            + f"Content-Length: {len(body)}\r\n\r\n".encode() + body
        )
        plane = port_req.current()
        deadline = time.monotonic() + 10
        while plane.status_summary()["in_flight"] == 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        before = plane.status_summary()["in_flight"]
        s.close()
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            summary = plane.status_summary()
            if summary["in_flight"] == 0 and summary["by_status"].get("cancelled"):
                break
            time.sleep(0.02)
        after = plane.status_summary()
        alive = _post(port, {"query": "alive"})[0]
        return before, after, alive

    before, after, alive = serve(pw, build, drive, free_port())
    assert before == 1
    assert after["in_flight"] == 0 and after["by_status"].get("cancelled") == 1
    assert alive == "ALIVE"
