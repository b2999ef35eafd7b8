"""The port's monitoring server and run-level exports (``pathway_tpu_torch/
internals/{monitoring,telemetry}.py``) against the reference's, on the same
pipelines.

Mirrors ``tests/test_monitoring.py`` and ``tests/test_serving.py``'s
``/status`` + ``/metrics`` asserts: the same pipeline runs under both
packages and the deterministic part of ``run_stats`` (operators, row counts,
last times, lags, watermark ingest counts) and of ``prometheus_text`` (every
series name, and the value of every count series) is equal; the console
summary, the live dashboard, the OTLP trace and metrics exports and
``set_monitoring_config``; ``pw.run(with_http_server=True)`` serving
``/status`` and ``/metrics`` during a run, the serving section of a served
route, ``/timeline`` and ``/explain`` answering as the reference's do, and
the route of a plane not ported yet (``/scale``) answering 501 with the
``later slice`` message. Times are never compared.

Both sides run with ``PATHWAY_AUDIT=off`` and ``PATHWAY_TIMELINE=off`` (set
with ``monkeypatch``) but in the ``_at_default_planes`` case. Every server
binds a port reserved by ``torch_http_helpers.free_port``.
"""

from __future__ import annotations

import io
import json
import re
import threading
import time
import urllib.error
import urllib.request

import pytest

import pathway_tpu
import pathway_tpu_torch
from pathway_tpu.internals import monitoring as ref_mon
from pathway_tpu.internals import telemetry as ref_telemetry
from pathway_tpu_torch.internals import monitoring as port_mon
from pathway_tpu_torch.internals import telemetry as port_telemetry
from torch_http_helpers import free_port, release_port, wait_ready

SIDES = {"ref": (pathway_tpu, ref_mon), "port": (pathway_tpu_torch, port_mon)}


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("PATHWAY_AUDIT", "off")
    monkeypatch.setenv("PATHWAY_TIMELINE", "off")
    for k in ("PATHWAY_TRACE_FILE", "PATHWAY_METRICS_FILE", "PATHWAY_MONITORING_HTTP_PORT"):
        monkeypatch.delenv(k, raising=False)
    # ``set_monitoring_config(trace_file=None)`` disables an export for the
    # rest of the process, and a file that ran earlier in the same worker
    # (the reference's tests/test_monitoring.py) leaves it so: each test
    # starts from the environment's settings
    for telemetry in (ref_telemetry, port_telemetry):
        monkeypatch.setattr(telemetry, "_trace_file_override", telemetry._UNSET)
        monkeypatch.setattr(telemetry, "_metrics_file_override", telemetry._UNSET)
    # a reshard restore (tests/test_elastic.py, test_elastic_migrate.py and
    # their port mirrors) keeps its stats for the rest of the process, and
    # every later exposition of that package then carries
    # pathway_elastic_reshard_*; the flow plane is retained after a run for
    # post-run /status. Each test starts with neither.
    monkeypatch.setattr(pathway_tpu.elastic, "_LAST_RESHARD", {})
    monkeypatch.setattr(pathway_tpu_torch.elastic, "_LAST_RESHARD", {})
    monkeypatch.delenv("PATHWAY_FLOW", raising=False)
    for pw, _mon in SIDES.values():
        monkeypatch.setattr(pw.flow, "_plane", None)
    yield
    for pw, _mon in SIDES.values():
        pw.G.clear()


def _static(pw):
    pw.G.clear()
    t = pw.debug.table_from_rows(pw.schema_from_types(x=int), [(i,) for i in range(50)])
    t = t.with_columns(m=t.x % 5)
    g = t.groupby(t.m).reduce(s=pw.reducers.sum(t.x))
    pw.io.subscribe(g, on_change=lambda **k: None)


def _streaming(pw):
    """A multi-tick stream: three blocks of 20 rows, pushed in order. Each
    block lands in one push and the next waits until a tick has drained it,
    so every run takes the same three data ticks whatever the host's load
    (the per-operator row counts depend on how the rows split into ticks);
    20 ms between blocks keep the run long enough for a live redraw."""
    pw.G.clear()

    class S(pw.Schema):
        x: int

    class Subj(pw.io.python.ConnectorSubject):
        def run(self):
            for start in range(0, 60, 20):
                self.next_batch([{"x": i} for i in range(start, start + 20)])
                deadline = time.monotonic() + 30.0
                while self._node.polled_total < start + 20 and time.monotonic() < deadline:
                    time.sleep(0.001)
                time.sleep(0.02)

    t = pw.io.python.read(Subj(), schema=S)
    t = t.with_columns(m=t.x % 5)
    g = t.groupby(t.m).reduce(s=pw.reducers.sum(t.x))
    pw.io.subscribe(g, on_change=lambda **k: None)


def _ops(stats):
    return [{k: o[k] for k in ("id", "operator", "rows_in", "rows_out")} for o in stats["operators"]]


_COUNT_SERIES = ("pathway_operator_rows_in_total", "pathway_operator_rows_out_total",
                 "pathway_input_rows_ingested_total", "pathway_operator_errors_total")


#: process-lifetime families, which count the whole process's earlier work
#: and not the run's: the device plane's counters of every callable, the
#: tiered-index gauges of every live backend, and the reference's embedder
#: memo counters of every live embedder (a plane the port does not carry;
#: a reference file that ran earlier in the same worker leaves its embedders
#: alive)
_PROCESS_SERIES = ("pathway_jit_", "pathway_pad_", "pathway_device_", "pathway_index_",
                   "pathway_embedder_memo_")


def _series(text: str) -> tuple[list[str], list[str]]:
    """(every series name with its labels, every count series line with its
    value) of an exposition."""
    names, counts = [], []
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        name = line.rsplit(" ", 1)[0]
        names.append(name)
        if name.startswith(_COUNT_SERIES):
            counts.append(line)
    return names, counts


# ------------------------------------------------------------- run_stats


def test_static_run_stats_and_metrics_match_the_reference():
    out = {}
    for name, (pw, mon) in SIDES.items():
        _static(pw)
        pw.run(monitoring_level="none")
        rt = pw.internals.run.current_runtime()
        stats = mon.run_stats(rt)
        out[name] = (_ops(stats), stats["rows_in_total"], stats["rows_out_total"], stats["resilience"],
                     stats["errors"], _series(mon.prometheus_text(rt))[1])
    assert out["port"] == out["ref"]
    assert "groupby" in {o["operator"] for o in out["port"][0]}


def test_static_run_stats_and_metrics_match_the_reference_at_default_planes(monkeypatch):
    """The static run at both packages' default planes (the audit plane and
    the timeline's recorder on): the same, and the audit sections (per-edge
    cardinality, violations, lineage occupancy) and their series equal."""
    monkeypatch.delenv("PATHWAY_AUDIT")
    monkeypatch.delenv("PATHWAY_TIMELINE")
    out = {}
    for name, (pw, mon) in SIDES.items():
        _static(pw)
        pw.run(monitoring_level="none")
        rt = pw.internals.run.current_runtime()
        stats = mon.run_stats(rt)
        text = mon.prometheus_text(rt)
        audit_lines = [line for line in text.splitlines() if line.startswith(("pathway_operator_rows_total",
                       "pathway_operator_selectivity", "pathway_audit_"))]
        out[name] = (_ops(stats), stats["rows_in_total"], stats["rows_out_total"], stats["errors"],
                     _series(text)[1], stats["audit"], audit_lines)
    assert out["port"] == out["ref"]
    audit = out["port"][5]
    assert audit["enabled"] and audit["mode"] == "on" and audit["violations_total"] == 0
    assert audit["lineage"]["recorded_pairs"] > 0 and out["port"][6]


def test_streaming_probes_and_series_match_the_reference():
    """Per-operator rows, last times and lags, the input's ingest count and
    the set of exposition series are equal under a multi-tick stream; every
    operator that worked has a latency and a lag."""
    out = {}
    for name, (pw, mon) in SIDES.items():
        _streaming(pw)
        pw.run(monitoring_level="none")
        rt = pw.internals.run.current_runtime()
        stats = mon.run_stats(rt)
        worked = [o for o in stats["operators"] if o["rows_in"] > 0]
        assert worked and all(o["latency_ms"] > 0 and o["lag"] is not None for o in worked), worked
        wms = [{k: w[k] for k in ("input", "rows_ingested")} for w in stats["watermarks"]]
        names, counts = _series(mon.prometheus_text(rt))
        # the sink latency histogram's buckets hold wall times: keep names
        # only; the process-lifetime series count the whole process's
        # earlier work (test_torch_device_plane compares the device plane's)
        names = [n for n in names if not n.startswith(_PROCESS_SERIES)]
        out[name] = (_ops(stats), wms, sorted(set(names)), counts, sorted(stats["sink_latency"]))
    assert out["port"] == out["ref"]
    assert out["port"][1][0]["rows_ingested"] == 60
    assert any(n.startswith("pathway_sink_latency_seconds_bucket") for n in out["port"][2])


def test_console_summary_levels_match_the_reference():
    texts = {}
    for name, (pw, mon) in SIDES.items():
        _static(pw)
        pw.run(monitoring_level="none")
        rt = pw.internals.run.current_runtime()
        got = []
        for level in ("all", "in_out"):
            text = mon.print_summary(rt, level, file=io.StringIO())
            got.append([line.split()[:3] for line in text.splitlines()])  # drop time_ms
        got += [mon.print_summary(rt, "none"), mon.print_summary(rt, "auto", file=io.StringIO())]
        texts[name] = got
    assert texts["port"] == texts["ref"]
    assert any(row[0] == "groupby" for row in texts["port"][0])


def test_live_dashboard_renders_during_streaming():
    from pathway_tpu_torch.internals import run as run_mod

    _streaming(pathway_tpu_torch)
    buf = io.StringIO()
    rt = run_mod.make_runtime(monitoring_level="all", autocommit_duration_ms=5)
    run_mod._last_runtime = rt
    dash = port_mon.LiveDashboard(rt, "all", file=buf, refresh_s=0.05, force=True).start()
    try:
        rt.run(list(pathway_tpu_torch.G.outputs))
    finally:
        dash.stop()
    text = buf.getvalue()
    assert "operator" in text and "latency_ms" in text and "lag" in text and "groupby" in text
    assert "\x1b[" in text


# ------------------------------------------------------------ OTLP exports


def _spans_shape(doc):
    spans = doc["resourceSpans"][0]["scopeSpans"][0]["spans"]
    root = next(s for s in spans if s["name"] == "pathway.run")
    assert all(s["traceId"] == root["traceId"] for s in spans)
    return sorted(
        (s["name"], s.get("parentSpanId") == root["spanId"], sorted(a["key"] for a in s["attributes"]))
        for s in spans
    )


def test_otlp_trace_and_metrics_exports_match_the_reference(tmp_path, monkeypatch):
    out = {}
    for name, (pw, _mon) in SIDES.items():
        _streaming(pw)
        monkeypatch.setenv("PATHWAY_TRACE_FILE", str(tmp_path / f"{name}.trace.json"))
        monkeypatch.setenv("PATHWAY_METRICS_FILE", str(tmp_path / f"{name}.metrics.json"))
        pw.run(monitoring_level="none")
        trace = json.loads((tmp_path / f"{name}.trace.json").read_text())
        metrics = json.loads((tmp_path / f"{name}.metrics.json").read_text())
        scope = metrics["resourceMetrics"][0]["scopeMetrics"][0]
        ints = {
            (m["name"], tuple(sorted((a["key"], json.dumps(a["value"])) for a in p["attributes"]))): p["asInt"]
            for m in scope["metrics"]
            for p in m["gauge"]["dataPoints"]
            if "asInt" in p
        }
        out[name] = (_spans_shape(trace), sorted(m["name"] for m in scope["metrics"]), ints,
                     trace["resourceSpans"][0]["resource"]["attributes"][0]["value"]["stringValue"])
    assert out["port"][:3] == out["ref"][:3]
    assert (out["ref"][3], out["port"][3]) == ("pathway_tpu", "pathway_tpu_torch")
    assert ("operator/groupby", True, [
        "pathway.operator.busy_ms", "pathway.operator.id", "pathway.operator.lag",
        "pathway.operator.latency_ms", "pathway.operator.rows_in", "pathway.operator.rows_out",
    ]) in out["port"][0]


def test_set_monitoring_config_trace_and_metrics_files(tmp_path):
    pw = pathway_tpu_torch
    _streaming(pw)
    pw.set_monitoring_config(trace_file=str(tmp_path / "t.json"), metrics_file=str(tmp_path / "m.json"))
    try:
        pw.run(monitoring_level="none")
    finally:
        pw.set_monitoring_config(trace_file=None, metrics_file=None)
    assert json.loads((tmp_path / "t.json").read_text())["resourceSpans"]
    assert json.loads((tmp_path / "m.json").read_text())["resourceMetrics"]
    _streaming(pw)
    pw.run(monitoring_level="none")  # cleared: nothing new written
    assert sorted(p.name for p in tmp_path.iterdir()) == ["m.json", "t.json"]


# ------------------------------------------------------- the HTTP server


def _get(url: str):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        with e:
            return e.code, e.read().decode()


class _RT:
    scheduler = None
    monitoring_server = None


def test_http_server_status_metrics_and_later_slice_routes():
    out = {}
    for name, (pw, mon) in SIDES.items():
        _static(pw)
        port = free_port()
        release_port(port)
        rt = _RT()
        srv = mon.MonitoringHttpServer(rt, port=port).start()
        try:
            base = f"http://127.0.0.1:{srv.port}"
            empty = json.loads(_get(f"{base}/status")[1])
            pw.run(monitoring_level="none")
            rt.scheduler = pw.internals.run.current_runtime().scheduler
            status = json.loads(_get(f"{base}/status")[1])
            metrics = _get(f"{base}/metrics")[1]
            other = {p: _get(f"{base}{p}") for p in ("/timeline", "/scale", "/explain", "/nope", "/trace")}
        finally:
            srv.stop()
        out[name] = (empty["operators"], _ops(status), _series(metrics)[1], other)
    assert out["port"][:3] == out["ref"][:3]
    assert out["port"][0] == [] and "groupby" in {o["operator"] for o in out["port"][1]}
    other = out["port"][3]
    # the audit and timeline planes are off on both sides here: their routes
    # answer as the reference's do with the planes off
    # (tests/test_torch_lineage.py and test_torch_timeline.py serve them on)
    assert other["/timeline"] == out["ref"][3]["/timeline"] == (
        200, json.dumps({"enabled": False, "points": [], "next": None}))
    assert other["/explain"] == out["ref"][3]["/explain"]
    assert other["/explain"][0] == 200 and json.loads(other["/explain"][1])["ok"] is False
    assert other["/scale"] == out["ref"][3]["/scale"] == (
        200, json.dumps({"ok": False, "error": "elasticity is off (PATHWAY_ELASTIC=off)"}))
    assert other["/nope"][0] == out["ref"][3]["/nope"][0] == 404
    assert other["/trace"] == out["ref"][3]["/trace"] == (200, json.dumps({"enabled": False, "spans": [], "next": 0}))


def test_with_http_server_serves_during_a_run(monkeypatch):
    pw = pathway_tpu_torch
    mon_port = free_port()
    release_port(mon_port)
    monkeypatch.setenv("PATHWAY_MONITORING_HTTP_PORT", str(mon_port))
    pw.G.clear()

    class S(pw.Schema):
        x: int

    class Slow(pw.io.python.ConnectorSubject):
        def run(self):
            for i in range(5):
                self.next(x=i)
                time.sleep(0.1)

    t = pw.io.python.read(Slow(), schema=S)
    pw.io.subscribe(t, on_change=lambda **k: None)
    got: dict = {}

    def probe():
        # the server answers from before the run installs its planes: wait
        # for the health section, which the run's install adds
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            try:
                got["status"] = json.loads(_get(f"http://127.0.0.1:{mon_port}/status")[1])
                if "health" in got["status"]:
                    return
            except (OSError, ValueError):
                pass
            time.sleep(0.02)

    th = threading.Thread(target=probe)
    th.start()
    pw.run(with_http_server=True, monitoring_level="none")
    th.join(timeout=15)
    assert got["status"]["alive"]
    assert got["status"]["monitoring"] == {"host": "127.0.0.1", "port": mon_port}
    assert got["status"]["device"]["enabled"] and got["status"]["health"]["state"] in ("starting", "ready")


def test_served_route_shows_on_status_and_metrics(monkeypatch):
    """16 parallel clients against one route with the monitoring server on:
    ``/status``' serving section and ``/metrics``' serving series count
    exactly the 16, as in ``test_serving``."""
    pw = pathway_tpu_torch
    n_clients = 16
    port, mon_port = free_port(), free_port()
    release_port(mon_port)
    monkeypatch.setenv("PATHWAY_SERVE_COALESCE_MS", "100")
    monkeypatch.setenv("PATHWAY_MONITORING_HTTP_PORT", str(mon_port))
    pw.G.clear()
    queries, respond = pw.io.http.rest_connector(host="127.0.0.1", port=port, schema=pw.schema_from_types(query=str))
    respond(queries.select(result=pw.apply(str.upper, queries.query)))
    results: dict = {}
    out: dict = {}
    errors: list = []

    def post(i, barrier):
        barrier.wait()
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/", data=json.dumps({"query": f"hello-{i}"}).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=30) as r:
            results[i] = (r.status, json.loads(r.read()), r.headers.get("X-Pathway-Request-Id"))

    def target():
        try:
            pw.run(monitoring_level="none", with_http_server=True)
        except BaseException as e:  # surfaced below
            errors.append(e)

    th = threading.Thread(target=target, daemon=True)
    th.start()
    try:
        wait_ready(port)
        barrier = threading.Barrier(n_clients)
        clients = [threading.Thread(target=post, args=(i, barrier)) for i in range(n_clients)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=60)
        out["status"] = json.loads(_get(f"http://127.0.0.1:{mon_port}/status")[1])
        out["metrics"] = _get(f"http://127.0.0.1:{mon_port}/metrics")[1]
    finally:
        rt = pw.internals.run.current_runtime()
        if rt is not None:
            rt.request_stop()
        th.join(timeout=60)
        pw.G.clear()
    assert not th.is_alive() and not errors, errors
    assert sorted(results) == list(range(n_clients))
    assert all(v[:2] == (200, f"HELLO-{i}") for i, v in results.items())
    assert len({v[2] for v in results.values()}) == n_clients  # one request id each
    [live] = out["status"]["serving"]["routes"]
    assert live["requests_total"] == live["responses_total"] == n_clients and live["shed_total"] == 0
    assert 1 <= live["batches_total"] <= 5
    assert out["status"]["request_trace"]["completed_total"] == n_clients
    metrics = out["metrics"]
    assert f'pathway_serve_requests_total{{route="/"}} {n_clients}' in metrics
    assert f'pathway_serve_responses_total{{route="/"}} {n_clients}' in metrics
    assert re.search(r'pathway_input_rows_ingested_total\{input="rest:/:\d+"\} 32', metrics), metrics
