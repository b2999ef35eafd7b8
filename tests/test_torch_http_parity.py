"""The port's REST serving plane against the reference's, on the same requests.

The reference (``pathway_tpu/io/http``) serves through aiohttp; the port
(``pathway_tpu_torch/io/http``) through its own HTTP/1.1 layer on the
standard library (``_wire.py``). The same pipeline is built once as
``build(pw, port)`` and served by each package in turn; the same requests go
to both over ``http.client`` (one keep-alive connection, reopened where a
response closes it) or a raw socket, and the answers must agree: equal
statuses, bodies equal byte for byte, equal ``Content-Type`` / ``Allow`` /
``Retry-After`` / ``Connection`` headers, and equal engine keys for the
admitted requests (both packages' ``_KEY_SEQ`` restarted at 1 first). The
reference runs with its request-trace and health planes off
(``PATHWAY_REQUEST_TRACE=off``, ``PATHWAY_HEALTH=off``), the planes the port
does not carry yet.

Also here: the serving section and its Prometheus lines for the same
counters, GET-parameter coercion, and that the port's HTTP modules load
neither ``jax``, ``pathway_tpu``, ``aiohttp`` nor ``requests``.
"""

from __future__ import annotations

import http.client
import itertools
import json
import numbers
import os
import re
import socket
import subprocess
import sys
import threading
import time

import pytest

import pathway_tpu
import pathway_tpu.io.http._server as ref_server
import pathway_tpu.stdlib.indexing
import pathway_tpu.xpacks.llm
import pathway_tpu.xpacks.llm.servers
import pathway_tpu_torch
import pathway_tpu_torch.xpacks.llm.servers
from pathway_tpu_torch.io.http import _server as port_server
from torch_http_helpers import free_port, wait_ready

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN_TIMEOUT = 60.0
#: the response headers that must agree (Date and Server name the moment
#: and the implementation)
COMPARED_HEADERS = (
    "content-type", "content-length", "allow", "retry-after", "connection", "x-pathway-request-id",
)


@pytest.fixture
def planes_off(monkeypatch):
    monkeypatch.setenv("PATHWAY_REQUEST_TRACE", "off")
    monkeypatch.setenv("PATHWAY_HEALTH", "off")
    return monkeypatch


class Client:
    """``http.client`` over one keep-alive connection; each answer as
    (status, body bytes, the compared headers)."""

    def __init__(self, port: int):
        self.conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)

    def send(self, method: str, path: str, body: bytes | None = None, headers: dict | None = None):
        hdrs = dict(headers or {})
        if isinstance(body, list):  # chunked: the list is the chunks
            self.conn.putrequest(method, path)
            for k, v in {**hdrs, "Transfer-Encoding": "chunked"}.items():
                self.conn.putheader(k, v)
            self.conn.endheaders()
            for chunk in body:
                self.conn.send(b"%x\r\n%s\r\n" % (len(chunk), chunk))
            self.conn.send(b"0\r\n\r\n")
        else:
            self.conn.request(method, path, body=body, headers=hdrs)
        resp = self.conn.getresponse()
        data = resp.read()
        got = {k.lower(): v for k, v in resp.getheaders() if k.lower() in COMPARED_HEADERS}
        if got.get("connection") == "close":
            self.conn.close()  # http.client reopens on the next request
        return resp.status, data, got

    def close(self) -> None:
        self.conn.close()


def raw_exchange(port: int, payload: bytes) -> tuple[bytes, bool]:
    """Send raw bytes; return everything the server wrote within a short
    wait, and whether it closed the connection."""
    with socket.create_connection(("127.0.0.1", port), timeout=10) as sock:
        sock.sendall(payload)
        sock.settimeout(1.0)
        out, closed = b"", False
        try:
            while True:
                data = sock.recv(65536)
                if not data:
                    closed = True
                    break
                out += data
        except socket.timeout:
            pass
    return out, closed


def split_responses(raw: bytes) -> list[tuple[bytes, dict, bytes]]:
    """Raw HTTP/1.1 responses (Content-Length framed) → (status line, the
    compared headers, body)."""
    out = []
    while raw:
        head, _, rest = raw.partition(b"\r\n\r\n")
        lines = head.split(b"\r\n")
        hdrs = {}
        for line in lines[1:]:
            k, _, v = line.decode("latin-1").partition(":")
            if k.strip().lower() in COMPARED_HEADERS:
                hdrs[k.strip().lower()] = v.strip()
        n = int(hdrs.get("content-length", 0))
        out.append((lines[0], hdrs, rest[:n]))
        raw = rest[n:]
    return out


def serve(pw, build, exchanges, monkeypatch, ready=None):
    """Serve ``build(pw, port)`` under package ``pw`` and run ``exchanges``
    (a callable of the port returning its answers) once ``ready(port)``
    holds; returns (answers, engine keys minted for them)."""
    mod = ref_server if pw is pathway_tpu else port_server
    pw.G.clear()
    port = free_port()
    build(pw, port)
    keys: list[int] = []
    mint = mod.mint_request_key

    def recording_mint() -> int:
        key = mint()
        keys.append(key)
        return key

    monkeypatch.setattr(mod, "mint_request_key", recording_mint)
    monkeypatch.setattr(mod, "_KEY_SEQ", itertools.count(1))
    errors: list[BaseException] = []

    def target():
        try:
            pw.run(monitoring_level="none")
        except BaseException as e:  # surfaced below
            errors.append(e)

    th = threading.Thread(target=target, daemon=True)
    th.start()
    try:
        wait_ready(port, pw)
        if ready is not None:
            ready(port)
            # the readiness polls minted keys of their own
            keys.clear()
            mod._KEY_SEQ = itertools.count(1)
        answers = exchanges(port)
    finally:
        rt = pw.internals.run.current_runtime()
        if rt is not None:
            rt.request_stop()
        th.join(timeout=RUN_TIMEOUT)
    assert not th.is_alive(), "pw.run did not stop"
    if errors:
        raise errors[0]
    pw.G.clear()
    return answers, keys


_DIST = re.compile(rb'"dist": (-?[0-9.e+-]+)')


def _split_dists(answer):
    """(the answer with every ``"dist"`` number blanked, those numbers)."""
    status, body, hdrs = answer
    dists = [float(m) for m in _DIST.findall(body)]
    return (status, _DIST.sub(b'"dist": _', body), hdrs), dists


def assert_same_serving(build, exchanges, monkeypatch, ready=None, dist_tol: float = 0.0):
    """Equal answers and keys; with ``dist_tol``, a hit's ``dist`` (an f32
    cosine that two frameworks compute) within it and every other byte of
    the body equal."""
    ref, ref_keys = serve(pathway_tpu, build, exchanges, monkeypatch, ready)
    port, port_keys = serve(pathway_tpu_torch, build, exchanges, monkeypatch, ready)
    assert len(port) == len(ref)
    for i, (a, b) in enumerate(zip(port, ref)):
        if dist_tol:
            (a, a_d), (b, b_d) = _split_dists(a), _split_dists(b)
            assert len(a_d) == len(b_d) and all(abs(x - y) <= dist_tol for x, y in zip(a_d, b_d)), (i, a_d, b_d)
            # the blanked number's width may differ: compare without the length
            a = (a[0], a[1], {k: v for k, v in a[2].items() if k != "content-length"})
            b = (b[0], b[1], {k: v for k, v in b[2].items() if k != "content-length"})
        assert a == b, (i, a, b)
    assert port_keys == ref_keys and port_keys
    return port


# --------------------------------------------------------- a rest_connector route


def _echo_route(pw, port):
    class Q(pw.Schema):
        query: str
        k: int = pw.column_definition(default_value=3)

    def validator(payload):
        if payload.get("query") == "forbidden":
            raise ValueError("query 'forbidden' is not allowed")

    queries, respond = pw.io.http.rest_connector(
        host="127.0.0.1",
        port=port,
        route="/v1/echo",
        schema=Q,
        methods=("GET", "POST"),
        request_validator=validator,
        documentation=pw.io.http.EndpointDocumentation(summary="echo", description="echoes", tags=["t"]),
    )
    def answer(q, k):  # k stays a string where a GET value does not parse
        return (q, k, k / 8 if isinstance(k, numbers.Number) else None, {"n": [k] * 2})

    respond(queries.select(result=pw.apply(answer, queries.query, queries.k)))


ECHO_REQUESTS = [
    ("POST", "/v1/echo", json.dumps({"query": "alpha", "k": 2}).encode(), {"Content-Type": "application/json"}),
    ("GET", "/v1/echo?query=x+y&k=5&extra=1", None, {}),
    ("GET", "/v1/echo?query=a%26b%20c&k=7&k=9", None, {}),
    ("POST", "/v1/echo", b"plain text, not json", {"Content-Type": "text/plain"}),
    ("POST", "/v1/echo", json.dumps({"query": "unicode é ✓"}).encode(), {}),
    ("POST", "/v1/echo", [b'{"query": "chun', b'ked", "k": 11}'], {}),
    ("POST", "/v1/echo", json.dumps({"query": "forbidden"}).encode(), {}),
    ("GET", "/v1/echo?k=notanint&query=q", None, {}),
    ("POST", "/v1/echo", b"[1, 2]", {}),
    ("POST", "/nope", b"{}", {}),
    ("PUT", "/v1/echo", b"", {}),
    ("HEAD", "/v1/echo", None, {}),
    ("POST", "/healthz", b"", {}),
    ("GET", "/_schema", None, {}),
    ("GET", "/healthz", None, {}),
    ("GET", "/readyz", None, {}),
    ("POST", "/v1/echo", json.dumps({"query": "last", "k": 0}).encode(), {"Connection": "close"}),
]


def _send_all(requests):
    def exchanges(port):
        client = Client(port)
        try:
            return [client.send(*r) for r in requests]
        finally:
            client.close()

    return exchanges


def test_rest_connector_route_answers_as_the_reference(planes_off):
    """POST JSON, GET with typed and repeated query params, a non-JSON body,
    a chunked body, a validator rejection, a payload that is not an object,
    an unknown path, a wrong method, HEAD, ``/_schema``, ``/healthz``,
    ``/readyz`` and ``Connection: close``."""
    answers = assert_same_serving(_echo_route, _send_all(ECHO_REQUESTS), planes_off)
    statuses = [a[0] for a in answers]
    # the non-object payload fails in the validator (``payload.get``): 400
    assert statuses == [200, 200, 200, 200, 200, 200, 400, 200, 400, 404, 405, 405, 405, 200, 200, 200, 200]
    assert json.loads(answers[1][1]) == ["x y", 5, 0.625, {"n": [5, 5]}]
    assert json.loads(answers[2][1])[:2] == ["a&b c", 9]
    assert json.loads(answers[3][1])[:2] == ["plain text, not json", 3]
    assert answers[10][2]["allow"] == "GET,POST"
    assert answers[14][1] == b'{"alive": true, "health": "off"}'
    assert answers[15][1] == b'{"ready": true, "health": "off"}'
    assert answers[16][2]["connection"] == "close"


@pytest.fixture
def planes_on(monkeypatch):
    """Request tracing and health on, the audit and timeline planes pinned
    off (the case as it ran before the port carried them)."""
    monkeypatch.setenv("PATHWAY_REQUEST_TRACE", "on")
    monkeypatch.setenv("PATHWAY_HEALTH", "on")
    monkeypatch.setenv("PATHWAY_AUDIT", "off")
    monkeypatch.setenv("PATHWAY_TIMELINE", "off")
    return monkeypatch


def test_rest_connector_route_answers_as_the_reference_with_planes_on(planes_on):
    """The same requests with the request-trace and health planes on: equal
    statuses, bodies and headers, ``X-Pathway-Request-Id`` included (the hex
    of the same engine key on both sides), and ``/healthz`` / ``/readyz``
    answered from the door state machine."""
    answers = assert_same_serving(_echo_route, _send_all(ECHO_REQUESTS), planes_on)
    statuses = [a[0] for a in answers]
    assert statuses == [200, 200, 200, 200, 200, 200, 400, 200, 400, 404, 405, 405, 405, 200, 200, 200, 200]
    routed = [a for a, r in zip(answers, ECHO_REQUESTS) if r[1].startswith("/v1/echo") and a[0] == 200]
    assert routed and all("x-pathway-request-id" in a[2] for a in routed)
    assert len({a[2]["x-pathway-request-id"] for a in routed}) == len(routed)
    assert answers[14][1] == b'{"alive": true, "state": "ready"}'
    assert answers[15][1] == b'{"ready": true, "state": "ready"}'


@pytest.fixture
def planes_default(monkeypatch):
    """Both packages' defaults: every plane on (request tracing, health,
    audit, timeline)."""
    for k in ("PATHWAY_REQUEST_TRACE", "PATHWAY_HEALTH", "PATHWAY_AUDIT", "PATHWAY_TIMELINE"):
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


def test_rest_connector_route_answers_as_the_reference_at_default_planes(planes_default):
    """The same requests at both packages' default planes: equal statuses,
    bodies and headers, request ids included."""
    answers = assert_same_serving(_echo_route, _send_all(ECHO_REQUESTS), planes_default)
    statuses = [a[0] for a in answers]
    assert statuses == [200, 200, 200, 200, 200, 200, 400, 200, 400, 404, 405, 405, 405, 200, 200, 200, 200]
    routed = [a for a, r in zip(answers, ECHO_REQUESTS) if r[1].startswith("/v1/echo") and a[0] == 200]
    assert routed and all("x-pathway-request-id" in a[2] for a in routed)
    assert answers[14][1] == b'{"alive": true, "state": "ready"}'


def test_keep_alive_pipelining_and_connection_close_on_the_wire(planes_off):
    """Two requests pipelined on one raw connection are both answered in
    order and the connection stays open; ``Connection: close`` and an
    HTTP/1.0 request without keep-alive close it after the answer."""

    def req(body: dict, extra: str = "", version: str = "HTTP/1.1") -> bytes:
        data = json.dumps(body).encode()
        return (
            f"POST /v1/echo {version}\r\nHost: h\r\nContent-Type: application/json\r\n"
            f"Content-Length: {len(data)}\r\n{extra}\r\n"
        ).encode() + data

    def exchanges(port):
        out = []
        for payload in (
            req({"query": "p1"}) + req({"query": "p2", "k": 4}),
            req({"query": "c"}, "Connection: close\r\n"),
            req({"query": "h10"}, version="HTTP/1.0"),
            req({"query": "h10ka"}, "Connection: keep-alive\r\n", version="HTTP/1.0"),
            b"NONSENSE\r\n\r\n",
        ):
            raw, closed = raw_exchange(port, payload)
            # a malformed request: the status code (the two texts name the
            # parse error each in its own words)
            bad = b" 400 " in raw.split(b"\r\n", 1)[0]
            out.append((raw.split(b" ", 2)[1] if bad else split_responses(raw), closed))
        return out

    answers = assert_same_serving(_echo_route, exchanges, planes_off)
    (pipelined, open1), (close, closed2), (h10, closed3), (h10ka, open4), (bad, closed5) = answers
    assert [json.loads(r[2])[0] for r in pipelined] == ["p1", "p2"] and not open1
    assert closed2 and close[0][1]["connection"] == "close"
    assert closed3 and not open4
    assert bad == b"400" and closed5


# ------------------------------------------------------------ DocumentStoreServer


def _store_server(factory_name):
    def build(pw, port):
        docs = pw.debug.table_from_rows(
            pw.schema_from_types(data=str, _metadata=dict),
            [
                ("Kafka connector reads topics into tables.", {"path": "a.txt", "modified_at": 100, "seen_at": 200}),
                ("The engine runs matmuls on the systolic array.", {"path": "b.md", "modified_at": 50, "seen_at": 300}),
                ("Bananas are yellow fruit rich in potassium.", {"path": "c.txt", "modified_at": 70, "seen_at": 250}),
            ],
        )
        if factory_name == "bm25":
            factory = pw.stdlib.indexing.TantivyBM25Factory()
        else:
            emb = pw.xpacks.llm.mocks.FakeEmbedder(dimension=16)
            cpu = {"device": "cpu"} if pw is pathway_tpu_torch else {}
            factory = pw.stdlib.indexing.BruteForceKnnFactory(embedder=emb, **cpu)
        store = pw.xpacks.llm.DocumentStore(docs, retriever_factory=factory)
        pw.xpacks.llm.servers.DocumentStoreServer("127.0.0.1", port, store)

    return build


def _indexed(port: int, timeout: float = 30.0) -> None:
    """Poll until the three docs are counted and retrievable (they arrive in
    one batch, so one indexed doc means all three are)."""
    client = Client(port)
    deadline = time.monotonic() + timeout
    try:
        while time.monotonic() < deadline:
            _s, stats, _h = client.send("POST", "/v1/statistics", b"{}")
            _s, hits, _h = client.send("POST", "/v1/retrieve", json.dumps({"query": "bananas", "k": 1}).encode())
            if json.loads(stats).get("file_count") == 3 and json.loads(hits):
                return
            time.sleep(0.05)
    finally:
        client.close()
    raise AssertionError("the store never indexed its three docs")


STORE_REQUESTS = [
    ("POST", "/v1/retrieve", json.dumps({"query": "kafka topics tables", "k": 2}).encode(), {}),
    ("GET", "/v1/retrieve?query=yellow+bananas&k=1", None, {}),
    ("POST", "/v1/retrieve", json.dumps({"query": "engine", "k": 3, "metadata_filter": "path == 'b.md'"}).encode(), {}),
    ("POST", "/v1/retrieve", json.dumps({"query": "fruit", "k": 3, "filepath_globpattern": "*.txt"}).encode(), {}),
    ("POST", "/v1/statistics", b"{}", {}),
    ("GET", "/v1/statistics", None, {}),
    ("POST", "/v1/inputs", b"{}", {}),
    ("GET", "/v1/inputs?filepath_globpattern=*.md", None, {}),
    ("GET", "/_schema", None, {}),
    ("DELETE", "/v1/inputs", None, {}),
]


@pytest.mark.parametrize("factory_name, dist_tol", [("bm25", 0.0), ("knn", 1e-6)])
def test_document_store_server_answers_as_the_reference(planes_off, factory_name, dist_tol):
    """``/v1/retrieve`` (POST, GET, metadata filter, glob), ``/v1/statistics``,
    ``/v1/inputs`` and ``/_schema``; on the KNN index a hit's ``dist`` is
    compared within 1e-6, as in ``test_torch_llm_xpack.py``, and every other
    byte exactly."""
    answers = assert_same_serving(
        _store_server(factory_name), _send_all(STORE_REQUESTS), planes_off, ready=_indexed, dist_tol=dist_tol
    )
    assert [a[0] for a in answers] == [200] * 9 + [405]
    first = json.loads(answers[0][1])
    assert len(first) == (1 if factory_name == "bm25" else 2)
    assert all({"text", "metadata", "dist"} <= set(h) for h in first)
    assert json.loads(answers[4][1]) == {"file_count": 3, "last_modified": 100, "last_indexed": 300}
    assert set(json.loads(answers[8][1])["paths"]) == {"/v1/retrieve", "/v1/statistics", "/v1/inputs"}


# ------------------------------------------------------------------ the units


def _schema(pw):
    class S(pw.Schema):
        query: str
        k: int = pw.column_definition(default_value=3)

    return S


def test_serving_status_and_prometheus_lines_match_the_reference():
    """The same counters and latencies on two routes of each package give the
    same ``/status`` serving section, heartbeat summary and ``/metrics``
    lines."""
    rt = object()
    states = {}
    for pw, mod in ((pathway_tpu, ref_server), (pathway_tpu_torch, port_server)):
        made = []
        for route in ('/v2/"answer"', "/v1/retrieve"):
            st = mod._RouteServing(route, ("GET", "POST"), _schema(pw))
            st.runtime = rt
            st.requests_total, st.responses_total, st.shed_total = 40, 31, 5
            st.errors_total, st.timeouts_total, st.limited_total = 2, 1, 3
            st.unauthorized_total, st.forbidden_total = 4, 6
            st.batches_total, st.batched_rows_total = 7, 31
            st.futures = {1: None, 2: None}
            for s in (0.0001, 0.003, 0.003, 0.02, 0.5, 0.9, 3.0, 100.0):
                st.latency.observe(s)
            mod._ROUTES.add(st)
            made.append(st)
        states[pw] = made
    ref = (ref_server.serving_status(rt), ref_server.serving_heartbeat_summary(rt), ref_server.serving_prometheus_lines(rt))
    port = (port_server.serving_status(rt), port_server.serving_heartbeat_summary(rt), port_server.serving_prometheus_lines(rt))
    assert port == ref
    assert port[0]["routes"][0]["route"] == '/v1/retrieve' and port[0]["requests_total"] == 80
    assert 'route="/v2/\\"answer\\""' in "\n".join(port[2])
    assert port_server.serving_status(object()) is None and port_server.serving_prometheus_lines(object()) == []


@pytest.mark.parametrize(
    "value",
    ["12", "-3", "1.5", "nan", "true", "False", "0", "no", "", '{"a": [1]}', "[1, 2", "plain", None, 7],
)
def test_get_params_are_coerced_as_the_reference(value):
    from pathway_tpu.internals import dtype as rdt
    from pathway_tpu_torch.internals import dtype as pdt

    for name in ("INT", "FLOAT", "BOOL", "STR", "JSON"):
        for optional in (False, True):
            rd, pd = getattr(rdt, name), getattr(pdt, name)
            if optional:
                rd, pd = rdt.Optional(rd), pdt.Optional(pd)
            a, b = port_server._coerce(value, pd), ref_server._coerce(value, rd)
            assert type(a) is type(b) and (a == b or (a != a and b != b)), (name, value, a, b)


def test_port_http_modules_load_no_jax_reference_aiohttp_or_requests():
    code = (
        "import sys, pathway_tpu_torch.io.http, pathway_tpu_torch.xpacks.llm.servers\n"
        "print(sorted(m for m in ('jax', 'pathway_tpu', 'aiohttp', 'requests') if m in sys.modules))"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    # and no source of the port (or chip_smoke.py) imports either package
    pattern = re.compile(r"^\s*(import|from)\s+(aiohttp|requests)\b", re.M)
    sources = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _sub, files in os.walk(os.path.join(ROOT, "pathway_tpu_torch")):
        sources += [os.path.join(d, f) for f in files if f.endswith(".py")]
    offenders = [p for p in sources if pattern.search(open(p, encoding="utf-8").read())]
    assert offenders == []
