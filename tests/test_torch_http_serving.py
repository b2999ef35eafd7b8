"""The port's REST serving plane (``pathway_tpu_torch/io/http``) on its own.

Mirrors the single-process cases of ``tests/test_serving.py`` and the
front-door protection cases of ``tests/test_fabric.py`` against the port:
concurrent clients coalescing into few engine ticks with byte-correct
answers, the 429 shed path with exact counts, webserver lifecycle (503 flush
on shutdown, back-to-back port reuse), query-row retraction, OpenAPI at
``/_schema``, DocumentStoreServer's ``/v1/retrieve``, token buckets and API
keys (units and through a live route), and a client that hangs up
mid-request. The monitoring server is a later slice, so the serving counters
are read from ``serving_status`` / ``serving_prometheus_lines`` directly.

Every server binds a port reserved by ``torch_http_helpers.free_port`` and
is talked to only once ``wait_ready`` holds (``/readyz`` 200 and every route
of the run configured); every client call and every ``pw.run`` thread has a
timeout, and ``request_stop()`` runs in a ``finally``, so no test can hang
the suite.
"""

from __future__ import annotations

import json
import socket
import threading
import time
import urllib.error
import urllib.request

import pytest

import pathway_tpu_torch as pw
from pathway_tpu_torch.io.http import _server as S
from torch_http_helpers import free_port as _free_port
from torch_http_helpers import wait_ready as _wait_ready

RUN_TIMEOUT = 60.0


class QuerySchema(pw.Schema):
    query: str


@pytest.fixture(autouse=True)
def _fresh_port_graph():
    pw.G.clear()
    yield
    pw.G.clear()


def _post(port: int, payload: dict, route: str = "/", timeout: float = 30.0, headers: dict | None = None):
    """POST returning (status, parsed body, headers)."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{route}",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read()), dict(resp.headers)
    except urllib.error.HTTPError as e:
        with e:
            body = e.read()
            try:
                parsed = json.loads(body)
            except ValueError:
                parsed = body.decode(errors="replace")
            return e.code, parsed, dict(e.headers)


def _stop_current_run() -> None:
    rt = pw.internals.run.current_runtime()
    if rt is not None:
        rt.request_stop()


def run_serving(drive, **run_kwargs) -> None:
    """``pw.run`` in a thread while ``drive()`` talks to the server from this
    one; the run is stopped whatever ``drive`` does, and both are bounded."""
    errors: list[BaseException] = []

    def target():
        try:
            pw.run(monitoring_level="none", **run_kwargs)
        except BaseException as e:  # surfaced below
            errors.append(e)

    th = threading.Thread(target=target, daemon=True)
    th.start()
    try:
        drive()
    finally:
        # the runtime of THIS run: wait until pw.run has made it current
        deadline = time.monotonic() + 10
        while pw.internals.run.current_runtime() is None and time.monotonic() < deadline:
            time.sleep(0.01)
        _stop_current_run()
        th.join(timeout=RUN_TIMEOUT)
    assert not th.is_alive(), "pw.run did not stop"
    if errors:
        raise errors[0]


def _upper_route(port: int, **kwargs):
    queries, respond = pw.io.http.rest_connector(host="127.0.0.1", port=port, schema=QuerySchema, **kwargs)
    respond(queries.select(result=pw.apply(lambda q: q.upper(), queries.query)))
    return queries


# ------------------------------------------------------------------ coalescing


def test_concurrent_clients_coalesce_byte_correct(monkeypatch):
    """16 parallel clients against one route: every request answered
    byte-correctly, the requests coalesce into a few engine ticks (not one
    tick per request), and the serving section and its Prometheus lines
    count them."""
    n_clients = 16
    port = _free_port()
    # wide coalesce window so simultaneous clients provably share ticks; the
    # autocommit poll is set past it, so only the arrival-driven wakeup ends
    # a serving tick (at the default 20 ms poll, how many ticks 16 client
    # threads span depends on how fast the host starts them)
    monkeypatch.setenv("PATHWAY_SERVE_COALESCE_MS", "100")
    _upper_route(port)
    results: dict[int, tuple] = {}
    live: dict = {}

    def client(i: int, barrier: threading.Barrier) -> None:
        barrier.wait(timeout=30)
        results[i] = _post(port, {"query": f"hello-{i}"})

    def drive() -> None:
        _wait_ready(port)
        barrier = threading.Barrier(n_clients)
        threads = [threading.Thread(target=client, args=(i, barrier)) for i in range(n_clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        rt = pw.internals.run.current_runtime()
        live["status"] = S.serving_status(rt)
        live["metrics"] = "\n".join(S.serving_prometheus_lines(rt))

    run_serving(drive, autocommit_duration_ms=1000)
    assert len(results) == n_clients
    for i, (status, body, _hdr) in results.items():
        assert status == 200, (i, body)
        assert body == f"HELLO-{i}"
    serving = S.serving_status(pw.internals.run.current_runtime())
    assert serving is not None
    [route] = serving["routes"]
    assert route["requests_total"] == n_clients
    assert route["responses_total"] == n_clients
    assert route["shed_total"] == 0
    # the coalescing claim: 16 simultaneous requests must NOT take 16
    # response ticks (the 100 ms window gathers them into a handful)
    assert 1 <= route["batches_total"] <= 5, route
    assert route["mean_batch"] >= n_clients / 5
    # the section and the exposition lines while the run was live
    assert live["status"]["routes"][0]["requests_total"] == n_clients
    assert "pathway_serve_requests_total" in live["metrics"]
    assert f'pathway_serve_responses_total{{route="/"}} {n_clients}' in live["metrics"]


# ------------------------------------------------------------------- shed path


def test_shed_returns_429_with_exact_counts(monkeypatch):
    """A tiny in-flight budget + a slow pipeline: overflow clients get a fast
    429 with Retry-After, and the route counters account for every request."""
    n_clients = 8
    port = _free_port()
    monkeypatch.setenv("PATHWAY_SERVE_MAX_INFLIGHT", "2")
    queries, respond = pw.io.http.rest_connector(host="127.0.0.1", port=port, schema=QuerySchema)

    def slow_upper(q: str) -> str:
        time.sleep(0.25)
        return q.upper()

    respond(queries.select(result=pw.apply(slow_upper, queries.query)))
    results: dict[int, tuple] = {}

    def client(i: int, barrier: threading.Barrier) -> None:
        barrier.wait(timeout=30)
        results[i] = _post(port, {"query": f"q{i}"})

    def drive() -> None:
        _wait_ready(port)
        barrier = threading.Barrier(n_clients)
        threads = [threading.Thread(target=client, args=(i, barrier)) for i in range(n_clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)

    run_serving(drive)
    ok = {i: r for i, r in results.items() if r[0] == 200}
    shed = {i: r for i, r in results.items() if r[0] == 429}
    assert len(ok) + len(shed) == n_clients, results
    # budget is 2 and resolution needs an engine tick that takes >= 0.25 s,
    # while all 8 arrive within milliseconds: most must shed
    assert len(shed) >= 4, results
    for i, (_s, body, hdr) in shed.items():
        assert hdr.get("Retry-After"), (i, hdr)
        assert body["error"] == "overloaded"
    for i, (_s, body, _h) in ok.items():
        assert body == f"Q{i}".upper()
    [route] = S.serving_status(pw.internals.run.current_runtime())["routes"]
    assert route["shed_total"] == len(shed)
    assert route["responses_total"] == len(ok)
    assert route["requests_total"] == n_clients


# ------------------------------------------------------------------- lifecycle


def test_webserver_lifecycle_port_reuse_and_shutdown_flush():
    """Run 1 leaves a request pending (its query produces no response row) —
    engine shutdown must flush it with a fast 503. Run 2 binds the SAME port
    immediately after: stop() released it (server shut down, thread joined)."""
    port = _free_port()
    queries, respond = pw.io.http.rest_connector(host="127.0.0.1", port=port, schema=QuerySchema)
    answered = queries.filter(queries.query != "blackhole")
    respond(answered.select(result=pw.apply(lambda q: q.upper(), answered.query)))
    pending_result: dict = {}

    def drive() -> None:
        _wait_ready(port)

        def pending_client() -> None:
            t0 = time.perf_counter()
            status, body, _ = _post(port, {"query": "blackhole"})
            pending_result.update(status=status, body=body, elapsed=time.perf_counter() - t0)

        t = threading.Thread(target=pending_client)
        t.start()
        time.sleep(0.5)  # let the request register + drain into the engine
        _stop_current_run()
        t.join(timeout=30)
        assert not t.is_alive(), "pending client still blocked after stop"

    run_serving(drive)
    assert pending_result["status"] == 503, pending_result
    assert pending_result["body"] == {"error": "engine shutting down"}
    # flushed at shutdown, NOT after the 120 s request timeout
    assert pending_result["elapsed"] < 30, pending_result

    # ---- run 2: fresh pipeline on the same port ----
    pw.G.clear()
    _upper_route(port)
    result2: dict = {}

    def drive2() -> None:
        _wait_ready(port)
        status, body, _ = _post(port, {"query": "again"})
        result2.update(status=status, body=body)

    run_serving(drive2)
    assert result2 == {"status": 200, "body": "AGAIN"}


# ------------------------------------------------- keep/delete served queries


def _run_query_row_lifecycle(keep_queries: bool) -> list[bool]:
    """One served request; returns the queries-table additions/retractions
    observed by an independent subscriber."""
    port = _free_port()
    queries = _upper_route(port, keep_queries=keep_queries)
    events: list[bool] = []
    pw.io.subscribe(queries, lambda key, row, time, is_addition: events.append(is_addition))
    out: dict = {}

    def drive() -> None:
        _wait_ready(port)
        out["answer"] = _post(port, {"query": "x"})[:2]
        time.sleep(0.3)  # let the post-serve retraction tick land

    run_serving(drive)
    assert out["answer"] == (200, "X")
    return events


def test_delete_completed_queries_retracts_served_row():
    assert _run_query_row_lifecycle(keep_queries=False) == [True, False]


def test_keep_queries_retains_served_row():
    assert _run_query_row_lifecycle(keep_queries=True) == [True]


# --------------------------------------------------------------------- OpenAPI


def test_openapi_schema_endpoint():
    port = _free_port()

    class RetrieveSchema(pw.Schema):
        query: str
        k: int = pw.column_definition(default_value=3)

    queries, respond = pw.io.http.rest_connector(
        host="127.0.0.1",
        port=port,
        route="/v1/retrieve",
        schema=RetrieveSchema,
        methods=("GET", "POST"),
        documentation=pw.io.http.EndpointDocumentation(summary="Retrieve top-k chunks", tags=["rag"]),
    )
    respond(queries.select(result=pw.apply(lambda q, k: q * k, queries.query, queries.k)))
    spec: dict = {}
    out: dict = {}

    def drive() -> None:
        _wait_ready(port)
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/_schema", timeout=10) as resp:
            spec.update(json.loads(resp.read()))
        out["post"] = _post(port, {"query": "ab", "k": 2}, route="/v1/retrieve")[:2]
        # GET path with query-param coercion (k arrives as a string)
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/v1/retrieve?query=cd&k=3", timeout=10) as resp:
            out["get"] = (resp.status, json.loads(resp.read()))

    run_serving(drive)
    assert out == {"post": (200, "abab"), "get": (200, "cdcdcd")}
    assert spec["openapi"].startswith("3.")
    item = spec["paths"]["/v1/retrieve"]
    assert set(item) == {"get", "post"}
    post_op = item["post"]
    assert post_op["summary"] == "Retrieve top-k chunks"
    assert post_op["tags"] == ["rag"]
    body_schema = post_op["requestBody"]["content"]["application/json"]["schema"]
    assert body_schema["properties"]["query"] == {"type": "string"}
    assert body_schema["properties"]["k"] == {"type": "integer", "default": 3}
    assert body_schema["required"] == ["query"]
    get_params = {p["name"]: p for p in item["get"]["parameters"]}
    assert get_params["query"]["required"] is True
    assert get_params["k"]["required"] is False


# ------------------------------------------- DocumentStore over the front door


def test_document_store_server_retrieve_over_rest():
    """The full RAG serving path: DocumentStoreServer's /v1/retrieve answers a
    live HTTP query with the real top-k — not a provisional empty reply."""
    from pathway_tpu_torch.stdlib.indexing import BruteForceKnnFactory
    from pathway_tpu_torch.xpacks.llm import DocumentStore
    from pathway_tpu_torch.xpacks.llm.mocks import FakeEmbedder
    from pathway_tpu_torch.xpacks.llm.servers import DocumentStoreServer

    docs = pw.debug.table_from_rows(
        pw.schema_from_types(data=str),
        [("kafka topics stream rows",), ("tpu matmul systolic array",), ("bananas are yellow",)],
    )
    store = DocumentStore(
        docs, retriever_factory=BruteForceKnnFactory(embedder=FakeEmbedder(dimension=16), device="cpu")
    )
    port = _free_port()
    DocumentStoreServer("127.0.0.1", port, store)
    out: dict = {}

    def drive() -> None:
        _wait_ready(port)
        out["status"], out["body"], _ = _post(port, {"query": "kafka topics stream rows", "k": 1}, route="/v1/retrieve")

    run_serving(drive)
    assert out["status"] == 200
    assert out["body"], "retrieve returned the provisional padded reply"
    assert out["body"][0]["text"] == "kafka topics stream rows", out


# ------------------------------------------------ front-door protection (units)


def test_token_bucket_refill_and_retry_after():
    from pathway_tpu_torch.fabric.limits import TokenBucket, retry_after_header

    t = [0.0]
    b = TokenBucket(rate=2.0, burst=3, clock=lambda: t[0])
    assert [b.try_take() for _ in range(3)] == [0.0, 0.0, 0.0]  # burst
    wait = b.try_take()
    assert wait == pytest.approx(0.5)  # one token at 2/s
    assert retry_after_header(wait) == "1"  # rounded UP, never early
    t[0] += 0.5
    assert b.try_take() == 0.0
    assert b.try_take() == pytest.approx(0.5)
    t[0] += 100.0  # refill clamps at burst
    assert b.available() == pytest.approx(3.0)
    # default burst = ceil(rate)
    b2 = TokenBucket(rate=2.5, clock=lambda: t[0])
    assert b2.burst == 3


def test_api_key_guard_and_header_extraction():
    from pathway_tpu_torch.fabric.limits import FORBIDDEN, UNAUTHORIZED, ApiKeyGuard, extract_api_key

    g = ApiKeyGuard(("secret-1", "secret-2"))
    assert g.check(None) == UNAUTHORIZED
    assert g.check("") == UNAUTHORIZED
    assert g.check("wrong") == FORBIDDEN
    assert g.check("secret-2") is None
    assert ApiKeyGuard(()).check(None) is None  # auth off
    assert extract_api_key({"X-API-Key": "k"}) == "k"
    assert extract_api_key({"Authorization": "Bearer tok"}) == "tok"
    # X-API-Key wins over Authorization; Basic auth is not an API key
    assert extract_api_key({"X-API-Key": "a", "Authorization": "Bearer b"}) == "a"
    assert extract_api_key({"Authorization": "Basic xyz"}) is None
    assert extract_api_key({}) is None


def test_mint_request_key_is_pid_salted(monkeypatch):
    """Two processes' Nth requests must never mint the same engine key."""
    monkeypatch.delenv("PATHWAY_PROCESS_ID", raising=False)
    monkeypatch.setattr(S, "_KEY_SEQ", iter([7, 7]))
    k0 = S.mint_request_key()
    monkeypatch.setenv("PATHWAY_PROCESS_ID", "2")
    assert S.mint_request_key() != k0


def test_rate_limited_response_carries_retry_after():
    from pathway_tpu_torch.fabric.limits import TokenBucket

    state = S._RouteServing("/r", ("POST",), None)
    state.limiter = TokenBucket(rate=1.0, burst=1)
    assert S.gate_check(state, {}) is None  # burst token
    status, body, hdrs = S.gate_check(state, {})
    assert status == 429 and body["error"] == "rate limited"
    assert int(hdrs["Retry-After"]) >= 1
    assert state.limited_total == 1


# ------------------------------------------- front-door protection, live route


def test_rate_limit_and_auth_exact_counters_under_mixed_flood():
    """One route with auth + a token bucket, flooded by a mix of authorized,
    key-less and wrong-key clients: every client-observed 401/403/429/200
    matches the route's exact counters, and admitted+rejected == sent."""
    port = _free_port()
    _upper_route(port, rate_limit=5.0, api_keys=("good-key",))
    n = 40
    results: dict[str, list] = {"auth": [], "nokey": [], "badkey": []}

    def drive() -> None:
        _wait_ready(port)
        for i in range(n):
            results["auth"].append(_post(port, {"query": f"q{i}"}, headers={"X-API-Key": "good-key"}))
            results["nokey"].append(_post(port, {"query": f"n{i}"}))
            results["badkey"].append(_post(port, {"query": f"b{i}"}, headers={"Authorization": "Bearer wrong"}))

    run_serving(drive)
    assert all(r[:2] == (401, {"error": "missing api key"}) for r in results["nokey"])
    assert all(r[:2] == (403, {"error": "invalid api key"}) for r in results["badkey"])
    ok = [r for r in results["auth"] if r[0] == 200]
    limited = [r for r in results["auth"] if r[0] == 429]
    assert len(ok) + len(limited) == n and ok
    assert limited, "the 5 req/s bucket never engaged — flood too slow?"
    for _s, body, hdrs in limited:
        assert body == {"error": "rate limited", "reason": "rate_limit"}
        assert int(hdrs["Retry-After"]) >= 1
    [route] = S.serving_status(pw.internals.run.current_runtime())["routes"]
    assert route["unauthorized_total"] == n
    assert route["forbidden_total"] == n
    assert route["limited_total"] == len(limited)
    assert route["responses_total"] == len(ok)
    assert route["requests_total"] == 3 * n
    assert route["rate_limit"] == 5.0 and route["auth"] is True


# ---------------------------------------------------- client hangs up mid-flight


def test_client_hangup_releases_its_slot_and_retracts_its_row():
    """A raw-socket client sends a request whose query never gets an answer
    and closes before one comes: its handler is cancelled, the in-flight slot
    is free again, and its query row is retracted (delete_completed)."""
    port = _free_port()
    queries, respond = pw.io.http.rest_connector(host="127.0.0.1", port=port, schema=QuerySchema)
    answered = queries.filter(queries.query != "blackhole")
    respond(answered.select(result=pw.apply(lambda q: q.upper(), answered.query)))
    events: list[tuple[str, bool]] = []
    pw.io.subscribe(queries, lambda key, row, time, is_addition: events.append((row["query"], is_addition)))
    out: dict = {}

    def drive() -> None:
        _wait_ready(port)
        body = json.dumps({"query": "blackhole"}).encode()
        sock = socket.create_connection(("127.0.0.1", port), timeout=10)
        sock.sendall(
            b"POST / HTTP/1.1\r\nHost: x\r\nContent-Type: application/json\r\n"
            + f"Content-Length: {len(body)}\r\n\r\n".encode()
            + body
        )
        rs = _route_state("/")
        deadline = time.monotonic() + 10
        # the engine must ingest the row in a tick before the hang-up: an
        # insert and its retraction drained in one tick net to nothing
        while (not rs.futures or ("blackhole", True) not in events) and time.monotonic() < deadline:
            time.sleep(0.01)
        out["in_flight_before"] = len(rs.futures)
        sock.close()
        deadline = time.monotonic() + 10
        while (rs.futures or ("blackhole", False) not in events) and time.monotonic() < deadline:
            time.sleep(0.01)
        out["in_flight_after"] = len(rs.futures)
        # the slot serves the next client
        out["next"] = _post(port, {"query": "after"})[:2]

    run_serving(drive)
    assert out["in_flight_before"] == 1
    assert out["in_flight_after"] == 0
    assert events[:2] == [("blackhole", True), ("blackhole", False)]
    assert out["next"] == (200, "AFTER")
    [route] = S.serving_status(pw.internals.run.current_runtime())["routes"]
    assert route["requests_total"] == 2 and route["responses_total"] == 1
    assert route["timeouts_total"] == 0 and route["in_flight"] == 0


def _route_state(route: str) -> S._RouteServing:
    """The live serving state of ``route`` in the current run."""
    rt = pw.internals.run.current_runtime()
    return next(rs for rs in list(S._ROUTES) if rs.route == route and rs.runtime is rt)


# ----------------------------------------------------------- the wire's bounds


def test_expect_continue_and_oversized_body_on_the_wire():
    """``Expect: 100-continue`` gets its interim answer before the final one;
    a body over ``MAX_BODY`` (aiohttp's 1 MiB ``client_max_size``) is refused
    with 413 before it is read, and the connection closes."""
    from pathway_tpu_torch.io.http import _wire

    port = _free_port()
    _upper_route(port)
    out: dict = {}

    def exchange(payload: bytes) -> bytes:
        with socket.create_connection(("127.0.0.1", port), timeout=10) as sock:
            sock.sendall(payload)
            sock.settimeout(2.0)
            data = b""
            try:
                while chunk := sock.recv(65536):
                    data += chunk
            except socket.timeout:
                pass
        return data

    def drive() -> None:
        _wait_ready(port)
        body = b'{"query": "cont"}'
        out["continue"] = exchange(
            b"POST / HTTP/1.1\r\nHost: h\r\nExpect: 100-continue\r\nConnection: close\r\n"
            + f"Content-Length: {len(body)}\r\n\r\n".encode() + body
        )
        out["too_large"] = exchange(
            f"POST / HTTP/1.1\r\nHost: h\r\nContent-Length: {_wire.MAX_BODY + 1}\r\n\r\n".encode() + b"x" * 1024
        )

    run_serving(drive)
    assert out["continue"].startswith(b"HTTP/1.1 100 Continue\r\n\r\nHTTP/1.1 200 OK\r\n")
    assert out["continue"].endswith(b'"CONT"')
    assert out["too_large"].startswith(b"HTTP/1.1 413 Request Entity Too Large\r\n")
    assert b"Connection: close" in out["too_large"]
    [route] = S.serving_status(pw.internals.run.current_runtime())["routes"]
    assert route["requests_total"] == 1  # the refused body never reached the route


def test_qa_summary_server_serves_every_route():
    """``QASummaryRestServer`` adds ``/v2/summarize`` to QARestServer's
    routes; the fake chat model echoes its prompt, so the summary holds the
    texts sent."""
    from pathway_tpu_torch.stdlib.indexing import TantivyBM25Factory
    from pathway_tpu_torch.xpacks.llm import DocumentStore
    from pathway_tpu_torch.xpacks.llm.mocks import FakeChatModel
    from pathway_tpu_torch.xpacks.llm.question_answering import BaseRAGQuestionAnswerer
    from pathway_tpu_torch.xpacks.llm.servers import QASummaryRestServer

    docs = pw.debug.table_from_rows(pw.schema_from_types(data=str), [("alpha beta",), ("gamma delta",)])
    rag = BaseRAGQuestionAnswerer(FakeChatModel(), DocumentStore(docs, retriever_factory=TantivyBM25Factory()))
    port = _free_port()
    QASummaryRestServer("127.0.0.1", port, rag)
    out: dict = {}

    def drive() -> None:
        _wait_ready(port)
        out["summary"] = _post(port, {"text_list": ["first text", "second text"]}, route="/v2/summarize")[:2]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/_schema", timeout=10) as resp:
            out["paths"] = sorted(json.loads(resp.read())["paths"])

    run_serving(drive)
    status, summary = out["summary"]
    assert status == 200 and "first text" in summary and "second text" in summary
    assert out["paths"] == [
        "/v1/inputs", "/v1/retrieve", "/v1/statistics", "/v2/answer", "/v2/list_documents", "/v2/summarize",
    ]
