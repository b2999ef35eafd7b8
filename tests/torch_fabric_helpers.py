"""Cluster scripts of the port's serving-fabric tests (``tests/test_torch_fabric.py``,
``tests/test_torch_index_replica.py``), run as
``python tests/torch_fabric_helpers.py <script> <http_port> <out>`` on every
process of a cluster. Process 0 drives the doors once every door answers
``/readyz`` 200 (never a bare TCP connect), writes what it saw to ``<out>`` as
JSON and stops the run. Door ``p`` listens on ``http_port + p``
(``PATHWAY_FABRIC_PORT_STRIDE`` 1), monitoring on
``PATHWAY_MONITORING_HTTP_PORT + p``.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
import urllib.error
import urllib.request


def _request(url: str, payload: dict | None = None, timeout: float = 60.0):
    """(status, body, headers) without raising on HTTP errors."""
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read().decode(), dict(r.headers)
    except urllib.error.HTTPError as e:
        with e:
            return e.code, e.read().decode(), dict(e.headers)


def wait_doors(ports: list[int], timeout: float = 60.0) -> None:
    """Every door answers ``/readyz`` 200 (a door is ready once its
    connectors started and, on a peer, its fabric installed)."""
    deadline = time.monotonic() + timeout
    for p in ports:
        while True:
            status, _b, _h = (None, None, None)
            try:
                status, _b, _h = _request(f"http://127.0.0.1:{p}/readyz", timeout=2.0)
            except OSError:
                pass
            if status == 200:
                break
            if time.monotonic() > deadline:
                raise TimeoutError(f"door {p} never became ready")
            time.sleep(0.05)


def _doors(port: int) -> list[int]:
    n = int(os.environ.get("PATHWAY_PROCESSES", "1"))
    on = os.environ.get("PATHWAY_FABRIC") == "on"
    return [port + i for i in range(n)] if on else [port]


def _finish(pw, out: str, doc: dict) -> None:
    with open(out, "w") as fh:
        json.dump(doc, fh)
    rt = pw.internals.run.current_runtime()
    if rt is not None:
        rt.request_stop()


def _client(pw, target) -> None:
    if int(os.environ.get("PATHWAY_PROCESS_ID", "0")) == 0:
        threading.Thread(target=target, daemon=True).start()


def retrieve(pw, port: int, out: str) -> None:
    """embed → KNN → rerank behind ``/v1/retrieve`` (the reference test's
    pipeline); process 0 sends the same queries to every door."""
    from pathway_tpu_torch.stdlib.indexing import BruteForceKnnFactory
    from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder
    from pathway_tpu_torch.xpacks.llm.rerankers import EncoderReranker

    emb = SentenceTransformerEmbedder("tiny", seed=0, device="cpu")
    rr = EncoderReranker(emb)
    docs = [f"alpha beta doc{i} gamma delta" for i in range(24)]
    doc_t = pw.debug.table_from_rows(pw.schema_from_types(text=str), [(d,) for d in docs])
    index = BruteForceKnnFactory(embedder=emb, reserved_space=64, device="cpu").build_index(doc_t.text, doc_t)
    ws = pw.io.http.PathwayWebserver(host="127.0.0.1", port=port)
    queries, respond = pw.io.http.rest_connector(
        webserver=ws, route="/v1/retrieve", schema=pw.schema_from_types(query=str)
    )
    picked = index.query_as_of_now(queries.query, number_of_matches=2).select(
        q=pw.left.query, top=pw.apply(lambda ts: ts[0] if ts else "", pw.right.text)
    )
    scored = picked.select(picked.top, score=rr(picked.top, picked.q))
    respond(scored.select(
        result=pw.apply(lambda t, s: {"top": t, "score": round(float(s), 6)}, scored.top, scored.score)
    ))
    mon = int(os.environ.get("PATHWAY_MONITORING_HTTP_PORT", "0"))

    def client():
        doors = _doors(port)
        wait_doors(doors)
        doc = {"answers": {}, "rids": {}, "fabric": {}}
        qs = ["alpha beta doc3 gamma", "doc7 delta", "gamma doc11 alpha"]
        for p in doors:
            got = [_request(f"http://127.0.0.1:{p}/v1/retrieve", {"query": q}) for q in qs]
            doc["answers"][str(p)] = [[s, b] for s, b, _h in got]
            doc["rids"][str(p)] = [h.get("X-Pathway-Request-Id") for _s, _b, h in got]
            doc["fabric"][str(p)] = [h.get("X-Pathway-Fabric") for _s, _b, h in got]
        doc["schemas"] = [_request(f"http://127.0.0.1:{p}/_schema")[1] for p in doors]
        if mon and len(doors) > 1:
            # the last door is a peer: its kept trace (ingress spans) and the
            # coordinator's (owner spans) share one trace id
            rid = doc["rids"][str(doors[-1])][0]
            doc["peer_trace"] = json.loads(_request(f"http://127.0.0.1:{mon + len(doors) - 1}/request?id={rid}")[1])
            doc["owner_trace"] = json.loads(_request(f"http://127.0.0.1:{mon}/request?id={rid}")[1])
            time.sleep(1.6)  # two heartbeat intervals: the serving rollup lands
            doc["status"] = json.loads(_request(f"http://127.0.0.1:{mon}/status")[1])
        _finish(pw, out, doc)

    _client(pw, client)
    pw.run(monitoring_level="none", with_http_server=bool(mon))


def lookup(pw, port: int, out: str) -> None:
    """A churning table served by ``serve_table`` (the reference test's
    replica pipeline): lookups at every door during and after the churn."""
    keys = 8

    class Churn(pw.io.python.ConnectorSubject):
        def __init__(self):
            super().__init__()
            self._stop = False

        def run(self):
            i = 0
            while not self._stop and i < 200:
                self.next_batch([{"name": f"k{i % keys}", "price": i}])
                i += 1
                time.sleep(0.005)

        def on_stop(self):
            self._stop = True

    feed = pw.io.python.read(Churn(), schema=pw.schema_from_types(name=str, price=int), name="churn")
    latest = feed.groupby(feed.name).reduce(name=feed.name, price=pw.reducers.max(feed.price))
    ws = pw.io.http.PathwayWebserver(host="127.0.0.1", port=port)
    pw.io.http.serve_table(latest, route="/v1/latest", key_column="name", webserver=ws)
    mon = int(os.environ.get("PATHWAY_MONITORING_HTTP_PORT", "0"))

    def client():
        doors = _doors(port)
        wait_doors(doors)
        time.sleep(0.5)
        doc = {"during": [], "settled": []}
        for i in range(20):
            s, _b, h = _request(f"http://127.0.0.1:{doors[-1]}/v1/latest?name=k{i % keys}")
            doc["during"].append([s, h.get("X-Pathway-Fabric"), h.get("X-Pathway-Replica-Lag-Ms")])
            time.sleep(0.02)
        time.sleep(2.5)  # the churn ends (200 rows); every store settles
        for k in range(keys):
            doc["settled"].append([
                [s, b, h.get("X-Pathway-Fabric")]
                for s, b, h in (_request(f"http://127.0.0.1:{p}/v1/latest?name=k{k}") for p in doors)
            ])
        if mon and len(doors) > 1:
            doc["peer_metrics"] = _request(f"http://127.0.0.1:{mon + len(doors) - 1}/metrics")[1]
            doc["peer_status"] = json.loads(_request(f"http://127.0.0.1:{mon + len(doors) - 1}/status")[1])
        _finish(pw, out, doc)

    _client(pw, client)
    pw.run(monitoring_level="none", with_http_server=bool(mon), autocommit_duration_ms=20)


def store(pw, port: int, out: str) -> None:
    """A ``DocumentStoreServer`` over a brute-force index fed by a seed table
    and a churning stream (the reference's replica-served retrieval
    pipeline): ``/v1/retrieve`` at every door during the churn, then until
    every door answers the same bytes with the peers answering locally."""
    from pathway_tpu_torch.stdlib.indexing import BruteForceKnnFactory
    from pathway_tpu_torch.xpacks.llm.document_store import DocumentStore
    from pathway_tpu_torch.xpacks.llm.mocks import FakeEmbedder
    from pathway_tpu_torch.xpacks.llm.servers import DocumentStoreServer

    n_base, n_churn = 12, 48
    base = pw.debug.table_from_rows(
        pw.schema_from_types(data=str), [(f"seed doc {i:02d} topic{i % 5} alpha beta",) for i in range(n_base)]
    )

    class Churn(pw.io.python.ConnectorSubject):
        def __init__(self):
            super().__init__()
            self._stop = False

        def run(self):
            for i in range(n_churn):
                if self._stop:
                    return
                self.next_batch([{"data": f"churn doc {i:02d} topic{i % 5} gamma delta"}])
                time.sleep(0.02)

        def on_stop(self):
            self._stop = True

    feed = pw.io.python.read(Churn(), schema=pw.schema_from_types(data=str), name="churn_docs")
    ds = DocumentStore(
        base.concat_reindex(feed),
        retriever_factory=BruteForceKnnFactory(embedder=FakeEmbedder(dimension=16), device="cpu"),
    )
    DocumentStoreServer("127.0.0.1", port, ds)
    mon = int(os.environ.get("PATHWAY_MONITORING_HTTP_PORT", "0"))

    def client():
        doors = _doors(port)
        wait_doors(doors)
        qs = [
            {"query": "topic2 alpha beta", "k": 3},
            {"query": "churn doc 07", "k": 3},
            {"query": "seed doc 03 topic3", "k": 4, "metadata_filter": "((("},
        ]
        doc = {"during": [], "settled": None}
        for i in range(12):
            s, _b, h = _request(f"http://127.0.0.1:{doors[i % len(doors)]}/v1/retrieve", qs[i % 2])
            doc["during"].append([s, h.get("X-Pathway-Fabric"), h.get("X-Pathway-Replica-Lag-Ms")])
            time.sleep(0.05)
        deadline = time.monotonic() + 40
        while time.monotonic() < deadline:
            rounds = [[_request(f"http://127.0.0.1:{p}/v1/retrieve", q) for p in doors] for q in qs]
            same = all(len({b for _s, b, _h in row}) == 1 for row in rounds)
            local = all(
                (h.get("X-Pathway-Fabric") or "").startswith("replica:") for row in rounds for _s, _b, h in row[1:]
            )
            full = all(len(json.loads(row[0][1])) == q["k"] for row, q in zip(rounds[:2], qs))
            if same and local and full:
                doc["settled"] = [[[s, b, h.get("X-Pathway-Fabric")] for s, b, h in row] for row in rounds]
                break
            time.sleep(0.3)
        if mon and len(doors) > 1:
            time.sleep(1.6)  # two heartbeat intervals: the coordinator rollup lands
            doc["status"] = json.loads(_request(f"http://127.0.0.1:{mon}/status")[1])
            doc["peer_status"] = json.loads(_request(f"http://127.0.0.1:{mon + len(doors) - 1}/status")[1])
            doc["peer_metrics"] = _request(f"http://127.0.0.1:{mon + len(doors) - 1}/metrics")[1]
        _finish(pw, out, doc)

    _client(pw, client)
    pw.run(monitoring_level="none", with_http_server=bool(mon), autocommit_duration_ms=50)


SCRIPTS = {f.__name__: f for f in (retrieve, lookup, store)}


def run(script: str, tmp_path, processes: int, env: dict | None = None, timeout: float = 120) -> dict:
    """Run ``SCRIPTS[script]`` on a ``processes``-wide cluster (one process
    without a cluster); every process must exit 0. Returns process 0's
    result. The ports come from one block of this xdist worker's range:
    the cluster's bands at ``base``, the doors at ``base + 7``, monitoring
    at ``base + 9``. Relaunches once on ``EADDRINUSE``."""
    import subprocess

    import torch_cluster_helpers as tc

    out = str(tmp_path / f"{script}.p{processes}.json")
    for attempt in range(2):
        base = tc.first_port(processes, span=12)
        full = tc._env(processes, 1, {
            "PATHWAY_FIRST_PORT": str(base), "PATHWAY_MONITORING_HTTP_PORT": str(base + 9), **(env or {}),
        })
        procs = [
            subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), script, str(base + 7), out],
                env=dict(full, PATHWAY_PROCESS_ID=str(pid)),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for pid in range(processes)
        ]
        texts = []
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                texts.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0] or "")
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            texts = [p.communicate(timeout=30)[0] or "" for p in procs]
            raise AssertionError("cluster process hung:\n" + "\n---\n".join(texts))
        codes = [p.returncode for p in procs]
        if attempt == 0 and any(rc != 0 and tc._addr_in_use(t) for rc, t in zip(codes, texts)):
            continue
        assert codes == [0] * processes, "\n---\n".join(texts)
        with open(out) as fh:
            return json.load(fh)
    raise AssertionError("unreachable")


if __name__ == "__main__":
    import pathway_tpu_torch

    SCRIPTS[sys.argv[1]](pathway_tpu_torch, int(sys.argv[2]), sys.argv[3])
