"""The live-RAG loop of ``tools/rag_pipeline.py`` as one process of a
cluster, writing its answers to a csv file.

    PATHWAY_PROCESSES=2 PATHWAY_PROCESS_ID=<pid> PATHWAY_THREADS=2 \\
    PATHWAY_FIRST_PORT=<port> python -m pathway_tpu_torch.tools.rag_cluster \\
        --out answers.csv --docs 4096 --queries 256

Every process of the cluster runs this same command (the cluster env says
which process it is); a single process runs it with no cluster env. The
docs are :func:`synth_docs` (seed 0, 120 words from a 5,000-word vocab, as
``chip_smoke.py``'s), the queries the first ``--queries`` docs; both stream
in ``--tick``-row ticks, docs first. The embedder is the ``minilm``
sentence encoder (seed 0) and the reranker ``chip_smoke.py``'s 4-layer
cross-encoder (seed 1), on ``--device`` (default: the card); ``--model
tiny`` swaps both for narrow 2-layer encoders for a CPU rehearsal.
``--persist DIR`` runs under ``operator_persisting`` persistence on a
filesystem backend at DIR, snapshotting every 500 ms (a restart resumes
from its last committed epoch; the csv sink rewinds to it). The csv holds
one row per (query, hit): ``qi, dkey, di, rank, knn, rerank`` with
``time`` and ``diff``. ``--http`` serves the monitoring server (``/status``,
``/scale``; process ``p`` at ``PATHWAY_MONITORING_HTTP_PORT + p``) and
``--pace-ms MS`` adds a live ticker, one row every MS ms for twice the
stream's ticks, whose subscriber sleeps MS ms at each tick's end: every
tick is held at least MS ms, so that an operator's scale request lands
mid-stream.
Under ``PATHWAY_ELASTIC=manual`` and a supervisor (``python -m
pathway_tpu_torch supervise``, or ``resilience.Supervisor``) such a request
quiesces the pod, which exits 75 and is relaunched at the new shape. The
quiescing pod's close polls the timed docs and queries to their end, so
every one of them is logged before it exits and the relaunched pod only
replays them, re-embedding every doc (the index cannot migrate); the ticker
resumes from its log, so the relaunched pod streams on and a second request
can land on it. Each process prints, as it leaves
(the rescale exit included), one line ``rag_cluster_stats: {json}``: its
attention launches per route, the rows each batched UDF (the embedder, the
reranker) took and the tokens its encoder embedded, the
events it replayed, the reshard record of its restore, the rescale it
decided (process 0), the membership
version and the wall-clock time of its first answer.

``--serve PORT`` serves instead: the docs go into a ``DocumentStore`` over a
brute-force index of the embedder on ``--device``, and
``DocumentStoreServer`` answers ``/v1/retrieve`` at PORT (with
``PATHWAY_FABRIC=on``, process ``p``'s door at ``PORT + p``, the fabric's
port stride being 1). Process 0 waits until every door answers ``/readyz``
and the coordinator counts every doc, then asks each door the first
``--queries`` docs (``k = --k``), one request at a time, and writes, per
door, ``[status, body, X-Pathway-Fabric, ms]`` of each answer to ``--out``
as JSON before it stops the run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np


#: operator snapshot cadence under ``--persist``
SNAPSHOT_MS = 500


def synth_docs(n: int, words: int = 120) -> list[str]:
    """``n`` docs of ``words`` words from a 5,000-word vocab (seed 0)."""
    rng = np.random.default_rng(0)
    vocab = [f"word{i}" for i in range(5000)]
    return [" ".join(rng.choice(vocab, size=words)) for _ in range(n)]


def models(kind: str, device: str):
    """(embedder, reranker) UDFs: ``minilm`` widths or a ``tiny`` pair."""
    from pathway_tpu_torch.ops.encoder import EncoderConfig
    from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder
    from pathway_tpu_torch.xpacks.llm.rerankers import CrossEncoderReranker

    if kind == "tiny":
        cfg = EncoderConfig(vocab_size=4096, d_model=64, n_heads=2, n_layers=2, d_ff=128, max_len=128)
        return (SentenceTransformerEmbedder(cfg, seed=0, device=device),
                CrossEncoderReranker(cfg, seed=1, device=device))
    rr_cfg = EncoderConfig(vocab_size=32768, d_model=384, n_heads=6, n_layers=4, d_ff=1536, max_len=256)
    return (SentenceTransformerEmbedder("minilm", seed=0, device=device),
            CrossEncoderReranker(rr_cfg, seed=1, device=device))


def _request(url: str, payload: dict | None = None, timeout: float = 120.0) -> tuple[int, str, dict]:
    """(status, body, headers) of one request; an HTTP error is an answer."""
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read().decode(), dict(r.headers)
    except urllib.error.HTTPError as e:
        with e:
            return e.code, e.read().decode(), dict(e.headers)


def _serve_client(pw, port: int, docs: list[str], args) -> None:
    """Process 0's client of the served mode (see the module docstring)."""
    n_doors = int(os.environ.get("PATHWAY_PROCESSES", "1")) if os.environ.get("PATHWAY_FABRIC") == "on" else 1
    doors = [port + p for p in range(n_doors)]
    deadline = time.monotonic() + 600
    try:
        for p in doors:
            while _safe(lambda: _request(f"http://127.0.0.1:{p}/readyz", timeout=2.0)[0]) != 200:
                if time.monotonic() > deadline:
                    raise TimeoutError(f"door {p} never became ready")
                time.sleep(0.05)
        while True:
            status, body, _h = _request(f"http://127.0.0.1:{doors[0]}/v1/statistics", {})
            if status == 200 and json.loads(body).get("file_count") == len(docs):
                break
            if time.monotonic() > deadline:
                raise TimeoutError(f"the store never counted {len(docs)} docs: {status} {body}")
            time.sleep(0.1)
        # a peer door answers from its own replica once the replica caught up
        # (it forwards to the owner before); wait for that, at most 60 s
        first = {"query": docs[0], "k": args.k}
        settle = time.monotonic() + 60
        while time.monotonic() < settle and any(
            (_request(f"http://127.0.0.1:{p}/v1/retrieve", first)[2].get("X-Pathway-Fabric") or "").startswith(
                "forwarded:")
            for p in doors
        ):
            time.sleep(0.2)
        answers = {}
        for p in doors:
            rows = []
            for text in docs[: args.queries]:
                t0 = time.perf_counter()
                status, body, headers = _request(f"http://127.0.0.1:{p}/v1/retrieve", {"query": text, "k": args.k})
                rows.append([status, body, headers.get("X-Pathway-Fabric"), (time.perf_counter() - t0) * 1e3])
            answers[str(p)] = rows
        with open(args.out, "w") as fh:
            json.dump(answers, fh)
    finally:
        rt = pw.internals.run.current_runtime()
        while rt is None:
            time.sleep(0.01)
            rt = pw.internals.run.current_runtime()
        rt.request_stop()


def _safe(fn):
    try:
        return fn()
    except OSError:
        return None


def serve(pw, args) -> None:
    """The served mode (``--serve PORT``; see the module docstring)."""
    from pathway_tpu_torch.stdlib.indexing import BruteForceKnnFactory
    from pathway_tpu_torch.xpacks.llm.document_store import DocumentStore
    from pathway_tpu_torch.xpacks.llm.servers import DocumentStoreServer

    emb, _rr = models(args.model, args.device)
    docs = synth_docs(args.docs)
    table = pw.debug.table_from_rows(pw.schema_from_types(data=str), [(d,) for d in docs])
    store = DocumentStore(table, retriever_factory=BruteForceKnnFactory(embedder=emb, device=args.device))
    DocumentStoreServer("127.0.0.1", args.serve, store)
    if int(os.environ.get("PATHWAY_PROCESS_ID", "0")) == 0:
        threading.Thread(target=_serve_client, args=(pw, args.serve, docs, args), daemon=True).start()
    pw.run(monitoring_level="none")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--docs", type=int, default=4096)
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--tick", type=int, default=64)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--model", default="minilm", choices=("minilm", "tiny"))
    ap.add_argument("--persist", default=None)
    ap.add_argument("--serve", type=int, default=None, metavar="PORT")
    ap.add_argument("--http", action="store_true", help="serve the monitoring server")
    ap.add_argument("--pace-ms", type=int, default=0, help="hold every tick at least this long")
    args = ap.parse_args(argv)

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.ops import attention_kernel as A
    from pathway_tpu_torch.stdlib.indexing import BruteForceKnnFactory
    from pathway_tpu_torch.tools import rag_pipeline

    if args.serve is not None:
        serve(pw, args)
        print(f"rag_cluster: process {os.environ.get('PATHWAY_PROCESS_ID', '0')} attention launches "
              f"{A.LAUNCHES} replayed None", flush=True)
        return 0
    emb, rr = models(args.model, args.device)
    docs = synth_docs(args.docs)
    table = rag_pipeline.build(
        pw, embedder=emb, index_factory=BruteForceKnnFactory(embedder=emb, device=args.device),
        reranker=rr, docs=docs, queries=docs[: args.queries], tick_rows=args.tick, k=args.k,
    )
    pw.io.fs.write(table, args.out, format="csv")
    first_answer: list[float] = []
    wall = time.time  # the callback's ``time`` is the tick

    def on_change(key, row, time, is_addition):
        if is_addition and not first_answer:
            first_answer.append(wall())

    pw.io.subscribe(table, on_change=on_change)
    if args.pace_ms:
        # the ticker's subscriber sleeps at each tick's end: its frontier
        # advances every tick (the answers' waits on the microbatch
        # buffers), so the sleep holds ingestion, not only output
        n_ticks = -(-args.docs // args.tick) + -(-args.queries // args.tick)
        pw.io.subscribe(_ticker(pw, 2 * n_ticks, args.pace_ms / 1000.0), on_change=lambda **kw: None,
                        on_time_end=lambda t, s=args.pace_ms / 1000.0: time.sleep(s))
    kwargs = {"monitoring_level": "none", "with_http_server": args.http}
    if args.persist:
        kwargs["persistence_config"] = pw.persistence.Config(
            backend=pw.persistence.Backend.filesystem(args.persist),
            persistence_mode="operator_persisting",
            snapshot_interval_ms=SNAPSHOT_MS,
        )
    try:
        pw.run(**kwargs)
    finally:
        _print_stats(pw, A, first_answer)
    return 0


def _ticker(pw, n: int, pace_s: float):
    """A live stream of ``n`` rows, one every ``pace_s`` seconds, on
    process 0. It is seekable: a restore replays its logged rows and it
    resumes after them."""

    class Ticker(pw.io.python.ConnectorSubject):
        def __init__(self):
            super().__init__()
            self.sync_lock = threading.Lock()
            self._next = 0

        def offset_state(self):
            return {"next": self._next}

        def seek(self, state):
            self._next = int(state["next"])

        def run(self):
            while self._next < n:
                with self.sync_lock:
                    self.next(t=self._next)
                    self._next += 1
                time.sleep(pace_s)

    return pw.io.python.read(Ticker(), schema=pw.schema_from_types(t=int), name="ticker")


def _print_stats(pw, A, first_answer: list[float]) -> None:
    """This process's ``rag_cluster:`` and ``rag_cluster_stats:`` lines (see
    the module docstring), printed on every exit, a rescale's included."""
    from pathway_tpu_torch import elastic
    from pathway_tpu_torch.internals import telemetry
    from pathway_tpu_torch.observability import device as D

    rt = pw.internals.run.current_runtime()
    replayed = getattr(getattr(rt, "persistence", None), "replayed_events", None)
    pid = os.environ.get("PATHWAY_PROCESS_ID", "0")
    with D.stats().lock:
        enc = list(D.stats().pad.get("encoder", [0, 0, 0, 0]))
        udf_rows = {k[len("udf:"):]: v[0] for k, v in D.stats().pad.items() if k.startswith("udf:")}
    backend = getattr(getattr(rt, "persistence", None), "backend", None)
    membership = elastic.read_membership(backend) if backend is not None else None
    print(f"rag_cluster: process {pid} attention launches {A.LAUNCHES} replayed {replayed}", flush=True)
    print("rag_cluster_stats: " + json.dumps({
        "process": int(pid), "processes": int(os.environ.get("PATHWAY_PROCESSES", "1")),
        "attention_launches": dict(A.ROUTE_LAUNCHES), "udf_rows": udf_rows, "encoder_tokens": enc[2] + enc[3],
        "replayed": replayed, "reshard": elastic.last_reshard(),
        "rescale_decided": [e["attrs"] for e in telemetry.events("elastic.rescale_decided")],
        "membership_version": membership.version if membership is not None else None,
        "first_answer_unix": first_answer[0] if first_answer else None, "exit_unix": time.time(),
    }), flush=True)


if __name__ == "__main__":
    sys.exit(main())
