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
``time`` and ``diff``.

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
    kwargs = {"monitoring_level": "none"}
    if args.persist:
        kwargs["persistence_config"] = pw.persistence.Config(
            backend=pw.persistence.Backend.filesystem(args.persist),
            persistence_mode="operator_persisting",
            snapshot_interval_ms=SNAPSHOT_MS,
        )
    pw.run(**kwargs)
    rt = pw.internals.run.current_runtime()
    replayed = getattr(getattr(rt, "persistence", None), "replayed_events", None)
    print(f"rag_cluster: process {os.environ.get('PATHWAY_PROCESS_ID', '0')} attention launches "
          f"{A.LAUNCHES} replayed {replayed}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
