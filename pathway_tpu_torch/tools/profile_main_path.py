"""Where the device time of the port's main path goes, on one CUDA card.

    python -m pathway_tpu_torch.tools.profile_main_path [ops|pipeline|document_store|rest|temporal|all]

``ops`` (the default, and part of ``all``) traces, with ``torch.profiler``,
one ingest batch (1024 bench docs: encode → ``add_batch_device`` → flush) and
one RAG query (encode → search k=10 on an index of 8192 docs → rerank the 10
hits), calling the ops directly, one ingest batch of ``chip_smoke.py``'s
``f32_path`` (the same encoder in f32: f32 GEMMs, the f32 attention route)
and one of its ``bert_path`` (1024 WordPiece docs through the bert block of
a random checkpoint at all-MiniLM-L6-v2's widths, f32).

``pipeline`` traces the same loop run by the engine
(``pathway_tpu_torch/tools/rag_pipeline.py``, the pipeline of
``chip_smoke.py``'s pipeline phase) with the microbatch flush deadline at 0,
so every tick launches what it holds: 8 ticks of 512 docs, then ticks of 64
queries. It traces one engine tick of each kind, after warm ones: the
512-row ingest flush (embed → index) and the 64-row query tick (embed →
search → flatten → rerank of 640 pairs). Besides the device time by kernel,
it gives the tick's host time (wall − device time) split into the engine's
phases (``PATHWAY_ENGINE_PHASES``) and the rest (Python between launches).

``document_store`` traces the DocumentStore of ``chip_smoke.py``'s
document_store phase (``minilm`` embedder, ``TokenCountSplitter(50, 200)``,
the default ``TieredKnnFactory`` on the card), fed 1,024 of its files as
rows (bytes and metadata) in ticks of 128 files, then ``retrieve_query``
rows (k = 6, each a chunk's text) in ticks of 64, flush deadline 0: one
ingest tick (parse → split → embed → index) and one query tick, each with
the engine phase split as for ``pipeline``.

``rest`` serves the same DocumentStore (1,024 files, one static batch) over
HTTP through ``DocumentStoreServer`` on 127.0.0.1, flush deadline 0, and
traces the one engine tick that answers 64 concurrent ``/v1/retrieve``
requests (k = 6, each a chunk's text, from 64 ``http.client`` connections;
the coalesce window wakes the engine once all 64 have arrived), after a warm
round and a timed round of the same (its clients' wall time is printed): the
query embed, the tiered search, the as-of-now joins and the response pass
of the serving plane, with the engine phase split as for ``pipeline`` and
the requests the tick carried.

``temporal`` runs Q5 and Q7 with its 5 s cutoff from ``chip_smoke.py``'s
temporal phase (``tools/nexmark.py``) over 262,144 events in ticks of
65,536, with the engine's device functions on the card
(``PATHWAY_ENGINE_JAX=gpu``, ``PATHWAY_FUSE_JAX=on``), and traces the third
tick of each, with the engine phase split as for ``pipeline``.

All run at the bench's widths with random seeded weights. Each window prints
one JSON line: wall time, summed kernel time, the device's idle share
(1 − device time / wall time; one stream, so kernels do not overlap), the
attention kernel's time and the top kernels by device time. The profiler's
own cost is inside the wall time.
"""

from __future__ import annotations

import json
import sys
import time


def _window(name: str, fn) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    _report(name, prof, wall_ms)


def _report(name: str, prof, wall_ms: float, **extra) -> None:
    from torch.autograd import DeviceType

    # device-side events only (kernels, copies, sets); the CPU-side aten ops
    # carry their kernels' time too and would count it twice
    rows = [
        (ev.key, ev.device_time_total / 1e3, ev.count)
        for ev in prof.key_averages()
        if ev.device_type == DeviceType.CUDA and ev.device_time_total > 0
    ]
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    # the port's attention kernel, either route
    attention_ms = sum(r[1] for r in rows if "attention_tc_kernel" in r[0])
    print(json.dumps({
        "window": name,
        "wall_ms": wall_ms,
        "device_ms": device_ms,
        "host_ms": wall_ms - device_ms,
        "idle_share": 1.0 - device_ms / wall_ms,
        "attention_kernel_ms": attention_ms,
        "top": [{"kernel": k[:90], "ms": ms, "calls": n} for k, ms, n in rows[:12]],
        **extra,
    }), flush=True)


def _synth_docs(n: int) -> list[str]:
    import numpy as np

    rng = np.random.default_rng(0)
    vocab = [f"word{i}" for i in range(5000)]
    return [" ".join(rng.choice(vocab, size=120)) for _ in range(n)]


def profile_pipeline(ingest_tick: int = 5, query_tick: int = 10) -> None:
    """One engine tick of each kind of the RAG pipeline under the profiler.
    Ticks 0-7 each flush 512 docs; ticks 8+ each bring 64 queries."""
    import os

    import torch

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.debug import _capture
    from pathway_tpu_torch.ops.encoder import EncoderConfig
    from pathway_tpu_torch.stdlib.indexing import BruteForceKnnFactory
    from pathway_tpu_torch.tools import rag_pipeline
    from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder
    from pathway_tpu_torch.xpacks.llm.rerankers import CrossEncoderReranker

    os.environ.update(PATHWAY_MICROBATCH="auto", PATHWAY_MICROBATCH_FLUSH_MS="0", PATHWAY_ENGINE_PHASES="on")
    docs = _synth_docs(4096)
    emb = SentenceTransformerEmbedder("minilm", seed=0)
    rr = CrossEncoderReranker(
        EncoderConfig(vocab_size=32768, d_model=384, n_heads=6, n_layers=4, d_ff=1536, max_len=256), seed=1
    )
    emb._encoder.encode_texts(docs[:512])  # warm: allocator, cuBLAS
    rr._model.score_pairs([(docs[0], d) for d in docs[:640]])
    torch.cuda.synchronize()
    windows = {ingest_tick: "pipeline_ingest_tick_512", query_tick: "pipeline_query_tick_64"}
    # docs in 512-row ticks (one ingest flush each), then 64-row query ticks
    pw.G.clear()
    table = rag_pipeline.build(
        pw, embedder=emb, index_factory=BruteForceKnnFactory(embedder=emb), reranker=rr,
        docs=docs, queries=docs[:256], tick_rows=512, query_tick_rows=64, k=10,
    )
    try:
        _profile_ticks(windows, lambda: _capture(table))
    finally:
        pw.G.clear()


def profile_ops() -> None:
    import torch

    from pathway_tpu_torch.ops.encoder import EncoderConfig, TorchSentenceEncoder
    from pathway_tpu_torch.ops.knn import BruteForceKnnIndex
    from pathway_tpu_torch.ops.reranker import TorchCrossEncoder

    docs = _synth_docs(8192)
    cfg = EncoderConfig(vocab_size=32768, d_model=384, n_heads=6, n_layers=6, d_ff=1536, max_len=128)
    enc = TorchSentenceEncoder(cfg, seed=0, param_dtype=torch.bfloat16)
    ce = TorchCrossEncoder(cfg._replace(n_layers=4, max_len=256), seed=1)
    ids, _ = enc.tokenizer(docs)
    index = BruteForceKnnIndex(dimension=cfg.d_model, capacity=8192)
    for i in range(0, len(docs), 1024):
        index.add_batch_device(range(i, i + 1024), enc.encode_ids_device(ids[i : i + 1024]))
    index._flush()

    def ingest():
        embs = enc.encode_ids_device(ids[:1024])
        index.add_batch_device(range(1024), embs)
        index._flush()

    q = "what is word42 about"
    qids, _ = enc.tokenizer([q])

    def query():
        hits = index.search(enc.encode_ids_device(qids), k=10)[0]
        ce.score_pairs([(q, docs[int(k)][:800]) for k, _ in hits])

    enc32 = TorchSentenceEncoder(cfg._replace(dtype=torch.float32), seed=0)

    def ingest_f32():
        embs = enc32.encode_ids_device(ids[:1024])
        index.add_batch_device(range(1024), embs)
        index._flush()

    from pathway_tpu_torch.tools.batch_invariance import bert_encoder
    from pathway_tpu_torch.tools.bert_checkpoint import synthetic_docs

    bert, vocab = bert_encoder("cuda")
    bert_ids, _ = bert.tokenizer(synthetic_docs(vocab, 1024))

    def ingest_bert():
        embs = bert.encode_ids_device(bert_ids)
        index.add_batch_device(range(1024), embs)
        index._flush()

    _window("ingest_batch_1024", ingest)
    _window("rag_query_rerank", query)
    _window("f32_ingest_batch_1024", ingest_f32)
    _window("bert_ingest_batch_1024", ingest_bert)


def _profile_ticks(windows: dict, capture) -> None:
    """Run ``capture()`` with the engine ticks named in ``windows`` (tick →
    window name) under the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pathway_tpu_torch.engine.graph import Scheduler
    from pathway_tpu_torch.observability import engine_phases

    plain_run_tick = Scheduler.run_tick

    def run_tick(self, time_):
        name = windows.get(time_)
        if name is None:
            return plain_run_tick(self, time_)
        torch.cuda.synchronize()
        engine_phases.reset()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            plain_run_tick(self, time_)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        _report(name, prof, wall_ms, engine_phases_ms=engine_phases.snapshot())

    Scheduler.run_tick = run_tick
    try:
        capture()
    finally:
        Scheduler.run_tick = plain_run_tick


def profile_document_store(files: int = 1024, file_tick: int = 128, ingest_tick: int = 4, query_tick: int = 10) -> None:
    """One ingest tick and one query tick of the DocumentStore pipeline.
    Ticks 0 .. files/file_tick - 1 each bring ``file_tick`` files; later
    ticks each bring 64 queries."""
    import os

    import numpy as np
    import torch

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.debug import _capture
    from pathway_tpu_torch.xpacks.llm import DocumentStore
    from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder
    from pathway_tpu_torch.xpacks.llm.splitters import TokenCountSplitter

    os.environ.update(PATHWAY_MICROBATCH="auto", PATHWAY_MICROBATCH_FLUSH_MS="0", PATHWAY_ENGINE_PHASES="on")
    rng = np.random.default_rng(0)
    vocab = [f"word{i}" for i in range(5000)]
    texts = [" ".join(rng.choice(vocab, size=int(rng.integers(600, 1001)))) for _ in range(files)]
    splitter = TokenCountSplitter(min_tokens=50, max_tokens=200)
    chunks = [c for t in texts for c, _m in splitter.func(t)]
    emb = SentenceTransformerEmbedder("minilm", seed=0)
    emb._encoder.encode_texts(chunks[:512])  # warm: allocator, cuBLAS
    torch.cuda.synchronize()
    pw.G.clear()
    docs = pw.debug.table_from_rows(
        pw.schema_from_types(data=bytes, _metadata=dict),
        [(t.encode(), {"path": f"/corpus/d{i % 64:02d}/f{i:05d}.txt"}, i // file_tick, 1)
         for i, t in enumerate(texts)],
        is_stream=True,
    )
    store = DocumentStore(docs, embedder=emb, splitter=splitter)
    first = -(-files // file_tick)
    picks = rng.choice(len(chunks), size=256, replace=False)
    queries = pw.debug.table_from_rows(
        DocumentStore.RetrieveQuerySchema,
        [(chunks[c], 6, None, None, first + j // 64, 1) for j, c in enumerate(picks)],
        is_stream=True,
    )
    table = store.retrieve_query(queries)
    windows = {ingest_tick: f"document_store_ingest_tick_{file_tick}_files", query_tick: "document_store_query_tick_64"}
    try:
        _profile_ticks(windows, lambda: _capture(table))
    finally:
        pw.G.clear()


def profile_rest(files: int = 1024, clients: int = 64) -> None:
    """One coalesced request tick of a DocumentStoreServer: ``clients``
    concurrent ``/v1/retrieve`` requests answered by one engine tick."""
    import http.client
    import os
    import socket
    import threading

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.engine.graph import Scheduler
    from pathway_tpu_torch.observability import engine_phases
    from pathway_tpu_torch.stdlib.indexing import tiered
    from pathway_tpu_torch.xpacks.llm import DocumentStore
    from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder
    from pathway_tpu_torch.xpacks.llm.servers import DocumentStoreServer
    from pathway_tpu_torch.xpacks.llm.splitters import TokenCountSplitter

    os.environ.update(
        PATHWAY_MICROBATCH="auto", PATHWAY_MICROBATCH_FLUSH_MS="0", PATHWAY_ENGINE_PHASES="on",
        PATHWAY_SERVE_COALESCE_MS="500", PATHWAY_SERVE_COALESCE_ROWS=str(clients),
    )
    rng = np.random.default_rng(0)
    vocab = [f"word{i}" for i in range(5000)]
    texts = [" ".join(rng.choice(vocab, size=int(rng.integers(600, 1001)))) for _ in range(files)]
    splitter = TokenCountSplitter(min_tokens=50, max_tokens=200)
    chunks = [c for t in texts for c, _m in splitter.func(t)]
    emb = SentenceTransformerEmbedder("minilm", seed=0)
    emb._encoder.encode_texts(chunks[:512])  # warm: allocator, cuBLAS
    torch.cuda.synchronize()
    pw.G.clear()
    docs = pw.debug.table_from_rows(
        pw.schema_from_types(data=bytes, _metadata=dict),
        [(t.encode(), {"path": f"/corpus/d{i % 64:02d}/f{i:05d}.txt"}) for i, t in enumerate(texts)],
    )
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    server = DocumentStoreServer("127.0.0.1", port, DocumentStore(docs, embedder=emb, splitter=splitter))
    (route,) = [st for st in server.webserver._route_states() if st.route == "/v1/retrieve"]
    picks = rng.choice(len(chunks), size=3 * clients, replace=False)
    armed = threading.Event()
    plain_run_tick = Scheduler.run_tick

    def arrived() -> int:
        """Requests waiting in the route's input (the served rows'
        retractions wait there too)."""
        node = route.node
        return 0 if node is None else sum(1 for _k, _v, diff in list(node._pending) if diff > 0)

    def run_tick(self, time_):
        if not armed.is_set() or arrived() < clients:
            return plain_run_tick(self, time_)
        armed.clear()
        rows = arrived()
        torch.cuda.synchronize()
        engine_phases.reset()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            plain_run_tick(self, time_)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        _report(f"rest_request_tick_{clients}", prof, wall_ms, requests_in_tick=rows,
                engine_phases_ms=engine_phases.snapshot())

    def round_of(queries: list[str]) -> float:
        """The clients' wall time for one concurrent round."""
        start = threading.Barrier(len(queries) + 1)
        bad: list = []

        def client(q: str) -> None:
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
            start.wait(timeout=60)
            conn.request("POST", "/v1/retrieve", body=json.dumps({"query": q, "k": 6}).encode())
            resp = conn.getresponse()
            if resp.status != 200 or not json.loads(resp.read()):
                bad.append(resp.status)
            conn.close()

        threads = [threading.Thread(target=client, args=(q,), daemon=True) for q in queries]
        for t in threads:
            t.start()
        start.wait(timeout=60)
        t0 = time.perf_counter()
        for t in threads:
            t.join(timeout=300)
        if bad:
            raise RuntimeError(f"profile_main_path rest: {len(bad)} requests failed: {bad[:4]}")
        return (time.perf_counter() - t0) * 1e3

    Scheduler.run_tick = run_tick
    # the autocommit poll past the coalesce window: only a full round of
    # arrivals (or the window) starts a query tick
    run = server.run(threaded=True, autocommit_duration_ms=2000)
    try:
        deadline = time.monotonic() + 600
        while time.monotonic() < deadline:  # the one static batch indexed
            stats = tiered.tier_stats() or {}
            if stats.get("hot_rows", 0) + stats.get("cold_rows", 0) >= len(chunks):
                break
            time.sleep(0.05)
        round_of([chunks[c] for c in picks[:clients]])  # warm: the query shapes
        wall = round_of([chunks[c] for c in picks[clients : 2 * clients]])
        print(json.dumps({"window": f"rest_request_round_{clients}_clients", "clients_wall_ms": wall}), flush=True)
        armed.set()
        round_of([chunks[c] for c in picks[2 * clients :]])
    finally:
        Scheduler.run_tick = plain_run_tick
        pw.internals.run.current_runtime().request_stop()
        run.join(timeout=120)
        pw.G.clear()


def profile_temporal(events: int = 262_144, tick: int = 65_536, traced_time: int = 6) -> None:
    """One 65,536-event tick of Q5 and of Q7 with its cutoff under the
    profiler (logical time ``traced_time``: ticks arrive at 2, 4, 6, ...)."""
    import os

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.tools import nexmark

    os.environ.update(PATHWAY_ENGINE_JAX="gpu", PATHWAY_FUSE_JAX="on", PATHWAY_ENGINE_PHASES="on")
    ev = {c: v[:events] for c, v in nexmark.generate(1_048_576, seed=0).items()}
    for query in ("q5", "q7_cutoff"):
        tables = nexmark.build(pw, query, ev, tick)
        try:
            _profile_ticks({traced_time: f"temporal_{query}_tick_{tick}"}, lambda: nexmark.capture(pw, tables))
        finally:
            pw.G.clear()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_main_path: CUDA is not available", file=sys.stderr)
        return 2
    mode = sys.argv[1] if len(sys.argv) > 1 else "ops"
    if mode not in ("ops", "pipeline", "document_store", "rest", "temporal", "all"):
        print(f"profile_main_path: unknown mode {mode!r} (ops, pipeline, document_store, rest, temporal, all)",
              file=sys.stderr)
        return 2
    if mode in ("ops", "all"):
        profile_ops()
    if mode in ("pipeline", "all"):
        profile_pipeline()
    if mode in ("document_store", "all"):
        profile_document_store()
    if mode in ("rest", "all"):
        profile_rest()
    if mode in ("temporal", "all"):
        profile_temporal()
    return 0


if __name__ == "__main__":
    sys.exit(main())
