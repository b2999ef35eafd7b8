"""Where the device time of the port's main path goes, on one CUDA card.

    python -m pathway_tpu_torch.tools.profile_main_path [ops|pipeline|all]

``ops`` (the default, and part of ``all``) traces, with ``torch.profiler``,
one ingest batch (1024 bench docs: encode → ``add_batch_device`` → flush) and
one RAG query (encode → search k=10 on an index of 8192 docs → rerank the 10
hits), calling the ops directly.

``pipeline`` traces the same loop run by the engine
(``pathway_tpu_torch/tools/rag_pipeline.py``, the pipeline of
``chip_smoke.py``'s pipeline phase) with the microbatch flush deadline at 0,
so every tick launches what it holds: 8 ticks of 512 docs, then ticks of 64
queries. It traces one engine tick of each kind, after warm ones: the
512-row ingest flush (embed → index) and the 64-row query tick (embed →
search → flatten → rerank of 640 pairs). Besides the device time by kernel,
it gives the tick's host time (wall − device time) split into the engine's
phases (``PATHWAY_ENGINE_PHASES``) and the rest (Python between launches).

Both run at the bench's widths with random seeded weights. Each window prints
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
    # the port's attention kernel: the bf16 (tensor-core) or f32 (SIMT) route
    attention_ms = sum(
        r[1] for r in rows if "attention_tc_kernel" in r[0] or "attention_short_kernel" in r[0]
    )
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
    from torch.profiler import ProfilerActivity, profile

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.debug import _capture
    from pathway_tpu_torch.engine.graph import Scheduler
    from pathway_tpu_torch.observability import engine_phases
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

    # docs in 512-row ticks (one ingest flush each), then 64-row query ticks
    pw.G.clear()
    table = rag_pipeline.build(
        pw, embedder=emb, index_factory=BruteForceKnnFactory(embedder=emb), reranker=rr,
        docs=docs, queries=docs[:256], tick_rows=512, query_tick_rows=64, k=10,
    )
    Scheduler.run_tick = run_tick
    try:
        _capture(table)
    finally:
        Scheduler.run_tick = plain_run_tick
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

    _window("ingest_batch_1024", ingest)
    _window("rag_query_rerank", query)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_main_path: CUDA is not available", file=sys.stderr)
        return 2
    mode = sys.argv[1] if len(sys.argv) > 1 else "ops"
    if mode not in ("ops", "pipeline", "all"):
        print(f"profile_main_path: unknown mode {mode!r} (ops, pipeline, all)", file=sys.stderr)
        return 2
    if mode in ("ops", "all"):
        profile_ops()
    if mode in ("pipeline", "all"):
        profile_pipeline()
    return 0


if __name__ == "__main__":
    sys.exit(main())
