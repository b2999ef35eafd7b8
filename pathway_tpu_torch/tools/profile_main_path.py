"""Where the device time of the port's main path goes, on one CUDA card.

    python -m pathway_tpu_torch.tools.profile_main_path

Traces, with ``torch.profiler``, one ingest batch (1024 bench docs: encode →
``add_batch_device`` → flush) and one RAG query (encode → search k=10 on an
index of 8192 docs → rerank the 10 hits), at the bench's widths with random
seeded weights. Prints one JSON line per window: wall time, summed kernel
time, the device's idle share (1 − device time / wall time; one stream, so
kernels do not overlap), the attention kernel's time and the top kernels by
device time. The profiler's own cost is inside the wall time.
"""

from __future__ import annotations

import json
import sys
import time


def _window(name: str, fn) -> None:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
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
        "idle_share": 1.0 - device_ms / wall_ms,
        "attention_kernel_ms": attention_ms,
        "top": [{"kernel": k[:90], "ms": ms, "calls": n} for k, ms, n in rows[:12]],
    }), flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_main_path: CUDA is not available", file=sys.stderr)
        return 2
    import numpy as np

    from pathway_tpu_torch.ops.encoder import EncoderConfig, TorchSentenceEncoder
    from pathway_tpu_torch.ops.knn import BruteForceKnnIndex
    from pathway_tpu_torch.ops.reranker import TorchCrossEncoder

    rng = np.random.default_rng(0)
    vocab = [f"word{i}" for i in range(5000)]
    docs = [" ".join(rng.choice(vocab, size=120)) for _ in range(8192)]
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
