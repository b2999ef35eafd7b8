#!/usr/bin/env python3
"""Drive the PyTorch port's live-RAG loop once on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout; needs one CUDA card and ``nvcc`` (CUDA_HOME,
PATH or the toolkit's default location), and nothing of JAX. Phases, each
printing one JSON line:

1. device: the card's name and power limit (``nvidia-smi``) and versions;
2. build: every CUDA kernel of the port built from ``pathway_tpu_torch/csrc``
   (ptxas registers, spills and shared memory per instantiation, and the
   tensor-core instructions in each route's SASS), and the native C
   tokenizer built from ``pathway_tpu_torch/native``;
3. kernels: each kernel against its plain PyTorch version on the card, both
   routes of the attention kernel (bf16, and f32 as split 3xTF32 products,
   both on the tensor cores) at nine shapes, the main path's among them,
   with its time at the main path's three shapes and at bert_path's
   batch (12 heads of 32), its plain version's time,
   one PyTorch library call's time as a yardstick, and its bound;
4. main path, at the full width of the bench's MiniLM-class encoder with
   random seeded weights: 8192 docs tokenized, embedded in batches of 1024
   and indexed; the index filled to 1,000,000 x 384 f32; 30 RAG queries
   (encode → search k=10 → rerank the hits); a 16-query search at 1M;
5. checks of the main path's answers: each doc finds itself first, search
   agrees with a float64 numpy brute force in keys and order, rerank scores
   are finite, card embeddings agree with the port's CPU path;
6. f32_path: the main path's encoder in f32 (f32 weights and activations,
   so every attention call takes the f32 route): the 8192 docs embedded in
   batches of 1024 and indexed, with its checks (the first 64 embeddings
   against the port's CPU path, each of them finding its own doc first, and
   the first 8 docs embedded in an 8-row launch bit-identical to the same
   docs in a 1,024-row launch, ``tools/batch_invariance.py``'s pre-LN f32
   entry);
7. pipeline: the same loop written against ``import pathway_tpu_torch as pw``
   and run by the engine (``pw.debug`` streams → ``SentenceTransformerEmbedder``
   through the cross-tick microbatcher → ``BruteForceKnnFactory`` index →
   ``query_as_of_now`` → flatten → ``CrossEncoderReranker``): 65,536 docs and
   then 1,024 queries in 64-row ticks, with its checks (self-retrieval, a
   direct search over the embeddings the pipeline emitted, rerank scores
   against the cross-encoder, microbatch off == auto at 4,096 docs);
8. tiered: the tiered index (bounded hot shard on the card, host IVF cold
   tier, cold candidates rescored on the card) on ``knn_bench``'s clustered
   384-d corpus: first the index-rows check of ``tools/batch_invariance.py``
   (the same scores in a brute-force index of any capacity and in the cold
   rescore); then at 262,144 rows, 4x the default hot bound of 65,536, with
   an exact cold tier, its top-10 must equal a card-resident brute-force
   index's in keys and score bits, before and after ``maintain()``; then
   its serving rates at 16, 256 and 1,024 queries a batch beside the
   brute-force index's, with a trained IVF cold tier, recall@10 and the
   tier counters; then the pipeline of phase 7 with ``TieredKnnFactory``
   (hot bound 16,384) with its checks (self-retrieval, microbatch off ==
   auto at 4,096 docs with an exact cold tier);
9. engine_kernels: the engine's filter → join → groupby/sum at 1,000,000
   rows, static and over 20 ticks, with both ``engine/torch_kernels.py``
   functions on the card (``PATHWAY_ENGINE_JAX=gpu``) and on numpy (``0``,
   fused chains on the register program), whose captured outputs must be
   identical; and the fused chain filter → select → select at 1,000,000
   rows, static and over 20 ticks, on the fused device tier on the card
   (``PATHWAY_FUSE_JAX=on``) against the register program (``off``), bit
   for bit, all with the audit plane off; then that chain over 20 ticks on
   the device tier under ``PATHWAY_AUDIT=full`` (sample 1.0: no block on the
   card) and at the default ``on`` (the audit-sampled ticks' blocks stay on
   the host, the others take the card), each stream identical to the
   audit-off one and no violation;
   audit_fault: ``PATHWAY_FAULT_PLAN=flip_diff:proc=0,tick=2`` on the docs
   edge of a small tiered index whose hot shard is on the card: the audit
   plane catches it at that edge and tick, one flight dump names the
   operator, key and tick, and the index keeps answering from the card;
10. temporal: the temporal Table API on a Nexmark-shaped stream
   (``tools/nexmark.py``: Beam's generator defaults, 2% of the bids 1-8 s
   late): Q5 (sliding hot items), Q7 (tumbling highest bid, without a
   behavior and with ``common_behavior(cutoff=5 s)``) and Q8 (window join
   of persons and the auctions they sell) over TEMPORAL_EVENTS events,
   static and in ticks of 65,536, each with the engine's device functions
   on the card (``PATHWAY_ENGINE_JAX=gpu``, ``PATHWAY_FUSE_JAX=on``) and on
   numpy, the runs spread over worker processes with the audit plane off
   (an audited tick keeps its fused chains on the host); then asof and interval
   joins, sort/diff and deduplicate on the first 65,536 events. Gates:
   card == numpy update streams, ``grouped`` and ``fused`` routes on the
   card and none on numpy, the static answers and the cutoff's dropped late
   bids equal a numpy model, ticks == static without a behavior;
11. bert_path: a BERT checkpoint at all-MiniLM-L6-v2's published widths
   (vocab 30,522, hidden 384, 6 layers, 12 heads of 32, random f32 weights
   from seed 0, a synthetic vocab.txt), written as pytorch_model.bin and
   model.safetensors (equal parameters), loaded by ``from_pretrained`` on
   the card; 8,192 WordPiece docs embedded in f32 in batches of 1,024 (every
   attention call on the f32 route at hd 32) and indexed, with its checks
   (64 embeddings against the CPU path, 8,192/8,192 self-hits, the bert
   entry of ``tools/batch_invariance.py``);
12. document_store: 8,192 UTF-8 files in 64 directories read by
   ``pw.io.fs`` into ``DocumentStore`` (``minilm`` embedder,
   ``TokenCountSplitter(50, 200)``, the default ``TieredKnnFactory``); 1,024
   ``retrieve_query`` rows in 64-row ticks (256 filtered to a directory),
   ``statistics_query``, ``inputs_query`` and 256 prompts through
   ``BaseRAGQuestionAnswerer``, with its checks (self-hits, filtered hits
   inside their glob, 8,192 files counted, each prompt holding its k texts
   in order); a 1,024-file streaming read whose answers equal a static
   read's; 64 files each of PDF, DOCX, HTML and Markdown through their
   parsers, each marker phrase retrieved first;
13. rest_serving: phase 12's files served over HTTP by ``QARestServer``
   (``pw.io.http`` on the port's own HTTP/1.1 server) over the same
   ``DocumentStore`` and ``BaseRAGQuestionAnswerer``, at the port's
   defaults (the device, audit, request-trace, health and timeline planes
   on) with the monitoring server on a port of its own: ingest until ``/v1/statistics``
   counts every file and both index nodes hold every chunk; phase 12's
   1,024 retrieve payloads as JSON POSTs from 1 and from 32 concurrent
   keep-alive clients, each answer equal to phase 12's in-process answer
   (texts, metadata, score bits); 256 ``/v2/answer`` prompts holding their
   texts in order; ``/v1/inputs``, ``/v2/list_documents``, ``/_schema``,
   ``/healthz``, ``/readyz``; the planes' gates (a unique
   ``X-Pathway-Request-Id`` on every answer, each kept id's flight path on
   ``/request?id=``, canaries outside the route counters, ``/readyz`` 503
   while draining, the hot shard's bytes on ``/metrics``, the CUDA
   allocator, per leg traced encoder calls == launches and attention
   launches == 6 x calls and tokens == buckets x lengths, a
   ``/profile?ticks=4`` window naming the kernel; no audit violation or
   shadow divergence, ``/status`` with its audit, timeline and bottleneck
   sections, the fs input edge's and each index's docs edge's rows on
   ``/metrics`` equal to the files and the chunks, ``/explain`` walking a
   retrieve answer back to its hits' source files through parse, split,
   index and join, ``/timeline`` with the retrieve route's rate inside the
   32-client leg); a shed leg (in-flight
   budget 8, 64 concurrent requests: 200s + 429s = 64 and the route's
   counters agree) and a lifecycle leg (requests pending at ``stop()``
   answered 503, a restart on the same port); a text embedded with the same
   bits in launches padded to 64, 128, 256 and 512 tokens;
14. observability: the 32-client retrieve leg again over three fresh servers
   on the same files, one with every plane off, one with the audit and
   timeline planes off and the others at their defaults, and one with
   ``PATHWAY_PROFILE=full`` (the encoder's device-wait split above 0 and
   below the leg's wall), requests/s and p50/p99 beside phase 13's;
15. the kernels line, with each kernel's launches during phases 4, 6, 7,
   8's pipeline, 10, 11, 12, 13 and 14.

The last line is ``{"ok": true, "device": {...}}``. Any failure exits non-zero
without it. TF32 is off for every matmul (``allow_tf32 = False``), so the f32
KNN scores and f32 checks are true f32.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np

N_DOCS = 8192
DOC_WORDS = 120
INGEST_BATCH = 1024
INDEX_ROWS = 1_000_000
FILL_CHUNK = 8192
N_QUERIES = 30
#: the pipeline phase: docs and queries in ticks of streaming_bench's size
PIPE_DOCS = 65_536
PIPE_QUERIES = 1024
PIPE_TICK = 64
PIPE_K = 10
PIPE_SAME_DOCS = 4096  # microbatch off == auto at this size
#: the engine_kernels phase: engine_bench's pipeline
ENGINE_ROWS = 1_000_000
ENGINE_TICKS = 20
#: the tiered phase: knn_bench's corpus at 4x the default hot bound
#: (``PATHWAY_INDEX_HOT_ROWS``, internals/config.py), its query batches, and
#: the pipeline at 4x a 16,384-row hot bound
TIER_CORPUS = 262_144
TIER_HOT = 65_536
TIER_QUERIES = 64
TIER_Q_BATCHES = (16, 256, 1024)
TIER_PIPE_HOT = 16_384
TIER_SAME_HOT = 1024  # microbatch off == auto: PIPE_SAME_DOCS docs, 4x this bound
INVARIANCE_CAPACITIES = (4096, 65_536, 1 << 20)
#: the temporal phase: a Nexmark-shaped stream (``tools/nexmark.py``) in
#: ticks of TEMPORAL_TICK events, the queries, and the rest of the temporal
#: surface on the first TEMPORAL_SURFACE_EVENTS events
TEMPORAL_EVENTS_GENERATED = 1_048_576  # the stream; the runs read its first TEMPORAL_EVENTS
TEMPORAL_EVENTS = 262_144  # 4 ticks; cut from 524,288 to keep the whole script near 850 s (PERF.md section 4)
TEMPORAL_TICK = 65_536
TEMPORAL_SURFACE_EVENTS = 65_536
TEMPORAL_QUERIES = ("q5", "q7", "q7_cutoff", "q8")
TEMPORAL_WORKERS = 6  # processes running the phase's 18 runs, longest first
#: the bert_path phase: all-MiniLM-L6-v2's published widths, random weights
BERT_DOCS = 8192
BERT_BATCH = 1024
#: the document_store phase: a file corpus read by pw.io.fs into DocumentStore
DS_FILES = 8192
DS_SUBDIRS = 64
DS_WORDS = (600, 1000)
DS_QUERIES = 1024
DS_GLOB_QUERIES = 256
DS_QA = 256
DS_TICK = 64
DS_K = 6
DS_STREAM_FILES = 1024
DS_STREAM_QUERIES = 128
DS_FORMAT_FILES = 64  # of each of PDF, DOCX, HTML and Markdown
#: the rest_serving phase: document_store's corpus and queries over HTTP
RS_CLIENTS = 32
RS_SHED_INFLIGHT = 8
RS_SHED_REQUESTS = 64
RS_SHED_SLEEP_S = 0.05  # host seconds per answered row of the shed route
RS_PENDING = 8
#: scratch files of the two phases (``build/`` is not committed)
SCRATCH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke")
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM
H100_BF16_FLOPS = 989e12  # dense tensor-core bf16
H100_F32_FLOPS = 67e12  # FP32 pipes, outside the tensor cores
H100_TF32_FLOPS = 495e12  # dense tensor-core TF32

#: where every phase runs (a CPU rehearsal at a small size sets "cpu")
DEVICE = "cuda"

failures: list[str] = []


def sync() -> None:
    import torch

    if DEVICE == "cuda":
        torch.cuda.synchronize()


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(ok: bool, what: str) -> bool:
    if not ok:
        failures.append(what)
        print(f"CHECK FAILED: {what}", file=sys.stderr, flush=True)
    return ok


def synth_docs(n: int, words: int = DOC_WORDS) -> list[str]:
    """The bench's corpus: ``n`` docs of ``words`` words from a 5000-word vocab."""
    rng = np.random.default_rng(0)
    vocab = [f"word{i}" for i in range(5000)]
    return [" ".join(rng.choice(vocab, size=words)) for _ in range(n)]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device() -> dict:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else None
    print(card if card else "nvidia-smi: not available", flush=True)
    info = {
        "nvidia_smi": card,
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "python": sys.version.split()[0],
    }
    emit("device", **info)
    return info


def _demangle(names: list[str], tool_dir: str) -> dict[str, str]:
    """Mangled kernel name -> readable C++ signature (``cu++filt``)."""
    tool = os.path.join(tool_dir, "cu++filt")
    if not names or not os.path.exists(tool):
        return {n: n for n in names}
    res = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True, timeout=60)
    out = res.stdout.splitlines() if res.returncode == 0 else []
    return dict(zip(names, out)) if len(out) == len(names) else {n: n for n in names}


def _ptxas_per_function(log: str) -> dict[str, str]:
    """ptxas -v output -> one line per kernel instantiation: registers,
    spills, shared memory."""
    per, name = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
            per[name] = ""
        elif name and ("spill" in ln or "registers" in ln):
            per[name] = (per[name] + "; " + ln.split(":", 1)[-1].strip()).strip("; ")
    return per


def _sass_tensor_ops(lib: str, tool_dir: str) -> dict[str, int]:
    """HMMA / HGMMA instructions per kernel function in the library's SASS."""
    res = subprocess.run(
        [os.path.join(tool_dir, "cuobjdump"), "-sass", lib], capture_output=True, text=True, timeout=300
    )
    if res.returncode != 0:
        raise RuntimeError(f"cuobjdump -sass failed: {res.stderr.strip()[-500:]}")
    per, name = {}, None
    for ln in res.stdout.splitlines():
        if "Function : " in ln:
            name = ln.split("Function : ", 1)[1].strip()
            per[name] = 0
        elif name and ("HMMA" in ln or "HGMMA" in ln):
            per[name] += 1
    return per


def phase_build() -> None:
    import torch

    from pathway_tpu_torch import native
    from pathway_tpu_torch.ops import _build
    from pathway_tpu_torch.ops import attention_kernel as A

    t0 = time.perf_counter()
    per_kernel = _build.build()
    build_s = time.perf_counter() - t0
    tool_dir = os.path.dirname(_build.find_nvcc())
    ptxas, sass = {}, {}
    for name in _build.SOURCES:
        # ptxas speaks only when this run compiled the kernel; the SASS is read
        # from the library either way
        per_fn = _ptxas_per_function(_build.build_logs.get(name, ""))
        hmma = _sass_tensor_ops(str(_build.library_path(name)), tool_dir)
        nice = _demangle(sorted(set(per_fn) | set(hmma)), tool_dir)
        ptxas[name] = {nice[f]: v for f, v in per_fn.items()}
        sass[name] = {nice[f]: n for f, n in hmma.items()}
    # each route's instantiations (3 head widths x resident / streamed) must
    # run on the tensor cores
    tc = {f: n for f, n in sass.get("attention_short", {}).items() if "attention_tc_kernel" in f}
    for dname, tname in (("bf16", "__nv_bfloat16"), ("f32", "float")):
        mine = {f: n for f, n in tc.items() if f"attention_tc_kernel<{tname}," in f}
        check(len(mine) == 6, f"{dname} route: {len(mine)} tensor-core instantiations in the SASS, expected 6")
        check(all(n > 0 for n in mine.values()), f"{dname} route without HMMA/HGMMA in its SASS: {mine}")

    # the host C tokenizer, built here so that no timed call pays its compile
    t1 = time.perf_counter()
    tok = native.try_load("pwtok")
    tok_s = time.perf_counter() - t1
    cc = native.compiler()
    check(tok is not None or cc is None, f"C compiler {cc} present but the native tokenizer did not load: "
          f"{native.last_error.get('pwtok')}")

    # the kernels' shared memory is dynamic (ptxas cannot report it): per
    # checked case, what the launch asks for
    smem = {
        f"{str(dt).replace('torch.', '')} {case}": A.launch_geometry(B, L, 384 // hd, hd, dt).smem_bytes
        for dt in (torch.bfloat16, torch.float32) for case, (B, L, hd) in KERNEL_SHAPES.items()
    }
    emit(
        "build", seconds=build_s, per_kernel_s=per_kernel, ptxas=ptxas,
        sass_tensor_ops=sass, dynamic_smem_bytes=smem,
        tokenizer="native" if tok is not None else "python",
        tokenizer_build_s=native.build_seconds.get("pwtok"), tokenizer_load_s=tok_s,
        tokenizer_error=native.last_error.get("pwtok"), c_compiler=cc,
    )


def _attention_inputs(B, L, dtype, gen, H=6, hd=64):
    """q/k/v as the strided split of one [B, L, 3D] projection (the encoder's
    layout), a key mask with padded tails and row 0 fully masked."""
    import torch

    D = H * hd
    qkv = torch.randn(B, L, 3 * D, device="cuda", generator=gen).to(dtype)
    q, k, v = qkv.split(D, dim=-1)
    lens = torch.randint(1, L + 1, (B,), device="cuda", generator=gen)
    mask = torch.arange(L, device="cuda")[None, :] < lens[:, None]
    mask[0] = False
    return q, k, v, mask


#: (B, L, hd) of each checked case: the main path's three shapes (the
#: rerank case at the reranker's longest input), then the longest length, a
#: length that fills no tile evenly, the other head widths the kernel is
#: built for (hd 128 both with K and V resident and streamed), and the
#: bert_path's ingest batch (12 heads of 32)
KERNEL_SHAPES = {
    "embed": (1024, 128, 64), "query": (1, 16, 64), "rerank": (10, 256, 64),
    "max_len": (4, 512, 64), "ragged": (3, 77, 64), "hd32": (2, 128, 32), "hd128": (2, 256, 128),
    "hd128_resident": (2, 128, 128), "bert_embed": (1024, 128, 32),
}
#: the timed cases per dtype: both routes at the main path's shapes and at
#: bert_path's batch
TIMED = {"bfloat16": ("embed", "query", "rerank", "bert_embed"), "float32": ("embed", "query", "rerank", "bert_embed")}


def phase_kernels() -> list[dict]:
    """attention_short_flat against attention_short_flat_plain on the card,
    both routes at every shape of KERNEL_SHAPES; returns every case's record.
    f32 at rtol = atol = 1e-5; bf16 at |err| <= 2^-7 (|ref| + max|v|): one
    bf16 ulp of the output plus one ulp of every prob that rounds the other
    way (Σ p·|v| ≤ max|v|)."""
    import torch
    import torch.nn.functional as F

    from pathway_tpu_torch.ops import attention_kernel as A

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    D = 384
    records = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        for label, (B, L, hd) in KERNEL_SHAPES.items():
            H, scale = D // hd, hd ** -0.5
            q, k, v, mask = _attention_inputs(B, L, dtype, gen, H, hd)
            geo = A.launch_geometry(B, L, H, hd, dtype)
            out = A.attention_short_flat(q, k, v, mask, H, scale)
            torch.cuda.synchronize()
            ref = A.attention_short_flat_plain(q, k, v, mask, H, scale)
            err = (out.float() - ref.float()).abs()
            mean_v = v[0].float().mean(dim=0, keepdim=True)
            err_masked = (out[0].float() - mean_v).abs().max().item()
            if dtype == torch.float32:
                ok = bool(torch.allclose(out, ref, rtol=1e-5, atol=1e-5))
                ok_masked = err_masked <= 1e-5 + 1e-5 * mean_v.abs().max().item()
                tol = "rtol=atol=1e-5"
            else:
                bound = 2.0 ** -7 * (ref.float().abs() + v.float().abs().max())
                ok = bool((err <= bound).all())
                ok_masked = err_masked <= 2.0 ** -7 * (mean_v.abs().max().item() + v[0].float().abs().max().item())
                tol = "2^-7*(|ref|+max|v|)"
            check(ok and ok_masked, f"attention {label} {dname}: kernel disagrees with plain")
            rec = {
                "case": label, "dtype": dname, "route": geo.route, "B": B, "L": L, "hd": hd,
                "rows_per_block": geo.rows, "resident": geo.resident, "smem_bytes": geo.smem_bytes,
                "max_abs_err": err.max().item(), "masked_row_vs_mean_v": err_masked,
                "tolerance": tol, "ok": ok and ok_masked,
            }
            if label in TIMED[dname]:
                iters = 20 if label == "embed" else 200
                rec["ms"] = cuda_ms(lambda: A.attention_short_flat(q, k, v, mask, H, scale), iters)
                rec["plain_ms"] = cuda_ms(lambda: A.attention_short_flat_plain(q, k, v, mask, H, scale), iters)
                qh, kh, vh = (t.view(B, L, H, hd).transpose(1, 2) for t in (q, k, v))
                bias = torch.zeros(B, 1, 1, L, device="cuda", dtype=dtype).masked_fill(
                    ~mask[:, None, None, :], -1e30
                )
                rec["library_ms"] = cuda_ms(
                    lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=bias, scale=scale), iters
                )
                es = q.element_size()
                nbytes = 4 * B * L * D * es + B * L  # q, k, v read, ctx written, mask read
                flops = 4 * B * L * L * D
                t_bytes = nbytes / H100_BYTES_PER_S * 1e3
                if dtype == torch.bfloat16:
                    t_ops = flops / H100_BF16_FLOPS * 1e3
                else:
                    # f32-accurate products on the tensor cores: three TF32
                    # products each; beside it, the same work on the FP32 pipes
                    t_ops = 3 * flops / H100_TF32_FLOPS * 1e3
                    rec["bound_fp32_pipes_ms"] = max(t_bytes, flops / H100_F32_FLOPS * 1e3)
                rec["bound_ms"] = max(t_bytes, t_ops)
                rec["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
            records.append(rec)
            emit("kernel_check", kernel="attention_short_flat", **rec)
            del q, k, v, mask, out, ref, err
    torch.cuda.empty_cache()
    return records


def phase_main_path(docs: list[str]) -> dict:
    import torch

    from pathway_tpu_torch import native
    from pathway_tpu_torch.ops import attention_kernel as A
    from pathway_tpu_torch.ops import encoder as E
    from pathway_tpu_torch.ops.encoder import EncoderConfig, TorchSentenceEncoder, encoder_flops_per_doc
    from pathway_tpu_torch.ops.knn import BruteForceKnnIndex
    from pathway_tpu_torch.ops.reranker import TorchCrossEncoder

    cfg = EncoderConfig(vocab_size=32768, d_model=384, n_heads=6, n_layers=6, d_ff=1536, max_len=128)
    rr_cfg = EncoderConfig(vocab_size=32768, d_model=384, n_heads=6, n_layers=4, d_ff=1536, max_len=256)
    enc = TorchSentenceEncoder(cfg, seed=0, param_dtype=torch.bfloat16, device=DEVICE)
    ce = TorchCrossEncoder(rr_cfg, seed=1, device=DEVICE)

    tokenizer = "native" if E._native_pwtok() is not None else "python"
    t0 = time.perf_counter()
    ids_all, _ = enc.tokenizer(docs)
    tok_s = time.perf_counter() - t0
    L = ids_all.shape[1]
    check(L == 128, f"corpus tokenized to L={L}, expected 128")

    calls = {"encode": 0, "rerank": 0}

    def ingest(index, ids):
        for i in range(0, len(ids), INGEST_BATCH):
            embs = enc.encode_ids_device(ids[i : i + INGEST_BATCH])
            calls["encode"] += 1
            index.add_batch_device(range(i, i + int(embs.shape[0])), embs)
            index._flush()
        index.search(embs[:64], k=10)  # one fetch syncs the whole pipeline

    q_text = "what is word42 about"
    qids, _ = enc.tokenizer([q_text])

    def text_of(key):
        return docs[key] if key < len(docs) else f"vector {key}"

    def rag_query(index):
        t0 = time.perf_counter()
        emb = enc.encode_ids_device(qids)
        calls["encode"] += 1
        hits = index.search(emb, k=10)[0]
        _context = "\n".join(text_of(int(k))[:200] for k, _ in hits)
        t1 = time.perf_counter()
        scores = ce.score_pairs([(q_text, text_of(int(k))[:800]) for k, _ in hits])
        calls["rerank"] += 1
        best = hits[int(np.argmax(scores))]
        return (t1 - t0) * 1e3, (time.perf_counter() - t0) * 1e3, hits, scores, best

    # warm-up: every shape the timed loop runs (allocator, cuBLAS, kernel build)
    warm = BruteForceKnnIndex(dimension=cfg.d_model, capacity=8192, device=DEVICE)
    ingest(warm, ids_all[: 2 * INGEST_BATCH])
    rag_query(warm)
    sync()

    # --- the main path: counts from 0 ---------------------------------------
    A.LAUNCHES = 0
    A.ROUTE_LAUNCHES.update(dict.fromkeys(A.ROUTE_LAUNCHES, 0))
    calls.update(encode=0, rerank=0)
    rates = []
    for _ in range(3):
        index = BruteForceKnnIndex(dimension=cfg.d_model, capacity=8192, device=DEVICE)
        t0 = time.perf_counter()
        ingest(index, ids_all)
        rates.append(len(docs) / (time.perf_counter() - t0))
    docs_per_s = statistics.median(rates)

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    filled = 0
    for start in range(N_DOCS, INDEX_ROWS, FILL_CHUNK):
        n = min(FILL_CHUNK, INDEX_ROWS - start)
        block = torch.randn(n, cfg.d_model, device=DEVICE, generator=gen)
        block = block / block.norm(dim=-1, keepdim=True)
        index.add_batch_device(range(start, start + n), block)
        index._flush()
        filled += n
    sync()
    fill_s = time.perf_counter() - t0
    check(len(index) == INDEX_ROWS, f"index holds {len(index)} rows, expected {INDEX_ROWS}")

    lat, lat_rr, all_scores, rr_L = [], [], [], ce.pair_ids([(q_text, docs[0][:800])])[0].shape[1]
    for _ in range(N_QUERIES):
        t_search, t_total, hits, scores, _best = rag_query(index)
        lat.append(t_search)
        lat_rr.append(t_total)
        all_scores.append(scores)

    q16 = torch.randn(16, cfg.d_model, device=DEVICE, generator=gen)
    q16 = q16 / q16.norm(dim=-1, keepdim=True)
    index.search(q16, k=10)
    lat16 = []
    for _ in range(20):
        t0 = time.perf_counter()
        index.search(q16, k=10)
        lat16.append((time.perf_counter() - t0) * 1e3)
    sync()
    launches, route_launches = A.LAUNCHES, dict(A.ROUTE_LAUNCHES)  # read right after the main path
    # --------------------------------------------------------------------------

    expected = cfg.n_layers * calls["encode"] + rr_cfg.n_layers * calls["rerank"]
    check(launches >= cfg.n_layers * calls["encode"], "attention launches < n_layers x encoder launches")
    check(launches == expected, f"attention launches {launches} != expected {expected}")
    check(route_launches["tensor_core"] == expected, f"bf16 tensor-core launches {route_launches} != {expected}")
    flops_per_doc = encoder_flops_per_doc(cfg, L)
    out = {
        "tokenizer": tokenizer,
        "tokenizer_error": native.last_error.get("pwtok"),
        "tokenize_docs_per_s": len(docs) / tok_s,
        "seq_len": int(L),
        "embed_index_docs_per_s": docs_per_s,
        "embed_index_runs_docs_per_s": rates,
        "encoder_tflops": docs_per_s * flops_per_doc / 1e12,
        "index_fill_rows_per_s": filled / fill_s,
        "index_rows": len(index),
        "index_device_bytes": index.device_bytes(),
        "rag_query_p50_ms": statistics.median(lat),
        "rag_query_rerank_p50_ms": statistics.median(lat_rr),
        "rerank_seq_len": int(rr_L),
        "knn1m_query16_p50_ms": statistics.median(lat16),
        "encoder_launches": calls["encode"],
        "reranker_launches": calls["rerank"],
        "attention_launches": launches,
        "attention_launches_by_route": route_launches,
        "attention_launches_expected": expected,
    }
    emit("main_path", **out)
    return {
        "enc": enc, "ce": ce, "index": index, "ids_all": ids_all, "scores": all_scores,
        "q16": q16, "launches": route_launches, "cfg": cfg, "metrics": out,
    }


def phase_checks(state: dict) -> None:
    import torch

    from pathway_tpu_torch.internals.keys import tie_order
    from pathway_tpu_torch.ops.encoder import TorchSentenceEncoder

    enc, index, ids_all = state["enc"], state["index"], state["ids_all"]

    # 1. each of 16 docs, used as its own query, comes back at rank 1
    embs = enc.encode_ids_device(ids_all[:16])
    self_hits = [h[0][0] if h else None for h in index.search(embs, k=10)]
    check(self_hits == list(range(16)), f"self-retrieval: got {self_hits}")

    # 2. 16 random queries against a float64 numpy brute force, canonical order
    q = state["q16"]
    got = [[k for k, _ in hits] for hits in index.search(q, k=10)]
    valid = index._valid.cpu().numpy()
    slots = np.nonzero(valid)[0]
    vecs = index._vectors[torch.from_numpy(slots).to(index._vectors.device)].cpu().numpy().astype(np.float64)
    keys = np.array([index._slot_to_key[int(s)] for s in slots])
    qn = q.cpu().numpy().astype(np.float64)
    scores = (qn @ vecs.T) / np.maximum(
        np.linalg.norm(qn, axis=1)[:, None] * np.linalg.norm(vecs, axis=1)[None, :], 1e-30
    )
    want = []
    for row in scores:
        cand = np.argpartition(-row, 40)[:40]
        order = sorted(cand, key=lambda i: (-row[i], tie_order(int(keys[i]))))
        want.append([int(keys[i]) for i in order[:10]])
    check(got == want, "1M search disagrees with the float64 brute force")

    # 3. rerank scores are finite
    check(all(np.isfinite(s).all() and len(s) == 10 for s in state["scores"]), "rerank scores not finite")

    # 4. card embeddings agree with the port's CPU path (same seeded weights)
    cpu = TorchSentenceEncoder(state["cfg"], seed=0, param_dtype=torch.bfloat16, device="cpu")
    e_cpu = cpu.encode_ids_device(ids_all[:8]).numpy()
    e_gpu = enc.encode_ids_device(ids_all[:8]).cpu().numpy()
    emb_err = float(np.abs(e_cpu - e_gpu).max())
    check(emb_err <= 1e-2, f"card vs CPU embeddings differ by {emb_err}")
    check(bool(np.isfinite(e_gpu).all()) and e_gpu.shape == (8, 384), "embeddings not finite / wrong shape")
    emit(
        "checks",
        self_retrieval_ok=self_hits == list(range(16)),
        brute_force_f64_ok=got == want,
        rerank_finite=all(np.isfinite(s).all() for s in state["scores"]),
        card_vs_cpu_embedding_max_abs_err=emb_err,
        tolerance_embedding=1e-2,
    )


def phase_f32_path(state: dict, info: dict) -> dict:
    """The main path's ingest with the encoder in f32: f32 weights and
    activations, so all of its attention takes the f32 (3xTF32) route. Its
    own index, the main path's tokenized docs, batches of INGEST_BATCH,
    median of 3 runs; checks against the port's CPU path and by
    self-retrieval."""
    import torch

    from pathway_tpu_torch.ops import attention_kernel as A
    from pathway_tpu_torch.ops.encoder import TorchSentenceEncoder
    from pathway_tpu_torch.ops.knn import BruteForceKnnIndex

    cfg = state["cfg"]._replace(dtype=torch.float32)
    enc = TorchSentenceEncoder(cfg, seed=0, device=DEVICE)
    ids_all = state["ids_all"]
    batches = -(-len(ids_all) // INGEST_BATCH)

    def ingest(index):
        for i in range(0, len(ids_all), INGEST_BATCH):
            embs = enc.encode_ids_device(ids_all[i : i + INGEST_BATCH])
            index.add_batch_device(range(i, i + int(embs.shape[0])), embs)
            index._flush()
        index.search(embs[:64], k=10)  # one fetch syncs the whole pipeline

    # warm-up at the batch shape (allocator, cuBLAS's f32 kernels)
    warm = BruteForceKnnIndex(dimension=cfg.d_model, capacity=2 * INGEST_BATCH, device=DEVICE)
    for i in range(0, 2 * INGEST_BATCH, INGEST_BATCH):
        warm.add_batch_device(range(i, i + INGEST_BATCH), enc.encode_ids_device(ids_all[i : i + INGEST_BATCH]))
    warm._flush()
    del warm
    sync()

    # --- the f32 path: counts from 0 ------------------------------------------
    A.LAUNCHES = 0
    A.ROUTE_LAUNCHES.update(dict.fromkeys(A.ROUTE_LAUNCHES, 0))
    rates = []
    for _ in range(3):
        index = BruteForceKnnIndex(dimension=cfg.d_model, capacity=8192, device=DEVICE)
        t0 = time.perf_counter()
        ingest(index)
        rates.append(len(ids_all) / (time.perf_counter() - t0))
    launches, route_launches = A.LAUNCHES, dict(A.ROUTE_LAUNCHES)  # read right after the path
    # --------------------------------------------------------------------------

    expected = 3 * batches * cfg.n_layers
    check(route_launches["tensor_core_3xtf32"] == expected,
          f"f32 path: f32-route launches {route_launches} != {expected} ({cfg.n_layers} per batch)")
    check(launches == expected, f"f32 path: attention launches {launches} != {expected}")

    # checks: the first 64 embeddings against the CPU path (same seeded
    # weights, the plain attention); f32 GEMMs and the kernel's split
    # products sum in other orders than the CPU's, ~1e-6 in a unit vector
    # after 6 layers, so 1e-4 holds with room
    e_dev = enc.encode_ids_device(ids_all[:64])
    e_gpu = e_dev.cpu().numpy()
    cpu = TorchSentenceEncoder(cfg, seed=0, device="cpu")
    e_cpu = cpu.encode_ids_device(ids_all[:64]).numpy()
    emb_err = float(np.abs(e_cpu - e_gpu).max())
    check(bool(np.isfinite(e_gpu).all()) and e_gpu.shape == (64, cfg.d_model), "f32 embeddings not finite / wrong shape")
    check(emb_err <= 1e-4, f"f32 path: card vs CPU embeddings differ by {emb_err}")
    self_hits = [h[0][0] if h else None for h in index.search(e_dev, k=10)]
    self_ok = sum(1 for i, key in enumerate(self_hits) if key == i)
    check(self_ok == 64, f"f32 path: self-retrieval at rank 1 {self_ok}/64")
    from pathway_tpu_torch.tools.batch_invariance import preln_f32_check

    invariance = preln_f32_check(enc, synth_docs(INGEST_BATCH))
    check(invariance[f"preln_f32_embed_8_rows_vs_{INGEST_BATCH}"][0],
          f"f32 path: a doc in an 8-row launch differs from the {INGEST_BATCH}-row launch ({invariance})")
    out = {
        "card": info["nvidia_smi"],
        "dtype": "float32",
        "docs": len(ids_all),
        "seq_len": int(ids_all.shape[1]),
        "f32_embed_index_docs_per_s": statistics.median(rates),
        "f32_embed_index_runs_docs_per_s": rates,
        "encoder_launches": 3 * batches,
        "attention_launches": launches,
        "attention_launches_by_route": route_launches,
        "attention_launches_expected": expected,
        "card_vs_cpu_embedding_max_abs_err": emb_err,
        "tolerance_embedding": 1e-4,
        "self_retrieval_rank1": self_ok,
        "batch_invariance": invariance,
    }
    emit("f32_path", **out)
    del enc, cpu, index
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    return {"launches": route_launches, "metrics": out}


class _LaunchLog:
    """Wraps a batched UDF's batch function before a pipeline is built from
    it: per launch, its host clock span and its row count (the bucket the
    microbatcher padded to), optionally its texts, and for an embedder every
    vector it returned, by text. The launch returns numpy, so its span includes the card's
    work."""

    def __init__(self, udf, keep_vectors: bool = False, keep_texts: bool = False):
        self.spans: list[tuple[float, float, int]] = []
        self.vectors: dict[str, list] = {}
        self.texts: list[list[str]] = []
        inner = udf._fn

        def launch(*cols):
            t0 = time.perf_counter()
            out = inner(*cols)
            self.spans.append((t0, time.perf_counter(), len(cols[0])))
            if keep_texts:
                self.texts.append(list(cols[0]))
            if keep_vectors:
                for text, vec in zip(cols[0], out):
                    self.vectors.setdefault(text, []).append(vec)
            return out

        udf._fn = launch


def _buckets(spans) -> dict[str, int]:
    """Launch row count -> number of launches."""
    out: dict[str, int] = {}
    for _a, _b, n in spans:
        out[str(n)] = out.get(str(n), 0) + 1
    return out


def _run_pipeline(emb, rr, docs: list[str], queries: list[str], mode: str, factory=None):
    """One capture of the pipeline under ``PATHWAY_MICROBATCH=mode`` with the
    index ``factory`` builds (default: brute force on the card); returns
    (rows, run start, run end) on the host clock."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.debug import _capture
    from pathway_tpu_torch.stdlib.indexing import BruteForceKnnFactory
    from pathway_tpu_torch.tools import rag_pipeline

    os.environ["PATHWAY_MICROBATCH"] = mode
    pw.G.clear()
    table = rag_pipeline.build(
        pw, embedder=emb, index_factory=factory or BruteForceKnnFactory(embedder=emb, device=DEVICE),
        reranker=rr, docs=docs, queries=queries, tick_rows=PIPE_TICK, k=PIPE_K,
    )
    t0 = time.perf_counter()
    rows = _capture(table).rows
    sync()
    t1 = time.perf_counter()
    pw.G.clear()
    return rows, t0, t1


def phase_pipeline(info: dict) -> dict:
    """The live-RAG loop through ``pw.run`` at full width; see the module
    docstring. The microbatch flush deadline is set past the run, so every
    launch is a full 512-row bucket until the streams close: the launch
    compositions, and with them the bits, are the same in every run."""
    import torch

    from pathway_tpu_torch.internals.keys import sequential_keys
    from pathway_tpu_torch.ops import attention_kernel as A
    from pathway_tpu_torch.ops.encoder import EncoderConfig
    from pathway_tpu_torch.stdlib.indexing._engine import VectorBackend
    from pathway_tpu_torch.tools.rag_pipeline import hits_by_query
    from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder
    from pathway_tpu_torch.xpacks.llm.rerankers import CrossEncoderReranker

    saved = {k: os.environ.get(k) for k in ("PATHWAY_MICROBATCH", "PATHWAY_MICROBATCH_FLUSH_MS")}
    os.environ["PATHWAY_MICROBATCH_FLUSH_MS"] = "3600000"
    emb = SentenceTransformerEmbedder("minilm", seed=0, device=DEVICE)
    rr_cfg = EncoderConfig(vocab_size=32768, d_model=384, n_heads=6, n_layers=4, d_ff=1536, max_len=256)
    rr = CrossEncoderReranker(rr_cfg, seed=1, device=DEVICE)
    elog, rlog = _LaunchLog(emb, keep_vectors=True), _LaunchLog(rr)
    docs = synth_docs(PIPE_DOCS)
    queries = docs[:PIPE_QUERIES]

    # warm-up at the launch shapes (allocator, cuBLAS), outside the counts
    emb._encoder.encode_texts(docs[:512])
    rr._model.score_pairs([(q, d) for q, d in zip(queries[:512], docs[1:513])])
    sync()

    # --- the pipeline: counts from 0 -------------------------------------------
    A.LAUNCHES = 0
    A.ROUTE_LAUNCHES.update(dict.fromkeys(A.ROUTE_LAUNCHES, 0))
    rows, t0, t1 = _run_pipeline(emb, rr, docs, queries, "auto")
    launches, route_launches = A.LAUNCHES, dict(A.ROUTE_LAUNCHES)
    # ------------------------------------------------------------------------------
    e_spans, r_spans = list(elog.spans), list(rlog.spans)
    seen = 0
    t_ingest = None
    for _a, b, n in e_spans:
        seen += n
        if seen >= PIPE_DOCS:
            t_ingest = b
            break
    check(t_ingest is not None, "the pipeline embedded fewer docs than it was given")
    t_ingest = t_ingest if t_ingest is not None else t1
    doc_launches = [sp for sp in e_spans if sp[1] <= t_ingest]
    query_launches = [sp for sp in e_spans if sp[1] > t_ingest]
    expected = 6 * len(e_spans) + rr_cfg.n_layers * len(r_spans)
    check(route_launches["tensor_core"] > 0, "the pipeline launched no tensor-core attention kernel")
    check(launches == expected, f"pipeline attention launches {launches} != expected {expected}")

    # checks ------------------------------------------------------------------------
    hits = hits_by_query(rows.values())
    check(len(rows) == PIPE_QUERIES * PIPE_K, f"pipeline captured {len(rows)} rows, expected {PIPE_QUERIES * PIPE_K}")
    check(sorted(hits) == list(range(PIPE_QUERIES)), "pipeline answered the wrong set of queries")
    self_ok = sum(1 for qi, hs in hits.items() if hs and hs[0][1] == qi)
    check(self_ok == PIPE_QUERIES, f"self-retrieval at rank 1: {self_ok}/{PIPE_QUERIES}")

    # a direct search over the embeddings the pipeline emitted, through the
    # index backend the pipeline uses, with the same capacity growth and the
    # same 512-query batches
    keys = [int(k) for k in sequential_keys(0, PIPE_DOCS)]
    direct = VectorBackend(dimension=384, metric="cos", reserved_space=1024, device=DEVICE)
    for key, d in zip(keys, docs):
        direct.add(key, elog.vectors[d][0], 0)
    q_vecs = [elog.vectors[q][-1] for q in queries]
    want: list[list[int]] = []
    for lo in range(0, PIPE_QUERIES, 512):
        chunk = q_vecs[lo : lo + 512]
        want.extend([[k for k, _ in h] for h in direct.search(chunk, [PIPE_K] * len(chunk), [lambda m: True] * len(chunk))])
    mismatched = [qi for qi in range(PIPE_QUERIES) if [h[0] for h in hits.get(qi, [])] != want[qi]]
    check(not mismatched, f"pipeline top-{PIPE_K} differs from the direct search for {len(mismatched)} queries")
    del direct

    pairs = [(queries[qi], docs[di]) for qi in range(PIPE_QUERIES) for _dk, di, _kn, _rs in hits.get(qi, [])]
    got_rr = np.array([rs for qi in range(PIPE_QUERIES) for *_x, rs in hits.get(qi, [])])
    want_rr = np.concatenate([rr._model.score_pairs(pairs[i : i + 512]) for i in range(0, len(pairs), 512)])
    rr_err = float(np.abs(got_rr - want_rr).max()) if len(pairs) else float("inf")
    check(bool(np.isfinite(got_rr).all()), "pipeline rerank scores not finite")
    check(rr_err <= 1e-2, f"pipeline rerank scores differ from score_pairs by {rr_err}")

    # microbatch off == auto, byte for byte, at PIPE_SAME_DOCS docs
    same_docs = docs[:PIPE_SAME_DOCS]
    off_rows, o0, o1 = _run_pipeline(emb, rr, same_docs, queries, "off")
    auto_rows, a0, a1 = _run_pipeline(emb, rr, same_docs, queries, "auto")
    same = off_rows == auto_rows
    check(same, f"microbatch off and auto differ at {PIPE_SAME_DOCS} docs")

    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    span_s = lambda spans: sum(b - a for a, b, _n in spans)  # noqa: E731
    out = {
        "card": info["nvidia_smi"],
        "docs": PIPE_DOCS, "queries": PIPE_QUERIES, "tick_rows": PIPE_TICK, "k": PIPE_K,
        "run_s": t1 - t0,
        "ingest_s": t_ingest - t0,
        "query_s": t1 - t_ingest,
        "ingest_docs_per_s": PIPE_DOCS / (t_ingest - t0),
        "query_rows_per_s": PIPE_QUERIES / (t1 - t_ingest),
        "embed_docs_launch_s": span_s(doc_launches),
        "embed_queries_launch_s": span_s(query_launches),
        "rerank_launch_s": span_s(r_spans),
        "engine_host_s": (t1 - t0) - span_s(e_spans) - span_s(r_spans),
        "embed_launches": len(e_spans),
        "embed_buckets": _buckets(e_spans),
        "rerank_launches": len(r_spans),
        "rerank_buckets": _buckets(r_spans),
        "attention_launches": launches,
        "attention_launches_by_route": route_launches,
        "attention_launches_expected": expected,
        "self_retrieval_rank1": self_ok,
        "direct_search_mismatches": len(mismatched),
        "rerank_max_abs_err_vs_score_pairs": rr_err,
        "rerank_tolerance": 1e-2,
        "microbatch_off_equals_auto": same,
        "same_docs": PIPE_SAME_DOCS,
        "off_run_s": o1 - o0,
        "auto_run_s": a1 - a0,
    }
    emit("pipeline", **out)
    del emb, rr, elog
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    return {"launches": route_launches, "metrics": out}


def make_corpus(n: int, dim: int, seed: int = 0) -> np.ndarray:
    """``benchmarks/knn_bench.py::make_corpus``: a clustered mixture, the shape
    embedding corpora have, so the IVF cold tier runs in its honest regime."""
    rng = np.random.default_rng(seed)
    n_centers = max(64, int(np.sqrt(n)))
    centers = rng.normal(size=(n_centers, dim)).astype(np.float32)
    assign = rng.integers(0, n_centers, n)
    return (centers[assign] + 0.15 * rng.normal(size=(n, dim))).astype(np.float32)


def _true(_md) -> bool:
    return True


def _best_qps(fn, q: int, reps: int = 3, budget_s: float = 0.3) -> float:
    """Queries/s of ``fn`` (one search of ``q`` queries that ends on the host):
    warmed, then the best of ``reps`` timed runs of enough calls to fill
    ``budget_s``."""
    fn()
    t0 = time.perf_counter()
    fn()
    iters = max(1, int(budget_s / max(time.perf_counter() - t0, 1e-4)))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        best = min(best, (time.perf_counter() - t0) / iters)
    return q / best


def _tier_counters() -> dict:
    from pathway_tpu_torch.stdlib.indexing import tiered

    return dict(tiered._counters)


def _tiered_split(tiered, queries: np.ndarray, k: int) -> dict:
    """Host-clock seconds of one tiered search by part: the hot search on the
    device (synchronised), the host IVF candidate scan, the cold rescore
    (device products, fetch and decode), and the rest (the hot hits' fetch
    and decode, candidate dedup, the canonical merge, hit accounting)."""
    from pathway_tpu_torch.ops import knn

    spent = {"hot_search": 0.0, "cold_ivf": 0.0, "cold_rescore": 0.0}

    def timed(name, fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            sync()
            spent[name] += time.perf_counter() - t0
            return out
        return run

    saved = tiered.hot.search_device, tiered.cold.search, knn.exact_rescore
    tiered.hot.search_device = timed("hot_search", saved[0])
    tiered.cold.search = timed("cold_ivf", saved[1])
    knn.exact_rescore = timed("cold_rescore", saved[2])
    try:
        t0 = time.perf_counter()
        tiered.search(list(queries), [k] * len(queries), [_true] * len(queries))
        total = time.perf_counter() - t0
    finally:
        del tiered.hot.search_device, tiered.cold.search
        knn.exact_rescore = saved[2]
    return {**spent, "rest": total - sum(spent.values()), "total": total}


def phase_tiered(info: dict) -> dict:
    """The tiered index on the card; see the module docstring (phase 8)."""
    import torch

    from pathway_tpu_torch.internals.keys import sequential_keys
    from pathway_tpu_torch.ops import attention_kernel as A
    from pathway_tpu_torch.ops import knn
    from pathway_tpu_torch.ops.encoder import EncoderConfig
    from pathway_tpu_torch.ops.knn import BruteForceKnnIndex
    from pathway_tpu_torch.stdlib.indexing import TieredKnnBackend, TieredKnnFactory
    from pathway_tpu_torch.stdlib.indexing._engine import VectorBackend
    from pathway_tpu_torch.tools.batch_invariance import index_rows_check
    from pathway_tpu_torch.tools.rag_pipeline import hits_by_query
    from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder
    from pathway_tpu_torch.xpacks.llm.rerankers import CrossEncoderReranker

    out: dict = {"card": info["nvidia_smi"]}
    dim, k = 384, 10

    # 0. a row scores the same bits in an index of any row count
    t0 = time.perf_counter()
    rows_check = index_rows_check(DEVICE, capacities=INVARIANCE_CAPACITIES)
    for name, (same, diff) in rows_check.items():
        check(same, f"{name}: scores differ by up to {diff}")
    out["index_rows_check"] = rows_check
    out["index_rows_check_s"] = time.perf_counter() - t0

    # 1. identity gate: 4x the hot bound, exact cold tier; the devices the
    # hot search and the cold rescore ran on are recorded
    ran_on: dict[str, set] = {"hot_search": set(), "cold_rescore": set()}

    def on_device(name, fn):
        def run(*args, **kwargs):
            ran_on[name].add(args[0].device.type)
            return fn(*args, **kwargs)
        return run

    saved_kernels = knn._search_kernel, knn._rescore_kernel
    knn._search_kernel = on_device("hot_search", knn._search_kernel)
    knn._rescore_kernel = on_device("cold_rescore", knn._rescore_kernel)
    corpus = make_corpus(TIER_CORPUS, dim, seed=3)
    queries = make_corpus(TIER_QUERIES, dim, seed=4)
    t0 = time.perf_counter()
    tiered = TieredKnnBackend(dimension=dim, metric="cos", hot_rows=TIER_HOT, min_train=10**9, device=DEVICE)
    for i in range(TIER_CORPUS):
        tiered.add(i, corpus[i], None)
    add_s = time.perf_counter() - t0
    brute = BruteForceKnnIndex(dimension=dim, metric="cos", capacity=TIER_CORPUS, device=DEVICE)
    brute.add_batch(list(range(TIER_CORPUS)), corpus)
    want = brute.search(queries, k)
    t0 = time.perf_counter()
    got = tiered.search(list(queries), [k] * TIER_QUERIES, [_true] * TIER_QUERIES)
    search_s = time.perf_counter() - t0
    check(tiered.hot.device.type == DEVICE and brute.device.type == DEVICE,
          f"tiered hot shard on {tiered.hot.device}, brute force on {brute.device}")
    same = got == want
    tiered.maintain()
    same_after = tiered.search(list(queries), [k] * TIER_QUERIES, [_true] * TIER_QUERIES) == want
    knn._search_kernel, knn._rescore_kernel = saved_kernels
    check(ran_on == {"hot_search": {DEVICE}, "cold_rescore": {DEVICE}},
          f"tiered search ran on {ran_on}, expected {DEVICE} only")
    check(same, "tiered top-10 differs from the brute-force index (keys or score bits)")
    check(same_after, "tiered top-10 differs from the brute-force index after maintain()")
    check(len(tiered.hot) == TIER_HOT, f"hot shard holds {len(tiered.hot)} rows, bound {TIER_HOT}")
    out["identity"] = {
        "corpus": TIER_CORPUS, "hot_bound": TIER_HOT, "queries": TIER_QUERIES, "k": k,
        "identical": same, "identical_after_maintain": same_after,
        "ran_on": {name: sorted(devs) for name, devs in ran_on.items()},
        "hot_rows": len(tiered.hot), "hot_device_bytes": tiered.hot.device_bytes(),
        "brute_force_device_bytes": brute.device_bytes(), "cold_host_bytes": tiered.cold_bytes(),
        "add_rows_per_s": TIER_CORPUS / add_s, "exact_cold_search_s": search_s,
    }
    del tiered

    # 2. serving: a trained IVF cold tier, knn_bench's queries and warm-up
    t0 = time.perf_counter()
    tiered = TieredKnnBackend(dimension=dim, metric="cos", hot_rows=TIER_HOT, device=DEVICE)
    for i in range(TIER_CORPUS):
        tiered.add(i, corpus[i], None)
    add_s = time.perf_counter() - t0
    rng = np.random.default_rng(7)
    qsets = {
        qb: (make_corpus(qb, dim, seed=100 + qb) + 0.1 * rng.normal(size=(qb, dim))).astype(np.float32)
        for qb in TIER_Q_BATCHES
    }
    t0 = time.perf_counter()
    for qb in TIER_Q_BATCHES:  # two passes per batch in one window, then rebalance
        for _ in range(2):
            tiered.search(list(qsets[qb]), [k] * qb, [_true] * qb)
        tiered.maintain()
    warm_s = time.perf_counter() - t0
    serving: dict = {"tiered_qps": {}, "brute_force_qps": {}, "recall_at_10": {}}
    for qb in TIER_Q_BATCHES:
        qs, qlist = qsets[qb], list(qsets[qb])
        tier_fn = lambda qlist=qlist, qb=qb: tiered.search(qlist, [k] * qb, [_true] * qb)  # noqa: E731
        brute_fn = lambda qs=qs: brute.search(qs, k)  # noqa: E731
        serving["tiered_qps"][str(qb)] = _best_qps(tier_fn, qb)
        serving["brute_force_qps"][str(qb)] = _best_qps(brute_fn, qb)
        got, want = tier_fn(), brute_fn()
        serving["recall_at_10"][str(qb)] = sum(
            len({key for key, _ in g} & {key for key, _ in w}) for g, w in zip(got, want)
        ) / (qb * k)
    serving["split_s"] = {str(qb): _tiered_split(tiered, qsets[qb], k) for qb in TIER_Q_BATCHES}
    stats = tiered.stats()
    check(stats["hot_rows"] <= TIER_HOT, f"hot shard past its bound: {stats['hot_rows']}")
    out["serving"] = {
        "corpus": TIER_CORPUS, "nlist": len(tiered.cold._centroids),
        "nprobe": tiered.cold._nprobe(len(tiered.cold._centroids)), "add_rows_per_s": TIER_CORPUS / add_s,
        "warmup_s": warm_s, **serving, **stats,
    }
    del tiered, brute, corpus
    if DEVICE == "cuda":
        torch.cuda.empty_cache()

    # 3. the pipeline with the tiered factory, at the pipeline phase's sizes
    saved = {key: os.environ.get(key) for key in ("PATHWAY_MICROBATCH", "PATHWAY_MICROBATCH_FLUSH_MS")}
    os.environ["PATHWAY_MICROBATCH_FLUSH_MS"] = "3600000"
    emb = SentenceTransformerEmbedder("minilm", seed=0, device=DEVICE)
    rr_cfg = EncoderConfig(vocab_size=32768, d_model=384, n_heads=6, n_layers=4, d_ff=1536, max_len=256)
    rr = CrossEncoderReranker(rr_cfg, seed=1, device=DEVICE)
    elog, rlog = _LaunchLog(emb, keep_vectors=True), _LaunchLog(rr)
    docs = synth_docs(PIPE_DOCS)
    queries = docs[:PIPE_QUERIES]
    factory = TieredKnnFactory(embedder=emb, hot_rows=TIER_PIPE_HOT, device=DEVICE)
    emb._encoder.encode_texts(docs[:512])  # warm-up at the launch shapes, outside the counts
    rr._model.score_pairs([(q, d) for q, d in zip(queries[:512], docs[1:513])])
    sync()
    before = _tier_counters()

    # --- the tiered pipeline: counts from 0 --------------------------------------
    A.LAUNCHES = 0
    A.ROUTE_LAUNCHES.update(dict.fromkeys(A.ROUTE_LAUNCHES, 0))
    rows, t0, t1 = _run_pipeline(emb, rr, docs, queries, "auto", factory)
    launches, route_launches = A.LAUNCHES, dict(A.ROUTE_LAUNCHES)
    # ------------------------------------------------------------------------------
    after = _tier_counters()
    e_spans, r_spans = list(elog.spans), list(rlog.spans)
    seen, t_ingest = 0, t1
    for _a, b, n in e_spans:
        seen += n
        if seen >= PIPE_DOCS:
            t_ingest = b
            break
    expected = 6 * len(e_spans) + rr_cfg.n_layers * len(r_spans)
    check(route_launches["tensor_core"] > 0, "the tiered pipeline launched no tensor-core attention kernel")
    check(launches == expected, f"tiered pipeline attention launches {launches} != expected {expected}")
    hits = hits_by_query(rows.values())
    check(len(rows) == PIPE_QUERIES * PIPE_K, f"tiered pipeline captured {len(rows)} rows")
    self_ok = sum(1 for qi, hs in hits.items() if hs and hs[0][1] == qi)
    check(self_ok == PIPE_QUERIES, f"tiered pipeline self-retrieval at rank 1: {self_ok}/{PIPE_QUERIES}")

    # recall of the pipeline's answers against an exact search over the
    # vectors it embedded
    keys = [int(key) for key in sequential_keys(0, PIPE_DOCS)]
    direct = VectorBackend(dimension=dim, metric="cos", reserved_space=PIPE_DOCS, device=DEVICE)
    for key, d in zip(keys, docs):
        direct.add(key, elog.vectors[d][0], 0)
    q_vecs = [elog.vectors[q][-1] for q in queries]
    exact = []
    for lo in range(0, PIPE_QUERIES, 512):
        chunk = q_vecs[lo : lo + 512]
        exact.extend([{key for key, _ in h} for h in direct.search(chunk, [PIPE_K] * len(chunk), [_true] * len(chunk))])
    recall = sum(len({h[0] for h in hits.get(qi, [])} & exact[qi]) for qi in range(PIPE_QUERIES)) / (PIPE_QUERIES * PIPE_K)
    del direct

    # microbatch off == auto at PIPE_SAME_DOCS docs, 4x the hot bound, with an
    # exact cold tier: the cold tier's candidates are the union over a
    # query batch, so only an exact tier promises the same answers for any
    # batching (as the brute-force index does)
    same_factory = TieredKnnFactory(embedder=emb, hot_rows=TIER_SAME_HOT, min_train=10**9, device=DEVICE)
    off_rows, o0, o1 = _run_pipeline(emb, rr, docs[:PIPE_SAME_DOCS], queries, "off", same_factory)
    auto_rows, a0, a1 = _run_pipeline(emb, rr, docs[:PIPE_SAME_DOCS], queries, "auto", same_factory)
    same = off_rows == auto_rows
    check(same, f"tiered pipeline: microbatch off and auto differ at {PIPE_SAME_DOCS} docs")
    for key, v in saved.items():
        if v is None:
            os.environ.pop(key, None)
        else:
            os.environ[key] = v
    out["pipeline"] = {
        "docs": PIPE_DOCS, "queries": PIPE_QUERIES, "tick_rows": PIPE_TICK, "k": PIPE_K,
        "hot_bound": TIER_PIPE_HOT, "run_s": t1 - t0,
        "ingest_docs_per_s": PIPE_DOCS / (t_ingest - t0),
        "query_rows_per_s": PIPE_QUERIES / (t1 - t_ingest),
        "self_retrieval_rank1": self_ok,
        "recall_at_10_vs_exact": recall,
        **{name: after[name] - before[name] for name in after},
        "embed_launches": len(e_spans), "rerank_launches": len(r_spans),
        "attention_launches": launches, "attention_launches_by_route": route_launches,
        "attention_launches_expected": expected,
        "microbatch_off_equals_auto": same, "same_docs": PIPE_SAME_DOCS, "same_hot_bound": TIER_SAME_HOT,
        "off_run_s": o1 - o0, "auto_run_s": a1 - a0,
    }
    emit("tiered", **out)
    del emb, rr, elog
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    return {"launches": route_launches, "metrics": out}


def phase_engine_kernels(info: dict) -> dict:
    """engine_bench's filter → join → groupby/sum in the port at
    ENGINE_ROWS rows, static and over ENGINE_TICKS ticks, with both
    functions of ``engine/torch_kernels.py`` on the card and on numpy (its
    fused chains on the register program); then the fused chain filter →
    select → select at ENGINE_ROWS rows on the fused device tier on the card
    against the register program. These legs run with the audit plane off:
    they measure the device routes, which an audit-sampled tick does not take
    (``engine/fusion.py``). Then the audit legs: the fused chain over
    ENGINE_TICKS ticks on the device tier with ``PATHWAY_AUDIT=full`` at
    sample 1.0 (no block takes ``fused/<card>``) and at the default ``on``
    (the unsampled ticks' blocks take it, the sampled ones stay on the
    host), each stream identical to the audit-off one and neither plane
    reporting a violation."""
    from pathway_tpu_torch.debug import _capture
    from pathway_tpu_torch.engine import torch_kernels as K
    from pathway_tpu_torch.observability import audit as AU
    from pathway_tpu_torch.observability.spans import tick_hash_sampled
    from pathway_tpu_torch.tools.engine_pipeline import build, build_fused_chain

    saved = {k: os.environ.get(k) for k in ("PATHWAY_ENGINE_JAX", "PATHWAY_FUSE_JAX", "PATHWAY_AUDIT",
                                            "PATHWAY_AUDIT_SAMPLE")}
    os.environ["PATHWAY_AUDIT"] = "off"
    card_flag = "gpu" if DEVICE == "cuda" else "cpu"
    runs = {}
    for n_times in (1, ENGINE_TICKS):
        outs = {}
        for flag in (card_flag, "0"):
            os.environ["PATHWAY_ENGINE_JAX"] = flag
            os.environ["PATHWAY_FUSE_JAX"] = "off" if flag == "0" else "auto"
            K.ROUTES.clear()
            table = build(ENGINE_ROWS, n_times)
            t0 = time.perf_counter()
            deltas = _capture(table).deltas
            sync()
            outs[flag] = (deltas, time.perf_counter() - t0, dict(K.ROUTES))
        same = outs[card_flag][0] == outs["0"][0]
        label = "static" if n_times == 1 else f"{n_times}_ticks"
        check(same, f"engine pipeline ({label}): card and numpy routes differ")
        check(bool(outs[card_flag][2]), f"engine pipeline ({label}): no function routed to the card")
        check(not outs["0"][2], f"engine pipeline ({label}): numpy route ran a torch function")
        runs[label] = {
            "rows": ENGINE_ROWS, "ticks": n_times, "out_updates": len(outs["0"][0]),
            f"{card_flag}_s": outs[card_flag][1], "numpy_s": outs["0"][1],
            f"{card_flag}_rows_per_s": ENGINE_ROWS / outs[card_flag][1],
            "numpy_rows_per_s": ENGINE_ROWS / outs["0"][1],
            "routes": outs[card_flag][2], "identical": same,
        }
    # the fused chain: PATHWAY_FUSE_JAX=on (the device tier, on the card)
    # against off (the register program), bit for bit
    os.environ["PATHWAY_ENGINE_JAX"] = card_flag
    fused = {}
    for n_times in (1, ENGINE_TICKS):
        outs = {}
        for mode in ("on", "off"):
            os.environ["PATHWAY_FUSE_JAX"] = mode
            K.ROUTES.clear()
            table = build_fused_chain(ENGINE_ROWS, n_times)
            t0 = time.perf_counter()
            deltas = _capture(table).deltas
            sync()
            outs[mode] = (deltas, time.perf_counter() - t0, dict(K.ROUTES))
        label = "static" if n_times == 1 else f"{n_times}_ticks"
        audit_off_ticks = outs["on"]
        same = outs["on"][0] == outs["off"][0] and repr(outs["on"][0]) == repr(outs["off"][0])
        check(same, f"fused chain ({label}): device tier and register program differ")
        check(outs["on"][2].get(f"fused/{DEVICE}", 0) > 0, f"fused chain ({label}): no block took the device tier on {DEVICE}")
        check(not outs["off"][2], f"fused chain ({label}): the register program ran a torch function")
        fused[label] = {
            "rows": ENGINE_ROWS, "ticks": n_times, "out_updates": len(outs["off"][0]),
            "device_tier_s": outs["on"][1], "register_program_s": outs["off"][1],
            "device_tier_rows_per_s": ENGINE_ROWS / outs["on"][1],
            "register_program_rows_per_s": ENGINE_ROWS / outs["off"][1],
            "routes": outs["on"][2], "identical": same,
        }
    runs["fused_chain"] = fused
    # the audit legs: the device tier wanted for every block (``on``), the
    # audit plane at full (every tick sampled) and at its default
    os.environ["PATHWAY_FUSE_JAX"] = "on"
    base = fused[f"{ENGINE_TICKS}_ticks"]
    audited = {}
    for leg, mode, sample in (("full", "full", "1.0"), ("on", "on", None)):
        os.environ["PATHWAY_AUDIT"] = mode
        if sample is None:
            os.environ.pop("PATHWAY_AUDIT_SAMPLE", None)
        else:
            os.environ["PATHWAY_AUDIT_SAMPLE"] = sample
        K.ROUTES.clear()
        table = build_fused_chain(ENGINE_ROWS, ENGINE_TICKS)
        t0 = time.perf_counter()
        deltas = _capture(table).deltas
        sync()
        secs = time.perf_counter() - t0
        routes = dict(K.ROUTES)
        plane = AU.current()
        got = routes.get(f"fused/{DEVICE}", 0)
        same = deltas == audit_off_ticks[0] and repr(deltas) == repr(audit_off_ticks[0])
        check(same, f"fused chain under PATHWAY_AUDIT={mode}: its stream differs from the audit-off run")
        check(plane is not None and plane.violation_counts == {} and plane.divergences == 0,
              f"fused chain under PATHWAY_AUDIT={mode}: violations {plane and plane.violation_counts}")
        sampled = [t for t in range(ENGINE_TICKS) if tick_hash_sampled(t, plane.edge_sample)]
        expected = base["routes"].get(f"fused/{DEVICE}", 0) - len(sampled)
        if mode == "full":
            check(got == 0, f"fused chain under PATHWAY_AUDIT=full: {got} blocks took the device tier")
        else:
            check(got == expected and 0 < got < base["routes"].get(f"fused/{DEVICE}", 0),
                  f"fused chain under PATHWAY_AUDIT=on: {got} blocks took the device tier, expected {expected} "
                  f"(ticks {sampled} audit-sampled)")
        audited[leg] = {"seconds": secs, "rows_per_s": ENGINE_ROWS / secs, "routes": routes,
                        "sampled_ticks": sampled, "expected_device_blocks": expected if mode == "on" else 0,
                        "shadow_ticks": plane.shadow_ticks, "identical": same,
                        "audit_off_seconds": base["device_tier_s"]}
    runs["fused_chain_audited"] = audited
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    emit("engine_kernels", card=info["nvidia_smi"], **runs)
    import pathway_tpu_torch as pw

    pw.G.clear()
    return runs


def phase_audit_fault(info: dict) -> dict:
    """The audit plane's tripwire on the card's tiered path (the port's copy of
    ``tests/test_audit.py::test_flip_diff_on_index_input_edge_with_tiered_backend_live``):
    48 seeded 8-d vectors in 6 ticks of 8 into a ``TieredKnnFactory`` index
    whose hot shard lives on the card (hot bound 8), one as-of-now query,
    and ``PATHWAY_FAULT_PLAN=flip_diff:proc=0,tick=2`` negating one docs
    row's diff. Gates: a ``negative_multiplicity`` violation at the docs
    input edge at tick 2, one flight dump naming the operator, key and tick,
    the index still answering from the card (hot hits counted)."""
    import tempfile

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.observability import audit as AU
    from pathway_tpu_torch.stdlib.indexing import TieredKnnFactory
    from pathway_tpu_torch.stdlib.indexing import tiered

    os.makedirs(SCRATCH, exist_ok=True)
    flight = tempfile.mkdtemp(prefix="audit_fault_", dir=SCRATCH)
    saved = {k: os.environ.get(k) for k in ("PATHWAY_FAULT_PLAN", "PATHWAY_FLIGHT_DIR")}
    os.environ["PATHWAY_FAULT_PLAN"] = "flip_diff:proc=0,tick=2"
    os.environ["PATHWAY_FLIGHT_DIR"] = flight
    try:
        with tiered._registry_lock:
            hits0 = tiered._counters["hits_total"]
        pw.G.clear()
        rng = np.random.default_rng(21)
        vecs = rng.normal(size=(48, 8)).astype(np.float32)
        docs = pw.debug.table_from_rows(pw.schema_from_types(emb=np.ndarray),
                                        [(v, i // 8, 1) for i, v in enumerate(vecs)], is_stream=True)
        factory = TieredKnnFactory(dimensions=8, hot_rows=8, min_train=10**9, device=DEVICE)
        index = factory.build_index(docs.emb, docs)
        qs = pw.debug.table_from_rows(pw.schema_from_types(emb=np.ndarray), [(vecs[3],)])
        r = index.inner_index.query_as_of_now(qs.emb, number_of_matches=2)
        replies: list = []
        pw.io.subscribe(r, on_change=lambda key, row, time, is_addition: replies.append(row) if is_addition else None)
        pw.run(monitoring_level="none")
        with tiered._registry_lock:
            hot_devices = sorted({str(b.hot.device) for b in tiered._live_tiered})
        plane = AU.current()
        found = [v for v in plane.violations if v["kind"] == "negative_multiplicity"]
        v = found[0] if found else {}
        check(bool(found) and v.get("tick") == 2 and v.get("key") is not None
              and str(v.get("operator", "")).startswith("stream_fixture"),
              f"audit_fault: the flipped diff was not caught at the docs edge at tick 2: {list(plane.violations)}")
        dumps = sorted(f for f in os.listdir(flight) if f.startswith("flight_p0_"))
        doc = json.load(open(os.path.join(flight, dumps[0]))) if dumps else {}
        extra = doc.get("extra") or {}
        check(len(dumps) == 1 and doc.get("reason") == "audit_violation"
              and extra.get("tick") == 2 and extra.get("key") == v.get("key")
              and str(extra.get("operator", "")).startswith("stream_fixture")
              and any(e.get("kind") == "audit_violation" for e in doc.get("events", [])),
              f"audit_fault: flight dumps {dumps}: reason {doc.get('reason')}, extra {extra}")
        with tiered._registry_lock:
            hits = tiered._counters["hits_total"] - hits0
        check(bool(replies) and hits >= 2 and hot_devices and all(d.startswith(DEVICE) for d in hot_devices),
              f"audit_fault: replies {len(replies)}, hot hits {hits}, hot shards on {hot_devices}")
        out = {"violation": {k: v.get(k) for k in ("kind", "operator", "key", "tick", "detail")},
               "violations_by_kind": dict(plane.violation_counts), "flight_dump": {"reason": doc.get("reason"),
               "extra": {k: extra.get(k) for k in ("operator", "key", "tick")}}, "replies": len(replies),
               "hot_hits": hits, "hot_shard_devices": hot_devices}
    finally:
        for k, val in saved.items():
            if val is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = val
        pw.G.clear()
    emit("audit_fault", card=info["nvidia_smi"], **out)
    return out


def _capture_all(tables: dict) -> tuple[dict, float]:
    """Every table of ``tables`` captured in ONE engine run: (name -> its
    update stream ``(time, key, diff, values)``, the run's seconds)."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.tools import nexmark as nx

    t0 = time.perf_counter()
    nodes = nx.capture(pw, tables)
    sync()
    seconds = time.perf_counter() - t0

    def plain(v):
        return v.item() if isinstance(v, np.generic) else v

    streams = {
        name: [(t, k, d, tuple(plain(v) for v in row)) for (t, k, d, row) in node.deltas]
        for name, node in nodes.items()
    }
    return streams, seconds


def _net_rows(stream) -> dict:
    """Final rows of an update stream: row values -> multiplicity."""
    net: dict = {}
    for _t, k, d, row in stream:
        net[(k, row)] = net.get((k, row), 0) + d
    out: dict = {}
    for (_k, row), m in net.items():
        if m:
            out[row] = out.get(row, 0) + m
    return out


def _nexmark_model(ev: dict, tick: int) -> dict:
    """The static answers of Q5, Q7 and Q8 in plain numpy, and the bids that
    Q7's cutoff drops when the events arrive ``tick`` at a time: a bid is
    dropped iff the watermark at its arrival (the largest bid time of the
    earlier ticks) is at least its window's end + the cutoff."""
    from pathway_tpu_torch.tools import nexmark as nx

    b = ev["kind"] == nx.BID
    arrival = np.flatnonzero(b)
    auction, bidder, price, t = (ev[c][b] for c in ("auction", "bidder", "price", "t"))
    out: dict = {}
    # Q5: 5 sliding windows per bid (hop 2 s, duration 10 s), count per auction
    k = nx.Q5_DURATION_MS // nx.Q5_HOP_MS
    starts = ((t // nx.Q5_HOP_MS)[:, None] - np.arange(k)[None, :]) * nx.Q5_HOP_MS
    pairs = np.stack([np.repeat(auction, k), starts.ravel()], axis=1)
    uniq, counts = np.unique(pairs, axis=0, return_counts=True)
    out["q5_counts"] = {(int(a), int(s), int(c)): 1 for (a, s), c in zip(uniq, counts)}
    best: dict = {}
    for (a, s), c in zip(uniq.tolist(), counts.tolist()):
        best[s] = max(best.get(s, 0), c)
    out["q5_hot"] = {(s, a, c): 1 for (a, s), c in zip(uniq.tolist(), counts.tolist()) if c == best[s]}

    def q7(keep):
        start = (t // nx.Q7_WINDOW_MS) * nx.Q7_WINDOW_MS
        top: dict = {}
        n: dict = {}
        for s_, p_ in zip(start[keep].tolist(), price[keep].tolist()):
            top[s_] = max(top.get(s_, p_), p_)
            n[s_] = n.get(s_, 0) + 1
        highest: dict = {}
        for s_, a_, b_, p_ in zip(start.tolist(), auction.tolist(), bidder.tolist(), price.tolist()):
            if top.get(s_) == p_:
                highest[(s_, a_, b_, p_)] = highest.get((s_, a_, b_, p_), 0) + 1
        return {(s_, top[s_], n[s_]): 1 for s_ in top}, highest

    out["q7_top"], out["q7_highest"] = q7(np.ones(len(t), bool))
    # the cutoff's drops in the ticked run
    tick_of = arrival // tick
    tick_max = {}
    for j, tt in zip(tick_of.tolist(), t.tolist()):
        tick_max[j] = max(tick_max.get(j, tt), tt)
    wm = np.full(len(t), -1, np.int64)
    running = None
    for j in range(int(tick_of.max()) + 1 if len(t) else 0):
        wm[tick_of == j] = -1 if running is None else running
        if j in tick_max:
            running = tick_max[j] if running is None else max(running, tick_max[j])
    threshold = (t // nx.Q7_WINDOW_MS) * nx.Q7_WINDOW_MS + nx.Q7_WINDOW_MS + nx.Q7_CUTOFF_MS
    dropped = (wm >= 0) & (threshold <= wm)
    out["q7_cutoff_dropped"] = int(dropped.sum())
    out["q7_cutoff_top_ticks"], out["q7_cutoff_highest_ticks"] = q7(~dropped)
    # Q8: a person and the auctions it sells in the same 10 s window
    pm, am = ev["kind"] == nx.PERSON, ev["kind"] == nx.AUCTION
    persons = {}
    for pid, city, pt in zip(ev["eid"][pm].tolist(), ev["city"][pm].tolist(), ev["t"][pm].tolist()):
        persons.setdefault((pid, pt // nx.Q8_WINDOW_MS), []).append((city, pt))
    q8: dict = {}
    for aid, seller, at in zip(ev["eid"][am].tolist(), ev["seller"][am].tolist(), ev["t"][am].tolist()):
        for city, pt in persons.get((seller, at // nx.Q8_WINDOW_MS), ()):
            row = (seller, city, aid, pt, at)
            q8[row] = q8.get(row, 0) + 1
    out["q8_pairs"] = q8
    out["bids"] = int(b.sum())
    return out


def _surface_model(ev: dict) -> dict:
    """Plain numpy answers of the surface queries (``tools/nexmark.py``)."""
    from pathway_tpu_torch.tools import nexmark as nx

    b, pm, am = (ev["kind"] == k for k in (nx.BID, nx.PERSON, nx.AUCTION))
    auction, bidder, price, t = (ev[c][b] for c in ("auction", "bidder", "price", "t"))
    person_t = dict(zip(ev["eid"][pm].tolist(), ev["t"][pm].tolist()))
    asof_matched = sum(1 for bd, tt in zip(bidder.tolist(), t.tolist()) if person_t.get(bd, tt + 1) <= tt)
    created = dict(zip(ev["eid"][am].tolist(), ev["t"][am].tolist()))
    interval = sum(
        1 for a, tt in zip(auction.tolist(), t.tolist())
        if a in created and 0 <= tt - created[a] <= nx.SURFACE_INTERVAL_MS
    )
    kept: dict = {}
    for a, p in zip(auction.tolist(), price.tolist()):
        kept[a] = max(kept.get(a, p), p)
    return {"asof_matched": asof_matched, "asof_rows": int(b.sum()), "interval_pairs": interval,
            "dedup_prices": sorted(kept.items()), "diff_firsts": len(set(auction.tolist()))}


def _temporal_job(job: tuple) -> tuple:
    """One run of phase ``temporal`` in a worker process: ``query`` over the
    first ``n_events`` events of the seeded stream (static, or in ticks of
    ``tick``) on one route. Returns the job, the update streams, the run's
    seconds, the engine routes and the attention launches it made."""
    global DEVICE
    query, mode, route, n_events, generated, tick, device = job
    DEVICE = device
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.engine import torch_kernels as K
    from pathway_tpu_torch.ops import attention_kernel as A
    from pathway_tpu_torch.tools import nexmark as nx

    engine, fuse = ("0", "off") if route == "numpy" else (route, "on")
    os.environ["PATHWAY_ENGINE_JAX"] = engine
    os.environ["PATHWAY_FUSE_JAX"] = fuse
    # the phase holds the card's routes against numpy's: an audit-sampled
    # tick keeps its fused chains on the host (phase engine_kernels prices
    # the audit plane on the device tier)
    os.environ["PATHWAY_AUDIT"] = "off"
    ev = {c: v[:n_events] for c, v in nx.generate(generated, seed=0).items()}
    tables = nx.build(pw, query, ev, tick if mode == "ticks" else None)
    K.ROUTES.clear()
    A.LAUNCHES = 0
    A.ROUTE_LAUNCHES.update(dict.fromkeys(A.ROUTE_LAUNCHES, 0))
    streams, seconds = _capture_all(tables)
    pw.G.clear()
    return job, streams, seconds, dict(K.ROUTES), dict(A.ROUTE_LAUNCHES)


def phase_temporal(info: dict) -> dict:
    """The temporal Table API on a Nexmark-shaped stream (``tools/nexmark.py``):
    Q5, Q7 (without a behavior and with ``common_behavior(cutoff=5 s)``) and
    Q8 over TEMPORAL_EVENTS events, static and in ticks of TEMPORAL_TICK,
    each with the engine's device functions on the card
    (``PATHWAY_ENGINE_JAX=gpu``, ``PATHWAY_FUSE_JAX=on``) and on numpy
    (``0``, ``off``); then the rest of the surface (asof and interval joins,
    sort/diff, deduplicate) on the first TEMPORAL_SURFACE_EVENTS events.
    The runs are host-bound Python, so they run TEMPORAL_WORKERS at a time,
    each in a worker process of its own that times its run, with the audit
    plane off (an audit-sampled tick keeps a fused chain on the host).
    Gates: card == numpy update streams; ``grouped`` and ``fused`` on the
    card, no torch function on numpy; the static answers and the cutoff's
    drops equal ``_nexmark_model``; ticks == static where no behavior acts."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from pathway_tpu_torch.tools import nexmark as nx

    card = "gpu" if DEVICE == "cuda" else "cpu"
    device = "cuda" if DEVICE == "cuda" else "cpu"
    t_gen = time.perf_counter()
    ev = nx.generate(TEMPORAL_EVENTS_GENERATED, seed=0)
    ev = {c: v[:TEMPORAL_EVENTS] for c, v in ev.items()}
    model = _nexmark_model(ev, TEMPORAL_TICK)
    gen_s = time.perf_counter() - t_gen
    # longest runs first, so the pool's tail is short
    jobs = [(q, mode, route, TEMPORAL_EVENTS, TEMPORAL_EVENTS_GENERATED, TEMPORAL_TICK, DEVICE)
            for q in TEMPORAL_QUERIES for mode in ("static", "ticks") for route in (card, "numpy")]
    jobs += [("surface", "static", route, TEMPORAL_SURFACE_EVENTS, TEMPORAL_EVENTS_GENERATED, TEMPORAL_TICK, DEVICE)
             for route in (card, "numpy")]
    t_phase = time.perf_counter()
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=TEMPORAL_WORKERS, mp_context=ctx) as pool:
        done = {(job[0], job[1], job[2]): rest for job, *rest in pool.map(_temporal_job, jobs)}
    phase_s = time.perf_counter() - t_phase
    launches = {"tensor_core": 0, "tensor_core_3xtf32": 0}
    for *_, by_route in done.values():
        for k, v in by_route.items():
            launches[k] = launches.get(k, 0) + v

    result: dict = {"events": TEMPORAL_EVENTS, "tick_events": TEMPORAL_TICK, "ticks": -(-TEMPORAL_EVENTS // TEMPORAL_TICK),
                    "late_bids": int(ev["late"].sum()), "bids": model["bids"], "workers": TEMPORAL_WORKERS,
                    "generate_and_model_s": gen_s}
    finals: dict = {}
    for query in TEMPORAL_QUERIES + ("surface",):
        entry = {}
        n = TEMPORAL_SURFACE_EVENTS if query == "surface" else TEMPORAL_EVENTS
        for mode in ("static",) if query == "surface" else ("static", "ticks"):
            c, nu = done[(query, mode, card)], done[(query, mode, "numpy")]
            label = f"temporal {query} ({mode})"
            same = c[0] == nu[0]
            check(same, f"{label}: card and numpy update streams differ")
            check(c[2].get(f"fused/{device}", 0) > 0, f"{label}: no fused chain on the {device} tier")
            if query in ("q5", "q7", "q7_cutoff"):
                check(c[2].get(f"grouped/{device}", 0) > 0, f"{label}: no groupby on the {device} route")
            check(not nu[2], f"{label}: the numpy route ran a torch function {nu[2]}")
            finals[(query, mode)] = {name: _net_rows(st) for name, st in nu[0].items()}
            entry[mode] = {
                f"{card}_s": c[1], "numpy_s": nu[1],
                f"{card}_events_per_s": n / c[1], "numpy_events_per_s": n / nu[1],
                "routes": c[2], "out_updates": {k: len(v) for k, v in nu[0].items()}, "identical": same,
            }
        result[query] = entry
    # gate 3: the static answers against the numpy model
    for query, names in (("q5", ("q5_counts", "q5_hot")), ("q7", ("q7_top", "q7_highest")),
                         ("q7_cutoff", ("q7_top", "q7_highest")), ("q8", ("q8_pairs",))):
        for name in names:
            got = finals[(query, "static")][name]
            check(got == model[name], f"temporal {query} static {name}: {len(got)} rows, model {len(model[name])}")
    # the cutoff's drops over ticks
    cut = finals[("q7_cutoff", "ticks")]
    kept = sum(n * m for (_s, _top, n), m in cut["q7_top"].items())
    dropped = model["bids"] - kept
    check(dropped == model["q7_cutoff_dropped"],
          f"temporal q7_cutoff: {dropped} late bids dropped, model {model['q7_cutoff_dropped']}")
    check(cut["q7_top"] == model["q7_cutoff_top_ticks"], "temporal q7_cutoff ticks: window maxima differ from the model")
    check(cut["q7_highest"] == model["q7_cutoff_highest_ticks"], "temporal q7_cutoff ticks: highest bids differ from the model")
    result["q7_cutoff"]["dropped_late_bids"] = dropped
    result["q7_cutoff"]["model_dropped"] = model["q7_cutoff_dropped"]
    # gate 4: without a behavior, the ticked final state is the static one
    for query in ("q5", "q7", "q8"):
        check(finals[(query, "ticks")] == finals[(query, "static")], f"temporal {query}: ticks final state != static")
    # the rest of the surface against its numpy model
    head = {c: v[:TEMPORAL_SURFACE_EVENTS] for c, v in ev.items()}
    sm = _surface_model(head)
    fin = finals[("surface", "static")]
    asof_rows = sum(fin["asof"].values())
    asof_matched = sum(m for row, m in fin["asof"].items() if row[4] is not None)
    check(asof_rows == sm["asof_rows"] and asof_matched == sm["asof_matched"],
          f"temporal surface asof: {asof_rows} rows / {asof_matched} matched, model {sm['asof_rows']} / {sm['asof_matched']}")
    check(sum(fin["interval"].values()) == sm["interval_pairs"],
          f"temporal surface interval: {sum(fin['interval'].values())} pairs, model {sm['interval_pairs']}")
    check(sorted((row[0], row[2]) for row in fin["dedup"]) == sm["dedup_prices"],
          "temporal surface dedup: kept prices differ from the model")
    firsts = sum(m for row, m in fin["diff"].items() if row[0] is None)
    check(firsts == sm["diff_firsts"], f"temporal surface diff: {firsts} first bids, model {sm['diff_firsts']}")
    result["surface"].update(asof_matched=asof_matched, interval_pairs=sm["interval_pairs"])
    result["phase_s"] = phase_s
    result["launches"] = launches
    emit("temporal", card=info["nvidia_smi"], **result)
    return result


def _write_safetensors(path: str, tensors: dict) -> None:
    """A ``.safetensors`` file of f32 tensors without the ``safetensors``
    package: 8-byte little-endian header length, JSON header, raw data."""
    header, blobs, offset = {}, [], 0
    for name, t in tensors.items():
        raw = t.detach().to("cpu", dtype=__import__("torch").float32).contiguous().numpy().tobytes()
        header[name] = {"dtype": "F32", "shape": list(t.shape), "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little") + head)
        for raw in blobs:
            f.write(raw)


def phase_bert_path(info: dict) -> dict:
    """A BERT checkpoint at all-MiniLM-L6-v2's widths (vocab 30,522, hidden
    384, 6 layers, 12 heads of 32, intermediate 1,536, random f32 weights
    from seed 0, a synthetic vocab.txt) written as pytorch_model.bin and as
    model.safetensors, loaded by ``from_pretrained`` on the card (f32, so
    every attention call takes the f32 route at hd 32); BERT_DOCS WordPiece
    docs tokenized on the host, then embedded in batches of BERT_BATCH and
    indexed, median of 3; checks against the port's CPU path, by
    self-retrieval and by the bert entry of ``tools/batch_invariance.py``."""
    import shutil

    import torch

    from pathway_tpu_torch.ops import attention_kernel as A
    from pathway_tpu_torch.ops.encoder import TorchSentenceEncoder
    from pathway_tpu_torch.ops.knn import BruteForceKnnIndex
    from pathway_tpu_torch.tools import bert_checkpoint as C
    from pathway_tpu_torch.tools.batch_invariance import bert_check

    config = C.MINILM_L6
    root = os.path.join(SCRATCH, "bert")
    shutil.rmtree(root, ignore_errors=True)
    vocab = C.synthetic_vocab(config["vocab_size"])
    sd = C.random_state_dict(config, seed=0)
    bin_dir, st_dir = os.path.join(root, "bin"), os.path.join(root, "safetensors")
    C.write_checkpoint(bin_dir, config, sd, vocab)
    os.makedirs(st_dir)
    for name in ("config.json", "vocab.txt"):
        shutil.copy(os.path.join(bin_dir, name), st_dir)
    _write_safetensors(os.path.join(st_dir, "model.safetensors"), sd)
    t0 = time.perf_counter()
    enc = TorchSentenceEncoder.from_pretrained(bin_dir, max_len=128, device=DEVICE)
    load_s = time.perf_counter() - t0
    enc_st = TorchSentenceEncoder.from_pretrained(st_dir, max_len=128, device=DEVICE)
    pa, pb = dict(enc.named_parameters()), dict(enc_st.named_parameters())
    same_params = pa.keys() == pb.keys() and all(torch.equal(pa[k], pb[k]) for k in pa)
    check(same_params, "bert_path: pytorch_model.bin and model.safetensors load different parameters")
    check(enc.cfg.n_heads == 12 and enc.cfg.d_model // enc.cfg.n_heads == 32 and enc.cfg.dtype == torch.float32,
          f"bert_path: config {enc.cfg}")
    del enc_st, pa, pb

    docs = C.synthetic_docs(vocab, BERT_DOCS)
    t0 = time.perf_counter()
    ids_all, mask_all = enc.tokenizer(docs)
    tok_s = time.perf_counter() - t0
    n_ids = mask_all.sum(axis=1)
    check(ids_all.shape[1] == 128 and int(n_ids.max()) <= 128, f"bert_path: docs tokenized to L={ids_all.shape[1]}")
    unk_share = float((ids_all == enc.tokenizer.unk_id).sum() / n_ids.sum())
    cont_ids = {i for t, i in enc.tokenizer.vocab.items() if t.startswith("##")}
    cont_share = float(np.isin(ids_all, list(cont_ids)).sum() / n_ids.sum())
    batches = -(-len(docs) // BERT_BATCH)

    def ingest(index):
        for i in range(0, len(ids_all), BERT_BATCH):
            embs = enc.encode_ids_device(ids_all[i : i + BERT_BATCH])
            index.add_batch_device(range(i, i + int(embs.shape[0])), embs)
            index._flush()
        index.search(embs[:64], k=10)  # one fetch syncs the whole pipeline

    warm = BruteForceKnnIndex(dimension=384, capacity=2 * BERT_BATCH, device=DEVICE)
    for i in range(0, 2 * BERT_BATCH, BERT_BATCH):
        warm.add_batch_device(range(i, i + BERT_BATCH), enc.encode_ids_device(ids_all[i : i + BERT_BATCH]))
    warm._flush()
    del warm
    sync()

    # --- the bert path: counts from 0 -----------------------------------------
    A.LAUNCHES = 0
    A.ROUTE_LAUNCHES.update(dict.fromkeys(A.ROUTE_LAUNCHES, 0))
    rates = []
    for _ in range(3):
        index = BruteForceKnnIndex(dimension=384, capacity=BERT_DOCS, device=DEVICE)
        t0 = time.perf_counter()
        ingest(index)
        rates.append(len(docs) / (time.perf_counter() - t0))
    launches, route_launches = A.LAUNCHES, dict(A.ROUTE_LAUNCHES)  # read right after the path
    # --------------------------------------------------------------------------
    expected = 3 * batches * enc.cfg.n_layers
    check(route_launches["tensor_core_3xtf32"] == expected,
          f"bert_path: f32-route launches {route_launches} != {expected}")
    check(launches == expected, f"bert_path: attention launches {launches} != {expected}")

    # checks: the first 64 against the CPU path (f32_path's tolerance), every
    # doc finds itself first, the bert entry of batch_invariance
    e_dev = torch.cat([enc.encode_ids_device(ids_all[i : i + BERT_BATCH]) for i in range(0, len(docs), BERT_BATCH)])
    e64 = e_dev[:64].cpu().numpy()
    cpu = TorchSentenceEncoder.from_pretrained(bin_dir, max_len=128, device="cpu")
    e_cpu = cpu.encode_ids_device(ids_all[:64]).numpy()
    emb_err = float(np.abs(e_cpu - e64).max())
    check(bool(torch.isfinite(e_dev).all()) and tuple(e_dev.shape) == (BERT_DOCS, 384), "bert embeddings not finite / wrong shape")
    check(emb_err <= 1e-4, f"bert_path: card vs CPU embeddings differ by {emb_err}")
    self_ok = 0
    for lo in range(0, len(docs), 1024):
        hits = index.search(e_dev[lo : lo + 1024], k=1)
        self_ok += sum(1 for i, h in enumerate(hits) if h and h[0][0] == lo + i)
    check(self_ok == BERT_DOCS, f"bert_path: self-retrieval at rank 1 {self_ok}/{BERT_DOCS}")
    inv = bert_check(enc, docs[:BERT_BATCH])
    inv_key = f"bert_embed_8_rows_vs_{min(BERT_BATCH, len(docs))}"
    check(inv[inv_key][0], f"bert_path: batch invariance {inv}")
    out = {
        "card": info["nvidia_smi"],
        "config": {k: config[k] for k in ("vocab_size", "hidden_size", "num_hidden_layers", "num_attention_heads",
                                          "intermediate_size", "max_position_embeddings", "layer_norm_eps")},
        "dtype": "float32",
        "docs": len(docs),
        "seq_len": int(ids_all.shape[1]),
        "ids_per_doc_mean": float(n_ids.mean()),
        "ids_per_doc_max": int(n_ids.max()),
        "unk_share": unk_share,
        "continuation_share": cont_share,
        "wordpiece_docs_per_s": len(docs) / tok_s,
        "from_pretrained_bin_s": load_s,
        "bin_equals_safetensors": same_params,
        "bert_embed_index_docs_per_s": statistics.median(rates),
        "bert_embed_index_runs_docs_per_s": rates,
        "encoder_launches": 3 * batches,
        "attention_launches": launches,
        "attention_launches_by_route": route_launches,
        "attention_launches_expected": expected,
        "card_vs_cpu_embedding_max_abs_err": emb_err,
        "tolerance_embedding": 1e-4,
        "self_retrieval_rank1": self_ok,
        "batch_invariance": inv,
    }
    emit("bert_path", **out)
    del enc, cpu, index, e_dev
    shutil.rmtree(root, ignore_errors=True)
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    return {"launches": route_launches, "metrics": out}


def _make_pdf(text: str) -> bytes:
    """A one-page PDF showing ``text`` (Helvetica, FlateDecode)."""
    import zlib

    esc = text.replace("\\", r"\\").replace("(", r"\(").replace(")", r"\)").encode("latin-1")
    stream = zlib.compress(b"BT /F1 12 Tf 72 720 Td (" + esc + b") Tj ET")
    objs = [
        b"<< /Type /Font /Subtype /Type1 /BaseFont /Helvetica >>",
        b"<< /Length %d /Filter /FlateDecode >>\nstream\n" % len(stream) + stream + b"\nendstream",
        b"<< /Type /Page /Parent 4 0 R /MediaBox [0 0 612 792] /Resources << /Font << /F1 1 0 R >> >> /Contents 2 0 R >>",
        b"<< /Type /Pages /Kids [3 0 R] /Count 1 >>",
        b"<< /Type /Catalog /Pages 4 0 R >>",
    ]
    out, offsets = bytearray(b"%PDF-1.4\n"), []
    for i, body in enumerate(objs, start=1):
        offsets.append(len(out))
        out += b"%d 0 obj\n" % i + body + b"\nendobj\n"
    xref = len(out)
    out += b"xref\n0 %d\n0000000000 65535 f \n" % (len(objs) + 1)
    out += b"".join(b"%010d 00000 n \n" % o for o in offsets)
    out += b"trailer\n<< /Size %d /Root 5 0 R >>\nstartxref\n%d\n%%%%EOF\n" % (len(objs) + 1, xref)
    return bytes(out)


def _make_docx(text: str) -> bytes:
    import io
    import zipfile

    w = "http://schemas.openxmlformats.org/wordprocessingml/2006/main"
    doc = (f'<?xml version="1.0" encoding="UTF-8"?><w:document xmlns:w="{w}"><w:body>'
           f'<w:p><w:r><w:t xml:space="preserve">{text}</w:t></w:r></w:p></w:body></w:document>')
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as zf:
        zf.writestr("word/document.xml", doc)
    return buf.getvalue()


def _format_files(root: str, n: int, rng) -> dict:
    """``n`` files of each of PDF, DOCX, HTML and Markdown under
    ``root/<fmt>``, each holding one marker phrase; returns {fmt: [(path,
    phrase)]}."""
    words = [f"marker{i}" for i in range(2000)]
    made: dict = {}
    for fmt, ext in (("pdf", "pdf"), ("docx", "docx"), ("html", "html"), ("md", "md")):
        os.makedirs(os.path.join(root, fmt), exist_ok=True)
        for i in range(n):
            phrase = f"{fmt} file {i} " + " ".join(rng.choice(words, size=12))
            path = os.path.join(root, fmt, f"f{i:03d}.{ext}")
            data = {
                "pdf": lambda: _make_pdf(phrase),
                "docx": lambda: _make_docx(phrase),
                "html": lambda: f"<html><head><title>t{i}</title></head><body><p>{phrase}</p></body></html>".encode(),
                "md": lambda: f"# {phrase.split()[0]}\n\n{' '.join(phrase.split()[1:])}\n".encode(),
            }[fmt]()
            with open(path, "wb") as f:
                f.write(data)
            made.setdefault(fmt, []).append((path, phrase))
    return made


def _ds_run(pw, store, *, retrieve=None, stats=False, inputs=False, qa=None) -> dict:
    """One ``pw.run`` of ``store``'s queries, each a list of query rows
    arriving in DS_TICK-row ticks after the docs; returns every subscribed
    output's final rows by name (each a list in arrival order) and the host
    clock of the run."""
    out: dict = {}
    tick = [1]

    def stream(schema, rows):
        timed = [(*r, tick[0] + i // DS_TICK, 1) for i, r in enumerate(rows)]
        tick[0] += -(-len(rows) // DS_TICK)
        return pw.debug.table_from_rows(schema, timed, is_stream=True)

    def sink(name, table):
        got = out.setdefault(name, {})

        def on_change(key, row, time, is_addition):  # row: {column: value}
            if is_addition:
                got[key] = row
            elif got.get(key) == row:
                del got[key]

        pw.io.subscribe(table, on_change)

    Store = type(store)
    if retrieve is not None:
        q = stream(Store.RetrieveQuerySchema, retrieve)
        sink("retrieve", q.select(q.query, q.filepath_globpattern, result=store.retrieve_query(q).with_universe_of(q).result))
    if stats:
        sink("stats", store.statistics_query(stream(Store.StatisticsQuerySchema, [()])))
    if inputs:
        sink("inputs", store.inputs_query(stream(Store.InputsQuerySchema, [(None, None)])))
    if qa is not None:
        rag, prompts = qa
        q = stream(rag.AnswerQuerySchema, [(p, None, None) for p in prompts])
        sink("qa", q.select(q.prompt, result=rag.answer_query(q).with_universe_of(q).result))
    out["_t0"] = time.perf_counter()
    pw.run()
    sync()
    out["_t1"] = time.perf_counter()
    return out


def _hits(result) -> list[dict]:
    return list(result.value if hasattr(result, "value") else result or [])


def phase_document_store(info: dict) -> dict:
    """The DocumentStore RAG surface on the card: DS_FILES UTF-8 files of
    DS_WORDS seeded words in DS_SUBDIRS directories, read by ``pw.io.fs``
    (binary, static, with metadata) into ``DocumentStore`` with the
    ``minilm`` embedder and ``TokenCountSplitter(50, 200)`` over the default
    ``TieredKnnFactory``; DS_QUERIES ``retrieve_query`` rows (k = DS_K) in
    DS_TICK-row ticks, each the text of a known chunk, DS_GLOB_QUERIES of
    them filtered to the chunk's directory; ``statistics_query``,
    ``inputs_query`` and DS_QA prompts through ``BaseRAGQuestionAnswerer``
    with a ``FakeChatModel``. Then the same store over DS_STREAM_FILES of the
    files read in streaming mode against a static read; then
    DS_FORMAT_FILES files of each of PDF, DOCX, HTML and Markdown through
    their parsers."""
    import fnmatch
    import shutil
    import threading

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.ops import attention_kernel as A
    from pathway_tpu_torch.stdlib.indexing import tiered
    from pathway_tpu_torch.stdlib.indexing.retrievers import TieredKnnFactory
    from pathway_tpu_torch.xpacks.llm import DocumentStore, parsers
    from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder
    from pathway_tpu_torch.xpacks.llm.mocks import FakeChatModel
    from pathway_tpu_torch.xpacks.llm.question_answering import BaseRAGQuestionAnswerer
    from pathway_tpu_torch.xpacks.llm.splitters import TokenCountSplitter

    root = os.path.join(SCRATCH, "docs")
    shutil.rmtree(root, ignore_errors=True)
    rng = np.random.default_rng(0)
    vocab = [f"word{i}" for i in range(5000)]
    texts: list[tuple[str, str]] = []
    for i in range(DS_FILES):
        d = os.path.join(root, "corpus", f"d{i % DS_SUBDIRS:02d}")
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"f{i:05d}.txt")
        text = " ".join(rng.choice(vocab, size=int(rng.integers(DS_WORDS[0], DS_WORDS[1] + 1))))
        with open(path, "w", encoding="utf-8") as f:
            f.write(text)
        texts.append((path, text))
    corpus = os.path.join(root, "corpus")

    splitter = TokenCountSplitter(min_tokens=50, max_tokens=200)
    t0 = time.perf_counter()
    utf8 = parsers.Utf8Parser()
    for path, _t in texts:
        with open(path, "rb") as f:
            utf8.func(f.read())
    parse_s = time.perf_counter() - t0
    chunks = [(path, c) for path, text in texts for c, _m in splitter.func(text)]
    pick = rng.choice(len(chunks), size=DS_QUERIES, replace=False)
    queries = []
    for j, ci in enumerate(pick):
        path, c = chunks[ci]
        glob = os.path.join(os.path.dirname(path), "*") if j >= DS_QUERIES - DS_GLOB_QUERIES else None
        queries.append((c, DS_K, None, glob))
    prompts = [q[0] for q in queries[:DS_QA]]

    emb = SentenceTransformerEmbedder("minilm", seed=0, device=DEVICE)
    launch_log = _LaunchLog(emb, keep_texts=True)
    chunk_texts = {c for _p, c in chunks}

    def make_store(docs, parser=None):
        # on the card the default retriever (TieredKnnFactory at the default
        # hot bound); a CPU rehearsal names the CPU for it
        factory = None if DEVICE == "cuda" else TieredKnnFactory(embedder=emb, device=DEVICE)
        return DocumentStore(docs, retriever_factory=factory, embedder=emb, splitter=splitter,
                             **({"parser": parser} if parser is not None else {}))

    # warm-up at the launch shapes (allocator, cuBLAS), outside the counts
    emb._encoder.encode_texts([c for _p, c in chunks[:512]])
    sync()

    # --- the document store: counts from 0 ------------------------------------
    pw.G.clear()
    A.LAUNCHES = 0
    A.ROUTE_LAUNCHES.update(dict.fromkeys(A.ROUTE_LAUNCHES, 0))
    launch_log.spans.clear()
    launch_log.texts.clear()
    store = make_store(pw.io.fs.read(corpus, format="binary", mode="static", with_metadata=True))
    rag = BaseRAGQuestionAnswerer(FakeChatModel(), store, search_topk=DS_K)
    got = _ds_run(pw, store, retrieve=queries, stats=True, inputs=True, qa=(rag, prompts))
    launches, route_launches = A.LAUNCHES, dict(A.ROUTE_LAUNCHES)
    # ----------------------------------------------------------------------------
    tier = tiered.tier_stats() or {}
    pw.G.clear()
    spans = list(launch_log.spans)
    t_run0, t_run1 = got["_t0"], got["_t1"]
    check(len(spans) > 0, "document_store: the embedder never launched")
    expected = 6 * len(spans)
    check(route_launches["tensor_core"] == expected and launches == expected,
          f"document_store: bf16 attention launches {route_launches} != {expected} (6 per embedder launch)")

    # the ingest ends with the launch that embedded the last chunk
    left, t_ingest, n_ingest_launches = set(chunk_texts), None, 0
    for (_a, b, _n), batch in zip(spans, launch_log.texts):
        left.difference_update(batch)
        n_ingest_launches += 1
        if not left:
            t_ingest = b
            break
    check(t_ingest is not None, f"document_store: {len(left)} chunks were never embedded")
    t_ingest = t_ingest or t_run1

    res = list(got.get("retrieve", {}).values())
    check(len(res) == DS_QUERIES, f"document_store: {len(res)} retrieve answers, expected {DS_QUERIES}")
    # unfiltered queries get k hits; a filtered one may get fewer, as in the
    # reference: the tiered index over-fetches, then filters
    self_ok, glob_ok, glob_n, k_ok, glob_hits = 0, True, 0, True, []
    for row in res:
        query, glob, hits = row["query"], row["filepath_globpattern"], _hits(row["result"])
        self_ok += bool(hits) and hits[0]["text"] == query
        if glob:
            glob_n += 1
            glob_hits.append(len(hits))
            glob_ok &= all(fnmatch.fnmatch(h["metadata"]["path"], glob) for h in hits)
        else:
            k_ok &= len(hits) == DS_K
    check(k_ok, f"document_store: an unfiltered query got other than k={DS_K} hits")
    check(self_ok == DS_QUERIES, f"document_store: self-hits {self_ok}/{DS_QUERIES}")
    check(glob_ok and glob_n == DS_GLOB_QUERIES, f"document_store: a filtered hit outside its glob ({glob_n} filtered)")
    stats = [r["result"] for r in got.get("stats", {}).values()]
    stats = stats[0].value if stats else {}
    check(stats.get("file_count") == DS_FILES, f"document_store: statistics {stats}")
    inputs = [r["result"] for r in got.get("inputs", {}).values()]
    n_inputs = len(inputs[0].value) if inputs else 0
    check(n_inputs == DS_FILES, f"document_store: inputs_query listed {n_inputs} files")
    by_query = {r["query"]: [h["text"] for h in _hits(r["result"])] for r in res if r["filepath_globpattern"] is None}
    qa_rows = list(got.get("qa", {}).values())
    qa_ok = len(qa_rows) == DS_QA
    for row in qa_rows:
        answer, want = row["result"], by_query.get(row["prompt"], [])
        pos = [answer.find(t) for t in want]
        qa_ok &= len(want) == DS_K and all(p >= 0 for p in pos) and pos == sorted(pos)
    check(qa_ok, f"document_store: {len(qa_rows)} QA answers, or a prompt without its {DS_K} texts in order")

    # the streaming leg: DS_STREAM_FILES files read in streaming mode against
    # the static read of the same files, the same queries
    stream_root = os.path.join(root, "stream")
    picked = texts[:DS_STREAM_FILES]
    for path, text in picked:
        dest = os.path.join(stream_root, os.path.relpath(path, corpus))
        os.makedirs(os.path.dirname(dest), exist_ok=True)
        shutil.copy(path, dest)
    s_chunks = [c for _p, t in picked for c, _m in splitter.func(t)]
    s_queries = [(c, DS_K, None, None) for c in s_chunks[:: max(1, len(s_chunks) // DS_STREAM_QUERIES)][:DS_STREAM_QUERIES]]
    pw.G.clear()
    static = _ds_run(pw, make_store(pw.io.fs.read(stream_root, format="binary", mode="static", with_metadata=True)),
                     retrieve=s_queries)
    pw.G.clear()
    ingested = threading.Event()
    count = [0]

    class Queries(pw.io.python.ConnectorSubject):
        def run(self):
            ingested.wait(timeout=600)
            time.sleep(1.0)  # past the microbatcher's flush deadline
            for lo in range(0, len(s_queries), DS_TICK):
                for q in s_queries[lo : lo + DS_TICK]:
                    self.next(query=q[0], k=q[1], metadata_filter=None, filepath_globpattern=None)
                time.sleep(0.05)

    def on_chunk(key, row, time, is_addition):
        count[0] += 1 if is_addition else -1
        if count[0] >= len(s_chunks):
            ingested.set()

    live = make_store(pw.io.fs.read(stream_root, format="binary", with_metadata=True, _bounded=True))
    pw.io.subscribe(live.chunked_docs, on_chunk)
    lq = pw.io.python.read(Queries(), schema=DocumentStore.RetrieveQuerySchema)
    streamed: dict = {}
    pw.io.subscribe(
        lq.select(lq.query, result=live.retrieve_query(lq).with_universe_of(lq).result),
        lambda key, row, time, is_addition: streamed.__setitem__(row["query"], row["result"]) if is_addition else None,
    )
    t0 = time.perf_counter()
    pw.run()
    stream_s = time.perf_counter() - t0
    pw.G.clear()
    pairs = lambda r: [(h["text"], h["dist"]) for h in _hits(r)]  # noqa: E731
    s_static = {r["query"]: pairs(r["result"]) for r in static.get("retrieve", {}).values()}
    s_live = {q: pairs(r) for q, r in streamed.items()}
    stream_same = len(s_static) == len(s_queries) and s_static == s_live
    check(stream_same, f"document_store: streaming read answers differ from the static read's "
          f"({len(s_live)}/{len(s_static)} answered, {sum(s_static.get(q) != s_live.get(q) for q in s_static)} differ)")

    # the parsers leg: each format's files through its parser, each marker
    # phrase retrieved first
    made = _format_files(os.path.join(root, "formats"), DS_FORMAT_FILES, rng)
    fmt_out = {}
    parser_of = {"pdf": parsers.PypdfParser, "docx": parsers.DocxParser, "html": parsers.HtmlParser, "md": parsers.MarkdownParser}
    for fmt, files in made.items():
        p = parser_of[fmt]()
        t0 = time.perf_counter()
        for path, _phrase in files:
            with open(path, "rb") as f:
                p.func(f.read())
        fmt_parse_s = time.perf_counter() - t0
        pw.G.clear()
        fstore = make_store(pw.io.fs.read(os.path.join(root, "formats", fmt), format="binary", mode="static",
                                          with_metadata=True), parser=p)
        r = _ds_run(pw, fstore, retrieve=[(phrase, 1, None, None) for _path, phrase in files])
        pw.G.clear()
        want = {phrase: path for path, phrase in files}
        first = sum(1 for row in r.get("retrieve", {}).values()
                    if _hits(row["result"]) and _hits(row["result"])[0]["metadata"]["path"] == want.get(row["query"]))
        check(first == len(files), f"document_store: {fmt} marker phrases retrieved first {first}/{len(files)}")
        fmt_out[fmt] = {"files": len(files), "parse_files_per_s": len(files) / fmt_parse_s, "marker_first": first}

    query_rows = DS_QUERIES + 2 + DS_QA
    out = {
        "card": info["nvidia_smi"],
        "files": DS_FILES, "subdirs": DS_SUBDIRS, "words_per_file": list(DS_WORDS),
        "utf8_parse_files_per_s": DS_FILES / parse_s,
        "chunks": len(chunks),
        "tier": {k: tier.get(k) for k in ("backends", "hot_rows", "hot_bound", "cold_rows", "hot_device_bytes")},
        "run_s": t_run1 - t_run0,
        "ingest_s": t_ingest - t_run0,
        "ingest_chunks_per_s": len(chunks) / (t_ingest - t_run0),
        "query_rows": query_rows,
        "query_s": t_run1 - t_ingest,
        "query_rows_per_s": query_rows / (t_run1 - t_ingest),
        "embed_launches": len(spans),
        "embed_ingest_launches": n_ingest_launches,
        "embed_buckets": _buckets(spans),
        "attention_launches": launches,
        "attention_launches_by_route": route_launches,
        "attention_launches_expected": expected,
        "self_hits": self_ok,
        "glob_queries": glob_n,
        "glob_hits_mean": float(np.mean(glob_hits)) if glob_hits else None,
        "glob_hits_inside": glob_ok,
        "statistics_file_count": stats.get("file_count"),
        "inputs_listed": n_inputs,
        "qa_prompts_with_k_texts_in_order": qa_ok,
        "stream_files": DS_STREAM_FILES,
        "stream_queries": len(s_queries),
        "stream_equals_static": stream_same,
        "stream_run_s": stream_s,
        "formats": fmt_out,
    }
    emit("document_store", **out)
    # the corpus stays on disk for phase rest_serving, which removes it
    answers = {(r["query"], r["filepath_globpattern"]): _hits(r["result"]) for r in res}
    return {"launches": route_launches, "metrics": out, "root": root, "corpus": corpus, "queries": queries,
            "prompts": prompts, "answers": answers, "chunks": len(chunks), "emb": emb, "launch_log": launch_log,
            "splitter": splitter, "chunk_list": chunks}


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _wait_listening(port: int, timeout: float = 60.0) -> None:
    import socket

    deadline = time.monotonic() + timeout
    while True:
        try:
            socket.create_connection(("127.0.0.1", port), timeout=1.0).close()
            return
        except OSError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.02)


class _Http:
    """One keep-alive ``http.client`` connection to the server on ``port``."""

    def __init__(self, port: int):
        import http.client

        self.conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)

    def call(self, method: str, path: str, payload=None) -> tuple:
        """(status, the JSON body parsed, seconds on the host clock, the
        ``X-Pathway-Request-Id`` header, the ``Retry-After`` header)."""
        body = None if payload is None else json.dumps(payload).encode()
        t0 = time.perf_counter()
        self.conn.request(method, path, body=body, headers={"Content-Type": "application/json"} if body else {})
        resp = self.conn.getresponse()
        data = resp.read()
        took = time.perf_counter() - t0
        rid, retry = resp.getheader("X-Pathway-Request-Id"), resp.getheader("Retry-After")
        if resp.getheader("Connection") == "close":
            self.conn.close()
        try:
            return resp.status, json.loads(data), took, rid, retry
        except ValueError:
            return resp.status, data, took, rid, retry

    def close(self) -> None:
        self.conn.close()


def _fan_out(port: int, jobs: list, clients: int) -> list:
    """``jobs`` ((method, path, payload) each) from ``clients`` threads, each
    on its own keep-alive connection and sending its share in turn (job i
    from client i mod clients); the answers in job order."""
    import threading

    results: list = [None] * len(jobs)
    start = threading.Barrier(clients)

    def client(c: int) -> None:
        http = _Http(port)
        try:
            start.wait(timeout=60)
            for i in range(c, len(jobs), clients):
                results[i] = http.call(*jobs[i])
        except Exception as e:  # reported by the gate as a missing answer
            print(f"rest_serving: client {c}: {e!r}", file=sys.stderr, flush=True)
        finally:
            http.close()

    threads = [threading.Thread(target=client, args=(c,), daemon=True) for c in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    return results


def _route_counts(state) -> tuple:
    return list(state.latency.snapshot()["counts"]), state.batches_total, state.batched_rows_total


def _server_leg(before: tuple, after: tuple) -> dict:
    """The route's server-side numbers over one leg: arrival-to-response
    quantiles (the histogram's bucket bounds) and rows per resolution pass."""
    from pathway_tpu_torch.observability.metrics import Histogram

    counts = [a - b for a, b in zip(after[0], before[0])]
    snap = {"counts": counts, "count": sum(counts)}
    batches, rows = after[1] - before[1], after[2] - before[2]
    return {
        "latency_p50_s": Histogram.quantile(snap, 0.5),
        "latency_p99_s": Histogram.quantile(snap, 0.99),
        "mean_batch": rows / batches if batches else None,
        "batches": batches,
    }


def _client_leg(answers: list, wall_s: float) -> dict:
    took = [a[2] for a in answers if a is not None]
    return {
        "requests": len(answers),
        "wall_s": wall_s,
        "requests_per_s": len(answers) / wall_s,
        "client_p50_ms": float(np.percentile(took, 50)) * 1e3 if took else None,
        "client_p99_ms": float(np.percentile(took, 99)) * 1e3 if took else None,
    }


def _comparable(hits) -> str:
    """A retrieve answer as JSON text, without the fs connector's ``seen_at``
    (the wall-clock second the file was read, which differs between runs);
    floats print as their shortest repr, so equal text is equal bits."""
    from pathway_tpu_torch.io.http._server import _jsonable

    return json.dumps([
        {**h, "metadata": {k: v for k, v in h["metadata"].items() if k != "seen_at"}}
        for h in _jsonable(list(hits))
    ])


def _first_difference(got, want) -> str:
    """Where a REST answer first departs from the in-process one."""
    if not isinstance(got, list) or want is None:
        return f"answer {str(got)[:200]!r}, in-process {str(want)[:200]!r}"
    got, want = json.loads(_comparable(got)), json.loads(_comparable(want))
    if len(got) != len(want):
        return f"{len(got)} hits, in-process {len(want)}"
    for i, (g, w) in enumerate(zip(got, want)):
        for field in sorted(set(g) | set(w)):
            if g.get(field) != w.get(field):
                return f"hit {i} {field}: {str(g.get(field))[:120]!r} != in-process {str(w.get(field))[:120]!r}"
    return "equal"


def _diagnose_embed(emb, texts: list[str], others: list[str]) -> list[dict]:
    """For each of ``texts``: its token count, and whether the embedder gives
    it the same bits in an 8-row launch (the microbatcher's smallest bucket,
    pad rows repeating it) as at the head of a 512-row launch of ``others``,
    with the first traced op that differs."""
    from pathway_tpu_torch.tools.batch_invariance import PRELN_OPS, _launch_check

    enc = emb._encoder
    out = []
    for t in texts:
        batch = [t] + [o for o in others if o != t][:511]
        got = _launch_check(enc, batch, [t] * 8, 1, "d", PRELN_OPS)
        out.append({"tokens": int((enc.tokenizer([t])[0] != 0).sum()), "same_bits": got[f"d_embed_1_rows_vs_{len(batch)}"],
                    "first_differing_op": got["d_first_differing_op"], "seq_len": got["d_seq_len"]})
    return out


def _stop_run(run, timeout: float = 120.0) -> None:
    import pathway_tpu_torch as pw

    rt = pw.internals.run.current_runtime()
    if rt is not None:
        rt.request_stop()
    run.join(timeout=timeout)
    check(not run.is_alive(), "rest_serving: a server's pw.run did not stop")


def _encoder_calls() -> int:
    """The device plane's count of traced encoder calls (``encoder.encode``
    and ``encoder.encode_ids``; the hash tokenizer's pad id is 0, so the
    embedder takes ``encoder.encode_ids``)."""
    from pathway_tpu_torch.observability import device as D

    view = D._callables_view()
    return sum((view.get(label) or {}).get("calls") or 0 for label in ("encoder.encode", "encoder.encode_ids"))


def _encoder_tokens() -> int:
    """Real plus pad tokens the encoder launched this run (the device plane)."""
    from pathway_tpu_torch.observability import device as D

    with D.stats().lock:
        ent = D.stats().pad.get("encoder", [0, 0, 0, 0])
    return ent[2] + ent[3]


def _leg_counts(launch_log) -> tuple:
    """What a leg's call gates difference: the phase's own launch count, the
    traced encoder calls, the attention kernel's route launches, the
    encoder's launched tokens."""
    from pathway_tpu_torch.ops import attention_kernel as A

    return len(launch_log.spans), _encoder_calls(), dict(A.ROUTE_LAUNCHES), _encoder_tokens()


def _check_leg_calls(leg: str, before: tuple, after: tuple, launch_log, emb, layers: int) -> dict:
    """Per leg: traced encoder calls == the launches the phase counts; the
    bf16 route's launches == layers x those calls; the encoder's launched
    tokens == sum over the leg's launches of rows x padded length."""
    spans, calls = after[0] - before[0], after[1] - before[1]
    attn = after[2]["tensor_core"] - before[2]["tensor_core"]
    tokens = after[3] - before[3]
    shapes = [emb._encoder.tokenizer(batch)[0].shape for batch in launch_log.texts[before[0]:after[0]]]
    want_tokens = sum(int(r) * int(L) for r, L in shapes)
    check(spans > 0 and calls == spans, f"{leg}: traced encoder calls {calls} != the phase's {spans} launches")
    check(attn == layers * calls, f"{leg}: bf16 attention launches {attn} != {layers} x {calls} encoder calls")
    check(tokens == want_tokens, f"{leg}: the encoder launched {tokens} tokens, buckets x lengths = {want_tokens}")
    return {"embed_launches": spans, "encoder_calls": calls, "attention_launches": attn,
            "encoder_tokens": tokens, "buckets_x_lengths": want_tokens}


def _serve_store(ds: dict, port: int, mode: str = "static", rows_probe: list | None = None,
                 poll_statistics: bool = True) -> tuple:
    """``QARestServer`` over a fresh ``DocumentStore`` on phase document_store's
    files (``pw.io.fs.read`` in ``mode``), run with the monitoring server
    (``PATHWAY_MONITORING_HTTP_PORT``) until ingest finishes:
    ``/v1/statistics`` counts every file (polled every 50 ms, unless
    ``poll_statistics`` is false) and both index nodes hold every chunk.
    Returns (the run thread, the routes' serving states, ingest numbers, the
    statistics calls sent); ``rows_probe`` gets the function that counts
    the rows of this server's index nodes."""
    import gc

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.stdlib.indexing import tiered
    from pathway_tpu_torch.stdlib.indexing.retrievers import TieredKnnFactory
    from pathway_tpu_torch.xpacks.llm import DocumentStore
    from pathway_tpu_torch.xpacks.llm.mocks import FakeChatModel
    from pathway_tpu_torch.xpacks.llm.question_answering import BaseRAGQuestionAnswerer

    emb = ds["emb"]
    pw.G.clear()
    gc.collect()
    with tiered._registry_lock:
        earlier = {id(b) for b in tiered._live_tiered}

    def new_index_rows() -> int:
        with tiered._registry_lock:
            live = [b for b in tiered._live_tiered if id(b) not in earlier]
        return sum(b.stats()["hot_rows"] + b.stats()["cold_rows"] for b in live)

    factory = None if DEVICE == "cuda" else TieredKnnFactory(embedder=emb, device=DEVICE)
    store = DocumentStore(
        pw.io.fs.read(ds["corpus"], format="binary", mode=mode, with_metadata=True),
        retriever_factory=factory, embedder=emb, splitter=ds["splitter"],
    )
    rag = BaseRAGQuestionAnswerer(FakeChatModel(), store, search_topk=DS_K)
    rag.build_server("127.0.0.1", port)
    routes = {st.route: st for st in rag.server.webserver._route_states()}
    if rows_probe is not None:
        rows_probe.append(new_index_rows)
    t0 = time.perf_counter()
    run = rag.run_server(threaded=True, with_http_server=True)
    _wait_listening(port)
    http = _Http(port)
    files_s = indexed_s = None
    stats_calls = 0
    deadline = time.monotonic() + 900
    while poll_statistics and time.monotonic() < deadline and files_s is None:
        status, stats, *_ = http.call("POST", "/v1/statistics", {})
        stats_calls += 1
        if status == 200 and stats.get("file_count") == DS_FILES:
            files_s = time.perf_counter() - t0
        else:
            time.sleep(0.05)
    http.close()
    # /v1/retrieve and /v2/answer each query their own index node
    while time.monotonic() < deadline and indexed_s is None:
        if new_index_rows() >= 2 * ds["chunks"]:
            indexed_s = time.perf_counter() - t0
        else:
            time.sleep(0.02)
    check((files_s is not None or not poll_statistics) and indexed_s is not None,
          f"rest_serving: ingest never finished (files at {files_s}, index rows {new_index_rows()})")
    check(new_index_rows() == 2 * ds["chunks"],
          f"rest_serving: the index nodes hold {new_index_rows()} rows, expected 2 x {ds['chunks']}")
    ingest = {"ingest_files_s": files_s, "ingest_s": indexed_s,
              "ingest_chunks_per_s": ds["chunks"] / indexed_s if indexed_s else None}
    return run, routes, ingest, stats_calls


def _retrieve_leg(port: int, ds: dict, clients: int, retrieve, diagnose: dict, leg: str) -> tuple[dict, list]:
    """The document_store phase's retrieve payloads from ``clients`` clients,
    each answer held against the in-process one; (the leg's numbers, the
    answers)."""
    jobs = [("POST", "/v1/retrieve", {"query": q, "k": k, "metadata_filter": m, "filepath_globpattern": g})
            for q, k, m, g in ds["queries"]]
    want = {key: _comparable(hits) for key, hits in ds["answers"].items()}
    before = _route_counts(retrieve)
    t1 = time.perf_counter()
    got = _fan_out(port, jobs, clients)
    wall = time.perf_counter() - t1
    differing = [
        i for i, ((_m, _p, body), ans) in enumerate(zip(jobs, got))
        if ans is None or ans[0] != 200
        or _comparable(ans[1]) != want.get((body["query"], body["filepath_globpattern"]))
    ]
    same = len(jobs) - len(differing)
    if differing:
        body, ans = jobs[differing[0]][2], got[differing[0]]
        print(f"{leg}: first differing retrieve answer:",
              _first_difference(ans[1] if ans else None,
                                ds["answers"].get((body["query"], body["filepath_globpattern"]))),
              file=sys.stderr, flush=True)
        diagnose[f"retrieve_{clients}_clients_diagnosis"] = [jobs[i][2]["query"] for i in differing[:4]]
    check(same == len(jobs), f"{leg}: {same}/{len(jobs)} retrieve answers at {clients} "
          "client(s) equal the in-process answers")
    return {**_client_leg(got, wall), "equal_to_in_process": same,
            "server": _server_leg(before, _route_counts(retrieve))}, got


def _get(port: int, path: str) -> tuple:
    """(status, body, headers) of one GET; the body parsed when it is JSON."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        data = resp.read()
        hdrs = {k.lower(): v for k, v in resp.getheaders()}
    finally:
        conn.close()
    try:
        return resp.status, json.loads(data), hdrs
    except ValueError:
        return resp.status, data.decode(errors="replace"), hdrs


def _card_component_bytes() -> dict:
    """Registered device bytes per component, over the owners whose tensors
    are on the card (an owner on the CPU counts in the plane's gauge, but
    not on the card's allocator). ``knn_cold`` is the tiered index's host
    IVF tier, registered as the reference registers it, and is not on the
    card."""
    from pathway_tpu_torch.observability import device as D

    out: dict = {}
    with D._memory_lock:
        providers = list(D._memory_providers)
    for component, ref, fn in providers:
        owner = ref()
        dev = getattr(owner, "device", None)
        if owner is None or component == "knn_cold" or getattr(dev, "type", dev) != "cuda":
            continue
        out[component] = out.get(component, 0) + int(fn(owner))
    return out


def _metric_value(text: str, series: str) -> float | None:
    for line in text.splitlines():
        if line.startswith(series + " "):
            return float(line.rsplit(" ", 1)[1])
    return None


#: profiler windows armed at most, one after another, until one's ticks hold
#: a launch: arrivals wake the engine within 2 ms, and a row waits in the
#: microbatcher until its flush deadline, so under concurrent clients most
#: ticks only buffer rows and a 4-tick window can miss every launch
PROFILE_WINDOWS = 8
#: the clients sending while a window is open: one client alternates an
#: arrival tick and a launch tick
PROFILE_CLIENTS = 1


def _trace_kernels(trace: str) -> tuple[int, list[str]]:
    """(kernel events, the attention kernel's symbols) of a Chrome trace."""
    with open(trace) as fh:
        events = json.load(fh).get("traceEvents", [])
    names = [ev.get("name", "") for ev in events if ev.get("cat") == "kernel"]
    return len(names), sorted({n for n in names if "attention_tc_kernel" in n})


def _profiler_window(port: int, mon_port: int, ds: dict) -> dict:
    """``/profile?ticks=4`` armed while PROFILE_CLIENTS clients keep sending
    retrieve requests: each window closes by itself, and a window's Chrome
    trace names the attention kernel's symbol from ``csrc/attention_short.cu``
    (windows are armed one after another, up to PROFILE_WINDOWS, until one
    does)."""
    import threading

    from pathway_tpu_torch.observability import device as D

    prof_dir = os.path.join(SCRATCH, "profile")
    os.makedirs(prof_dir, exist_ok=True)
    queries = [(q, k) for q, k, _m, _g in ds["queries"]]
    stop = threading.Event()
    answered: list = []

    def client(c: int) -> None:
        http = _Http(port)
        try:
            i = c
            while not stop.is_set():
                q, k = queries[i % len(queries)]
                answered.append(http.call("POST", "/v1/retrieve", {"query": q, "k": k})[0])
                i += PROFILE_CLIENTS
        finally:
            http.close()

    threads = [threading.Thread(target=client, args=(c,), daemon=True) for c in range(PROFILE_CLIENTS)]
    for t in threads:
        t.start()
    windows: list = []
    symbol: list = []
    try:
        deadline = time.monotonic() + 120
        while len(answered) < 4 * PROFILE_CLIENTS and time.monotonic() < deadline:
            time.sleep(0.01)  # the traffic is flowing before a window opens
        while len(windows) < PROFILE_WINDOWS and not symbol and time.monotonic() < deadline:
            before = len(answered)
            armed = _get(mon_port, f"/profile?ticks=4&dir={prof_dir}")
            state = armed
            while time.monotonic() < deadline:
                state = _get(mon_port, "/profile")
                if state[0] == 200 and state[1].get("window") is None:
                    break
                time.sleep(0.02)
            trace = D.last_trace()
            closed = armed[0] == 200 and armed[1].get("ok") is True and armed[1].get("ticks") == 4 \
                and state[0] == 200 and state[1].get("window") is None and trace is not None
            kernels, symbol = _trace_kernels(trace) if closed else (0, [])
            windows.append({"closed_by_itself": closed, "kernel_events": kernels,
                            "answers_while_open": len(answered) - before,
                            "trace_bytes": os.path.getsize(trace) if closed else None})
            if not closed:
                break
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=120)
    check(bool(windows) and all(w["closed_by_itself"] for w in windows),
          f"observability: a /profile?ticks=4 window did not close by itself: {windows}")
    check(bool(symbol), f"observability: no profiler window named attention_tc_kernel in {len(windows)}: {windows}")
    return {"windows": windows, "attention_symbols": symbol[:4],
            "trace_file": os.path.relpath(D.last_trace(), os.path.dirname(SCRATCH)) if D.last_trace() else None}


#: retrieve answers of the RS_CLIENTS-client leg explained on /explain, the
#: newest first: the lineage rings keep each edge's newest
#: PATHWAY_LINEAGE_KEYS (default 4,096) output keys, so an older answer's
#: chunk edges may be evicted
EXPLAIN_ANSWERS = 64
#: the key-deriving operators a retrieve answer's walk back to its source
#: file crosses: parse and split (``flatten``), the join of its hits with the
#: chunks (``ix``) and the regrouping of its hits (``groupby``); the index
#: (``external_index``) keeps the query's key and is on the walk too
EXPLAIN_OPERATORS = ("flatten", "ix", "groupby")


def _audit_timeline_gates(mon_port: int, ds: dict, answers: list, leg_t0: float, leg_t1: float) -> dict:
    """The audit and timeline planes on the served store (both on by default):
    no violation and no shadow divergence; ``/status`` with the ``audit``,
    ``timeline`` and ``bottleneck`` sections; per-edge cardinality on
    ``/metrics`` with the fs input edge's rows out equal to the files and each
    index's docs edge's rows out equal to the chunks; ``/explain`` on
    retrieve answers naming their hits' source files through parse, split,
    index and join; ``/timeline?metric=`` with the retrieve route's rate at two
    or more points inside the RS_CLIENTS-client leg."""
    import pathway_tpu_torch as pw

    st, status, _h = _get(mon_port, "/status")
    metrics = _get(mon_port, "/metrics")[1]
    audit = status.get("audit", {}) if st == 200 else {}
    check(st == 200 and all(k in status for k in ("audit", "timeline", "bottleneck")),
          f"rest_serving: /status sections {sorted(status) if st == 200 else st} lack audit, timeline or bottleneck")
    check(audit.get("enabled") is True and audit.get("violations_total") == 0 and audit.get("divergences") == 0
          and audit.get("shadow_ticks", 0) > 0,
          f"rest_serving: audit violations {audit.get('violations_by_kind')}, divergences {audit.get('divergences')}, "
          f"shadow ticks {audit.get('shadow_ticks')}")
    # per-edge cardinality: the fs input and each index's docs edge
    graph = pw.internals.run.current_runtime().scheduler.graph
    fs_ids = [n.node_index for n in graph.nodes if n.name == "static_input"]
    docs_ids = [src for src, conns in graph.edges.items() for ci, port in conns
                if graph.nodes[ci].name == "external_index" and port == 0]
    fs_rows = [_metric_value(metrics, f'pathway_operator_rows_total{{op="static_input",id="{i}",dir="out"}}')
               for i in fs_ids]
    docs_rows = [_metric_value(metrics, f'pathway_operator_rows_total{{op="{graph.nodes[i].name}",id="{i}",dir="out"}}')
                 for i in docs_ids]
    check(fs_rows == [DS_FILES] and len(docs_rows) == 2 and all(r == ds["chunks"] for r in docs_rows),
          f"rest_serving: /metrics edge rows: fs input {fs_rows} (files {DS_FILES}), index docs edges {docs_rows} "
          f"(chunks {ds['chunks']})")
    # /explain: a retrieve answer's key, walked back to its hits' files
    listing = _get(mon_port, "/explain")[1]
    sinks = listing.get("sinks", []) if isinstance(listing, dict) else []
    explained, named, walked = 0, 0, None
    for ans in reversed([a for a in answers if a is not None and a[0] == 200 and a[3]][-EXPLAIN_ANSWERS:]):
        paths = {h["metadata"]["path"] for h in ans[1]}
        for sink in sinks:
            stx, doc, _h = _get(mon_port, f"/explain?sink={sink}&key=0x{ans[3]}")
            if stx == 200 and doc.get("ok") and doc.get("output") is not None:
                break
        else:
            continue
        explained += 1
        ops = {p["operator"] for p in doc["path"] if p["derives_keys"]}
        ops_seen = {p["operator"] for p in doc["path"]}
        found = set()
        for i in doc["inputs"]:
            md = i["row"].get("_metadata")
            if isinstance(md, str):
                md = json.loads(md)
            if isinstance(md, dict) and md.get("path") in paths:
                found.add(md["path"])
        if found and all(op in ops for op in EXPLAIN_OPERATORS) and "external_index" in ops_seen:
            named += 1
            if walked is None:
                walked = {"sink": doc["sink"], "key": doc["key"], "hits": len(paths), "files_named": len(found),
                          "operators": [p["operator"] for p in doc["path"]],
                          "inputs": sorted({i["input"] for i in doc["inputs"]})}
    check(named > 0, f"rest_serving: /explain named no retrieve answer's source file ({explained} answers "
                     f"explained of the newest {EXPLAIN_ANSWERS}, sinks {sinks})")
    # /timeline: the retrieve route's rate during the RS_CLIENTS-client leg
    tl = _get(mon_port, f"/timeline?metric=route_qps:/v1/retrieve&since={leg_t0 - 1.0}")[1]
    inside = [p for p in tl.get("points", []) if leg_t0 <= p["t"] <= leg_t1 + 1.0 and p["v"] > 0]
    check(len(inside) >= 2, f"rest_serving: /timeline has {len(inside)} retrieve-rate points inside the "
                            f"{RS_CLIENTS}-client leg ({len(tl.get('points', []))} since its start)")
    return {"audit": {k: audit.get(k) for k in ("mode", "sample", "violations_total", "divergences", "shadow_ticks",
                                                "lineage")},
            "edge_rows": {"fs_input": fs_rows, "index_docs": docs_rows},
            "explain": {"explained": explained, "named_source_file": named, "first": walked},
            "timeline": {"status": status.get("timeline"), "retrieve_rate_points": inside},
            "bottleneck": status.get("bottleneck")}


def phase_rest_serving(info: dict, ds: dict) -> dict:
    """The live-RAG store over HTTP at the port's defaults, which are the
    reference's: the device, request-trace and health planes on, and the
    monitoring server on a port of its own. Phase document_store's DS_FILES
    files (still on disk) served by ``QARestServer`` over ``DocumentStore``
    (the ``minilm`` embedder, the default ``TieredKnnFactory``) and
    ``BaseRAGQuestionAnswerer(FakeChatModel())`` on 127.0.0.1. Waits for
    ingest (``/v1/statistics`` reports every file, and both index nodes hold
    every chunk); sends phase document_store's DS_QUERIES retrieve payloads
    as JSON POSTs from 1 client and from RS_CLIENTS concurrent clients over
    keep-alive connections, each answer held against that phase's in-process
    answer (texts, metadata, score bits); DS_QA ``/v2/answer`` requests, each
    prompt holding its DS_K texts in order; ``/v1/inputs``,
    ``/v2/list_documents``, ``/_schema``, ``/healthz`` and ``/readyz``.
    The planes' gates (``_audit_timeline_gates`` for the audit and timeline
    planes): a unique ``X-Pathway-Request-Id`` on every answer and
    the flight path of every kept id on ``/request?id=`` (microbatch and
    index stages); canaries counted and never in a route's counters;
    ``/readyz`` 503 with ``Retry-After`` while the door drains; the hot
    shard's tensor bytes on ``/metrics``, ``knn_cold`` registered, the CUDA
    allocator at least the card's registered bytes; per leg, traced encoder
    calls == the phase's launches, attention launches == 6 x calls, launched
    tokens == buckets x lengths; a ``/profile?ticks=4`` window that closes
    by itself and names the kernel. Then, on the same port, a shed leg (one
    route, ``PATHWAY_SERVE_MAX_INFLIGHT`` = RS_SHED_INFLIGHT,
    RS_SHED_REQUESTS concurrent requests: 429s + 200s equal the requests
    and the route's counters) and a lifecycle leg (RS_PENDING requests
    pending at ``stop()`` each get 503, then a restart on the same port
    answers). Between them, ``batch_invariance.length_check`` on the
    embedder: a text gets the same bits in launches padded to 64, 128, 256
    and 512 tokens. Phase document_store's files stay for phase
    observability."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.observability import device as D
    from pathway_tpu_torch.observability import health as H
    from pathway_tpu_torch.observability import requests as R
    from pathway_tpu_torch.ops import attention_kernel as A
    from pathway_tpu_torch.stdlib.indexing import tiered

    emb, launch_log = ds["emb"], ds["launch_log"]
    layers = emb._encoder.cfg.n_layers
    port, mon_port = _free_port(), _free_port()
    os.environ["PATHWAY_MONITORING_HTTP_PORT"] = str(mon_port)
    out: dict = {"card": info["nvidia_smi"], "files": DS_FILES, "chunks": ds["chunks"],
                 "planes": {"profile": "on", "request_trace": "on", "health": "on", "audit": "on", "timeline": "on",
                            "monitoring_port": mon_port}}
    diagnose: dict = {}  # leg -> texts whose answer differed, embedded again once the counts are read
    # --- the QA server: counts from 0 -------------------------------------
    A.LAUNCHES = 0
    A.ROUTE_LAUNCHES.update(dict.fromkeys(A.ROUTE_LAUNCHES, 0))
    launch_log.spans.clear()
    launch_log.texts.clear()
    run, routes, ingest, stats_calls = _serve_store(ds, port)
    out.update(ingest)
    try:
        ids: list = []
        # retrieve: the document_store phase's payloads, 1 then RS_CLIENTS clients
        retrieve = routes["/v1/retrieve"]
        for clients in (1, RS_CLIENTS):
            c0 = _leg_counts(launch_log)
            leg_t0 = time.time()
            leg, got = _retrieve_leg(port, ds, clients, retrieve, diagnose, "rest_serving")
            leg_t1 = time.time()
            leg["calls"] = _check_leg_calls(f"rest_serving retrieve {clients}", c0, _leg_counts(launch_log),
                                            launch_log, emb, layers)
            out[f"retrieve_{clients}_clients"] = leg
            ids += [a[3] if a is not None else None for a in got]
        # the audit and timeline planes, read right after the RS_CLIENTS leg
        # (the lineage rings then hold its answers)
        out["audit_timeline"] = _audit_timeline_gates(mon_port, ds, got, leg_t0, leg_t1)

        # answer: each prompt holds its DS_K retrieved texts in order
        answer = routes["/v2/answer"]
        before = _route_counts(answer)
        c0 = _leg_counts(launch_log)
        t1 = time.perf_counter()
        got = _fan_out(port, [("POST", "/v2/answer", {"prompt": p}) for p in ds["prompts"]], RS_CLIENTS)
        wall = time.perf_counter() - t1
        in_order = 0
        for p, ans in zip(ds["prompts"], got):
            texts = [h["text"] for h in ds["answers"][(p, None)]]
            pos = [ans[1].find(t) for t in texts] if ans is not None and ans[0] == 200 else [-1]
            in_order += len(texts) == DS_K and min(pos) >= 0 and pos == sorted(pos)
        check(in_order == len(ds["prompts"]),
              f"rest_serving: {in_order}/{len(ds['prompts'])} answers hold their {DS_K} texts in order")
        out["answer"] = {**_client_leg(got, wall), "prompts_with_k_texts_in_order": in_order,
                         "server": _server_leg(before, _route_counts(answer)),
                         "calls": _check_leg_calls("rest_serving answer", c0, _leg_counts(launch_log),
                                                   launch_log, emb, layers)}
        ids += [a[3] if a is not None else None for a in got]

        # request ids: one on every answer, unique; every kept id's flight path
        check(all(ids) and len(set(ids)) == len(ids),
              f"rest_serving: {sum(1 for i in ids if i)} of {len(ids)} answers carry a request id, "
              f"{len(set(i for i in ids if i))} distinct")
        # a kept /v1/retrieve or /v2/answer flight embeds its query and
        # searches the index; a kept /v1/statistics flight (slow while the
        # ingest ticks run) does neither
        listing = _get(mon_port, "/request")
        kept = listing[1].get("kept_ids", []) if listing[0] == 200 else []
        paths_ok, stage_names, kept_routes, missing = 0, set(), {}, []
        for rid in kept:
            st, doc, _h = _get(mon_port, f"/request?id={rid}")
            names = [s["name"] for s in doc.get("spans", [])] if st == 200 else []
            route = doc.get("route") if st == 200 else None
            kept_routes[route] = kept_routes.get(route, 0) + 1
            stage_names.update(names)
            ok = doc.get("ok") is True and doc.get("kept") is True and "serve/admission" in names
            if route in ("/v1/retrieve", "/v2/answer"):
                ok = ok and rid in ids and any(n.startswith("microbatch/") for n in names) and "index/search" in names
            paths_ok += ok
            if not ok:
                missing.append({"id": rid, "route": route, "status": doc.get("status"), "stages": names})
        check(len(kept) > 0 and paths_ok == len(kept),
              f"rest_serving: {paths_ok}/{len(kept)} kept request ids have their flight path "
              f"(the query routes' with the microbatch and index stages): {missing[:2]}")
        unknown = "ffffffffffffffff"
        st, doc, _h = _get(mon_port, f"/request?id={unknown}")
        check(st == 200 and doc.get("ok") is False and doc.get("error") == f"unknown request '{unknown}'",
              f"rest_serving: /request?id= of an unknown id answered {st} {doc}")
        summary = R.current().status_summary()
        out["request_trace"] = {"ids": len(ids), "distinct": len(set(ids)), "kept": len(kept),
                                "kept_by_route": kept_routes, "kept_with_flight_path": paths_ok,
                                "summary": summary, "stages": sorted(stage_names)}

        http = _Http(port)
        status_i, inputs, *_ = http.call("POST", "/v1/inputs", {})
        status_l, listed, *_ = http.call("POST", "/v2/list_documents", {})
        status_s, spec, *_ = http.call("GET", "/_schema")
        health = [http.call("GET", p)[:2] for p in ("/healthz", "/readyz")]
        http.close()
        n_inputs = len(inputs) if status_i == 200 else None
        n_listed = len(listed) if status_l == 200 else None
        check(n_inputs == DS_FILES and n_listed == DS_FILES,
              f"rest_serving: /v1/inputs listed {n_inputs}, /v2/list_documents {n_listed} files")
        check(status_s == 200 and set(spec.get("paths", {})) == set(routes),
              f"rest_serving: /_schema paths {sorted(spec.get('paths', {})) if status_s == 200 else status_s}")
        check(health == [(200, {"alive": True, "state": "ready"}), (200, {"ready": True, "state": "ready"})],
              f"rest_serving: /healthz, /readyz answered {health}")
        launches, route_launches, spans = A.LAUNCHES, dict(A.ROUTE_LAUNCHES), list(launch_log.spans)

        # health: canaries counted, never in the routes' counters
        canary = H.current().canary_snapshot()
        sent = {"/v1/retrieve": 2 * len(ds["queries"]), "/v2/answer": len(ds["prompts"]),
                "/v1/statistics": stats_calls, "/v1/inputs": 1, "/v2/list_documents": 1}
        totals = {r: routes[r].requests_total for r in sent}
        check(totals == sent, f"rest_serving: route request counters {totals} != the requests sent {sent}")
        check(all(canary.get(r, {}).get("requests", 0) > 0 for r in sent),
              f"rest_serving: canary counters {canary}")

        # device bytes: the hot shards' tensors, the cold tier registered, the allocator
        status = _get(mon_port, "/status")
        metrics = _get(mon_port, "/metrics")[1]
        with tiered._registry_lock:
            hots = [b.hot for b in tiered._live_tiered]
        hot_bytes = sum(getattr(h, n).numel() * getattr(h, n).element_size() for h in hots for n in h._TENSORS)
        gauge_hot = _metric_value(metrics, 'pathway_device_bytes{component="knn_hot"}')
        check(gauge_hot == hot_bytes, f"rest_serving: knn_hot gauge {gauge_hot} != the hot shards' {hot_bytes} bytes")
        check(_metric_value(metrics, 'pathway_device_bytes{component="knn_cold"}') is not None,
              "rest_serving: knn_cold is not on /metrics")
        backend = status[1]["device"]["memory"]["backend"] if status[0] == 200 else None
        card = _card_component_bytes()
        check(backend is not None and backend["bytes_in_use"] >= sum(card.values()),
              f"rest_serving: CUDA allocator {backend} below the card's registered bytes {card}")
        out["device_plane"] = {
            "knn_hot_bytes": hot_bytes, "card_components": card, "backend": backend,
            "callables": {k: v for k, v in status[1]["device"]["callables"].items()} if status[0] == 200 else None,
            "pad": status[1]["device"]["pad"] if status[0] == 200 else None,
        }
        out["health"] = {"canary": canary, "route_requests": totals}

        # the profiler window on the card
        out["profiler"] = _profiler_window(port, mon_port, ds)

        # drain: /readyz 503 + Retry-After, /status 503, /healthz still 200
        H.current().mark_draining("chip_smoke")
        readyz, status_d, healthz = _get(port, "/readyz"), _get(mon_port, "/status"), _get(port, "/healthz")
        check(readyz[0] == 503 and readyz[2].get("retry-after") == "5" and readyz[1].get("state") == "draining",
              f"rest_serving: /readyz while draining answered {readyz[0]} {readyz[1]} {readyz[2].get('retry-after')}")
        check(status_d[0] == 503 and healthz[0] == 200,
              f"rest_serving: while draining /status answered {status_d[0]}, /healthz {healthz[0]}")
        out["draining"] = {"readyz": readyz[0], "retry_after": readyz[2].get("retry-after"),
                           "status": status_d[0], "healthz": healthz[0]}
        out.update(inputs_listed=n_inputs, list_documents_listed=n_listed,
                   routes={r: routes[r].snapshot() for r in sorted(routes)})
    finally:
        _stop_run(run)
        os.environ.pop("PATHWAY_MONITORING_HTTP_PORT", None)
    expected = 6 * len(spans)
    check(len(spans) > 0 and route_launches["tensor_core"] == expected and launches == expected,
          f"rest_serving: bf16 attention launches {route_launches} != {expected} (6 per embedder launch)")
    out.update(embed_launches=len(spans), embed_buckets=_buckets(spans), attention_launches=launches,
               attention_launches_by_route=route_launches, attention_launches_expected=expected,
               builds={k: v for k, v in D._callables_view().items() if k.startswith("build/")})
    # a text alone (its launch padded to 64 or 128 tokens, keys resident
    # in the kernel) and in a batch (256 or 512, keys streamed): same bits
    from pathway_tpu_torch.tools.batch_invariance import length_check

    lengths = length_check(emb._encoder)
    out["length_invariance"] = lengths
    check(all(v[0] for n, v in lengths.items() if n.startswith("embed_len_") and isinstance(v, list)
              and isinstance(v[0], bool)), f"rest_serving: a text's bits depend on its launch's length: {lengths}")
    for leg, texts in diagnose.items():
        out[leg] = _diagnose_embed(emb, texts, [q for q, *_r in ds["queries"]])
        print(f"rest_serving: {leg}:", json.dumps(out[leg]), file=sys.stderr, flush=True)

    out["shed"], out["lifecycle"] = _rest_shed_and_lifecycle(port, emb)
    emit("rest_serving", **out)
    return {"launches": route_launches, "metrics": out}


#: the planes' settings of phase observability's legs (rest_serving's leg is
#: the default: every plane on)
OBS_LEGS = {
    "planes_off": {"PATHWAY_PROFILE": "off", "PATHWAY_REQUEST_TRACE": "off", "PATHWAY_HEALTH": "off",
                   "PATHWAY_AUDIT": "off", "PATHWAY_TIMELINE": "off"},
    "audit_timeline_off": {"PATHWAY_AUDIT": "off", "PATHWAY_TIMELINE": "off"},
    "profile_full": {"PATHWAY_PROFILE": "full"},
}


def phase_observability(info: dict, ds: dict, rest: dict) -> dict:
    """The planes' cost beside the default: for each of OBS_LEGS a fresh
    server on phase document_store's files (ingest to the end, as in
    rest_serving), then the RS_CLIENTS-client retrieve leg, every answer
    held against the in-process one. ``planes_off``: every plane off, no
    request id on an answer. ``audit_timeline_off``: the audit and timeline
    planes off and the others at their defaults, so the leg beside the
    default prices those two planes; ``/status`` has no timeline section and
    an audit section that says off. ``profile_full``: the traced encoder's
    device-wait split is above 0 and below the leg's wall. Prints
    requests/s and client p50/p99 of every leg beside rest_serving's
    default one."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.observability import device as D
    from pathway_tpu_torch.ops import attention_kernel as A

    emb, launch_log = ds["emb"], ds["launch_log"]
    out: dict = {"card": info["nvidia_smi"], "requests": len(ds["queries"]), "clients": RS_CLIENTS,
                 "legs": {"default": {k: rest["metrics"][f"retrieve_{RS_CLIENTS}_clients"][k]
                                      for k in ("requests_per_s", "client_p50_ms", "client_p99_ms", "wall_s")},
                          "default_1_client": {k: rest["metrics"]["retrieve_1_clients"][k]
                                               for k in ("requests_per_s", "client_p50_ms", "client_p99_ms")}}}
    A.LAUNCHES = 0
    A.ROUTE_LAUNCHES.update(dict.fromkeys(A.ROUTE_LAUNCHES, 0))
    try:
        for leg_name, env in OBS_LEGS.items():
            os.environ.update(env)
            port, mon_port = _free_port(), _free_port()
            os.environ["PATHWAY_MONITORING_HTTP_PORT"] = str(mon_port)
            launch_log.spans.clear()
            launch_log.texts.clear()
            try:
                run, routes, ingest, _calls = _serve_store(ds, port)
                try:
                    split0 = dict((D.status_summary().get("time_split") or {}).get("encoder.encode_ids") or {})
                    leg, got = _retrieve_leg(port, ds, RS_CLIENTS, routes["/v1/retrieve"], {}, f"observability {leg_name}")
                    split1 = dict((D.status_summary().get("time_split") or {}).get("encoder.encode_ids") or {})
                    rids = sum(1 for a in got if a is not None and a[3])
                    st, status, _h = _get(mon_port, "/status")
                    sections = sorted(status) if st == 200 else []
                    audit_section = status.get("audit") if st == 200 else None
                finally:
                    _stop_run(run)
            finally:
                for k in (*env, "PATHWAY_MONITORING_HTTP_PORT"):
                    os.environ.pop(k, None)
            row = {k: leg[k] for k in ("requests_per_s", "client_p50_ms", "client_p99_ms", "wall_s",
                                       "equal_to_in_process")}
            row.update(ingest_chunks_per_s=ingest["ingest_chunks_per_s"], request_ids=rids,
                       server=leg["server"])
            row["status_sections"] = sections
            if leg_name == "planes_off":
                check(rids == 0, f"observability: {rids} answers carry a request id with the planes off")
            if leg_name == "audit_timeline_off":
                check(rids == len(got) and "timeline" not in sections and "bottleneck" not in sections
                      and audit_section == {"enabled": False, "mode": "off"},
                      f"observability: audit and timeline off: {rids} request ids, /status sections {sections}, "
                      f"audit {audit_section}")
            if leg_name == "profile_full":
                dev_ms = split1.get("device_ms", 0.0) - split0.get("device_ms", 0.0)
                host_ms = split1.get("host_ms", 0.0) - split0.get("host_ms", 0.0)
                samples = split1.get("samples", 0) - split0.get("samples", 0)
                row["encoder_split"] = {"device_ms": dev_ms, "host_ms": host_ms, "samples": samples}
                check(samples > 0 and 0.0 < dev_ms < leg["wall_s"] * 1e3,
                      f"observability: encoder.encode_ids device-wait split {dev_ms} ms over {samples} calls, "
                      f"leg wall {leg['wall_s'] * 1e3} ms")
            out["legs"][leg_name] = row
            print(f"observability {leg_name}: {row['requests_per_s']:.2f} requests/s, "
                  f"p50 {row['client_p50_ms']:.2f} ms, p99 {row['client_p99_ms']:.2f} ms", file=sys.stderr, flush=True)
        route_launches = dict(A.ROUTE_LAUNCHES)
    finally:
        pw.G.clear()
    emit("observability", **out)
    return {"launches": route_launches, "metrics": out}


FLOW_BACKFILL_FILES = 2048
FLOW_SHED_ROWS = 4096
FLOW_SHED_BOUND = 256
FLOW_SAMPLE_S = 0.05  # /status sampling period during the backfill
FLOW_BUCKETS = (8, 16, 32, 64, 128, 256)  # launch buckets the AIMD controller may choose below 512


def _backfill_files(root: str, n: int) -> list[tuple[str, str]]:
    """``n`` new files for the watched directory, from phase document_store's
    generator with seed 1: (path under ``root/corpus/backfill``, text)."""
    rng = np.random.default_rng(1)
    vocab = [f"word{i}" for i in range(5000)]
    return [
        (os.path.join(root, "corpus", "backfill", f"b{i:05d}.txt"),
         " ".join(rng.choice(vocab, size=int(rng.integers(DS_WORDS[0], DS_WORDS[1] + 1)))))
        for i in range(n)
    ]


def _write_files(files: list[tuple[str, str]], staging: str) -> None:
    """Each file written beside the watched tree, then renamed into it, so
    the streaming reader never sees a half-written file."""
    os.makedirs(staging, exist_ok=True)
    for i, (path, text) in enumerate(files):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = os.path.join(staging, os.path.basename(path))
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(text)
        # a fixed mtime: the fs metadata's modified_at is then the same in
        # every leg that writes the file
        os.utime(tmp, (1_700_000_000 + i, 1_700_000_000 + i))
        os.replace(tmp, path)


def _flow_server_leg(ds: dict, mode: str, backfill: list, bf_chunks: int) -> dict:
    """One fresh ``QARestServer`` over a streaming ``pw.io.fs`` read of phase
    document_store's files (the reader's default ``bulk`` class) under
    ``PATHWAY_FLOW=mode`` at the default knobs: ingest to the end, then the
    RS_CLIENTS-client retrieve leg while FLOW_BACKFILL_FILES new files are
    renamed into the watched tree, ``/status`` sampled every FLOW_SAMPLE_S;
    once the backfill is indexed, the same payloads again. Returns the
    leg's numbers, the settled answers (comparable text) and the samples."""
    import shutil
    import threading

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.ops import attention_kernel as A

    shutil.rmtree(os.path.dirname(backfill[0][0]), ignore_errors=True)
    port, mon_port = _free_port(), _free_port()
    env = {"PATHWAY_FLOW": mode, "PATHWAY_MONITORING_HTTP_PORT": str(mon_port)}
    os.environ.update(env)
    A.LAUNCHES = 0
    A.ROUTE_LAUNCHES.update(dict.fromkeys(A.ROUTE_LAUNCHES, 0))
    probe: list = []
    out: dict = {"mode": mode}
    try:
        # no interactive request during the initial ingest: with the plane
        # on, a 20 Hz /v1/statistics poll breaches the SLO and the AIMD
        # controller embeds the corpus in 8-row launches (PERF.md section 6)
        run, routes, ingest, _calls = _serve_store(ds, port, mode="streaming", rows_probe=probe,
                                                   poll_statistics=False)
        out["ingest_chunks_per_s"] = ingest["ingest_chunks_per_s"]
        index_rows = probe[0]
        try:
            samples: list = []
            stop = threading.Event()

            def sample() -> None:
                while not stop.is_set():
                    st, status, _h = _get(mon_port, "/status")
                    if st == 200 and isinstance(status, dict):
                        samples.append((status.get("flow") or {}).get("inputs") or [])
                    stop.wait(FLOW_SAMPLE_S)

            sampler = threading.Thread(target=sample, daemon=True)
            writer = threading.Thread(target=_write_files, args=(backfill, os.path.join(ds["root"], "staging")),
                                      daemon=True)
            jobs = [("POST", "/v1/retrieve", {"query": q, "k": k, "metadata_filter": m, "filepath_globpattern": g})
                    for q, k, m, g in ds["queries"]]
            want_rows = 2 * (ds["chunks"] + bf_chunks)
            sampler.start()
            t0 = time.perf_counter()
            writer.start()
            during = _fan_out(port, jobs, RS_CLIENTS)
            wall = time.perf_counter() - t0
            deadline = time.monotonic() + 600
            while time.monotonic() < deadline and index_rows() < want_rows:
                time.sleep(0.02)
            settle_s = time.perf_counter() - t0
            writer.join(timeout=60)
            stop.set()
            sampler.join(timeout=10)
            check(index_rows() == want_rows,
                  f"flow {mode}: the index nodes hold {index_rows()} rows after the backfill, expected {want_rows}")
            http = _Http(port)
            _st, stats, *_ = http.call("POST", "/v1/statistics", {})
            http.close()
            check(isinstance(stats, dict) and stats.get("file_count") == DS_FILES + len(backfill),
                  f"flow {mode}: /v1/statistics counts {stats} files after the backfill")
            settled = _fan_out(port, jobs, RS_CLIENTS)
            st_status, status, _h = _get(mon_port, "/status")
            st_metrics, metrics, _h = _get(mon_port, "/metrics")
            plane = pw.flow.current()
            decisions = list(plane.controller.decisions) if plane is not None else []
        finally:
            _stop_run(run)
    finally:
        for k in env:
            os.environ.pop(k, None)
    ok = sum(1 for a in during if a is not None and a[0] == 200)
    check(ok == len(jobs), f"flow {mode}: {ok}/{len(jobs)} retrieve requests answered 200 during the backfill")
    ok = sum(1 for a in settled if a is not None and a[0] == 200)
    check(ok == len(jobs), f"flow {mode}: {ok}/{len(jobs)} retrieve requests answered 200 after the backfill")
    out.update(_client_leg(during, wall))
    out.update(backfill_files=len(backfill), backfill_chunks=bf_chunks, backfill_settle_s=settle_s,
               backfill_chunks_per_s=bf_chunks / settle_s, status_samples=len(samples),
               attention_launches=dict(A.ROUTE_LAUNCHES))
    text = metrics if isinstance(metrics, str) else (metrics.decode() if isinstance(metrics, bytes) else "")
    flow_series = sorted({ln.split("{")[0].split(" ")[0] for ln in text.splitlines() if ln.startswith("pathway_flow_")})
    flow = status.get("flow") if st_status == 200 and isinstance(status, dict) else None
    if mode == "on":
        check(flow is not None, f"flow on: /status has no flow section ({st_status})")
        check(len(flow_series) == 5, f"flow on: /metrics flow series {flow_series}")
        over = [(g["input"], g["queued"] + g["in_flight"], g["effective_bound"])
                for inputs in samples for g in inputs if g["queued"] + g["in_flight"] > g["effective_bound"]]
        check(samples and all(inputs for inputs in samples[-1:]) and not over,
              f"flow on: {len(samples)} /status samples, over the bound: {over[:4]}")
        check(flow is not None and flow["shed_rows_total"] == 0, f"flow on: shed {flow and flow['shed_rows_total']}")
        ctl = (flow or {}).get("controller") or {}
        lo, hi = ctl.get("min_bucket", 8), ctl.get("max_bucket", 0)
        bad = [d for d in decisions if not lo <= d["target"] <= hi]
        check(decisions and not bad, f"flow on: {len(decisions)} controller decisions, outside [{lo}, {hi}]: {bad[:4]}")
        trajectory = []
        for d in decisions:
            if not trajectory or trajectory[-1][1] != d["target"]:
                trajectory.append((d["tick"], d["target"]))
        peak = max((g["queued"] + g["in_flight"] for inputs in samples for g in inputs), default=0)
        out.update(
            inputs=[{k: g[k] for k in ("input", "service_class", "bound", "admitted_rows", "shed_rows",
                                       "cancelled_rows", "blocked_ms")} for g in flow["inputs"]] if flow else None,
            peak_queued_plus_in_flight=peak, decisions=len(decisions),
            actions={a: sum(1 for d in decisions if d["action"] == a) for a in ("increase", "decrease", "hold")},
            bucket_trajectory=trajectory[-64:], flow_series=flow_series,
        )
    else:
        check(flow is None and not flow_series, f"flow off: /status flow {flow}, /metrics {flow_series}")
    return {"metrics": out, "settled": [_comparable(a[1]) if a is not None and a[0] == 200 else None
                                        for a in settled]}


def phase_flow(info: dict, ds: dict) -> dict:
    """The flow plane on the served live-RAG path. First the store's
    embedder on 512 chunks in one launch against launches of each of
    FLOW_BUCKETS rows (the buckets the AIMD controller may pick): the same
    bits. Then two fresh servers (``_flow_server_leg``), ``PATHWAY_FLOW=on``
    at the default knobs (65,536-row queues, ``block``, a 250 ms SLO, bulk
    minimum 64) and ``off``, each taking the RS_CLIENTS-client retrieve leg
    during a FLOW_BACKFILL_FILES-file backfill. Gates: after the backfill,
    the ``on`` server's 1,024 answers equal the ``off`` server's (texts,
    metadata without ``seen_at``, score bits); no ``/status`` sample over a
    bound; no row shed; every controller decision inside [min, max]; ``flow``
    on ``/status`` and ``pathway_flow_*`` on ``/metrics`` (and neither with
    ``off``). Then a shed leg: ``PATHWAY_FLOW_POLICY=shed``,
    ``PATHWAY_INPUT_QUEUE_ROWS`` = FLOW_SHED_BOUND, FLOW_SHED_ROWS chunks
    pushed at once into the embedder: the shed count equals the rows pushed
    less the rows ingested. Prints retrieve p50/p99 during the backfill on
    against off, backfill chunks/s, the bucket trajectory and the attention
    launches."""
    import shutil

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.internals import monitoring as M
    from pathway_tpu_torch.ops import attention_kernel as A

    emb = ds["emb"]
    texts = [c for _p, c in ds["chunk_list"][:512]]
    whole = emb._encoder.encode_texts(texts)
    invariance = {}
    for rows in FLOW_BUCKETS:
        parts = np.concatenate([emb._encoder.encode_texts(texts[i : i + rows]) for i in range(0, 512, rows)])
        same = bool(np.array_equal(whole.view(np.uint32), parts.view(np.uint32)))
        invariance[f"embed_{rows}_rows_vs_512"] = same
        check(same, f"flow: the store's embedder gives other bits in {rows}-row launches than in one of 512")

    backfill = _backfill_files(ds["root"], FLOW_BACKFILL_FILES)
    bf_chunks = sum(len(ds["splitter"].func(text)) for _p, text in backfill)
    out: dict = {"card": info["nvidia_smi"], "files": DS_FILES, "backfill_files": FLOW_BACKFILL_FILES,
                 "clients": RS_CLIENTS, "requests": len(ds["queries"]), "batch_invariance": invariance}
    legs = {}
    try:
        for mode in ("on", "off"):
            legs[mode] = _flow_server_leg(ds, mode, backfill, bf_chunks)
            out[mode] = legs[mode]["metrics"]
            m = legs[mode]["metrics"]
            print(f"flow {mode}: retrieve during the backfill p50 {m['client_p50_ms']:.2f} ms, "
                  f"p99 {m['client_p99_ms']:.2f} ms; backfill {m['backfill_chunks_per_s']:.1f} chunks/s",
                  file=sys.stderr, flush=True)
    finally:
        shutil.rmtree(os.path.dirname(backfill[0][0]), ignore_errors=True)
    same = sum(1 for a, b in zip(legs["on"]["settled"], legs["off"]["settled"]) if a is not None and a == b)
    check(same == len(ds["queries"]),
          f"flow: {same}/{len(ds['queries'])} settled answers of the on server equal the off server's")
    out["settled_answers_equal"] = same
    launches = {k: legs["on"]["metrics"]["attention_launches"].get(k, 0)
                + legs["off"]["metrics"]["attention_launches"].get(k, 0) for k in A.ROUTE_LAUNCHES}

    # shed: a 4,096-chunk flood into a 256-row queue
    env = {"PATHWAY_FLOW": "on", "PATHWAY_FLOW_POLICY": "shed", "PATHWAY_INPUT_QUEUE_ROWS": str(FLOW_SHED_BOUND)}
    os.environ.update(env)
    A.ROUTE_LAUNCHES.update(dict.fromkeys(A.ROUTE_LAUNCHES, 0))
    flood = [c for _p, c in ds["chunk_list"][:FLOW_SHED_ROWS]]
    try:
        pw.G.clear()

        class Flood(pw.io.python.ConnectorSubject):
            def run(self):
                self.next_batch([{"text": c} for c in flood])

        t = pw.io.python.read(Flood(), schema=pw.schema_from_types(text=str), name="flood")
        vecs = t.select(v=emb(t.text))
        seen = [0]

        def on_change(key, row, time, is_addition):
            seen[0] += 1 if is_addition else -1

        pw.io.subscribe(vecs, on_change=on_change)
        pw.run(monitoring_level="none")
        st = M.run_stats(pw.internals.run.current_runtime())
    finally:
        for k in env:
            os.environ.pop(k, None)
        pw.G.clear()
    g = next(x for x in st["flow"]["inputs"] if x["input"].startswith("flood"))
    ingested = next(w["rows_ingested"] for w in st["watermarks"] if w["input"].startswith("flood"))
    check(g["shed_rows"] == FLOW_SHED_ROWS - ingested and g["shed_rows"] > 0 and seen[0] == ingested,
          f"flow shed: {g['shed_rows']} shed, {ingested} ingested, {seen[0]} embedded of {FLOW_SHED_ROWS}")
    out["shed"] = {"pushed": FLOW_SHED_ROWS, "bound": FLOW_SHED_BOUND, "shed_rows": g["shed_rows"],
                   "ingested": ingested, "embedded": seen[0], "status_shed_rows_total": st["flow"]["shed_rows_total"]}
    for k, v in A.ROUTE_LAUNCHES.items():
        launches[k] = launches.get(k, 0) + v
    out["attention_launches"] = launches
    emit("flow", **out)
    return {"launches": launches, "metrics": out}


def _rest_shed_and_lifecycle(port: int, emb) -> tuple[dict, dict]:
    """The shed and lifecycle legs on one embedding route on ``port`` (the
    QA server's, released by its stop). A query of "hold" never gets an
    answer; each answered row sleeps RS_SHED_SLEEP_S on the host, so the
    in-flight budget stays full while the concurrent requests arrive."""
    import threading

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.io.http import _server as S

    def build():
        pw.G.clear()
        ws = S.PathwayWebserver(host="127.0.0.1", port=port)
        q, respond = pw.io.http.rest_connector(webserver=ws, route="/v1/embed", schema=pw.schema_from_types(query=str))
        kept = q.filter(q.query != "hold")
        vec = kept.select(v=emb(kept.query))

        def first(v):
            time.sleep(RS_SHED_SLEEP_S)
            return float(np.asarray(v)[0])

        respond(vec.select(result=pw.apply_with_type(first, float, vec.v)))
        return ws._route_states()[0]

    def serve():
        run = threading.Thread(target=pw.run, daemon=True)
        run.start()
        _wait_listening(port)
        return run

    os.environ["PATHWAY_SERVE_MAX_INFLIGHT"] = str(RS_SHED_INFLIGHT)
    try:
        state = build()
        run = serve()
        try:
            got = _fan_out(port, [("POST", "/v1/embed", {"query": f"shed {i}"}) for i in range(RS_SHED_REQUESTS)],
                           RS_SHED_REQUESTS)
            ok = sum(1 for a in got if a is not None and a[0] == 200)
            shed = sum(1 for a in got if a is not None and a[0] == 429 and a[1].get("reason") == "max_inflight")
            snap = state.snapshot()
            check(ok + shed == RS_SHED_REQUESTS and shed > 0 and snap["shed_total"] == shed
                  and snap["responses_total"] == ok and snap["requests_total"] == RS_SHED_REQUESTS,
                  f"rest_serving: shed leg {ok} x 200 + {shed} x 429 of {RS_SHED_REQUESTS}, route counters {snap}")
            shed_out = {"requests": RS_SHED_REQUESTS, "max_inflight": RS_SHED_INFLIGHT, "ok": ok, "shed_429": shed,
                        "route": {k: snap[k] for k in ("requests_total", "responses_total", "shed_total")}}

            # lifecycle: RS_PENDING requests pending when the engine stops
            pending: list = []
            holders = [threading.Thread(target=lambda: pending.append(_Http(port).call("POST", "/v1/embed",
                                                                                      {"query": "hold"})),
                                        daemon=True) for _ in range(RS_PENDING)]
            for t in holders:
                t.start()
            deadline = time.monotonic() + 60
            while len(state.futures) < RS_PENDING and time.monotonic() < deadline:
                time.sleep(0.01)
            held = len(state.futures)
        finally:
            t_stop = time.perf_counter()
            _stop_run(run)
            stop_s = time.perf_counter() - t_stop
        for t in holders:
            t.join(timeout=60)
        answered_503 = sum(1 for a in pending if a[0] == 503 and a[1] == {"error": "engine shutting down"})
        check(held == RS_PENDING and answered_503 == RS_PENDING,
              f"rest_serving: {held} requests pending at stop, {answered_503} answered 503")
    finally:
        os.environ.pop("PATHWAY_SERVE_MAX_INFLIGHT", None)
    build()
    run = serve()
    try:
        again = _Http(port).call("POST", "/v1/embed", {"query": "after restart"})
    finally:
        _stop_run(run)
    check(again[0] == 200 and isinstance(again[1], float), f"rest_serving: the restart on port {port} answered {again[:2]}")
    pw.G.clear()
    return shed_out, {"pending_at_stop": held, "answered_503": answered_503, "stop_s": stop_s,
                      "restart_same_port": again[0]}


GRAPH_SCALE = 13  # R-MAT scale, cut from 18 (PERF.md section 4); Graph500's smallest class is 26
GRAPH_EDGE_FACTOR = 16  # Graph500's edge factor
GRAPH_STEPS = 5
GRAPH_CHURN = 0.01  # the incremental tick deletes and adds this share of the edges
GRAPH_SMALL_SCALE = 12  # bellman_ford: 4,096 vertices
GRAPH_LOUVAIN_SCALE = 8  # louvain: 256 vertices (cut from 4,096: PERF.md)
GRAPH_LOUVAIN_EDGE_FACTOR = 4
RMAT_INITIATOR = (0.57, 0.19, 0.19, 0.05)  # Graph500's Kronecker initiator A, B, C, D


def rmat_edges(scale: int, n_edges: int, rng) -> tuple[np.ndarray, np.ndarray]:
    """``n_edges`` R-MAT edges over ``2**scale`` vertices with Graph500's
    initiator: each of ``scale`` bit levels picks a quadrant with
    probabilities A, B, C, D (no noise, no label permutation)."""
    a, b, c, _d = RMAT_INITIATOR
    u = np.zeros(n_edges, np.int64)
    v = np.zeros(n_edges, np.int64)
    for level in range(scale):
        r = rng.random(n_edges)
        down = r >= a + b  # quadrant C or D: the source's bit is set
        right = ((r >= a) & (r < a + b)) | (r >= a + b + c)  # B or D: the target's bit
        u |= down.astype(np.int64) << level
        v |= right.astype(np.int64) << level
    return u, v


def pagerank_model(u: np.ndarray, v: np.ndarray, steps: int) -> dict[int, int]:
    """``stdlib.graphs.pagerank``'s integer iteration in numpy: every endpoint
    starts at 6,000; a vertex of out-degree d sends ``rank * 5 // (d * 6)``
    along each out-edge (duplicates count); the new rank is its inflow plus
    1,000; ``steps`` rounds, or fewer where a round changes nothing."""
    verts = np.unique(np.concatenate([u, v]))
    ui, vi = np.searchsorted(verts, u), np.searchsorted(verts, v)
    deg = np.bincount(ui, minlength=len(verts)).astype(np.int64)
    rank = np.full(len(verts), 6_000, np.int64)
    safe = np.maximum(deg, 1)
    for _ in range(steps):
        flow = np.where(deg > 0, (rank * 5) // (safe * 6), 0)
        inflow = np.zeros(len(verts), np.int64)
        np.add.at(inflow, vi, flow[ui])
        new = inflow + 1_000
        if np.array_equal(new, rank):
            break
        rank = new
    return dict(zip(verts.tolist(), rank.tolist()))


class _EventCount:
    """The length and the last time of a columnar timed fixture: all that
    its connector reads of the event list (the rows stay in arrays)."""

    def __init__(self, n: int, last_time: int):
        self.n, self.last_time = n, last_time

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i):
        return (self.last_time,)


def _columnar_stream(pw, columns: dict, keys: np.ndarray, times: np.ndarray, diffs: np.ndarray, name: str):
    """A timed input table straight from numpy columns (one tick per distinct
    time), without a Python tuple per row: ``pw.debug``'s timed fixture fed
    its columnarized arrays."""
    from pathway_tpu_torch.internals.logical import LogicalNode
    from pathway_tpu_torch.internals.table import Table
    from pathway_tpu_torch.internals.universe import Universe
    from pathway_tpu_torch.io.python import _TimedDriver, _TimedInputNode

    order = np.argsort(times, kind="stable")
    cols = list(columns)
    schema = pw.schema_from_types(**{c: int for c in cols})
    arrays = (times[order].astype(np.int64), keys[order].astype(np.uint64), diffs[order].astype(np.int64),
              {c: np.asarray(columns[c])[order].astype(np.int64) for c in cols})
    events = _EventCount(len(order), int(times.max()) if len(times) else 0)
    holder: dict = {}

    def factory():
        node = _TimedInputNode(events, cols, schema.np_dtypes(), arrays=arrays)
        node.input_name = name
        holder["node"] = node
        return node

    def hook(node, runtime):
        if runtime is not None:
            runtime.register_connector(_TimedDriver(holder))

    return Table(LogicalNode(factory, [], name=name, runtime_hook=hook), schema, Universe())


def _graph_run(route: str, fn, profile: bool = False) -> tuple:
    """``fn()`` (building a table from a cleared graph) captured under
    ``PATHWAY_ENGINE_JAX=route`` with the audit and timeline planes off:
    (the capture, seconds, the engine routes it took, the profiler's device
    ms or None)."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.engine import torch_kernels as K

    env = {"PATHWAY_ENGINE_JAX": route, "PATHWAY_AUDIT": "off", "PATHWAY_TIMELINE": "off"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    K.ROUTES.clear()
    try:
        pw.G.clear()
        table = fn(pw)
        device_ms = None
        if profile and DEVICE == "cuda":
            import torch
            from torch.autograd import DeviceType
            from torch.profiler import ProfilerActivity, profile as _profile

            with _profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                cap = pw.debug._capture(table)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
            device_ms = sum(ev.device_time_total / 1e3 for ev in prof.key_averages()
                            if ev.device_type == DeviceType.CUDA and ev.device_time_total > 0)
        else:
            t0 = time.perf_counter()
            cap = pw.debug._capture(table)
            secs = time.perf_counter() - t0
        return cap, secs, dict(K.ROUTES), device_ms
    finally:
        pw.G.clear()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _final(deltas, until: int | None = None) -> dict:
    """key -> row of an update stream's net state (up to time ``until``)."""
    net: dict = {}
    for t, k, d, row in deltas:
        if until is not None and t > until:
            continue
        net[(k, row)] = net.get((k, row), 0) + d
    out: dict = {}
    for (k, row), n in net.items():
        if n:
            check(n == 1 and k not in out, f"graphs: key {k} holds {n} copies of {row}")
            out[k] = row
    return out


def phase_graphs(info: dict) -> dict:
    """``stdlib.graphs`` on the engine: ``pagerank(steps=GRAPH_STEPS)`` on an
    R-MAT graph (Graph500's initiator, edge factor 16, ``2**GRAPH_SCALE``
    vertices, built with numpy from seed 0), then one incremental tick that
    deletes GRAPH_CHURN of the edges and adds as many new ones; with the
    engine's device functions on the card (``PATHWAY_ENGINE_JAX=gpu``) and
    on the host (``cpu``). Gates: card ranks == host ranks == the numpy
    model of the same integer iteration, exactly, after each tick; the card
    run took the grouped and probe routes on the card. Then
    ``bellman_ford`` on a 4,096-vertex R-MAT graph and
    ``louvain_communities(levels=2)`` on a 256-vertex one
    (integer-valued float lengths and weights, so every sum is exact in any
    order): card == host. Prints seconds, edges/s, the card run's
    device idle share and the routes taken."""
    from pathway_tpu_torch.internals.keys import row_keys, sequential_keys

    card = "gpu" if DEVICE == "cuda" else "cpu"
    dev = "cuda" if DEVICE == "cuda" else "cpu"
    rng = np.random.default_rng(0)
    n_v = 1 << GRAPH_SCALE
    n_e = GRAPH_EDGE_FACTOR * n_v
    t_gen = time.perf_counter()
    u, v = rmat_edges(GRAPH_SCALE, n_e, rng)
    churn = int(n_e * GRAPH_CHURN)
    gone = np.sort(rng.choice(n_e, size=churn, replace=False))
    nu, nv = rmat_edges(GRAPH_SCALE, churn, rng)
    keep = np.ones(n_e, bool)
    keep[gone] = False
    u2, v2 = np.concatenate([u[keep], nu]), np.concatenate([v[keep], nv])
    model0, model1 = pagerank_model(u, v, GRAPH_STEPS), pagerank_model(u2, v2, GRAPH_STEPS)
    gen_s = time.perf_counter() - t_gen
    keys = sequential_keys(0, n_e + churn)
    all_u, all_v = np.concatenate([u, u[gone], nu]), np.concatenate([v, v[gone], nv])
    all_k = np.concatenate([keys[:n_e], keys[:n_e][gone], keys[n_e:]])
    times = np.concatenate([np.zeros(n_e, np.int64), np.full(2 * churn, 2, np.int64)])
    diffs = np.concatenate([np.ones(n_e, np.int64), -np.ones(churn, np.int64), np.ones(churn, np.int64)])

    def pagerank(pw):
        raw = _columnar_stream(pw, {"ui": all_u, "vi": all_v}, all_k, times, diffs, "rmat_edges")
        edges = raw.select(u=raw.pointer_from(raw.ui), v=raw.pointer_from(raw.vi))
        return pw.stdlib.graphs.pagerank.pagerank(edges, steps=GRAPH_STEPS)

    out: dict = {"card": info["nvidia_smi"], "scale": GRAPH_SCALE, "vertices": n_v, "edges": n_e,
                 "edge_factor": GRAPH_EDGE_FACTOR, "steps": GRAPH_STEPS, "churn_edges": churn,
                 "endpoints": len(model0), "generate_and_model_s": gen_s}
    cap_card, card_s, card_routes, device_ms = _graph_run(card, pagerank, profile=True)
    cap_host, host_s, host_routes, _ = _graph_run("cpu", pagerank)
    vert_keys = {}
    for model in (model0, model1):
        ids = np.fromiter(model, np.int64, count=len(model))
        vert_keys.update(zip(ids.tolist(), row_keys([ids], n=len(ids)).tolist()))
    want0 = {vert_keys[i]: (r,) for i, r in model0.items()}
    want1 = {vert_keys[i]: (r,) for i, r in model1.items()}
    for name, cap in (("card", cap_card), ("host", cap_host)):
        got0, got1 = _final(cap.deltas, until=0), _final(cap.deltas)
        got0 = {int(k): tuple(int(x) for x in row) for k, row in got0.items()}
        got1 = {int(k): tuple(int(x) for x in row) for k, row in got1.items()}
        check(got0 == want0, f"graphs pagerank ({name}) tick 0: {sum(got0.get(k) == r for k, r in want0.items())}"
              f"/{len(want0)} ranks equal the numpy model")
        check(got1 == want1, f"graphs pagerank ({name}) after the churn tick: "
              f"{sum(got1.get(k) == r for k, r in want1.items())}/{len(want1)} ranks equal the numpy model")
    check(cap_card.deltas == cap_host.deltas, "graphs pagerank: the card's update stream differs from the host's")
    if DEVICE == "cuda":
        check(card_routes.get("grouped/cuda", 0) > 0 and card_routes.get("probe/cuda", 0) > 0,
              f"graphs pagerank: the card run's routes {card_routes} miss grouped/cuda or probe/cuda")
    check(not any(r.endswith("/cuda") for r in host_routes), f"graphs pagerank: the host run took {host_routes}")
    edge_rows = n_e + 2 * churn
    out["pagerank"] = {
        f"{card}_s": card_s, "cpu_s": host_s,
        f"{card}_edges_per_s": edge_rows * GRAPH_STEPS / card_s, "cpu_edges_per_s": edge_rows * GRAPH_STEPS / host_s,
        f"{card}_routes": card_routes, "cpu_routes": host_routes,
        "device_ms": device_ms, "device_idle_share": None if device_ms is None else 1.0 - device_ms / (card_s * 1e3),
        "updates": len(cap_card.deltas), "equal_to_model": True,
    }
    print(f"graphs pagerank: {n_e} edges, {card} {card_s:.1f} s, cpu {host_s:.1f} s", file=sys.stderr, flush=True)

    # bellman_ford and louvain on small R-MAT graphs: card == host
    def small_graph(scale: int, edge_factor: int, seed: int) -> tuple:
        g_rng = np.random.default_rng(seed)
        gu, gv = rmat_edges(scale, edge_factor << scale, g_rng)
        return 1 << scale, gu, gv, g_rng.integers(1, 8, size=len(gu))

    def columns(pw, cols, name):
        m = len(next(iter(cols.values())))
        return _columnar_stream(pw, cols, sequential_keys(0, m), np.zeros(m, np.int64), np.ones(m, np.int64), name)

    def vertices(pw, n):
        t = columns(pw, {"i": np.arange(n, dtype=np.int64)}, "rmat_vertices")
        return t.with_id_from(t.i)

    bf = small_graph(GRAPH_SMALL_SCALE, GRAPH_EDGE_FACTOR, 1)
    lv = small_graph(GRAPH_LOUVAIN_SCALE, GRAPH_LOUVAIN_EDGE_FACTOR, 2)

    def bellman(pw):
        n, gu, gv, lengths = bf
        vs = vertices(pw, n)
        vs = vs.select(is_source=vs.i == 0)
        raw = columns(pw, {"ui": gu, "vi": gv, "len": lengths}, "rmat_lengths")
        edges = raw.select(u=vs.pointer_from(raw.ui), v=vs.pointer_from(raw.vi), dist=raw.len * 1.0)
        return pw.stdlib.graphs.bellman_ford.bellman_ford(vs, edges)

    def louvain(pw):
        n, gu, gv, weights = lv
        vs = vertices(pw, n)
        raw = columns(pw, {"ui": gu, "vi": gv, "w": weights}, "rmat_weights")
        fwd = raw.select(u=vs.pointer_from(raw.ui), v=vs.pointer_from(raw.vi), weight=raw.w * 1.0)
        bwd = raw.select(u=vs.pointer_from(raw.vi), v=vs.pointer_from(raw.ui), weight=raw.w * 1.0)
        graph = pw.stdlib.graphs.WeightedGraph.from_vertices_and_weighted_edges(vs.select(), fwd.concat_reindex(bwd))
        return pw.stdlib.graphs.louvain_communities.louvain_communities(graph, levels=2)

    for name, fn, (sv, su_, _v, _w) in (("bellman_ford", bellman, bf), ("louvain", louvain, lv)):
        c_cap, c_s, c_routes, _ = _graph_run(card, fn)
        h_cap, h_s, h_routes, _ = _graph_run("cpu", fn)
        same = _final(c_cap.deltas) == _final(h_cap.deltas)
        check(same, f"graphs {name}: the card's final rows differ from the host's")
        rows = _final(h_cap.deltas)
        out[name] = {f"{card}_s": c_s, "cpu_s": h_s, f"{card}_routes": c_routes, "rows": len(rows),
                     "vertices": sv, "edges": len(su_), "identical": same}
        if name == "bellman_ford":
            reach = sum(1 for (d,) in rows.values() if np.isfinite(d))
            out[name]["reachable"] = reach
            check(0 < reach <= sv, f"graphs bellman_ford: {reach} reachable vertices")
        else:
            out[name]["communities"] = len({row for row in rows.values()})
            check(1 < out[name]["communities"] < sv, f"graphs louvain: {out[name]['communities']} communities")
        print(f"graphs {name}: {card} {c_s:.1f} s, cpu {h_s:.1f} s", file=sys.stderr, flush=True)
    emit("graphs", **out)
    return out


KNN_INDEX_QUERIES = 256
KNN_INDEX_K = 10
# LSH of the legacy KNNIndex on the main path's unit-norm embeddings: 16 ORed
# bands of 8 ANDed projections, bucket length 1 (a unit vector's projection
# is N(0, 1)); euclidean distance, which ranks unit vectors as cosine does
KNN_INDEX_LSH = {"n_or": 16, "n_and": 8, "bucket_length": 1.0}


def main_path_embeddings(index, n: int) -> np.ndarray:
    """The vectors the main path indexed under keys 0..n-1, from its
    brute-force index on the card, as f32 on the host."""
    import torch

    rows = torch.tensor([index._key_to_slot[k] for k in range(n)], device=index._vectors.device)
    return index._vectors[rows].float().cpu().numpy()


def _knn_index_run(vecs: np.ndarray, queries: np.ndarray, route: str) -> tuple:
    """``stdlib.ml.KNNIndex`` over ``vecs`` answering ``queries`` (flat rows
    with distances) under ``PATHWAY_ENGINE_JAX=route``: (query -> [(doc,
    dist)] nearest first, seconds)."""
    def build(pw):
        data = pw.debug.table_from_rows(pw.schema_from_types(emb=np.ndarray, doc=int),
                                        [(v, i) for i, v in enumerate(vecs)])
        index = pw.stdlib.ml.KNNIndex(data.emb, data, n_dimensions=vecs.shape[1], **KNN_INDEX_LSH)
        qs = pw.debug.table_from_rows(pw.schema_from_types(emb=np.ndarray, q=int),
                                      [(v, i) for i, v in enumerate(queries)])
        res = index.get_nearest_items(qs.emb, k=KNN_INDEX_K, collapse_rows=False, with_distances=True)
        return res.select(q=qs.ix(res.query_id).q, doc=res.doc, dist=res.dist)

    cap, secs, _routes, _ = _graph_run(route, build)
    hits: dict = {}
    for (q, doc, dist) in _final(cap.deltas).values():
        hits.setdefault(int(q), []).append((float(dist), int(doc)))
    return {q: [(d, s) for s, d in sorted(h)] for q, h in hits.items()}, secs


def phase_knn_index(info: dict, vecs: np.ndarray) -> dict:
    """The legacy ``stdlib.ml.KNNIndex`` (LSH buckets on the engine, numpy
    distances) on the main path's 8,192 embeddings made on the card:
    KNN_INDEX_QUERIES queries (every 32nd doc's vector), k = KNN_INDEX_K,
    with the engine's device functions on the card and on the host. Gate:
    the card run's neighbours and distances equal the host run's on the
    same vectors copied to the host, and each query finds its own doc
    first. Prints recall@10 against the port's ``BruteForceKnnIndex`` on
    the card (no gate)."""
    from pathway_tpu_torch.ops.knn import BruteForceKnnIndex

    card = "gpu" if DEVICE == "cuda" else "cpu"
    queries = vecs[:: len(vecs) // KNN_INDEX_QUERIES][:KNN_INDEX_QUERIES]
    q_docs = list(range(0, len(vecs), len(vecs) // KNN_INDEX_QUERIES))[:KNN_INDEX_QUERIES]
    got_card, card_s = _knn_index_run(vecs, queries, card)
    got_host, host_s = _knn_index_run(vecs.copy(), queries.copy(), "cpu")
    check(got_card == got_host, "knn_index: the card run's neighbours differ from the host run's")
    self_first = sum(1 for q, d in enumerate(q_docs) if got_card.get(q) and got_card[q][0][0] == d)
    check(self_first == len(q_docs), f"knn_index: {self_first}/{len(q_docs)} queries find their own doc first")
    brute = BruteForceKnnIndex(dimension=vecs.shape[1], capacity=len(vecs), device=DEVICE)
    brute.add_batch(list(range(len(vecs))), vecs)
    truth = [[int(k) for k, _s in hits] for hits in brute.search(queries, KNN_INDEX_K)]
    found = sum(len({d for d, _ in got_card.get(q, [])} & set(t)) for q, t in enumerate(truth))
    out = {"card": info["nvidia_smi"], "rows": len(vecs), "dim": int(vecs.shape[1]), "queries": len(queries),
           "k": KNN_INDEX_K, **KNN_INDEX_LSH, f"{card}_s": card_s, "cpu_s": host_s,
           f"{card}_queries_per_s": len(queries) / card_s, "identical": got_card == got_host,
           "self_first": self_first, "recall_at_10_vs_brute_force": found / (len(queries) * KNN_INDEX_K),
           "mean_hits": sum(len(h) for h in got_card.values()) / len(queries)}
    emit("knn_index", **out)
    return out


def _kernel_entry(records: list[dict], dtype: str, route: str, what: str, launches: dict) -> dict:
    """One route of the attention kernel on the kernels line: its time at the
    embed shape, and its largest error over every checked case of its dtype
    (with the case it came from). ``launches``: path name -> route counts,
    each read right after that path ran; the line's count is their sum."""
    mine = [r for r in records if r["dtype"] == dtype]
    worst = max(mine, key=lambda r: r["max_abs_err"])
    embed = next(r for r in mine if r["case"] == "embed")
    entry = {
        "name": f"attention_short_flat[{dtype}]",
        "route": "cuda",
        "source": "pathway_tpu_torch/csrc/attention_short.cu",
        "replaces": "pathway_tpu/ops/attention_kernel.py:33",
        "launches": sum(by_route[route] for by_route in launches.values()),
        "launches_by_path": {path: by_route[route] for path, by_route in launches.items()},
        "max_abs_err": worst["max_abs_err"],
        "max_abs_err_case": f"{dtype} {worst['case']} (B={worst['B']} L={worst['L']} hd={worst['hd']})",
        "cases_checked": len(mine),
        "ms": embed["ms"],
        "plain_ms": embed["plain_ms"],
        "bound_ms": embed["bound_ms"],
        "bound_by": embed["bound_by"],
        "library_ms": embed["library_ms"],
        "shape": f"B=1024 L=128 D=384 H=6 {dtype}",
        "kernel": what,
        "timed_cases": {r["case"]: {k: r[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
                        for r in mine if "ms" in r},
    }
    if "bound_fp32_pipes_ms" in embed:
        entry["bound_fp32_pipes_ms"] = embed["bound_fp32_pipes_ms"]
    return entry


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script measures the card only", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import pathway_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the pathway_tpu_torch package is missing ({exc})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    walls: dict = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            walls[name] = round(time.perf_counter() - t0, 3)

    info = timed("device", phase_device)
    timed("build", phase_build)
    kern = timed("kernels", phase_kernels)
    state = timed("main_path", phase_main_path, synth_docs(N_DOCS))
    timed("checks", phase_checks, state)
    bench_vecs = main_path_embeddings(state["index"], N_DOCS)
    del state["index"]
    f32 = timed("f32_path", phase_f32_path, state, info)
    pipe = timed("pipeline", phase_pipeline, info)
    tier = timed("tiered", phase_tiered, info)
    timed("engine_kernels", phase_engine_kernels, info)
    timed("audit_fault", phase_audit_fault, info)
    temporal = timed("temporal", phase_temporal, info)
    bert = timed("bert_path", phase_bert_path, info)
    store = timed("document_store", phase_document_store, info)
    try:
        rest = timed("rest_serving", phase_rest_serving, info, store)
        obs = timed("observability", phase_observability, info, store, rest)
        flow = timed("flow", phase_flow, info, store)
    finally:
        import shutil

        shutil.rmtree(store["root"], ignore_errors=True)
    timed("graphs", phase_graphs, info)
    timed("knn_index", phase_knn_index, info, bench_vecs)
    emit("phase_walls", seconds=walls, total=round(sum(walls.values()), 3))

    launches = {
        "main_path": state["launches"], "f32_path": f32["launches"], "pipeline": pipe["launches"],
        "tiered_pipeline": tier["launches"], "temporal": temporal["launches"], "bert_path": bert["launches"],
        "document_store": store["launches"], "rest_serving": rest["launches"], "observability": obs["launches"],
        "flow": flow["launches"],
    }
    line = {"kernels": [
        _kernel_entry(kern, "bfloat16", "tensor_core", "bf16, tensor cores (mma.sync, cp.async)", launches),
        _kernel_entry(kern, "float32", "tensor_core_3xtf32",
                      "f32, tensor cores in 3xTF32 (mma.sync m16n8k8 tf32 on split operands, cp.async)", launches),
    ]}
    if failures:
        print("chip_smoke: FAILED: " + "; ".join(failures), file=sys.stderr)
        return 1
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": info["kind"], "count": info["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:
        traceback.print_exc()
        sys.exit(1)
