#!/usr/bin/env python3
"""Drive the PyTorch port's live-RAG loop once on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout; needs one CUDA card and ``nvcc`` (CUDA_HOME,
PATH or the toolkit's default location), and nothing of JAX. Phases, each
printing one JSON line:

1. device: the card's name and power limit (``nvidia-smi``) and versions;
2. build: every CUDA kernel of the port built from ``pathway_tpu_torch/csrc``
   (ptxas registers, spills and shared memory per instantiation, and the
   tensor-core instructions in the bf16 route's SASS), and the native C
   tokenizer built from ``pathway_tpu_torch/native``;
3. kernels: each kernel against its plain PyTorch version on the card, both
   routes of the attention kernel (bf16 on the tensor cores, f32 SIMT) at
   eight shapes, the main path's among them, with its time, its plain
   version's time, one PyTorch library call's time as a yardstick, and its
   bound;
4. main path, at the full width of the bench's MiniLM-class encoder with
   random seeded weights: 8192 docs tokenized, embedded in batches of 1024
   and indexed; the index filled to 1,000,000 x 384 f32; 30 RAG queries
   (encode → search k=10 → rerank the hits); a 16-query search at 1M;
5. checks of the main path's answers: each doc finds itself first, search
   agrees with a float64 numpy brute force in keys and order, rerank scores
   are finite, card embeddings agree with the port's CPU path;
6. pipeline: the same loop written against ``import pathway_tpu_torch as pw``
   and run by the engine (``pw.debug`` streams → ``SentenceTransformerEmbedder``
   through the cross-tick microbatcher → ``BruteForceKnnFactory`` index →
   ``query_as_of_now`` → flatten → ``CrossEncoderReranker``): 65,536 docs and
   then 1,024 queries in 64-row ticks, with its checks (self-retrieval, a
   direct search over the embeddings the pipeline emitted, rerank scores
   against the cross-encoder, microbatch off == auto at 4,096 docs);
7. engine_kernels: the engine's filter → join → groupby/sum at 1,000,000
   rows, static and over 20 ticks, with both ``engine/torch_kernels.py``
   functions on the card (``PATHWAY_ENGINE_JAX=gpu``) and on numpy (``0``),
   whose captured outputs must be identical;
8. the kernels line, with each kernel's launches during phases 4 and 6.

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
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM
H100_BF16_FLOPS = 989e12  # dense tensor-core bf16
H100_F32_FLOPS = 67e12  # FP32 pipes, outside the tensor cores

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
    tc = {f: n for f, n in sass.get("attention_short", {}).items() if "attention_tc_kernel" in f}
    check(len(tc) > 0, "no tensor-core attention instantiation found in the SASS")
    check(all(n > 0 for n in tc.values()), f"bf16 route without HMMA/HGMMA in its SASS: {tc}")

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
#: length that fills no tile evenly, and the other head widths the kernel is
#: built for (hd 128 both with K and V resident and streamed)
KERNEL_SHAPES = {
    "embed": (1024, 128, 64), "query": (1, 16, 64), "rerank": (10, 256, 64),
    "max_len": (4, 512, 64), "ragged": (3, 77, 64), "hd32": (2, 128, 32), "hd128": (2, 256, 128),
    "hd128_resident": (2, 128, 128),
}
#: the timed cases per dtype: the bf16 route at the main path's shapes, the
#: f32 route at the embed shape
TIMED = {"bfloat16": ("embed", "query", "rerank"), "float32": ("embed",)}


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
                peak = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_F32_FLOPS
                t_bytes, t_ops = nbytes / H100_BYTES_PER_S * 1e3, flops / peak * 1e3
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
    A.ROUTE_LAUNCHES.update(tensor_core=0, simt=0)
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


class _LaunchLog:
    """Wraps a batched UDF's batch function before a pipeline is built from
    it: per launch, its host clock span and its row count (the bucket the
    microbatcher padded to), and for an embedder every vector it returned,
    by text. The launch returns numpy, so its span includes the card's
    work."""

    def __init__(self, udf, keep_vectors: bool = False):
        self.spans: list[tuple[float, float, int]] = []
        self.vectors: dict[str, list] = {}
        inner = udf._fn

        def launch(*cols):
            t0 = time.perf_counter()
            out = inner(*cols)
            self.spans.append((t0, time.perf_counter(), len(cols[0])))
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


def _run_pipeline(emb, rr, docs: list[str], queries: list[str], mode: str):
    """One capture of the pipeline under ``PATHWAY_MICROBATCH=mode``; returns
    (rows, run start, run end) on the host clock."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.debug import _capture
    from pathway_tpu_torch.stdlib.indexing import BruteForceKnnFactory
    from pathway_tpu_torch.tools import rag_pipeline

    os.environ["PATHWAY_MICROBATCH"] = mode
    pw.G.clear()
    table = rag_pipeline.build(
        pw, embedder=emb, index_factory=BruteForceKnnFactory(embedder=emb, device=DEVICE),
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
    A.ROUTE_LAUNCHES.update(tensor_core=0, simt=0)
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


def phase_engine_kernels(info: dict) -> dict:
    """engine_bench's filter → join → groupby/sum in the port at
    ENGINE_ROWS rows, static and over ENGINE_TICKS ticks, with both
    functions of ``engine/torch_kernels.py`` on the card and on numpy."""
    from pathway_tpu_torch.debug import _capture
    from pathway_tpu_torch.engine import torch_kernels as K
    from pathway_tpu_torch.tools.engine_pipeline import build

    saved = os.environ.get("PATHWAY_ENGINE_JAX")
    card_flag = "gpu" if DEVICE == "cuda" else "cpu"
    runs = {}
    for n_times in (1, ENGINE_TICKS):
        outs = {}
        for flag in (card_flag, "0"):
            os.environ["PATHWAY_ENGINE_JAX"] = flag
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
    if saved is None:
        os.environ.pop("PATHWAY_ENGINE_JAX", None)
    else:
        os.environ["PATHWAY_ENGINE_JAX"] = saved
    emit("engine_kernels", card=info["nvidia_smi"], **runs)
    import pathway_tpu_torch as pw

    pw.G.clear()
    return runs


def _kernel_entry(records: list[dict], dtype: str, route: str, what: str, launches: dict) -> dict:
    """One route of the attention kernel on the kernels line: its time at the
    embed shape, and its largest error over every checked case of its dtype
    (with the case it came from). ``launches``: path name -> route counts,
    each read right after that path ran; the line's count is their sum."""
    mine = [r for r in records if r["dtype"] == dtype]
    worst = max(mine, key=lambda r: r["max_abs_err"])
    embed = next(r for r in mine if r["case"] == "embed")
    return {
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

    info = phase_device()
    phase_build()
    kern = phase_kernels()
    state = phase_main_path(synth_docs(N_DOCS))
    phase_checks(state)
    del state["index"]
    pipe = phase_pipeline(info)
    phase_engine_kernels(info)

    launches = {"main_path": state["launches"], "pipeline": pipe["launches"]}
    line = {"kernels": [
        _kernel_entry(kern, "bfloat16", "tensor_core", "bf16, tensor cores (mma.sync, cp.async)", launches),
        _kernel_entry(kern, "float32", "simt", "f32, FP32 pipes (SIMT); not on a path", launches),
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
