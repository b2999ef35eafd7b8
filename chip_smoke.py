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
   one PyTorch library call's time as a yardstick, and its bound; then
   the attention's backward (``attention_short_bwd.cu``: up to 128 keys one
   fused pass per (text, head) on the tensor cores, above it a dQ pass and
   a dK/dV pass on the tensor cores) against its plain version, both dtypes
   at every shape of ``BWD_SHAPES``, with the route each took; at each
   timed shape (the train step's, 512 and 1,024 keys, 3 heads of 256 at
   128 and 600 keys, ...), on its route and on the two-pass route forced,
   two launches give the same bits and the first texts alone give those
   rows of the whole call's bits, and it is timed beside the two-pass route
   at that shape, its plain version, SDPA's backward and its bound; then every head the
   aligned kernels do not take, on ``attention_any.cu``: the forward at hd
   1, 4, 6, 12, 20, 36, 100, 136, 192 and 256 in 3 heads (the [B, L, 3D]
   projection's rows at copies of 2, 4, 8 and 16 bytes) at 16, 128 and
   600 keys and at encoder_widths' shapes (32 heads of 12, 3 of 256), each
   on the route its copy width and width pick, timed beside SDPA and its
   bound; the backward at hd 1, 12, 136 and 256 on its fused route at any
   copy width or its two-pass route (any copy width, column blocks of 128);
3b. encoder_widths: encoders at 8 heads of 48, 6 of 64 at 1,024 keys, 32
   heads of 12 at d 384 and 3 heads of 256 at d 768 (6 layers, 1,024 docs,
   bf16 and f32): every launch on the route the head picks, the card
   against the CPU path, and one train step of the last two on the
   kernels against the plain attention (bf16; f32 at 3 x 256);
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
   ``query_as_of_now`` → flatten → ``CrossEncoderReranker``): 16,384 docs and
   then 512 queries in 64-row ticks, with its checks (self-retrieval, a
   direct search over the embeddings the pipeline emitted, rerank scores
   against the cross-encoder, microbatch off == auto at 4,096 docs);
8. tiered: the tiered index (bounded hot shard on the card, host IVF cold
   tier, cold candidates rescored on the card) on ``knn_bench``'s clustered
   384-d corpus: first the index-rows check of ``tools/batch_invariance.py``
   (the same scores in a brute-force index of any capacity and in the cold
   rescore); then at 131,072 rows, 2x the default hot bound of 65,536, with
   an exact cold tier, its top-10 must equal a card-resident brute-force
   index's in keys and score bits, before and after ``maintain()``; then
   its serving rates at 16, 256 and 1,024 queries a batch beside the
   brute-force index's, with a trained IVF cold tier, recall@10 and the
   tier counters; then the pipeline of phase 7 with ``TieredKnnFactory``
   (hot bound 4,096) with its checks (self-retrieval, microbatch off ==
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
   engine_semantics: every case of the reference's ten Table API test
   files (table ops, joins, reducers, expressions, edge cases, errors,
   core types, the differential fuzz, the first-load paths, column dtypes;
   their sources read as the port's) with the groupby segment-sum and the
   join probe on the card (``PATHWAY_ENGINE_JAX=gpu``, size thresholds at
   1) and the fused device tier forced on, each update stream equal to the
   same case on CPU tensors bit for bit; the differential fuzz at 65,536
   events streamed against static on the card and against CPU tensors;
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
12. document_store: 2,048 UTF-8 files in 64 directories read by
   ``pw.io.fs`` into ``DocumentStore`` (``minilm`` embedder,
   ``TokenCountSplitter(50, 200)``, the default ``TieredKnnFactory``); 1,024
   ``retrieve_query`` rows in 64-row ticks (256 filtered to a directory),
   ``statistics_query``, ``inputs_query`` and 256 prompts through
   ``BaseRAGQuestionAnswerer``, with its checks (self-hits, filtered hits
   inside their glob, 2,048 files counted, each prompt holding its k texts
   in order); a 1,024-file streaming read whose answers equal a static
   read's; 64 files each of PDF, DOCX, HTML and Markdown through their
   parsers, each marker phrase retrieved first;
12b. persistence: phase 12's files in two halves through ``pw.io.fs``
   (streaming) into the same ``DocumentStore`` over ``TieredKnnFactory``
   (the default hot bound, which holds every chunk), with a filesystem persistence
   backend in ``operator_persisting`` mode and two jsonlines sinks with
   ``delivery="exactly_once"``: run A ingests the first half and ends; run B
   restores the operator snapshots and the index from its base and delta
   chunks, takes the second half, then answers phase 12's 1,024 retrieve
   rows. Gates: run B's answers equal an uninterrupted run's (keys, texts,
   metadata, score bits); run B embeds exactly the second half's chunks and
   the queries (embedder rows, attention launches == 6 x embedder
   launches); each exactly-once file holds every row once, equal to the
   uninterrupted run's. It prints the base and delta bytes, the snapshot
   seconds at close, the restore seconds and the seconds from ``pw.run`` to
   run B's first answer for ``operator_persisting`` (a 5 s snapshot
   cadence) and ``persisting`` (input replay, which re-embeds the first
   half);
13. rest_serving: phase 12's files served over HTTP by ``QARestServer``
   (``pw.io.http`` on the port's own HTTP/1.1 server) over the same
   ``DocumentStore`` and ``BaseRAGQuestionAnswerer``, at the port's
   defaults (the device, audit, request-trace, health and timeline planes
   on) with the monitoring server on a port of its own: ingest until ``/v1/statistics``
   counts every file and both index nodes hold every chunk; phase 12's
   retrieve payloads as JSON POSTs from 1 client (the first 256) and all
   1,024 from 32 concurrent keep-alive clients, each answer equal to phase 12's in-process answer
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
15. multiworker (after the flow, graphs and knn_index phases): the RAG path
   on several workers, four legs. Threads: phase 7's loop at 4,096 docs and
   256 queries through ``pw.run(n_workers=4)`` (the thread-sharded
   runtime) against one worker, each under ``torch.profiler``: answers
   equal in keys, order and score bits; ingest docs/s, query rows/s,
   attention launches and the device's idle share of each. Exchange:
   phase 9's filter → join → groupby at 1,000,000 rows in 20 ticks on 4
   workers with the on-device exchange plane forced on
   (``PATHWAY_DEVICE_EXCHANGE=on``, plain and fused, 4 logical shards on the
   card) against the host plane: the same multiset of updates; rows
   exchanged, exchanges, rows netted, seconds. Sharded search:
   ``ShardedBruteForceKnnIndex`` at 1,000,000 x 384 f32 over 4 shards on
   the card, with a block of 1,000 identical rows, against
   ``BruteForceKnnIndex``: top-10 equal in keys and score bits at Q = 16
   and 1,024, the tied query's hits the block's first keys in the canonical
   order; Q = 16 p50 ms of both. Cluster: ``tools/rag_cluster.py`` at 2,048
   docs and 256 queries on 2 processes x 2 threads sharing the card, with
   a filesystem persistence backend, against one worker in this process:
   the same answers; then the same cluster under ``resilience.Supervisor``
   with ``PATHWAY_FAULT_PLAN=kill:proc=1,tick=34``: the restarted cluster's
   answers equal the uninterrupted run's;
15b. elastic (after multiworker): the elasticity plane. Leg A:
   ``tools/rag_cluster.py --persist DIR --http --pace-ms 300`` at 2,048
   docs and 256 queries (minilm, bf16, and the 4-layer reranker) on 2
   processes x 1 thread under ``resilience.Supervisor`` with
   ``PATHWAY_ELASTIC=manual``; once process 0's ``/status`` counts half the
   docs, ``python -m pathway_tpu_torch scale --to 3 --storage DIR``; the
   pod quiesces, exits 75 and is relaunched at 3, whose restore replays the
   logs (every doc embedded again on the card). Leg B: the same from 3
   processes with ``/scale?to=2`` on process 0's monitoring server. Gates
   per leg: one rescale and no restart, membership versions 0 -> 1, the
   net answers equal phase 15's one-worker run bit for bit, each (query,
   hit) once, every doc embedded at the new shape, input-log rows
   rebucketed against ``moved_fraction``, no plain attention call. Leg C:
   the migrate test's groupby pipeline under ``PATHWAY_SHARDMAP=on``, 2
   then 3 processes: migrated, not replayed; ranges moved ==
   ``shardmap.diff``; totals equal the rows' sums. Printed: seconds from
   the request to the pod's exit, the relaunch and the first answer at the
   new shape, docs re-embedded, attention launches per route, bytes moved
   beside a replay's;
16. train: contrastive training at phase 4's full width (vocab 32,768, d
   384, 6 heads, 6 layers, d_ff 1,536, seed 0) on 256 synth_docs pairs
   (each positive the same text) at L = 128, lr 1e-2: 10 steps in bf16
   with f32 parameters, then 3 in f32 (TF32 off), every attention's
   forward on ``attention_short.cu`` and backward on
   ``attention_short_bwd.cu`` (the backward checked against its plain
   version in phase 3); then the long leg, 64 pairs of 600-word docs at
   the encoder's max_len of 512 keys, 3 bf16 steps and 1 f32 step, every
   backward on the two-pass route. Gates: finite losses, the last below
   the first (legs of two steps or more), 12 forward and 12 backward
   launches a step (every backward on the fused route, on the two-pass
   route in the long leg), one step's loss
   and every gradient leaf equal to the same step with both plain
   attention functions within TRAIN_GRAD_TOL. Printed: ms a step, its
   forward and backward, tokens/s, one profiled step's attention ms (the
   backward's > 0, read under its kernels' names) and device idle share,
   the peak allocated memory;
17. multichip_dryrun: ``tools/multichip_dryrun.dryrun_multichip(4)`` on
   four logical shards of the card (a 2 x 2 TP/DP step equal to the
   unsharded one, the sharded KNN self-search, the key exchange, the
   sharded dataflow and the device plane against one worker);
18. fabric: ``tools/rag_cluster.py --serve`` (``DocumentStoreServer`` over
   1,024 docs) on one worker in this process, then on 2 processes x 2
   threads with ``PATHWAY_FABRIC=on`` and ``PATHWAY_SHARDMAP=on`` (every
   door its requests' owner) and with the fabric alone (the peer answers
   from its replica index); both doors answer the first 32 docs. Gates:
   every answer byte-identical to the coordinator's and to one worker's,
   each doc first in its own answer. Printed: replica-answered, forwarded
   and owner-answered counts and each door's p50;
19. the kernels line, with each kernel's launches during phases 4, 6, 7,
   8's pipeline, 10, 11, 12, 12b's run B, 13, 14, the flow phase, 15, 15b,
   16, 17 and 18 (the cluster processes' counts read from their output):
   the attention kernel's two routes and its backward's two dtypes, each
   with its launches per backward route, ``attention_any.cu``'s forward
   and backward per dtype (launched by 3b), with their launches per copy
   width and route, and the two-pass backward's kernels per dtype (both
   libraries, launched by 3b and 16); a kernel no path launched fails the
   run.

The last line is ``{"ok": true, "device": {...}}``. Any failure exits non-zero
without it. TF32 is off for every matmul (``allow_tf32 = False``), so the f32
KNN scores and f32 checks are true f32.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import threading
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
PIPE_DOCS = 16_384  # cut from 65,536 to pay for phases multiworker, train and fabric (PERF.md section 4)
PIPE_QUERIES = 512  # cut from 1,024 to pay for phases train and fabric
PIPE_TICK = 64
PIPE_K = 10
PIPE_SAME_DOCS = 4096  # microbatch off == auto at this size
#: the engine_kernels phase: engine_bench's pipeline
ENGINE_ROWS = 1_000_000
ENGINE_TICKS = 20
#: the tiered phase: knn_bench's corpus at 2x the default hot bound
#: (``PATHWAY_INDEX_HOT_ROWS``, internals/config.py), its query batches, and
#: the pipeline at 4x a 4,096-row hot bound
TIER_CORPUS = 131_072  # cut from 262,144 (4x the hot bound) to pay for phase multiworker
TIER_HOT = 65_536
TIER_QUERIES = 64
TIER_Q_BATCHES = (16, 256, 1024)
TIER_PIPE_HOT = 4096  # PIPE_DOCS / 4: cut from 16,384 with PIPE_DOCS
TIER_SAME_HOT = 1024  # microbatch off == auto: PIPE_SAME_DOCS docs, 4x this bound
INVARIANCE_CAPACITIES = (4096, 65_536, 1 << 20)
#: the temporal phase: a Nexmark-shaped stream (``tools/nexmark.py``) in
#: ticks of TEMPORAL_TICK events, the queries, and the rest of the temporal
#: surface on the first TEMPORAL_SURFACE_EVENTS events
TEMPORAL_EVENTS_GENERATED = 1_048_576  # the stream; the runs read its first TEMPORAL_EVENTS
TEMPORAL_EVENTS = 131_072  # 2 ticks; cut from 524,288 to keep the whole script near 850 s (PERF.md section 4)
TEMPORAL_TICK = 65_536
TEMPORAL_SURFACE_EVENTS = 65_536
TEMPORAL_QUERIES = ("q5", "q7", "q7_cutoff", "q8")
TEMPORAL_WORKERS = 6  # processes running the phase's 18 runs, longest first
#: the bert_path phase: all-MiniLM-L6-v2's published widths, random weights
BERT_DOCS = 8192
BERT_BATCH = 1024
#: the document_store phase: a file corpus read by pw.io.fs into DocumentStore
DS_FILES = 2048  # cut from 8,192 to pay for phases multiworker, train and fabric (PERF.md section 4)
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
#: the 1-client retrieve leg sends the first this many of the payloads (cut
#: from all 1,024 to keep the whole script in its time; PERF.md section 4):
#: one client is a latency leg, 256 sequential requests give its p50/p99
RS_ONE_CLIENT_REQUESTS = 256
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
    # each library's SASS read by its own cuobjdump, all three at once
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(_build.SOURCES)) as pool:
        hmmas = dict(zip(_build.SOURCES, pool.map(
            lambda name: _sass_tensor_ops(str(_build.library_path(name)), tool_dir), _build.SOURCES)))
    for name in _build.SOURCES:
        # ptxas speaks only when this run compiled the kernel; the SASS is read
        # from the library either way
        per_fn = _ptxas_per_function(_build.build_logs.get(name, ""))
        hmma = hmmas[name]
        nice = _demangle(sorted(set(per_fn) | set(hmma)), tool_dir)
        ptxas[name] = {nice[f]: v for f, v in per_fn.items()}
        sass[name] = {nice[f]: n for f, n in hmma.items()}
    # each route's instantiations (8 head widths x resident / streamed x
    # exact width / narrower head) must run on the tensor cores
    n_widths = len(A.KERNEL_WIDTHS)
    tc = {f: n for f, n in sass.get("attention_short", {}).items() if "attention_tc_kernel" in f}
    for dname, tname in (("bf16", "__nv_bfloat16"), ("f32", "float")):
        mine = {f: n for f, n in tc.items() if f"attention_tc_kernel<{tname}," in f}
        check(len(mine) == 4 * n_widths,
              f"{dname} route: {len(mine)} tensor-core instantiations in the SASS, expected {4 * n_widths}")
        check(all(n > 0 for n in mine.values()), f"{dname} route without HMMA/HGMMA in its SASS: {mine}")
    # the fused backward: bf16 at every width and f32 up to 64, each at
    # L = 128 and at any length
    n_fused = 2 * (n_widths + sum(w <= 64 for w in A.KERNEL_WIDTHS))
    fused = {f: n for f, n in sass.get("attention_short_bwd", {}).items()
             if any(k in f for k in A.BACKWARD_KERNELS["fused"])}
    check(len(fused) == n_fused and all(n > 0 for n in fused.values()),
          f"fused backward: {len(fused)} instantiations, HMMA/HGMMA per instantiation {fused}, "
          f"expected {n_fused}, all > 0")
    # the two-pass backward: both kernels at every width, both dtypes, on
    # the tensor cores, in the aligned library and in attention_any.cu
    def two_pass(lib):
        return {f: n for f, n in sass.get(lib, {}).items() if any(k in f for k in A.BACKWARD_KERNELS["two_pass"])}

    for lib, n_tp in (("attention_short_bwd", 4 * n_widths), ("attention_any", 4 * len(A.ANY_WIDTHS))):
        tp = two_pass(lib)
        check(len(tp) == n_tp and all(n > 0 for n in tp.values()),
              f"two-pass backward in {lib}: {len(tp)} instantiations, HMMA/HGMMA {tp}, expected {n_tp}, all > 0")
    # attention_any.cu: the forward at each full width of
    # ANY_FORWARD_WIDTHS per dtype and its column-blocked kernel above 256
    # columns, the fused backward at any copy width (bf16 at every block
    # width, f32 up to 64), all on the tensor cores; every forward
    # instantiation without a spill or a stack frame (where this run
    # compiled it)
    anyk = sass.get("attention_any", {})
    n_any = len(A.ANY_WIDTHS)
    for dname, tname in (("bf16", "__nv_bfloat16"), ("f32", "float")):
        for kname, n_want in (("attention_any_kernel", len(A.ANY_FORWARD_WIDTHS)), ("attention_any_cols_kernel", 1)):
            mine = {f: n for f, n in anyk.items() if f"{kname}<{tname}," in f}
            check(len(mine) == n_want and all(n > 0 for n in mine.values()),
                  f"{dname} any-width forward {kname}: {len(mine)} instantiations, HMMA/HGMMA {mine}, "
                  f"expected {n_want}, all > 0")
    fwd_ptxas = {f: v for f, v in ptxas.get("attention_any", {}).items() if "attention_any_" in f and "_kernel<" in f}
    for f, v in fwd_ptxas.items():
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", v)
        check(m is not None and m.groups() == ("0", "0", "0"), f"any-width forward {f}: ptxas says {v!r}, "
              f"expected no stack frame and no spill")
    fused_any = {f: n for f, n in anyk.items() if "attention_bwd_fused" in f}
    n_fused_any = n_any + sum(w <= 64 for w in A.ANY_WIDTHS)
    check(len(fused_any) == n_fused_any and all(n > 0 for n in fused_any.values()),
          f"fused backward at any copy width: {len(fused_any)} instantiations, HMMA/HGMMA {fused_any}, "
          f"expected {n_fused_any}, all > 0")

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
        f"{str(dt).replace('torch.', '')} {case}": A.launch_geometry(B, L, H, hd, dt, _projection_copy(H, hd, dt)).smem_bytes
        for dt in (torch.bfloat16, torch.float32) for case, (B, L, H, hd) in {**KERNEL_SHAPES, **ANY_SHAPES}.items()
    }
    bwd_geo = {
        f"{str(dt).replace('torch.', '')} {case}":
            A.backward_launch_geometry(B, L, H, hd, dt, _projection_copy(H, hd, dt))._asdict()
        for dt in (torch.bfloat16, torch.float32) for case, (B, L, H, hd) in BWD_SHAPES.items()
    }
    emit(
        "build", seconds=build_s, per_kernel_s=per_kernel, ptxas=ptxas,
        sass_tensor_ops=sass, dynamic_smem_bytes=smem, backward_geometry=bwd_geo,
        tokenizer="native" if tok is not None else "python",
        tokenizer_build_s=native.build_seconds.get("pwtok"), tokenizer_load_s=tok_s,
        tokenizer_error=native.last_error.get("pwtok"), c_compiler=cc,
    )


def _projection_copy(H: int, hd: int, dtype) -> int:
    """The copy width (bytes) of q/k/v as the column views of one
    contiguous [B, L, 3D] projection, D = H * hd (``_attention_inputs``'s
    and the encoder's layout): the lowest set bit of hd, D and 3D in bytes,
    at most 16."""
    import torch

    es = torch.empty(0, dtype=dtype).element_size()
    x = hd * es | H * hd * es | 3 * H * hd * es | 16
    return x & -x


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


#: (B, L, heads, hd) of each checked case: the main path's three shapes
#: (the rerank case at the reranker's longest input), then 512 keys, a
#: length that fills no tile evenly, the other instantiated widths (hd 128
#: and hd 16 both with K and V resident and streamed), the bert_path's
#: ingest batch (12 heads of 32), multichip_dryrun's encoder (4 heads of 16
#: at d 64, L 16), the widths that run in a wider instantiation (8 in 16,
#: 24 in 32, 80 in 80 ... each at B 64, L 128; 48 also streamed at L 200),
#: the long lengths (1,024 and 4,096 keys at 6 x 64; 8,192 at 3 x 128, past
#: the shared bytes the per-key fills took before they rode in the ring)
#: and an embed-like batch at hd 96
KERNEL_SHAPES = {
    "embed": (1024, 128, 6, 64), "query": (1, 16, 6, 64), "rerank": (10, 256, 6, 64),
    "max_len": (4, 512, 6, 64), "ragged": (3, 77, 6, 64), "hd32": (2, 128, 12, 32),
    "hd128": (2, 256, 3, 128), "hd128_resident": (2, 128, 3, 128), "bert_embed": (1024, 128, 12, 32),
    "hd16": (64, 128, 24, 16), "hd16_streamed": (4, 200, 24, 16), "dryrun": (8, 16, 4, 16),
    "hd8": (64, 128, 48, 8), "hd24": (64, 128, 16, 24), "hd48": (64, 128, 8, 48), "hd80": (64, 128, 4, 80),
    "hd96": (64, 128, 4, 96), "hd112": (64, 128, 3, 112), "hd48_streamed": (4, 200, 8, 48),
    "l1024": (4, 1024, 6, 64), "l4096": (2, 4096, 6, 64), "l8192_hd128": (2, 8192, 3, 128),
    "hd96_embed": (1024, 128, 4, 96),
}
#: attention_any.cu's cases, (B, L, heads, hd): every head width the
#: aligned kernels do not take and some they do, each in 3 heads (D = 3 hd,
#: so the [B, L, 3D] projection's rows are unaligned wherever 3 hd
#: elements are not a multiple of 16 bytes: copies of 2, 4, 8 and 16
#: bytes in bf16, 4, 8 and 16 in f32, hd 6 the f32 case of 8; hd 320 in
#: three column blocks, past the full-width kernel), at 16, 128 and 600
#: keys; then the two encoders of phase encoder_widths at their
#: attention's shape (32 heads of 12, 3 of 256). Every case is timed.
ANY_HEAD_WIDTHS = (1, 4, 6, 12, 20, 36, 100, 136, 192, 256, 320)
ANY_LENGTHS = {16: 64, 128: 32, 600: 4}  # L -> B
ANY_SHAPES = {f"any_hd{hd}_l{L}": (B, L, 3, hd) for hd in ANY_HEAD_WIDTHS for L, B in ANY_LENGTHS.items()}
ANY_SHAPES.update({"enc_hd12": (1024, 128, 32, 12), "enc_hd256": (1024, 128, 3, 256)})
#: the timed cases per dtype: both routes at the main path's shapes, at
#: bert_path's batch, at multichip_dryrun's, at an embed-like batch of hd
#: 96 and at 1,024 keys
TIMED = {"bfloat16": ("embed", "query", "rerank", "bert_embed", "dryrun", "hd96_embed", "l1024"),
         "float32": ("embed", "query", "rerank", "bert_embed", "dryrun", "hd96_embed", "l1024")}


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
    records = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        es = torch.empty(0, dtype=dtype).element_size()
        for label, (B, L, H, hd) in {**KERNEL_SHAPES, **ANY_SHAPES}.items():
            D, scale = H * hd, hd ** -0.5
            q, k, v, mask = _attention_inputs(B, L, dtype, gen, H, hd)
            vb = A.copy_width(hd, es, q, k, v)
            geo = A.launch_geometry(B, L, H, hd, dtype, vb)
            # the route by the rule the kernels state: 16-byte copies of a
            # head of at most 128 columns on attention_short.cu, every other
            # head on attention_any.cu
            want_route = A.ROUTES[dtype] if vb == 16 and hd <= 128 else A.ANY_ROUTES[dtype][0]
            check(vb == _projection_copy(H, hd, dtype) and geo.route == want_route,
                  f"attention {label} {dname}: copy width {vb}, route {geo.route}, expected {want_route}")
            before = dict(A.ROUTE_LAUNCHES)
            out = A.attention_short_flat(q, k, v, mask, H, scale)
            torch.cuda.synchronize()
            check(A.ROUTE_LAUNCHES[geo.route] == before[geo.route] + 1,
                  f"attention {label} {dname}: the call did not launch on route {geo.route}")
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
                "case": label, "dtype": dname, "route": geo.route, "B": B, "L": L, "H": H, "hd": hd,
                "kernel_width": geo.width, "col_blocks": geo.col_blocks, "copy_bytes": geo.copy_bytes,
                "rows_per_block": geo.rows, "resident": geo.resident, "smem_bytes": geo.smem_bytes,
                "max_abs_err": err.max().item(), "masked_row_vs_mean_v": err_masked,
                "tolerance": tol, "ok": ok and ok_masked,
            }
            if label in TIMED[dname] or label in ANY_SHAPES:
                iters = 20 if label in ("embed", "hd96_embed", "l1024") or label in ANY_SHAPES else 200
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


#: the encoder leg of every head width: (d_model, heads, d_ff, max_len,
#: words per doc) of each config, 6 layers otherwise, and the docs each
#: embeds on the card per dtype: 8 heads of 48 (the 48-wide instantiation),
#: 6 of 64 at 1,024 keys (the streamed route), 32 heads of 12 at d 384
#: (bf16 rows of 24 bytes: attention_any.cu at 8-byte copies; f32 the
#: aligned kernel) and 3 heads of 256 at d 768 (two column blocks of 128)
ENC_WIDTHS = {"hd48": (384, 8, 1536, 128, DOC_WORDS), "len1024": (384, 6, 1536, 1024, 1100),
              "hd12": (384, 32, 1536, 128, DOC_WORDS), "hd256": (768, 3, 3072, 128, DOC_WORDS)}
ENC_WIDTH_DOCS = 1024
ENC_WIDTH_BATCH = {128: INGEST_BATCH, 1024: 128}
#: embeddings checked against the CPU path per max_len: at 1,024 keys cut
#: from 64 to 8 (the CPU's 64 took 54 s of the script's 1,007; PERF.md
#: section 4)
ENC_WIDTH_CHECKED = {128: 64, 1024: 8}
#: one contrastive train step on the kernels against the same step on the
#: plain attention, per config and dtype (TRAIN_GRAD_TOL), on
#: ENC_WIDTH_TRAIN_PAIRS pairs of TRAIN_LEN tokens
ENC_WIDTH_TRAIN = {"hd12": ("bfloat16",), "hd256": ("bfloat16", "float32")}
ENC_WIDTH_TRAIN_PAIRS = 64


def phase_encoder_widths(info: dict) -> dict:
    """Encoders at head widths and lengths beyond the main path's on the
    card (ENC_WIDTHS), each in bf16 and in f32, ENC_WIDTH_DOCS docs per
    run. Gates: every attention launch on the kernel route the head's copy
    width and width pick (6 per batch), and the first
    ENC_WIDTH_CHECKED[max_len] embeddings against the port's CPU path within
    main_path's tolerances (bf16 1e-2, f32 1e-4); for the configs of
    ENC_WIDTH_TRAIN one train step whose loss and gradients are within
    TRAIN_GRAD_TOL of the same step on the plain attention, every forward
    and backward launch on its kernel route."""
    import torch

    from pathway_tpu_torch.convert import tree_map
    from pathway_tpu_torch.ops import attention_kernel as A
    from pathway_tpu_torch.ops.encoder import EncoderConfig, TorchSentenceEncoder, init_params

    out, launches, bwd_launches = {}, {}, {}
    for name, (d, heads, d_ff, max_len, words) in ENC_WIDTHS.items():
        docs = synth_docs(ENC_WIDTH_DOCS, words)
        hd = d // heads
        for dtype, tol in ((torch.bfloat16, 1e-2), (torch.float32, 1e-4)):
            dname = str(dtype).replace("torch.", "")
            cfg = EncoderConfig(vocab_size=32768, d_model=d, n_heads=heads, n_layers=6, d_ff=d_ff,
                                max_len=max_len, dtype=dtype)
            kw = {"param_dtype": torch.bfloat16} if dtype == torch.bfloat16 else {}
            enc = TorchSentenceEncoder(cfg, seed=0, device=DEVICE, **kw)
            ids, _ = enc.tokenizer(docs)
            check(ids.shape[1] == max_len, f"encoder_widths {name}: tokenized to L={ids.shape[1]}, expected {max_len}")
            batch = ENC_WIDTH_BATCH[max_len]
            route = A.launch_geometry(batch, max_len, heads, hd, dtype, _projection_copy(heads, hd, dtype)).route
            enc.encode_ids_device(ids[:batch])  # warm-up at the batch shape, outside the counts
            sync()
            # --- the leg: counts from 0 -----------------------------------------
            _reset_attention_counts()
            t0 = time.perf_counter()
            embs = [enc.encode_ids_device(ids[i : i + batch]) for i in range(0, len(ids), batch)]
            sync()
            secs = time.perf_counter() - t0
            n_launches, by_route, by_copy = A.LAUNCHES, dict(A.ROUTE_LAUNCHES), dict(A.COPY_LAUNCHES)
            # ------------------------------------------------------------------
            expected = cfg.n_layers * len(embs)
            check(by_route[route] == expected and n_launches == expected,
                  f"encoder_widths {name} {dname}: launches {by_route}, expected {expected} on {route}")
            n_checked = ENC_WIDTH_CHECKED[max_len]
            e_gpu = torch.cat(embs)[:n_checked].float().cpu().numpy()
            t_cpu = time.perf_counter()
            cpu = TorchSentenceEncoder(cfg, seed=0, device="cpu", **kw)
            e_cpu = cpu.encode_ids_device(ids[:n_checked]).float().numpy()
            t_cpu = time.perf_counter() - t_cpu
            err = float(np.abs(e_cpu - e_gpu).max())
            check(bool(np.isfinite(e_gpu).all()) and err <= tol,
                  f"encoder_widths {name} {dname}: card vs CPU embeddings differ by {err} (tolerance {tol})")
            key = f"{name}_{dname}"
            launches[key] = by_route
            out[key] = {"d_model": d, "heads": heads, "hd": hd, "route": route,
                        "kernel_width": A.launch_geometry(batch, max_len, heads, hd, dtype,
                                                          _projection_copy(heads, hd, dtype)).width,
                        "max_len": max_len, "docs": len(ids), "batch": batch, "seconds": secs,
                        "docs_per_s": len(ids) / secs, "launches": by_route, "copy_launches": by_copy,
                        "launches_expected": expected, "card_vs_cpu_max_abs_err": err, "tolerance": tol,
                        "checked": n_checked, "cpu_check_s": t_cpu}
            del enc, cpu, embs
            if dname in ENC_WIDTH_TRAIN.get(name, ()):
                params = tree_map(lambda t: t.to(DEVICE), init_params(cfg, torch.Generator().manual_seed(0)))
                tbatch = _train_batch(ENC_WIDTH_TRAIN_PAIRS)
                vb = _projection_copy(heads, hd, dtype)
                bwd_route = A.backward_launch_geometry(ENC_WIDTH_TRAIN_PAIRS, TRAIN_LEN, heads, hd, dtype, vb).route
                _reset_attention_counts()  # the kernels' step: counts from 0
                t0 = time.perf_counter()
                vs = _kernel_vs_plain_step(params, cfg, tbatch, TRAIN_GRAD_TOL[dname])
                vs["seconds"] = time.perf_counter() - t0
                fwd, bwd = _attention_counts()
                per_step = 2 * cfg.n_layers
                fwd_route = A.launch_geometry(ENC_WIDTH_TRAIN_PAIRS, TRAIN_LEN, heads, hd, dtype, vb).route
                check(vs["ok"], f"encoder_widths {name} {dname}: the kernels' train step differs from the "
                      f"plain-attention step: {vs}")
                check(fwd[fwd_route] == sum(fwd.values()) == per_step and bwd[bwd_route] == sum(bwd.values()) == per_step,
                      f"encoder_widths {name} {dname} train step: launches forward {fwd} backward {bwd}, "
                      f"expected {per_step} each on {fwd_route} / {bwd_route}")
                vs.update(pairs=ENC_WIDTH_TRAIN_PAIRS, forward_route=fwd_route, backward_route=bwd_route,
                          backward_copy_launches=dict(A.BACKWARD_COPY_LAUNCHES))
                out[key]["train_step"] = vs
                for r, n in fwd.items():
                    launches[key][r] += n
                bwd_launches[key] = bwd
                del params
            torch.cuda.empty_cache() if DEVICE == "cuda" else None
    emit("encoder_widths", card=info["nvidia_smi"], **out)
    total: dict = dict.fromkeys(A.ROUTE_LAUNCHES, 0)
    for by_route in launches.values():
        for r, n in by_route.items():
            total[r] += n
    bwd_total: dict = dict.fromkeys(A.BACKWARD_ROUTE_LAUNCHES, 0)
    for by_route in bwd_launches.values():
        for r, n in by_route.items():
            bwd_total[r] += n
    return {"launches": total, "backward_launches": bwd_total, "metrics": out}


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

    # 1. identity gate: 2x the hot bound, exact cold tier; the devices the
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


#: the reference's tests of the engine's core Table API, run as the port's
#: pipelines (their sources read with ``pathway_tpu`` as
#: ``pathway_tpu_torch``; tests/test_torch_<name>.py holds each to the
#: reference on the CPU)
ENGINE_SEM_FILES = ("table_ops", "joins", "reducers", "expressions", "edge_cases", "errors", "core_types",
                    "differential_fuzz", "engine_perf_paths", "blocks_dtypes")
#: cases whose rows land in wall-clock ticks (a live subject, a REST round
#: trip, an async UDF): compared by their final rows
ENGINE_SEM_FINAL = {"test_rest_server_round_trip", "test_udf_async", "test_join_groupby_first_load_then_deltas",
                    "test_outer_join_first_load_then_retraction",
                    "test_outer_join_float_pad_retraction_consistency"}
#: the differential fuzz at this many events (the reference test's
#: generator, pipelines and streamed-against-static comparison)
ENGINE_SEM_FUZZ_ROWS = 65_536
#: shape 0: filter -> join -> groupby sum; 3: outer join -> groupby count
#: (the other two cut to keep the phase within 30 s; PERF.md section 4)
ENGINE_SEM_FUZZ_SHAPES = (0, 3)


def _port_module(name: str, path: str, cache: dict):
    """A reference test file (or ``tests/utils.py``) read as the port's:
    ``pathway_tpu`` as ``pathway_tpu_torch``, its helpers from the port's
    copy of ``tests/utils.py``. Nothing of the JAX package is imported."""
    import re
    import types

    if name in cache:
        return cache[name]
    if "_engine_sem_utils" not in sys.modules and name != "_engine_sem_utils":
        _port_module("_engine_sem_utils", os.path.join(os.path.dirname(path), "utils.py"), cache)
    with open(path) as f:
        src = re.sub(r"\bpathway_tpu\b", "pathway_tpu_torch", f.read())
    src = re.sub(r"""(["'])tests\.utils\1""", '"_engine_sem_utils"', src)
    src = re.sub(r"^(\s*)from (tests\.)?utils import", r"\1from _engine_sem_utils import", src, flags=re.M)
    mod = types.ModuleType(name)
    mod.__file__ = path
    exec(compile(src, path, "exec"), mod.__dict__)
    if name == "_engine_sem_utils":
        sys.modules[name] = mod
    cache[name] = mod
    return mod


def _param_cases(fn) -> list[tuple[str, dict]]:
    """(id, kwargs) of each case pytest's ``parametrize`` marks give ``fn``."""
    import itertools

    marks = [m for m in getattr(fn, "pytestmark", []) if m.name == "parametrize"]
    if not marks:
        return [(fn.__name__, {})]
    axes = [[(m.args[0], v) for v in m.args[1]] for m in marks]
    return [(f"{fn.__name__}[{'-'.join(str(v) for _n, v in combo)}]", {n: v for n, v in combo})
            for combo in itertools.product(*axes)]


def _bits(v):
    """A value with every float as its IEEE bits, so equality is equality
    of bits."""
    if isinstance(v, (float, np.floating)):
        return ("f64", np.float64(v).view(np.uint64).item())
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, (tuple, list)):
        return tuple(_bits(x) for x in v)
    if isinstance(v, np.ndarray):
        return ("nd", v.dtype.str, _bits(v.ravel().tolist()))
    if type(v).__name__ in ("_Error", "Json", "Pointer"):
        return (type(v).__name__, str(v))
    return v


def _recorded_run(fn, kwargs: dict, final: bool) -> list:
    """Run one test body; every table it captured as its update stream
    (consolidated per tick: the net diff of each (time, key, values)), or
    as its final rows by key."""
    import pytest

    from collections import Counter

    from pathway_tpu_torch.engine import operators as ops

    nodes, init = [], ops.CaptureNode.__init__

    def capture_init(node, *a, **kw):
        init(node, *a, **kw)
        nodes.append(node)

    mp = pytest.MonkeyPatch()
    mp.setattr(ops.CaptureNode, "__init__", capture_init)
    import pathway_tpu_torch as pw

    pw.G.clear()
    try:
        params = fn.__code__.co_varnames[: fn.__code__.co_argcount]
        fn(**kwargs, **({"monkeypatch": mp} if "monkeypatch" in params else {}))
    finally:
        mp.undo()
        pw.G.clear()
    out = []
    for node in nodes:
        net: Counter = Counter()
        for t, k, d, row in node.deltas:
            net[((None if final else t), int(k), _bits(tuple(row)))] += d
        out.append(sorted((e, n) for e, n in net.items() if n))
    return out


def _engine_registry(tests_dir: str) -> list[tuple[str, object, dict]]:
    """(case, function, kwargs) of every test of ENGINE_SEM_FILES."""
    cache: dict = {}
    cases = []
    for name in ENGINE_SEM_FILES:
        mod = _port_module(f"_engine_sem_{name}", os.path.join(tests_dir, f"test_{name}.py"), cache)
        for attr, fn in vars(mod).items():
            if attr.startswith("test_") and callable(fn):
                for cid, kw in _param_cases(fn):
                    cases.append((f"{name}::{cid}", fn, kw))
    return cases


def phase_engine_semantics(info: dict) -> dict:
    """The engine's core Table API on the card: every case of the
    reference's ten Table API test files (ENGINE_SEM_FILES; the mirrors in
    tests/test_torch_<name>.py hold the port to the reference on the CPU),
    run as the port's pipelines with ``PATHWAY_ENGINE_JAX=gpu`` and the
    fused device tier forced on (``PATHWAY_FUSE_JAX=on``) against the same
    cases with both on CPU tensors (``cpu``); the device functions' size
    thresholds are set to 1 for the phase, so every groupby segment-sum and
    join probe of engine/torch_kernels.py runs on the card (the thresholds
    are a speed choice: the values do not depend on them). Each case's
    update streams (consolidated per tick; final rows by key for the
    wall-clock cases of ENGINE_SEM_FINAL) must equal the CPU run's bit for
    bit, and each body's own assertions pass. Then the differential fuzz
    (the reference test's generator and pipelines) at ENGINE_SEM_FUZZ_ROWS
    events with ``PATHWAY_AUDIT=off``: on the card streamed (5 ticks)
    equal to one static load, and the card's static rows equal to the CPU
    tensors', bit for bit.
    Routes taken: ``torch_kernels.ROUTES`` (``grouped/``, ``probe/``,
    ``fused/<device>``)."""
    from pathway_tpu_torch.engine import torch_kernels as K

    tests_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    card = "gpu" if DEVICE == "cuda" else "cpu"
    keys = ("PATHWAY_ENGINE_JAX", "PATHWAY_FUSE_JAX", "PATHWAY_FUSE_JAX_MIN_ROWS", "PATHWAY_AUDIT")
    saved_env = {k: os.environ.get(k) for k in keys}
    saved_k = (K._MIN_ROWS, K.probe_eligible)
    cases = _engine_registry(tests_dir)
    out = {"card": info["nvidia_smi"], "cases": len(cases), "files": len(ENGINE_SEM_FILES)}
    try:
        os.environ["PATHWAY_AUDIT"] = "off"
        os.environ["PATHWAY_FUSE_JAX"] = "on"
        os.environ["PATHWAY_FUSE_JAX_MIN_ROWS"] = "1"
        K._MIN_ROWS = 1
        K.probe_eligible = lambda n_state, n_query: K.flag() not in ("0", "false", "auto")
        runs, routes, secs = {}, {}, {}
        for flag in ("cpu", card):
            os.environ["PATHWAY_ENGINE_JAX"] = flag
            K.ROUTES.clear()
            t0 = time.perf_counter()
            runs[flag] = {}
            for cid, fn, kw in cases:
                try:
                    runs[flag][cid] = _recorded_run(fn, kw, cid.split("::")[1].split("[")[0] in ENGINE_SEM_FINAL)
                except Exception as e:  # the body's own assertion, or a raise the body did not expect
                    runs[flag][cid] = f"FAILED: {type(e).__name__}: {str(e)[:300]}"
            sync()
            secs[flag] = time.perf_counter() - t0
            routes[flag] = dict(K.ROUTES)
        failed = {c: r for c, r in runs[card].items() if isinstance(r, str)}
        differ = [c for c in runs["cpu"] if runs["cpu"][c] != runs[card][c]]
        check(not failed, f"engine_semantics: cases failed on {card}: {failed}")
        check(not differ, f"engine_semantics: {len(differ)} cases differ from the CPU run: {differ[:10]}")
        on_card = {r: n for r, n in routes[card].items() if not r.endswith("/cpu")}
        if DEVICE == "cuda":
            for kind in ("grouped", "probe", "fused"):
                check(any(r.startswith(kind + "/cuda") for r in on_card),
                      f"engine_semantics: no {kind} call on the card, routes {routes[card]}")
        out.update(registry_s=secs, routes=routes, cases_failed=len(failed), cases_differing=len(differ),
                   captures=sum(len(r) for r in runs[card].values() if not isinstance(r, str)),
                   updates=sum(len(s) for r in runs[card].values() if not isinstance(r, str) for s in r))

        # the differential fuzz at ENGINE_SEM_FUZZ_ROWS events: on the card
        # streamed and static, on CPU tensors static
        fuzz = _port_module("_engine_sem_differential_fuzz", os.path.join(tests_dir, "test_differential_fuzz.py"), {})
        fuzz_out: dict = {"cpu": {"seconds": 0.0, "routes": {}}, card: {"seconds": 0.0, "routes": {}}}
        final_rows = {}
        for shape in ENGINE_SEM_FUZZ_SHAPES:
            rng = np.random.default_rng(1000 + shape)
            events = fuzz._make_rows(rng, ENGINE_SEM_FUZZ_ROWS)
            right = [(int(k), int(w)) for k, w in zip(rng.integers(0, ENGINE_SEM_FUZZ_ROWS // 4, 4096),
                                                      rng.integers(1, 9, 4096))]
            got = {}
            for flag, streamed in ((card, True), (card, False), ("cpu", False)):
                os.environ["PATHWAY_ENGINE_JAX"] = flag
                K.ROUTES.clear()
                t0 = time.perf_counter()
                left_t, right_t = fuzz._tables(events, right, streamed=streamed, n_times=5 if streamed else 1)
                got[(flag, streamed)] = _recorded_run(
                    lambda: fuzz.rows_of(fuzz._pipeline(left_t, right_t, shape)), {}, True)
                sync()
                fuzz_out[flag]["seconds"] += time.perf_counter() - t0
                for r, n in K.ROUTES.items():
                    fuzz_out[flag]["routes"][r] = fuzz_out[flag]["routes"].get(r, 0) + n
            check(got[(card, True)] == got[(card, False)],
                  f"engine_semantics fuzz shape {shape} on {card}: streamed differs from the static load")
            check(got[(card, False)] == got[("cpu", False)],
                  f"engine_semantics fuzz shape {shape}: the card's rows differ from the CPU's")
            final_rows[str(shape)] = sum(len(x) for x in got[(card, False)])
        if DEVICE == "cuda":
            check(any(r.startswith("fused/cuda") for r in fuzz_out[card]["routes"]),
                  f"engine_semantics fuzz: no fused chain on the card, routes {fuzz_out[card]['routes']}")
        out["fuzz"] = {"events": ENGINE_SEM_FUZZ_ROWS, "shapes": list(ENGINE_SEM_FUZZ_SHAPES),
                       "final_rows": final_rows, **fuzz_out}
    finally:
        K._MIN_ROWS, K.probe_eligible = saved_k
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    emit("engine_semantics", **out)
    return out


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


#: the connectors phase: CN_FILES seeded files reach one DocumentStore
#: through five connectors (files per source), then CN_QUERIES retrieve
#: queries arrive on a NATS topic and the answers leave through NATS,
#: Logstash, Pub/Sub (and Delta Lake and Iceberg where pyarrow imports);
#: CN_NOISE of the queries are words of no doc, whose low top scores feed
#: the Slack alerts
CN_SOURCES = {"gdrive": 512, "pyfilesystem": 512, "sqlite": 512, "nats": 256, "airbyte": 256}
CN_SUBDIRS = 64
CN_SQLITE_COMMIT = 64
CN_SQLITE_UPDATES = 64
CN_QUERIES = 1024
CN_NOISE = 64
CN_TICK = 64
CN_K = 6
CN_TIMEOUT_S = 300
#: an answer whose best hit scores below this cosine raises an alert (a
#: query of the corpus scores its own chunk first, at 1 to float rounding)
CN_ALERT_SCORE = 0.99

_AIRBYTE_SOURCE = '''
import argparse, json, sys

p = argparse.ArgumentParser()
p.add_argument("command")
p.add_argument("--config")
p.add_argument("--catalog")
p.add_argument("--state")
a = p.parse_args()
CATALOG = {"streams": [{"name": "docs", "json_schema": {}, "supported_sync_modes": ["incremental"]}]}
if a.command == "discover":
    print(json.dumps({"type": "CATALOG", "catalog": CATALOG}))
    sys.exit(0)
cfg = json.load(open(a.config))
cursor = int((json.load(open(a.state)) if a.state else {}).get("cursor", 0))
rows = [json.loads(line) for line in open(cfg["corpus"], encoding="utf-8")]
for row in rows[cursor:]:
    print(json.dumps({"type": "RECORD", "record": {"stream": "docs", "data": row, "emitted_at": 0}}))
print(json.dumps({"type": "STATE", "state": {"cursor": len(rows)}}))
'''


class _Drive:
    """A Drive transport over files in memory (``pw.io.gdrive``'s ``client=``
    surface: ``tree`` and ``download``)."""

    def __init__(self, files: list[tuple[str, str]]):
        self.meta = {f"g{i}": {"id": f"g{i}", "name": path, "mimeType": "text/plain",
                               "modifiedTime": "2024-01-01T00:00:00Z", "size": str(len(text.encode()))}
                     for i, (path, text) in enumerate(files)}
        self.data = {f"g{i}": text.encode() for i, (_p, text) in enumerate(files)}
        self.downloads = 0

    def tree(self, object_id: str) -> dict:
        return {k: dict(m) for k, m in self.meta.items()}

    def download(self, meta: dict) -> bytes:
        self.downloads += 1
        return self.data[meta["id"]]


class _DirFS:
    """An fs-shaped object (``pw.io.pyfilesystem``'s surface: ``listdir``,
    ``isdir``, ``readbytes``, ``getinfo``) over a local directory."""

    def __init__(self, root: str):
        self.root = root

    def _p(self, path: str) -> str:
        return os.path.join(self.root, path.lstrip("/"))

    def listdir(self, path):
        return sorted(os.listdir(self._p(path)))

    def isdir(self, path):
        return os.path.isdir(self._p(path))

    def readbytes(self, path):
        with open(self._p(path), "rb") as f:
            return f.read()

    def getinfo(self, path, namespaces=()):
        mtime = os.stat(self._p(path)).st_mtime

        class Info:
            raw = {"details": {"modified": mtime}}
            modified = mtime

        return Info()


class _Broker:
    """An in-process NATS broker (``pw.io.nats``'s ``client_factory``
    surface): topics are lists of payloads; a subscriber reads from the
    start and, once it has caught up, waits up to 0.1 s for a message
    before it yields None, as the nats-py adapter's queue does."""

    def __init__(self):
        self.topics: dict[str, list[bytes]] = {}
        self.times: dict[str, list[float]] = {}  # host clock of each publish
        self.cond = threading.Condition()
        self.closed = 0

    def publish(self, topic: str, payload: bytes) -> None:
        with self.cond:
            self.topics.setdefault(topic, []).append(payload)
            self.times.setdefault(topic, []).append(time.perf_counter())
            self.cond.notify_all()

    def connect(self, uri):
        broker = self

        class Conn:
            def subscribe(self, topic):
                pos = 0
                while True:
                    with broker.cond:
                        msgs = broker.topics.get(topic, [])
                        if pos >= len(msgs):
                            broker.cond.wait(timeout=0.1)
                            msgs = broker.topics.get(topic, [])
                        msg = msgs[pos] if pos < len(msgs) else None
                    if msg is None:
                        yield None
                    else:
                        pos += 1
                        yield msg

            def publish(self, topic, payload):
                broker.publish(topic, payload)

            def close(self):
                broker.closed += 1

        return Conn()


class _Publisher:
    """A Pub/Sub publisher (``pw.io.pubsub``'s surface)."""

    def __init__(self):
        self.published: list[tuple[str, bytes, dict]] = []
        self.times: list[float] = []  # host clock of each publish

    def topic_path(self, project, topic):
        return f"projects/{project}/topics/{topic}"

    def publish(self, topic_path, data, **attrs):
        self.published.append((topic_path, data, attrs))
        self.times.append(time.perf_counter())

        class Done:
            def result(self):
                return "id"

        return Done()


def _logstash_server() -> tuple:
    """A local HTTP server that records each POSTed JSON body and the host
    clock it arrived at."""
    import http.server

    posts: list = []
    times: list = []

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_POST(self):
            n = int(self.headers["Content-Length"])
            posts.append(json.loads(self.rfile.read(n)))
            times.append(time.perf_counter())
            self.send_response(200)
            self.end_headers()

        def log_message(self, *a):
            pass

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, posts, times


def _real_rows(batch: list) -> int:
    """The real rows of a padded launch: the microbatcher pads with repeats
    of the last row (the corpus has no duplicate chunk)."""
    n = len(batch)
    while n > 1 and batch[n - 2] == batch[-1]:
        n -= 1
    return n


def phase_connectors(info: dict) -> dict:
    """The last connectors feeding a live DocumentStore on the card (the
    document_store phase's recipe: the ``minilm`` embedder in bf16,
    ``TokenCountSplitter(50, 200)``, the default ``TieredKnnFactory``). A
    seeded corpus of sum(CN_SOURCES) files of DS_WORDS words reaches one
    store through ``pw.io.gdrive`` (a fake transport, with metadata),
    ``pw.io.pyfilesystem`` (an fs-shaped object over a directory),
    ``pw.io.sqlite`` (streaming; rows written in CN_SQLITE_COMMIT-row
    commits while the run polls, then CN_SQLITE_UPDATES of them updated),
    ``pw.io.nats`` (json, an in-process broker) and ``pw.io.airbyte`` (an
    executable source with an incremental stream). Once every file is
    indexed, CN_QUERIES retrieve queries (k = CN_K) arrive on a NATS topic;
    the answers leave through ``pw.io.nats.write``, ``pw.io.logstash.write``
    (a local server) and ``pw.io.pubsub.write`` (a fake publisher), and,
    where pyarrow imports, ``pw.io.deltalake.write`` and
    ``pw.io.iceberg.write``; an alerts table (answers whose best hit scores
    below CN_ALERT_SCORE) goes to ``pw.io.slack.send_alerts`` (a fake
    transport). Gates: each file ingested once per source; the updated
    sqlite rows retracted and re-embedded; the answers equal, text and score
    bits, a second store's fed the final corpus through ``pw.io.fs``; every
    answer reaches each sink once; one Slack post per positive alert diff;
    every attention launch on the tensor cores; the lake tables read back
    equal (or, without pyarrow, the writers raise as the reference's do)."""
    import shutil
    import sqlite3
    import time as time_mod  # `time` is also the name of a subscriber's argument below

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.ops import attention_kernel as A
    from pathway_tpu_torch.stdlib.indexing.retrievers import TieredKnnFactory
    from pathway_tpu_torch.xpacks.llm import DocumentStore
    from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder
    from pathway_tpu_torch.xpacks.llm.splitters import TokenCountSplitter

    t_phase = time.perf_counter()
    root = os.path.join(SCRATCH, "connectors")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    rng = np.random.default_rng(17)
    vocab = [f"word{i}" for i in range(5000)]

    def text():
        return " ".join(rng.choice(vocab, size=int(rng.integers(DS_WORDS[0], DS_WORDS[1] + 1))))

    files: dict[str, list[tuple[str, str]]] = {}
    i = 0
    for source, n in CN_SOURCES.items():
        files[source] = []
        for _ in range(n):
            files[source].append((f"d{i % CN_SUBDIRS:02d}/f{i:05d}.txt", text()))
            i += 1
    updates = {int(j): text() for j in sorted(rng.choice(CN_SOURCES["sqlite"], size=CN_SQLITE_UPDATES, replace=False))}
    final = {src: [(p, updates.get(j, t) if src == "sqlite" else t) for j, (p, t) in enumerate(rows)]
             for src, rows in files.items()}

    def write_tree(top: str, rows) -> str:
        for path, t in rows:
            os.makedirs(os.path.join(top, os.path.dirname(path)), exist_ok=True)
            with open(os.path.join(top, path), "w", encoding="utf-8") as f:
                f.write(t)
        return top

    # the fs-fed store's corpus: every file as it ends
    fs_root = write_tree(os.path.join(root, "fs"), [r for rows in final.values() for r in rows])
    pyfs_root = write_tree(os.path.join(root, "pyfs"), files["pyfilesystem"])
    corpus_jsonl = os.path.join(root, "airbyte_corpus.jsonl")
    with open(corpus_jsonl, "w", encoding="utf-8") as f:
        for path, t in files["airbyte"]:
            f.write(json.dumps({"path": path, "data": t}) + "\n")
    source_py = os.path.join(root, "airbyte_source.py")
    with open(source_py, "w", encoding="utf-8") as f:
        f.write(_AIRBYTE_SOURCE)
    db = os.path.join(root, "docs.db")
    con = sqlite3.connect(db)
    con.execute("CREATE TABLE docs (id INTEGER PRIMARY KEY, path TEXT, data TEXT)")
    con.commit()
    con.close()

    splitter = TokenCountSplitter(min_tokens=50, max_tokens=200)
    chunk_source: dict[str, str] = {}
    for src, rows in files.items():
        for _p, t in rows:
            for c, _m in splitter.func(t):
                chunk_source[c] = src
    new_chunks = {c for j in updates for c, _m in splitter.func(updates[j])}
    old_chunks = {c for j in updates for c, _m in splitter.func(files["sqlite"][j][1])}
    final_chunks = {c for rows in final.values() for _p, t in rows for c, _m in splitter.func(t)}
    n_initial = len(chunk_source)
    check(len(final_chunks) == n_initial - len(old_chunks) + len(new_chunks),
          "connectors: the seeded corpus repeats a chunk")
    picks = rng.choice(sorted(final_chunks), size=CN_QUERIES - CN_NOISE, replace=False)
    noise = [" ".join(f"zq{int(x)}" for x in rng.integers(0, 10**6, size=40)) for _ in range(CN_NOISE)]
    queries = [str(q) for q in picks] + noise

    emb = SentenceTransformerEmbedder("minilm", seed=0, device=DEVICE)
    launch_log = _LaunchLog(emb, keep_texts=True)

    def make_store(docs):
        factory = None if DEVICE == "cuda" else TieredKnnFactory(embedder=emb, device=DEVICE)
        return DocumentStore(docs, retriever_factory=factory, embedder=emb, splitter=splitter)

    emb._encoder.encode_texts(sorted(final_chunks)[:512])  # warm-up, outside the counts
    sync()

    # the expected answers: the final corpus through pw.io.fs
    pw.G.clear()
    want_run = _ds_run(pw, make_store(pw.io.fs.read(fs_root, format="binary", mode="static", with_metadata=True)),
                       retrieve=[(q, CN_K, None, None) for q in queries])
    pw.G.clear()

    def bits(hits):
        return [(h["text"], np.float64(h["dist"]).view(np.uint64).item()) for h in hits]

    want = {r["query"]: bits(_hits(r["result"])) for r in want_run.get("retrieve", {}).values()}
    check(len(want) == CN_QUERIES, f"connectors: the fs-fed store answered {len(want)}/{CN_QUERIES} queries")

    broker, publisher = _Broker(), _Publisher()
    srv, posts, post_times = _logstash_server()
    slack_posts: list = []
    drive = _Drive(files["gdrive"])
    for path, t in files["nats"]:
        broker.publish("docs", json.dumps({"path": path, "data": t}).encode())

    def meta(source):
        return lambda path: pw.Json({"path": path, "source": source})

    def as_bytes(s):
        return s.encode("utf-8")

    class Rows(pw.Schema):
        id: int = pw.column_definition(primary_key=True)
        path: str
        data: str

    sq = pw.io.sqlite.read(db, "docs", Rows, mode="streaming", poll_interval=0.05)
    nd = pw.io.nats.read("nats://local", "docs", format="json", schema=pw.schema_from_types(path=str, data=str),
                         client_factory=broker)
    ab = pw.io.airbyte.read({"source": {"executable": source_py, "config": {"corpus": corpus_jsonl}}},
                            streams=["docs"], mode="streaming", _poll_interval=0.5)
    tables = {
        "gdrive": pw.io.gdrive.read("root", mode="static", client=drive, with_metadata=True),
        "pyfilesystem": pw.io.pyfilesystem.read(_DirFS(pyfs_root), "/", mode="static", with_metadata=True),
        "sqlite": sq.select(data=pw.apply_with_type(as_bytes, bytes, sq.data),
                            _metadata=pw.apply_with_type(meta("sqlite"), dict, sq.path)),
        "nats": nd.select(data=pw.apply_with_type(as_bytes, bytes, nd.data),
                          _metadata=pw.apply_with_type(meta("nats"), dict, nd.path)),
        "airbyte": ab.select(data=pw.apply_with_type(lambda j: j.value["data"].encode("utf-8"), bytes, ab.data),
                             _metadata=pw.apply_with_type(lambda j: pw.Json({"path": j.value["path"],
                                                                             "source": "airbyte"}), dict, ab.data)),
    }
    seen = {src: {"add": 0, "retract": 0, "keys": set(), "retracted": []} for src in tables}

    def on_source(src):
        def on_change(key, row, time, is_addition):
            s = seen[src]
            if is_addition:
                s["add"] += 1
                s["keys"].add(int(key))
            else:
                s["retract"] += 1
                s["retracted"].append(row["data"])
        return on_change

    for src, t in tables.items():
        pw.io.subscribe(t, on_source(src))
    store = make_store(list(tables.values()))

    qs = pw.io.nats.read("nats://local", "queries", format="json", schema=DocumentStore.RetrieveQuerySchema,
                         client_factory=broker)
    res = qs.select(qs.query, result=store.retrieve_query(qs).with_universe_of(qs).result)
    answers = res.select(
        query=res.query,
        answer=pw.apply_with_type(lambda r: json.dumps([[h["text"], h["dist"]] for h in _hits(r)]), str, res.result),
        top=pw.apply_with_type(lambda r: -float(_hits(r)[0]["dist"]) if _hits(r) else -1.0, float, res.result),
    )
    got: dict = {}
    answered_at: dict = {}
    answer_diffs = [0]

    def on_answer(key, row, time, is_addition):
        answer_diffs[0] += 1
        if is_addition:
            got[row["query"]] = json.loads(row["answer"])
            answered_at.setdefault(row["query"], time_mod.perf_counter())

    pw.io.subscribe(answers, on_answer)
    pw.io.nats.write(answers, "nats://local", "answers", format="json", client_factory=broker)
    pw.io.logstash.write(answers, f"http://127.0.0.1:{srv.server_address[1]}/")
    pw.io.pubsub.write(
        answers.select(payload=pw.apply_with_type(lambda q, a: json.dumps([q, a]).encode(), bytes,
                                                  answers.query, answers.answer)),
        publisher, "rag", "answers")
    alerts = answers.filter(answers.top < CN_ALERT_SCORE).select(
        msg=pw.apply_with_type(lambda q, s: f"low retrieval score {s:.3f}: {q[:60]}", str, answers.query, answers.top))
    pw.io.slack.send_alerts(alerts, "C0RAG", "xoxb-rag",
                            _transport=lambda url, headers, body: slack_posts.append((url, headers, body)))
    alert_diffs = {"add": 0, "retract": 0}
    pw.io.subscribe(alerts, lambda key, row, time, is_addition: alert_diffs.__setitem__(
        "add" if is_addition else "retract", alert_diffs["add" if is_addition else "retract"] + 1))
    try:
        import pyarrow  # noqa: F401

        has_pyarrow = True
    except ImportError:
        has_pyarrow = False
    lake_errors = {}
    delta_uri, warehouse = os.path.join(root, "delta"), os.path.join(root, "iceberg")
    lake = answers.select(answers.query, answers.answer)
    if has_pyarrow:
        pw.io.deltalake.write(lake, delta_uri)
        pw.io.iceberg.write(lake, warehouse, ["rag"], "answers")
    else:
        for name, call in (("deltalake", lambda: pw.io.deltalake.write(lake, delta_uri)),
                           ("iceberg", lambda: pw.io.iceberg.write(lake, warehouse, ["rag"], "answers"))):
            try:
                call()
                lake_errors[name] = None
            except ImportError as e:
                lake_errors[name] = f"{type(e).__name__}: {e}"
        check(all(lake_errors.values()), f"connectors: without pyarrow a lake writer did not raise {lake_errors}")

    marks: dict = {}
    sent_at: dict = {}
    failed: list = []

    def embedded() -> set:
        return {t for batch in launch_log.texts for t in batch}

    def wait(cond, what):
        t0 = time_mod.perf_counter()
        while not cond():
            if time_mod.perf_counter() - t0 > CN_TIMEOUT_S:
                failed.append(what)
                return False
            time_mod.sleep(0.02)
        return True

    def feed():
        try:
            sqlite_rows = files["sqlite"]
            for lo in range(0, len(sqlite_rows), CN_SQLITE_COMMIT):
                c = sqlite3.connect(db)
                c.executemany("INSERT INTO docs VALUES (?, ?, ?)",
                              [(j, p, t) for j, (p, t) in enumerate(sqlite_rows[lo: lo + CN_SQLITE_COMMIT], lo)])
                c.commit()
                c.close()
                time_mod.sleep(0.05)
            initial = set(chunk_source)
            if not wait(lambda: initial <= embedded(), "every initial chunk embedded"):
                return
            marks["ingest"] = time_mod.perf_counter()
            marks["ingest_launches"] = len(launch_log.texts)
            c = sqlite3.connect(db)
            c.executemany("UPDATE docs SET data = ? WHERE id = ?", [(t, j) for j, t in updates.items()])
            c.commit()
            c.close()
            if not wait(lambda: new_chunks <= embedded() and seen["sqlite"]["retract"] >= CN_SQLITE_UPDATES,
                        "every updated chunk embedded"):
                return
            time_mod.sleep(1.0)  # past the microbatcher's flush deadline
            marks["updated"] = time_mod.perf_counter()
            marks["doc_rows"] = sum(_real_rows(b) for b in launch_log.texts)
            marks["doc_launches"] = len(launch_log.texts)
            for lo in range(0, len(queries), CN_TICK):
                for q in queries[lo: lo + CN_TICK]:
                    sent_at[q] = time_mod.perf_counter()
                    broker.publish("queries", json.dumps(
                        {"query": q, "k": CN_K, "metadata_filter": None, "filepath_globpattern": None}).encode())
                time_mod.sleep(0.05)
            wait(lambda: len(got) >= len(queries) and len(broker.topics.get("answers", [])) >= len(queries)
                 and len(posts) >= len(queries) and len(publisher.published) >= len(queries), "every answer out")
            time_mod.sleep(0.5)
            marks["answered"] = time_mod.perf_counter()
        finally:
            rt = pw.internals.run.current_runtime()
            if rt is not None:
                rt.request_stop()

    # --- the connectors: counts from 0 -----------------------------------------
    A.LAUNCHES = 0
    A.ROUTE_LAUNCHES.update(dict.fromkeys(A.ROUTE_LAUNCHES, 0))
    launch_log.spans.clear()
    launch_log.texts.clear()
    th = threading.Thread(target=feed, daemon=True)
    t_run0 = time_mod.perf_counter()
    th.start()
    pw.run()
    sync()
    t_run1 = time_mod.perf_counter()
    launches, route_launches = A.LAUNCHES, dict(A.ROUTE_LAUNCHES)
    # ------------------------------------------------------------------------------
    th.join(timeout=10)
    srv.shutdown()
    srv.server_close()
    pw.G.clear()
    check(not failed, f"connectors: timed out waiting for {failed}")

    # each file once per source; sqlite: each updated row retracted once
    for src, n in CN_SOURCES.items():
        s = seen[src]
        want_add = n + (CN_SQLITE_UPDATES if src == "sqlite" else 0)
        want_retract = CN_SQLITE_UPDATES if src == "sqlite" else 0
        check(s["add"] == want_add and s["retract"] == want_retract and len(s["keys"]) == n,
              f"connectors: {src} gave {s['add']} rows, {s['retract']} retractions, {len(s['keys'])} keys; "
              f"expected {want_add}, {want_retract}, {n}")
    old_texts = {files["sqlite"][j][1].encode() for j in updates}
    check(set(seen["sqlite"]["retracted"]) == old_texts, "connectors: the retracted sqlite rows are not the updated ones")
    n_doc_rows = marks.get("doc_rows", -1)
    check(n_doc_rows == n_initial + len(new_chunks),
          f"connectors: the embedder took {n_doc_rows} doc rows, expected {n_initial} chunks + "
          f"{len(new_chunks)} updated chunks")

    # the answers against the fs-fed store's, text and score bits
    got_bits = {q: [(t, np.float64(d).view(np.uint64).item()) for t, d in hits] for q, hits in got.items()}
    differ = [q for q in queries if got_bits.get(q) != want.get(q)]
    check(not differ, f"connectors: {len(differ)}/{len(queries)} answers differ from the fs-fed store's")
    self_hits = sum(1 for q in queries[: CN_QUERIES - CN_NOISE] if got.get(q) and got[q][0][0] == q)
    check(self_hits == CN_QUERIES - CN_NOISE, f"connectors: self-hits {self_hits}/{CN_QUERIES - CN_NOISE}")

    # every answer change once to each sink; one Slack post per positive alert diff
    n_nats = len(broker.topics.get("answers", []))
    check(n_nats == answer_diffs[0] and len(posts) == answer_diffs[0] and len(publisher.published) == answer_diffs[0],
          f"connectors: {answer_diffs[0]} answer changes, NATS {n_nats}, Logstash {len(posts)}, "
          f"Pub/Sub {len(publisher.published)}")
    check(sorted(json.loads(m)["query"] for m in broker.topics.get("answers", [])) == sorted(got),
          "connectors: the NATS answers name other queries")
    check(len(slack_posts) == alert_diffs["add"] and alert_diffs["add"] >= 1,
          f"connectors: {len(slack_posts)} Slack posts for {alert_diffs['add']} positive alert diffs")

    # every attention launch on the bf16 tensor-core route, 6 per embedder launch
    expected = 6 * len(launch_log.spans)
    check(route_launches["tensor_core"] == expected == launches == sum(route_launches.values()),
          f"connectors: attention launches {route_launches}, expected {expected} on tensor_core")

    lake_read = {}
    if has_pyarrow:
        want_rows = sorted((q, json.dumps(h)) for q, h in got.items())
        pw.G.clear()
        lake_schema = pw.schema_from_types(query=str, answer=str)
        for name, t in (("deltalake", pw.io.deltalake.read(delta_uri, schema=lake_schema, mode="static")),
                        ("iceberg", pw.io.iceberg.read(warehouse, ["rag"], "answers", schema=lake_schema,
                                                       mode="static"))):
            from pathway_tpu_torch.debug import _capture

            rows = sorted(tuple(r) for r in _capture(t).rows.values())
            pw.G.clear()
            lake_read[name] = len(rows)
            check(rows == want_rows, f"connectors: {name} read back {len(rows)} rows other than the answers")

    # per source: the time its last chunk's launch ended, from the run's
    # start (the ingest's launches only: a query is a chunk's text too)
    done_at: dict = {}
    n_ingest = marks.get("ingest_launches", len(launch_log.texts))
    for (_a, b, _n), batch in zip(launch_log.spans[:n_ingest], launch_log.texts[:n_ingest]):
        for t in batch:
            src = chunk_source.get(t)
            if src is not None:
                done_at[src] = max(done_at.get(src, 0.0), b)
    chunks_of = {src: sum(1 for s in chunk_source.values() if s == src) for src in CN_SOURCES}
    lat = sorted((answered_at[q] - sent_at[q]) * 1e3 for q in queries if q in answered_at and q in sent_at)
    # the answer's arrival on the NATS topic (the first sink), from its query's publish
    on_nats = {json.loads(m)["query"]: t for m, t in zip(broker.topics.get("answers", []),
                                                         broker.times.get("answers", []))}
    lat_nats = sorted((on_nats[q] - sent_at[q]) * 1e3 for q in queries if q in on_nats and q in sent_at)
    t_last_query = max(sent_at.values()) if sent_at else t_run1

    def spread(times):
        return [times[0] - t_last_query, times[-1] - t_last_query] if times else None
    t_ingest = marks.get("ingest", t_run1) - t_run0
    out = {
        "card": info["nvidia_smi"], "files": sum(CN_SOURCES.values()), "files_per_source": CN_SOURCES,
        "chunks": n_initial, "sqlite_updates": CN_SQLITE_UPDATES, "updated_chunks": len(new_chunks),
        "retracted_chunks": len(old_chunks),
        "ingest_s": t_ingest, "ingest_chunks_per_s": n_initial / t_ingest,
        "ingest_chunks_per_s_by_source": {src: chunks_of[src] / (done_at[src] - t_run0) for src in done_at},
        "source_done_s": {src: done_at[src] - t_run0 for src in done_at},
        "rows_by_source": {src: {"add": s["add"], "retract": s["retract"], "keys": len(s["keys"])}
                           for src, s in seen.items()},
        "embedder_doc_rows": n_doc_rows, "embedder_doc_launches": marks.get("doc_launches"),
        "embed_launches": len(launch_log.spans), "embed_buckets": _buckets(launch_log.spans),
        "queries": len(queries), "noise_queries": CN_NOISE, "answers": len(got),
        "answers_equal_fs_store": not differ, "self_hits": self_hits,
        "retrieve_p50_ms": lat[len(lat) // 2] if lat else None, "retrieve_p99_ms": lat[int(len(lat) * 0.99)] if lat else None,
        "nats_answer_p50_ms": lat_nats[len(lat_nats) // 2] if lat_nats else None,
        "sink_first_last_s_after_last_query": {"nats": spread(broker.times.get("answers", [])),
                                               "logstash": spread(sorted(post_times)),
                                               "pubsub": spread(publisher.times)},
        "answer_changes": answer_diffs[0], "nats_answers": n_nats, "logstash_posts": len(posts),
        "pubsub_published": len(publisher.published), "alerts": alert_diffs, "slack_posts": len(slack_posts),
        "top_score_range": {kind: [min(v), max(v)] for kind, v in (
            ("corpus", [-got[q][0][1] for q in queries[: CN_QUERIES - CN_NOISE] if got.get(q)]),
            ("noise", [-got[q][0][1] for q in queries[CN_QUERIES - CN_NOISE:] if got.get(q)])) if v},
        "gdrive_downloads": drive.downloads, "pyarrow": has_pyarrow, "lake_rows_read": lake_read,
        "lake_errors": lake_errors, "attention_launches": launches, "attention_launches_by_route": route_launches,
        "run_s": t_run1 - t_run0, "phase_s": time_mod.perf_counter() - t_phase,
    }
    emit("connectors", **out)
    shutil.rmtree(root, ignore_errors=True)
    return {"launches": route_launches, "metrics": out}


PERSIST_SNAPSHOT_MS = 5_000  # operator snapshot cadence in runs A and B (delta chunks), plus the one at close


def _persist_split(ds: dict, root: str) -> tuple[str, list, list, list[str]]:
    """Hard links of phase document_store's files (mtimes kept) under
    ``root/docs``: files 0 .. DS_FILES/2-1 under ``h0/`` now, the others
    under ``h1/`` when the caller links them, each in its directory
    ``d<i % DS_SUBDIRS>``, so a sorted scan lists the first half first (the
    input log's prefix). Returns the docs dir, the two halves' chunk texts
    and the second half's (source, link) paths."""
    import shutil

    half = DS_FILES // 2
    by_path: dict[str, list[str]] = {}
    for path, chunk in ds["chunk_list"]:
        by_path.setdefault(path, []).append(chunk)
    docs = os.path.join(root, "docs")
    shutil.rmtree(root, ignore_errors=True)
    first, second, pending = [], [], []
    for i in range(DS_FILES):
        src = os.path.join(ds["corpus"], f"d{i % DS_SUBDIRS:02d}", f"f{i:05d}.txt")
        dest = os.path.join(docs, "h0" if i < half else "h1", f"d{i % DS_SUBDIRS:02d}", f"f{i:05d}.txt")
        (first if i < half else second).extend(by_path[src])
        if i < half:
            _link(src, dest)
        else:
            pending.append((src, dest))
    return docs, first, second, pending


def _link(src: str, dest: str) -> None:
    import shutil

    os.makedirs(os.path.dirname(dest), exist_ok=True)
    try:
        os.link(src, dest)
    except OSError:
        shutil.copy2(src, dest)


def _index_rows_since(earlier: set) -> int:
    from pathway_tpu_torch.stdlib.indexing import tiered

    with tiered._registry_lock:
        live = [b for b in tiered._live_tiered if id(b) not in earlier]
    return sum(b.stats()["hot_rows"] + b.stats()["cold_rows"] for b in live)


def _persist_run(ds: dict, docs_dir: str, backend, out_dir: str, mode: str, factory,
                 query_rows: list, want_rows: int | None, interval_ms: int = PERSIST_SNAPSHOT_MS) -> dict:
    """One ``pw.run`` of the persisted RAG graph: ``pw.io.fs`` (streaming,
    bounded) over ``docs_dir`` → ``DocumentStore`` (phase document_store's
    ``minilm`` embedder and splitter) over ``factory``; a query connector
    that, once the index holds ``want_rows`` rows, sends ``query_rows`` in
    DS_TICK-row ticks to ``retrieve_query``; the answers and the chunks
    written by ``pw.io.jsonlines`` (``delivery="exactly_once"`` under
    ``operator_persisting``). Returns the answers, the host clocks, the
    embedder's launches and the persistence layer's own timings."""
    import gc

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.ops import attention_kernel as A
    from pathway_tpu_torch.persistence import snapshots
    from pathway_tpu_torch.stdlib.indexing import tiered
    from pathway_tpu_torch.xpacks.llm import DocumentStore

    pw.G.clear()
    gc.collect()
    with tiered._registry_lock:
        earlier = {id(b) for b in tiered._live_tiered}
    got: dict = {"answers": {}, "t_first": None, "t_push": None, "t_last": None}
    delivery = "exactly_once" if mode == "operator_persisting" else "off"
    docs = pw.io.fs.read(docs_dir, format="binary", with_metadata=True, _bounded=True, name="persist_docs")
    store = DocumentStore(docs, retriever_factory=factory, embedder=ds["emb"], splitter=ds["splitter"])

    class Queries(pw.io.python.ConnectorSubject):
        def run(self):
            if not query_rows:
                return
            deadline = time.monotonic() + 900
            while _index_rows_since(earlier) < want_rows and time.monotonic() < deadline:
                time.sleep(0.02)
            got["t_push"] = time.perf_counter()
            for lo in range(0, len(query_rows), DS_TICK):
                for q in query_rows[lo : lo + DS_TICK]:
                    self.next(query=q[0], k=q[1], metadata_filter=q[2], filepath_globpattern=q[3])
                time.sleep(0.05)

    q = pw.io.python.read(Queries(), schema=DocumentStore.RetrieveQuerySchema, name="persist_queries")
    answers = q.select(q.query, q.filepath_globpattern, result=store.retrieve_query(q).with_universe_of(q).result)

    clock = time.perf_counter

    def on_answer(key, row, time, is_addition):  # noqa: A002 - subscribe passes time=
        if is_addition:
            if got["t_first"] is None:
                got["t_first"] = clock()
            got["answers"][int(key)] = (row["query"], row["filepath_globpattern"], _comparable(_hits(row["result"])))
            got["t_last"] = clock()

    pw.io.subscribe(answers, on_answer)
    pw.io.jsonlines.write(
        answers.select(answers.query, hits=pw.apply(lambda r: _comparable(_hits(r)), answers.result)),
        os.path.join(out_dir, "answers.jsonl"), delivery=delivery,
    )
    chunks = store.chunked_docs
    pw.io.jsonlines.write(
        chunks.select(path=pw.apply(lambda m: _json_value(m)["path"], chunks.metadata), text=chunks.text),
        os.path.join(out_dir, "chunks.jsonl"), delivery=delivery,
    )

    timings: dict = {"save_s": [], "restore_s": None, "replay_s": None, "close_s": None,
                     "put": {"base": 0, "delta": 0}, "tick_done_s": []}
    P, O, S = snapshots.Persistence, snapshots._OperatorSnapshots, snapshots.SnapshotStore
    saved = (P._save_operators, P._replay_all, P.on_close, O.restore, S.put_chunk, P.on_tick_done)

    def put_chunk(self, name, payload):  # the index's chunk bytes written, by kind
        timings["put"][name.split("_", 1)[0]] += len(payload)
        return saved[4](self, name, payload)

    def clocked(fn, key, append=False):
        def wrapper(self, *a):
            t0 = time.perf_counter()
            try:
                return fn(self, *a)
            finally:
                sync()
                dt = time.perf_counter() - t0
                if append:
                    timings[key].append((a[0] if a else None, dt))
                else:
                    timings[key] = dt
        return wrapper

    P._save_operators = clocked(saved[0], "save_s", append=True)
    P._replay_all = clocked(saved[1], "replay_s")
    P.on_close = clocked(saved[2], "close_s")
    O.restore = clocked(saved[3], "restore_s")
    S.put_chunk = put_chunk
    P.on_tick_done = clocked(saved[5], "tick_done_s", append=True)
    launch_log = ds["launch_log"]
    launch_log.spans.clear()
    launch_log.texts.clear()
    A.LAUNCHES = 0
    A.ROUTE_LAUNCHES.update(dict.fromkeys(A.ROUTE_LAUNCHES, 0))
    try:
        t0 = time.perf_counter()
        pw.run(
            monitoring_level="none",
            persistence_config=pw.persistence.Config(
                backend=backend,
                persistence_mode=mode,
                snapshot_interval_ms=interval_ms,
            ),
        )
        sync()
        t1 = time.perf_counter()
    finally:
        P._save_operators, P._replay_all, P.on_close, O.restore, S.put_chunk, P.on_tick_done = saved
    from pathway_tpu_torch.observability import device as dev

    pad = dev.status_summary().get("pad", {})
    got.update(
        t0=t0, t1=t1, timings=timings,
        launches=A.LAUNCHES, route_launches=dict(A.ROUTE_LAUNCHES),
        spans=list(launch_log.spans), texts=list(launch_log.texts),
        real_rows=sum(v["real_rows"] for k, v in pad.items() if k.startswith("udf:")),
        index_rows=_index_rows_since(earlier),
    )
    pw.G.clear()
    return got


def _json_value(v):
    return v.value if hasattr(v, "value") else v


def _jsonl_rows(path: str) -> list[str]:
    """A jsonlines sink's rows without their ``time`` field (the tick a row
    landed in follows the host clock), sorted."""
    rows = []
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            rec.pop("time", None)
            rows.append(json.dumps(rec, sort_keys=True))
    return sorted(rows)


def _aux_bytes(store_dir: str) -> dict:
    out = {"base_bytes": 0, "delta_bytes": 0, "base_chunks": 0, "delta_chunks": 0, "store_bytes": 0}
    for dirpath, _dirs, files in os.walk(store_dir):
        for fn in files:
            size = os.path.getsize(os.path.join(dirpath, fn))
            out["store_bytes"] += size
            for kind in ("base", "delta"):
                if fn.startswith(kind + "_") and f"{os.sep}aux{os.sep}" in dirpath + os.sep:
                    out[f"{kind}_bytes"] += size
                    out[f"{kind}_chunks"] += 1
    return out


def _spread(xs: list) -> dict:
    return {"n": len(xs), "sum": round(sum(xs), 3), "max": round(max(xs), 4) if xs else None}


def phase_persistence(info: dict, ds: dict) -> dict:
    """Persistence and exactly-once delivery on the served live-RAG path:
    phase document_store's corpus in two halves through ``pw.io.fs``
    (streaming) → ``DocumentStore`` (``minilm``, bf16, ``TieredKnnFactory``
    at the default hot bound, which holds every chunk) with a filesystem
    backend in ``operator_persisting`` mode and two jsonlines sinks with
    ``delivery="exactly_once"``. Run A ingests the first half and ends at
    settle; run B restores (operator snapshots, the index from its base and
    delta chunks), takes the second half, then answers phase document_store's
    1,024 retrieve rows. Gates: run B's answers (keys, texts, metadata, score
    bits) equal an uninterrupted run's on the same files; run B embeds
    exactly the second half's chunks and the queries (embedder rows and
    attention launches); each exactly-once file holds every row once and
    equals the uninterrupted run's. The same two runs in ``persisting`` mode
    (input replay: run B re-embeds the first half) for contrast.

    Every chunk sits in the hot shard, so the cold tier is never searched
    and an IVF trained at any point cannot change an answer. Below the
    corpus, the tiered search rescores the union of a query batch's cold
    candidates for every query of the batch, so a directory-filtered answer
    would depend on which queries share a tick."""
    import shutil
    import tempfile

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.persistence.backends import MemoryBackend
    from pathway_tpu_torch.stdlib.indexing.retrievers import TieredKnnFactory

    emb = ds["emb"]
    root = os.path.join(SCRATCH, "persistence")
    stores = tempfile.mkdtemp(prefix="pathway_persistence_")  # the filesystem backends
    docs_dir, first, second, pending = _persist_split(ds, os.path.join(root, "corpus"))
    # phase document_store's queries; a directory filter names the same
    # directory in either half
    queries = [(t, k, f, g if g is None else g.replace(ds["corpus"], os.path.join(docs_dir, "h*")))
               for t, k, f, g in ds["queries"]]
    env_before = os.environ.get("PATHWAY_PERSISTENT_STORAGE")

    def store_factory():  # rest_serving's store: the default hot bound
        return TieredKnnFactory(embedder=emb, device=DEVICE)

    def leg(name: str, mode: str, factory, interval_ms: int = PERSIST_SNAPSHOT_MS) -> dict:
        store_dir = os.path.join(stores, name)
        backend = pw.persistence.Backend.filesystem(store_dir)
        out_dir = os.path.join(root, name, "out")  # runs A and B write the same sink files
        os.makedirs(out_dir, exist_ok=True)
        t0 = time.perf_counter()
        a = _persist_run(ds, docs_dir, backend, out_dir, mode, factory(), [], None, interval_ms)
        n_nodes = max(1, round(a["index_rows"] / max(1, len(first))))
        for src, dest in pending:
            _link(src, dest)
        b = _persist_run(ds, docs_dir, backend, out_dir, mode, factory(), queries,
                         n_nodes * (len(first) + len(second)), interval_ms)
        walls[name] = time.perf_counter() - t0
        for _src, dest in pending:  # the second half leaves for the next leg's run A
            os.remove(dest)
        return {"a": a, "b": b, "n_nodes": n_nodes, "aux": _aux_bytes(store_dir), "out_dir": out_dir}

    walls: dict = {}
    try:
        op = leg("operator", "operator_persisting", store_factory)
        # the uninterrupted run: the same graph on both halves at once, its
        # state in a memory backend (where it persists does not change what
        # it answers or writes) at the same snapshot cadence: with snapshots
        # at close only, the exactly-once sinks stage one epoch a tick and
        # stop the run at PATHWAY_DELIVERY_MAX_STAGED_EPOCHS (512) unpublished
        for src, dest in pending:
            _link(src, dest)
        whole_dir = os.path.join(root, "whole")
        os.makedirs(whole_dir, exist_ok=True)
        t0 = time.perf_counter()
        MemoryBackend.clear("chip_smoke_persistence")
        whole = _persist_run(ds, docs_dir, pw.persistence.Backend("memory", "chip_smoke_persistence"), whole_dir,
                             "operator_persisting", store_factory(), queries,
                             op["n_nodes"] * (len(first) + len(second)))
        MemoryBackend.clear("chip_smoke_persistence")
        walls["whole"] = time.perf_counter() - t0
        for _src, dest in pending:
            os.remove(dest)
        rep = leg("replay", "persisting", store_factory)
    finally:
        shutil.rmtree(stores, ignore_errors=True)
        if env_before is None:
            os.environ.pop("PATHWAY_PERSISTENT_STORAGE", None)
        else:
            os.environ["PATHWAY_PERSISTENT_STORAGE"] = env_before

    b = op["b"]
    # gate 1: run B answers as the uninterrupted run does
    same = b["answers"] == whole["answers"]
    differ = [k for k in whole["answers"] if b["answers"].get(k) != whole["answers"][k]]
    first_diff = (_first_difference(json.loads(b["answers"][differ[0]][2]), json.loads(whole["answers"][differ[0]][2]))
                  if differ and differ[0] in b["answers"] else None)
    check(len(whole["answers"]) == DS_QUERIES and same,
          f"persistence: run B's answers differ from the uninterrupted run's ({len(b['answers'])}/"
          f"{len(whole['answers'])} answered, {len(differ)} differ, first {differ[:1]}: {first_diff})")
    self_ok = sum(1 for qq, _g, hits in b["answers"].values() if json.loads(hits) and json.loads(hits)[0]["text"] == qq)
    # gate 2: run B embedded the second half's chunks and the queries, nothing of the first half
    push = b["t_push"] or b["t1"]
    before_q = {t for (s, _e, _n), batch in zip(b["spans"], b["texts"]) if s < push for t in batch}
    first_only = set(first) - set(second)
    reembedded = len(before_q & first_only)
    want_rows = op["n_nodes"] * len(second) + DS_QUERIES
    check(before_q == set(second) and reembedded == 0,
          f"persistence: run B embedded {len(before_q)} distinct texts before its queries, expected the second "
          f"half's {len(set(second))} ({reembedded} of the first half again)")
    check(b["real_rows"] == want_rows,
          f"persistence: run B's embedder took {b['real_rows']} rows, expected {want_rows} "
          f"({op['n_nodes']} x {len(second)} chunks + {DS_QUERIES} queries)")
    check(b["launches"] == 6 * len(b["spans"]) and b["route_launches"].get("tensor_core") == b["launches"]
          and b["launches"] > 0,
          f"persistence: run B's attention launches {b['route_launches']} != 6 x {len(b['spans'])} embedder launches")
    # gate 3: each exactly-once file holds every row once, equal to the uninterrupted run's
    files = {}
    for fn, n_want in (("answers.jsonl", DS_QUERIES), ("chunks.jsonl", len(first) + len(second))):
        got_rows = _jsonl_rows(os.path.join(op["out_dir"], fn))
        want = _jsonl_rows(os.path.join(whole_dir, fn))
        once = len(got_rows) == len(set(got_rows)) == n_want and all(json.loads(r)["diff"] == 1 for r in got_rows)
        files[fn] = {"rows": len(got_rows), "unique": len(set(got_rows)), "equal_to_uninterrupted": got_rows == want}
        check(once and got_rows == want,
              f"persistence: {fn} holds {len(got_rows)} rows ({len(set(got_rows))} unique), expected {n_want} once, "
              f"equal to the uninterrupted run's: {got_rows == want}")

    def numbers(lg: dict) -> dict:
        bb = lg["b"]
        tm = bb["timings"]
        at_close = [s for t, s in lg["a"]["timings"]["save_s"] if t == -1]
        return {
            **lg["aux"],
            "base_bytes_written": lg["a"]["timings"]["put"]["base"] + bb["timings"]["put"]["base"],
            "delta_bytes_written": lg["a"]["timings"]["put"]["delta"] + bb["timings"]["put"]["delta"],
            "snapshot_at_close_s_run_a": at_close[0] if at_close else None,
            "close_s_run_a": lg["a"]["timings"]["close_s"],
            "restore_s": tm["restore_s"],
            "replay_s": tm["replay_s"],
            "run_b_to_first_answer_s": (bb["t_first"] - bb["t0"]) if bb["t_first"] else None,
            "run_b_s": bb["t1"] - bb["t0"],
            "run_a_s": lg["a"]["t1"] - lg["a"]["t0"],
            "run_b_embedder_rows": bb["real_rows"],
            "run_b_embedder_launches": len(bb["spans"]),
            "run_b_attention_launches": bb["launches"],
            "periodic_snapshots": len(lg["a"]["timings"]["save_s"]) + len(bb["timings"]["save_s"]),
            "save_s_run_b": [round(x, 3) for _t, x in bb["timings"]["save_s"]],
            "tick_done_s_run_b": _spread([x for _t, x in bb["timings"]["tick_done_s"]]),
            "tick_done_s_run_a": _spread([x for _t, x in lg["a"]["timings"]["tick_done_s"]]),
            "run_b_push_to_last_answer_s": (bb["t_last"] - bb["t_push"]) if bb["t_last"] and bb["t_push"] else None,
            "run_b_to_push_s": (bb["t_push"] - bb["t0"]) if bb["t_push"] else None,
        }

    legs = {"operator_persisting": numbers(op), "persisting": numbers(rep)}
    for mode, nums in legs.items():
        for key in ("base_bytes", "delta_bytes", "base_bytes_written", "delta_bytes_written",
                    "snapshot_at_close_s_run_a", "restore_s", "run_b_to_first_answer_s"):
            emit("persistence_number", mode=mode, name=key, value=nums[key], card=info["nvidia_smi"])
    out = {
        "card": info["nvidia_smi"],
        "files": DS_FILES, "first_half_chunks": len(first), "second_half_chunks": len(second),
        "index_nodes": op["n_nodes"], "snapshot_interval_ms": PERSIST_SNAPSHOT_MS,
        "answers_equal_uninterrupted": same, "answers_differ": len(differ), "self_hits": self_ok,
        "run_b_distinct_texts_before_queries": len(before_q), "first_half_reembedded": reembedded,
        "run_b_embedder_rows": b["real_rows"], "run_b_embedder_rows_expected": want_rows,
        "run_b_attention_launches": b["launches"], "run_b_attention_launches_by_route": b["route_launches"],
        "exactly_once_files": files,
        "uninterrupted_s": whole["t1"] - whole["t0"],
        "uninterrupted_to_first_answer_s": (whole["t_first"] - whole["t0"]) if whole["t_first"] else None,
        "legs": legs,
        "walls_s": walls,
    }
    emit("persistence", **out)
    shutil.rmtree(root, ignore_errors=True)
    return {"launches": b["route_launches"], "metrics": out}


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


def _retrieve_leg(port: int, ds: dict, clients: int, retrieve, diagnose: dict, leg: str,
                  limit: int | None = None) -> tuple[dict, list]:
    """The document_store phase's retrieve payloads (the first ``limit``)
    from ``clients`` clients, each answer held against the in-process one;
    (the leg's numbers, the answers)."""
    jobs = [("POST", "/v1/retrieve", {"query": q, "k": k, "metadata_filter": m, "filepath_globpattern": g})
            for q, k, m, g in ds["queries"][:limit]]
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
    every chunk); sends phase document_store's retrieve payloads as JSON
    POSTs from 1 client (the first RS_ONE_CLIENT_REQUESTS) and all
    DS_QUERIES from RS_CLIENTS concurrent clients over
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
            leg, got = _retrieve_leg(port, ds, clients, retrieve, diagnose, "rest_serving",
                                     RS_ONE_CLIENT_REQUESTS if clients == 1 else None)
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
        sent = {"/v1/retrieve": len(ds["queries"][:RS_ONE_CLIENT_REQUESTS]) + len(ds["queries"]),
                "/v2/answer": len(ds["prompts"]),
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


FLOW_BACKFILL_FILES = 512  # cut from 2,048 with DS_FILES
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


GRAPH_SCALE = 12  # R-MAT scale, cut from 18 (PERF.md section 4); Graph500's smallest class is 26
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


KNN_INDEX_QUERIES = 128  # cut from 256 to keep the whole script in its time (PERF.md section 4)
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


MW_DOCS = 4096  # cut from 16,384 to pay for phases train and fabric, then from 8,192 (PERF.md section 4)
MW_QUERIES = 256  # cut from 1,024 with MW_DOCS
MW_WORKERS = 4
MW_SEARCH_ROWS = 1_000_000
MW_SEARCH_TIED = 1000  # rows 1000..1999 are one vector: ties at the k boundary
MW_SEARCH_SHARDS = 4
MW_SEARCH_REPS = 20
MW_CLUSTER_DOCS = 2048  # cut from 4,096 to pay for phases train and fabric
MW_CLUSTER_QUERIES = 256
MW_CLUSTER_THREADS = 2
MW_KILL_TICK = 34  # the 3rd of the 4 query ticks (32 doc ticks come first)
MW_CLUSTER_TIMEOUT_S = 300


def _bits_rows(rows: dict) -> dict:
    """Captured rows with every float as its IEEE bits, so equality is
    equality of bits."""
    def conv(v):
        if isinstance(v, float):
            return ("f64", np.float64(v).view(np.uint64).item())
        if isinstance(v, tuple):
            return tuple(conv(x) for x in v)
        return v
    return {int(k): conv(v) for k, v in rows.items()}


def _mw_rag_run(emb, rr, docs: list[str], queries: list[str], n_workers: int) -> dict:
    """One capture of the RAG loop on ``n_workers`` workers under the
    profiler: rows, seconds, ingest and query split, device ms, launches."""
    import torch

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.debug import _capture
    from pathway_tpu_torch.ops import attention_kernel as A
    from pathway_tpu_torch.stdlib.indexing import BruteForceKnnFactory
    from pathway_tpu_torch.tools import rag_pipeline

    elog, rlog = _LaunchLog(emb), _LaunchLog(rr)
    pw.G.clear()
    table = rag_pipeline.build(
        pw, embedder=emb, index_factory=BruteForceKnnFactory(embedder=emb, device=DEVICE),
        reranker=rr, docs=docs, queries=queries, tick_rows=PIPE_TICK, k=PIPE_K,
    )
    A.LAUNCHES = 0
    A.ROUTE_LAUNCHES.update(dict.fromkeys(A.ROUTE_LAUNCHES, 0))
    device_ms = None
    if DEVICE == "cuda":
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile as _profile

        with _profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            rows = _capture(table, n_workers=n_workers).rows
            torch.cuda.synchronize()
            t1 = time.perf_counter()
        device_ms = sum(ev.device_time_total / 1e3 for ev in prof.key_averages()
                        if ev.device_type == DeviceType.CUDA and ev.device_time_total > 0)
    else:
        t0 = time.perf_counter()
        rows = _capture(table, n_workers=n_workers).rows
        t1 = time.perf_counter()
    launches, route_launches = A.LAUNCHES, dict(A.ROUTE_LAUNCHES)
    pw.G.clear()
    e_spans = sorted(elog.spans, key=lambda sp: sp[1])
    r_spans = list(rlog.spans)
    seen, t_ingest = 0, t1
    for _a, b, n in e_spans:
        seen += n
        if seen >= len(docs):
            t_ingest = b
            break
    expected = 6 * len(e_spans) + 4 * len(r_spans)
    check(launches == expected, f"multiworker threads ({n_workers} workers): attention launches {launches} "
          f"!= expected {expected}")
    return {
        "rows": rows, "route_launches": route_launches,
        "metrics": {
            "workers": n_workers, "run_s": t1 - t0, "ingest_s": t_ingest - t0, "query_s": t1 - t_ingest,
            "ingest_docs_per_s": len(docs) / (t_ingest - t0),
            "query_rows_per_s": len(queries) / max(t1 - t_ingest, 1e-9),
            "embed_launches": len(e_spans), "embed_buckets": _buckets(e_spans),
            "rerank_launches": len(r_spans), "attention_launches": launches,
            "attention_launches_expected": expected, "device_ms": device_ms,
            "device_idle_share": None if device_ms is None else 1.0 - device_ms / ((t1 - t0) * 1e3),
            "captured_rows": len(rows),
        },
    }


def _update_multiset(deltas) -> list:
    """An update stream as the sorted list of its (time, key, diff, row)
    updates: equal streams up to the order in which workers delivered
    them."""
    return sorted(deltas)


def _mw_exchange_run(n_rows: int, n_ticks: int, n_workers: int, mode: str, fused: str) -> dict:
    """engine_kernels' filter → join → groupby on the thread-sharded runtime
    with ``PATHWAY_DEVICE_EXCHANGE=mode`` (``_FUSED=fused``): deltas,
    seconds and the plane's counters."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.engine import operators as ops
    from pathway_tpu_torch.internals import errors as _errors
    from pathway_tpu_torch.internals.logical import LogicalNode
    from pathway_tpu_torch.parallel.sharded import ShardedRuntime
    from pathway_tpu_torch.tools.engine_pipeline import build

    os.environ["PATHWAY_DEVICE_EXCHANGE"] = mode
    os.environ["PATHWAY_DEVICE_EXCHANGE_FUSED"] = fused
    table = build(n_rows, n_ticks)
    holder = {}

    def factory(cols=table.column_names()):
        holder["n"] = ops.CaptureNode(cols)
        return holder["n"]

    lnode = LogicalNode(factory, [table._node], name="capture")
    rt = ShardedRuntime(n_workers=n_workers, autocommit_duration_ms=5)
    prev = _errors.get_error_policy()
    _errors.set_error_policy(False)
    try:
        t0 = time.perf_counter()
        rt.run([lnode])
        sync()
        secs = time.perf_counter() - t0
    finally:
        _errors.set_error_policy(prev)
        pw.G.clear()
    plane = rt.device_plane
    return {
        "deltas": holder["n"].deltas, "seconds": secs,
        "rows_exchanged": plane.rows_exchanged if plane is not None else 0,
        "collectives": plane.collectives if plane is not None else 0,
        "rows_netted": plane.rows_netted if plane is not None else 0,
        "shard_devices": None if plane is None or plane.mesh is None
        else sorted({str(d) for d in plane.mesh.devices.flat}),
    }


def _cluster_port(processes: int) -> int:
    """A base port whose cluster ports (coordinator, each process's block
    link, the heartbeat monitor) are all free now."""
    import socket

    for _ in range(64):
        probe = socket.socket()
        probe.bind(("127.0.0.1", 0))
        base = probe.getsockname()[1]
        probe.close()
        socks = []
        try:
            for p in range(base, base + processes + 2):
                s = socket.socket()
                s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
                s.bind(("127.0.0.1", p))
                socks.append(s)
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise RuntimeError("no free cluster ports")


def _rag_cluster_argv(out: str, docs: int, queries: int, persist: str | None = None) -> list[str]:
    argv = [sys.executable, "-m", "pathway_tpu_torch.tools.rag_cluster", "--out", out, "--docs", str(docs),
            "--queries", str(queries), "--tick", str(PIPE_TICK), "--k", str(PIPE_K), "--device", DEVICE]
    if persist:
        argv += ["--persist", persist]
    return argv


def _cluster_env(extra: dict | None = None) -> dict:
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([root, os.environ.get("PYTHONPATH", "")]),
               PATHWAY_PROCESSES="2", PATHWAY_THREADS=str(MW_CLUSTER_THREADS), PATHWAY_BARRIER_TIMEOUT="120",
               PATHWAY_MICROBATCH_FLUSH_MS="3600000")
    env.update(extra or {})
    return env


def _launch_cluster(argv: list[str], env: dict) -> tuple[list[int], list[str], float]:
    """Both processes of a 2-process cluster: (exit codes, outputs, seconds).
    Every process is waited for with a timeout and killed after it."""
    env = dict(env, PATHWAY_FIRST_PORT=str(_cluster_port(2)))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(argv, env=dict(env, PATHWAY_PROCESS_ID=str(pid)), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for pid in range(2)]
    outs, codes = [], []
    deadline = time.monotonic() + MW_CLUSTER_TIMEOUT_S
    for p in procs:
        try:
            out, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, _ = p.communicate()
        outs.append(out or "")
        codes.append(p.returncode)
    return codes, outs, time.perf_counter() - t0


def _net_csv(path: str) -> dict:
    """Net multiplicity of each row of a csv sink (every column but time and
    diff)."""
    import csv

    state: dict = {}
    with open(path) as fh:
        for rec in csv.DictReader(fh):
            key = tuple(v for k, v in sorted(rec.items()) if k not in ("time", "diff"))
            state[key] = state.get(key, 0) + int(rec["diff"])
    return {k: v for k, v in state.items() if v != 0}


def _cluster_launches(outs: list[str]) -> int:
    total = 0
    for out in outs:
        for line in out.splitlines():
            if line.startswith("rag_cluster:") and "attention launches" in line:
                total += int(line.split("attention launches")[1].split()[0])
    return total


def phase_multiworker(info: dict) -> dict:
    """The live-RAG path on several workers, four legs; see the module
    docstring. Threads: ``pw.run(n_workers=MW_WORKERS)`` against one worker,
    answers equal in keys, order and score bits. Exchange: the exchange plane
    forced on (plain and fused) with MW_WORKERS shards on the card against
    the host plane, captured outputs equal. Sharded search: a 4-shard index
    against the single index, top-10 equal in keys and score bits. Cluster:
    a 2-process cluster (MW_CLUSTER_THREADS threads each) against one
    worker, then a ``kill`` fault under ``resilience.Supervisor`` with a
    filesystem persistence backend against the uninterrupted run."""
    import shutil
    import tempfile

    import torch

    from pathway_tpu_torch.internals.keys import tie_order
    from pathway_tpu_torch.ops import attention_kernel as A
    from pathway_tpu_torch.ops.encoder import EncoderConfig
    from pathway_tpu_torch.ops.knn import BruteForceKnnIndex, ShardedBruteForceKnnIndex
    from pathway_tpu_torch.parallel.mesh import device_mesh
    from pathway_tpu_torch.resilience import Supervisor
    from pathway_tpu_torch.tools import rag_cluster
    from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder
    from pathway_tpu_torch.xpacks.llm.rerankers import CrossEncoderReranker

    out: dict = {"card": info["nvidia_smi"]}
    walls: dict = {}
    t_leg = time.perf_counter()
    keys = ("PATHWAY_MICROBATCH", "PATHWAY_MICROBATCH_FLUSH_MS", "PATHWAY_DEVICE_EXCHANGE",
            "PATHWAY_DEVICE_EXCHANGE_FUSED", "PATHWAY_AUDIT", "PATHWAY_ENGINE_JAX")
    saved = {k: os.environ.get(k) for k in keys}
    launches = dict.fromkeys(A.ROUTE_LAUNCHES, 0)
    try:
        # --- 1. threads ----------------------------------------------------------
        os.environ["PATHWAY_MICROBATCH"] = "auto"
        os.environ["PATHWAY_MICROBATCH_FLUSH_MS"] = "3600000"
        emb = SentenceTransformerEmbedder("minilm", seed=0, device=DEVICE)
        rr_cfg = EncoderConfig(vocab_size=32768, d_model=384, n_heads=6, n_layers=4, d_ff=1536, max_len=256)
        rr = CrossEncoderReranker(rr_cfg, seed=1, device=DEVICE)
        docs = synth_docs(MW_DOCS)
        queries = docs[:MW_QUERIES]
        emb._encoder.encode_texts(docs[:512])
        rr._model.score_pairs([(q, d) for q, d in zip(queries[:512], docs[1:513])])
        sync()
        one = _mw_rag_run(emb, rr, docs, queries, 1)
        many = _mw_rag_run(emb, rr, docs, queries, MW_WORKERS)
        for run in (one, many):
            for route, n in run["route_launches"].items():
                launches[route] += n
        same = _bits_rows(one["rows"]) == _bits_rows(many["rows"])
        check(len(one["rows"]) == MW_QUERIES * PIPE_K,
              f"multiworker threads: {len(one['rows'])} rows at one worker, expected {MW_QUERIES * PIPE_K}")
        if not same:
            diff = [k for k in one["rows"] if _bits_rows({k: one["rows"][k]}) != _bits_rows({k: many["rows"].get(k)})]
            check(False, f"multiworker threads: {MW_WORKERS} workers' answers differ from one worker's in "
                  f"{len(diff)} of {len(one['rows'])} rows (keys, order or score bits)")
        check(many["route_launches"]["tensor_core"] > 0,
              f"multiworker threads: {MW_WORKERS} workers launched no tensor-core attention kernel")
        out["threads"] = {"docs": MW_DOCS, "queries": MW_QUERIES, "tick_rows": PIPE_TICK, "k": PIPE_K,
                          "one_worker": one["metrics"], f"{MW_WORKERS}_workers": many["metrics"],
                          "answers_equal": same}
        print(f"multiworker threads: 1 worker {one['metrics']['run_s']:.1f} s, {MW_WORKERS} workers "
              f"{many['metrics']['run_s']:.1f} s, equal {same}", file=sys.stderr, flush=True)
        del one, many
        walls["threads"], t_leg = time.perf_counter() - t_leg, time.perf_counter()

        # --- 2. exchange -----------------------------------------------------------
        os.environ["PATHWAY_AUDIT"] = "off"
        os.environ.pop("PATHWAY_ENGINE_JAX", None)
        host = _mw_exchange_run(ENGINE_ROWS, ENGINE_TICKS, MW_WORKERS, "off", "off")
        host_updates = _update_multiset(host["deltas"])
        legs = {"host_plane": host}
        for name, fused in (("device_plane", "off"), ("device_plane_fused", "on")):
            legs[name] = _mw_exchange_run(ENGINE_ROWS, ENGINE_TICKS, MW_WORKERS, "on", fused)
            got = legs[name]
            # workers hand blocks to the capture in the order their sweeps
            # finish, so the captured output is the multiset of updates
            got["identical"] = _update_multiset(got["deltas"]) == host_updates
            check(got["identical"], f"multiworker exchange ({name}): the captured output differs from the host plane's")
            check(got["rows_exchanged"] > 0 and got["collectives"] > 0,
                  f"multiworker exchange ({name}): the plane moved no rows")
            if DEVICE == "cuda":
                check(got["shard_devices"] == ["cuda:0"],
                      f"multiworker exchange ({name}): shards on {got['shard_devices']}, not the card")
        check(legs["device_plane_fused"]["rows_netted"] >= 0, "multiworker exchange: rows netted below 0")
        out["exchange"] = {
            "rows": ENGINE_ROWS, "ticks": ENGINE_TICKS, "shards": MW_WORKERS,
            "out_updates": len(host["deltas"]),
            **{name: {k: v for k, v in leg.items() if k != "deltas"} for name, leg in legs.items()},
            "identical": all(leg.get("identical", True) for leg in legs.values()),
        }
        print(f"multiworker exchange: host {host['seconds']:.1f} s, plane "
              f"{legs['device_plane']['seconds']:.1f} s, fused {legs['device_plane_fused']['seconds']:.1f} s",
              file=sys.stderr, flush=True)
        del legs, host
        walls["exchange"], t_leg = time.perf_counter() - t_leg, time.perf_counter()

        # --- 3. sharded search ---------------------------------------------------------
        corpus = make_corpus(MW_SEARCH_ROWS, 384, seed=5)
        corpus[MW_SEARCH_TIED : 2 * MW_SEARCH_TIED] = corpus[MW_SEARCH_TIED]
        rng = np.random.default_rng(6)
        qs = corpus[rng.integers(0, MW_SEARCH_ROWS, 1024)] + 0.05 * rng.normal(size=(1024, 384)).astype(np.float32)
        qs[0] = corpus[MW_SEARCH_TIED]  # a query hitting the tied block head-on
        key_list = list(range(MW_SEARCH_ROWS))
        rows_dev = torch.from_numpy(corpus).to(DEVICE)
        single = BruteForceKnnIndex(384, capacity=MW_SEARCH_ROWS, device=DEVICE)
        single.add_batch_device(key_list, rows_dev)
        mesh = device_mesh(n_shards=MW_SEARCH_SHARDS)
        sharded = ShardedBruteForceKnnIndex(384, mesh, capacity=MW_SEARCH_ROWS)
        sharded.add_batch_device(key_list, rows_dev)
        del rows_dev
        search = {"rows": MW_SEARCH_ROWS, "dim": 384, "shards": MW_SEARCH_SHARDS, "tied_rows": MW_SEARCH_TIED,
                  "capacity": sharded.capacity, "shard_devices": sorted({str(d) for d in mesh.devices.flat})}
        for q in (16, 1024):
            a, b = single.search(qs[:q], PIPE_K), sharded.search(qs[:q], PIPE_K)
            bits = lambda hits: [[(k, np.float32(s).view(np.uint32).item()) for k, s in h] for h in hits]  # noqa: E731
            eq = bits(a) == bits(b)
            check(eq, f"multiworker sharded search: top-{PIPE_K} at Q={q} differs from the single index")
            search[f"q{q}_equal"] = eq
        tied = [k for k, _s in sharded.search(qs[:1], PIPE_K)[0]]
        search["tied_query_hits"] = tied
        block = sorted(range(MW_SEARCH_TIED, 2 * MW_SEARCH_TIED), key=tie_order)[:PIPE_K]
        check(tied == block, f"multiworker sharded search: the tied query's hits {tied} are not the block's "
              f"first {PIPE_K} keys in the canonical tie order {block}")
        for name, ix in (("single", single), ("sharded", sharded)):
            times = []
            for _ in range(MW_SEARCH_REPS):
                t0 = time.perf_counter()
                s_, i_ = ix.search_device(qs[:16], PIPE_K)
                sync()
                times.append((time.perf_counter() - t0) * 1e3)
            search[f"{name}_q16_p50_ms"] = statistics.median(times)
        out["sharded_search"] = search
        del single, sharded, corpus
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
        walls["sharded_search"], t_leg = time.perf_counter() - t_leg, time.perf_counter()

        # --- 4. cluster ------------------------------------------------------------------
        want = None
        tmp = tempfile.mkdtemp(prefix="chip_smoke_cluster_")
        try:
            solo = os.path.join(tmp, "solo.csv")
            A.ROUTE_LAUNCHES.update(dict.fromkeys(A.ROUTE_LAUNCHES, 0))
            rag_cluster.main(["--out", solo, "--docs", str(MW_CLUSTER_DOCS), "--queries", str(MW_CLUSTER_QUERIES),
                              "--tick", str(PIPE_TICK), "--k", str(PIPE_K), "--device", DEVICE])
            for route, n in A.ROUTE_LAUNCHES.items():
                launches[route] += n
            want = _net_csv(solo)
            check(len(want) == MW_CLUSTER_QUERIES * PIPE_K,
                  f"multiworker cluster: one worker wrote {len(want)} answers, expected "
                  f"{MW_CLUSTER_QUERIES * PIPE_K}")
            dist = os.path.join(tmp, "dist.csv")
            codes, outs, secs = _launch_cluster(
                _rag_cluster_argv(dist, MW_CLUSTER_DOCS, MW_CLUSTER_QUERIES, os.path.join(tmp, "p_dist")),
                _cluster_env())
            check(codes == [0, 0], f"multiworker cluster: exit codes {codes}: " + " | ".join(o[-800:] for o in outs))
            got = _net_csv(dist) if os.path.exists(dist) else {}
            check(got == want, f"multiworker cluster: the 2-process answers differ from one worker's "
                  f"({len(set(got) ^ set(want))} rows)")
            cluster_launches = _cluster_launches(outs)
            launches["tensor_core"] += cluster_launches
            kill_out = os.path.join(tmp, "killed.csv")
            env = _cluster_env({"PATHWAY_FAULT_PLAN": f"kill:proc=1,tick={MW_KILL_TICK}"})
            t0 = time.perf_counter()
            sup = Supervisor(
                _rag_cluster_argv(kill_out, MW_CLUSTER_DOCS, MW_CLUSTER_QUERIES, os.path.join(tmp, "p_kill")),
                processes=2, threads=MW_CLUSTER_THREADS, first_port=_cluster_port(2), max_restarts=2,
                backoff_s=0.2, env=env, log_dir=os.path.join(tmp, "logs"),
            )
            result = sup.run()
            kill_s = time.perf_counter() - t0
            check(result.restarts == 1 and result.attempts[0]["exit_codes"][1] == -9,
                  f"multiworker cluster kill: attempts {[a['exit_codes'] for a in result.attempts]}")
            killed = _net_csv(kill_out) if os.path.exists(kill_out) else {}
            check(killed == got, f"multiworker cluster kill: the restarted cluster's answers differ from the "
                  f"uninterrupted run's ({len(set(killed) ^ set(got))} rows)")
            logs = []
            for path in result.log_paths:
                with open(path) as fh:
                    logs.append(fh.read())
            restart_launches = _cluster_launches(logs)
            launches["tensor_core"] += restart_launches
            replayed = [ln.split("replayed")[1].strip() for lg in logs for ln in lg.splitlines()
                        if ln.startswith("rag_cluster:") and "replayed" in ln]
            out["cluster"] = {
                "docs": MW_CLUSTER_DOCS, "queries": MW_CLUSTER_QUERIES, "processes": 2,
                "threads": MW_CLUSTER_THREADS, "answers": len(got), "equal_to_one_worker": got == want,
                "cluster_s": secs, "attention_launches": cluster_launches,
                "kill": {"fault": f"kill:proc=1,tick={MW_KILL_TICK}", "restarts": result.restarts,
                         "exit_codes": [a["exit_codes"] for a in result.attempts], "seconds": kill_s,
                         "equal_to_uninterrupted": killed == got, "attention_launches": restart_launches,
                         "replayed_events_by_process": replayed},
            }
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        walls["cluster"] = time.perf_counter() - t_leg
        out["leg_seconds"] = walls
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        import pathway_tpu_torch as pw

        pw.G.clear()
    emit("multiworker", **out)
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    return {"launches": launches, "metrics": out, "solo_answers": want}


# ------------------------------------------------------------ elasticity plane

#: the elastic phase: multiworker's cluster depth (docs, then queries), one
#: thread per process, every tick held ELASTIC_PACE_MS so a request lands
#: while the docs still stream
ELASTIC_DOCS = 2048
ELASTIC_QUERIES = 256
ELASTIC_PACE_MS = 300
ELASTIC_MODEL = "minilm"
#: the pod's shapes: it starts at 2 processes; leg A asks for 3 through the
#: CLI, leg B for 2 through process 0's /scale on the relaunched pod
ELASTIC_START = 2
ELASTIC_RESCALES = (("cli", 3), ("http", 2))
ELASTIC_TIMEOUT_S = 240
#: leg C: the migrate test's groupby pipeline, session rows (2, then 3 processes)
ELASTIC_MIGRATE_ROWS = (40_000, 6_000)
ELASTIC_MIGRATE_WORDS = 4_000

_MIGRATE_SCRIPT = """
import json, os, sys
import pathway_tpu_torch as pw
from pathway_tpu_torch.internals import telemetry

with open(os.environ["SESSION_ROWS"]) as fh:
    rows = json.load(fh)  # [[id, word, count], ...]
expected_total = int(os.environ["EXPECTED_TOTAL"])


class WordSchema(pw.Schema):
    id: int = pw.column_definition(primary_key=True)
    word: str
    count: int


def make_subject(w, n):
    mine = [r for i, r in enumerate(rows) if i % n == w]

    class S(pw.io.python.ConnectorSubject):
        def offset_state(self):
            return {"done": True}

        def seek(self, state):
            pass

        def run(self):
            for rid, word, cnt in mine:
                self.next(id=rid, word=word, count=cnt)

    return S()


t = pw.io.python.read_partitioned(make_subject, schema=WordSchema, name="src")
agg = t.groupby(pw.this.word).reduce(pw.this.word, total=pw.reducers.sum(pw.this.count))
got, keys = {}, {}


def on_agg(key, row, time, is_addition):
    if is_addition:
        got[row["word"]] = row["total"]
        keys[row["word"]] = int(key)


pw.io.subscribe(agg, on_change=on_agg)
total = t.reduce(c=pw.reducers.count())


def on_total(key, row, time, is_addition):
    if is_addition and row["c"] >= expected_total:
        rt = pw.internals.run.current_runtime()
        if rt is not None:
            rt.request_stop()


pw.io.subscribe(total, on_change=on_total)
pw.run(monitoring_level="none", persistence_config=pw.persistence.Config(
    backend=pw.persistence.Backend.filesystem(os.environ["PATHWAY_PERSISTENT_STORAGE"]),
    persistence_mode="operator_persisting"))
attrs = lambda name: [e["attrs"] for e in telemetry.events(name)]
print("RESULT:" + json.dumps({
    "got": got, "keys": keys, "migrate": attrs("elastic.migrate_restore"), "reshard": attrs("elastic.reshard_restore"),
    "rebucket": attrs("elastic.reshard_input_logs"), "replay": attrs("resilience.replay"),
}), flush=True)
"""


def _get_json(url: str, timeout: float = 5.0):
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read().decode())


def _docs_ingested(mon: int) -> int | None:
    """Rows process 0's inputs ingested, from its ``/status``: the docs' count
    until the last doc (queries start after it)."""
    try:
        st = _get_json(f"http://127.0.0.1:{mon}/status", timeout=2.0)
    except (OSError, ValueError):
        return None
    rows = [w.get("rows_ingested") or 0 for w in st.get("watermarks") or ()]
    return max(rows) if rows else None


def _rag_stats(texts: list[str]) -> list[dict]:
    out = []
    for text in texts:
        for line in text.splitlines():
            if line.startswith("rag_cluster_stats: "):
                out.append(json.loads(line[len("rag_cluster_stats: "):]))
    return out


def _elastic_rescales(tmp: str, want: dict) -> tuple[dict, dict]:
    """Legs A and B (see phase_elastic) on one supervised pod and one store;
    returns (metrics, attention launches per route summed over every
    process of every attempt)."""
    import re
    import threading

    from pathway_tpu_torch import elastic
    from pathway_tpu_torch.persistence.backends import FileBackend
    from pathway_tpu_torch.resilience import Supervisor

    store, out_csv = os.path.join(tmp, "store"), os.path.join(tmp, "answers.csv")
    shapes = [ELASTIC_START] + [n for _via, n in ELASTIC_RESCALES]
    mon = _cluster_port(max(shapes) - 1)  # process p's monitoring server at mon + p
    argv = [sys.executable, "-m", "pathway_tpu_torch.tools.rag_cluster", "--out", out_csv, "--docs",
            str(ELASTIC_DOCS), "--queries", str(ELASTIC_QUERIES), "--tick", str(PIPE_TICK), "--k", str(PIPE_K),
            "--device", DEVICE, "--model", ELASTIC_MODEL, "--persist", store, "--http",
            "--pace-ms", str(ELASTIC_PACE_MS)]
    # the microbatch buffers flush at every tick: the docs embed as they
    # stream, and the restore's replay tick embeds every doc in that tick (at
    # the default age deadline the replayed answers vary from run to run, on
    # both packages: tests/test_torch_elastic_replay.py, PERF.md section 7)
    env = _cluster_env({"PATHWAY_ELASTIC": "manual", "PATHWAY_MONITORING_HTTP_PORT": str(mon),
                        "PATHWAY_THREADS": "1", "PATHWAY_MICROBATCH_FLUSH_MS": "0"})
    relaunched: list[tuple[int, int]] = []
    sup = Supervisor(argv, processes=shapes[0], threads=1, first_port=_cluster_port(max(shapes)),
                     max_restarts=0, backoff_s=5.0, env=env, log_dir=os.path.join(tmp, "logs"), storage=store,
                     on_rescale=lambda frm, to: relaunched.append((frm, to)))
    box: dict = {}

    def run():
        try:
            box["result"] = sup.run()
        except BaseException as e:  # noqa: BLE001 — reported by the gate below
            box["error"] = e

    th = threading.Thread(target=run, daemon=True)
    th.start()
    deadline = time.monotonic() + ELASTIC_TIMEOUT_S
    requests: list[dict] = []
    for i, (via, target) in enumerate(ELASTIC_RESCALES):
        # A: once process 0 counts half the docs; B: once the relaunched
        # pod's plane answers on process 0's /status at its new shape
        while th.is_alive() and time.monotonic() < deadline:
            if i == 0:
                n = _docs_ingested(mon)
                ready = n is not None and n >= ELASTIC_DOCS // 2
            else:
                try:
                    st = _get_json(f"http://127.0.0.1:{mon}/status", timeout=2.0)
                except (OSError, ValueError):
                    st = {}
                n = None
                ready = len(relaunched) == i and (st.get("elastic") or {}).get("processes") == shapes[i]
            if ready:
                break
            time.sleep(0.05)
        else:
            break
        t_req = time.time()
        if via == "cli":
            proc = subprocess.run([sys.executable, "-m", "pathway_tpu_torch", "scale", "--to", str(target),
                                   "--storage", store], env=env, capture_output=True, text=True, timeout=120)
            req = {"via": "python -m pathway_tpu_torch scale", "ok": proc.returncode == 0,
                   "out": (proc.stdout + proc.stderr)[-400:]}
        else:
            answer = _get_json(f"http://127.0.0.1:{mon}/scale?to={target}")
            req = {"via": "/scale", "ok": bool(answer.get("ok")), "answer": answer}
        requests.append(dict(req, to=target, docs_ingested=n, unix=t_req))
    th.join(timeout=max(1.0, deadline - time.monotonic()))
    check(not th.is_alive(), f"elastic: the supervised pod did not finish in {ELASTIC_TIMEOUT_S} s")
    check("error" not in box, f"elastic: the supervisor failed: {box.get('error')!r}")
    check(len(requests) == len(ELASTIC_RESCALES) and all(r["ok"] for r in requests),
          f"elastic: a scale request failed or never went out: {requests}")
    result = box.get("result")
    # every process's stats line, by attempt (attempt<N>-p<P>.log)
    by_attempt: dict[int, list[dict]] = {}
    for path in (result.log_paths if result else []):
        with open(path) as fh:
            stats = _rag_stats([fh.read()])
        attempt = int(re.match(r"attempt(\d+)-", os.path.basename(path)).group(1))
        by_attempt.setdefault(attempt, []).extend(stats)
    history = [(m.version, m.processes) for m in elastic.membership_history(FileBackend(store))]
    got = _net_csv(out_csv) if os.path.exists(out_csv) else {}
    check(result is not None and result.rescales == len(ELASTIC_RESCALES) and result.restarts == 0,
          f"elastic: rescales/restarts {getattr(result, 'rescales', None)}/{getattr(result, 'restarts', None)}")
    check(history == list(enumerate(shapes)), f"elastic: membership history {history}, expected "
          f"{list(enumerate(shapes))}")
    check(got == want, f"elastic: the rescaled pod's answers differ from one worker's "
          f"({len(set(got) ^ set(want))} rows)")
    check(all(v == 1 for v in got.values()), "elastic: a (query, hit) appears more than once in the net state")
    check([len(by_attempt.get(a, ())) for a in range(len(shapes))] == shapes,
          f"elastic: stats lines per attempt {[len(by_attempt.get(a, ())) for a in range(len(shapes))]}, "
          f"expected {shapes}")
    launches: dict = {}
    for stats in by_attempt.values():
        for s in stats:
            for route, n in s["attention_launches"].items():
                launches[route] = launches.get(route, 0) + n
    check(0 < launches.get("tensor_core", 0) == sum(launches.values()),
          f"elastic: attention launches {launches}, expected every one on tensor_core")
    attempts = result.attempts if result else []
    rescales = []
    for i, req in enumerate(requests):
        new = by_attempt.get(i + 1, [])
        # every doc and query embedded again at the new shape: the relaunched
        # pod replays them all (the quiescing pod's close logged the rest)
        embedded = sum((s["udf_rows"] or {}).get("__item", 0) for s in new)
        check(embedded == ELASTIC_DOCS + ELASTIC_QUERIES,
              f"elastic rescale {i}: the new pod embedded {embedded} rows, expected {ELASTIC_DOCS + ELASTIC_QUERIES}")
        first = min((s["first_answer_unix"] for s in new if s["first_answer_unix"]), default=None)
        reshard = next((s["reshard"] for s in new if s["reshard"]), None) or {}
        frm, to = shapes[i], shapes[i + 1]
        rescales.append({
            "from": frm, "to": to, "request": req,
            "request_to_exit_s": attempts[i]["end_ns"] / 1e9 - req["unix"] if len(attempts) > i else None,
            "request_to_relaunch_s": attempts[i + 1]["start_ns"] / 1e9 - req["unix"] if len(attempts) > i + 1
            else None,
            "request_to_first_answer_s": first - req["unix"] if first else None,
            "docs_reembedded": embedded - ELASTIC_QUERIES, "replayed_by_process": [s["replayed"] for s in new],
            # the sources are process 0's unpartitioned docs, queries and
            # ticker: no input log is partitioned, so none is rebucketed
            "rows_rebucketed": int(reshard.get("rows_moved") or 0) if reshard.get("mode") != "migrate" else 0,
            "moved_fraction": elastic.moved_fraction(frm, to), "reshard": reshard,
        })
    metrics = {
        "shapes": shapes, "rescales": rescales, "supervisor_rescales": getattr(result, "rescales", None),
        "restarts": getattr(result, "restarts", None), "exit_codes": [a.get("exit_codes") for a in attempts],
        "membership_history": history, "answers": len(got), "equal_to_one_worker": got == want,
        "attention_launches": launches,
    }
    return metrics, launches


def _migrate_session(script: str, n_proc: int, store: str, rows: list, expected: int) -> list[dict]:
    """One session of leg C's groupby pipeline on an ``n_proc``-process
    cluster; every process's RESULT line."""
    rows_file = f"{store}.rows{n_proc}.json"
    with open(rows_file, "w") as fh:
        json.dump(rows, fh)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([os.path.dirname(os.path.abspath(__file__)),
                                                        os.environ.get("PYTHONPATH", "")]),
               PATHWAY_PROCESSES=str(n_proc), PATHWAY_THREADS="1", PATHWAY_BARRIER_TIMEOUT="120",
               PATHWAY_FIRST_PORT=str(_cluster_port(n_proc)), PATHWAY_ELASTIC="manual", PATHWAY_SHARDMAP="on",
               PATHWAY_PERSISTENT_STORAGE=store, SESSION_ROWS=rows_file, EXPECTED_TOTAL=str(expected))
    procs = [subprocess.Popen([sys.executable, script], env=dict(env, PATHWAY_PROCESS_ID=str(p)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for p in range(n_proc)]
    outs = []
    deadline = time.monotonic() + ELASTIC_TIMEOUT_S
    for p in procs:
        try:
            o, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            o, _ = p.communicate()
        outs.append(o or "")
    codes = [p.returncode for p in procs]
    check(codes == [0] * n_proc, f"elastic migrate: exit codes {codes}: " + " | ".join(o[-600:] for o in outs))
    results = [json.loads(ln[len("RESULT:"):]) for o in outs for ln in o.splitlines() if ln.startswith("RESULT:")]
    check(len(results) == n_proc, f"elastic migrate: {len(results)} of {n_proc} processes reported")
    return results


def _migrate_leg(tmp: str) -> dict:
    """Leg C (see phase_elastic)."""
    import pickle

    import numpy as np

    from pathway_tpu_torch.internals import shardmap
    from pathway_tpu_torch.persistence.backends import FileBackend

    script = os.path.join(tmp, "migrate_pipeline.py")
    with open(script, "w") as fh:
        fh.write(_MIGRATE_SCRIPT)
    store = os.path.join(tmp, "migrate_store")
    rng = np.random.default_rng(0)
    n1, n2 = ELASTIC_MIGRATE_ROWS
    rows1 = [[i, f"w{int(w)}", int(c)] for i, (w, c) in
             enumerate(zip(rng.integers(0, ELASTIC_MIGRATE_WORDS, n1), rng.integers(1, 100, n1)))]
    rows2 = [[n1 + i, f"w{int(w)}", int(c)] for i, (w, c) in
             enumerate(zip(rng.integers(0, ELASTIC_MIGRATE_WORDS, n2), rng.integers(1, 100, n2)))]
    want: dict = {}
    for _i, w, c in rows1 + rows2:
        want[w] = want.get(w, 0) + c
    t0 = time.perf_counter()
    r1 = _migrate_session(script, 2, store, rows1, n1)
    s1 = time.perf_counter() - t0
    t0 = time.perf_counter()
    r2 = _migrate_session(script, 3, store, rows2, n1 + n2)
    s2 = time.perf_counter() - t0
    backend = FileBackend(store)
    old_map, new_map = shardmap.read_shardmap_version(backend, 0), shardmap.read_shardmap(backend)
    moved = shardmap.diff(old_map, new_map) if old_map is not None and new_map is not None else None
    migs = [m for r in r2 for m in r.get("migrate") or ()]
    # every group's key, from the sessions' outputs: those whose owner the
    # new map changes are the state that must move
    keys = np.array(sorted({k for r in r1 + r2 for k in (r.get("keys") or {}).values()}), dtype=np.uint64)
    moved_groups = int((old_map.owner_of_keys(keys) != new_map.owner_of_keys(keys)).sum()) if moved is not None \
        and len(keys) else None
    got: dict = {}
    for r in r1 + r2:  # session 2 emits the groups it changed; the rest stand as session 1 left them
        got.update(r.get("got") or {})
    # a replay would re-read the whole input history: its events pickled as
    # the input logs hold them (key, values, diff), one list per session
    replay_bytes = sum(len(pickle.dumps([(i, (i, w, c), 1) for i, w, c in rows])) for rows in (rows1, rows2))
    check(len(migs) == 3 and not any(r.get("reshard") or r.get("rebucket") for r in r2),
          f"elastic migrate: the 3-process restore did not migrate on every process: {migs}")
    check(moved is not None and all(m.get("ranges_moved") == len(moved) for m in migs),
          f"elastic migrate: ranges moved {[m.get('ranges_moved') for m in migs]}, shardmap.diff counts "
          f"{None if moved is None else len(moved)}")
    check(sum(e.get("events", 0) for r in r2 for e in r.get("replay") or ()) == 0,
          "elastic migrate: events replayed from the logs after the migration")
    check(got == want, f"elastic migrate: the totals differ from the rows' sums "
          f"({sum(1 for w in want if got.get(w) != want[w])} of {len(want)} words)")
    return {
        "rows": [n1, n2], "words": ELASTIC_MIGRATE_WORDS, "session_s": [s1, s2],
        "ranges_moved": len(moved) if moved is not None else None,
        "map_moved_fraction": None if moved is None else shardmap.moved_fraction(old_map, new_map),
        "modulo_moved_fraction": 2 / 3, "groups": int(len(keys)), "groups_moved": moved_groups,
        "rows_moved": sum(m.get("rows_moved", 0) for m in migs),
        "bytes_moved": sum(m.get("bytes_moved", 0) for m in migs),
        "replay_input_bytes": replay_bytes, "pause_s": max((m.get("pause_s", 0) for m in migs), default=None),
        "equal": got == want,
    }


def phase_elastic(info: dict, solo_answers: dict | None = None) -> dict:
    """The elasticity plane on the card, legs A and B on one supervised pod
    and one filesystem store: the rag_cluster pod (ELASTIC_DOCS docs, then
    ELASTIC_QUERIES queries, the minilm embedder and the 4-layer reranker on
    the card, bf16; ticks held ELASTIC_PACE_MS by its live ticker) under
    ``resilience.Supervisor`` with ``PATHWAY_ELASTIC=manual``, 2 processes x
    1 thread. Leg A, scale out: once process 0's ``/status`` counts half the
    docs, ``python -m pathway_tpu_torch scale --to 3 --storage DIR``; the
    pod quiesces, exits 75 and is relaunched at 3. Leg B, scale in over
    HTTP: once the relaunched pod's plane answers on process 0's ``/status``,
    ``/scale?to=2`` there; it quiesces and is relaunched at 2, over the logs
    and the membership table that leg A rewrote. The quiescing pod's close
    polls the timed docs and queries to their end, so each relaunched pod
    only replays them (no live doc reaches it; the ticker alone streams on),
    re-embedding every doc on the card: the index node cannot migrate.
    Gates: two rescales, no restart, membership history (0, 2), (1, 3),
    (2, 2), the final net answers equal one worker's (multiworker's
    ``solo`` run of the same command) bit for bit, each (query, hit) once,
    every doc and query embedded again by each relaunched pod, no plain
    attention call. The sources are process 0's unpartitioned ones, so no
    input log is rebucketed (printed, not gated). Leg C, O(moved state):
    the migrate test's groupby pipeline under ``PATHWAY_SHARDMAP=on``, 2
    then 3 processes: migrated (no replay), ranges moved ==
    ``shardmap.diff``, totals equal the rows' sums; bytes moved beside a
    replay's."""
    import shutil
    import tempfile

    from pathway_tpu_torch.ops import attention_kernel as A
    from pathway_tpu_torch.tools import rag_cluster

    out: dict = {"card": info["nvidia_smi"], "docs": ELASTIC_DOCS, "queries": ELASTIC_QUERIES,
                 "pace_ms": ELASTIC_PACE_MS, "model": ELASTIC_MODEL}
    launches = dict.fromkeys(A.ROUTE_LAUNCHES, 0)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_elastic_")
    walls: dict = {}
    try:
        t0 = time.perf_counter()
        if solo_answers is None:
            solo = os.path.join(tmp, "solo.csv")
            rag_cluster.main(["--out", solo, "--docs", str(ELASTIC_DOCS), "--queries", str(ELASTIC_QUERIES),
                              "--tick", str(PIPE_TICK), "--k", str(PIPE_K), "--device", DEVICE,
                              "--model", ELASTIC_MODEL])
            solo_answers = _net_csv(solo)
        walls["solo"] = time.perf_counter() - t0
        check(len(solo_answers) == ELASTIC_QUERIES * PIPE_K,
              f"elastic: one worker wrote {len(solo_answers)} answers")
        t0 = time.perf_counter()
        out["rescale"], pod_launches = _elastic_rescales(tmp, solo_answers)
        for route, n in pod_launches.items():
            launches[route] = launches.get(route, 0) + n
        walls["rescale"] = time.perf_counter() - t0
        emit("elastic_leg", leg="rescale", seconds=walls["rescale"], **out["rescale"])
        t0 = time.perf_counter()
        out["migrate"] = _migrate_leg(tmp)
        walls["migrate"] = time.perf_counter() - t0
        emit("elastic_leg", leg="migrate", seconds=walls["migrate"], **out["migrate"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["leg_seconds"] = walls
    out["attention_launches"] = launches
    emit("elastic", **out)
    return {"launches": launches, "metrics": out}


# --------------------------------------------------------------- training path

#: the backward kernel's checked cases, (B texts, L, heads, hd): the train
#: step's texts (256 pairs, both sides; the step encodes each side in its
#: own call of 256), the bert block's heads, 512 keys, a length that fills
#: no tile evenly, the widest head, a single row, multichip_dryrun's step (4
#: heads of 16 at L 16), the widest head on the fused route at L 128 and
#: below (bf16; f32 at hd 128 takes the two-pass route), the narrowest at
#: L 128 (fused) and 200 (two-pass), the widths that run in a wider or new
#: instantiation (48 and 96 at L 128: bf16 fused, f32 fused at 48 and
#: two-pass at 96; 8 at L 16) and 1,024 keys (two-pass)
BWD_SHAPES = {
    "train": (512, 128, 6, 64), "bert": (64, 128, 12, 32), "max_len": (4, 512, 6, 64),
    "ragged": (3, 77, 6, 64), "hd128": (4, 256, 3, 128), "one": (1, 16, 6, 64),
    "dryrun": (8, 16, 4, 16), "hd128_l128": (4, 128, 3, 128), "hd128_l77": (3, 77, 3, 128),
    "hd16_l128": (16, 128, 4, 16), "hd16_l200": (4, 200, 4, 16),
    "hd48_l128": (16, 128, 8, 48), "hd96_l128": (8, 128, 4, 96), "hd8_l16": (8, 16, 48, 8),
    "l1024": (2, 1024, 6, 64),
    # heads the aligned kernels do not take, in 3 heads (D = 3 hd): hd 12
    # (bf16 rows of 72 bytes: the fused route at 8-byte copies; f32 rows of
    # 144 bytes: the aligned fused route) at 128 and 77 keys and on the
    # two-pass route at 200; hd 1 (2- and 4-byte copies); hd 136 and 256 on
    # the two-pass route in column blocks of 128, at 128 and 600 keys; and
    # phase encoder_widths' train shapes (32 heads of 12, 3 of 256)
    "any_hd12_l128": (16, 128, 3, 12), "any_hd12_l77": (8, 77, 3, 12), "any_hd12_l200": (4, 200, 3, 12),
    "any_hd1_l16": (8, 16, 3, 1), "any_hd136_l128": (8, 128, 3, 136), "any_hd136_l600": (2, 600, 3, 136),
    "any_hd256_l128": (8, 128, 3, 256), "any_hd256_l600": (2, 600, 3, 256),
    "train_hd12": (256, 128, 32, 12), "train_hd256": (256, 128, 3, 256),
    # the fused route in f32 at width 64 where a text keeps one key
    # (BWD_ONE_KEY): its P is 1 there, so dP and D cancel and dS is their
    # rounding alone
    "one_key_hd64": (8, 77, 3, 64),
}
#: cases whose odd texts keep exactly one key (text i: key 37 (i // 2) mod L)
BWD_ONE_KEY = ("one_key_hd64",)
#: the backward's timed cases: the train step's shape and multichip_dryrun's,
#: encoder_widths' train shapes, and the two-pass route at 512 keys (the
#: train phase's long leg), 1,024 keys and 3 heads of 256 at 600 keys
BWD_TIMED = ("train", "dryrun", "train_hd12", "train_hd256", "max_len", "l1024", "any_hd256_l600")
#: the train phase: the main path's encoder at full width, the reference
#: test's recipe (each positive is the same text) on synth_docs
TRAIN_PAIRS = 256
TRAIN_LEN = 128
TRAIN_STEPS = 10
TRAIN_F32_STEPS = 3
TRAIN_LR = 1e-2
#: the train phase's long leg: the encoder's max_len (the reference's
#: position table, pathway_tpu/ops/encoder.py), every backward on the
#: two-pass route; docs long enough to fill it
TRAIN_LONG_PAIRS = 64
TRAIN_LONG_LEN = 512
TRAIN_LONG_WORDS = 600
TRAIN_LONG_STEPS = 3
TRAIN_LONG_F32_STEPS = 1
#: a step on the kernels against the same step with both plain attention
#: functions on the card: the loss within this share of itself and every
#: gradient leaf within this share of the leaf's largest value. bf16: the
#: kernels round the probabilities and the outputs where the plain version
#: does, but sum in another order, so a bf16 ulp (2^-8) can flip through
#: six layers of bf16 activations; f32: the forward's 3xTF32 products keep
#: ~2^-22 of a product
TRAIN_GRAD_TOL = {"bfloat16": 5e-2, "float32": 1e-3}
#: the fabric phase: rag_cluster's served mode, docs and requests per door
FABRIC_DOCS = 1024  # cut from 2,048 to keep the whole script in its time (PERF.md section 4)
FABRIC_QUERIES = 32
FABRIC_LEGS = {
    "zero_hop": {"PATHWAY_FABRIC": "on", "PATHWAY_SHARDMAP": "on"},
    "replica": {"PATHWAY_FABRIC": "on"},
}


def phase_kernels_backward() -> list[dict]:
    """attention_short_flat_backward against its plain version on the card,
    both dtypes at every shape of BWD_SHAPES (row 0 of each batch fully
    masked), with the route each case took; returns every case's record.
    dq, dk and dv each within 1e-5 (|ref| + max|ref|) in f32 and 2^-7
    (|ref| + max|ref|) in bf16 (one bf16 ulp of the output plus one of
    every rounded probability and dS operand). At the ragged shape, d_out
    given at an offset of one element (rows not 16-byte aligned, as autograd
    may pass it) gives the same bits. At each timed shape, on the route it
    takes and on the two-pass route forced: a second launch gives the same
    bits, and the first texts alone (8, or half the batch) give those rows
    of the whole call bit for bit (no atomics, no sums across blocks); then
    it times the kernel, the two-pass route on the same inputs, the plain
    version and the backward of ``scaled_dot_product_attention`` (the
    yardstick)."""
    import torch
    import torch.nn.functional as F

    from pathway_tpu_torch.ops import attention_kernel as A

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    records = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        rel = 1e-5 if dtype == torch.float32 else 2.0 ** -7
        for label, (B, L, H, hd) in BWD_SHAPES.items():
            D, scale = H * hd, hd ** -0.5
            vb = _projection_copy(H, hd, dtype)
            geo = A.backward_launch_geometry(B, L, H, hd, dtype, vb)
            q, k, v, mask = _attention_inputs(B, L, dtype, gen, H, hd)
            if label in BWD_ONE_KEY:
                mask[1::2] = False
                for i in range(1, B, 2):
                    mask[i, 37 * (i // 2) % L] = True
            out = A.attention_short_flat(q, k, v, mask, H, scale)
            g = torch.randn(B, L, D, device="cuda", generator=gen).to(dtype)
            before = dict(A.BACKWARD_ROUTE_LAUNCHES)
            got = A.attention_short_flat_backward(q, k, v, mask, out, g, H, scale)
            torch.cuda.synchronize()
            check(A.BACKWARD_ROUTE_LAUNCHES[geo.route] == before[geo.route] + 1,
                  f"attention backward {label} {dname}: the call did not launch on route {geo.route}")
            want = A.attention_short_flat_backward_plain(q, k, v, mask, out, g, H, scale)
            errs, ok = {}, True
            for name, a, b in zip(("dq", "dk", "dv"), got, want):
                a, b = a.float(), b.float()
                err = (a - b).abs()
                ok = ok and bool(torch.isfinite(a).all()) and bool((err <= rel * (b.abs() + b.abs().max())).all())
                errs[name] = err.max().item()
            check(ok, f"attention backward {label} {dname}: kernel disagrees with plain {errs}")
            # the route by the rule the kernels state: fused up to 128 keys
            # and 128 columns where its block fits (bf16 at any width, f32
            # up to 64), else two passes; on attention_any.cu below 16-byte
            # copies and above 128 columns
            width = A.kernel_width(hd) if vb == 16 else A.any_width(hd)
            want_fused = L <= 128 and hd <= 128 and (dtype == torch.bfloat16 or width <= 64)
            if want_fused:
                want_route = A.BACKWARD_ROUTES[dtype][0] if vb == 16 else A.ANY_ROUTES[dtype][1]
            else:
                want_route = A.BACKWARD_ROUTES[dtype][1] if hd <= 128 and vb == 16 else A.ANY_ROUTES[dtype][2]
            check(geo.route == want_route, f"attention backward {label} {dname}: route {geo.route}, "
                  f"expected {want_route}")
            if label == "ragged":
                wide = torch.empty(B, L, D + 1, device="cuda", dtype=dtype)
                wide[..., 1:] = g
                shifted = A.attention_short_flat_backward(q, k, v, mask, out, wide[..., 1:], H, scale)
                check(all(torch.equal(a, b) for a, b in zip(got, shifted)),
                      f"attention backward ragged {dname}: an unaligned d_out changes the result")
                del wide, shifted
            rec = {"case": label, "dtype": dname, "B": B, "L": L, "H": H, "hd": hd, "route": geo.route,
                   "kernel_width": geo.width, "col_blocks": geo.col_blocks, "copy_bytes": geo.copy_bytes,
                   "rows_per_block": geo.rows, "smem_bytes": geo.smem_bytes,
                   "max_abs_err": max(errs.values()), "errors": errs,
                   "tolerance": f"{rel:g}*(|ref|+max|ref|)", "ok": ok}
            if label == "train":
                check(geo.fused, f"attention backward train {dname}: route {geo.route}, expected the fused route")
            if label in BWD_TIMED:
                two = A._two_pass_geometry(B, L, H, hd, dtype, vb)
                n = max(1, min(8, B // 2))
                # the route the call takes, then the two-pass route forced
                # (at a two-pass shape the same route twice)
                for tag, run in (("", lambda *t: A.attention_short_flat_backward(*t, H, scale)),
                                 ("two_pass_", lambda *t: A._launch_backward(*t, H, scale, hd, two))):
                    first = run(q, k, v, mask, out, g)
                    again = run(q, k, v, mask, out, g)
                    part = run(q[:n], k[:n], v[:n], mask[:n], out[:n], g[:n])
                    rec[tag + "deterministic"] = all(torch.equal(a, b) for a, b in zip(first, again))
                    rec[tag + "batch_invariant"] = all(torch.equal(a[:n], b) for a, b in zip(first, part))
                    check(rec[tag + "deterministic"], f"attention backward {label} {dname} {tag}: two launches differ")
                    check(rec[tag + "batch_invariant"],
                          f"attention backward {label} {dname} {tag}: {n} texts alone differ from rows 0-{n - 1}")
                    del first, again, part
                # 10 launches at the train shapes and 50 above 128 keys (each
                # 0.1-7 ms), 200 below
                iters = 10 if label.startswith("train") else 50 if L > 128 else 200
                rec["ms"] = cuda_ms(lambda: A.attention_short_flat_backward(q, k, v, mask, out, g, H, scale), iters)
                rec["two_pass_ms"] = cuda_ms(
                    lambda: A._launch_backward(q, k, v, mask, out, g, H, scale, hd, two), iters)
                rec["plain_ms"] = cuda_ms(
                    lambda: A.attention_short_flat_backward_plain(q, k, v, mask, out, g, H, scale), iters)
                qh, kh, vh = (t.detach().view(B, L, H, hd).transpose(1, 2).requires_grad_(True) for t in (q, k, v))
                bias = torch.zeros(B, 1, 1, L, device="cuda", dtype=dtype).masked_fill(~mask[:, None, None, :], -1e30)
                ref_out = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=bias, scale=scale)
                gh = g.view(B, L, H, hd).transpose(1, 2)
                rec["library_ms"] = cuda_ms(
                    lambda: torch.autograd.grad(ref_out, (qh, kh, vh), gh, retain_graph=True), iters)
                es = q.element_size()
                nbytes = 8 * B * L * D * es + B * L  # q, k, v, out, d_out read; dq, dk, dv written; mask
                flops = 10 * B * H * L * L * hd
                t_bytes = nbytes / H100_BYTES_PER_S * 1e3
                if dtype == torch.bfloat16:
                    t_ops = flops / H100_BF16_FLOPS * 1e3
                else:
                    t_ops = 3 * flops / H100_TF32_FLOPS * 1e3
                    rec["bound_fp32_pipes_ms"] = max(t_bytes, flops / H100_F32_FLOPS * 1e3)
                rec["bound_ms"] = max(t_bytes, t_ops)
                rec["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
                del qh, kh, vh, ref_out, bias
            records.append(rec)
            emit("kernel_check", kernel="attention_short_flat_backward", **rec)
            del q, k, v, mask, out, g, got, want
    torch.cuda.empty_cache()
    return records


def _reset_attention_counts() -> None:
    from pathway_tpu_torch.ops import attention_kernel as A

    A.LAUNCHES = A.BACKWARD_LAUNCHES = 0
    for counts in (A.ROUTE_LAUNCHES, A.BACKWARD_ROUTE_LAUNCHES, A.COPY_LAUNCHES, A.BACKWARD_COPY_LAUNCHES):
        counts.update(dict.fromkeys(counts, 0))


def _attention_counts() -> tuple[dict, dict]:
    from pathway_tpu_torch.ops import attention_kernel as A

    return dict(A.ROUTE_LAUNCHES), dict(A.BACKWARD_ROUTE_LAUNCHES)


def _train_batch(pairs: int, length: int = TRAIN_LEN, words: int = DOC_WORDS):
    """(tok_a, mask_a, tok_b, mask_b): synth_docs of ``words`` words hashed
    to ``length`` tokens, each positive the same text."""
    import torch

    from pathway_tpu_torch.ops.encoder import HashTokenizer

    ids, mask = HashTokenizer(32768, length)(synth_docs(pairs, words))
    ids = torch.from_numpy(ids.astype(np.int64)).to(DEVICE)
    mask = torch.from_numpy(mask).to(DEVICE)
    return ids, mask, ids, mask


def _loss_and_grads(params, cfg, batch) -> tuple:
    """One step's loss and gradient leaves, with the forward's and the
    backward's seconds."""
    import torch

    from pathway_tpu_torch.convert import tree_leaves, tree_map
    from pathway_tpu_torch.ops import encoder as E

    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    leaves = tree_leaves(live)
    sync()
    t0 = time.perf_counter()
    with torch.enable_grad():
        loss = E.contrastive_loss(live, cfg, *batch)
        sync()
        t1 = time.perf_counter()
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    sync()
    return loss.detach(), grads, t1 - t0, time.perf_counter() - t1


def _plain_attention():
    """A context in which the attention's forward and backward are their
    plain versions, on the card as on the CPU."""
    import contextlib

    from pathway_tpu_torch.ops import attention_kernel as A

    @contextlib.contextmanager
    def ctx():
        saved = (A._forward, A.attention_short_flat_backward)
        A._forward = lambda q, k, v, mask, n_heads, scale: A.attention_short_flat_plain(q, k, v, mask, n_heads, scale)
        A.attention_short_flat_backward = A.attention_short_flat_backward_plain
        try:
            yield
        finally:
            A._forward, A.attention_short_flat_backward = saved

    return ctx()


def _kernel_vs_plain_step(params, cfg, batch, tol: float) -> dict:
    """The same step's loss and gradients on the kernels and on the plain
    attention functions; errors per leaf over the leaf's largest value."""
    loss_k, grads_k, _f, _b = _loss_and_grads(params, cfg, batch)
    with _plain_attention():
        loss_p, grads_p, _f, _b = _loss_and_grads(params, cfg, batch)
    loss_err = abs(float(loss_k) - float(loss_p)) / max(abs(float(loss_p)), 1e-12)
    leaf_err = max(
        float((a.float() - b.float()).abs().max()) / max(float(b.float().abs().max()), 1e-12)
        for a, b in zip(grads_k, grads_p)
    )
    return {"loss_kernels": float(loss_k), "loss_plain": float(loss_p), "loss_rel_err": loss_err,
            "grad_leaf_rel_err": leaf_err, "tolerance": tol, "ok": loss_err <= tol and leaf_err <= tol}


def _train_leg(cfg, params, batch, steps: int, tol: float, route: int = 0) -> dict:
    """``steps`` steps of ``contrastive_train_step`` from zero momenta with
    the launches they made (every backward on ``BACKWARD_ROUTES[dtype]
    [route]``: 0 fused, 1 two-pass), then one step split into forward and
    backward, one under ``torch.profiler`` and the kernels-vs-plain step."""
    import torch

    from pathway_tpu_torch.convert import tree_map
    from pathway_tpu_torch.ops import attention_kernel as A
    from pathway_tpu_torch.ops import encoder as E

    dname = str(cfg.dtype).replace("torch.", "")
    opt = tree_map(torch.zeros_like, params)
    _reset_attention_counts()
    losses, step_ms = [], []
    p = params
    for _ in range(steps):
        sync()
        t0 = time.perf_counter()
        p, opt, loss = E.contrastive_train_step(p, cfg, opt, batch, lr=TRAIN_LR)
        losses.append(float(loss))  # the float() syncs
        step_ms.append((time.perf_counter() - t0) * 1e3)
    fwd, bwd = _attention_counts()
    per_step = 2 * cfg.n_layers
    want_route = A.BACKWARD_ROUTES[cfg.dtype][route]
    check(all(np.isfinite(losses)), f"train {dname}: non-finite loss {losses}")
    check(steps < 2 or losses[-1] < losses[0], f"train {dname}: the loss did not fall: {losses}")
    check(sum(fwd.values()) == per_step * steps and bwd[want_route] == sum(bwd.values()) == per_step * steps,
          f"train {dname}: attention launches forward {fwd} backward {bwd}, expected {per_step * steps} each, "
          f"every backward on {want_route}")
    _l, _g, fwd_s, bwd_s = _loss_and_grads(p, cfg, batch)
    out = {
        "dtype": dname, "L": int(batch[0].shape[1]), "steps": steps, "losses": losses, "step_ms": step_ms,
        "step_ms_median": statistics.median(step_ms), "forward_ms": fwd_s * 1e3, "backward_ms": bwd_s * 1e3,
        "tokens_per_s": 2 * batch[0].shape[0] * batch[0].shape[1] / (statistics.median(step_ms) / 1e3),
        "attention_launches": {"forward": fwd, "backward": bwd},
    }
    if DEVICE == "cuda":
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile as _profile

        with _profile(activities=[ProfilerActivity.CUDA]) as prof:
            sync()
            t0 = time.perf_counter()
            E.contrastive_train_step(p, cfg, opt, batch, lr=TRAIN_LR)
            sync()
            wall_ms = (time.perf_counter() - t0) * 1e3
        evs = [ev for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA and ev.device_time_total > 0]
        device_ms = sum(ev.device_time_total / 1e3 for ev in evs)
        bwd_names = [n for names in A.BACKWARD_KERNELS.values() for n in names]
        bwd_evs = {ev.key[:80]: ev.device_time_total / 1e3 for ev in evs if any(n in ev.key for n in bwd_names)}
        out["profiled_step"] = {
            "wall_ms": wall_ms, "device_ms": device_ms, "device_idle_share": 1.0 - device_ms / wall_ms,
            "attention_forward_ms": sum(ev.device_time_total / 1e3 for ev in evs if "attention_tc_kernel" in ev.key),
            "attention_backward_ms": sum(bwd_evs.values()),
            "attention_backward_kernels_ms": bwd_evs,
            "top_kernels_ms": {ev.key[:80]: ev.device_time_total / 1e3
                               for ev in sorted(evs, key=lambda e: -e.device_time_total)[:8]},
        }
        if not evs:
            out["profiled_step"]["device_idle_share"] = "not measured (no device events)"
        check(out["profiled_step"]["attention_backward_ms"] > 0,
              f"train {dname}: the profiled step shows no backward kernel named {bwd_names}")
    vs = _kernel_vs_plain_step(params, cfg, batch, tol)
    check(vs["ok"], f"train {dname}: the kernels' step differs from the plain-attention step: {vs}")
    out["kernels_vs_plain"] = vs
    return out


def phase_train(info: dict) -> dict:
    """Contrastive training at the main path's full width: TRAIN_STEPS steps
    in bf16 (f32 parameters) and TRAIN_F32_STEPS in f32 (TF32 off), each
    attention forward on attention_short.cu and backward on
    attention_short_bwd.cu; see the module docstring."""
    import torch

    from pathway_tpu_torch.convert import tree_map
    from pathway_tpu_torch.ops.encoder import EncoderConfig, init_params

    cfg = EncoderConfig(vocab_size=32768, d_model=384, n_heads=6, n_layers=6, d_ff=1536, max_len=512)
    params = tree_map(lambda t: t.to(DEVICE), init_params(cfg, torch.Generator().manual_seed(0)))
    batch = _train_batch(TRAIN_PAIRS)
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    out = {"card": info["nvidia_smi"], "pairs": TRAIN_PAIRS, "L": int(batch[0].shape[1]), "lr": TRAIN_LR,
           "config": cfg._replace(dtype=str(cfg.dtype))._asdict()}
    out["bf16"] = _train_leg(cfg, params, batch, TRAIN_STEPS, TRAIN_GRAD_TOL["bfloat16"])
    f32 = cfg._replace(dtype=torch.float32)
    out["f32"] = _train_leg(f32, params, batch, TRAIN_F32_STEPS, TRAIN_GRAD_TOL["float32"])
    # the long leg: L = max_len, every backward on the two-pass route
    long_batch = _train_batch(TRAIN_LONG_PAIRS, TRAIN_LONG_LEN, TRAIN_LONG_WORDS)
    out["long_pairs"] = TRAIN_LONG_PAIRS
    out["bf16_long"] = _train_leg(cfg, params, long_batch, TRAIN_LONG_STEPS, TRAIN_GRAD_TOL["bfloat16"], route=1)
    out["f32_long"] = _train_leg(f32, params, long_batch, TRAIN_LONG_F32_STEPS, TRAIN_GRAD_TOL["float32"], route=1)
    if DEVICE == "cuda":
        out["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    emit("train", **out)
    legs = ("bf16", "f32", "bf16_long", "f32_long")
    launches = {r: sum(out[leg]["attention_launches"]["forward"][r] for leg in legs)
                for r in out["bf16"]["attention_launches"]["forward"]}
    bwd = {r: sum(out[leg]["attention_launches"]["backward"][r] for leg in legs)
           for r in out["bf16"]["attention_launches"]["backward"]}
    del params
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    return {"launches": launches, "backward_launches": bwd, "metrics": out}


def phase_multichip_dryrun(info: dict) -> dict:
    """``tools/multichip_dryrun.dryrun_multichip(4)`` on four logical shards
    of the card: the TP/DP step (2 x 2, f32, equal to the unsharded step),
    the sharded KNN self-search, the key exchange, the sharded dataflow and
    the device plane against one worker."""
    from pathway_tpu_torch.tools.multichip_dryrun import dryrun_multichip

    _reset_attention_counts()
    res = dryrun_multichip(4, device=DEVICE)
    fwd, bwd = _attention_counts()
    check(sum(bwd.values()) > 0, f"multichip_dryrun: the train step launched no backward kernel ({bwd})")
    emit("multichip_dryrun", card=info["nvidia_smi"], **res, attention_launches={"forward": fwd, "backward": bwd})
    return {"launches": fwd, "backward_launches": bwd, "metrics": res}


def _free_door_pair() -> int:
    """A port ``p`` with ``p`` and ``p + 1`` free (the two doors)."""
    import socket

    for _ in range(100):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        p = s.getsockname()[1]
        s.close()
        socks = []
        try:
            for q in (p, p + 1):
                t = socket.socket()
                t.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
                t.bind(("127.0.0.1", q))
                socks.append(t)
            return p
        except OSError:
            continue
        finally:
            for t in socks:
                t.close()
    raise RuntimeError("no free pair of door ports")


def phase_fabric(info: dict) -> dict:
    """``tools/rag_cluster.py --serve`` at FABRIC_DOCS docs: one worker in
    this process, then 2 processes x 2 threads on the card with the fabric
    on, with the shard map (zero-hop) and without it (replica-served); both
    doors answer the first FABRIC_QUERIES docs. Gates: every answer byte-
    identical to the coordinator's and to one worker's, each doc first in
    its own answer."""
    import shutil
    import tempfile

    from pathway_tpu_torch.ops import attention_kernel as A
    from pathway_tpu_torch.tools import rag_cluster

    out: dict = {"card": info["nvidia_smi"], "docs": FABRIC_DOCS, "queries_per_door": FABRIC_QUERIES}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_fabric_")
    launches = dict.fromkeys(A.ROUTE_LAUNCHES, 0)
    args = ["--docs", str(FABRIC_DOCS), "--queries", str(FABRIC_QUERIES), "--k", str(PIPE_K), "--device", DEVICE]
    try:
        solo_path = os.path.join(tmp, "solo.json")
        _reset_attention_counts()
        t0 = time.perf_counter()
        rag_cluster.main(["--out", solo_path, "--serve", str(_free_door_pair()), *args])
        out["solo_s"] = time.perf_counter() - t0
        for route, n in A.ROUTE_LAUNCHES.items():
            launches[route] += n
        with open(solo_path) as fh:
            (solo,) = json.load(fh).values()
        bodies = [b for _s, b, _f, _ms in solo]
        check(all(s == 200 for s, _b, _f, _ms in solo), "fabric: one worker answered an error")
        self_hits = sum(json.loads(b)[0]["text"] == d for b, d in zip(bodies, synth_docs(FABRIC_QUERIES)))
        check(self_hits == FABRIC_QUERIES, f"fabric: {self_hits}/{FABRIC_QUERIES} docs first in their own answer")
        out["solo_p50_ms"] = statistics.median(ms for *_r, ms in solo)
        for leg, env in FABRIC_LEGS.items():
            path = os.path.join(tmp, f"{leg}.json")
            cenv = _cluster_env(env)
            cenv.pop("PATHWAY_MICROBATCH_FLUSH_MS", None)  # served queries flush at each tick
            codes, outs, secs = _launch_cluster(
                [sys.executable, "-m", "pathway_tpu_torch.tools.rag_cluster", "--out", path,
                 "--serve", str(_free_door_pair()), *args], cenv)
            check(codes == [0, 0], f"fabric {leg}: exit codes {codes}: " + " | ".join(o[-800:] for o in outs))
            doors = {}
            if os.path.exists(path):
                with open(path) as fh:
                    doors = json.load(fh)
            rec = {"seconds": secs, "doors": {}, "attention_launches": _cluster_launches(outs)}
            launches["tensor_core"] += rec["attention_launches"]
            coord = None
            for i, (door, rows) in enumerate(sorted(doors.items(), key=lambda kv: int(kv[0]))):
                got = [b for _s, b, _f, _ms in rows]
                coord = got if coord is None else coord
                hdrs = [f or "" for _s, _b, f, _ms in rows]
                rec["doors"][f"p{i}"] = {
                    "p50_ms": statistics.median(ms for *_r, ms in rows),
                    "replica_answered": sum(h.startswith("replica:") for h in hdrs),
                    "forwarded": sum(h.startswith("forwarded:") for h in hdrs),
                    "owner_answered": sum(h.startswith("owner:") for h in hdrs),
                    "equal_to_coordinator": got == coord, "equal_to_one_worker": got == bodies,
                }
                check(got == coord and got == bodies,
                      f"fabric {leg}: door p{i}'s answers differ from the coordinator's or one worker's")
            check(len(doors) == 2, f"fabric {leg}: {len(doors)} doors answered, expected 2")
            out[leg] = rec
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit("fabric", **out)
    return {"launches": launches, "metrics": out}


def _backward_entry(records: list[dict], dtype: str, launches: dict) -> dict:
    """The attention backward of one dtype on the kernels line: its time at
    the train step's shape (the fused route) beside the two-pass route's,
    its largest error over every checked case of its dtype, the route each
    case took, and its launches per path and per backward route."""
    import torch

    from pathway_tpu_torch.ops import attention_kernel as A

    routes = A.BACKWARD_ROUTES[getattr(torch, dtype)]
    mine = [r for r in records if r["dtype"] == dtype and r["route"] in routes]
    worst = max(mine, key=lambda r: r["max_abs_err"])
    train = next(r for r in mine if r["case"] == "train")
    what = {
        "fused_tensor_core": "one fused pass per (text, head) on the tensor cores (mma.sync m16n8k16 bf16, "
                             "ldmatrix, cp.async), dS in bf16 as the operand of dQ and dK",
        "fused_tensor_core_3xtf32": "one fused pass per (text, head) on the tensor cores in 3xTF32 "
                                    "(mma.sync m16n8k8 tf32 on split operands, cp.async)",
    }[routes[0]]
    entry = {
        "name": f"attention_short_flat_backward[{dtype}]",
        "route": "cuda",
        "source": "pathway_tpu_torch/csrc/attention_short_bwd.cu",
        "replaces": "pathway_tpu/ops/encoder.py:150",
        "launches": sum(by_route.get(r, 0) for by_route in launches.values() for r in routes),
        "launches_by_path": {path: sum(by_route.get(r, 0) for r in routes) for path, by_route in launches.items()},
        "launches_by_route": {r: sum(by_route.get(r, 0) for by_route in launches.values()) for r in routes},
        "max_abs_err": worst["max_abs_err"],
        "max_abs_err_case": f"{dtype} {worst['case']} (B={worst['B']} L={worst['L']} hd={worst['hd']})",
        "cases_checked": len(mine),
        "route_by_case": {r["case"]: r["route"] for r in mine},
        "ms": train["ms"],
        "plain_ms": train["plain_ms"],
        "bound_ms": train["bound_ms"],
        "bound_by": train["bound_by"],
        "library_ms": train["library_ms"],
        "two_pass_ms": train["two_pass_ms"],
        "timed_cases": {r["case"]: {k: r[k] for k in ("ms", "two_pass_ms", "plain_ms", "library_ms", "bound_ms")}
                        for r in mine if "ms" in r},
        "deterministic": train["deterministic"],
        "batch_invariant": train["batch_invariant"],
        "shape": f"B=512 L=128 D=384 H=6 {dtype}",
        "kernel": f"{what}; L > 128 (and f32 at hd 80-128): {routes[1]}, a dQ pass and a dK/dV pass over "
                  "64-row tiles on the tensor cores",
    }
    if "bound_fp32_pipes_ms" in train:
        entry["bound_fp32_pipes_ms"] = train["bound_fp32_pipes_ms"]
    return entry


def _kernel_entry(records: list[dict], dtype: str, route: str, what: str, launches: dict) -> dict:
    """One route of the attention kernel on the kernels line: its time at the
    embed shape, and its largest error over every checked case of its dtype
    (with the case it came from). ``launches``: path name -> route counts,
    each read right after that path ran; the line's count is their sum."""
    mine = [r for r in records if r["dtype"] == dtype and r["route"] == route]
    worst = max(mine, key=lambda r: r["max_abs_err"])
    embed = next(r for r in mine if r["case"] == "embed")
    entry = {
        "name": f"attention_short_flat[{dtype}]",
        "route": "cuda",
        "source": "pathway_tpu_torch/csrc/attention_short.cu",
        "replaces": "pathway_tpu/ops/attention_kernel.py:33",
        "launches": sum(by_route.get(route, 0) for by_route in launches.values()),
        "launches_by_path": {path: by_route.get(route, 0) for path, by_route in launches.items()},
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


def _any_kernel_entry(records: list[dict], dtype: str, launches: dict, widths: dict) -> dict:
    """attention_any.cu's forward of one dtype on the kernels line: its time
    at encoder_widths' 3 heads of 256 (two column blocks), its largest error
    over every case it ran, and its launches per path and per copy width
    (the copy widths counted in encoder_widths' legs)."""
    import torch

    from pathway_tpu_torch.ops import attention_kernel as A

    route = A.ANY_ROUTES[getattr(torch, dtype)][0]
    mine = [r for r in records if r["dtype"] == dtype and r["route"] == route]
    worst = max(mine, key=lambda r: r["max_abs_err"])
    head = next(r for r in mine if r["case"] == "enc_hd256")
    copies: dict = {}
    for key, m in widths["metrics"].items():
        if key.endswith(dtype) and m["route"] == route:
            for vb, n in m["copy_launches"].items():
                copies[vb] = copies.get(vb, 0) + n
    return {
        "name": f"attention_short_flat_any[{dtype}]",
        "route": "cuda",
        "source": "pathway_tpu_torch/csrc/attention_any.cu",
        "replaces": "pathway_tpu/ops/attention_kernel.py:33",
        "launches": sum(by_route.get(route, 0) for by_route in launches.values()),
        "launches_by_path": {path: by_route.get(route, 0) for path, by_route in launches.items()},
        "launches_by_copy_bytes": copies,
        "max_abs_err": worst["max_abs_err"],
        "max_abs_err_case": f"{dtype} {worst['case']} (B={worst['B']} L={worst['L']} hd={worst['hd']})",
        "cases_checked": len(mine),
        "copy_bytes_checked": sorted({r["copy_bytes"] for r in mine}),
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "shape": f"B=1024 L=128 D=768 H=3 {dtype}",
        "kernel": "any head width and copy width (16/8/4/2 bytes); up to 256 columns at full width: Q resident, "
                  "K/V through a cp.async ring of 64-key slots, one score pass at L <= 128 (two above); wider "
                  "heads in column blocks of 128; tensor cores "
                  + ("(mma.sync bf16)" if dtype == "bfloat16" else "in 3xTF32"),
        "timed_cases": {r["case"]: {k: r[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "copy_bytes")}
                        for r in mine if "ms" in r},
    }


def _any_backward_entry(records: list[dict], dtype: str, launches: dict) -> dict:
    """attention_any.cu's backward of one dtype on the kernels line: the
    fused route at any copy width and the two-pass route in column blocks;
    its time at encoder_widths' train shape of 3 heads of 256 (two-pass in
    column blocks), its largest error, launches per path and route."""
    import torch

    from pathway_tpu_torch.ops import attention_kernel as A

    routes = A.ANY_ROUTES[getattr(torch, dtype)][1:]
    mine = [r for r in records if r["dtype"] == dtype and r["route"] in routes]
    worst = max(mine, key=lambda r: r["max_abs_err"])
    head = next(r for r in mine if r["case"] == "train_hd256")
    return {
        "name": f"attention_short_flat_backward_any[{dtype}]",
        "route": "cuda",
        "source": "pathway_tpu_torch/csrc/attention_any.cu",
        "replaces": "pathway_tpu/ops/encoder.py:150",
        "launches": sum(by_route.get(r, 0) for by_route in launches.values() for r in routes),
        "launches_by_path": {path: sum(by_route.get(r, 0) for r in routes) for path, by_route in launches.items()},
        "launches_by_route": {r: sum(by_route.get(r, 0) for by_route in launches.values()) for r in routes},
        "max_abs_err": worst["max_abs_err"],
        "max_abs_err_case": f"{dtype} {worst['case']} (B={worst['B']} L={worst['L']} hd={worst['hd']})",
        "cases_checked": len(mine),
        "route_by_case": {r["case"]: r["route"] for r in mine},
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "shape": f"B=256 L=128 D=768 H=3 {dtype}",
        "kernel": f"{routes[0]}: the fused backward's kernel at any copy width (L <= 128, hd <= 128); "
                  f"{routes[1]}: the two-pass route's kernels at any copy width, in column blocks of 128 "
                  "above 128 columns",
        "timed_cases": {r["case"]: {k: r[k] for k in ("ms", "two_pass_ms", "plain_ms", "library_ms", "bound_ms")}
                        for r in mine if "ms" in r},
    }


def _two_pass_entry(records: list[dict], dtype: str, launches: dict) -> dict:
    """The two-pass backward's kernels (``attention_two_pass_dq`` and
    ``attention_two_pass_dkv``, built in both libraries) of one dtype on the
    kernels line: its time at encoder_widths' train shape of 3 heads of 256
    (column blocks), every timed case beside its two-pass time forced, its
    largest error over the cases on its routes, its launches per path and
    route (the library entries above count them too)."""
    import torch

    from pathway_tpu_torch.ops import attention_kernel as A

    t = getattr(torch, dtype)
    routes = (A.BACKWARD_ROUTES[t][1], A.ANY_ROUTES[t][2])
    mine = [r for r in records if r["dtype"] == dtype and r["route"] in routes]
    worst = max(mine, key=lambda r: r["max_abs_err"])
    head = next(r for r in mine if r["case"] == "train_hd256")
    timed = [r for r in records if r["dtype"] == dtype and "ms" in r]
    return {
        "name": f"attention_two_pass_backward[{dtype}]",
        "route": "cuda",
        "source": "pathway_tpu_torch/csrc/attention_bwd.cuh",
        "replaces": "pathway_tpu/ops/encoder.py:150",
        "launches": sum(by_route.get(r, 0) for by_route in launches.values() for r in routes),
        "launches_by_path": {path: sum(by_route.get(r, 0) for r in routes) for path, by_route in launches.items()},
        "launches_by_route": {r: sum(by_route.get(r, 0) for by_route in launches.values()) for r in routes},
        "max_abs_err": worst["max_abs_err"],
        "max_abs_err_case": f"{dtype} {worst['case']} (B={worst['B']} L={worst['L']} hd={worst['hd']})",
        "cases_checked": len(mine),
        "route_by_case": {r["case"]: r["route"] for r in mine},
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "shape": f"B=256 L=128 D=768 H=3 {dtype}",
        "kernel": "a dQ pass and a dK/dV pass over 64-row tiles on the tensor cores "
                  + ("(mma.sync m16n8k16 bf16, ldmatrix, cp.async rings)" if dtype == "bfloat16"
                     else "in 3xTF32 (mma.sync m16n8k8 tf32 on split operands, cp.async rings)"),
        "timed_cases": {r["case"]: {k: r.get(k) for k in ("route", "ms", "two_pass_ms", "plain_ms", "library_ms",
                                                          "bound_ms", "two_pass_deterministic",
                                                          "two_pass_batch_invariant")}
                        for r in timed},
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
    bwd_kern = timed("kernels_backward", phase_kernels_backward)
    widths = timed("encoder_widths", phase_encoder_widths, info)
    state = timed("main_path", phase_main_path, synth_docs(N_DOCS))
    timed("checks", phase_checks, state)
    bench_vecs = main_path_embeddings(state["index"], N_DOCS)
    del state["index"]
    f32 = timed("f32_path", phase_f32_path, state, info)
    pipe = timed("pipeline", phase_pipeline, info)
    tier = timed("tiered", phase_tiered, info)
    timed("engine_kernels", phase_engine_kernels, info)
    timed("engine_semantics", phase_engine_semantics, info)
    timed("audit_fault", phase_audit_fault, info)
    temporal = timed("temporal", phase_temporal, info)
    bert = timed("bert_path", phase_bert_path, info)
    store = timed("document_store", phase_document_store, info)
    try:
        persist = timed("persistence", phase_persistence, info, store)
        rest = timed("rest_serving", phase_rest_serving, info, store)
        obs = timed("observability", phase_observability, info, store, rest)
        flow = timed("flow", phase_flow, info, store)
    finally:
        import shutil

        shutil.rmtree(store["root"], ignore_errors=True)
    conn = timed("connectors", phase_connectors, info)
    timed("graphs", phase_graphs, info)
    timed("knn_index", phase_knn_index, info, bench_vecs)
    multi = timed("multiworker", phase_multiworker, info)
    elastic = timed("elastic", phase_elastic, info, multi["solo_answers"])
    train = timed("train", phase_train, info)
    dry = timed("multichip_dryrun", phase_multichip_dryrun, info)
    fab = timed("fabric", phase_fabric, info)
    emit("phase_walls", seconds=walls, total=round(sum(walls.values()), 3))

    launches = {
        "main_path": state["launches"], "encoder_widths": widths["launches"], "f32_path": f32["launches"],
        "pipeline": pipe["launches"],
        "tiered_pipeline": tier["launches"], "temporal": temporal["launches"], "bert_path": bert["launches"],
        "document_store": store["launches"], "rest_serving": rest["launches"], "observability": obs["launches"],
        "flow": flow["launches"], "persistence": persist["launches"], "connectors": conn["launches"],
        "multiworker": multi["launches"],
        "elastic": elastic["launches"], "train": train["launches"], "multichip_dryrun": dry["launches"],
        "fabric": fab["launches"],
    }
    bwd_launches = {"encoder_widths": widths["backward_launches"], "train": train["backward_launches"],
                    "multichip_dryrun": dry["backward_launches"]}
    line = {"kernels": [
        _kernel_entry(kern, "bfloat16", "tensor_core", "bf16, tensor cores (mma.sync, cp.async)", launches),
        _kernel_entry(kern, "float32", "tensor_core_3xtf32",
                      "f32, tensor cores in 3xTF32 (mma.sync m16n8k8 tf32 on split operands, cp.async)", launches),
        _backward_entry(bwd_kern, "bfloat16", bwd_launches),
        _backward_entry(bwd_kern, "float32", bwd_launches),
        _any_kernel_entry(kern, "bfloat16", launches, widths),
        _any_kernel_entry(kern, "float32", launches, widths),
        _any_backward_entry(bwd_kern, "bfloat16", bwd_launches),
        _any_backward_entry(bwd_kern, "float32", bwd_launches),
        _two_pass_entry(bwd_kern, "bfloat16", bwd_launches),
        _two_pass_entry(bwd_kern, "float32", bwd_launches),
    ]}
    # every kernel of the line was launched on a path of the run
    idle = [e["name"] for e in line["kernels"] if not e["launches"]]
    check(not idle, f"kernels no path launched: {idle}")
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
