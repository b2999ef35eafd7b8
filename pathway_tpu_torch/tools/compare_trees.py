"""Run chosen phases of ``chip_smoke.py`` from several checkouts on one card,
one process each, in one call, and print their headline numbers side by side.

    python -m pathway_tpu_torch.tools.compare_trees --out chiprun_out/ab \\
        --phases kernels,main_path,f32_path,pipeline,document_store,rest_serving \\
        parent=ab/parent change=. change=. parent=ab/parent

Phase ``attention_main`` times the attention kernels at the main path's
shapes alone (the embed forward and the train step's backward, both
dtypes), with no other case run before them in the process.

Each ``NAME=DIR`` runs in its own process, in the order given, with DIR's
``chip_smoke.py`` and DIR's package (the kernels built from DIR's sources),
so that a parent and a change are timed on the same card in the same call;
list them as parent, change, change, parent, so that the host clock's drift
shows. A phase that a checkout lacks is skipped. Each run's whole output
goes to ``OUT/<i>-<name>.log``; the last line printed is one JSON object:
per run, the headline metric of each phase and the failures that the
checkout's own checks reported. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

PHASES = (
    "attention_main", "kernels", "kernels_backward", "main_path", "f32_path", "pipeline", "engine_kernels", "audit_fault", "temporal", "document_store",
    "persistence", "rest_serving", "observability", "flow", "graphs", "knn_index", "multiworker",
)

#: phase -> the fields of its chip_smoke line kept in the summary (dotted
#: paths into nested objects)
HEADLINES = {
    "attention_main": tuple(f"{fn}_{d}_{case}_ms" for fn, case in (("forward", "embed"), ("backward", "train"))
                            for d in ("bfloat16", "float32")),
    "main_path": ("embed_index_docs_per_s", "rag_query_p50_ms", "rag_query_rerank_p50_ms", "knn1m_query16_p50_ms"),
    "f32_path": ("f32_embed_index_docs_per_s",),
    "pipeline": ("ingest_docs_per_s", "query_rows_per_s"),
    "engine_kernels": (
        "fused_chain.20_ticks.device_tier_s", "fused_chain.20_ticks.register_program_s",
        "fused_chain_audited.full.seconds", "fused_chain_audited.on.seconds",
    ),
    "audit_fault": ("violation.tick", "hot_hits"),
    "temporal": tuple(
        f"{q}.{mode}.{route}_events_per_s"
        for q in ("q5", "q7", "q7_cutoff", "q8") for mode in ("static", "ticks") for route in ("gpu", "numpy")
    ) + ("q7_cutoff.dropped_late_bids", "phase_s"),
    "document_store": ("ingest_chunks_per_s", "query_rows_per_s"),
    "rest_serving": (
        "ingest_chunks_per_s", "retrieve_1_clients.requests_per_s", "retrieve_1_clients.client_p50_ms",
        "retrieve_1_clients.equal_to_in_process", "retrieve_32_clients.requests_per_s",
        "retrieve_32_clients.client_p50_ms", "retrieve_32_clients.equal_to_in_process", "answer.requests_per_s",
    ),
    "flow": tuple(f"{mode}.{k}" for mode in ("on", "off") for k in (
        "client_p50_ms", "client_p99_ms", "backfill_chunks_per_s")) + ("settled_answers_equal", "shed.shed_rows"),
    "graphs": ("pagerank.gpu_s", "pagerank.cpu_s", "pagerank.gpu_edges_per_s", "pagerank.device_idle_share",
               "bellman_ford.gpu_s", "louvain.gpu_s"),
    "knn_index": ("gpu_s", "cpu_s", "recall_at_10_vs_brute_force"),
    "multiworker": (
        "threads.one_worker.ingest_docs_per_s", "threads.4_workers.ingest_docs_per_s",
        "threads.one_worker.query_rows_per_s", "threads.4_workers.query_rows_per_s", "threads.answers_equal",
        "exchange.host_plane.seconds", "exchange.device_plane.seconds", "exchange.device_plane_fused.seconds",
        "sharded_search.single_q16_p50_ms", "sharded_search.sharded_q16_p50_ms",
        "cluster.equal_to_one_worker", "cluster.kill.equal_to_uninterrupted",
    ),
    "persistence": tuple(
        f"legs.{mode}.{k}" for mode in ("operator_persisting", "operator_persisting_at_close", "persisting")
        for k in ("base_bytes", "delta_bytes", "restore_s", "run_b_to_first_answer_s")
    ) + ("answers_equal_uninterrupted", "first_half_reembedded"),
    "observability": tuple(
        f"legs.{leg}.{k}" for leg in ("planes_off", "audit_timeline_off", "profile_full")
        for k in ("requests_per_s", "client_p50_ms", "client_p99_ms")
    ),
}

# Runs inside DIR (cwd and first on sys.path), so every import resolves to
# that checkout. argv: the phases, comma-separated.
_RUNNER = r"""
import os, shutil, sys
sys.path.insert(0, os.getcwd())
import torch
import chip_smoke as cs
want = sys.argv[1].split(",")
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
info = cs.phase_device()
cs.phase_build()
if "attention_main" in want:
    # the attention kernels at the main path's shapes alone, in one fixed
    # order, so every tree's timings follow the same work: the embed
    # forward (1,024 texts, L 128, 6 heads of 64) in bf16 and f32, then the
    # train step's backward (512 texts), each the median of ATTN_REPEATS
    # event-timed runs of ATTN_ITERS launches
    import json, statistics
    from pathway_tpu_torch.ops import attention_kernel as A
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rec = {"phase": "attention_main"}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).replace("torch.", "")
        for case, B, fn in (("embed", 1024, "forward"), ("train", 512, "backward")):
            q, k, v, mask = cs._attention_inputs(B, 128, dtype, gen, 6, 64)
            scale = 64 ** -0.5
            if fn == "forward":
                run = lambda: A.attention_short_flat(q, k, v, mask, 6, scale)
            else:
                out = A.attention_short_flat(q, k, v, mask, 6, scale)
                g = torch.randn(B, 128, 384, device="cuda", generator=gen).to(dtype)
                run = lambda: A.attention_short_flat_backward(q, k, v, mask, out, g, 6, scale)
            rec[f"{fn}_{dname}_{case}_ms"] = statistics.median(cs.cuda_ms(run, 50, warmup=5) for _ in range(7))
    print(json.dumps(rec), flush=True)
if "kernels" in want:
    cs.phase_kernels()
if "kernels_backward" in want and hasattr(cs, "phase_kernels_backward"):
    cs.phase_kernels_backward()
if "main_path" in want or "f32_path" in want or "knn_index" in want:
    state = cs.phase_main_path(cs.synth_docs(cs.N_DOCS))
    if "knn_index" in want and hasattr(cs, "phase_knn_index"):
        cs.phase_knn_index(info, cs.main_path_embeddings(state["index"], cs.N_DOCS))
    del state["index"]
    if "f32_path" in want:
        cs.phase_f32_path(state, info)
    del state
if "pipeline" in want:
    cs.phase_pipeline(info)
if "engine_kernels" in want:
    cs.phase_engine_kernels(info)
if "audit_fault" in want and hasattr(cs, "phase_audit_fault"):
    cs.phase_audit_fault(info)
if "temporal" in want and hasattr(cs, "phase_temporal"):
    cs.phase_temporal(info)
if "graphs" in want and hasattr(cs, "phase_graphs"):
    cs.phase_graphs(info)
if "multiworker" in want and hasattr(cs, "phase_multiworker"):
    cs.phase_multiworker(info)
if "document_store" in want or "rest_serving" in want or "flow" in want or "persistence" in want:
    store = cs.phase_document_store(info)
    try:
        if "persistence" in want and hasattr(cs, "phase_persistence"):
            cs.phase_persistence(info, store)
        if "rest_serving" in want and hasattr(cs, "phase_rest_serving"):
            rest = cs.phase_rest_serving(info, store)
            if "observability" in want and hasattr(cs, "phase_observability"):
                cs.phase_observability(info, store, rest)
        if "flow" in want and hasattr(cs, "phase_flow"):
            cs.phase_flow(info, store)
    finally:
        if isinstance(store, dict) and store.get("root"):
            shutil.rmtree(store["root"], ignore_errors=True)
print("compare_trees: failures", cs.failures, flush=True)
"""


def _field(obj, path: str):
    for part in path.split("."):
        if not isinstance(obj, dict) or part not in obj:
            return None
        obj = obj[part]
    return obj


def summarize(lines: list[str]) -> dict:
    """The headline fields of each phase line in one run's output, and, for
    the kernel checks, each timed case's ms by kernel and dtype."""
    out: dict = {}
    for line in lines:
        if not line.startswith("{"):
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        phase = rec.get("phase")
        if phase == "kernel_check" and "ms" in rec:
            out.setdefault("kernels", {})[f"{rec.get('kernel', '')} {rec['dtype']} {rec['case']}".lstrip()] = rec["ms"]
        elif phase in HEADLINES:
            out[phase] = {f: _field(rec, f) for f in HEADLINES[phase]}
        elif phase == "device":
            out["card"] = rec.get("nvidia_smi")
    return out


def run_one(name: str, tree: str, phases: list[str], log_path: str, timeout: float) -> dict:
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.run(
            [sys.executable, "-c", _RUNNER, ",".join(phases)], cwd=tree, stdout=subprocess.PIPE,
            stderr=log, text=True, timeout=timeout,
        )
        log.write(proc.stdout)
    lines = proc.stdout.splitlines()
    failures = next((ln for ln in lines if ln.startswith("compare_trees: failures")), None)
    return {"name": name, "tree": tree, "rc": proc.returncode, "seconds": time.perf_counter() - t0,
            "failures": failures, **summarize(lines)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("runs", nargs="+", help="NAME=DIR, in the order to run them")
    ap.add_argument("--phases", default=",".join(PHASES))
    ap.add_argument("--out", default="chiprun_out/compare_trees")
    ap.add_argument("--timeout", type=float, default=1200.0, help="seconds per run")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = sorted(set(phases) - set(PHASES))
    if unknown:
        ap.error(f"unknown phases {unknown}; known: {', '.join(PHASES)}")
    os.makedirs(args.out, exist_ok=True)
    results = []
    for i, spec in enumerate(args.runs):
        name, sep, tree = spec.partition("=")
        if not sep or not os.path.isfile(os.path.join(tree, "chip_smoke.py")):
            ap.error(f"{spec!r}: expected NAME=DIR with DIR holding chip_smoke.py")
        res = run_one(name, os.path.abspath(tree), phases, os.path.join(args.out, f"{i}-{name}.log"), args.timeout)
        print(json.dumps(res), flush=True)
        results.append(res)
    print(json.dumps({"phases": phases, "runs": results}), flush=True)
    return 0 if all(r["rc"] == 0 for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
