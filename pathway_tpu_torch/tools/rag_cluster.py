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
"""

from __future__ import annotations

import argparse
import os
import sys

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
    args = ap.parse_args(argv)

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.ops import attention_kernel as A
    from pathway_tpu_torch.stdlib.indexing import BruteForceKnnFactory
    from pathway_tpu_torch.tools import rag_pipeline

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
