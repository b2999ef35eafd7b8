"""A rescale whose restore replays a whole live-RAG stream, on both packages.

Session 1 runs ``tools/rag_pipeline.py``'s loop (a timed stream of docs,
then queries; embedder, KNN index, as-of-now queries, rerank) on 2 workers
under operator persistence in a memory store, to the end of its stream.
Session 2 runs the same graph on 3 workers from that store: the index cannot
migrate, so the restore reshards by replay, and the replay puts every logged
doc and query into its first tick. Each session's answers are the net
``(query, rank, doc) -> (knn, rerank)`` rows its subscriber saw.

    JAX_PLATFORMS=cpu python tests/torch_replay_probe.py --repeat 6 [--flush-ms MS]

prints, per trial and package, the answers the replay lost and added
against the uninterrupted session and the queries left without a hit.
``--flush-ms`` sets ``PATHWAY_MICROBATCH_FLUSH_MS`` (unset: the default
deadline, the autocommit period). ``tests/test_torch_elastic_replay.py``
holds the two packages to each other on the same inputs.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

SMALL = dict(vocab_size=1024, d_model=64, n_heads=2, n_layers=1, d_ff=128, max_len=64)
N_DOCS, N_QUERIES, TICK_ROWS, K = 1024, 128, 64, 5


def synth_docs(n: int, words: int = 40, seed: int = 0) -> list[str]:
    rng = np.random.default_rng(seed)
    vocab = [f"word{i}" for i in range(300)]
    return [" ".join(rng.choice(vocab, size=words)) for _ in range(n)]


def models():
    """The reference's embedder and reranker (seeds 0 and 1) and the port's
    on converted copies of their weights, f32: ``{"ref": (emb, rr, factory),
    "port": ...}``."""
    import jax
    import jax.numpy as jnp
    import torch

    from pathway_tpu.ops.encoder import EncoderConfig as JConfig
    from pathway_tpu.stdlib.indexing import BruteForceKnnFactory as JFactory
    from pathway_tpu.xpacks.llm.embedders import SentenceTransformerEmbedder as JEmbedder
    from pathway_tpu.xpacks.llm.rerankers import CrossEncoderReranker as JReranker
    from pathway_tpu_torch import convert
    from pathway_tpu_torch.ops.encoder import EncoderConfig as TConfig
    from pathway_tpu_torch.stdlib.indexing import BruteForceKnnFactory as TFactory
    from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder as TEmbedder
    from pathway_tpu_torch.xpacks.llm.rerankers import CrossEncoderReranker as TReranker

    jcfg, tcfg = JConfig(**SMALL, dtype=jnp.float32), TConfig(**SMALL, dtype=torch.float32)
    j_emb, j_rr = JEmbedder(jcfg, seed=0), JReranker(jcfg, seed=1)

    def to_torch(params):
        return convert.params_from_numpy(jax.tree.map(np.asarray, params), "cpu")

    t_emb = TEmbedder(tcfg, params=to_torch(j_emb._encoder.params), device="cpu")
    t_rr = TReranker(tcfg, params=to_torch(j_rr._model.params), device="cpu")
    return {
        "ref": (j_emb, j_rr, JFactory),
        "port": (t_emb, t_rr, lambda embedder: TFactory(embedder=embedder, device="cpu")),
    }


def session(pw, emb, rr, factory, n_workers: int, root: str, docs: list[str]) -> dict:
    """One run of the loop on ``n_workers`` from the memory store ``root``;
    its net answers."""
    from pathway_tpu_torch.tools import rag_pipeline

    pw.G.clear()
    table = rag_pipeline.build(pw, embedder=emb, index_factory=factory(embedder=emb), reranker=rr, docs=docs,
                               queries=docs[:N_QUERIES], tick_rows=TICK_ROWS, k=K)
    net: dict = {}

    def on_change(key, row, time, is_addition):
        k = (row["qi"], row["rank"], row["di"])
        n, _scores = net.get(k, (0, None))
        net[k] = (n + (1 if is_addition else -1), (row["knn"], row["rerank"]))

    pw.io.subscribe(table, on_change=on_change)
    pw.run(monitoring_level="none", n_workers=n_workers, persistence_config=pw.persistence.Config(
        backend=pw.persistence.Backend("memory", root), persistence_mode="operator_persisting"))
    pw.G.clear()
    return {k: scores for k, (n, scores) in net.items() if n}


def rescale(pw, emb, rr, factory, root: str) -> tuple[dict, dict]:
    """(the uninterrupted 2-worker answers, the answers after the replay on
    3 workers), with ``PATHWAY_ELASTIC=manual`` (the caller sets it)."""
    pw.persistence.backends.MemoryBackend.clear(root)
    docs = synth_docs(N_DOCS)
    try:
        return session(pw, emb, rr, factory, 2, root, docs), session(pw, emb, rr, factory, 3, root, docs)
    finally:
        pw.persistence.backends.MemoryBackend.clear(root)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeat", type=int, default=3)
    ap.add_argument("--flush-ms", default=None)
    args = ap.parse_args(argv)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.environ["PATHWAY_ELASTIC"] = "manual"
    os.environ["PATHWAY_MICROBATCH"] = "auto"
    if args.flush_ms is not None:
        os.environ["PATHWAY_MICROBATCH_FLUSH_MS"] = args.flush_ms
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import pathway_tpu
    import pathway_tpu_torch

    pkgs = {"ref": pathway_tpu, "port": pathway_tpu_torch}
    for trial in range(args.repeat):
        for name, (emb, rr, factory) in models().items():
            whole, replayed = rescale(pkgs[name], emb, rr, factory, f"replay-probe-{name}")
            print(f"trial {trial} {name}: answers {len(whole)} -> {len(replayed)}, lost "
                  f"{len(set(whole) - set(replayed))}, added {len(set(replayed) - set(whole))}, queries without "
                  f"a hit {N_QUERIES - len({k[0] for k in replayed})}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
