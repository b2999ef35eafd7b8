"""The live-RAG loop as a Pathway pipeline (``pathway_tpu_torch/tools/
rag_pipeline.py``: docs stream → embedder UDF → KNN index → as-of-now
queries → flatten → cross-encoder rerank) on both packages at a small width,
the port on converted copies of the JAX package's weights.

f32: the same rows under the same keys, hits in the same order, KNN and rerank
scores within 1e-5. bf16 (the chip's type): each query, the text of a doc,
finds its doc at rank 1 in both packages, and the rerank scores of the pairs
both packages found agree within 1e-2 (the encoder's bf16 tolerance).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pathway_tpu
import pathway_tpu_torch
from pathway_tpu.debug import _capture as capture_ref
from pathway_tpu.ops.encoder import EncoderConfig as JConfig
from pathway_tpu.stdlib.indexing import BruteForceKnnFactory as JFactory
from pathway_tpu.xpacks.llm.embedders import SentenceTransformerEmbedder as JEmbedder
from pathway_tpu.xpacks.llm.rerankers import CrossEncoderReranker as JReranker
from pathway_tpu_torch import convert
from pathway_tpu_torch.debug import _capture as capture_port
from pathway_tpu_torch.ops.encoder import EncoderConfig as TConfig
from pathway_tpu_torch.stdlib.indexing import BruteForceKnnFactory as TFactory
from pathway_tpu_torch.tools import rag_pipeline
from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder as TEmbedder
from pathway_tpu_torch.xpacks.llm.rerankers import CrossEncoderReranker as TReranker

SMALL = dict(vocab_size=1024, d_model=128, n_heads=2, n_layers=2, d_ff=256, max_len=64)
N_DOCS, N_QUERIES, TICK_ROWS, K = 256, 24, 16, 10


def synth_docs(n, words=40, seed=0):
    rng = np.random.default_rng(seed)
    vocab = [f"word{i}" for i in range(300)]
    return [" ".join(rng.choice(vocab, size=words)) for _ in range(n)]


@pytest.fixture(autouse=True)
def _pipeline_env(monkeypatch):
    # full 64-row launches only, with the flush deadline past the run: 256
    # docs flush in four whole chunks as they arrive, so every doc is indexed
    # before the first query tick, whatever the host's speed
    monkeypatch.setenv("PATHWAY_MICROBATCH", "auto")
    monkeypatch.setenv("PATHWAY_MICROBATCH_MAX_BATCH", "64")
    monkeypatch.setenv("PATHWAY_MICROBATCH_FLUSH_MS", "60000")
    pathway_tpu_torch.G.clear()
    yield
    pathway_tpu_torch.G.clear()


def _to_torch(params):
    return convert.params_from_numpy(jax.tree.map(np.asarray, params), "cpu")


def run_both(dtype: str):
    docs = synth_docs(N_DOCS)
    queries = docs[:N_QUERIES]
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    pathway_tpu.G.clear()
    j_emb = JEmbedder(JConfig(**SMALL, dtype=jdt), seed=0)
    j_rr = JReranker(JConfig(**SMALL, dtype=jdt), seed=1)
    ref = capture_ref(
        rag_pipeline.build(
            pathway_tpu, embedder=j_emb, index_factory=JFactory(embedder=j_emb), reranker=j_rr,
            docs=docs, queries=queries, tick_rows=TICK_ROWS, k=K,
        )
    ).rows
    pathway_tpu.G.clear()

    pathway_tpu_torch.G.clear()
    t_emb = TEmbedder(TConfig(**SMALL, dtype=tdt), params=_to_torch(j_emb._encoder.params), device="cpu")
    t_rr = TReranker(TConfig(**SMALL, dtype=tdt), params=_to_torch(j_rr._model.params), device="cpu")
    got = capture_port(
        rag_pipeline.build(
            pathway_tpu_torch, embedder=t_emb,
            index_factory=TFactory(embedder=t_emb, device="cpu"), reranker=t_rr,
            docs=docs, queries=queries, tick_rows=TICK_ROWS, k=K,
        )
    ).rows
    return ref, got


def test_pipeline_f32_matches_reference():
    ref, got = run_both("float32")
    assert set(got) == set(ref), "row keys differ"
    assert len(got) == N_QUERIES * K
    r, g = rag_pipeline.hits_by_query(ref.values()), rag_pipeline.hits_by_query(got.values())
    assert sorted(g) == list(range(N_QUERIES))
    for qi in r:
        assert [h[:2] for h in g[qi]] == [h[:2] for h in r[qi]], f"query {qi}: hit keys or order differ"
        np.testing.assert_allclose([h[2] for h in g[qi]], [h[2] for h in r[qi]], rtol=0, atol=1e-5)
        np.testing.assert_allclose([h[3] for h in g[qi]], [h[3] for h in r[qi]], rtol=0, atol=1e-5)
        assert g[qi][0][1] == qi, "a query did not find its own doc first"


def test_pipeline_bf16_self_retrieval_and_rerank():
    ref, got = run_both("bfloat16")
    r, g = rag_pipeline.hits_by_query(ref.values()), rag_pipeline.hits_by_query(got.values())
    assert sorted(g) == sorted(r) == list(range(N_QUERIES))
    compared = 0
    for qi in r:
        assert g[qi][0][1] == r[qi][0][1] == qi, f"query {qi}: own doc not at rank 1"
        ref_rr = {h[0]: h[3] for h in r[qi]}
        for dkey, _di, _knn, score in g[qi]:
            assert np.isfinite(score)
            if dkey in ref_rr:
                assert abs(score - ref_rr[dkey]) <= 1e-2, (qi, dkey, score, ref_rr[dkey])
                compared += 1
    assert compared >= N_QUERIES * K // 2
