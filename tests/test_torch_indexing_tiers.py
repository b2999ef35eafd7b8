"""The index family of the port (``pathway_tpu_torch/stdlib/indexing``: IVF-flat,
tiered, LSH, BM25, hybrid, usearch and their factories) against the JAX
package's, fed the same seeded inputs, at a small width. The port's device is
the CPU.

- IVF-flat, LSH and BM25 are numpy / Python on both sides: keys and scores
  exact.
- Tiered (hot shard on the device, IVF cold tier): keys exact, scores within
  rtol = atol = 1e-6 of the reference (two frameworks' f32 products); within
  the port, tiered == brute force bit for bit, keys and scores.
- The RAG pipeline of ``tools/rag_pipeline.py`` with the tiered, IVF-flat and
  hybrid factories: the same rows in the same order, scores within the
  1e-5 of ``tests/test_torch_rag_pipeline.py``.
"""

from __future__ import annotations

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pathway_tpu
import pathway_tpu.stdlib.indexing as JI
import pathway_tpu_torch
import pathway_tpu_torch.stdlib.indexing as TI
from pathway_tpu.debug import _capture as capture_ref
from pathway_tpu.ops.encoder import EncoderConfig as JConfig
from pathway_tpu.stdlib.indexing._engine import BM25Backend as JBM25
from pathway_tpu.stdlib.indexing._engine import LshVectorBackend as JLsh
from pathway_tpu.stdlib.indexing.ivf import IvfFlatBackend as JIvf
from pathway_tpu.xpacks.llm.embedders import SentenceTransformerEmbedder as JEmbedder
from pathway_tpu.xpacks.llm.rerankers import CrossEncoderReranker as JReranker
from pathway_tpu_torch import convert
from pathway_tpu_torch.debug import _capture as capture_port
from pathway_tpu_torch.ops.encoder import EncoderConfig as TConfig
from pathway_tpu_torch.stdlib.indexing._engine import BM25Backend as TBM25
from pathway_tpu_torch.stdlib.indexing._engine import LshVectorBackend as TLsh
from pathway_tpu_torch.stdlib.indexing._engine import VectorBackend
from pathway_tpu_torch.stdlib.indexing.ivf import IvfFlatBackend as TIvf
from pathway_tpu_torch.tools import rag_pipeline
from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder as TEmbedder
from pathway_tpu_torch.xpacks.llm.rerankers import CrossEncoderReranker as TReranker

D = 32
ALWAYS = lambda md: True  # noqa: E731


def _clustered(n, seed, d=D, n_centers=24):
    """The corpus shape of ``benchmarks/knn_bench.py::make_corpus``."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_centers, d)).astype(np.float32)
    return (centers[rng.integers(0, n_centers, n)] + 0.15 * rng.normal(size=(n, d))).astype(np.float32)


def _search(backend, qs, k, flt=ALWAYS):
    return backend.search(list(qs), [k] * len(qs), [flt] * len(qs))


def _keys(hits):
    return [[key for key, _ in h] for h in hits]


def _assert_close(got, want, tol=1e-6):
    assert _keys(got) == _keys(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w], rtol=tol, atol=tol)


def test_all_equals_the_reference():
    assert sorted(TI.__all__) == sorted(JI.__all__)
    for name in TI.__all__:
        assert hasattr(TI, name), name


# ------------------------------------------------------------------ IVF-flat


@pytest.mark.parametrize("metric", ["cos", "l2sq", "dot"])
def test_ivf_flat_matches_reference_exactly(metric):
    """Same seed, same adds, removes and re-adds: the same k-means, lists,
    CSR tail and answers, keys and scores exact — untrained (exact scan),
    trained, and after churn and a retrain."""
    corpus = _clustered(2048, seed=1)
    j = JIvf(dimension=D, metric=metric, min_train=512, seed=3)
    t = TIvf(dimension=D, metric=metric, min_train=512, seed=3)
    qs = _clustered(24, seed=2)
    for i in range(400):
        j.add(i, corpus[i], {"i": i})
        t.add(i, corpus[i], {"i": i})
    assert _search(t, qs, 10) == _search(j, qs, 10)  # exact below min_train
    for i in range(400, 1600):
        j.add(i, corpus[i], {"i": i})
        t.add(i, corpus[i], {"i": i})
    assert _search(t, qs, 10) == _search(j, qs, 10)  # trained
    np.testing.assert_array_equal(t._centroids, j._centroids)
    for i in range(0, 1600, 7):  # churn: masked CSR rows and the exact tail
        j.remove(i)
        t.remove(i)
    for i in range(1600, 2048):
        j.add(i, corpus[i], {"i": i})
        t.add(i, corpus[i], {"i": i})
    even = lambda md: md["i"] % 2 == 0  # noqa: E731
    assert _search(t, qs, 10, even) == _search(j, qs, 10, even)
    for i in range(2048, 3600):  # doubling past the training size retrains
        v = corpus[i % 2048] + np.float32(0.01)
        j.add(i, v, {"i": i})
        t.add(i, v, {"i": i})
    assert _search(t, qs, 10) == _search(j, qs, 10)
    assert t._trained_at == j._trained_at > 1600


# ------------------------------------------------------------------ tiered


def _tiered_pair(n, hot, metric="cos", min_train=10**9, promote_hits=None, seed=0):
    corpus = _clustered(n, seed=seed)
    j = JI.TieredKnnBackend(
        dimension=D, metric=metric, hot_rows=hot, min_train=min_train, promote_hits=promote_hits
    )
    t = TI.TieredKnnBackend(
        dimension=D, metric=metric, hot_rows=hot, min_train=min_train,
        promote_hits=promote_hits, device="cpu",
    )
    brute = VectorBackend(dimension=D, metric=metric, reserved_space=n, device="cpu")
    for i, v in enumerate(corpus):
        meta = {"par": i % 2}
        j.add(i, v, meta)
        t.add(i, v, meta)
        brute.add(i, v, meta)
    return j, t, brute


@pytest.mark.parametrize("metric", ["cos", "l2sq", "dot"])
def test_tiered_at_4x_hot_bound_matches_reference_and_brute_force(metric):
    """Corpus 4x the hot bound, cold tier exact: keys equal the reference's,
    scores within 1e-6; the port's tiered answers equal its brute-force
    index's bit for bit, before and after three maintenance passes."""
    n, hot = 1024, 256
    j, t, brute = _tiered_pair(n, hot, metric)
    assert len(t.hot) == hot and t.hot.capacity == j.hot.capacity
    qs = _clustered(32, seed=9) + np.float32(0.05)
    want = _search(brute, qs, 10)
    got = _search(t, qs, 10)
    assert got == want
    _assert_close(got, _search(j, qs, 10))
    for _ in range(3):
        t.maintain()
        j.maintain()
        got = _search(t, qs, 10)
        assert got == want
        _assert_close(got, _search(j, qs, 10))
    assert t.stats() == j.stats()


def test_tiered_promotion_counters_match_reference():
    """The same query sequence promotes, demotes and counts hits as the
    reference does."""
    j, t, _ = _tiered_pair(600, 100, promote_hits=2, seed=5)
    qs = _clustered(16, seed=6)
    for backend in (j, t):
        _search(backend, qs, 8)
        _search(backend, qs, 8)
        backend.maintain()
        _search(backend, qs, 8)
    s, r = t.stats(), j.stats()
    assert s["promotions_total"] > 0 and s["demotions_total"] > 0
    assert s == r
    assert set(t.hot._key_to_slot) == set(j.hot._key_to_slot)
    assert TI.tier_stats()["backends"] >= 1


def test_tiered_with_trained_cold_tier_matches_reference():
    """A trained IVF cold tier (approximate candidates, the same on both
    sides): keys equal the reference's, scores within 1e-6."""
    j, t, _ = _tiered_pair(2048, 512, min_train=256, seed=11)
    qs = _clustered(24, seed=12)
    _assert_close(_search(t, qs, 10), _search(j, qs, 10))
    t.maintain()
    j.maintain()
    _assert_close(_search(t, qs, 10), _search(j, qs, 10))
    assert t.stats() == j.stats()


def test_tiered_filters_remove_upsert_and_pickle():
    n, hot = 200, 50
    j, t, brute = _tiered_pair(n, hot, seed=7)
    qs = _clustered(4, seed=8)
    even = lambda md: md["par"] == 0  # noqa: E731
    got = _search(t, qs, 6, even)
    assert got == _search(brute, qs, 6, even)
    _assert_close(got, _search(j, qs, 6, even))
    assert all(k % 2 == 0 for hits in got for k, _ in hits)
    t.remove(10**9)  # unknown key: a no-op
    hot_key = next(iter(t.hot._key_to_slot))
    cold_key = next(k for k in range(n) if k not in t.hot._key_to_slot)
    for backend in (t, brute):
        backend.remove(hot_key)
        backend.remove(cold_key)
    seen = {k for hits in _search(t, qs, n) for k, _ in hits}
    assert hot_key not in seen and cold_key not in seen
    assert _search(t, qs, 10) == _search(brute, qs, 10)

    up = TI.TieredKnnBackend(dimension=D, hot_rows=4, min_train=10**9, device="cpu")
    v1 = np.ones(D, np.float32)
    up.add(1, v1, {"v": 1})
    up.add(1, -v1, {"v": 2})  # upsert
    assert up.search([-v1], [1], [ALWAYS])[0][0][0] == 1
    assert up.cold.metadata[1] == {"v": 2} and len(up) == 1

    back = pickle.loads(pickle.dumps(t))
    assert _search(back, qs, 10) == _search(t, qs, 10)
    assert back.stats()["hot_rows"] == t.stats()["hot_rows"]
    assert back.hot.device == t.hot.device


# ------------------------------------------------------------- LSH and BM25


@pytest.mark.parametrize("metric", ["cos", "l2sq"])
def test_lsh_matches_reference_exactly(metric):
    corpus = _clustered(800, seed=13)
    j = JLsh(dimension=D, metric=metric, n_or=6, n_and=4, bucket_length=2.0)
    t = TLsh(dimension=D, metric=metric, n_or=6, n_and=4, bucket_length=2.0)
    for i, v in enumerate(corpus):
        j.add(i, v, i)
        t.add(i, v, i)
    for i in range(0, 800, 5):
        j.remove(i)
        t.remove(i)
    qs = corpus[1::40] + np.float32(0.02)
    got = _search(t, qs, 10)
    assert got == _search(j, qs, 10)
    assert sum(len(h) for h in got) > 0
    with pytest.raises(ValueError, match="dot"):
        TLsh(dimension=D, metric="dot")


def test_bm25_matches_reference_exactly():
    rng = np.random.default_rng(14)
    vocab = [f"w{i}" for i in range(60)]
    docs = [" ".join(rng.choice(vocab, size=int(rng.integers(3, 30)))) for _ in range(300)]
    j, t = JBM25(), TBM25()
    for i, d in enumerate(docs):
        j.add(i, d, {"i": i})
        t.add(i, d, {"i": i})
    for i in range(0, 300, 9):
        j.remove(i)
        t.remove(i)
    queries = [" ".join(rng.choice(vocab, size=3)) for _ in range(20)]
    odd = lambda md: md["i"] % 2 == 1  # noqa: E731
    for flt in (ALWAYS, odd):
        got = t.search(queries, [8] * 20, [flt] * 20)
        assert got == j.search(queries, [8] * 20, [flt] * 20)
    assert TBM25.shardable is False


def test_usearch_routes_to_ivf_and_factories_build_their_backends():
    t = pathway_tpu_torch.debug.table_from_rows(
        pathway_tpu_torch.schema_from_types(v=list), [([0.0] * D,)]
    )
    built = {
        "usearch": TI.UsearchKnnFactory(dimensions=D),
        "ivf": TI.IvfFlatKnnFactory(dimensions=D, min_train=64),
        "lsh": TI.LshKnnFactory(dimensions=D),
        "tiered": TI.TieredKnnFactory(dimensions=D, hot_rows=16, device="cpu"),
        "brute": TI.BruteForceKnnFactory(dimensions=D, device="cpu"),
        "bm25": TI.TantivyBM25Factory(),
    }
    kinds = {}
    for name, factory in built.items():
        index = factory.build_index(t.v, t)
        kinds[name] = type(index.inner_index.backend_factory()).__name__
    assert kinds == {
        "usearch": "IvfFlatBackend", "ivf": "IvfFlatBackend", "lsh": "LshVectorBackend",
        "tiered": "TieredKnnBackend", "brute": "VectorBackend", "bm25": "BM25Backend",
    }
    assert isinstance(TI.UsearchKnnFactory(dimensions=D).build_index(t.v, t).inner_index, TI.IvfFlatKnn)
    pathway_tpu_torch.G.clear()


# ------------------------------------------------------------ RAG pipelines

SMALL = dict(vocab_size=1024, d_model=128, n_heads=2, n_layers=2, d_ff=256, max_len=64)
N_DOCS, N_QUERIES, TICK_ROWS, K = 256, 24, 16, 10


def _synth_docs(n, words=40, seed=0):
    rng = np.random.default_rng(seed)
    vocab = [f"word{i}" for i in range(300)]
    return [" ".join(rng.choice(vocab, size=words)) for _ in range(n)]


@pytest.fixture
def pipeline_env(monkeypatch):
    # full 64-row launches with the flush deadline past the run: every doc is
    # indexed before the first query tick (tests/test_torch_rag_pipeline.py)
    monkeypatch.setenv("PATHWAY_MICROBATCH", "auto")
    monkeypatch.setenv("PATHWAY_MICROBATCH_MAX_BATCH", "64")
    monkeypatch.setenv("PATHWAY_MICROBATCH_FLUSH_MS", "60000")
    pathway_tpu.G.clear()
    pathway_tpu_torch.G.clear()
    yield
    pathway_tpu.G.clear()
    pathway_tpu_torch.G.clear()


def _factories(pkg, emb, port: bool):
    dev = {"device": "cpu"} if port else {}
    return {
        # 4x the hot bound, the cold tier in its exact regime (256 < min_train)
        "tiered": pkg.TieredKnnFactory(embedder=emb, hot_rows=N_DOCS // 4, **dev),
        "ivf": pkg.IvfFlatKnnFactory(embedder=emb),
        "hybrid": pkg.HybridIndexFactory(
            retriever_factories=[pkg.TantivyBM25Factory(), pkg.BruteForceKnnFactory(embedder=emb, **dev)]
        ),
    }


@pytest.mark.parametrize("kind", ["tiered", "ivf", "hybrid"])
def test_rag_pipeline_matches_reference(kind, pipeline_env):
    """The live-RAG pipeline through ``pw.run`` on both packages (the port on
    converted copies of the reference's f32 weights): the same rows under the
    same keys, hits in the same order, KNN (or RRF) and rerank scores within
    1e-5; each query finds its own doc first."""
    docs = _synth_docs(N_DOCS)
    queries = docs[:N_QUERIES]
    j_emb = JEmbedder(JConfig(**SMALL, dtype=jnp.float32), seed=0)
    j_rr = JReranker(JConfig(**SMALL, dtype=jnp.float32), seed=1)
    ref = capture_ref(
        rag_pipeline.build(
            pathway_tpu, embedder=j_emb, index_factory=_factories(JI, j_emb, False)[kind],
            reranker=j_rr, docs=docs, queries=queries, tick_rows=TICK_ROWS, k=K,
        )
    ).rows
    pathway_tpu.G.clear()

    def to_torch(params):
        return convert.params_from_numpy(jax.tree.map(np.asarray, params), "cpu")

    t_emb = TEmbedder(TConfig(**SMALL, dtype=torch.float32), params=to_torch(j_emb._encoder.params), device="cpu")
    t_rr = TReranker(TConfig(**SMALL, dtype=torch.float32), params=to_torch(j_rr._model.params), device="cpu")
    got = capture_port(
        rag_pipeline.build(
            pathway_tpu_torch, embedder=t_emb, index_factory=_factories(TI, t_emb, True)[kind],
            reranker=t_rr, docs=docs, queries=queries, tick_rows=TICK_ROWS, k=K,
        )
    ).rows
    assert set(got) == set(ref), "row keys differ"
    assert len(got) == N_QUERIES * K
    r, g = rag_pipeline.hits_by_query(ref.values()), rag_pipeline.hits_by_query(got.values())
    assert sorted(g) == sorted(r) == list(range(N_QUERIES))
    for qi in r:
        assert [h[:2] for h in g[qi]] == [h[:2] for h in r[qi]], f"query {qi}: hit keys or order differ"
        np.testing.assert_allclose([h[2] for h in g[qi]], [h[2] for h in r[qi]], rtol=0, atol=1e-5)
        np.testing.assert_allclose([h[3] for h in g[qi]], [h[3] for h in r[qi]], rtol=0, atol=1e-5)
        assert g[qi][0][1] == qi, "a query did not find its own doc first"
