"""The port's sharded KNN search (``ops/knn.py::sharded_search`` and
``ShardedBruteForceKnnIndex``) against the port's single index and the
reference's sharded search (``pathway_tpu/ops/knn.py``, ``shard_map`` over
the 8-device virtual CPU mesh).

Corpora carry blocks of identical rows, so equal scores straddle the k
boundary. Within the port, a sharded search at 2, 4 and 8 logical shards
must equal the single index exactly: keys, their order, and score bits.
Against the reference: the same keys in the same order, scores within
rtol = atol = 1e-6 (the port scores with torch f32 products, the reference
with XLA's; an L2SQ score near 16 has an f32 step of 1.9e-6).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from pathway_tpu.ops import knn as ref_knn  # noqa: E402
from pathway_tpu_torch.ops import knn as port_knn  # noqa: E402
from pathway_tpu_torch.parallel.mesh import device_mesh  # noqa: E402


def _ref_mesh(n):
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:n]), ("data",))


def _corpus(seed, n, d, tied=(20, 60)):
    rng = np.random.default_rng(seed)
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    lo, hi = tied
    vecs[lo:hi] = vecs[lo]  # a block of identical rows: ties at the k boundary
    qs = rng.normal(size=(9, d)).astype(np.float32)
    qs[0] = vecs[lo]  # a query hitting the tied block head-on
    qs[1] = -vecs[lo]
    keys = [int(x) for x in rng.integers(0, 2**62, n)]
    return keys, vecs, qs


def _port_single(keys, vecs, metric, capacity):
    ix = port_knn.BruteForceKnnIndex(vecs.shape[1], metric=metric, capacity=capacity, device="cpu")
    ix.add_batch(keys, vecs)
    return ix


def _port_sharded(keys, vecs, metric, capacity, n_shards):
    ix = port_knn.ShardedBruteForceKnnIndex(
        vecs.shape[1], device_mesh(n_shards=n_shards), metric=metric, capacity=capacity
    )
    ix.add_batch(keys, vecs)
    return ix


def _bits(hits):
    return [[(k, np.float32(s).view(np.uint32).item()) for k, s in row] for row in hits]


@pytest.mark.parametrize("metric", ["cos", "l2sq", "dot"])
@pytest.mark.parametrize("n_shards", [2, 4, 8])
@pytest.mark.parametrize("k", [1, 5, 40])
def test_sharded_equals_single_index(metric, n_shards, k):
    keys, vecs, qs = _corpus(0, 300, 16)
    single = _port_single(keys, vecs, metric, 1024)
    sharded = _port_sharded(keys, vecs, metric, 1024, n_shards)
    assert _bits(sharded.search(qs, k)) == _bits(single.search(qs, k))


@pytest.mark.parametrize("metric", ["cos", "l2sq"])
@pytest.mark.parametrize("n_shards", [4, 8])
def test_sharded_equals_reference(metric, n_shards):
    keys, vecs, qs = _corpus(1, 500, 16, tied=(100, 180))
    ref = ref_knn.ShardedBruteForceKnnIndex(16, _ref_mesh(n_shards), metric=metric, capacity=1024)
    ref.add_batch(keys, vecs)
    port = _port_sharded(keys, vecs, metric, 1024, n_shards)
    for k in (3, 10, 90):
        want = ref.search(qs, k)
        got = port.search(qs, k)
        assert [[kk for kk, _ in row] for row in got] == [[kk for kk, _ in row] for row in want]
        for g, w in zip(got, want):
            np.testing.assert_allclose([s for _, s in g], [s for _, s in w], rtol=1e-6, atol=1e-6)


def test_sharded_search_function_equals_reference():
    """``sharded_search`` on raw tensors: global slot ids and scores against
    the reference's function on the same matrix, with k above a shard's row
    count (k_local = shard_n). Both functions leave the order among the
    selected rows to top-k (the index's decode sorts them canonically), so
    each query's selected slot ids must be the same set and its scores, in
    slot order, equal within 1e-6."""
    n_shards, n, d = 4, 64, 8
    keys, vecs, qs = _corpus(2, n, d, tied=(8, 40))
    bits = port_knn._key_bits_of(keys)
    nsq = (vecs.astype(np.float32) ** 2).sum(1)
    valid = np.ones(n, dtype=bool)
    valid[::9] = False
    qn = qs / np.linalg.norm(qs, axis=1, keepdims=True)
    import jax.numpy as jnp

    for k in (4, 20):
        rs, rg = ref_knn.sharded_search(
            _ref_mesh(n_shards), "data", jnp.asarray(vecs), jnp.asarray(nsq), jnp.asarray(valid),
            jnp.asarray(bits), jnp.asarray(qn), k=k, metric="cos",
        )
        ps, pg = port_knn.sharded_search(
            device_mesh(n_shards=n_shards), "data", torch.from_numpy(vecs),
            port_knn._row_sq_norms(torch.from_numpy(vecs)), torch.from_numpy(valid),
            port_knn._bits_tensor(bits, "cpu"), torch.from_numpy(qn), k=k, metric="cos",
        )
        assert ps.shape == (len(qs), k)
        pg, rg, ps, rs = pg.numpy(), np.asarray(rg), ps.numpy(), np.asarray(rs)
        for qi in range(len(qs)):
            assert sorted(pg[qi].tolist()) == sorted(rg[qi].tolist())
            np.testing.assert_allclose(
                ps[qi][np.argsort(pg[qi])], rs[qi][np.argsort(rg[qi])], rtol=0, atol=1e-6
            )


def test_sharded_index_tracks_removes_and_growth():
    keys, vecs, qs = _corpus(3, 400, 16)
    single = _port_single(keys[:100], vecs[:100], "cos", 128)
    sharded = _port_sharded(keys[:100], vecs[:100], "cos", 128, 4)
    for ix in (single, sharded):
        ix.add_batch(keys[100:], vecs[100:])  # grows past the first capacity
        for key in keys[20:30] + keys[300:310]:
            ix.remove(key)
    assert sharded.capacity == single.capacity
    assert _bits(sharded.search(qs, 25)) == _bits(single.search(qs, 25))
