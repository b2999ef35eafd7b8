"""The port's brute-force KNN index against the JAX package's, driven by the
same operations on the same data. Keys and their order must match exactly;
scores within 1e-5 (f32 sums taken in another order)."""

import os
import pickle
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.internals import keys as JK
from pathway_tpu.ops import knn as J
from pathway_tpu_torch.internals import keys as TK
from pathway_tpu_torch.ops import knn as T

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D = 16


class Both:
    """One JAX index and one port index, fed identical operations."""

    def __init__(self, metric="cos", capacity=128, d=D):
        self.j = J.BruteForceKnnIndex(d, metric=metric, capacity=capacity)
        self.t = T.BruteForceKnnIndex(d, metric=metric, capacity=capacity, device="cpu")

    def add(self, key, vec):
        self.j.add(key, vec)
        self.t.add(key, vec)

    def add_batch(self, keys, vecs):
        self.j.add_batch(keys, vecs)
        self.t.add_batch(keys, vecs)

    def add_batch_device(self, keys, vecs):
        self.j.add_batch_device(keys, jnp.asarray(vecs))
        self.t.add_batch_device(keys, torch.from_numpy(np.array(vecs)))

    def remove(self, key):
        self.j.remove(key)
        self.t.remove(key)

    def check(self, queries, k):
        ref = self.j.search(queries, k)
        out = self.t.search(queries, k)
        assert [[key for key, _ in hits] for hits in out] == [[key for key, _ in hits] for hits in ref]
        for a, b in zip(out, ref):
            np.testing.assert_allclose([s for _, s in a], [s for _, s in b], rtol=1e-5, atol=1e-5)
        assert self.t.capacity == self.j.capacity
        assert self.t.device_bytes() == self.j.device_bytes()
        return out


def _vecs(n, seed, d=D):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


@pytest.mark.parametrize("metric", ["cos", "dot", "l2sq"])
def test_search_matches_jax_through_growth(metric):
    b = Both(metric)
    vecs = _vecs(300, 1)
    b.add_batch(list(range(100)), vecs[:100])
    b.add_batch_device(list(range(100, 250)), vecs[100:250])  # grows past 128
    for i in range(250, 300):
        b.add(f"doc-{i}", vecs[i])
    q = _vecs(7, 2)
    b.check(q, 10)
    b.check(q, 1)
    assert b.t.capacity == 512
    assert len(b.t) == 300
    # a tensor query, 1-D
    out = b.t.search(torch.from_numpy(q[0]), 3)
    assert out == b.t.search(q[:1], 3)


def test_equal_scores_are_broken_by_key_tie_order():
    b = Both("dot")
    base = np.ones(D, np.float32)
    keys = [f"k{i}" for i in range(20)] + list(range(20))
    b.add_batch(keys, np.tile(base, (len(keys), 1)))
    b.add("better", 2 * base)
    out = b.check(base[None, :], 6)[0]
    assert out[0][0] == "better"
    want = sorted(keys, key=TK.tie_order)[:5]
    assert [key for key, _ in out[1:]] == want
    # the device cut alone, before host decode, already picks the canonical set
    scores, ids = b.t.search_device(base[None, :], 6)
    picked = {b.t._slot_to_key[int(i)] for i in ids[0]}
    assert picked == {"better", *want}


def test_upsert_within_one_flush_last_write_wins():
    b = Both("cos")
    v = _vecs(6, 3)
    b.add("a", v[0])
    b.add("a", v[1])  # same slot twice before a flush
    b.add_batch(["b", "c"], v[2:4])
    b.add_batch_device(["d", "d", "e"], v[3:6])  # duplicate key in one device block
    out = b.check(v[1][None, :], 5)[0]
    assert out[0][0] == "a" and abs(out[0][1] - 1.0) < 1e-6
    assert dict(b.check(v[4][None, :], 5)[0])["d"] > 0.9999


@pytest.mark.parametrize("host_first", [True, False])
def test_host_and_device_staging_land_in_staging_order(host_first):
    b = Both("cos")
    vh, vd = _vecs(2, 4)
    if host_first:
        b.add("x", vh)
        b.add_batch_device(["x"], vd[None, :])
        winner = vd
    else:
        b.add_batch_device(["x"], vh[None, :])
        b.add("x", vd)
        winner = vd
    b.add("other", vh * -1)
    out = b.check(winner[None, :], 2)[0]
    assert out[0][0] == "x" and abs(out[0][1] - 1.0) < 1e-6


def test_remove_and_readd():
    b = Both("l2sq")
    v = _vecs(10, 5)
    b.add_batch(list(range(10)), v)
    b.check(v[:3], 4)
    b.remove(3)
    b.remove(4)
    b.add(4, v[9] * 2)  # re-add in the same window: its slot must stay valid
    b.add(11, v[3])  # reuses a freed slot
    out = b.check(v[3:5], 4)
    assert 3 not in [key for hits in out for key, _ in hits]
    with pytest.raises(KeyError):
        b.t.remove("missing")
    assert len(b.t) == len(b.j) == 10


def test_pickle_round_trip_keeps_answers():
    b = Both("cos")
    v = _vecs(150, 6)
    b.add_batch(list(range(150)), v)
    b.add("late", v[0] * 3)  # still staged when pickled
    q = _vecs(4, 7)
    before = b.t.search(q, 5)
    restored = pickle.loads(pickle.dumps(b.t))
    assert restored.search(q, 5) == before
    assert restored.device_bytes() == b.j.device_bytes()
    assert torch.equal(restored._key_bits, b.t._key_bits)
    restored.add(999, v[1])
    assert restored.search(v[1][None, :], 1)[0][0][0] in (1, 999)


@pytest.mark.parametrize("metric", ["cos", "dot", "l2sq"])
def test_exact_rescore_scores_the_same_bits_as_the_resident_search(metric):
    v = _vecs(40, 8)
    keys = [f"c{i}" for i in range(40)]
    q = _vecs(3, 9)
    ix = T.BruteForceKnnIndex(D, metric=metric, device="cpu")
    ix.add_batch(keys, v)
    resident = ix.search(q, 8)
    rescored = T.exact_rescore(v, keys, q, 8, metric=metric, device="cpu")
    assert rescored == resident  # same keys, same f32 bits
    ref = J.exact_rescore(v, keys, q, 8, metric=metric)
    assert [[k for k, _ in h] for h in rescored] == [[k for k, _ in h] for h in ref]
    assert T.exact_rescore(v[:0], [], q, 8, device="cpu") == [[], [], []]


def test_k_larger_than_index_and_k_zero():
    b = Both("cos")
    b.add_batch([1, 2, 3], _vecs(3, 10))
    out = b.check(_vecs(2, 11), 200)  # k above the capacity
    assert all(len(h) == 3 for h in out)
    scores, ids = b.t.search_device(_vecs(1, 12), 0)
    assert scores.shape == (1, 0) and ids.shape == (1, 0)


@pytest.mark.parametrize(
    "key",
    [0, 7, -3, 2**63 + 5, True, None, 1.5, -0.0, "doc-1", "naïve", b"\x00bytes",
     ("a", 1), [1, 2], np.int64(42), np.float32(0.25), np.datetime64("2024-01-02"),
     np.timedelta64(5, "s")],
)
def test_tie_order_is_the_reference_tie_order(key):
    assert TK.tie_order(key) == JK.tie_order(key)


def test_tie_order_vectorized_and_salt_agree_with_reference():
    ints = np.arange(-5, 500, dtype=np.int64)
    np.testing.assert_array_equal(TK.tie_order_u64(ints), JK.tie_order_u64(ints))
    assert [TK.tie_order(int(i)) for i in ints[:20]] == [int(x) for x in TK.tie_order_u64(ints[:20])]
    code = (
        "from pathway_tpu.internals import keys as J\n"
        "from pathway_tpu_torch.internals import keys as T\n"
        "ks = [1, 'a', ('t', 2), None, 2.5]\n"
        "assert [T.tie_order(k) for k in ks] == [J.tie_order(k) for k in ks]\n"
        "assert T._HASH_SALT != 0\n"
    )
    env = dict(os.environ, PATHWAY_HASH_SALT="12345", PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("q", [1, 15, 16, 17, 64])
def test_search_is_batch_invariant(q):
    """A query's hits and score bits do not depend on the batch it is searched
    in, nor on the block size its docs were ingested in (the score product
    runs in fixed ``_Q_CHUNK``-row chunks, norms sum in one fixed order), so
    the cross-tick microbatcher changes no search result."""
    rng = np.random.default_rng(q)
    index = T.BruteForceKnnIndex(dimension=32, device="cpu")
    index.add_batch(list(range(300)), rng.normal(size=(300, 32)).astype(np.float32))
    queries = rng.normal(size=(q, 32)).astype(np.float32)
    together = index.search(queries, 10)
    alone = [index.search(queries[i : i + 1], 10)[0] for i in range(q)]
    assert together == alone
    # ingest in another block size: the stored norms, and so the scores, keep their bits
    rows = index._vectors[:300].numpy()
    stepwise = T.BruteForceKnnIndex(dimension=32, device="cpu")
    for lo in range(0, 300, 7):
        stepwise.add_batch(list(range(lo, min(lo + 7, 300))), rows[lo : lo + 7])
        stepwise._flush()
    assert stepwise.search(queries, 10) == together
    dots = T._dots(torch.from_numpy(queries), index._vectors)
    assert dots.shape == (q, index.capacity)
    np.testing.assert_allclose(dots.numpy(), queries @ index._vectors.numpy().T, rtol=1e-5, atol=1e-5)
    norms = T._row_sq_norms(torch.from_numpy(queries))
    np.testing.assert_allclose(norms.numpy(), (queries * queries).sum(-1), rtol=1e-5)


def test_scores_do_not_depend_on_index_rows():
    """A (query, row) pair scores the same bits in a brute-force index of any
    capacity and in ``exact_rescore`` over exactly the live rows (the score
    product also runs in fixed ``_N_TILE``-row tiles), so the tiered index's
    hot shard and cold rescore score rows as the brute-force index does.
    Checked by the tool that checks it on the card, at a small width."""
    from pathway_tpu_torch.tools.batch_invariance import index_rows_check

    out = index_rows_check("cpu", dim=32, capacities=(4096, 65536, 2 * 65536 + 128))
    assert len(out) == 3
    for name, (same, diff) in out.items():
        assert same, (name, diff)
    dots = T._dots(torch.ones(3, 8), torch.ones(T._N_TILE + 5, 8))
    assert dots.shape == (3, T._N_TILE + 5) and bool((dots == 8.0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_encode_is_batch_invariant(dtype):
    """A doc's embedding has the same bits in an 8-row launch as inside a
    512-row one (``ops/encoder.py::pool`` sums tokens and squares in one
    fixed order; on the H100 torch's ``norm`` rounded an 8-row launch
    differently), so the cross-tick microbatcher changes no embedding."""
    from pathway_tpu_torch.ops import encoder as TE

    cfg = TE.EncoderConfig(vocab_size=1024, d_model=128, n_heads=2, n_layers=2, d_ff=256, max_len=32, dtype=dtype)
    params = TE.init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(8)
    mask = torch.from_numpy(np.arange(32)[None, :] < rng.integers(1, 33, size=512)[:, None])
    ids = torch.from_numpy(rng.integers(3, 1024, size=(512, 32))).masked_fill(~mask, 0)
    together = TE.encode(params, cfg, ids, mask)
    parts = torch.cat([TE.encode(params, cfg, ids[i : i + 8], mask[i : i + 8]) for i in range(0, 512, 8)])
    assert torch.equal(together.view(torch.int32), parts.view(torch.int32))
