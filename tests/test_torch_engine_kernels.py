"""``engine/torch_kernels.py``: the grouped segment-sum and the sorted probe as
torch ops, held against the numpy path bit for bit on the CPU, and the
routing knobs (``PATHWAY_ENGINE_JAX``, ``_MIN_ROWS``, ``probe_eligible``,
``PATHWAY_FUSE_JAX``)."""

from __future__ import annotations

import numpy as np
import pytest

import pathway_tpu_torch as pw
from pathway_tpu_torch.engine import torch_kernels as K

_HIGH = np.uint64(1 << 63)


def _keys(rng, n, distinct):
    """uint64 keys drawn from ``distinct`` values, half of them >= 2^63 (the
    sign trap of an int64 sort)."""
    pool = rng.integers(0, 2**63, distinct, dtype=np.uint64)
    pool[::2] |= _HIGH
    pool[0] = np.uint64(2**64 - 1)
    pool[-1] = _HIGH
    return pool[rng.integers(0, distinct, n)]


def _assert_grouped_equal(got, want, exact_sums=True):
    for g, w in zip(got[:4], want[:4]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert len(got[4]) == len(want[4])
    for g, w in zip(got[4], want[4]):
        assert g.dtype == w.dtype
        if exact_sums:
            np.testing.assert_array_equal(g, w)
        else:
            # float sums match to accumulation order only
            np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-9)


@pytest.fixture
def on_cpu(monkeypatch):
    monkeypatch.setenv("PATHWAY_ENGINE_JAX", "cpu")
    K.ROUTES.clear()


@pytest.mark.parametrize("n,distinct", [(1, 1), (7, 3), (1000, 10), (5000, 4000)])
def test_grouped_matches_numpy(on_cpu, n, distinct):
    rng = np.random.default_rng(n)
    keys = _keys(rng, n, distinct)
    diffs = rng.choice(np.array([-1, 1, 2], dtype=np.int64), n)
    ints = rng.integers(-(2**40), 2**40, n)
    floats = rng.normal(size=n)
    got = K.grouped_sums(keys, diffs, [ints])
    want = K.numpy_grouped_sums(keys, diffs, [ints])
    _assert_grouped_equal(got, want)
    assert (got[2][1:] > got[2][:-1]).all(), "groups not in uint64 order"
    got_f = K.grouped_sums(keys, diffs, [floats])
    _assert_grouped_equal(got_f, K.numpy_grouped_sums(keys, diffs, [floats]), exact_sums=False)
    assert K.ROUTES == {"grouped/cpu": 2}


def test_grouped_equal_keys_keep_arrival_order(on_cpu):
    keys = np.array([2**63 + 1, 5, 2**63 + 1, 5, 5, 2**63 + 1], dtype=np.uint64)
    diffs = np.ones(6, dtype=np.int64)
    order, starts, u_gk, counts, _ = K.grouped_sums(keys, diffs, [])
    np.testing.assert_array_equal(order, [1, 3, 4, 0, 2, 5])
    np.testing.assert_array_equal(starts, [0, 3])
    np.testing.assert_array_equal(u_gk, np.array([5, 2**63 + 1], dtype=np.uint64))
    np.testing.assert_array_equal(counts, [3, 3])


def test_grouped_empty(on_cpu):
    e = np.empty(0, dtype=np.uint64)
    got = K.grouped_sums(e, np.empty(0, dtype=np.int64), [np.empty(0, dtype=np.int64)])
    want = K.numpy_grouped_sums(e, np.empty(0, dtype=np.int64), [np.empty(0, dtype=np.int64)])
    _assert_grouped_equal(got, want)


@pytest.mark.parametrize("n_state,n_q", [(0, 5), (5, 0), (1, 1), (1000, 300), (20000, 4096)])
def test_probe_matches_numpy(on_cpu, n_state, n_q):
    rng = np.random.default_rng(n_state + n_q)
    state = np.sort(_keys(rng, n_state, max(1, n_state // 3))) if n_state else np.empty(0, np.uint64)
    q = np.concatenate([state[: n_q // 2], _keys(rng, n_q - n_q // 2, 50)]) if n_q else np.empty(0, np.uint64)
    lo, cnt = K.join_probe(state, q)
    want_lo = np.searchsorted(state, q, side="left")
    want_cnt = np.searchsorted(state, q, side="right") - want_lo
    assert lo.dtype == want_lo.dtype and cnt.dtype == want_cnt.dtype
    np.testing.assert_array_equal(lo, want_lo)
    np.testing.assert_array_equal(cnt, want_cnt)


def test_probe_arrangement_cache_reuses_state(on_cpu, monkeypatch):
    monkeypatch.setenv("PATHWAY_ARRANGE_CACHE", "on")
    state = np.sort(np.random.default_rng(0).integers(0, 2**64 - 1, 3000, dtype=np.uint64))
    K.join_probe(state, state[:10])
    cached = K._DEV_CACHE[(id(state), "cpu")][1]
    K.join_probe(state, state[10:20])
    assert K._DEV_CACHE[(id(state), "cpu")][1] is cached


def test_routing(monkeypatch):
    monkeypatch.setenv("PATHWAY_ENGINE_JAX", "auto")
    assert not K.enabled()
    assert not K.probe_eligible(K._PROBE_STATE - 1, 10**6)
    assert K.probe_eligible(K._PROBE_STATE, K._PROBE_QUERY)
    assert K.try_grouped(np.zeros(10**5, np.uint64), np.ones(10**5, np.int64), [], {}) is None
    monkeypatch.setenv("PATHWAY_ENGINE_JAX", "0")
    assert not K.probe_eligible(10**7, 10**7)
    monkeypatch.setenv("PATHWAY_ENGINE_JAX", "cpu")
    assert K.enabled()
    assert K.probe_eligible(K._MIN_ROWS, 1024)
    assert not K.probe_eligible(K._MIN_ROWS - 1, 1024)
    assert not K.probe_eligible(K._MIN_ROWS, 1023)
    small = np.zeros(K._MIN_ROWS - 1, np.uint64)
    assert K.try_grouped(small, np.ones(len(small), np.int64), [], {}) is None
    monkeypatch.setenv("PATHWAY_ENGINE_JAX", "tpu")
    with pytest.raises(ValueError, match="PATHWAY_ENGINE_JAX"):
        K.flag()


def test_gpu_route_never_falls_back_to_the_cpu(monkeypatch):
    """``gpu`` pins the functions to the card; without CUDA the call raises
    instead of running on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the gpu route runs there")
    monkeypatch.setenv("PATHWAY_ENGINE_JAX", "gpu")
    keys = np.arange(10, dtype=np.uint64)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        K.join_probe(keys, keys)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        K.grouped_sums(keys, np.ones(10, np.int64), [])


def test_engine_routes_both_functions_and_matches_numpy(monkeypatch):
    """engine_bench's filter → join → groupby/sum at a size that routes the
    groupby (static load: one block above ``_MIN_ROWS``) and the probe (the
    same rows over 20 ticks: each tick probes the sorted 40k-key right
    side). Integer sums, so the captured update streams equal the numpy
    route's exactly."""
    from pathway_tpu_torch.debug import _capture
    from pathway_tpu_torch.tools.engine_pipeline import build

    def run(flag, n_times):
        monkeypatch.setenv("PATHWAY_ENGINE_JAX", flag)
        K.ROUTES.clear()
        out = _capture(build(400_000, n_times)).deltas
        pw.G.clear()
        return out, dict(K.ROUTES)

    for n_times, route in ((1, "grouped/cpu"), (20, "probe/cpu")):
        numpy_out, numpy_routes = run("0", n_times)
        torch_out, torch_routes = run("cpu", n_times)
        assert numpy_routes == {}
        assert torch_routes.get(route, 0) > 0, torch_routes
        assert torch_out == numpy_out


def test_fuse_jax_on_raises(monkeypatch):
    t = pw.debug.table_from_markdown(
        """
        a | b
        1 | 2
        """
    )
    s = t.filter(t.a > 0).select(c=t.a + t.b)
    from pathway_tpu_torch.debug import _capture

    monkeypatch.setenv("PATHWAY_FUSE_JAX", "on")
    with pytest.raises(NotImplementedError, match="later slice"):
        _capture(s)
    monkeypatch.setenv("PATHWAY_FUSE_JAX", "auto")
    assert [row for row in _capture(s).rows.values()] == [(3,)]
    pw.G.clear()
