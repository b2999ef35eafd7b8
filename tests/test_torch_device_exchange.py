"""The port's on-device key exchange (``parallel/device_exchange.py``, torch
ops over logical shards) against the reference's
(``tests/test_device_exchange.py``: ``shard_map`` + ``lax.all_to_all`` over
the 8-device virtual CPU mesh).

Both take the same seeded inputs: the port with 8 logical shards on ``cpu``
(and, for the copy path, shards on ``cpu`` and ``cpu:0``, which torch treats
as distinct devices), the reference on its 8-device mesh. Every output —
keys, diffs, validity and each column, at every row position, padding
included — must be equal exactly, fused and not, with and without explicit
destinations. The reference's own properties (key-shard placement, groupby
parity with the host, fused cancellation keeping arrival order and
multiplicity) are checked on the port's outputs.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from pathway_tpu.parallel import device_exchange as ref_ex  # noqa: E402
from pathway_tpu_torch.parallel import device_exchange as port_ex  # noqa: E402
from pathway_tpu_torch.parallel.mesh import device_mesh, shard_of_keys  # noqa: E402


def _ref_mesh(n):
    from jax.sharding import Mesh

    devices = jax.devices()
    if len(devices) < n:
        pytest.skip(f"need {n} devices, have {len(devices)}")
    return Mesh(np.array(devices[:n]), ("data",))


def _port_mesh(n, split_devices=False):
    if split_devices:
        devs = [torch.device("cpu") if i % 2 else torch.device("cpu", 0) for i in range(n)]
        return device_mesh(devices=devs)
    return device_mesh(n_shards=n)


def _np(out):
    k, d, v, cols = out
    return np.asarray(k), np.asarray(d), np.asarray(v), [np.asarray(c) for c in cols]


def _both(n_dev, keys, diffs, cols, valid, dest=None, dig=None, split_devices=False):
    ref = _np(ref_ex.exchange_by_key(_ref_mesh(n_dev), "data", keys, diffs, cols, valid, dest=dest, dig=dig))
    port = port_ex.exchange_by_key(
        _port_mesh(n_dev, split_devices), "data", keys, diffs, cols, valid, dest=dest, dig=dig
    )
    port = (port[0].numpy(), port[1].numpy(), port[2].numpy(), [c.numpy() for c in port[3]])
    return ref, port


def _assert_equal(ref, port):
    rk, rd, rv, rc = ref
    pk, pd, pv, pc = port
    for a, b in [(rk, pk), (rd, pd), (rv, pv)] + list(zip(rc, pc)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)


def _inputs(seed, n_dev=8, cap=64):
    rng = np.random.default_rng(seed)
    n = n_dev * cap
    keys = (rng.integers(0, 60, n).astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)) | np.uint64(1)
    diffs = rng.choice([-1, 1], n).astype(np.int32)
    cols = [
        rng.integers(0, 1000, n).astype(np.int32),
        rng.standard_normal(n).astype(np.float32),
        rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32),
        rng.random(n) > 0.5,
    ]
    valid = rng.random(n) > 0.1
    dig = port_ex.split_keys_u64((keys * np.uint64(3)) ^ np.uint64(77))
    dest = rng.integers(0, n_dev, n).astype(np.int32)
    return keys, diffs, cols, valid, dig, dest


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("explicit_dest", [False, True])
@pytest.mark.parametrize("split_devices", [False, True])
def test_exchange_equals_reference(fused, explicit_dest, split_devices):
    keys, diffs, cols, valid, dig, dest = _inputs(0)
    ref, port = _both(
        8, port_ex.split_keys_u64(keys), diffs, cols, valid,
        dest=dest if explicit_dest else None, dig=dig if fused else None,
        split_devices=split_devices,
    )
    _assert_equal(ref, port)


def test_split_join_keys_equal_reference():
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 2**64, 1000, dtype=np.uint64)
    pairs = port_ex.split_keys_u64(keys)
    assert np.array_equal(pairs, ref_ex.split_keys_u64(keys))
    assert np.array_equal(port_ex.join_keys_u64(pairs), keys)
    assert np.array_equal(port_ex.join_keys_u64(pairs), ref_ex.join_keys_u64(pairs))


def test_exchange_routes_rows_to_key_shards():
    n_dev, cap = 8, 64
    rng = np.random.default_rng(0)
    n = n_dev * cap
    keys = rng.integers(1, 2**63, n).astype(np.uint64)
    diffs = rng.choice([-1, 1], n).astype(np.int32)
    vals = rng.integers(0, 1000, n).astype(np.int32)
    valid = np.ones(n, dtype=bool)
    valid[::13] = False  # padding holes
    ref, port = _both(n_dev, port_ex.split_keys_u64(keys), diffs, [vals], valid)
    _assert_equal(ref, port)
    out_keys, out_diffs, out_valid, (out_vals,) = port
    per_dev = out_valid.shape[0] // n_dev
    got_rows = set()
    for d in range(n_dev):
        sl = slice(d * per_dev, (d + 1) * per_dev)
        kk = port_ex.join_keys_u64(out_keys[:, sl])[out_valid[sl]]
        assert (shard_of_keys(kk, n_dev) == d).all()
        for k, df, v in zip(kk, out_diffs[sl][out_valid[sl]], out_vals[sl][out_valid[sl]]):
            got_rows.add((int(k), int(df), int(v)))
    want_rows = {(int(k), int(d), int(v)) for k, d, v, ok in zip(keys, diffs, vals, valid) if ok}
    assert got_rows == want_rows


def test_exchanged_groupby_matches_host():
    n_dev, cap = 8, 32
    rng = np.random.default_rng(1)
    n = n_dev * cap
    keys = (rng.integers(0, 40, n).astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)) | np.uint64(1)
    diffs = np.ones(n, dtype=np.int32)
    vals = rng.integers(0, 100, n).astype(np.int32)
    valid = rng.random(n) > 0.1
    ref, port = _both(n_dev, port_ex.split_keys_u64(keys), diffs, [vals], valid)
    _assert_equal(ref, port)
    out_keys, out_diffs, out_valid, (out_vals,) = port
    kk = port_ex.join_keys_u64(out_keys)
    got: dict = {}
    for k, df, v in zip(kk[out_valid], out_diffs[out_valid], out_vals[out_valid]):
        got[int(k)] = got.get(int(k), 0) + int(df) * int(v)
    want: dict = {}
    for k, df, v, o in zip(keys, diffs, vals, valid):
        if o:
            want[int(k)] = want.get(int(k), 0) + int(df) * int(v)
    assert got == want


def test_fused_exchange_cancels_pairs_and_keeps_order():
    n_dev, cap = 4, 32
    rng = np.random.default_rng(3)
    n = n_dev * cap
    keys = rng.integers(0, 50, n).astype(np.uint64)
    vals = rng.integers(0, 1000, n).astype(np.uint64)
    diffs = np.ones(n, dtype=np.int32)
    keys[1::2] = keys[::2]
    vals[1::2] = vals[::2]
    diffs[1::2] = -1
    diffs[1::8] = 1  # every 4th pair stays live (same-sign duplicate)
    valid = np.ones(n, dtype=bool)
    valid[::17] = False
    dig = port_ex.split_keys_u64(vals * np.uint64(0x9E3779B97F4A7C15) + np.uint64(1))
    payload = list(port_ex.split_keys_u64(vals))
    sk = port_ex.split_keys_u64(keys)
    ref_p, plain = _both(n_dev, sk, diffs, payload, valid)
    ref_f, fused = _both(n_dev, sk, diffs, payload, valid, dig=dig)
    _assert_equal(ref_p, plain)
    _assert_equal(ref_f, fused)
    pk, pd, pv, pc = plain
    fk, fd, fv, fc = fused
    assert np.array_equal(pk, fk)
    for a, b in zip(pc, fc):
        assert np.array_equal(a, b)
    assert not (fv & ~pv).any()
    assert np.array_equal(fd[fv], pd[fv])
    assert int(fv.sum()) < int(pv.sum())

    def nets(k2, d2, v2, c2):
        kk = port_ex.join_keys_u64(np.stack([k2[0], k2[1]]))[v2]
        vv = port_ex.join_keys_u64(np.stack([c2[0][v2], c2[1][v2]]))
        c = Counter()
        for a, b, d in zip(kk.tolist(), vv.tolist(), d2[v2].astype(np.int64).tolist()):
            c[(a, b)] += d
        return Counter({k: v for k, v in c.items() if v != 0})

    assert nets(pk, pd, pv, pc) == nets(fk, fd, fv, fc)


def test_fused_exchange_same_sign_groups_keep_multiplicity():
    n_dev, cap = 4, 16
    n = n_dev * cap
    keys = np.full(n, 7, dtype=np.uint64)
    vals = np.full(n, 42, dtype=np.uint64)
    diffs = np.ones(n, dtype=np.int32)
    valid = np.ones(n, dtype=bool)
    dig = port_ex.split_keys_u64(vals)
    ref, port = _both(
        n_dev, port_ex.split_keys_u64(keys), diffs, list(port_ex.split_keys_u64(vals)), valid, dig=dig
    )
    _assert_equal(ref, port)
    _fk, fd, fv, _fc = port
    assert int(fv.sum()) == n
    assert (fd[fv] == 1).all()


def test_per_shard_output_lives_on_each_shard_device():
    keys, diffs, cols, valid, _dig, _dest = _inputs(2, n_dev=4, cap=16)
    mesh = _port_mesh(4, split_devices=True)
    per = port_ex.exchange_by_key_shards(mesh, "data", port_ex.split_keys_u64(keys), diffs, cols, valid)
    for d, (k, df, v, cs) in enumerate(per):
        # a CPU tensor reports ``cpu`` whatever index its device was named with
        dev = mesh.shard_devices("data")[d].type
        assert k.device.type == dev and df.device.type == dev and v.device.type == dev
        assert all(c.device.type == dev for c in cs)
        assert k.shape == (2, 4 * 16)
