"""The port's shard map (``pathway_tpu_torch/internals/shardmap.py``) against
the reference's (``tests/test_shardmap.py``), case by case: the same random
scale walks give segment tables equal to the reference's at every version,
and each property the reference checks holds on the port's maps (one owner
per residue, minimal movement, ``diff`` = the moved residues,
``overlap_sources`` = a brute-force owner scan); ``shard_of_keys`` places
keys as the map does in both packages; commits, history and
``ensure_shardmap``'s fresh versions on the memory backend. Integers only:
every comparison is exact."""

from __future__ import annotations

import random

import numpy as np
import pytest

from pathway_tpu.internals import keys as ref_keys
from pathway_tpu.internals import shardmap as ref_sm
from pathway_tpu_torch.internals import shardmap
from pathway_tpu_torch.internals.keys import SHARD_MASK, shard_of_keys, splitmix64
from pathway_tpu_torch.internals.shardmap import SHARD_SPACE, ShardMap
from pathway_tpu_torch.persistence.backends import MemoryBackend

ALL_RESIDUES = np.arange(SHARD_SPACE, dtype=np.int64)


def _owner_table(m) -> np.ndarray:
    return m.owner_of_residues(ALL_RESIDUES)


def _same(a, b) -> None:
    """A port map equals the reference's: version, shape and segments."""
    assert (a.version, a.n_workers) == (b.version, b.n_workers)
    np.testing.assert_array_equal(a.starts, b.starts)
    np.testing.assert_array_equal(a.owners, b.owners)


def test_initial_map_partitions_space_exactly_once():
    assert SHARD_SPACE == ref_sm.SHARD_SPACE
    for n in (1, 2, 3, 5, 7, 16):
        m = ShardMap.initial(n)
        m.validate()
        _same(m, ref_sm.ShardMap.initial(n))
        counts = np.bincount(_owner_table(m), minlength=n)
        assert counts.sum() == SHARD_SPACE and (counts > 0).all()
        assert abs(int(counts.max()) - int(counts.min())) <= 1


def test_random_scale_walks_exactly_one_owner_and_minimal_movement():
    rng = random.Random(0xA11CE)
    for _walk in range(20):
        n0 = rng.randint(1, 8)
        m, r = ShardMap.initial(n0), ref_sm.ShardMap.initial(n0)
        for _step in range(6):
            new_n = rng.choice([m.n_workers, rng.randint(1, 9)])  # incl. N->N
            nm, nr = m.rebalance(new_n), r.rebalance(new_n)
            nm.validate()
            _same(nm, nr)
            old_t, new_t = _owner_table(m), _owner_table(nm)
            counts = np.bincount(new_t, minlength=new_n)
            assert counts.sum() == SHARD_SPACE and (counts > 0).all()
            moved = int((old_t != new_t).sum())
            if new_n == m.n_workers:
                assert moved == 0
            else:
                quota = [SHARD_SPACE // new_n + (1 if w < SHARD_SPACE % new_n else 0) for w in range(new_n)]
                old_counts = np.bincount(old_t, minlength=max(new_n, m.n_workers))
                kept_max = sum(min(int(old_counts[w]), quota[w]) for w in range(new_n))
                assert moved == SHARD_SPACE - kept_max
            m, r = nm, nr


def test_diff_enumerates_exactly_the_moved_residues():
    rng = random.Random(7)
    for _ in range(10):
        n_old, n_new = rng.randint(1, 6), rng.randint(1, 7)
        old = ShardMap.initial(n_old)
        new = old.rebalance(n_new)
        ref_old = ref_sm.ShardMap.initial(n_old)
        got = shardmap.diff(old, new)
        assert got == ref_sm.diff(ref_old, ref_old.rebalance(n_new))
        old_t, new_t = _owner_table(old), _owner_table(new)
        in_diff = np.zeros(SHARD_SPACE, dtype=bool)
        for s, e, a, b in got:
            assert a != b
            assert (old_t[s:e] == a).all() and (new_t[s:e] == b).all()
            assert not in_diff[s:e].any()
            in_diff[s:e] = True
        np.testing.assert_array_equal(in_diff, old_t != new_t)
        assert shardmap.moved_fraction(old, new) == pytest.approx(in_diff.sum() / SHARD_SPACE)


def test_overlap_sources_matches_brute_force_owner_scan():
    rng = random.Random(99)
    for _ in range(10):
        n_old, n_new = rng.randint(1, 7), rng.randint(1, 8)
        old = ShardMap.initial(n_old)
        new = old.rebalance(n_new)
        ref_old = ref_sm.ShardMap.initial(n_old)
        ref_new = ref_old.rebalance(n_new)
        old_t, new_t = _owner_table(old), _owner_table(new)
        for w in range(new.n_workers):
            expect = sorted(set(int(o) for o in old_t[new_t == w]))
            assert shardmap.overlap_sources(old, new, w) == expect
            assert ref_sm.overlap_sources(ref_old, ref_new, w) == expect


def test_shard_of_keys_unifies_modulo_and_map_placement():
    keys = np.array([splitmix64(np.uint64(i)) for i in range(512)], dtype=np.uint64)
    np.testing.assert_array_equal(shard_of_keys(keys, 3), ((keys & SHARD_MASK) % 3).astype(np.int32))
    np.testing.assert_array_equal(shard_of_keys(keys, 3), ref_keys.shard_of_keys(keys, 3))
    m = ShardMap.initial(3).rebalance(5)
    r = ref_sm.ShardMap.initial(3).rebalance(5)
    got = shard_of_keys(keys, 5, shard_map=m)
    np.testing.assert_array_equal(got, m.owner_of_keys(keys))
    np.testing.assert_array_equal(got, ref_keys.shard_of_keys(keys, 5, shard_map=r))
    assert ((got >= 0) & (got < 5)).all()
    # the mesh's placement helper delegates to the same authority
    from pathway_tpu_torch.parallel.mesh import shard_of_keys as mesh_shard_of_keys

    np.testing.assert_array_equal(mesh_shard_of_keys(keys, 5, shard_map=m), got)


def test_key_ranges_and_dict_round_trip_match_the_reference():
    m = ShardMap.initial(4).rebalance(3)
    r = ref_sm.ShardMap.initial(4).rebalance(3)
    assert m.key_ranges() == r.key_ranges()
    d = m.to_dict()
    assert d == {**r.to_dict(), "committed_unix": d["committed_unix"]}
    _same(ShardMap.from_dict(d), r)
    with pytest.raises(ValueError, match="owner outside"):
        ShardMap(version=1, n_workers=2, starts=np.array([0, 5]), owners=np.array([0, 2])).validate()


def test_commit_read_roundtrip_and_immutable_history():
    MemoryBackend.clear("tsmap-rt")
    b = MemoryBackend("tsmap-rt")
    assert shardmap.read_shardmap(b) is None
    m0 = shardmap.commit_shardmap(b, ShardMap.initial(2, version=0))
    m1 = shardmap.commit_shardmap(b, m0.rebalance(3, version=1))
    got = shardmap.read_shardmap(b)
    assert got is not None and got.version == 1 and got.n_workers == 3
    np.testing.assert_array_equal(got.starts, m1.starts)
    hist0 = shardmap.read_shardmap_version(b, 0)
    assert hist0 is not None and hist0.n_workers == 2
    # the backend keys are the reference's
    assert sorted(b.list_keys("elastic/")) == ["elastic/shardmap", "elastic/shardmap_v000000", "elastic/shardmap_v000001"]
    MemoryBackend.clear("tsmap-rt")


def test_ensure_shardmap_never_reuses_a_version_for_a_new_map():
    MemoryBackend.clear("tsmap-fresh")
    b = MemoryBackend("tsmap-fresh")
    first, prev = shardmap.ensure_shardmap(b, 2, version=0, commit=True)
    assert prev is None and first.version == 0
    again, prev = shardmap.ensure_shardmap(b, 2, version=0, commit=True)
    assert prev is None and again.version == 0
    cur, prev = shardmap.ensure_shardmap(b, 3, version=0, commit=True)
    assert prev is not None and prev.n_workers == 2
    assert cur.version == 1 and cur.n_workers == 3
    old = shardmap.read_shardmap_version(b, 0)
    assert old is not None and old.n_workers == 2
    MemoryBackend.clear("tsmap-fresh2")
    b2 = MemoryBackend("tsmap-fresh2")
    shardmap.commit_shardmap(b2, ShardMap.initial(2, version=0))
    peer, _ = shardmap.ensure_shardmap(b2, 3, version=0, commit=False)
    np.testing.assert_array_equal(peer.starts, cur.starts)
    np.testing.assert_array_equal(peer.owners, cur.owners)
    ref = ref_sm.ShardMap.initial(2, version=0).rebalance(3, version=1)
    _same(cur, ref)
    # no backend: the equal initial split at the given version
    solo, prev = shardmap.ensure_shardmap(None, 4, version=0)
    assert prev is None
    _same(solo, ref_sm.ShardMap.initial(4, version=0))
    MemoryBackend.clear("tsmap-fresh")
    MemoryBackend.clear("tsmap-fresh2")
