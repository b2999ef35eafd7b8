"""Multi-worker determinism in the port against the reference
(``tests/test_multiworker.py``): every pipeline is written once as
``build(pw)`` and captured by the port at 1 and at 4 workers
(``ShardedRuntime``) and by the reference at 1 worker. The port at 1 worker
must equal the port at 4 in keys and rows, and the reference in keys and
rows. The KNN case compares keys and tie order exactly and scores within
1e-6 against the reference (the port scores in torch f32); within the port,
the 4-worker scores equal the 1-worker scores bit for bit.
"""

from __future__ import annotations

import numpy as np
import pytest

import pathway_tpu
import pathway_tpu_torch
from pathway_tpu.debug import _capture as ref_capture
from pathway_tpu_torch.debug import _capture as port_capture


@pytest.fixture(autouse=True)
def _fresh():
    for pw in (pathway_tpu, pathway_tpu_torch):
        pw.G.clear()
    yield
    for pw in (pathway_tpu, pathway_tpu_torch):
        pw.G.clear()


def _keyed(pw, build, n_workers):
    pw.G.clear()
    capture = port_capture if pw is pathway_tpu_torch else ref_capture
    return dict(capture(build(pw), n_workers=n_workers).rows)


def _three(build):
    """(reference at 1 worker, port at 1, port at 4)."""
    ref = _keyed(pathway_tpu, build, 1)
    p1 = _keyed(pathway_tpu_torch, build, 1)
    p4 = _keyed(pathway_tpu_torch, build, 4)
    return ref, p1, p4


def _mk_input(pw, n=2000, seed=0):
    rng = np.random.default_rng(seed)
    return pw.debug.table_from_rows(
        pw.schema_from_types(k=int, v=int, t=int),
        list(
            zip(
                rng.integers(0, 50, n).tolist(),
                rng.integers(0, 1000, n).tolist(),
                rng.integers(0, 100, n).tolist(),
            )
        ),
    )


def test_join_groupby_identical():
    def build(pw):
        t = _mk_input(pw)
        d = pw.debug.table_from_rows(
            pw.schema_from_types(k=int, name=str),
            [(i, f"g{i % 7}") for i in range(50)],
        )
        j = t.join(d, t.k == d.k).select(name=d.name, v=t.v)
        return j.groupby(j.name).reduce(
            j.name,
            s=pw.reducers.sum(j.v),
            c=pw.reducers.count(),
            mx=pw.reducers.max(j.v),
        )

    ref, p1, p4 = _three(build)
    assert p1 == p4 == ref
    assert len(p1) == 7


def test_outer_join_identical():
    def build(pw):
        t = _mk_input(pw)
        d = pw.debug.table_from_rows(
            pw.schema_from_types(k=int, name=str),
            [(i, f"g{i}") for i in range(30)],  # ks 30..49 unmatched
        )
        return t.join_outer(d, t.k == d.k).select(
            k=pw.coalesce(t.k, d.k), v=t.v, name=d.name
        )

    ref, p1, p4 = _three(build)
    assert p1 == p4 == ref


def test_windowby_identical():
    def build(pw):
        t = _mk_input(pw)
        return t.windowby(
            t.t, window=pw.temporal.tumbling(duration=10), instance=t.k
        ).reduce(
            k=pw.this._pw_instance,
            start=pw.this._pw_window_start,
            s=pw.reducers.sum(pw.this.v),
        )

    ref, p1, p4 = _three(build)
    assert p1 == p4 == ref
    assert len(p1) > 100


def test_full_pipeline_join_groupby_window_identical():
    def build(pw):
        t = _mk_input(pw)
        d = pw.debug.table_from_rows(
            pw.schema_from_types(k=int, w=int),
            [(i, i * 3) for i in range(50)],
        )
        j = t.join(d, t.k == d.k).select(k=t.k, v=t.v + d.w, t=t.t)
        win = j.windowby(
            j.t, window=pw.temporal.tumbling(duration=25), instance=j.k
        ).reduce(
            k=pw.this._pw_instance,
            start=pw.this._pw_window_start,
            s=pw.reducers.sum(pw.this.v),
        )
        return win.groupby(win.k).reduce(win.k, total=pw.reducers.sum(win.s))

    ref, p1, p4 = _three(build)
    assert p1 == p4 == ref
    assert len(p1) == 50


def test_iterate_identical():
    def build(pw):
        t = pw.debug.table_from_rows(
            pw.schema_from_types(val=int), [(i,) for i in range(1, 40)]
        )

        def step(iterated):
            return iterated.select(
                val=pw.if_else(iterated.val > 1, iterated.val - 1, iterated.val)
            )

        return pw.iterate(step, iterated=t)

    ref, p1, p4 = _three(build)
    assert p1 == p4 == ref
    assert all(row == (1,) for row in p1.values())


def test_streaming_retractions_identical():
    def build(pw):
        t = pw.debug.table_from_markdown(
            """
            k | v | __time__ | __diff__
            1 | 3 | 2        | 1
            2 | 4 | 2        | 1
            1 | 5 | 4        | 1
            1 | 3 | 6        | -1
            """
        )
        return t.groupby(t.k).reduce(t.k, s=pw.reducers.sum(t.v), c=pw.reducers.count())

    ref, p1, p4 = _three(build)
    assert p1 == p4 == ref


def test_sharded_knn_index_identical():
    """The external KNN index shards docs across workers (queries broadcast,
    partial replies merged per query): with a block of 20 tied rows at the
    k boundary, 4 workers answer as 1 does, keys and score bits."""
    rng = np.random.default_rng(7)
    vecs = rng.normal(size=(64, 8)).astype(np.float32)
    vecs[20:40] = vecs[20]  # 20 identical rows: score ties at the k boundary
    qs = rng.normal(size=(12, 8)).astype(np.float32)
    qs[0] = vecs[20]  # query hitting the tied block head-on

    def build(pw):
        docs = pw.debug.table_from_rows(pw.schema_from_types(emb=np.ndarray), [(v,) for v in vecs])
        queries = pw.debug.table_from_rows(pw.schema_from_types(emb=np.ndarray), [(q,) for q in qs])
        kw = {"device": "cpu"} if pw is pathway_tpu_torch else {}
        factory = pw.stdlib.indexing.BruteForceKnnFactory(dimensions=8, reserved_space=128, **kw)
        index = factory.build_index(docs.emb, docs)
        return index.inner_index.query(queries.emb, number_of_matches=5)

    ref, p1, p4 = _three(build)
    assert p1 == p4
    assert len(p1) == 12
    assert all(len(row[0]) == 5 for row in p1.values())
    assert set(ref) == set(p1)
    for key, (matches,) in p1.items():
        (want,) = ref[key]
        assert [int(k) for k, _ in matches] == [int(k) for k, _ in want]
        np.testing.assert_allclose(
            [s for _, s in matches], [s for _, s in want], rtol=0, atol=1e-6
        )


def test_data_index_tied_hits_identical():
    """A ``DataIndex`` (the factory's ``build_index``) over a corpus with a
    block of identical docs: each query's collapsed hits, tied scores
    included, come in the same order at 1 and 4 workers and in the
    reference, so the rank of a hit does not depend on which worker's rows
    reach the collapsing group first."""
    rng = np.random.default_rng(9)
    vecs = rng.normal(size=(96, 8)).astype(np.float32)
    vecs[30:60] = vecs[30]
    qs = rng.normal(size=(10, 8)).astype(np.float32)
    qs[0] = vecs[30]
    qs[1] = vecs[30] + 0.01

    def build(pw):
        docs = pw.debug.table_from_rows(
            pw.schema_from_types(emb=np.ndarray, name=str), [(v, f"d{i}") for i, v in enumerate(vecs)]
        )
        queries = pw.debug.table_from_rows(pw.schema_from_types(emb=np.ndarray), [(q,) for q in qs])
        kw = {"device": "cpu"} if pw is pathway_tpu_torch else {}
        index = pw.stdlib.indexing.BruteForceKnnFactory(dimensions=8, reserved_space=128, **kw).build_index(
            docs.emb, docs.select(docs.name)
        )
        return index.query_as_of_now(queries.emb, number_of_matches=12).select(names=pw.right.name)

    ref, p1, p4 = _three(build)
    assert p1 == p4 == ref
    assert len(p1) == 10 and all(len(row[0]) == 12 for row in p1.values())
