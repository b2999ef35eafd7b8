"""The index's O(delta) snapshots in the port against the reference
(``tests/test_index_snapshots.py``): ``ExternalIndexNode`` persists an
add/remove delta log per snapshot tick plus a compacted base, restore is base
+ in-order replay through ``backend.add``/``remove``, and compaction deletes
covered delta chunks after the manifest commit.

Each case feeds the same seeded vectors to both packages, each writing to its
own memory-backend root: the sequence of snapshot chunk names, the ops in
each delta chunk and the answers' keys and tie order are equal; scores agree
within 1e-6 (two frameworks). Within the port a restored index answers with
the live index's keys, tie order and score bits. The port's index runs on
``device="cpu"`` here.
"""

from __future__ import annotations

import gc
import os
import pickle

import numpy as np
import pytest

import pathway_tpu
import pathway_tpu_torch
from pathway_tpu.engine.blocks import DeltaBatch as RBatch
from pathway_tpu.persistence.backends import MemoryBackend as RMem
from pathway_tpu.persistence.snapshots import SnapshotStore as RStore
from pathway_tpu.persistence.snapshots import _OperatorSnapshots as ROps
from pathway_tpu.stdlib.indexing._engine import ExternalIndexNode as RNode
from pathway_tpu.stdlib.indexing._engine import VectorBackend as RVec
from pathway_tpu_torch.engine.blocks import DeltaBatch as TBatch
from pathway_tpu_torch.observability import device as port_dev
from pathway_tpu_torch.persistence.backends import MemoryBackend as TMem
from pathway_tpu_torch.persistence.snapshots import SnapshotStore as TStore
from pathway_tpu_torch.persistence.snapshots import _OperatorSnapshots as TOps
from pathway_tpu_torch.stdlib.indexing._engine import ExternalIndexNode as TNode
from pathway_tpu_torch.stdlib.indexing._engine import VectorBackend as TVec

DIM = 32
ALWAYS = lambda md: True  # noqa: E731
PREFIX = "operators/aux/worker_000/node_00007/"

SIDES = {
    "ref": dict(node=RNode, vec=lambda r: RVec(dimension=DIM, reserved_space=r), batch=RBatch,
                mem=RMem, store=RStore, ops=ROps, pw=pathway_tpu),
    "port": dict(node=TNode, vec=lambda r: TVec(dimension=DIM, reserved_space=r, device="cpu"),
                 batch=TBatch, mem=TMem, store=TStore, ops=TOps, pw=pathway_tpu_torch),
}


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    """Knobs set for both packages; the memory roots this file uses are
    process-lifetime stores, cleared before and after each case."""
    monkeypatch.delenv("PATHWAY_INDEX_SNAPSHOT", raising=False)
    monkeypatch.delenv("PATHWAY_INDEX_COMPACT_FRAC", raising=False)
    monkeypatch.setenv("PATHWAY_PERSISTENT_STORAGE", "unset")
    monkeypatch.delenv("PATHWAY_PERSISTENT_STORAGE")
    roots = []
    yield roots
    for side in SIDES.values():
        for r in roots:
            side["mem"].clear(r)


def _mk_node(side, reserved=2048):
    s = SIDES[side]
    node = s["node"](lambda: s["vec"](reserved), as_of_now=True)
    node.snapshot_log_enabled = True
    node.node_index = 7
    return node


def _docs(side, keys, vecs, t, diffs=None):
    return SIDES[side]["batch"].from_rows(
        keys, [(v, 0) for v in vecs], ["__item", "__meta"], t, diffs=diffs
    )


def _backend(side, roots, name):
    roots.append(name)
    SIDES[side]["mem"].clear(name)
    return SIDES[side]["mem"](name)


def _search(backend, qs, k=5):
    return backend.search(list(qs), [k] * len(qs), [ALWAYS] * len(qs))


def _decoded_ops(be, keys):
    """The ops of each delta chunk: (tag, key, item bytes) in order."""
    out = []
    for k in keys:
        ops = pickle.loads(be.get(k))
        out.append([
            (op[0], op[1]) + ((np.asarray(op[2], np.float32).tobytes(), op[3]) if op[0] == "a" else ())
            for op in ops
        ])
    return out


def _assert_answers_match(ref, port):
    """Keys and tie order equal; scores within 1e-6."""
    assert [[k for k, _ in q] for q in port] == [[k for k, _ in q] for q in ref]
    for rq, pq in zip(ref, port):
        np.testing.assert_allclose([s for _, s in pq], [s for _, s in rq], rtol=0, atol=1e-6)


def _score_bits(answers):
    return [[(k, np.float32(s).view(np.uint32).item()) for k, s in q] for q in answers]


# ------------------------------------------------------- node-level protocol


def test_snapshot_attrs_split_excludes_backend(_isolated):
    rng = np.random.default_rng(0)
    vecs = rng.normal(size=(1000, DIM)).astype(np.float32)
    got = {}
    for side in SIDES:
        assert "backend" not in SIDES[side]["node"].snapshot_attrs
        assert set(SIDES[side]["node"].snapshot_attrs) == {"_live_queries", "_emitted", "_tok"}
        assert SIDES[side]["node"].uses_snapshot_store
        node = _mk_node(side)
        node.process((_docs(side, list(range(1000)), list(vecs), 0), None), 0)
        be = _backend(side, _isolated, f"snapattr-{side}")
        state = node.snapshot_state_store(SIDES[side]["store"](be, PREFIX))
        gen_entry = pickle.dumps(state)
        assert len(gen_entry) < 2048, len(gen_entry)
        assert len(pickle.dumps(node.backend)) > 100_000
        got[side] = (state["backend_chunks"]["base"], be.list_keys("operators/"))
    assert got["port"] == got["ref"] == ("base_00000000", [PREFIX + "base_00000000"])


def _churn(side, roots, n_rows, ticks=10, seed=1):
    """Ingest ``n_rows``, snapshot, then ``ticks`` ticks of 0.1%-ish churn
    (2 removals + 2 adds, with one duplicate vector for a tie), a snapshot
    after each. Returns the node, the backend, the last state and each
    snapshot's (chunk names, bytes put)."""
    rng = np.random.default_rng(seed)
    node = _mk_node(side, reserved=max(2048, n_rows + 64))
    vecs = rng.normal(size=(n_rows, DIM)).astype(np.float32)
    node.process((_docs(side, list(range(n_rows)), list(vecs), 0), None), 0)
    be = _backend(side, roots, f"churn-{side}-{n_rows}")
    st = SIDES[side]["store"](be, PREFIX)
    state = node.snapshot_state_store(st)
    snaps = [(state["backend_chunks"]["base"], tuple(state["backend_chunks"]["deltas"]), st.put_bytes)]
    for t in range(1, ticks + 1):
        rm = sorted({int(rng.integers(0, n_rows)) for _ in range(2)})
        rm = [k for k in rm if k in node.backend.metadata]
        add_keys = [10_000 + t * 10 + j for j in range(2)]
        add_vecs = rng.normal(size=(2, DIM)).astype(np.float32)
        add_vecs[1] = add_vecs[0]  # an exact tie: the key bits order it
        b = SIDES[side]["batch"].from_rows(
            rm + add_keys,
            [(np.zeros(DIM, np.float32), 0)] * len(rm) + [(v, 0) for v in add_vecs],
            ["__item", "__meta"], t,
            diffs=[-1] * len(rm) + [1] * len(add_keys),
        )
        node.process((b, None), t)
        st = SIDES[side]["store"](be, PREFIX)
        state = node.snapshot_state_store(st)
        snaps.append((state["backend_chunks"]["base"], tuple(state["backend_chunks"]["deltas"]), st.put_bytes))
    return node, be, state, snaps


def test_delta_snapshots_are_o_churn_and_restore_bit_identical(_isolated):
    """Same chunk names and delta ops on both packages; per-tick bytes drop
    >= 50x against a whole-backend pickle; the port's base + delta restore
    answers with the live index's keys, tie order and score bits."""
    runs = {side: _churn(side, _isolated, 2000) for side in SIDES}
    names = {side: [s[:2] for s in runs[side][3]] for side in SIDES}
    assert names["port"] == names["ref"]
    assert names["port"][-1][0] == "base_00000000" and len(names["port"][-1][1]) == 10
    delta_keys = [PREFIX + n for n in names["port"][-1][1]]
    assert _decoded_ops(runs["port"][1], delta_keys) == _decoded_ops(runs["ref"][1], delta_keys)

    node, be, state, snaps = runs["port"]
    per_tick = [s[2] for s in snaps[1:]]
    whole = len(pickle.dumps(node.backend))
    assert whole / max(sum(per_tick) / len(per_tick), 1) >= 50, (whole, per_tick)

    rng = np.random.default_rng(9)
    qs = rng.normal(size=(4, DIM)).astype(np.float32)
    # a query equal to a duplicated vector: its top hits tie exactly
    qs = np.concatenate([qs, runs["port"][0].backend.index._vectors[
        runs["port"][0].backend.index._key_to_slot[10_101]
    ].numpy()[None, :]])
    live = _search(node.backend, qs)
    restored = {}
    for side in SIDES:
        n2 = _mk_node(side)
        n2.restore_state_store(pickle.loads(pickle.dumps(runs[side][2])), SIDES[side]["store"](runs[side][1], PREFIX))
        restored[side] = n2
        assert n2._snap_base == runs[side][0]._snap_base
        assert n2._snap_deltas == runs[side][0]._snap_deltas
    assert _score_bits(_search(restored["port"].backend, qs)) == _score_bits(live)
    assert [k for k, _ in live[-1][:2]] == sorted([10_100, 10_101], key=lambda k: [k2 for k2, _ in live[-1]].index(k))
    _assert_answers_match(_search(restored["ref"].backend, qs), _search(restored["port"].backend, qs))
    # slot assignment after replay equals the live index's
    assert restored["port"].backend.index._key_to_slot == node.backend.index._key_to_slot


def test_delta_chunks_grow_with_churn_not_index_size(_isolated):
    """The same churn over a 4x larger index writes delta chunks of the same
    size (to the few bytes a larger key takes in a pickle); only the base
    grows."""
    small = _churn("port", _isolated, 1000, ticks=4)[3]
    large = _churn("port", _isolated, 4000, ticks=4)[3]
    for s_small, s_large in zip(small[1:], large[1:]):
        assert abs(s_large[2] - s_small[2]) <= 8, (small, large)
    assert large[0][2] > 2 * small[0][2]


def test_compaction_threshold_rewrites_base(monkeypatch, _isolated):
    got = {}
    for side in SIDES:
        monkeypatch.delenv("PATHWAY_INDEX_COMPACT_FRAC", raising=False)
        rng = np.random.default_rng(2)
        node = _mk_node(side)
        node.process((_docs(side, list(range(100)), list(rng.normal(size=(100, DIM)).astype(np.float32)), 0), None), 0)
        be = _backend(side, _isolated, f"snapcompact-{side}")
        node.snapshot_state_store(SIDES[side]["store"](be, PREFIX))
        assert node._snap_deltas == []
        node.process((_docs(side, [500], [rng.normal(size=DIM).astype(np.float32)], 1), None), 1)
        node.snapshot_state_store(SIDES[side]["store"](be, PREFIX))
        assert len(node._snap_deltas) == 1
        monkeypatch.setenv("PATHWAY_INDEX_COMPACT_FRAC", "0.000001")
        node.process((_docs(side, [501], [rng.normal(size=DIM).astype(np.float32)], 2), None), 2)
        state = node.snapshot_state_store(SIDES[side]["store"](be, PREFIX))
        assert state["backend_chunks"]["deltas"] == []
        got[side] = (state["backend_chunks"]["base"], be.list_keys("operators/"))
    assert got["port"] == got["ref"]
    assert got["port"][0] == "base_00000002"


def test_gc_deletes_covered_delta_chunks_after_commit(monkeypatch, _isolated):
    seen = {}
    for side in SIDES:
        monkeypatch.delenv("PATHWAY_INDEX_COMPACT_FRAC", raising=False)
        rng = np.random.default_rng(3)
        node = _mk_node(side)
        node.process((_docs(side, list(range(200)), list(rng.normal(size=(200, DIM)).astype(np.float32)), 0), None), 0)
        be = _backend(side, _isolated, f"snapgc-{side}")
        ops = SIDES[side]["ops"](be, interval_s=10_000)
        worker_nodes = {0: [node]}
        names = [("external_index", 2, (), ())]
        trail = []
        ops.save_shards(worker_nodes)
        ops.commit(names, {}, 0, 1)
        ops.flush_aux_gc()
        ops.advance()
        node.process((_docs(side, [900], [rng.normal(size=DIM).astype(np.float32)], 1), None), 1)
        ops.save_shards(worker_nodes)
        trail.append(be.list_keys("operators/aux/"))
        ops.commit(names, {}, 1, 1)
        ops.flush_aux_gc()
        ops.advance()
        trail.append(be.list_keys("operators/aux/"))
        monkeypatch.setenv("PATHWAY_INDEX_COMPACT_FRAC", "0.000001")
        node.process((_docs(side, [901], [rng.normal(size=DIM).astype(np.float32)], 2), None), 2)
        ops.save_shards(worker_nodes)
        trail.append(be.list_keys("operators/aux/"))  # old base still present
        ops.commit(names, {}, 2, 1)
        ops.flush_aux_gc()
        trail.append(be.list_keys("operators/aux/"))
        seen[side] = trail
    assert seen["port"] == seen["ref"]
    assert any("base_00000000" in k for k in seen["port"][2])
    assert not any("delta" in k for k in seen["port"][3])
    assert len([k for k in seen["port"][3] if "base" in k]) == 1


def test_whole_mode_escape_hatch(monkeypatch, _isolated):
    monkeypatch.setenv("PATHWAY_INDEX_SNAPSHOT", "whole")
    answers = {}
    for side in SIDES:
        rng = np.random.default_rng(4)
        node = _mk_node(side)
        node.process((_docs(side, [1, 2], list(rng.normal(size=(2, DIM)).astype(np.float32)), 0), None), 0)
        be = _backend(side, _isolated, f"snapwhole-{side}")
        st = SIDES[side]["store"](be, PREFIX)
        state = node.snapshot_state_store(st)
        assert "backend_whole" in state and st.put_bytes == 0
        node2 = _mk_node(side)
        node2.restore_state_store(pickle.loads(pickle.dumps(state)), SIDES[side]["store"](be, PREFIX))
        qs = rng.normal(size=(2, DIM)).astype(np.float32)
        answers[side] = (_search(node.backend, qs, 2), _search(node2.backend, qs, 2))
        assert _score_bits(answers[side][1]) == _score_bits(answers[side][0]) or side == "ref"
    _assert_answers_match(answers["ref"][1], answers["port"][1])


def test_storeless_snapshot_state_roundtrips_whole_backend(_isolated):
    answers = {}
    for side in SIDES:
        rng = np.random.default_rng(5)
        node = _mk_node(side)
        node.process((_docs(side, [1], [rng.normal(size=DIM).astype(np.float32)], 0), None), 0)
        state = node.snapshot_state()
        assert "backend_whole" in state
        node2 = _mk_node(side)
        node2.restore_state(pickle.loads(pickle.dumps(state)))
        qs = rng.normal(size=(1, DIM)).astype(np.float32)
        answers[side] = (_search(node.backend, qs, 1), _search(node2.backend, qs, 1))
    assert _score_bits(answers["port"][1]) == _score_bits(answers["port"][0])
    _assert_answers_match(answers["ref"][1], answers["port"][1])


def test_index_pickle_flushes_staged_rows_and_keeps_the_device():
    """The index's pickle form applies every staged update first (host and
    device-staged blocks), moves the tensors to the host, and opens on the
    index's own device with the key bits recomputed."""
    from pathway_tpu_torch.ops.knn import BruteForceKnnIndex

    rng = np.random.default_rng(6)
    ix = BruteForceKnnIndex(dimension=DIM, capacity=256, device="cpu")
    ix.add_batch(list(range(40)), rng.normal(size=(40, DIM)).astype(np.float32))
    ix.remove(3)
    assert ix._pending_slots or ix._pending_device or ix._pending_invalidate
    blob = pickle.dumps(ix)
    assert not ix._pending_device and not ix._pending_slots and not ix._pending_invalidate
    gc.collect()
    before = port_dev.memory_components().get("knn_index", 0)
    back = pickle.loads(blob)
    # the restored index re-registers its device bytes, once
    assert port_dev.memory_components().get("knn_index", 0) - before == back.device_bytes() > 0
    assert str(back.device) == "cpu" and back._vectors.device.type == "cpu"
    assert back._key_to_slot == ix._key_to_slot
    live = sorted(ix._slot_to_key)
    assert back._key_bits[live].tolist() == ix._key_bits[live].tolist()
    qs = rng.normal(size=(3, DIM)).astype(np.float32)
    assert _score_bits(back.search(qs, 5)) == _score_bits(ix.search(qs, 5))


def test_tiered_backend_restore_registers_its_bytes_once(_isolated):
    """A restored tiered index answers with the live one's keys, tie order
    and score bits, and its ``knn_hot`` / ``knn_cold`` bytes count once."""
    from pathway_tpu_torch.stdlib.indexing.tiered import TieredKnnBackend

    def tiered():
        return TieredKnnBackend(dimension=DIM, hot_rows=256, min_train=10**9, device="cpu")

    rng = np.random.default_rng(7)
    node = TNode(tiered, as_of_now=True)
    node.snapshot_log_enabled = True
    node.node_index = 7
    vecs = rng.normal(size=(600, DIM)).astype(np.float32)
    node.process((_docs("port", list(range(600)), list(vecs), 0), None), 0)
    be = _backend("port", _isolated, "tiered-port")
    node.snapshot_state_store(TStore(be, PREFIX))
    node.process((_docs("port", [900, 901], [vecs[0], vecs[0]], 1), None), 1)
    state = node.snapshot_state_store(TStore(be, PREFIX))
    assert len(state["backend_chunks"]["deltas"]) == 1
    qs = np.concatenate([vecs[:1], rng.normal(size=(3, DIM)).astype(np.float32)])
    live = _search(node.backend, qs)
    live_bytes = (node.backend.hot.device_bytes(), node.backend.cold_bytes())
    del node
    gc.collect()
    before = port_dev.memory_components()
    n2 = TNode(tiered, as_of_now=True)
    n2.node_index = 7
    n2.restore_state_store(pickle.loads(pickle.dumps(state)), TStore(be, PREFIX))
    gc.collect()
    after = port_dev.memory_components()
    assert _score_bits(_search(n2.backend, qs)) == _score_bits(live)
    assert [k for k, _ in live[0][:3]] == sorted([0, 900, 901], key=[k for k, _ in live[0]].index)
    assert (n2.backend.hot.device_bytes(), n2.backend.cold_bytes()) == live_bytes
    assert after.get("knn_hot", 0) - before.get("knn_hot", 0) == live_bytes[0]
    assert after.get("knn_cold", 0) - before.get("knn_cold", 0) == live_bytes[1]


# ------------------------------------------------------ full-pipeline restart


def _vec(i):
    return np.random.default_rng(1000 + i).normal(size=DIM).astype(np.float32)


def _qvec(i):
    return np.random.default_rng(77_000 + i).normal(size=DIM).astype(np.float32)


def _index_session(pw, doc_ids, query_ids, backend, extra_docs_at=20):
    """Docs at time 2 (ids >= 500 at ``extra_docs_at``), query i at time
    10 + 2i: a timed, deterministic stream. Returns the answers' update
    stream (key, q_id, reply, time, is_addition)."""
    pw.G.clear()
    dsch = pw.schema_from_types(doc_id=int, emb=np.ndarray)
    qsch = pw.schema_from_types(q_id=int, emb=np.ndarray)
    docs = pw.debug.table_from_rows(
        dsch, [(i, _vec(i), extra_docs_at if i >= 500 else 2, 1) for i in doc_ids], is_stream=True
    )
    queries = pw.debug.table_from_rows(
        qsch, [(i, _qvec(i), 10 + 2 * i, 1) for i in query_ids], is_stream=True
    )
    kwargs = {"device": "cpu"} if pw is pathway_tpu_torch else {}
    index = pw.stdlib.indexing.BruteForceKnn(
        docs.emb, DIM, reserved_space=1024, metadata_column=docs.doc_id, **kwargs
    )
    replies = index.query_as_of_now(queries.emb, number_of_matches=3)
    joined = replies.select(q_id=queries.q_id, reply=replies["_pw_index_reply"])
    got = []
    pw.io.subscribe(
        joined,
        on_change=lambda key, row, time, is_addition: got.append(
            (int(key), row["q_id"], tuple((int(k), float(s)) for k, s in row["reply"]), time, is_addition)
        ),
    )
    pw.run(
        monitoring_level="none",
        persistence_config=pw.persistence.Config(
            backend=backend, persistence_mode="operator_persisting", snapshot_interval_ms=1
        )
        if backend is not None
        else None,
    )
    pw.G.clear()
    return got


def test_pipeline_restart_restores_index_from_base_plus_deltas(_isolated):
    """Operator-persisted restart with a live index: run 2 restores the
    backend from base + deltas and answers the new queries as an
    uninterrupted run does — the same keys, times and score bits within the
    port, and the reference's keys, times and order."""
    doc_ids = list(range(120))
    streams = {}
    for side in SIDES:
        pw = SIDES[side]["pw"]
        root = f"idxrestart-{side}"
        _backend(side, _isolated, root)
        backend = pw.persistence.Backend("memory", root)
        a1 = _index_session(pw, doc_ids, list(range(4)), backend)
        be = SIDES[side]["mem"](root)
        aux = be.list_keys("operators/aux/")
        assert any("base_" in k for k in aux), aux
        a2 = _index_session(pw, doc_ids + [500, 501], list(range(7)), backend)
        truth = _index_session(pw, doc_ids + [500, 501], list(range(7)), None)
        streams[side] = (a1, a2, truth, aux)
    a1, a2, truth, aux = streams["port"]
    assert {q for _k, q, *_ in a1} == set(range(4))
    cut = max(t for *_, t, _add in a1)
    # within the port: the restart's answers are the uninterrupted run's past
    # the cut, bit for bit (keys, tie order, score bits, times)
    assert a2 == [e for e in truth if e[3] > cut]
    assert {q for _k, q, *_ in a2} == {4, 5, 6}
    # against the reference: keys, query ids, times, additions; scores 1e-6
    for side_run in range(3):
        r, p = streams["ref"][side_run], streams["port"][side_run]
        assert [(e[0], e[1], tuple(k for k, _ in e[2]), e[3], e[4]) for e in p] == [
            (e[0], e[1], tuple(k for k, _ in e[2]), e[3], e[4]) for e in r
        ]
        for er, ep in zip(r, p):
            np.testing.assert_allclose([s for _, s in ep[2]], [s for _, s in er[2]], atol=1e-6, rtol=0)
    # both wrote the index's base chunk (how many delta chunks depends on how
    # many ticks took a millisecond, which follows the host clock)
    for side in SIDES:
        assert any(k.rsplit("/", 1)[1].startswith("base_") for k in streams[side][3])


# ------------------------------------------------------- SIGKILL + restart

_INDEX_PIPELINE = '''
import json
import os
import sys
import time

import numpy as np

import pathway_tpu_torch as pw
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.run import current_runtime

PSTORE = os.environ["PSTORE"]
N_DOCS = int(os.environ["N_DOCS"])
N_CHURN = int(os.environ["N_CHURN"])
N_QUERIES = int(os.environ["N_QUERIES"])
QUERY_SLEEP = float(os.environ["QUERY_SLEEP"])
DIM = 32


def doc_vec(i):
    return np.random.default_rng(1000 + i).normal(size=DIM).astype(np.float32)


def query_vec(i):
    return np.random.default_rng(7000 + i).normal(size=DIM).astype(np.float32)


class Docs(pw.io.python.ConnectorSubject):
    def run(self):
        for i in range(N_DOCS):
            self.next(doc_id=i, kind="main", emb=doc_vec(i))
        for j in range(N_CHURN):
            time.sleep(QUERY_SLEEP * 2)
            self.next(doc_id=100_000 + j, kind="churn", emb=doc_vec(100_000 + j))


class Queries(pw.io.python.ConnectorSubject):
    def run(self):
        time.sleep(0.8)
        for i in range(N_QUERIES):
            self.next(q_id=i, emb=query_vec(i))
            time.sleep(QUERY_SLEEP)


class DocSchema(pw.Schema):
    doc_id: int
    kind: str
    emb: np.ndarray


class QuerySchema(pw.Schema):
    q_id: int
    emb: np.ndarray


docs = pw.io.python.read(Docs(), schema=DocSchema, name="docs")
queries = pw.io.python.read(Queries(), schema=QuerySchema, name="queries")
index = pw.stdlib.indexing.BruteForceKnn(
    docs.emb,
    DIM,
    reserved_space=4096,
    metadata_column=pw.apply_with_type(lambda k: {"kind": k}, dt.ANY, docs.kind),
    device="cpu",
)
replies = index.query_as_of_now(
    queries.emb, number_of_matches=5, metadata_filter="kind == 'main'"
)
joined = replies.select(q_id=queries.q_id, reply=replies["_pw_index_reply"])

answers = {}


def on_change(key, row, time, is_addition):
    if not is_addition:
        return
    answers[row["q_id"]] = [[int(k), float(s)] for (k, s) in row["reply"]]
    if row["q_id"] == N_QUERIES - 1:
        rt = current_runtime()
        if rt is not None:
            rt.request_stop()


pw.io.subscribe(joined, on_change=on_change)
pw.run(
    monitoring_level="none",
    persistence_config=pw.persistence.Config(
        backend=pw.persistence.Backend.filesystem(PSTORE),
        persistence_mode="operator_persisting",
        snapshot_interval_ms=150,
    ),
)
with open(sys.argv[1], "w") as fh:
    json.dump({str(k): v for k, v in answers.items()}, fh)
'''


@pytest.mark.slow
def test_sigkill_restart_live_index_restores_base_plus_deltas(tmp_path):
    """SIGKILL mid-stream with a live index (the port's pipeline in a
    subprocess); the restart from the last committed snapshot restores base +
    deltas and its answers equal an uninterrupted run's; the per-interval
    puts are tiny against the base. The restart runs under the port's
    Supervisor, as the reference's does."""
    import glob as _glob
    import json
    import signal
    import subprocess
    import sys as _sys
    import time as _time

    script = tmp_path / "index_pipeline.py"
    script.write_text(_INDEX_PIPELINE)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    pstore = str(tmp_path / "pstore")
    env = dict(
        os.environ, PYTHONPATH=repo, PSTORE=pstore, N_DOCS="1500", N_CHURN="30",
        N_QUERIES="40", QUERY_SLEEP="0.1",
    )
    out1 = str(tmp_path / "run1.json")
    p = subprocess.Popen([_sys.executable, str(script), out1], env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    manifest_path = os.path.join(pstore, "operators", "manifest")
    deadline = _time.time() + 90
    while _time.time() < deadline:
        if os.path.exists(manifest_path):
            try:
                with open(manifest_path, "rb") as fh:
                    offs = pickle.loads(fh.read())["input_offsets"]
                if offs.get("docs", 0) >= 1500 and offs.get("queries", 0) >= 6:
                    break
            except Exception:
                pass
        _time.sleep(0.03)
    else:
        p.kill()
        raise AssertionError("no covering snapshot before deadline: " + (p.communicate()[0] or ""))
    p.send_signal(signal.SIGKILL)
    p.wait()

    # restart under the Supervisor: resumes from the last committed epoch
    from pathway_tpu_torch.resilience.supervisor import Supervisor

    out2 = str(tmp_path / "run2.json")
    result = Supervisor([_sys.executable, str(script), out2], processes=1, threads=1,
                        max_restarts=1, backoff_s=0.2, env=env,
                        log_dir=str(tmp_path / "logs")).run()
    assert result.restarts == 0, result.attempts
    run2 = {int(k): v for k, v in json.load(open(out2)).items()}
    assert 39 in run2 and len(run2) >= 10

    out3 = str(tmp_path / "truth.json")
    p = subprocess.run([_sys.executable, str(script), out3],
                       env=dict(env, PSTORE=str(tmp_path / "truth_store")),
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stdout + p.stderr
    truth = {int(k): v for k, v in json.load(open(out3)).items()}
    assert len(truth) == 40
    for q, reply in run2.items():
        assert [k for k, _s in reply] == [k for k, _s in truth[q]], (q, reply, truth[q])
        assert all(abs(s - ws) < 1e-5 for (_, s), (_, ws) in zip(reply, truth[q]))

    aux = _glob.glob(os.path.join(pstore, "operators", "aux", "**"), recursive=True)
    bases = [f for f in aux if os.path.basename(f).startswith("base_")]
    deltas = [f for f in aux if os.path.basename(f).startswith("delta_")]
    assert len(bases) == 1, bases
    assert deltas
    base_sz = os.path.getsize(bases[0])
    sizes = sorted(os.path.getsize(f) for f in deltas)
    assert base_sz >= 50 * sizes[len(sizes) // 2], (base_sz, sizes)
    assert sum(sizes) <= base_sz, (base_sz, sizes)
    with open(manifest_path, "rb") as fh:
        assert pickle.loads(fh.read())["gen"] >= 3
