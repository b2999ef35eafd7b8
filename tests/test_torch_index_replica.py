"""Replica-served retrieval in the port (``pathway_tpu_torch/fabric/
index_replica.py``) against the reference's (``tests/test_index_replica.py``).

Units run on both packages with the same inputs (``FakeEmbedder`` vectors,
the same ops) and compare what each observes: the replica index's
apply/search/last-write-wins, gap, frontier, poison and lag semantics, its
self slice and slice install, the route outbox's sequence discipline,
``local_retrieve_response``'s reply (texts, metadata, order and spans
exactly; ``dist`` within 1e-6: the two packages' index backends score in f32
in another order), its fallback sentinels, the lagging replica's recall@10
gate, the embedder memo's pod-wide shared tier and its ``/metrics`` lines,
and the heartbeat ride-along with the retired-peer drop.

The cluster case runs the port alone: a 2-process ``DocumentStoreServer``
fed by a seed table and a churning stream answers ``/v1/retrieve`` from both
doors during the churn, then byte-identically with the peer answering from
its replica, and reports the replica on ``/status`` (the peer's and the
coordinator's rollup) and ``/metrics``. The reference's 3-door case runs
here with 2 doors; its SIGKILL-under-a-Supervisor case (``slow``) is not
mirrored.
"""

from __future__ import annotations

import importlib
import json
import time
import types

import numpy as np
import pytest

import pathway_tpu
import pathway_tpu_torch
import torch_fabric_helpers as tf

PACKAGES = (pathway_tpu, pathway_tpu_torch)


def _mod(pw, name):
    return importlib.import_module(f"{pw.__name__}.{name}")


def _vec_backend(pw):
    eng = _mod(pw, "stdlib.indexing._engine")
    if pw is pathway_tpu_torch:
        return lambda: eng.VectorBackend(dimension=16, device="cpu")
    return lambda: eng.VectorBackend(dimension=16)


def _embed(pw, texts):
    return _mod(pw, "xpacks.llm.mocks").FakeEmbedder(dimension=16).func(list(texts))


def test_fake_embedder_vectors_are_the_references():
    texts = [f"doc {i}" for i in range(6)]
    for a, b in zip(_embed(pathway_tpu, texts), _embed(pathway_tpu_torch, texts)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _hits(hits):
    """(key, score rounded to 1e-6, payload) of a search's triples."""
    return [(k, round(s, 6), r[2] if r else None) for k, s, r in hits]


def _apply_search(pw) -> list:
    rep = _mod(pw, "fabric").ReplicaIndex(_vec_backend(pw))
    vecs = _embed(pw, [f"doc {i}" for i in range(6)])
    rep.apply_ops(1, [("a", i, vecs[i], {"i": i}, f"doc {i}") for i in range(4)], seq=1, ts_unix=100.0)
    rep.apply_ops(2, [("a", i, vecs[i], {"i": i}, f"doc {i}") for i in (4, 5)], seq=1, ts_unix=100.0)
    seen = [len(rep), rep.applied_total, _hits(rep.search_one(vecs[3], 2, lambda md: True))]
    rep.apply_ops(1, [("a", 3, vecs[0], {"i": 30}, "doc 3 v2")], seq=2, ts_unix=101.0)
    seen += [len(rep), rep.rows[3][2]]
    rep.apply_ops(1, [("r", 3)], seq=3, ts_unix=102.0)
    seen += [len(rep), 3 in rep.rows, _hits(rep.search_one(vecs[3], 6, lambda md: True))]
    return seen


def test_replica_index_apply_search_and_last_write_wins():
    ref, got = (_apply_search(pw) for pw in PACKAGES)
    assert got == ref
    assert got[2][0][0] == 3 and got[2][0][1] == pytest.approx(1.0) and got[2][0][2] == "doc 3"
    assert got[5:7] == [5, False] and all(k != 3 for k, _s, _p in got[7])


def _gaps(pw) -> list:
    rep = _mod(pw, "fabric").ReplicaIndex(_vec_backend(pw))
    rep.self_src = 0
    now = time.time()
    seen = [rep.lag_from(0), rep.lag_from(1), rep.remote_lag_s(3)]
    vec = _embed(pw, ["x"])[0]
    rep.apply_ops(1, [("a", 1, vec, None, "x")], seq=1, ts_unix=now)
    seen += [rep.src_gap(1, 5), rep.src_gap(1, 1), rep.src_gap(1, 0)]
    rep.frontier_from(2, 0, now)
    seen += [rep.lag_from(2) is not None, rep.remote_lag_s(3) < 10.0]
    rep.reset_src(1)
    seen.append(rep.src_seq[1])
    rep.poison(1)
    seen += [rep.lag_from(1), rep.remote_lag_s(3)]
    rep.install_slice(1, {1: (vec, None, "x")}, seq=0, ts_unix=time.time())
    seen += [rep.lag_from(1) is not None, rep.resyncs_total]
    return seen


def test_replica_index_gap_reset_frontier_and_lag():
    ref, got = (_gaps(pw) for pw in PACKAGES)
    assert got == ref == [0.0, None, None, True, False, False, True, True, 0, None, None, True, 0]


def _slices(pw) -> list:
    rep = _mod(pw, "fabric").ReplicaIndex(_vec_backend(pw))
    rep.self_src = 0
    vecs = _embed(pw, ["a", "b", "c"])
    rep.apply_ops(0, [("a", 1, vecs[0], None, "a")], seq=None, ts_unix=1.0)
    rep.apply_ops(1, [("a", 2, vecs[1], None, "b")], seq=1, ts_unix=1.0)
    rows, _seq, _ts = rep.self_slice()
    seen = [sorted(rows)]
    rep.install_slice(1, {3: (vecs[2], None, "c")}, seq=4, ts_unix=2.0)
    seen += [sorted(rep.rows), rep.src_seq[1]]
    rep.install_slice(1, {3: (vecs[2], None, "c")}, seq=1, ts_unix=3.0)
    seen.append(rep.src_seq[1])
    return seen


def test_replica_index_self_slice_and_install_slice():
    ref, got = (_slices(pw) for pw in PACKAGES)
    assert got == ref == [[1], [1, 3], 4, 1]


def _outbox(pw) -> list:
    ir = _mod(pw, "fabric.index_replica").IndexRoute("/v1/retrieve", None, 0)
    ir.bind(types.SimpleNamespace(backend_factory=_vec_backend(pw)))
    vec = _embed(pw, ["d"])[0]
    seen = [ir.replica is not None, ir.outbox_pending(), ir.drain_ops()]
    ir.note_ops([("a", 7, vec, None, "d")])
    seen += [ir.outbox_pending(), len(ir.replica)]
    ops, prev, seq = ir.drain_ops()
    seen += [len(ops), prev, seq, ir.drain_ops()]
    ir.bind(types.SimpleNamespace(backend_factory=_vec_backend(pw)))
    seen.append(ir.composite)
    return seen


def test_index_route_outbox_sequence_discipline():
    ref, got = (_outbox(pw) for pw in PACKAGES)
    assert got == ref == [True, False, ([], 0, 0), True, 1, 1, 0, 1, ([], 1, 1), True]


def _armed_route(pw, texts, embedder=None):
    ir_mod = _mod(pw, "fabric.index_replica")
    fake = _mod(pw, "xpacks.llm.mocks").FakeEmbedder
    ir = ir_mod.IndexRoute("/v1/retrieve", embedder or fake(dimension=16), 0)
    ir.bind(types.SimpleNamespace(backend_factory=_vec_backend(pw)))
    vecs = _embed(pw, texts)
    ir.note_ops([("a", i, vecs[i], {"path": f"/d/{i}.md", "i": i}, texts[i]) for i in range(len(texts))])
    return ir


def _replies(pw) -> list:
    local = _mod(pw, "fabric.index_replica").local_retrieve_response
    texts = [f"doc number {i} alpha beta" for i in range(8)]
    ir = _armed_route(pw, texts)
    out = []
    for flt, glob, k in ((None, None, 3), ("i == 2", None, 8), (None, "/d/3.*", 8), ("((", None, 3)):
        body, spans = local(ir, {"query": texts[5], "k": k, "metadata_filter": flt, "filepath_globpattern": glob})
        out.append((json.loads(body), [(s[0], s[3]) for s in spans]))
    return out


def test_local_retrieve_response_shape_order_and_filters():
    ref, got = (_replies(pw) for pw in PACKAGES)
    for (r_body, r_spans), (g_body, g_spans) in zip(ref, got):
        assert g_spans == r_spans
        assert [(d["text"], d["metadata"]) for d in g_body] == [(d["text"], d["metadata"]) for d in r_body]
        np.testing.assert_allclose([d["dist"] for d in g_body], [d["dist"] for d in r_body], atol=1e-6)
    first = got[0][0]
    assert len(first) == 3 and first[0]["text"] == "doc number 5 alpha beta"
    assert first[0]["dist"] == pytest.approx(-1.0)
    assert [d["dist"] for d in first] == sorted(d["dist"] for d in first)
    assert got[0][1] == [("replica/embed", None), ("replica/search", {"rows": 3})]
    assert [d["text"] for d in got[1][0]] == ["doc number 2 alpha beta"]
    assert [d["text"] for d in got[2][0]] == ["doc number 3 alpha beta"]
    assert got[3][0] == []


def _sentinels(pw) -> list:
    ir_mod = _mod(pw, "fabric.index_replica")
    local = ir_mod.local_retrieve_response
    ir = _armed_route(pw, ["alpha", "beta"])
    seen = [local(ir, {"k": 3}), local(ir, {"query": "alpha"}), local(ir, {"query": "alpha", "k": "NaN"})]

    async def aembed(texts):
        return _embed(pw, texts)

    ir_async = ir_mod.IndexRoute("/v1/retrieve", types.SimpleNamespace(func=aembed), 0)
    ir_async.bind(types.SimpleNamespace(backend_factory=_vec_backend(pw)))
    ir_async.note_ops([("a", 0, _embed(pw, ["alpha"])[0], None, "alpha")])
    seen.append(local(ir_async, {"query": "alpha", "k": 1}))
    ir2 = _armed_route(pw, ["gamma"])
    ir2.replica.rows[0] = (ir2.replica.rows[0][0], None, None, 0)
    seen.append(local(ir2, {"query": "gamma", "k": 1}))
    ir3 = _armed_route(pw, ["delta"])
    ir3.composite = True
    seen.append(local(ir3, {"query": "delta", "k": 1}))
    return seen


def test_local_retrieve_response_fallback_sentinels():
    ref, got = (_sentinels(pw) for pw in PACKAGES)
    assert got == ref == [None] * 6


def _recall(pw) -> list:
    rep_cls = _mod(pw, "fabric").ReplicaIndex
    n, missing, k = 160, 4, 10
    texts = [f"corpus doc {i} " + " ".join(f"w{(i * 7 + j) % 53}" for j in range(6)) for i in range(n)]
    vecs = _embed(pw, texts)
    full, lagging = rep_cls(_vec_backend(pw)), rep_cls(_vec_backend(pw))
    full.apply_ops(0, [("a", i, vecs[i], None, texts[i]) for i in range(n)], seq=1, ts_unix=1.0)
    lagging.apply_ops(0, [("a", i, vecs[i], None, texts[i]) for i in range(n - missing)], seq=1, ts_unix=1.0)
    recalls = []
    for qv in _embed(pw, [f"query {q} w{q % 53} w{(q * 3) % 53}" for q in range(25)]):
        want = {key for key, _s, _r in full.search_one(qv, k, lambda md: True)}
        got = {key for key, _s, _r in lagging.search_one(qv, k, lambda md: True)}
        recalls.append(len(want & got) / k)
    return recalls


def test_lagging_replica_recall_at_10_gate():
    ref, got = (_recall(pw) for pw in PACKAGES)
    assert got == ref
    assert sum(got) / len(got) >= 0.95, got


def test_memo_share_drain_apply_counters_and_no_echo():
    from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder

    a = SentenceTransformerEmbedder("tiny", seed=123, memoize=8, device="cpu")
    b = SentenceTransformerEmbedder("tiny", seed=123, memoize=8, device="cpu")
    assert a.memo_fingerprint == b.memo_fingerprint
    texts = [f"shared query {i}" for i in range(3)]
    want = a.func(list(texts))
    entries = a.drain_shared_out()
    assert a.memo_shared_out == 3
    assert sorted(t for t, _v in entries) == sorted(texts)
    assert a.drain_shared_out() == []
    assert b.apply_shared(entries) == 3 and b.memo_shared_in == 3
    got = b.func(list(texts))
    assert all(np.array_equal(w, g) for w, g in zip(want, got))
    assert b.memo_hits == 3 and b.memo_misses == 0
    assert b.drain_shared_out() == []  # no echo
    local = b.func(["only mine"])
    b.apply_shared([("only mine", [0.0] * len(local[0]))])
    assert np.array_equal(b.func(["only mine"])[0], local[0])
    a.func([f"churn {i} text" for i in range(12)])
    assert a.memo_evictions > 0 and len(a._memo) <= 8


def test_memo_module_api_stats_and_prometheus_lines():
    """The module API and the ``/metrics`` series are the reference's."""
    keys = {}
    lines = {}
    for pw in PACKAGES:
        emb_mod = _mod(pw, "xpacks.llm.embedders")
        kw = {"device": "cpu"} if pw is pathway_tpu_torch else {}
        a = emb_mod.SentenceTransformerEmbedder("tiny", seed=321, memoize=16, **kw)
        b = emb_mod.SentenceTransformerEmbedder("tiny", seed=321, memoize=16, **kw)
        a.func(["module share alpha", "module share beta"])
        shared = emb_mod.drain_shared_memo()
        ours = shared[a.memo_fingerprint]
        assert {t for t, _v in ours} >= {"module share alpha", "module share beta"}
        assert emb_mod.apply_shared_memo(a.memo_fingerprint, ours) >= 2
        b.func(["module share alpha"])
        assert b.memo_hits == 1 and b.memo_misses == 0
        stats = {s["fingerprint"]: s for s in emb_mod.memo_stats()}
        keys[pw.__name__] = sorted(stats[b.memo_fingerprint])
        lines[pw.__name__] = sorted({ln.split("{")[0] for ln in emb_mod.memo_prometheus_lines()})
    assert keys["pathway_tpu_torch"] == keys["pathway_tpu"]
    assert lines["pathway_tpu_torch"] == lines["pathway_tpu"]
    assert "pathway_embedder_memo_hit_ratio" in lines["pathway_tpu_torch"]


def _heartbeat(pw) -> list:
    hb = _mod(pw, "resilience.heartbeat")
    monitor = hb.HeartbeatMonitor(n_proc=2, port=0, timeout=30.0)
    block = {"/v1/retrieve": {"rows": 42, "lag_s": 0.5, "local": 7, "fallbacks": 1, "gaps": 0, "resyncs": 0}}
    client = hb.HeartbeatClient(pid=1, port=monitor.port, interval=0.05)
    client.summary_fn = lambda: {"replica_index": block}
    try:
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and not monitor.peer_replica_index():
            time.sleep(0.05)
        seen = [monitor.peer_replica_index()]
        monitor.retire_peer(1)
        seen += [monitor.peer_replica_index(), monitor.dead_peer()]
        return seen
    finally:
        client.goodbye()
        monitor.close()


def test_heartbeat_peer_replica_index_and_retired_drop():
    ref, got = (_heartbeat(pw) for pw in PACKAGES)
    assert got == ref
    assert got[0] == {1: {"/v1/retrieve": {"rows": 42, "lag_s": 0.5, "local": 7, "fallbacks": 1, "gaps": 0,
                                           "resyncs": 0}}}
    assert got[1:] == [{}, None]


def test_replica_arms_only_on_a_fabric_cluster(monkeypatch):
    """``maybe_arm`` returns None unless a cluster runs with the fabric and
    the replica plane on, in both packages."""
    store = types.SimpleNamespace(retriever_factory=types.SimpleNamespace(embedder=None))
    for env, armed in (({}, False), ({"PATHWAY_FABRIC": "on"}, False),
                       ({"PATHWAY_FABRIC": "on", "PATHWAY_PROCESSES": "2"}, True)):
        for k in ("PATHWAY_FABRIC", "PATHWAY_PROCESSES"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        for pw in PACKAGES:
            got = _mod(pw, "fabric.index_replica").maybe_arm("/v1/retrieve", store)
            assert (got is not None) == armed, (pw.__name__, env)


def test_replica_two_door_byte_identity_under_churn(tmp_path):
    got = tf.run("store", tmp_path, 2, {"PATHWAY_FABRIC": "on", "PATHWAY_REPLICA_MAX_STALENESS_MS": "2000"})
    assert all(s == 200 for s, _src, _lag in got["during"]), got["during"]
    for _s, _src, lag in got["during"]:
        assert lag is None or float(lag) <= 2000.0
    assert got["settled"] is not None, "the doors never answered alike with the peer local"
    for row in got["settled"]:
        assert len({b for _s, b, _f in row}) == 1
        assert row[1][2].startswith("replica:p1")
    peer = got["peer_status"]["fabric"]["index"]["/v1/retrieve"]
    assert peer["armed"] is True and peer["rows"] == 60
    assert peer["local_answers"] >= 1 and peer["lag_s"] is not None and peer["lag_s"] <= 2.0
    rollup = got["status"]["cluster"]["replica_index"]["/v1/retrieve"]
    assert rollup["doors"] == 2 and rollup["rows_min"] == 60
    for series in ("pathway_replica_lag_seconds", "pathway_replica_index_rows",
                   "pathway_replica_local_answers_total", "pathway_replica_fallback_total",
                   "pathway_replica_gaps_total", "pathway_replica_resyncs_total"):
        assert f'{series}{{route="/v1/retrieve"}}' in got["peer_metrics"], series
