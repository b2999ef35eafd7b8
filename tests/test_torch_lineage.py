"""The port's row lineage (``pathway_tpu_torch/observability/lineage.py``) and
the monitoring server's ``/explain`` against the reference's, on the same
pipelines.

Mirrors ``tests/test_lineage.py`` case by case: the same pipeline runs under
both packages, one sink row is explained on each side, and the payloads are
equal — sink, key, output row, operator path (operator, id, keys,
``derives_keys``) and contributing inputs (input, key, row, tick). Span ids
are random per run, so they are checked for presence, not compared; the
embed → KNN → rerank chain runs the tiny encoder of
``tests/test_torch_device_plane.py`` with the reference's weights, and its
score is compared within 1e-5. Also: the bounded rings evict alike, and the
``/explain`` error payloads are equal.

Left out of the reference's file: nothing but its module docstring's
``pathway_tpu explain`` command line (``cli.py``, ROADMAP Queue 1 item 7),
which has no test there.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pathway_tpu
import pathway_tpu_torch
from pathway_tpu.internals import monitoring as ref_mon
from pathway_tpu.observability import lineage as ref_lineage
from pathway_tpu_torch import convert
from pathway_tpu_torch.internals import monitoring as port_mon
from pathway_tpu_torch.observability import lineage as port_lineage
from torch_http_helpers import free_port, release_port

SIDES = {
    "ref": (pathway_tpu, ref_lineage, ref_mon),
    "port": (pathway_tpu_torch, port_lineage, port_mon),
}

#: the tiny encoder of tests/test_torch_device_plane.py
TINY = dict(vocab_size=997, d_model=96, n_heads=3, n_layers=1, d_ff=192, max_len=64)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in ("PATHWAY_AUDIT", "PATHWAY_LINEAGE_KEYS", "PATHWAY_TRACE", "PATHWAY_MONITORING_HTTP_PORT"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("PATHWAY_TIMELINE", "off")
    for pw, *_ in SIDES.values():
        pw.G.clear()
    yield
    for pw, *_ in SIDES.values():
        pw.G.clear()


def _comparable(doc: dict) -> dict:
    """An explain payload without its wall clock and its random span ids."""
    doc = dict(doc)
    doc.pop("t_unix", None)
    if doc.get("output"):
        doc["output"] = {k: v for k, v in doc["output"].items() if k != "span_id"}
    doc["inputs"] = [{k: v for k, v in i.items() if k != "span_id"} for i in doc.get("inputs", [])]
    return doc


def _run_and_explain(pw, lineage, key=None):
    """Run the registered pipeline, then explain one live sink row offline
    (the store and graph survive the run): the first key of the first sink
    ring, or ``key``."""
    pw.run(monitoring_level="none")
    store = lineage.current()
    assert store is not None
    store.fold()  # hot path only parks; reads fold (as /explain does)
    rt = pw.internals.run.current_runtime()
    sink = sorted(store.sinks)[0]
    if key is None:
        key = next(iter(store.sinks[sink].data))
    return store.explain(rt.scheduler, sink, key), store, sink


def _groupby(pw):
    t = pw.debug.table_from_rows(pw.schema_from_types(x=int), [(i, i // 8, 1) for i in range(32)], is_stream=True)
    t = t.with_columns(m=t.x % 3)
    g = t.groupby(t.m).reduce(s=pw.reducers.sum(t.x))
    pw.io.subscribe(g, on_change=lambda **k: None)


def test_explain_groupby_pipeline_reports_inputs_and_path():
    out = {}
    for name, (pw, lineage, _mon) in SIDES.items():
        _groupby(pw)
        doc, store, sink = _run_and_explain(pw, lineage)
        assert doc["ok"] and doc["sink"] == sink
        out[name] = (_comparable(doc), store.status_summary())
    assert out["port"] == out["ref"]
    doc = out["port"][0]
    ops = [p["operator"] for p in doc["path"]]
    assert "groupby" in ops and "subscribe" in ops
    gb = next(p for p in doc["path"] if p["operator"] == "groupby")
    assert gb["derives_keys"]  # the group key maps back to input row keys
    assert doc["output"] is not None and "s" in doc["output"]["row"]
    # the walk bottomed out at the input connector with actual row values
    assert doc["inputs"]
    assert all("x" in i["row"] and i["tick"] is not None for i in doc["inputs"])


def test_explain_join_pipeline_reaches_both_sides():
    out = {}
    for name, (pw, lineage, _mon) in SIDES.items():
        left = pw.debug.table_from_rows(pw.schema_from_types(k=int, v=int), [(1, 10, 0, 1), (2, 20, 0, 1)],
                                        is_stream=True)
        right = pw.debug.table_from_rows(pw.schema_from_types(k=int, name=str), [(1, "a", 0, 1), (2, "b", 0, 1)],
                                         is_stream=True)
        j = left.join(right, left.k == right.k).select(v=left.v, name=right.name)
        pw.io.subscribe(j, on_change=lambda **k: None)
        doc, _store, _sink = _run_and_explain(pw, lineage)
        assert doc["ok"]
        out[name] = _comparable(doc)
    assert out["port"] == out["ref"]
    doc = out["port"]
    jn = next(p for p in doc["path"] if p["operator"].startswith("join"))
    assert jn["derives_keys"]
    # contributing rows from BOTH input connectors
    cols = set()
    for i in doc["inputs"]:
        cols.update(i["row"].keys())
    assert {"v", "name"} <= cols, doc["inputs"]


def test_explain_flatten_and_salted_concat_edges():
    """The other key-deriving edges: flatten and a salted concat (a reindex
    of two tables' rows)."""
    out = {}
    for name, (pw, lineage, _mon) in SIDES.items():
        t = pw.debug.table_from_rows(pw.schema_from_types(k=int, w=str),
                                     [(i, f"a{i} b{i} c", i // 2, 1) for i in range(6)], is_stream=True)
        f = t.select(k=t.k, parts=pw.apply(lambda s: tuple(s.split()), t.w)).flatten(pw.this.parts)
        u = pw.debug.table_from_rows(pw.schema_from_types(k=int, w=str), [(9, "z", 0, 1)], is_stream=True)
        c = f.select(k=f.k, w=f.parts).concat_reindex(u)
        pw.io.subscribe(c, on_change=lambda **k: None)
        pw.run(monitoring_level="none")
        store = lineage.current()
        store.fold()
        rt = pw.internals.run.current_runtime()
        sink = sorted(store.sinks)[0]
        docs = [_comparable(store.explain(rt.scheduler, sink, k)) for k in sorted(store.sinks[sink].data)]
        out[name] = docs
    assert out["port"] == out["ref"]
    derived = {p["operator"] for d in out["port"] for p in d["path"] if p["derives_keys"]}
    assert any(op.startswith("flatten") for op in derived), derived
    assert len(out["port"]) == 19 and all(d["inputs"] for d in out["port"])


def test_explain_live_endpoint_with_span_ids(monkeypatch):
    """``/explain`` on the monitoring server during a run with tracing on:
    the sink listing, then one group's row once every row has arrived.
    The payloads are equal but for their ticks (a live subject's rows land
    in wall-clock ticks); each side's inputs carry their tick span ids."""
    monkeypatch.setenv("PATHWAY_TRACE", "on")
    out = {}
    for name, (pw, lineage, _mon) in SIDES.items():
        port = free_port()
        release_port(port)
        monkeypatch.setenv("PATHWAY_MONITORING_HTTP_PORT", str(port))
        done = threading.Event()
        latest: dict = {}

        class Subj(pw.io.python.ConnectorSubject):
            def run(self):
                for i in range(120):
                    self.next(x=i)
                    if i % 10 == 9:
                        time.sleep(0.04)
                done.wait(30)

        pw.G.clear()
        t = pw.io.python.read(Subj(), schema=pw.schema_from_types(x=int))
        t = t.with_columns(m=t.x % 3)
        g = t.groupby(t.m).reduce(m=pw.this.m, s=pw.reducers.sum(t.x))
        pw.io.subscribe(g, on_change=lambda key, row, time, is_addition: latest.update({row["m"]: (key, row["s"])})
                        if is_addition else None)
        got: dict = {}

        def probe(port=port, latest=latest, done=done, got=got):
            try:
                base = f"http://127.0.0.1:{port}/explain"
                deadline = time.monotonic() + 30.0
                while time.monotonic() < deadline:
                    totals = {m: s for m, (_k, s) in latest.items()}
                    if totals == {m: sum(range(m, 120, 3)) for m in range(3)}:
                        break
                    time.sleep(0.02)
                got["listing"] = json.loads(urllib.request.urlopen(base, timeout=5).read())
                key = latest[1][0]
                sink = got["listing"]["sinks"][0]
                got["doc"] = json.loads(urllib.request.urlopen(f"{base}?sink={sink}&key={key}", timeout=5).read())
            except Exception as e:  # surfaced by the asserts below
                got["error"] = repr(e)
            finally:
                done.set()

        th = threading.Thread(target=probe)
        th.start()
        pw.run(with_http_server=True, monitoring_level="none")
        th.join()
        assert "error" not in got, (name, got)
        assert got["listing"]["ok"] is False and got["listing"]["sinks"]  # missing sink= lists the sinks
        doc = got["doc"]
        assert doc["ok"], (name, doc)
        # with tracing on, ingested rows carry their tick's span id
        assert doc["inputs"] and all(i["span_id"] for i in doc["inputs"]), (name, doc["inputs"])
        doc = _comparable(doc)
        doc["output"].pop("tick")
        for i in doc["inputs"]:
            assert isinstance(i.pop("tick"), int), (name, i)
        out[name] = (got["listing"], doc)
    assert out["port"] == out["ref"]
    assert len(out["port"][1]["inputs"]) == 8  # a group's first 8 contributors


def _tiny_models():
    from pathway_tpu.ops.encoder import EncoderConfig as JConfig
    from pathway_tpu.xpacks.llm.embedders import SentenceTransformerEmbedder as JEmbedder
    from pathway_tpu_torch.ops.encoder import EncoderConfig as TConfig
    from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder as TEmbedder

    j_emb = JEmbedder(JConfig(**TINY, dtype=jnp.float32), seed=0)
    params = convert.params_from_numpy(jax.tree.map(np.asarray, j_emb._encoder.params), "cpu")
    t_emb = TEmbedder(TConfig(**TINY, dtype=torch.float32), params=params, device="cpu")
    return {"ref": j_emb, "port": t_emb}


def test_explain_chain_embed_knn_rerank_demo(monkeypatch):
    """``/explain`` returns the full provenance path for a live row of the
    embed → KNN → rerank demo pipeline, on the tiny encoder with the
    reference's weights on both sides."""
    monkeypatch.setenv("PATHWAY_TRACE", "on")
    embedders = _tiny_models()
    docs = [f"document number {i} about topic {i % 3}" for i in range(12)]
    out = {}
    for name, (pw, lineage, _mon) in SIDES.items():
        emb = embedders[name]
        dev = {"device": "cpu"} if pw is pathway_tpu_torch else {}
        doc_t = pw.debug.table_from_rows(pw.schema_from_types(text=str), [(d,) for d in docs])
        index = pw.stdlib.indexing.BruteForceKnnFactory(embedder=emb, **dev).build_index(doc_t.text, doc_t)
        q_t = pw.debug.table_from_rows(pw.schema_from_types(qi=int, q=str),
                                       [(i, docs[i], i // 4, 1) for i in range(8)], is_stream=True)
        picked = index.query_as_of_now(q_t.q, number_of_matches=1).select(
            qi=pw.left.qi, q=pw.left.q, top=pw.apply(lambda ts: ts[0] if ts else "", pw.right.text),
        )
        rr = pw.xpacks.llm.rerankers.EncoderReranker(emb)
        scored = picked.select(picked.qi, picked.top, score=rr(picked.top, picked.q))
        seen: dict = {}
        pw.io.subscribe(scored, on_change=lambda key, row, time, is_addition: seen.update({key: row}))
        pw.run(monitoring_level="none")
        assert seen, f"{name}: demo pipeline produced no output"
        store = lineage.current()
        store.fold()
        rt = pw.internals.run.current_runtime()
        sink = sorted(store.sinks)[0]
        # explain a LIVE output row (one the subscriber actually delivered)
        key = min(k for k in seen if k in store.sinks[sink].data)
        doc = store.explain(rt.scheduler, sink, key)
        assert doc["ok"], name
        # originating trace span ids ride along (PATHWAY_TRACE=on)
        assert any(i["span_id"] for i in doc["inputs"]) or doc["output"]["span_id"], name
        out[name] = _comparable(doc)
        pw.G.clear()
    ref, port = out["ref"], out["port"]
    score_r, score_p = ref["output"]["row"].pop("score"), port["output"]["row"].pop("score")
    assert abs(score_p - score_r) <= 1e-5
    assert port == ref
    ops = [p["operator"] for p in port["path"]]
    assert "subscribe" in ops and len(ops) >= 3, ops  # a real operator chain, not a stub
    # provenance bottoms out at the query input with the actual query row
    assert any("q" in i["row"] for i in port["inputs"]), port["inputs"]


def test_lineage_ring_bounded_eviction():
    out = {}
    for name, (_pw, lineage, _mon) in SIDES.items():
        ring = lineage._Ring(cap=128)
        for i in range(1000):
            ring.add(i, i + 1)
        ring2 = lineage._Ring(cap=4)
        for i in range(50):
            ring2.add(7, i)
        for i in range(8):
            ring2.put(i, (i, "row"))
        out[name] = (list(ring.data.items()), list(ring2.data.items()), lineage._MAX_CONTRIB)
    assert out["port"] == out["ref"]
    items, _small, cap = out["port"]
    assert len(items) <= 128 and items[-1][0] == 999  # newest survive
    assert all(len(v) <= cap for _k, v in out["port"][1])


def test_parked_log_bounds_rows_and_keeps_the_newest():
    out = {}
    for name, (_pw, lineage, _mon) in SIDES.items():
        log = lineage._ParkedLog(100)
        for i in range(40):
            log.park((i,), 7)
        out[name] = (log.rows, [rec for rec, _n in log.items])
    assert out["port"] == out["ref"]
    assert out["port"][0] <= 100 and out["port"][1][-1] == (39,)


def test_lineage_disabled_with_zero_cap(monkeypatch):
    from pathway_tpu.observability import audit as ref_audit
    from pathway_tpu_torch.observability import audit as port_audit

    monkeypatch.setenv("PATHWAY_LINEAGE_KEYS", "0")
    for (pw, lineage, _mon), audit in zip(SIDES.values(), (ref_audit, port_audit)):
        pw.G.clear()
        t = pw.debug.table_from_rows(pw.schema_from_types(x=int), [(1,), (2,)])
        pw.io.subscribe(t, on_change=lambda **k: None)
        pw.run(monitoring_level="none")
        assert lineage.current() is None
        # the audit monitors stay live even with lineage off
        assert audit.current() is not None


def test_explain_payload_errors():
    out = {}
    for name, (pw, _lineage, mon) in SIDES.items():
        pw.G.clear()
        t = pw.debug.table_from_rows(pw.schema_from_types(x=int), [(1,)])
        pw.io.subscribe(t, on_change=lambda **k: None)
        pw.run(monitoring_level="none")
        rt = pw.internals.run.current_runtime()
        out[name] = [json.loads(mon._explain_payload(rt, q)) for q in ("sink=nope&key=1", "sink=subscribe", "")]
    assert out["port"] == out["ref"]
    unknown, no_key, no_sink = out["port"]
    assert unknown["ok"] is False and "unknown sink" in unknown["error"]
    assert no_key["ok"] is False and "key" in no_key["error"]
    assert no_sink["ok"] is False and no_sink["sinks"]


def test_explain_payload_with_lineage_off(monkeypatch):
    monkeypatch.setenv("PATHWAY_AUDIT", "off")
    out = {}
    for name, (pw, _lineage, mon) in SIDES.items():
        pw.G.clear()
        t = pw.debug.table_from_rows(pw.schema_from_types(x=int), [(1,)])
        pw.io.subscribe(t, on_change=lambda **k: None)
        pw.run(monitoring_level="none")
        out[name] = json.loads(mon._explain_payload(pw.internals.run.current_runtime(), "sink=subscribe&key=1"))
    assert out["port"] == out["ref"] == {
        "ok": False, "error": "lineage is off (PATHWAY_AUDIT=off or PATHWAY_LINEAGE_KEYS=0)"}
