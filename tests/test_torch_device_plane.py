"""The port's device-profiling plane (``pathway_tpu_torch/observability/
device.py``) against the reference's, on the same inputs.

Mirrors the single-process cases of ``tests/test_device_profiling.py``. The
same RAG pipeline (``tools/rag_pipeline.py``) runs through both packages and
the plane's deterministic output is compared exactly: per-callable calls,
cold-shape counts, pad rows and tokens, FLOPs and registered component
bytes. Compile counts are not compared: the reference counts XLA compiles,
the port counts its kernel builds (``note_build``), and neither side's
compiles exist on the other. Cold-shape counts are compared for the
callables that launch at the reference's shapes; ``knn.scatter`` is not one
of them (the port does not pad a scatter block to a power-of-two bucket, a
bound that only served XLA's compile cache). Also covered: the flight
recorder, the recompile-storm alert, weak registration, the ``full`` mode
split, off mode, the ``/profile`` window (``torch.profiler`` on CPU
tensors) and the ``/status`` device section. Times are never compared.

Reference runs set ``PATHWAY_AUDIT=off`` and ``PATHWAY_TIMELINE=off`` (the
port has neither plane yet) through ``monkeypatch``, which both packages
read.
"""

from __future__ import annotations

import gc
import json
import os
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pathway_tpu
import pathway_tpu_torch
from pathway_tpu.debug import _capture as capture_ref
from pathway_tpu.internals import monitoring as ref_mon
from pathway_tpu.observability import alerts as ref_alerts
from pathway_tpu.observability import device as ref_dev
from pathway_tpu.ops import encoder as ref_enc
from pathway_tpu.ops import knn as ref_knn
from pathway_tpu.ops.microbatch import MicrobatchDispatcher as RefDispatcher
from pathway_tpu_torch import convert
from pathway_tpu_torch.debug import _capture as capture_port
from pathway_tpu_torch.internals import monitoring as port_mon
from pathway_tpu_torch.observability import alerts as port_alerts
from pathway_tpu_torch.observability import device as port_dev
from pathway_tpu_torch.ops import encoder as port_enc
from pathway_tpu_torch.ops import knn as port_knn
from pathway_tpu_torch.ops.microbatch import MicrobatchDispatcher as PortDispatcher
from pathway_tpu_torch.tools import rag_pipeline
from torch_http_helpers import free_port, release_port

#: a config no other test file uses: the cold-shape keys below include it, so
#: the counts do not depend on what ran earlier in this process
TINY = dict(vocab_size=997, d_model=96, n_heads=3, n_layers=1, d_ff=192, max_len=64)


class _RT:
    scheduler = None
    monitoring_server = None


@pytest.fixture(autouse=True)
def _planes(monkeypatch):
    for k in (
        "PATHWAY_PROFILE",
        "PATHWAY_PROFILE_DIR",
        "PATHWAY_PROFILE_SHAPE_WARN",
        "PATHWAY_FLIGHT_DIR",
    ):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("PATHWAY_AUDIT", "off")
    monkeypatch.setenv("PATHWAY_TIMELINE", "off")
    ref_dev.install_from_env()
    port_dev.install_from_env()
    yield
    ref_dev.shutdown()
    port_dev.shutdown()


def _counts(dev) -> dict[str, tuple[int, int]]:
    return {
        label: (v["calls"] or 0, v["cold_calls"])
        for label, v in dev._callables_view().items()
    }


def _delta(after: dict, before: dict) -> dict:
    out = {}
    for label, (calls, cold) in after.items():
        c0, k0 = before.get(label, (0, 0))
        if (calls - c0, cold - k0) != (0, 0):
            out[label] = (calls - c0, cold - k0)
    return out


def _docs(n, words=30, seed=0):
    rng = np.random.default_rng(seed)
    vocab = [f"term{i}" for i in range(200)]
    return [" ".join(rng.choice(vocab, size=words)) for _ in range(n)]


# ------------------------------------------------ the pipeline, both packages


def test_rag_pipeline_device_accounting_matches_reference(monkeypatch):
    """Embed → index → as-of-now search → rerank on both packages: the
    plane's per-callable calls and cold shapes, pad rows and tokens, FLOPs
    and registered bytes are equal."""
    from pathway_tpu.ops.encoder import EncoderConfig as JConfig
    from pathway_tpu.stdlib.indexing import BruteForceKnnFactory as JFactory
    from pathway_tpu.xpacks.llm.embedders import SentenceTransformerEmbedder as JEmbedder
    from pathway_tpu.xpacks.llm.rerankers import CrossEncoderReranker as JReranker
    from pathway_tpu_torch.ops.encoder import EncoderConfig as TConfig
    from pathway_tpu_torch.stdlib.indexing import BruteForceKnnFactory as TFactory
    from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder as TEmbedder
    from pathway_tpu_torch.xpacks.llm.rerankers import CrossEncoderReranker as TReranker

    monkeypatch.setenv("PATHWAY_MICROBATCH", "auto")
    monkeypatch.setenv("PATHWAY_MICROBATCH_MAX_BATCH", "32")
    monkeypatch.setenv("PATHWAY_MICROBATCH_FLUSH_MS", "60000")
    docs = _docs(96)
    queries = docs[:12]

    def to_torch(params):
        return convert.params_from_numpy(jax.tree.map(np.asarray, params), "cpu")

    out = {}
    for name, pw, dev in (("ref", pathway_tpu, ref_dev), ("port", pathway_tpu_torch, port_dev)):
        pw.G.clear()
        if pw is pathway_tpu:
            emb = JEmbedder(JConfig(**TINY, dtype=jnp.float32), seed=0)
            rr = JReranker(JConfig(**TINY, dtype=jnp.float32), seed=1)
            factory, capture = JFactory(embedder=emb), capture_ref
            j_emb, j_rr = emb, rr
        else:
            emb = TEmbedder(TConfig(**TINY, dtype=torch.float32), params=to_torch(j_emb._encoder.params), device="cpu")
            rr = TReranker(TConfig(**TINY, dtype=torch.float32), params=to_torch(j_rr._model.params), device="cpu")
            factory, capture = TFactory(embedder=emb, device="cpu"), capture_port
        before = _counts(dev)
        rows = capture(
            rag_pipeline.build(
                pw, embedder=emb, index_factory=factory, reranker=rr,
                docs=docs, queries=queries, tick_rows=16, k=5,
            )
        ).rows
        summary = dev.status_summary()
        out[name] = {
            "rows": len(rows),
            "counts": _delta(_counts(dev), before),
            "pad": summary["pad"],
            "flops": summary["flops"]["by_label"],
            "memory": dev.memory_components(),
        }
        pw.G.clear()
    ref, port = out["ref"], out["port"]
    assert port["rows"] == ref["rows"] == len(queries) * 5  # k hits a query
    # every traced callable the reference dispatched, the port dispatched as
    # often; cold shapes too where the launch shapes are the reference's
    assert {k: v[0] for k, v in port["counts"].items()} == {k: v[0] for k, v in ref["counts"].items()}
    same_shapes = {k for k in ref["counts"] if k.startswith(("encoder.", "reranker.", "knn.search", "udf:"))}
    assert same_shapes, ref["counts"]
    assert {k: port["counts"][k][1] for k in same_shapes} == {k: ref["counts"][k][1] for k in same_shapes}
    assert port["pad"] == ref["pad"]
    assert port["flops"] == ref["flops"]
    for comp in ("encoder_params", "reranker_params"):
        assert port["memory"][comp] == ref["memory"][comp] > 0


# --------------------------------------------------------- unit-level parity


def _registered(dev, component: str) -> int:
    return dev.memory_components().get(component, 0)


def test_encoder_token_pad_flops_and_params_bytes_match():
    gc.collect()
    r0, p0 = _registered(ref_dev, "encoder_params"), _registered(port_dev, "encoder_params")
    jenc = ref_enc.JaxSentenceEncoder(ref_enc.EncoderConfig(**TINY))
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jenc.params), "cpu")
    tenc = port_enc.TorchSentenceEncoder(port_enc.EncoderConfig(**TINY), params=tp, device="cpu")
    texts = ["hello world", "a much longer sentence with many words here"]
    jenc.encode_texts(texts)
    tenc.encode_texts(texts)
    r, p = ref_dev.status_summary(), port_dev.status_summary()
    assert p["pad"]["encoder"] == r["pad"]["encoder"]
    assert p["pad"]["encoder"]["pad_tokens"] > 0
    assert p["flops"]["by_label"]["encoder"] == r["flops"]["by_label"]["encoder"] > 0
    # the bytes each new encoder registered (other live encoders excluded)
    assert _registered(port_dev, "encoder_params") - p0 == _registered(ref_dev, "encoder_params") - r0
    assert _registered(port_dev, "encoder_params") - p0 == tenc.param_bytes() > 0


def test_knn_bytes_flops_and_pad_rows_match():
    rng = np.random.default_rng(0)
    vecs = rng.standard_normal((10, 16)).astype(np.float32)
    gc.collect()
    r0, p0 = _registered(ref_dev, "knn_index"), _registered(port_dev, "knn_index")
    rc0, pc0 = _counts(ref_dev), _counts(port_dev)
    rix = ref_knn.BruteForceKnnIndex(dimension=16, capacity=64)
    pix = port_knn.BruteForceKnnIndex(dimension=16, capacity=64, device="cpu")
    for i in range(10):
        rix.add(i, vecs[i])
        pix.add(i, vecs[i])
    q = np.zeros((2, 16), np.float32)
    assert rix.search(q, k=3) == pix.search(q, k=3)
    r, p = ref_dev.status_summary(), port_dev.status_summary()
    assert pix.device_bytes() == rix.device_bytes()
    assert _registered(port_dev, "knn_index") - p0 == _registered(ref_dev, "knn_index") - r0 == pix.device_bytes()
    assert p["flops"]["by_label"]["knn.search"] == r["flops"]["by_label"]["knn.search"]
    cap = pix.capacity
    assert cap == rix.capacity
    assert p["pad"]["knn.search"] == r["pad"]["knn.search"] == {
        "real_rows": 10, "pad_rows": cap - 10, "row_waste_ratio": round((cap - 10) / cap, 4),
    }
    # the search, its packed fetch and the scatter ran as often on both sides
    # (counts are process-lifetime: compare what this test added)
    rd, pd = _delta(_counts(ref_dev), rc0), _delta(_counts(port_dev), pc0)
    for label in ("knn.search", "knn.pack_hits", "knn.scatter"):
        assert pd[label][0] == rd[label][0] >= 1
    text_r, text_p = ref_mon.prometheus_text(_RT()), port_mon.prometheus_text(_RT())
    assert f'pathway_device_bytes{{component="knn_index"}} {_registered(port_dev, "knn_index")}' in text_p
    assert f'pathway_device_bytes{{component="knn_index"}} {_registered(ref_dev, "knn_index")}' in text_r


def test_dispatcher_pad_rows_and_prometheus_lines_match():
    for D in (RefDispatcher, PortDispatcher):
        D(lambda items: items, max_batch=64, label="padtest").map(list(range(5)))
    r = ref_dev.status_summary()["pad"]["udf:padtest"]
    p = port_dev.status_summary()["pad"]["udf:padtest"]
    assert p == r == {"real_rows": 5, "pad_rows": 3, "row_waste_ratio": round(3 / 8, 4)}
    lines = lambda dev: [ln for ln in dev.prometheus_lines() if "padtest" in ln]  # noqa: E731
    assert lines(port_dev) == lines(ref_dev)
    assert 'pathway_pad_rows_total{udf="udf:padtest",kind="pad"} 3' in lines(port_dev)


def test_bucketed_dispatch_keeps_the_reference_shape_set(monkeypatch):
    monkeypatch.setenv("PATHWAY_PROFILE_SHAPE_WARN", "6")
    ref_dev.install_from_env()
    port_dev.install_from_env()
    views = []
    for D, dev in ((RefDispatcher, ref_dev), (PortDispatcher, port_dev)):
        calls = []

        def batch_fn(items, calls=calls):
            calls.append(len(items))
            return [v * 2 for v in items]

        d = D(batch_fn, max_batch=128, label="bucketed")
        for n in (1, 3, 5, 9, 17, 33, 50, 64, 100, 2, 7):
            assert d.map(list(range(n))) == [v * 2 for v in range(n)]
        views.append((calls, dev.status_summary()["callables"]["udf:bucketed"]))
    (rc, rv), (pc, pv) = views
    assert pc == rc
    assert {k: pv[k] for k in ("calls", "cold_calls", "shapes", "storm")} == {
        k: rv[k] for k in ("calls", "cold_calls", "shapes", "storm")
    }


def test_traced_calls_cold_shapes_and_storm_alert_match(monkeypatch):
    """Unbucketed shapes climb the cold-call count and raise the storm on
    /status and through the alert registry, the same way on both sides."""
    monkeypatch.setenv("PATHWAY_PROFILE_SHAPE_WARN", "4")
    monkeypatch.setenv("PATHWAY_HEALTH", "on")
    ref_dev.install_from_env()
    port_dev.install_from_env()
    ref_alerts.install_from_env()
    port_alerts.install_from_env()
    try:
        rf = ref_dev.traced_jit("test.storm", jax.jit(lambda x: x * x))
        pf = port_dev.traced_jit("test.storm", lambda x: x * x)
        for n in (3, 4, 5, 5, 6, 7, 8, 9, 3):
            rf(jnp.ones((n,)))
            pf(torch.ones(n))
        assert (pf.calls, pf.cold_calls, len(pf._seen), pf.storm) == (
            rf.calls, rf.cold_calls, len(rf._seen), rf.storm,
        ) == (9, 7, 7, True)
        r, p = ref_dev.status_summary(), port_dev.status_summary()
        # the warnings of other callables depend on what ran earlier in this
        # process (shape sets are process-lifetime)
        mine = lambda s: [w for w in s["warnings"] if "test.storm" in w]  # noqa: E731
        assert mine(p) == mine(r) and len(mine(p)) == 1
        strip = lambda alerts: [  # noqa: E731
            {k: v for k, v in a.items() if not k.endswith("_unix")} for a in alerts
        ]
        ra, pa = ref_alerts.current().active_alerts(), port_alerts.current().active_alerts()
        assert strip(pa) == strip(ra)
        assert [a["alert"] for a in pa] == ["recompile_storm"]
    finally:
        ref_alerts.shutdown()
        port_alerts.shutdown()


def test_full_mode_split_and_off_mode_match(monkeypatch):
    monkeypatch.setenv("PATHWAY_PROFILE", "full")
    ref_dev.install_from_env()
    port_dev.install_from_env()
    rf = ref_dev.traced_jit("test.split", jax.jit(lambda x: x * x))
    pf = port_dev.traced_jit("test.split", lambda x: x * x)
    for _ in range(3):
        rf(jnp.ones((64,)))
        pf(torch.ones(64))
    r = ref_dev.status_summary()["time_split"]["test.split"]
    p = port_dev.status_summary()["time_split"]["test.split"]
    assert p["samples"] == r["samples"] == 2  # the cold call is not split
    assert p["host_ms"] >= 0.0 and p["device_ms"] >= 0.0
    monkeypatch.setenv("PATHWAY_PROFILE", "off")
    ref_dev.install_from_env()
    port_dev.install_from_env()
    rf2 = ref_dev.traced_jit("test.off", jax.jit(lambda x: x + 1))
    pf2 = port_dev.traced_jit("test.off", lambda x: x + 1)
    rf2(jnp.ones((4,)))
    pf2(torch.ones(4))
    PortDispatcher(lambda items: items, max_batch=8, label="offpad").map([1, 2, 3])
    assert (pf2.calls, pf2.cold_calls) == (rf2.calls, rf2.cold_calls) == (0, 0)
    assert port_dev.status_summary() == ref_dev.status_summary() == {"enabled": False, "mode": "off"}
    assert port_dev.prometheus_lines() == ref_dev.prometheus_lines() == []


def test_weak_registration_and_cpu_backend_memory():
    class Owner:
        pass

    for dev in (ref_dev, port_dev):
        o = Owner()
        dev.register_memory(o, "weak_test", lambda _o: 1234)
        assert dev.memory_components()["weak_test"] == 1234
        del o
        gc.collect()
        assert "weak_test" not in dev.memory_components()
    # the plane's tensors are on the CPU: no allocator to read on either side
    assert port_dev.backend_memory() is None
    assert ref_dev.backend_memory() is None


def test_kernel_builds_count_as_compiles():
    """The port's compiles are its kernel builds: attributed to the traced
    callable dispatching at the time, else to ``build/<name>``."""
    f = port_dev.traced_jit("test.builds", lambda x: (port_dev.note_build("k.cu", 0.25), x)[1])
    f(torch.ones(3))
    port_dev.note_build("tok.c", 0.5)
    view = port_dev.status_summary()["callables"]
    assert (view["test.builds"]["compiles"], view["test.builds"]["compile_s"]) == (1, 0.25)
    assert (view["build/tok.c"]["compiles"], view["build/tok.c"]["compile_s"]) == (1, 0.5)
    kinds = [e for e in port_dev.flight_snapshot()["events"] if e["kind"] == "compile"]
    assert [e["build"] for e in kinds[-2:]] == ["k.cu", "tok.c"]


def test_flight_dump_on_failing_run_matches(tmp_path, monkeypatch):
    docs = {}
    for name, pw in (("ref", pathway_tpu), ("port", pathway_tpu_torch)):
        monkeypatch.setenv("PATHWAY_FLIGHT_DIR", str(tmp_path / name))
        pw.G.clear()
        t = pw.debug.table_from_rows(pw.schema_from_types(x=int), [(1, 0, 1), (2, 0, 1)], is_stream=True)
        t = t.select(y=pw.apply(lambda x: 1 // 0, t.x))
        pw.io.subscribe(t, on_change=lambda **k: None)
        with pytest.raises(Exception):
            pw.run(monitoring_level="none", terminate_on_error=True)
        pw.G.clear()
        [dump] = sorted((tmp_path / name).glob("flight_p0_*.json"))
        docs[name] = json.loads(dump.read_text())
    r, p = docs["ref"], docs["port"]
    assert p["reason"] == r["reason"] == "run_error"
    assert p["error"]["type"] == r["error"]["type"]
    assert sorted(p) == sorted(set(r) - {"audit"}) or sorted(p) == sorted(r)
    assert isinstance(p["ticks"], list) and isinstance(p["events"], list)
    assert p["device"]["enabled"] and p["device"]["mode"] == r["device"]["mode"]
    assert [e["kind"] for e in p["events"] if e["kind"] == "run_error"] == ["run_error"]


def test_profile_window_via_endpoint_closes_after_its_ticks(tmp_path):
    """``/profile?ticks=2`` arms a window; the tick hook starts, steps and
    closes it; the port's window writes a Chrome trace of torch.profiler
    (CPU activities here). The endpoint's answers equal the reference's."""
    answers = {}
    for name, mon, dev in (("ref", ref_mon, ref_dev), ("port", port_mon, port_dev)):
        port = free_port()
        release_port(port)
        srv = mon.MonitoringHttpServer(_RT(), port=port).start()
        try:
            get = lambda q: json.loads(  # noqa: E731
                urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/profile{q}", timeout=5).read()
            )
            first = get("")
            armed = get(f"?ticks=2&dir={tmp_path}/{name}")
            again = get(f"?ticks=2&dir={tmp_path}/{name}2")
            dev.tick_hook(0)
            torch.ones(8).sum()
            dev.tick_hook(1)
            answers[name] = (first, {k: v for k, v in armed.items() if k != "dir"}, again, dev._profile_state())
        finally:
            srv.stop()
    assert answers["port"] == answers["ref"]
    assert answers["port"][0] == {"ok": True, "window": None}
    assert answers["port"][3] is None  # closed by itself after 2 ticks
    trace = port_dev.last_trace()
    assert trace is not None and os.path.dirname(trace) == f"{tmp_path}/port"
    with open(trace) as fh:
        assert "traceEvents" in json.load(fh)


def test_run_status_device_section_and_families_match():
    stats = {}
    for name, pw, mon in (("ref", pathway_tpu, ref_mon), ("port", pathway_tpu_torch, port_mon)):
        pw.G.clear()
        t = pw.debug.table_from_rows(pw.schema_from_types(x=int), [(i, i // 8, 1) for i in range(64)], is_stream=True)
        t = t.with_columns(m=t.x % 3)
        g = t.groupby(t.m).reduce(s=pw.reducers.sum(t.x))
        pw.io.subscribe(g, on_change=lambda **k: None)
        pw.run(monitoring_level="none")
        rt = pw.internals.run.current_runtime()
        stats[name] = (mon.run_stats(rt)["device"], mon.prometheus_text(rt))
        pw.G.clear()
    (rd, rtext), (pd, ptext) = stats["ref"], stats["port"]
    assert pd["enabled"] and pd["mode"] == rd["mode"] == "on"
    assert sorted(pd) == sorted(rd)
    for fam in ("pathway_jit_compiles_total", "pathway_jit_compile_seconds_total", "pathway_device_bytes"):
        assert (fam in ptext) == (fam in rtext) == True  # noqa: E712
