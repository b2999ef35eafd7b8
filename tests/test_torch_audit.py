"""The port's audit plane (``pathway_tpu_torch/observability/audit.py``) and
the fault plan it is tested with (``pathway_tpu_torch/resilience/faults.py``)
against the reference's, on the same seeded inputs.

Mirrors ``tests/test_audit.py`` case by case: each case runs the same
pipeline, or feeds the same delta blocks to a bare ``AuditPlane``, under both
packages and asserts equal violations (kind, operator, key, tick, detail),
equal shadow-audit counters, equal per-edge cardinality rows and ``/metrics``
lines, and equal flight dumps. Also: ``_mix_keys`` gives the same uint64
digest, both planes sample the same ticks, a ``drop_poll`` fault skips the
same ticks, and an audit-sampled tick keeps a fused chain of 65,536 rows on
the host program (``PATHWAY_ENGINE_JAX=cpu``, so the device tier runs on CPU
tensors where it runs at all).

The multi-worker cases run here too: ``flip_diff`` on the thread-sharded
runtime (``n_workers=2``) and the coordinator's rollup of peers' heartbeat
blocks (``merge_heartbeat_summaries``); the 2-process cluster case is in
``tests/test_torch_cluster.py``.
"""

from __future__ import annotations

import glob
import json
import time

import numpy as np
import pytest

import pathway_tpu
import pathway_tpu_torch
from pathway_tpu.engine import blocks as ref_blocks
from pathway_tpu.internals import monitoring as ref_mon
from pathway_tpu.observability import audit as ref_audit
from pathway_tpu.resilience import faults as ref_faults
from pathway_tpu_torch.engine import blocks as port_blocks
from pathway_tpu_torch.internals import monitoring as port_mon
from pathway_tpu_torch.observability import audit as port_audit
from pathway_tpu_torch.resilience import faults as port_faults

SIDES = {
    "ref": (pathway_tpu, ref_audit, ref_mon, ref_blocks.DeltaBatch),
    "port": (pathway_tpu_torch, port_audit, port_mon, port_blocks.DeltaBatch),
}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in ("PATHWAY_AUDIT", "PATHWAY_AUDIT_SAMPLE", "PATHWAY_AUDIT_KEYS", "PATHWAY_LINEAGE_KEYS",
              "PATHWAY_FAULT_PLAN", "PATHWAY_FLIGHT_DIR"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("PATHWAY_TIMELINE", "off")
    for pw, *_ in SIDES.values():
        pw.G.clear()
    yield
    for pw, *_ in SIDES.values():
        pw.G.clear()
    ref_faults.install(None)
    port_faults.install(None)


def _groupby_pipeline(pw, n=64, tick_rows=8):
    pw.G.clear()
    t = pw.debug.table_from_rows(
        pw.schema_from_types(x=int),
        [(i, i // tick_rows, 1) for i in range(n)],
        is_stream=True,
    )
    t = t.with_columns(m=t.x % 5)
    g = t.groupby(t.m).reduce(s=pw.reducers.sum(t.x))
    pw.io.subscribe(g, on_change=lambda **k: None)


def _violations(plane) -> list[dict]:
    return [{k: v[k] for k in ("kind", "operator", "key", "tick", "detail")} for v in plane.violations]


def _audit_lines(text: str) -> list[str]:
    return [line for line in text.splitlines()
            if line.startswith(("pathway_operator_rows_total", "pathway_operator_selectivity",
                                "pathway_operator_retract_fraction", "pathway_operator_distinct_keys",
                                "pathway_audit_"))]


# ------------------------------------------------------------- plane basics


def test_audit_on_by_default_and_off_installs_nothing(monkeypatch):
    for name, (pw, audit, _mon, _B) in SIDES.items():
        monkeypatch.delenv("PATHWAY_AUDIT", raising=False)
        _groupby_pipeline(pw)
        pw.run(monitoring_level="none")
        plane = audit.current()
        assert plane is not None and plane.mode == "on", name
        assert plane.violation_counts == {}, name  # a healthy pipeline trips nothing

        monkeypatch.setenv("PATHWAY_AUDIT", "off")
        _groupby_pipeline(pw)
        pw.run(monitoring_level="none")
        assert audit.current() is None, name


def test_audit_knob_validation(monkeypatch):
    from pathway_tpu.internals.config import get_pathway_config as ref_cfg
    from pathway_tpu_torch.internals.config import get_pathway_config as port_cfg

    for get in (ref_cfg, port_cfg):
        monkeypatch.setenv("PATHWAY_AUDIT", "bogus")
        with pytest.raises(ValueError):
            get().audit
        monkeypatch.setenv("PATHWAY_AUDIT", "full")
        assert get().audit == "full"
        monkeypatch.delenv("PATHWAY_AUDIT", raising=False)
        assert get().audit == "on"
        monkeypatch.setenv("PATHWAY_AUDIT_SAMPLE", "2.0")
        with pytest.raises(ValueError):
            get().audit_sample
        monkeypatch.delenv("PATHWAY_AUDIT_SAMPLE")
        assert (get().audit_sample, get().audit_keys, get().lineage_keys) == (0.0625, 262144, 4096)


def test_cardinality_gauges_and_status_and_metrics(monkeypatch):
    # full mode + sample 1.0: every tick records, so the sampled retract/KMV
    # estimators are exact here
    monkeypatch.setenv("PATHWAY_AUDIT", "full")
    monkeypatch.setenv("PATHWAY_AUDIT_SAMPLE", "1.0")
    out = {}
    for name, (pw, _audit, mon, _B) in SIDES.items():
        _groupby_pipeline(pw)
        pw.run(monitoring_level="none")
        rt = pw.internals.run.current_runtime()
        a = mon.run_stats(rt)["audit"]
        a.pop("lineage")
        out[name] = (a, _audit_lines(mon.prometheus_text(rt)))
    assert out["port"] == out["ref"]
    a, lines = out["port"]
    assert a["enabled"] and a["violations_total"] == 0
    gb = {o["operator"]: o for o in a["operators"]}["groupby"]
    # 64 inserts in; churny retract+insert output; 5 distinct group keys
    assert gb["rows_in"] == 64 and gb["retracts_out"] > 0 and gb["distinct_keys"] == 5
    assert 0.0 < gb["retract_fraction_out"] < 1.0 and gb["selectivity"] > 1.0
    assert any(line.startswith('pathway_operator_rows_total{op="groupby"') and 'dir="in"' in line for line in lines)
    assert "pathway_audit_divergence_total 0" in lines


def test_shadow_audit_runs_on_sampled_ticks_without_divergence(monkeypatch):
    monkeypatch.setenv("PATHWAY_AUDIT", "full")  # every tick shadow-audited
    out = {}
    for name, (pw, audit, _mon, _B) in SIDES.items():
        _groupby_pipeline(pw)
        pw.run(monitoring_level="none")
        plane = audit.current()
        out[name] = (plane.shadow_ticks, plane.divergences, plane.violation_counts)
    assert out["port"] == out["ref"]
    assert out["port"][0] > 0 and out["port"][1:] == (0, {})


def test_shadow_sampled_ticks_and_digest_match():
    """Both planes audit the same ticks (the span plane's tick hash) at the
    default sample and at another, and ``_mix_keys`` gives the reference's
    uint64 digest bit for bit."""
    for sample in (0.0625, 0.3, 1.0):
        sampled = {}
        for name, (_pw, audit, _mon, _B) in SIDES.items():
            plane = audit.AuditPlane("on", sample, 1 << 20)
            ticks = []
            for t in range(4096):
                plane.begin_tick(t)
                ticks.append((plane.tick_sampled, plane.edge_sampled))
            sampled[name] = ticks
        assert sampled["port"] == sampled["ref"]
        assert 0 < sum(s for s, _e in sampled["port"]) <= 4096
    rng = np.random.default_rng(7)
    for n in (0, 1, 17, 4096, 100_000):
        keys = rng.integers(0, 1 << 64, size=n, dtype=np.uint64)
        diffs = rng.integers(-3, 4, size=n).astype(np.int64)
        assert port_audit._mix_keys(keys, diffs) == ref_audit._mix_keys(keys, diffs)


# -------------------------------------------------- fault-injected corruption


def test_flip_diff_detected_within_one_tick_thread_runtime(monkeypatch, tmp_path):
    monkeypatch.setenv("PATHWAY_FAULT_PLAN", "flip_diff:proc=0,tick=2")
    out = {}
    for name, (pw, audit, mon, _B) in SIDES.items():
        monkeypatch.setenv("PATHWAY_FLIGHT_DIR", str(tmp_path / name))
        _groupby_pipeline(pw)
        pw.run(monitoring_level="none")
        plane = audit.current()
        a = mon.run_stats(pw.internals.run.current_runtime())["audit"]
        recent = [{k: v for k, v in r.items() if k != "t_ns"} for r in a["recent_violations"]]
        dumps = glob.glob(str(tmp_path / name / "flight_p0_*.json"))
        assert len(dumps) == 1, (name, dumps)  # one immediate dump per run
        doc = json.load(open(dumps[0]))
        events = [e for e in doc["events"] if e.get("kind") == "audit_violation"]
        out[name] = (_violations(plane), a["violations_by_kind"], recent, doc["reason"],
                     {k: v for k, v in doc["extra"].items() if k != "t_ns"},
                     [{k: v for k, v in e.items() if k != "t_ns"} for e in events],
                     (plane.divergences, plane.shadow_ticks))
    assert out["port"] == out["ref"]
    violations, by_kind, _recent, reason, extra, events, _counts = out["port"]
    v = next(v for v in violations if v["kind"] == "negative_multiplicity")
    # detected at the corrupted input edge, at the corruption tick
    assert v["tick"] == 2 and v["key"] is not None and v["operator"].startswith("stream_fixture")
    assert by_kind["negative_multiplicity"] >= 1
    # the flight dump names (operator, key, tick)
    assert reason == "audit_violation" and extra["operator"].startswith("stream_fixture") and extra["tick"] == 2
    assert events


def test_drop_retract_detected_on_upsert_session(monkeypatch):
    """Ticks of a live subject follow the wall clock, so the violation's
    kind, operator and key are compared and its tick is checked on each
    side."""
    monkeypatch.setenv("PATHWAY_FAULT_PLAN", "drop_retract:proc=0,tick=1")
    out = {}
    for name, (pw, audit, _mon, _B) in SIDES.items():
        class Subj(pw.io.python.ConnectorSubject):
            def run(self):
                self.next(k=1, v=10)
                time.sleep(0.1)
                self.next(k=1, v=20)  # replace: (-1 old, +1 new); retract dropped
                time.sleep(0.05)

            @property
            def _session_type(self):
                return "upsert"

        class KS(pw.Schema):
            k: int = pw.column_definition(primary_key=True)
            v: int

        pw.G.clear()
        t = pw.io.python.read(Subj(), schema=KS)
        pw.io.subscribe(t, on_change=lambda **k: None)
        pw.run(monitoring_level="none")
        plane = audit.current()
        v = next(v for v in plane.violations if v["kind"] == "upsert_duplicate")
        assert isinstance(v["tick"], int), name
        out[name] = (v["kind"], v["operator"], v["key"], v["detail"])
    assert out["port"] == out["ref"]
    assert out["port"][1].startswith("python_connector") and out["port"][2] is not None


def test_flip_diff_detected_on_sharded_thread_runtime(monkeypatch):
    """``flip_diff`` on a 2-worker run: both packages catch the negative
    multiplicity, with the same violations."""
    monkeypatch.setenv("PATHWAY_FAULT_PLAN", "flip_diff:proc=0,tick=2")
    out = {}
    for name, (pw, audit, _mon, _B) in SIDES.items():
        _groupby_pipeline(pw)
        pw.run(monitoring_level="none", n_workers=2)
        plane = audit.current()
        assert plane.violation_counts.get("negative_multiplicity", 0) >= 1
        out[name] = sorted(_violations(plane), key=repr)
    assert out["port"] == out["ref"]


def test_heartbeat_summary_merge():
    a = {
        "violations": 2,
        "by_kind": {"negative_multiplicity": 2},
        "divergences": 1,
        "shadow_ticks": 4,
        "recent": [{"kind": "negative_multiplicity", "t_ns": 5}],
    }
    b = {
        "violations": 1,
        "by_kind": {"upsert_duplicate": 1},
        "divergences": 0,
        "shadow_ticks": 4,
        "recent": [{"kind": "upsert_duplicate", "t_ns": 3}],
    }
    merged = {name: audit.merge_heartbeat_summaries([a, None, b]) for name, (_pw, audit, _m, _B) in SIDES.items()}
    assert merged["port"] == merged["ref"]
    m = merged["port"]
    assert m["violations"] == 3
    assert m["by_kind"] == {"negative_multiplicity": 2, "upsert_duplicate": 1}
    assert m["divergences"] == 1 and m["shadow_ticks"] == 8
    assert [r["t_ns"] for r in m["recent"]] == [3, 5]
    for _pw, audit, _m, _B in SIDES.values():
        assert audit.merge_heartbeat_summaries([None, {}]) is None


def test_flip_diff_on_index_input_edge_with_tiered_backend_live(monkeypatch):
    """A flip_diff fault on the index DOCS input edge is detected within one
    tick while a tiered backend serves the index (whose tolerant remove()
    keeps the dataflow alive so the tripwire, not a crash, reports it)."""
    monkeypatch.setenv("PATHWAY_FAULT_PLAN", "flip_diff:proc=0,tick=2")
    rng = np.random.default_rng(21)
    vecs = rng.normal(size=(48, 8)).astype(np.float32)
    out = {}
    for name, (pw, audit, _mon, _B) in SIDES.items():
        pw.G.clear()
        docs = pw.debug.table_from_rows(
            pw.schema_from_types(emb=np.ndarray),
            [(v, i // 8, 1) for i, v in enumerate(vecs)],  # 6 ticks of 8 docs
            is_stream=True,
        )
        extra = {"device": "cpu"} if pw is pathway_tpu_torch else {}
        factory = pw.stdlib.indexing.TieredKnnFactory(dimensions=8, hot_rows=8, min_train=10**9, **extra)
        index = factory.build_index(docs.emb, docs)
        qs = pw.debug.table_from_rows(pw.schema_from_types(emb=np.ndarray), [(vecs[3],)])
        r = index.inner_index.query_as_of_now(qs.emb, number_of_matches=2)
        replies: list = []
        pw.io.subscribe(r, on_change=lambda key, row, time, is_addition: replies.append(row) if is_addition else None)
        pw.run(monitoring_level="none")
        plane = audit.current()
        assert replies, f"{name}: index replies must survive the corrupted edge"
        out[name] = _violations(plane)
    assert out["port"] == out["ref"]
    v = next(v for v in out["port"] if v["kind"] == "negative_multiplicity")
    assert v["tick"] == 2 and v["key"] is not None and v["operator"].startswith("stream_fixture")
    from pathway_tpu_torch.stdlib.indexing.tiered import tier_stats

    ts = tier_stats()
    assert ts is not None and ts["hits_total"] >= 2


def test_drop_poll_skips_the_same_ticks(monkeypatch):
    """``drop_poll`` on this process: the named ticks poll nothing and the
    held rows land at the next tick, on both sides alike."""
    monkeypatch.setenv("PATHWAY_FAULT_PLAN", "drop_poll:proc=0,tick=2,count=2")
    out = {}
    for name, (pw, _audit, _mon, _B) in SIDES.items():
        seen: list = []
        pw.G.clear()
        t = pw.debug.table_from_rows(pw.schema_from_types(x=int), [(i, i // 8, 1) for i in range(64)], is_stream=True)
        pw.io.subscribe(t, on_change=lambda key, row, time, is_addition: seen.append((row["x"], time, is_addition)))
        pw.run(monitoring_level="none")
        out[name] = sorted(seen)
    assert out["port"] == out["ref"]
    times = {x: t for x, t, _a in out["port"]}
    assert times[16] == times[31] == 4 and times[15] == 1 and times[32] == 4


@pytest.mark.parametrize("step", ["kill:proc=1,tick=3", "kill_point:point=delivery_staged",
                                  "delay_barrier:proc=0,tick=1,ms=5", "drop_poll:proc=1,tick=2"])
def test_fault_plan_steps_of_the_cluster_are_a_later_slice(step):
    """The supervisor's and the cluster's steps (ported with the cluster
    plane): both packages parse each step into the same specs and write the
    same ``PATHWAY_FAULT_PLAN`` back."""
    ref_plan = ref_faults.FaultPlan.parse(step)
    port_plan = port_faults.FaultPlan.parse(step)
    fields = lambda plan: [  # noqa: E731
        (s.action, s.proc, s.tick, s.count, s.ms, s.point) for s in plan.specs
    ]
    assert fields(port_plan) == fields(ref_plan)
    assert port_plan.to_env() == ref_plan.to_env()
    assert fields(port_faults.FaultPlan(list(ref_plan.specs))) == fields(ref_plan)


def test_fault_plan_parse_roundtrip_new_actions():
    for faults in (ref_faults, port_faults):
        plan = faults.FaultPlan.parse("flip_diff:proc=0,tick=3;drop_retract:tick=5,count=2")
        assert [s.action for s in plan.specs] == ["flip_diff", "drop_retract"]
        again = faults.FaultPlan.parse(plan.to_env())
        assert [(s.action, s.proc, s.tick, s.count) for s in again.specs] == [
            ("flip_diff", 0, 3, 1),
            ("drop_retract", None, 5, 2),
        ]
        # drop_retract waits for a block that actually has a retraction, then
        # fires exactly `count` times
        plan = faults.FaultPlan.parse("drop_retract:tick=5")
        assert plan.take_corruption(0, 5, has_retract=False) is None
        spec = plan.take_corruption(0, 6, has_retract=True)
        assert spec is not None and spec.action == "drop_retract"
        assert plan.take_corruption(0, 7, has_retract=True) is None  # exhausted
        # wrong process never fires
        plan = faults.FaultPlan.parse("flip_diff:proc=1,tick=0")
        assert plan.take_corruption(0, 3, has_retract=True) is None
        with pytest.raises(ValueError):
            faults.FaultPlan.parse("explode:tick=1")


def test_corrupt_polled_flips_and_drops_the_same_rows():
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 1 << 63, size=12, dtype=np.uint64)
    diffs = np.array([1, 1, -1, 1, -1, 1, 1, 1, -1, 1, 1, 1], dtype=np.int64)
    vals = rng.integers(0, 100, size=12)
    out = {}
    for name, faults, B in (("ref", ref_faults, ref_blocks.DeltaBatch), ("port", port_faults, port_blocks.DeltaBatch)):
        got = []
        for plan in ("flip_diff:tick=1", "drop_retract:tick=1"):
            faults.install(faults.FaultPlan.parse(plan))
            b = B(keys.copy(), diffs.copy(), {"v": vals.copy()}, 1)
            assert faults.corrupt_polled(0, 0, [b])[0] is b  # before the step's tick: untouched
            (c,) = faults.corrupt_polled(0, 1, [b])
            got.append((c.keys.tolist(), c.diffs.tolist(), c.data["v"].tolist()))
            assert faults.corrupt_polled(0, 2, [b])[0] is b  # fired once
            faults.install(None)
        out[name] = got
    assert out["port"] == out["ref"]
    assert out["port"][0][1][0] == -1 and len(out["port"][1][0]) == 11


# ----------------------------------------------------------- monitor units


def _fake_sink(idx=9):
    class N:
        name = "subscribe"
        node_index = idx

    return N()


def _both(fn) -> dict:
    out = {}
    for name, (_pw, audit, _mon, B) in SIDES.items():
        out[name] = fn(audit, B)
    assert out["port"] == out["ref"]
    return out["port"]


def test_shadow_divergence_fires_on_inconsistent_net():
    def case(audit, B):
        plane = audit.AuditPlane("full", 1.0, 1 << 20)
        node = _fake_sink()
        plane.on_sink_delta(node, B.from_rows([1, 2], [(10,), (20,)], ["v"], 0))
        # a "consolidation" that silently dropped key 2's row
        plane.on_sink_net(node, B.from_rows([1], [(10,)], ["v"], 0), 0)
        first = (plane.divergences, dict(plane.violation_counts))
        # re-synced: the same healthy tick later does not re-fire
        plane.on_sink_delta(node, B.from_rows([3], [(30,)], ["v"], 1))
        plane.on_sink_net(node, B.from_rows([3], [(30,)], ["v"], 1), 1)
        return first, plane.divergences, _violations(plane)

    first, again, _v = _both(case)
    assert first == (1, {"shadow_divergence": 1}) and again == 1


def test_sink_negative_multiplicity_and_retract_excess():
    def case(audit, B):
        plane = audit.AuditPlane("on", 1.0, 1 << 20)
        plane.on_sink_net(_fake_sink(), B.from_rows([5], [(1,)], ["v"], 0, diffs=[-1]), 0)
        return _violations(plane)

    kinds = [x["kind"] for x in _both(case)]
    assert kinds.count("negative_multiplicity") == 1 and kinds.count("retract_excess") == 1


def test_history_truncated_stands_down_multiplicity_monitors():
    def case(audit, B):
        plane = audit.AuditPlane("full", 1.0, 1 << 20)
        plane.history_complete = False  # what note_history_truncated() sets

        class N:
            name = "stream_input"
            node_index = 0
            upsert = False

        retract = B.from_rows([5], [(1,)], ["v"], 0, diffs=[-1])
        plane.observe_input(N(), [retract], 0)
        sink = _fake_sink()
        plane.on_sink_delta(sink, retract)
        plane.on_sink_net(sink, retract, 0)
        audit._plane = fresh = audit.AuditPlane("on", 1.0, 1 << 20)
        try:
            audit.note_history_truncated()
        finally:
            audit._plane = None
        return plane.violation_counts, plane.divergences, fresh.history_complete

    assert _both(case) == ({}, 0, False)


def test_watermark_regression_fires_once_per_input():
    def case(audit, B):
        plane = audit.AuditPlane("on", 1.0, 1 << 20)

        class N:
            name = "stream_input"
            node_index = 1
            wm_event_time = 100.0

        n = N()
        plane.observe_input(n, [], 0)
        n.wm_event_time = 99.0
        plane.observe_input(n, [], 1)
        n.wm_event_time = 98.0  # still below the high-water mark: no re-fire
        plane.observe_input(n, [], 2)
        return _violations(plane)

    v = _both(case)
    assert [(x["kind"], x["tick"]) for x in v] == [("watermark_regression", 1)]


def test_watermark_regression_monitor():
    def case(audit, B):
        plane = audit.AuditPlane("on", 1.0, 1 << 20)

        class N:
            name = "stream_input"
            node_index = 1
            wm_event_time = 100.0

        n = N()
        plane.observe_input(n, [], 0)
        n.wm_event_time = 99.0  # bookkeeping bug: the high-water mark regressed
        plane.observe_input(n, [], 1)
        return plane.violation_counts

    assert _both(case) == {"watermark_regression": 1}


def test_event_time_column_drives_the_watermark_monitor():
    """``event_time_column`` becomes the input's ``wm_event_time``: the
    watermark ``/status`` reports and the audit plane's monotonicity monitor
    reads, the same on both sides (the live path and the timed fixture's
    columnar path); the monitor trips nothing on a healthy stream."""
    out = {}
    for name, (pw, audit, mon, _B) in SIDES.items():
        class Subj(pw.io.python.ConnectorSubject):
            def run(self):
                for i in range(12):
                    self.next(x=i, et=100.0 + (i * 7) % 12)

        pw.G.clear()
        live = pw.io.python.read(Subj(), schema=pw.schema_from_types(x=int, et=float), event_time_column="et")
        events = [(i // 4, i + 1, (i, 200.0 + i), 1) for i in range(16)]
        timed = pw.io.python.read(pw.io.python._StaticStreamSubject(events, ["x", "et"]),
                                  schema=pw.schema_from_types(x=int, et=float), event_time_column="et")
        pw.io.subscribe(live, on_change=lambda **k: None)
        pw.io.subscribe(timed, on_change=lambda **k: None)
        pw.run(monitoring_level="none")
        marks = mon.run_stats(pw.internals.run.current_runtime())["watermarks"]
        out[name] = ([(w["input"], w["watermark"], w["rows_ingested"]) for w in marks], audit.current().violation_counts)
    assert out["port"] == out["ref"]
    assert [w[1] for w in out["port"][0]] == [111.0, 215.0] and out["port"][1] == {}


def test_canonical_check_full_mode_only():
    def case(audit, B):
        bad = B.from_rows([7, 3], [(1,), (2,)], ["v"], 0)  # unsorted keys
        on = audit.AuditPlane("on", 1.0, 1 << 20)
        on.check_canonical(bad, "test")
        full = audit.AuditPlane("full", 1.0, 1 << 20)
        full.check_canonical(bad, "test")
        full.check_canonical(B.from_rows([3, 7], [(1,), (2,)], ["v"], 0, diffs=[0, 1]), "test")
        full.check_canonical(B.from_rows([3, 3], [(1,), (2,)], ["v"], 0, diffs=[1, -1]), "test")
        return on.violation_counts, _violations(full)

    on, full = _both(case)
    assert on == {}  # "on" mode skips the per-batch check
    assert [v["detail"] for v in full] == ["keys not sorted", "zero net diff kept",
                                           "within-key diff order broken (retract-before-insert)"]


def test_monitor_degrades_at_key_bound_instead_of_growing():
    def case(audit, B):
        plane = audit.AuditPlane("on", 1.0, 1024)  # floor of the knob

        class N:
            name = "stream_input"
            node_index = 0
            upsert = False

        n = N()
        big = B.from_rows(list(range(3000)), [(i,) for i in range(3000)], ["v"], 0)
        plane.observe_input(n, [big], 0)
        return n._audit_input.degraded, n._audit_input.counts.size()

    assert _both(case) == (True, 0)  # arrangement released, not retained


def test_key_counts_fold_modes_agree():
    """The monitor's per-key multiplicity in its dict mode and its sorted-array
    mode (past 2,048 keys) on seeded churn: the same offenders and digest."""
    rng = np.random.default_rng(11)
    windows = [(rng.integers(0, 5000, size=n).astype(np.uint64), rng.choice([-1, 1, 2], size=n).astype(np.int64))
               for n in (10, 200, 3000, 50, 4000)]

    def case(audit, B):
        kc = audit._KeyCounts()
        trail = []
        for keys, diffs in windows:
            kc.park(keys, diffs)
            kc.fold()
            trail.append((sorted(kc.offenders(lambda c: c < 0)), kc.digest(), kc.size()))
        return trail

    trail = _both(case)
    assert trail[-1][2] > 2048


# ----------------------------------------------- error-log live plane wiring


def test_udf_raise_increments_operator_error_counter():
    out = {}
    for name, (pw, _audit, mon, _B) in SIDES.items():
        pw.G.clear()
        t = pw.debug.table_from_rows(pw.schema_from_types(x=int), [(1,), (2,), (3,)])

        def boom(x):
            if x == 2:
                raise ValueError("bad row")
            return x * 10

        s = t.select(y=pw.apply(boom, t.x))
        pw.io.subscribe(s, on_change=lambda **k: None)
        pw.run(monitoring_level="none", terminate_on_error=False)
        rt = pw.internals.run.current_runtime()
        errors = mon.run_stats(rt)["errors"]
        text = mon.prometheus_text(rt)
        out[name] = (errors["total"], errors["by_operator"],
                     [line for line in text.splitlines() if line.startswith("pathway_operator_errors_total")])
    assert out["port"] == out["ref"]
    total, by_op, lines = out["port"]
    assert total >= 1 and any(c >= 1 for c in by_op.values()) and lines
    assert "(unattributed)" not in by_op


# ------------------------------------------ audited ticks keep the host program


def _chain(pw, n_ticks: int, rows: int):
    pw.G.clear()
    rng = np.random.default_rng(3)
    xs = rng.integers(-1000, 1000, size=n_ticks * rows)
    t = pw.debug.table_from_rows(pw.schema_from_types(x=int),
                                 [(int(x), i // rows, 1) for i, x in enumerate(xs)], is_stream=True)
    f = t.filter(t.x > -500)
    s = f.select(x=f.x, y=f.x * 3)
    return s.select(x=s.x, z=s.y + s.x)


@pytest.mark.parametrize("audit", ["off", "on", "full"])
def test_audited_tick_keeps_the_fused_chain_on_the_host(monkeypatch, audit):
    """A fused chain of 65,536-row blocks under ``PATHWAY_FUSE_JAX=auto``:
    with the audit plane off every tick takes the device tier; at the
    default ``on`` the audit-sampled tick 0 stays on the host program and the
    unsampled tick 1 takes the device tier; in ``full`` at sample 1.0 every
    tick stays on the host. The update streams are the same, and equal the
    reference's."""
    from pathway_tpu.debug import _capture as capture_ref
    from pathway_tpu_torch.debug import _capture as capture_port
    from pathway_tpu_torch.engine import torch_kernels as K

    monkeypatch.setenv("PATHWAY_ENGINE_JAX", "cpu")  # the device tier on CPU tensors here
    monkeypatch.setenv("PATHWAY_FUSE", "on")
    monkeypatch.setenv("PATHWAY_FUSE_JAX", "auto")
    monkeypatch.setenv("PATHWAY_FUSE_JAX_MIN_ROWS", "65536")
    monkeypatch.setenv("PATHWAY_AUDIT", audit)
    if audit == "full":
        monkeypatch.setenv("PATHWAY_AUDIT_SAMPLE", "1.0")
    rows = 65_536
    K.ROUTES.clear()
    port = capture_port(_chain(pathway_tpu_torch, 2, rows)).deltas
    routes = dict(K.ROUTES)
    assert routes.get("fused/cpu", 0) == {"off": 2, "on": 1, "full": 0}[audit], routes
    if audit != "off":
        plane = port_audit.current()
        assert plane.violation_counts == {}
        sampled = [(t, plane._sampled(t)) for t in (0, 1)]
        assert sampled == [(0, True), (1, audit == "full")]
    monkeypatch.setenv("PATHWAY_FUSE_JAX", "off")
    ref = capture_ref(_chain(pathway_tpu, 2, rows)).deltas
    assert [repr(d) for d in port] == [repr(d) for d in ref]
    assert len(port) > rows
