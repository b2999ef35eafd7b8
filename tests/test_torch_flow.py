"""The port's flow plane (``pathway_tpu_torch/flow``: credit gates,
interactive/bulk admission, the AIMD microbatch controller) against the
reference's, case by case.

Mirrors every single-process case of ``tests/test_flow.py``: each scenario
runs once on each package (the same pushes, polls, fed latencies and
streams) and what it observes (credit counters, shed and cancel counts,
budgets, controller decisions, final stream states, ``/status`` ``flow``
sections) is compared exactly; wall times are never compared. Threaded cases
compare counts and the bound invariant, not interleavings.

Left for later slices: the cluster case (``test_cluster_run_with_flow_on_
matches_off``, the cluster plane, ROADMAP Queue 1 item 4) and the persisted
input's gate bypass (``test_persisted_inputs_bypass_gate_and_replay_
survives``, the persistence plane, item 3), whose entry points raise
``later_slice`` in the port.
"""

from __future__ import annotations

import importlib
import json
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

import pathway_tpu
import pathway_tpu_torch

SIDES = {"ref": pathway_tpu, "port": pathway_tpu_torch}

_FLOW_ENV = (
    "PATHWAY_FLOW",
    "PATHWAY_INPUT_QUEUE_ROWS",
    "PATHWAY_FLOW_POLICY",
    "PATHWAY_LATENCY_SLO_MS",
    "PATHWAY_FLOW_BULK_MIN_ROWS",
    "PATHWAY_FLOW_BULK_MAX_ROWS",
    "PATHWAY_MICROBATCH_MAX_BATCH",
    "PATHWAY_TRACE",
    "PATHWAY_TRACE_LIVE_FILE",
)


def _m(pw):
    """The modules a scenario touches, of one package."""
    name = pw.__name__
    mod = lambda sub: importlib.import_module(f"{name}.{sub}")  # noqa: E731
    return SimpleNamespace(
        pw=pw,
        flow=mod("flow"),
        ops=mod("engine.operators"),
        admission=mod("flow.admission"),
        controller=mod("flow.controller"),
        monitoring=mod("internals.monitoring"),
        metrics=mod("observability.metrics"),
        microbatch=mod("ops.microbatch"),
        server=mod("io.http._server"),
        timeline=mod("observability.timeline"),
    )


@pytest.fixture(autouse=True)
def _isolate(monkeypatch):
    """Both packages' flow planes and run metrics are process-lifetime (the
    plane is retained after a run for post-run ``/status``): each case starts
    with neither, and with the flow knobs at their defaults."""
    for k in _FLOW_ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("PATHWAY_AUDIT", "off")
    monkeypatch.setenv("PATHWAY_TIMELINE", "off")
    for pw in SIDES.values():
        m = _m(pw)
        monkeypatch.setattr(m.flow, "_plane", None)
        m.metrics.reset()
        pw.G.clear()
    yield
    for pw in SIDES.values():
        m = _m(pw)
        m.flow.shutdown()
        m.metrics.reset()
        pw.G.clear()


RUN_LIMIT_S = 60.0


def _run(pw) -> None:
    """``pw.run`` in a thread that must end within ``RUN_LIMIT_S``: a gate
    whose producer is never released fails this test instead of stalling
    the whole run."""
    errors: list[BaseException] = []

    def run():
        try:
            pw.run(monitoring_level="none")
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)

    th = threading.Thread(target=run, daemon=True)
    th.start()
    th.join(RUN_LIMIT_S)
    if th.is_alive():
        rt = pw.internals.run.current_runtime()
        if rt is not None:
            rt.request_stop()
        importlib.import_module(f"{pw.__name__}.flow").shutdown()
        th.join(10)
        pytest.fail(f"{pw.__name__}: pw.run did not end within {RUN_LIMIT_S} s")
    if errors:
        raise errors[0]


def _both(scenario, monkeypatch):
    """``scenario(m, monkeypatch)`` on each package; their observations are
    equal, and the port's are returned for the case's own asserts."""
    out = {name: scenario(_m(pw), monkeypatch) for name, pw in SIDES.items()}
    assert out["port"] == out["ref"]
    return out["port"]


def _install(m, monkeypatch, **env):
    monkeypatch.setenv("PATHWAY_FLOW", "on")
    for k, v in env.items():
        monkeypatch.setenv(k, str(v))
    plane = m.flow.install_from_env()
    assert plane is not None
    return plane


def _input_node(m, monkeypatch, **env):
    plane = _install(m, monkeypatch, **env)
    node = m.ops.StreamInputNode(["x"], {"x": np.dtype(np.int64)})
    node.input_name = "test"
    assert node.flow_gate is not None
    return plane, node, node.flow_gate


def _rows(batches) -> int:
    return sum(len(b) for b in batches)


def _keys(batches) -> list[int]:
    return [int(k) for b in batches for k in np.asarray(b.keys).tolist()]


# ------------------------------------------------------------------- gating


def test_flow_off_by_default_installs_nothing(monkeypatch):
    def scenario(m, mp):
        plane = m.flow.install_from_env()
        node = m.ops.StreamInputNode(["x"])
        return plane, m.flow.current(), node.flow_gate

    assert _both(scenario, monkeypatch) == (None, None, None)


def test_gate_credits_replenish_on_tick_complete(monkeypatch):
    def scenario(m, mp):
        _plane, node, gate = _input_node(m, mp, PATHWAY_INPUT_QUEUE_ROWS=10)
        node.push_many((i, (i,), 1) for i in range(10))
        obs = [(gate.queued, gate.available())]
        obs.append(_rows(node.poll(0)))
        obs.append((gate.queued, gate.in_flight, gate.available()))
        gate.on_tick_complete()
        obs.append((gate.in_flight, gate.available()))
        m.flow.shutdown()
        return obs

    assert _both(scenario, monkeypatch) == [(10, 0), 10, (0, 10, 0), (0, 10)]


def test_block_policy_bounds_queue_under_flood(monkeypatch):
    def scenario(m, mp):
        _plane, node, gate = _input_node(m, mp, PATHWAY_INPUT_QUEUE_ROWS=4)
        peak = []
        done = threading.Event()

        def produce():
            node.push_many((i, (i,), 1) for i in range(50))
            done.set()

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        drained = 0
        for tick in range(400):
            if done.is_set() and gate.queued == 0:
                break
            peak.append(gate.queued + gate.in_flight)
            drained += _rows(node.poll(tick))
            gate.on_tick_complete()
            time.sleep(0.001)
        t.join(timeout=10)
        drained += _rows(node.poll(999))
        m.flow.shutdown()
        return done.is_set(), drained, max(peak) <= 4, gate.blocked_ns > 0, gate.shed_rows

    # the producer finished (credits replenished), nothing was lost, the
    # bound held at every sample, and the producer really waited
    assert _both(scenario, monkeypatch) == (True, 50, True, True, 0)


def test_shed_policy_counts_exact_drops(monkeypatch):
    def scenario(m, mp):
        _plane, node, gate = _input_node(
            m, mp, PATHWAY_INPUT_QUEUE_ROWS=8, PATHWAY_FLOW_POLICY="shed"
        )
        node.push_many((i, (i,), 1) for i in range(100))
        obs = (gate.queued, gate.admitted_rows, gate.shed_rows, _keys(node.poll(0)))
        m.flow.shutdown()
        return obs

    queued, admitted, shed, keys = _both(scenario, monkeypatch)
    assert (queued, admitted, shed) == (8, 8, 92) and keys == list(range(8))


def test_shed_never_drops_retractions(monkeypatch):
    def scenario(m, mp):
        _plane, node, gate = _input_node(
            m, mp, PATHWAY_INPUT_QUEUE_ROWS=4, PATHWAY_FLOW_POLICY="shed"
        )
        node.push_many((i, (i,), 1) for i in range(10))
        obs = [(gate.queued, gate.shed_rows)]
        node.push(99, (990,), -1)  # retract of a long-settled row
        obs.append((gate.queued, gate.shed_rows))
        obs.append(_keys(node.poll(0)))
        m.flow.shutdown()
        return obs

    obs = _both(scenario, monkeypatch)
    assert obs[:2] == [(4, 6), (5, 6)] and 99 in obs[2]


def test_bulk_only_pipeline_not_self_throttled(monkeypatch):
    def scenario(m, mp):
        plane = _install(m, mp, PATHWAY_INPUT_QUEUE_ROWS=10)
        node = m.ops.StreamInputNode(["x"])
        node.service_class = "bulk"
        gate = node.flow_gate
        gate.queued = 10  # at the bound
        plane.controller.step(None, 1, [gate])
        pressure = plane.controller.pressure
        plane.admission.plan([gate], plane.effective_pressure())
        hb = plane.heartbeat_summary()
        m.flow.shutdown()
        return pressure, gate.budget, hb

    pressure, budget, hb = _both(scenario, monkeypatch)
    assert pressure == 0.0 and budget is None
    assert hb["occupied"] == 0 and hb["bound"] == 0


def test_retract_of_queued_row_cancels_without_consuming_credit(monkeypatch):
    def scenario(m, mp):
        _plane, node, gate = _input_node(m, mp, PATHWAY_INPUT_QUEUE_ROWS=8)
        node.push(7, (70,), 1)
        obs = [gate.queued]
        node.push(7, (70,), -1)  # the retract catches the insert still queued
        obs.append((gate.queued, gate.cancelled_rows, gate.admitted_rows, node.poll(0)))
        node.push(9, (90,), -1)  # no queued match: a real event, takes credit
        obs.append((gate.queued, gate.admitted_rows))
        m.flow.shutdown()
        return obs

    assert _both(scenario, monkeypatch) == [1, (0, 1, 1, []), (1, 2)]


def test_retract_cancel_matches_by_value_not_just_key(monkeypatch):
    def scenario(m, mp):
        _plane, node, gate = _input_node(m, mp, PATHWAY_INPUT_QUEUE_ROWS=8)
        node.push(7, (71,), 1)  # the new version queued
        node.push(7, (70,), -1)  # retract of the old (settled) version
        obs = (gate.cancelled_rows, gate.queued)
        m.flow.shutdown()
        return obs

    assert _both(scenario, monkeypatch) == (0, 2)


def test_shed_retract_storm_bounded_at_twice_bound(monkeypatch):
    def scenario(m, mp):
        _plane, node, gate = _input_node(
            m, mp, PATHWAY_INPUT_QUEUE_ROWS=4, PATHWAY_FLOW_POLICY="shed"
        )
        node.push_many((i, (i,), 1) for i in range(4))
        for i in range(100, 104):
            node.push(i, (i,), -1)
        obs = [gate.queued]
        done = threading.Event()

        def extra_retract():
            node.push(200, (200,), -1)  # must block, neither grow nor drop
            done.set()

        t = threading.Thread(target=extra_retract, daemon=True)
        t.start()
        time.sleep(0.1)
        obs.append((done.is_set(), gate.queued))
        node.poll(0)
        gate.on_tick_complete()  # credits return: the blocked retract lands
        t.join(timeout=10)
        obs.append((done.is_set(), gate.queued))
        m.flow.shutdown()
        return obs

    assert _both(scenario, monkeypatch) == [8, (False, 8), (True, 1)]


def test_upsert_sessions_never_cancel_in_queue(monkeypatch):
    def scenario(m, mp):
        _install(m, mp, PATHWAY_INPUT_QUEUE_ROWS=8)
        node = m.ops.StreamInputNode(["x"], {"x": np.dtype(np.int64)}, upsert=True)
        gate = node.flow_gate
        node.push(7, (71,), 1)
        node.push(7, (71,), -1)
        obs = (gate.cancelled_rows, list(node._pending))
        m.flow.shutdown()
        return obs

    assert _both(scenario, monkeypatch) == (0, [(7, (71,), 1), (7, (71,), -1)])


def test_shed_insert_absorbs_matching_retract(monkeypatch):
    def scenario(m, mp):
        _plane, node, gate = _input_node(
            m, mp, PATHWAY_INPUT_QUEUE_ROWS=2, PATHWAY_FLOW_POLICY="shed"
        )
        node.push_many([(1, (10,), 1), (2, (20,), 1), (3, (30,), 1)])
        obs = [(gate.shed_rows, gate.queued)]
        node.push(3, (30,), -1)  # retract of the shed row: absorbed
        obs.append((gate.queued, gate.shed_rows, _keys(node.poll(0))))
        node.push(1, (10,), -1)  # a retract of an admitted row flows through
        obs.append(_keys(node.poll(1)))
        m.flow.shutdown()
        return obs

    assert _both(scenario, monkeypatch) == [(1, 2), (2, 2, [1, 2]), [1]]


def test_budget_drain_advances_oldest_stamp(monkeypatch):
    def scenario(m, mp):
        _plane, node, gate = _input_node(m, mp, PATHWAY_INPUT_QUEUE_ROWS=1000)
        node.push_many((i, (i,), 1) for i in range(100))
        first_stamp = node.wm_oldest_pending_ns
        gate.budget = 10
        node.poll(0)
        stamp = node.wm_oldest_pending_ns
        m.flow.shutdown()
        return stamp is not None and stamp > first_stamp

    assert _both(scenario, monkeypatch) is True


def test_poll_respects_admission_budget(monkeypatch):
    def scenario(m, mp):
        _plane, node, gate = _input_node(m, mp, PATHWAY_INPUT_QUEUE_ROWS=1000)
        node.push_many((i, (i,), 1) for i in range(100))
        gate.budget = 10
        obs = [_keys(node.poll(0)), (gate.queued, gate.in_flight)]
        gate.on_tick_complete()
        gate.budget = None
        obs.append(_rows(node.poll(1)))
        m.flow.shutdown()
        return obs

    assert _both(scenario, monkeypatch) == [list(range(10)), (90, 10), 90]


# --------------------------------------------------------------- admission


def _gate_like(m, service_class: str, bound: int = 100):
    return m.flow.IngestGate(SimpleNamespace(service_class=service_class), bound=bound, policy="block")


def test_admission_budgets_by_class_and_pressure(monkeypatch):
    def scenario(m, mp):
        sched = m.admission.AdmissionScheduler(bulk_min_rows=16)
        inter, bulk = _gate_like(m, "interactive"), _gate_like(m, "bulk")
        obs = []
        for pressure in (0.0, 0.5, 1.0, 0.1):
            sched.plan([inter, bulk], pressure=pressure)
            obs.append((inter.budget, bulk.budget))
        return obs

    assert _both(scenario, monkeypatch) == [(None, None), (None, 50), (None, 16), (None, None)]


def test_admission_standing_bulk_ceiling(monkeypatch):
    def scenario(m, mp):
        sched = m.admission.AdmissionScheduler(bulk_min_rows=8, bulk_max_rows=32)
        inter, bulk = _gate_like(m, "interactive"), _gate_like(m, "bulk")
        obs = []
        for pressure in (0.0, 0.75, 1.0):
            sched.plan([inter, bulk], pressure=pressure)
            obs.append((inter.budget, bulk.budget))
        m.admission.AdmissionScheduler(bulk_min_rows=64, bulk_max_rows=16).plan([bulk], pressure=1.0)
        obs.append(bulk.budget)
        m.admission.AdmissionScheduler(bulk_min_rows=8).plan([bulk], pressure=0.0)
        obs.append(bulk.budget)
        return obs

    assert _both(scenario, monkeypatch) == [(None, 32), (None, 25), (None, 8), 64, None]


# -------------------------------------------------------------- controller


def _fake_scheduler(backlog_rows: int = 0):
    node = SimpleNamespace(
        wm_rows=backlog_rows,
        wm_ingest_ns=None,
        wm_event_time=None,
        _pending=[None] * backlog_rows,
        node_index=0,
        name="stream_input",
        input_name="fake",
    )
    return SimpleNamespace(graph=SimpleNamespace(nodes=[node]))


def test_aimd_decrease_on_slo_breach_and_increase_on_backlog(monkeypatch):
    def scenario(m, mp):
        rm = m.metrics.run_metrics
        ctl = m.controller.AimdController(slo_ms=100.0, min_bucket=8, max_bucket=512)
        start = ctl.target
        rm().observe_sink_latency("subscribe:3", 1.0)  # p99 ~1 s >> 100 ms
        ctl.step(None, 1, [])
        pressure_after_breach = ctl.pressure
        ctl.step(_fake_scheduler(backlog_rows=300), 2, [])  # healthy, backlog > target
        ctl.step(_fake_scheduler(backlog_rows=10), 3, [])  # hold
        for i in range(20):
            rm().observe_sink_latency("subscribe:3", 1.0)
            ctl.step(None, 4 + i, [])
        return start, pressure_after_breach, list(ctl.decisions), ctl.snapshot()

    start, pressure, decisions, snap = _both(scenario, monkeypatch)
    assert start == 512 and pressure == 1.0
    assert [d["action"] for d in decisions[:3]] == ["decrease", "increase", "hold"]
    assert [d["target"] for d in decisions[:3]] == [256, 512, 512]
    assert decisions[-1]["target"] == 8 and snap["target_batch"] == 8
    assert all(8 <= d["target"] <= 512 for d in decisions)


def test_controller_watches_only_interactive_sinks(monkeypatch):
    def scenario(m, mp):
        ctl = m.controller.AimdController(slo_ms=100.0, max_bucket=512)
        bulk_sink = SimpleNamespace(is_sink=True, service_class="bulk", name="subscribe", node_index=5)
        sched = SimpleNamespace(graph=SimpleNamespace(nodes=[bulk_sink]))
        m.metrics.run_metrics().observe_sink_latency("subscribe:5", 5.0)
        ctl.step(sched, 1, [])
        return ctl.target, ctl.decisions[-1]["action"]

    assert _both(scenario, monkeypatch) == (512, "hold")


def test_cluster_signal_merges_peer_occupancy_and_scales_gates(monkeypatch):
    """The signal's arithmetic, on one process: the port has no peers to
    send it (the cluster plane is Queue 1 item 4), but the plane carries it."""

    def scenario(m, mp):
        plane = _install(m, mp, PATHWAY_INPUT_QUEUE_ROWS=100)
        gate = m.ops.StreamInputNode(["x"]).flow_gate
        sig = plane.cluster_signal({1: {"bound": 1000, "occupied": 900}})
        plane.apply_cluster_signal(sig)
        obs = [sig, gate.remote_scale, gate.effective_bound()]
        plane.apply_cluster_signal({"pressure": 0.0})
        obs.append(gate.effective_bound())
        m.flow.shutdown()
        return obs

    sig, scale, bound, restored = _both(scenario, monkeypatch)
    assert sig["pressure"] == pytest.approx(0.9) and scale == pytest.approx(0.55)
    assert (bound, restored) == (55, 100)


def test_no_positive_feedback_through_scaled_bounds(monkeypatch):
    def scenario(m, mp):
        plane = _install(m, mp, PATHWAY_INPUT_QUEUE_ROWS=100)
        gate = m.ops.StreamInputNode(["x"]).flow_gate
        gate.queued = 50
        gate.set_remote_scale(0.5)
        hb = plane.heartbeat_summary()
        plane.controller.step(None, 1, [gate])
        m.flow.shutdown()
        return hb["occupied"] / hb["bound"], plane.controller.pressure

    assert _both(scenario, monkeypatch) == (pytest.approx(0.5), pytest.approx(0.5))


def _subject(pw, rows):
    class Subj(pw.io.python.ConnectorSubject):
        def run(self):
            for r in rows:
                self.next(**r)

    return Subj()


def test_fs_write_service_class_scopes_slo(monkeypatch, tmp_path):
    def scenario(m, mp):
        mp.setenv("PATHWAY_FLOW", "on")
        pw = m.pw
        pw.G.clear()
        t = pw.io.python.read(_subject(pw, [{"x": i} for i in range(5)]), schema=pw.schema_from_types(x=int))
        pw.io.fs.write(t, str(tmp_path / f"{pw.__name__}.csv"), format="csv", service_class="bulk")
        pw.io.subscribe(t, on_change=lambda **kw: None)
        _run(pw)
        watched = m.flow.current().controller._watched_cache
        return sorted(watched)

    watched = _both(scenario, monkeypatch)
    assert any(label.startswith("subscribe:") for label in watched)
    assert not any(label.startswith("output:") for label in watched)  # the mirror is out


def test_subscribe_and_fs_write_refuse_an_unknown_class(monkeypatch, tmp_path):
    def scenario(m, mp):
        pw = m.pw
        t = pw.debug.table_from_markdown("x\n1")
        errors = []
        for call in (
            lambda: pw.io.subscribe(t, on_change=lambda **kw: None, service_class="batch"),
            lambda: pw.io.fs.write(t, str(tmp_path / "o.csv"), service_class="batch"),
            lambda: pw.io.python.read(_subject(pw, []), schema=pw.schema_from_types(x=int), service_class="x"),
        ):
            with pytest.raises(ValueError) as e:
                call()
            errors.append(str(e.value))
        pw.G.clear()
        return errors

    assert all("service_class must be one of" in e for e in _both(scenario, monkeypatch))


# ------------------------------------------------- the microbatch cap knob


def test_dispatcher_default_respects_max_batch_knob(monkeypatch):
    def scenario(m, mp):
        mp.delenv("PATHWAY_MICROBATCH_MAX_BATCH", raising=False)
        launches = []

        def fn(items):
            launches.append(len(items))
            return list(items)

        out = m.microbatch.MicrobatchDispatcher(fn).map(list(range(1300)))
        obs = [out == list(range(1300)), list(launches), m.microbatch.bucket_size(4096)]
        mp.setenv("PATHWAY_MICROBATCH_MAX_BATCH", "128")
        launches.clear()
        m.microbatch.MicrobatchDispatcher(fn).map(list(range(300)))
        obs += [list(launches), m.microbatch.bucket_size(4096)]
        mp.delenv("PATHWAY_MICROBATCH_MAX_BATCH")
        return obs

    same, first, cap, second, cap2 = _both(scenario, monkeypatch)
    assert same and max(first) <= 512 and cap == 512
    assert max(second) <= 128 and cap2 == 128


def test_length_bucketing_not_capped_by_row_knob(monkeypatch):
    def scenario(m, mp):
        mp.setenv("PATHWAY_MICROBATCH_MAX_BATCH", "32")
        out, mask = m.microbatch.pad_ragged_2d([np.arange(700)])
        mp.delenv("PATHWAY_MICROBATCH_MAX_BATCH")
        return tuple(out.shape), np.asarray(mask).astype(bool).sum()

    shape, valid = _both(scenario, monkeypatch)
    assert shape[1] == 1024 and valid == 700


def test_flow_plane_tunes_effective_microbatch(monkeypatch):
    def scenario(m, mp):
        plane = _install(m, mp)
        node = m.ops.MicrobatchApplyNode(
            out_columns=["y"], pass_names=["y"], pre_program=lambda b: {}, udf_specs=[], max_batch=512
        )
        obs = [node._effective_max_batch()]
        for target in (64, 4096):  # never above the node's static cap
            plane.controller.target = target
            obs.append(node._effective_max_batch())
        m.flow.shutdown()
        mp.setenv("PATHWAY_FLOW", "off")
        m.flow.install_from_env()
        obs.append(node._effective_max_batch())
        return obs

    assert _both(scenario, monkeypatch) == [512, 64, 512, 512]


def test_rest_door_takes_interactive_credit_without_blocking(monkeypatch):
    """``push_admitted`` of the REST door: a push takes one credit of the
    route input's gate at once, and a full gate refuses (the door answers
    429) without having queued anything."""

    def scenario(m, mp):
        _plane, node, gate = _input_node(m, mp, PATHWAY_INPUT_QUEUE_ROWS=2)
        state = m.server._RouteServing("/q", ("POST",), None)
        state.node = node
        pushed = [state.push_admitted(k, (k,)) for k in range(4)]
        obs = (pushed, gate.queued, gate.admitted_rows, gate.shed_rows, _keys(node.poll(0)))
        m.flow.shutdown()
        return obs

    assert _both(scenario, monkeypatch) == ([True, True, False, False], 2, 2, 0, [0, 1])


# ------------------------------------------------------------- integration


def _final_state(dst: dict):
    def on_change(key, row, time, is_addition):
        if is_addition:
            dst[key] = tuple(row.values())
        else:
            dst.pop(key, None)

    return on_change


def _run_mixed(pw) -> tuple[dict, dict]:
    """A bulk stream with an upsert-style correction and an interactive
    stream with an immediately retracted pair, each into its own subscriber."""

    class MixedBulk(pw.io.python.ConnectorSubject):
        def run(self):
            for i in range(120):
                self.next(k=1000 + i, x=i)
            self._remove(k=1000, x=0)
            self.next(k=1000, x=999)

    class MixedInteractive(pw.io.python.ConnectorSubject):
        def run(self):
            for i in range(40):
                self.next(k=i, x=i * 2)
                if i == 20:
                    self.next(k=500, x=5)
                    self._remove(k=500, x=5)
                time.sleep(0.001)

    class KS(pw.Schema):
        k: int = pw.column_definition(primary_key=True)
        x: int

    pw.G.clear()
    bulk = pw.io.python.read(MixedBulk(), schema=KS, service_class="bulk", name="bulkstream")
    inter = pw.io.python.read(MixedInteractive(), schema=KS, service_class="interactive", name="interstream")
    bulk_state: dict = {}
    inter_state: dict = {}
    pw.io.subscribe(bulk, on_change=_final_state(bulk_state), service_class="bulk")
    pw.io.subscribe(inter, on_change=_final_state(inter_state))
    _run(pw)
    return bulk_state, inter_state


def test_mixed_streams_byte_identical_on_vs_off(monkeypatch):
    def scenario(m, mp):
        mp.setenv("PATHWAY_FLOW", "off")
        off = _run_mixed(m.pw)
        mp.setenv("PATHWAY_FLOW", "on")
        mp.setenv("PATHWAY_INPUT_QUEUE_ROWS", "16")  # heavy backpressure
        on = _run_mixed(m.pw)
        st = m.monitoring.run_stats(m.pw.internals.run.current_runtime())
        classes = {g["input"].split(":")[0]: g["service_class"] for g in st["flow"]["inputs"]}
        mp.delenv("PATHWAY_INPUT_QUEUE_ROWS")
        return off, on, st["flow"]["shed_rows_total"], classes

    off, on, shed, classes = _both(scenario, monkeypatch)
    assert on == off
    assert len(off[0]) == 120 and 500 not in off[1]
    assert shed == 0
    assert classes == {"bulkstream": "bulk", "interstream": "interactive"}


def test_shed_drops_surface_in_status(monkeypatch):
    def scenario(m, mp):
        mp.setenv("PATHWAY_FLOW", "on")
        mp.setenv("PATHWAY_FLOW_POLICY", "shed")
        mp.setenv("PATHWAY_INPUT_QUEUE_ROWS", "8")
        pw = m.pw

        class Burst(pw.io.python.ConnectorSubject):
            def run(self):
                self.next_batch([{"x": i} for i in range(100)])  # one blast

        pw.G.clear()
        t = pw.io.python.read(Burst(), schema=pw.schema_from_types(x=int), name="burst")
        seen = []
        pw.io.subscribe(t, on_change=lambda **k: seen.append(k))
        _run(pw)
        st = m.monitoring.run_stats(pw.internals.run.current_runtime())
        g = st["flow"]["inputs"][0]
        # exact accounting, whatever tick the blast straddled
        return (
            g["admitted_rows"] + g["shed_rows"],
            g["shed_rows"] == st["flow"]["shed_rows_total"] > 0,
            len(seen) == g["admitted_rows"],
        )

    assert _both(scenario, monkeypatch) == (100, True, True)


def _flow_status_run(m, mp, flow: str):
    """A 40-row interactive stream and a 120-row bulk stream at the default
    knobs: the deterministic part of ``/status``'s ``flow`` section, of the
    timeline's flow sample and of the ``pathway_flow_*`` series."""
    mp.setenv("PATHWAY_FLOW", flow)
    pw = m.pw
    pw.G.clear()
    schema = pw.schema_from_types(x=int)
    inter = pw.io.python.read(_subject(pw, [{"x": i} for i in range(40)]), schema=schema, name="queries")
    bulk = pw.io.python.read(
        _subject(pw, [{"x": i} for i in range(120)]), schema=schema, name="docs", service_class="bulk"
    )
    pw.io.subscribe(inter, on_change=lambda **kw: None)
    pw.io.subscribe(bulk, on_change=lambda **kw: None, service_class="bulk")
    _run(pw)
    rt = pw.internals.run.current_runtime()
    st = m.monitoring.run_stats(rt)
    if "flow" not in st:
        return m.flow.current(), None, None, None
    fl = dict(st["flow"])
    ctl = dict(fl.pop("controller"))
    decisions = ctl.pop("decisions")
    ctl.pop("pressure")
    fl.pop("pressure")
    inputs = [{k: v for k, v in g.items() if k != "blocked_ms"} for g in fl.pop("inputs")]
    summary = (
        fl,
        inputs,
        ctl,
        sorted({(d["action"], d["target"], d["prev_target"]) for d in decisions}),
    )
    raw = m.timeline._raw_sample(rt)["flow"]
    metrics = []
    for line in m.monitoring.prometheus_text(rt).splitlines():
        if line.startswith("pathway_flow_"):
            name, value = line.rsplit(" ", 1)
            metrics.append(name if name == "pathway_flow_pressure" else line)
    return type(m.flow.current()).__name__, summary, (raw["bound"], raw["occupied"], raw["shed_rows"]), metrics


def test_flow_on_status_sections_match_the_reference(monkeypatch):
    """``PATHWAY_FLOW=on`` installs a plane in both packages: the same
    ``/status`` ``flow`` section (policy, bound, per-input classes and
    exact counts, the controller's bucket and decisions), the same timeline
    flow sample and the same ``pathway_flow_*`` series; with ``off`` neither
    installs anything."""
    plane, summary, raw, metrics = _both(lambda m, mp: _flow_status_run(m, mp, "on"), monkeypatch)
    fl, inputs, ctl, decisions = summary
    assert plane == "FlowPlane"
    assert fl == {"policy": "block", "queue_bound": 65536, "cluster_pressure": 0.0, "shed_rows_total": 0}
    assert [(g["input"].split(":")[0], g["service_class"], g["admitted_rows"]) for g in inputs] == [
        ("docs", "bulk", 120),
        ("queries", "interactive", 40),
    ]
    assert all(g["queued"] == g["in_flight"] == 0 for g in inputs)
    assert ctl == {"target_batch": 512, "min_bucket": 8, "max_bucket": 512, "slo_ms": 250.0}
    assert all(8 <= d[1] <= 512 for d in decisions)
    assert raw == (65536, 0, 0)
    assert {line.split("{")[0].split(" ")[0] for line in metrics} == {
        "pathway_flow_queued_rows",
        "pathway_flow_credits_available",
        "pathway_flow_shed_rows_total",
        "pathway_flow_target_batch",
        "pathway_flow_pressure",
    }
    assert _both(lambda m, mp: _flow_status_run(m, mp, "off"), monkeypatch) == (None, None, None, None)


N_BULK = 2000
N_INTER = 50


def _burst_run(m, mp, trace_file: str):
    """A 10x bulk burst against a rate-limited bulk sink beside a paced
    interactive stream, under a 15 ms SLO: every row arrives, the bound holds,
    queries overtake queued bulk rows, and the controller's decisions land in
    the live trace and on ``/status``."""
    pw = m.pw
    bound = 256
    mp.setenv("PATHWAY_FLOW", "on")
    mp.setenv("PATHWAY_INPUT_QUEUE_ROWS", str(bound))
    mp.setenv("PATHWAY_FLOW_BULK_MIN_ROWS", "64")
    mp.setenv("PATHWAY_LATENCY_SLO_MS", "15")  # force AIMD decisions
    mp.setenv("PATHWAY_TRACE", "on")
    mp.setenv("PATHWAY_TRACE_LIVE_FILE", trace_file)

    class KS(pw.Schema):
        k: int = pw.column_definition(primary_key=True)
        x: int

    class BurstBulk(pw.io.python.ConnectorSubject):
        def run(self):
            time.sleep(0.08)  # the burst arrives mid-stream
            for start in range(0, N_BULK, 200):
                self.next_batch([{"k": 10_000 + i, "x": i} for i in range(start, start + 200)])

    class Queries(pw.io.python.ConnectorSubject):
        def run(self):
            for i in range(N_INTER):
                self.next(k=i, x=i)
                time.sleep(0.03)

    pw.G.clear()
    bulk = pw.io.python.read(BurstBulk(), schema=KS, service_class="bulk", name="backfill")
    inter = pw.io.python.read(Queries(), schema=KS, name="queries")
    queries: list[int] = []
    backlog_at_query: list[int] = []
    bulk_seen: list[int] = []
    peak = [0]

    def on_query(**kw):
        queries.append(kw["key"])
        plane = m.flow.current()
        backlog_at_query.append(sum(g.queued + g.in_flight for g in plane.gates))

    def on_bulk(**kw):
        bulk_seen.append(kw["key"])
        if len(bulk_seen) % 16 == 0:
            time.sleep(0.005)  # the rate-limited sink
        for g in m.flow.current().gates:
            peak[0] = max(peak[0], g.queued + g.in_flight)

    pw.io.subscribe(bulk, on_change=on_bulk, service_class="bulk")
    pw.io.subscribe(inter, on_change=on_query)
    _run(pw)
    spans = []
    with open(trace_file) as fh:
        for line in fh:
            spans.extend(json.loads(line)["resourceSpans"][0]["scopeSpans"][0]["spans"])
    ctl = [s for s in spans if s["name"] == "flow/controller"]
    attrs = sorted({a["key"] for s in ctl for a in s["attributes"]})
    actions = {
        a["value"]["stringValue"] for s in ctl for a in s["attributes"] if a["key"] == "pathway.flow.action"
    }
    st = m.monitoring.run_stats(pw.internals.run.current_runtime())
    for k in ("PATHWAY_TRACE", "PATHWAY_TRACE_LIVE_FILE"):
        mp.delenv(k)
    return (
        len(bulk_seen),
        len(set(bulk_seen)),
        len(queries),
        peak[0] <= bound,
        max(backlog_at_query) > 0,
        attrs,
        "decrease" in actions,
        bool(st["flow"]["controller"]["decisions"]),
        st["flow"]["controller"]["target_batch"] < 512,
        st["flow"]["shed_rows_total"],
    )


def test_burst_bounded_queue_priority_and_trace(monkeypatch, tmp_path):
    """The burst case of ``tests/test_flow.py`` with its counts and decisions
    compared; its wall-time bound (interactive p99 within 3x unloaded) is a
    timing of the host and is left to the reference's own test."""
    got = _both(lambda m, mp: _burst_run(m, mp, str(tmp_path / f"{m.pw.__name__}.jsonl")), monkeypatch)
    (n_bulk, n_unique, n_queries, bounded, overtook, attrs, decreased, decided, below_max, shed) = got
    assert (n_bulk, n_unique, n_queries) == (N_BULK, N_BULK, N_INTER)
    assert bounded and overtook and decreased and decided and below_max and shed == 0
    assert {"pathway.flow.action", "pathway.flow.target", "pathway.flow.pressure"} <= set(attrs)


# ----------------------------------------------------------- process state


def test_plane_is_retained_closed_after_a_run_and_replaced_by_the_next(monkeypatch):
    def scenario(m, mp):
        _plane, node, gate = _input_node(m, mp, PATHWAY_INPUT_QUEUE_ROWS=4)
        m.flow.shutdown()
        retained = m.flow.current() is not None and gate.closed
        # a closed gate admits unconditionally so teardown never deadlocks
        node.push_many((i, (i,), 1) for i in range(10))
        after = gate.queued
        mp.setenv("PATHWAY_FLOW", "off")
        return retained, after, m.flow.install_from_env(), m.flow.current()

    assert _both(scenario, monkeypatch) == (True, 10, None, None)
