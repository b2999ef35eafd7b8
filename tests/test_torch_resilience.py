"""The port's resilience plane (``pathway_tpu_torch/resilience``: fault plans,
heartbeats, the supervisor, coordinated checkpoint epochs) against the
reference's (``tests/test_resilience.py``).

The fast cases run each scenario through both packages and assert the same
observations (plans, detector verdicts, recovered rows, epoch manifests,
telemetry events, supervisor attempts). The subprocess-killing recovery
cases run the port's cluster and are marked ``slow``, as the reference marks
them. The reference's ``supervise`` CLI case is not mirrored: the port has no
CLI. The cluster rollup of peers' heartbeat summaries
(``observability/aggregate.py``) is checked against a monitor that holds a
peer's summary.
"""

from __future__ import annotations

import csv
import json
import os
import shutil
import socket
import sys
import textwrap
import time

import pytest

import pathway_tpu
import pathway_tpu_torch
import torch_cluster_helpers as tc
from pathway_tpu.persistence.backends import MemoryBackend as RefMemoryBackend
from pathway_tpu_torch.persistence.backends import MemoryBackend as PortMemoryBackend

PACKAGES = (pathway_tpu, pathway_tpu_torch)
IDS = ("ref", "port")
_MEMORY = {pathway_tpu: RefMemoryBackend, pathway_tpu_torch: PortMemoryBackend}


def _mod(pw, name):
    from importlib import import_module

    return import_module(f"{pw.__name__}.{name}")


@pytest.fixture(autouse=True)
def _fresh():
    for pw in PACKAGES:
        pw.G.clear()
    yield
    for pw in PACKAGES:
        pw.G.clear()
        _mod(pw, "resilience.faults").install(None)


# ---------------------------------------------------------------- fault plans


@pytest.mark.parametrize("pw", PACKAGES, ids=IDS)
def test_fault_plan_parse_roundtrip(pw):
    FaultPlan = pw.resilience.FaultPlan
    plan = FaultPlan.parse(
        "kill:proc=1,tick=40; drop_poll:proc=0,tick=3,count=2 ;delay_barrier:tick=4,ms=250"
    )
    assert len(plan.specs) == 3
    assert plan.to_env() == (
        "kill:proc=1,tick=40;drop_poll:proc=0,tick=3,count=2;delay_barrier:tick=4,ms=250"
    )
    assert FaultPlan.parse(plan.to_env()).to_env() == plan.to_env()
    assert plan.should_kill(1, 40)
    assert not plan.should_kill(1, 39)
    assert not plan.should_kill(0, 40)
    assert plan.should_drop_poll(0, 3) and plan.should_drop_poll(0, 4)
    assert not plan.should_drop_poll(0, 5) and not plan.should_drop_poll(1, 3)
    assert plan.take_barrier_delay(2, 4) is not None
    assert plan.take_barrier_delay(2, 4) is None
    point = FaultPlan.parse("kill_point:point=delivery_staged,count=2")
    assert point.take_point_kill("delivery_staged", 0) is None
    assert point.take_point_kill("delivery_staged", 0) is not None


@pytest.mark.parametrize("pw", PACKAGES, ids=IDS)
def test_fault_plan_rejects_garbage(pw):
    FaultPlan = pw.resilience.FaultPlan
    with pytest.raises(ValueError, match="unknown fault action"):
        FaultPlan.parse("explode:tick=1")
    with pytest.raises(ValueError, match="unknown fault option"):
        FaultPlan.parse("kill:when=later")


def test_fault_drop_poll_single_process_still_completes():
    """A dropped poll delays events by a tick; the bounded run still produces
    the full result and records the injection, in both packages."""
    got_by = {}
    for pw in PACKAGES:
        telemetry = _mod(pw, "internals.telemetry")
        faults = _mod(pw, "resilience.faults")
        telemetry.clear_events()
        faults.install(pw.resilience.FaultPlan.parse("drop_poll:proc=0,tick=1,count=2"))
        try:
            pw.G.clear()

            class Subject(pw.io.python.ConnectorSubject):
                def run(self):
                    for i in range(5):
                        self.next(x=i)
                        time.sleep(0.01)

            t = pw.io.python.read(Subject(), schema=pw.schema_from_types(x=int), name="src")
            got = {}
            pw.io.subscribe(t, on_change=lambda key, row, time, is_addition, got=got: got.__setitem__(row["x"], is_addition))
            pw.run(monitoring_level="none")
        finally:
            faults.install(None)
        assert telemetry.events("resilience.fault_drop_poll")
        got_by[pw.__name__] = got
    assert got_by["pathway_tpu_torch"] == got_by["pathway_tpu"]
    assert sorted(got_by["pathway_tpu_torch"]) == [0, 1, 2, 3, 4]


@pytest.mark.parametrize("pw", PACKAGES, ids=IDS)
def test_other_worker_error_fields(pw):
    errors = _mod(pw, "internals.errors")
    e = errors.OtherWorkerError("p1 died", process_id=1, tick=17, reason="disconnected")
    assert isinstance(e, errors.EngineError)
    assert (e.process_id, e.tick, e.reason) == (1, 17, "disconnected")
    d = errors.OtherWorkerError("unknown peer")
    assert (d.process_id, d.tick, d.reason) == (None, None, "unknown")
    assert pw.resilience.OtherWorkerError is errors.OtherWorkerError


# ---------------------------------------------------------------- heartbeats


def _hb_connect(port: int):
    return socket.create_connection(("127.0.0.1", port), timeout=5)


def _wait(cond, timeout=5.0):
    deadline = time.time() + timeout
    while not cond() and time.time() < deadline:
        time.sleep(0.01)
    return cond()


@pytest.mark.parametrize("pw", PACKAGES, ids=IDS)
def test_heartbeat_monitor_detects_abrupt_disconnect(pw):
    heartbeat = _mod(pw, "resilience.heartbeat")
    mon = heartbeat.HeartbeatMonitor(2, 0, timeout=30.0)
    try:
        sock = _hb_connect(mon.port)
        heartbeat._send(sock, ("hb", 1, 7))
        assert _wait(lambda: mon.seen_peers().get(1) == 7)
        assert mon.seen_peers() == {1: 7}
        assert mon.dead_peer() is None
        sock.close()
        assert _wait(lambda: mon.dead_peer() is not None)
        assert mon.dead_peer() == (1, 7, "disconnected")
    finally:
        mon.close()


@pytest.mark.parametrize("pw", PACKAGES, ids=IDS)
def test_heartbeat_monitor_clean_goodbye_is_not_death(pw):
    heartbeat = _mod(pw, "resilience.heartbeat")
    mon = heartbeat.HeartbeatMonitor(2, 0, timeout=0.2)
    try:
        sock = _hb_connect(mon.port)
        heartbeat._send(sock, ("hb", 1, 3))
        heartbeat._send(sock, ("bye", 1, 4))
        sock.close()
        time.sleep(0.4)
        assert mon.dead_peer() is None
    finally:
        mon.close()


@pytest.mark.parametrize("pw", PACKAGES, ids=IDS)
def test_heartbeat_monitor_detects_silence_and_records_miss(pw):
    heartbeat = _mod(pw, "resilience.heartbeat")
    telemetry = _mod(pw, "internals.telemetry")
    telemetry.clear_events()
    mon = heartbeat.HeartbeatMonitor(2, 0, timeout=0.15)
    try:
        sock = _hb_connect(mon.port)
        heartbeat._send(sock, ("hb", 1, 2))
        assert _wait(lambda: mon.dead_peer() is not None)
        assert mon.dead_peer() == (1, 2, "heartbeat-timeout")
        misses = telemetry.events("resilience.heartbeat_miss")
        assert misses and misses[0]["attrs"]["process_id"] == 1
        sock.close()
    finally:
        mon.close()


@pytest.mark.parametrize("pw", PACKAGES, ids=IDS)
def test_heartbeat_client_flags_lost_coordinator(pw):
    heartbeat = _mod(pw, "resilience.heartbeat")
    mon = heartbeat.HeartbeatMonitor(2, 0, timeout=5.0)
    client = heartbeat.HeartbeatClient(1, mon.port, interval=0.05)
    try:
        assert _wait(lambda: 1 in mon.seen_peers())
        mon.close()
        assert _wait(lambda: client.coordinator_lost)
    finally:
        client.goodbye()
        mon.close()


def test_heartbeat_summaries_roll_up_on_the_coordinator():
    """A peer's heartbeat summary (``aggregate.local_summary``) lands in the
    coordinator's ``/status`` rollup (``cluster_status``): the same keys in
    both packages, and the port's timeline plane folds the peer's points into
    its pod series."""
    out = {}
    for pw in PACKAGES:
        heartbeat = _mod(pw, "resilience.heartbeat")
        aggregate = _mod(pw, "observability.aggregate")
        mon = heartbeat.HeartbeatMonitor(2, 0, timeout=30.0)
        try:
            sock = _hb_connect(mon.port)
            summary = {"tick": 5, "watermark": None, "backlog_rows": 3, "rows_in": 10, "rows_out": 4,
                       "sink_latency": {}, "audit": {"violations": 1, "by_kind": {"x": 1}, "divergences": 0,
                                                     "shadow_ticks": 2, "recent": []},
                       "device": {"compiles": 2, "compile_s": 0.5, "shapes_max": 1, "pad_rows": [1, 2]}}
            heartbeat._send(sock, ("hb", 1, 5, summary))
            assert _wait(lambda: (mon.peer_summaries().get(1) or {}).get("tick") == 5)

            class _Rt:
                hb_monitor = mon
                scheduler = None

            status = aggregate.cluster_status(_Rt())
            sock.close()
        finally:
            mon.close()
        out[pw.__name__] = {
            k: v for k, v in status.items() if k not in ("processes",)
        }, sorted(status["processes"]), status["processes"]["1"]["tick"]
    assert out["pathway_tpu_torch"][1:] == out["pathway_tpu"][1:] == (["0", "1"], 5)
    port, ref = out["pathway_tpu_torch"][0], out["pathway_tpu"][0]
    for key in ("n_reporting", "tick_min", "tick_max", "backlog_rows", "audit"):
        assert port[key] == ref[key], key
    assert port["audit"]["violations"] == 1


# ------------------------------------------------- in-process recovery smoke


def _word_session(pw, rows, backend):
    pw.G.clear()

    class ListSubject(pw.io.python.ConnectorSubject):
        def run(self):
            for w, c in rows:
                self.next(word=w, count=c)

    t = pw.io.python.read(ListSubject(), schema=pw.schema_from_types(word=str, count=int), name="src")
    agg = t.groupby(pw.this.word).reduce(pw.this.word, total=pw.reducers.sum(pw.this.count))
    got = {}
    pw.io.subscribe(
        agg,
        on_change=lambda key, row, time, is_addition: got.__setitem__(row["word"], row["total"])
        if is_addition
        else None,
    )
    pw.run(
        monitoring_level="none",
        persistence_config=pw.persistence.Config(backend=backend, persistence_mode="operator_persisting"),
    )
    return got


@pytest.mark.parametrize("n_workers", [1, 2])
def test_memory_backend_restart_smoke(n_workers, monkeypatch):
    """A fresh runtime over the same store recovers O(state + suffix),
    advances the epoch manifest and records the replay: the same rows,
    offsets and acks in both packages, on 1 and on 2 workers."""
    monkeypatch.setenv("PATHWAY_THREADS", str(n_workers))
    first = [("a", 1), ("b", 2), ("a", 3)]
    second = [("b", 10), ("c", 5)]
    seen = {}
    for pw in PACKAGES:
        root = f"{pw.__name__}-resilience-smoke-{n_workers}"
        _MEMORY[pw].clear(root)
        backend = pw.persistence.Backend("memory", root)
        telemetry = _mod(pw, "internals.telemetry")
        r1 = _word_session(pw, first, backend)
        ep1 = pw.resilience.last_committed_epoch(backend)
        telemetry.clear_events()
        r2 = _word_session(pw, first + second, backend)
        replays = telemetry.events("resilience.replay")
        ep2 = pw.resilience.last_committed_epoch(backend)
        stats = _mod(pw, "internals.monitoring").run_stats(pw.internals.run.current_runtime())
        seen[pw.__name__] = (r1, r2, ep1["input_offsets"], ep1["acks"], ep2["input_offsets"],
                             ep2["epoch"] > ep1["epoch"], stats["resilience"]["last_committed_epoch"] == ep2["epoch"],
                             bool(replays) and replays[0]["attrs"]["events"] < len(first + second))
        _MEMORY[pw].clear(root)
    assert seen["pathway_tpu_torch"] == seen["pathway_tpu"]
    r1, r2, off1, acks, off2, advanced, on_status, suffix_only = seen["pathway_tpu_torch"]
    assert r1 == {"a": 4, "b": 2} and r2 == {"b": 12, "c": 5}
    assert off1 == {"src": len(first)} and acks == [0] and off2 == {"src": len(first + second)}
    assert advanced and on_status and suffix_only


@pytest.mark.parametrize("pw", PACKAGES, ids=IDS)
def test_resilience_events_exported_in_otlp_docs(pw, tmp_path):
    telemetry = _mod(pw, "internals.telemetry")
    telemetry.clear_events()
    telemetry.record_event("resilience.heartbeat_miss", process_id=1, tick=3)
    telemetry.record_event("resilience.epoch_committed", epoch=7, tick=9)
    telemetry.record_event("resilience.replay", events=12, n_inputs=1)

    class _Rt:
        scheduler = None

    trace_doc = telemetry.export_run_trace(_Rt(), str(tmp_path / "t.json"), 0, 1)
    names = [s["name"] for s in trace_doc["resourceSpans"][0]["scopeSpans"][0]["spans"]]
    assert "event/resilience.heartbeat_miss" in names
    assert "event/resilience.epoch_committed" in names
    metrics_doc = telemetry.export_run_metrics(_Rt(), str(tmp_path / "m.json"), 1)
    gauges = {m["name"] for m in metrics_doc["resourceMetrics"][0]["scopeMetrics"][0]["metrics"]}
    assert {
        "pathway.resilience.heartbeat_misses",
        "pathway.resilience.replayed_events",
        "pathway.resilience.last_committed_epoch",
    } <= gauges
    telemetry.clear_events()


# ---------------------------------------------------------------- supervisor

_FLAKY_CHILD = textwrap.dedent(
    """
    import os, sys
    marker = sys.argv[1]
    if not os.path.exists(marker):
        open(marker, "w").close()
        sys.exit(3)  # first launch fails
    sys.exit(0)  # relaunch succeeds
    """
)


@pytest.mark.parametrize("pw", PACKAGES, ids=IDS)
def test_supervisor_restarts_until_success(pw, tmp_path):
    script = tmp_path / "flaky.py"
    script.write_text(_FLAKY_CHILD)
    telemetry = _mod(pw, "internals.telemetry")
    telemetry.clear_events()
    sup = pw.resilience.Supervisor(
        [sys.executable, str(script), str(tmp_path / "marker")],
        processes=1, max_restarts=3, backoff_s=0.05, log_dir=str(tmp_path / "logs"),
    )
    result = sup.run()
    assert result.restarts == 1
    assert [a["exit_codes"] for a in result.attempts] == [[3], [0]]
    assert len(result.log_paths) == 2 and all(os.path.exists(p) for p in result.log_paths)
    restarts = telemetry.events("resilience.restart")
    assert restarts and restarts[0]["attrs"]["exit_code"] == 3


@pytest.mark.parametrize("pw", PACKAGES, ids=IDS)
def test_supervisor_gives_up_after_budget(pw, tmp_path):
    script = tmp_path / "alwaysfail.py"
    script.write_text("import sys; sys.exit(2)\n")
    sup = pw.resilience.Supervisor([sys.executable, str(script)], processes=1, max_restarts=1, backoff_s=0.05)
    with pytest.raises(pw.resilience.SupervisorGaveUp) as exc:
        sup.run()
    assert len(exc.value.attempts) == 2
    assert all(a["exit_codes"] == [2] for a in exc.value.attempts)


@pytest.mark.parametrize("pw", PACKAGES, ids=IDS)
def test_supervisor_clears_fault_plan_after_failure(pw, tmp_path):
    script = tmp_path / "envcheck.py"
    script.write_text("import os, sys; sys.exit(4 if os.environ.get('PATHWAY_FAULT_PLAN') else 0)\n")
    env = dict(os.environ, PATHWAY_FAULT_PLAN="kill:proc=0,tick=5")
    sup = pw.resilience.Supervisor([sys.executable, str(script)], processes=1, max_restarts=2, backoff_s=0.05, env=env)
    assert sup.run().restarts == 1


def test_rescale_exit_codes_agree():
    from pathway_tpu_torch import elastic
    from pathway_tpu_torch.resilience import supervisor

    assert supervisor.RESCALE_EXIT_CODE == elastic.RESCALE_EXIT_CODE == _mod(pathway_tpu, "elastic").RESCALE_EXIT_CODE


# ----------------------------------------------------- cluster recovery (slow)


@pytest.mark.slow
def test_cluster_peer_killed_midrun_raises_other_worker_error(tmp_path):
    """SIGKILL a peer mid-run (``kill`` fault): the coordinator raises a
    structured ``OtherWorkerError`` naming it, detected by heartbeat EOF well
    before ``barrier_timeout``."""
    results = tc.launch(
        lambda pid: [sys.executable, tc.__file__, "streaming_sum", str(tmp_path / "s")],
        2,
        env={"PATHWAY_BARRIER_TIMEOUT": "60", "PATHWAY_FAULT_PLAN": "kill:proc=1,tick=10"},
        timeout=90,
    )
    (rc0, out0), (rc1, out1) = results
    assert rc1 == -9, out1
    assert rc0 != 0
    assert "OtherWorkerError" in out0, out0
    assert "cluster process 1 failed" in out0, out0


@pytest.mark.slow
def test_supervisor_cluster_kill_recovery(tmp_path):
    """A 2-process cluster with persistence, SIGKILLed mid-stream, restarted
    by the Supervisor from the last committed global epoch: final output
    equals an uninterrupted run's, with fewer events replayed than the whole
    history and both processes' acks on the epoch."""
    broker_path = str(tmp_path / "broker")
    broker = pathway_tpu_torch.io.kafka.MockKafkaBroker(path=broker_path)
    broker.create_topic("words", partitions=2)
    first = [f"w{i % 11}" for i in range(80)] + [f"only{i % 3}" for i in range(20)]
    second = [f"w{i % 11}" for i in range(100)]
    for i, w in enumerate(first):
        broker.produce("words", w, partition=i % 2)
    out = str(tmp_path / "run")
    env = dict(
        os.environ,
        PYTHONPATH=os.pathsep.join([tc.REPO, tc.TESTS]),
        BROKER_PATH=broker_path,
        PSTORE=str(tmp_path / "pstore"),
        EXPECTED_WORDS=str(len(first) + len(second)),
        SNAPSHOT_INTERVAL_MS="150",
        PATHWAY_BARRIER_TIMEOUT="45",
        PATHWAY_FAULT_PLAN="kill:proc=1,tick=100",
        PATHWAY_METRICS_FILE=out + ".metrics",
    )

    def on_restart(attempt, codes):
        shutil.copy(out + ".csv", out + ".first.csv")
        for i, w in enumerate(second):
            broker.produce("words", w, partition=i % 2)

    sup = pathway_tpu_torch.resilience.Supervisor(
        [sys.executable, tc.__file__, "persist_words", out],
        processes=2, threads=1, first_port=tc.first_port(2), max_restarts=2, backoff_s=0.2,
        env=env, log_dir=str(tmp_path / "logs"), on_restart=on_restart,
    )
    result = sup.run()
    assert result.restarts == 1, result.attempts

    def net(fp):
        state: dict = {}
        with open(fp) as fh:
            for rec in csv.DictReader(fh):
                w, c, d = rec["data"], int(rec["c"]), int(rec["diff"])
                state[w] = state.get(w, 0) + c * d
                if state[w] == 0:
                    del state[w]
        return state

    truth: dict = {}
    for w in first + second:
        truth[w] = truth.get(w, 0) + 1
    assert net(out + ".csv") == truth
    run1, final = tc.read(out + ".first.csv"), tc.read(out + ".csv")
    assert final.startswith(run1)
    assert "only" not in final[len(run1):]
    with open(out + ".metrics.p0") as fh:
        doc = json.load(fh)
    gauges = {m["name"]: m for m in doc["resourceMetrics"][0]["scopeMetrics"][0]["metrics"]}
    replayed = int(gauges["pathway.resilience.replayed_events"]["gauge"]["dataPoints"][0]["asInt"])
    assert replayed < len(first) + len(second), replayed
    ep = pathway_tpu_torch.resilience.last_committed_epoch(
        pathway_tpu_torch.persistence.Backend.filesystem(env["PSTORE"])
    )
    assert ep is not None and ep["acks"] == [0, 1] and ep["opsnap_gen"] is not None


@pytest.mark.slow
def test_flight_dump_names_failed_proc_and_tick_on_cluster_kill(tmp_path):
    """A ``kill`` fault on a peer mid-stream (``tests/test_device_profiling.py``):
    the surviving coordinator's flight-recorder dump names the failed
    process and its last known tick."""
    flight = tmp_path / "flight"
    (rc0, out0), (rc1, out1) = tc.launch(
        lambda pid: [sys.executable, tc.__file__, "streaming_sum", str(tmp_path / "s")],
        2,
        env={"PATHWAY_BARRIER_TIMEOUT": "60", "PATHWAY_FAULT_PLAN": "kill:proc=1,tick=10",
             "PATHWAY_FLIGHT_DIR": str(flight)},
        timeout=90,
    )
    assert rc1 == -9, out1
    assert rc0 != 0
    dumps = sorted(flight.glob("flight_p0_*.json"))
    assert dumps, out0
    doc = json.loads(dumps[-1].read_text())
    assert doc["reason"] == "other_worker_error"
    assert doc["error"]["type"] == "OtherWorkerError"
    assert doc["error"]["process_id"] == 1
    assert isinstance(doc["error"]["tick"], int)
    assert doc["ticks"], "the flight recorder captured no recent ticks"
