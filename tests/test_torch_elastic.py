"""The elasticity plane on the port: a mirror of the reference's
``tests/test_elastic.py`` with ``pathway_tpu_torch`` in place of
``pathway_tpu``, each case holding the port to the same expectations on the
same inputs (versioned membership and its stale guards, input-log
rebucketing, the autoscaler's hysteresis, bounds and cooldown, supervisor
rescale accounting, the config knobs, the sharded-sink part-count guard, an
in-process reshard by replay). The reshard smoke and the input-log rebucket
also run the reference on the same inputs and compare.

Changed against the reference: ``scale`` runs through the port's
``argparse`` command line (``cli.main``); the supervisor-rescale case
asserts that no backoff was slept from the attempts, the restart count and a
wall time below the ``backoff_s`` it sets (the reference's 4 s wall-clock
bound failed on loaded test machines); cluster ports come from
``torch_cluster_helpers.first_port``. The subprocess join/drain and
autoscale acceptance tests stay ``@pytest.mark.slow``.
"""

from __future__ import annotations

import csv as _csv
import json
import os
import pickle
import socket
import sys
import textwrap
import threading
import time

import pytest

import pathway_tpu_torch as pw
from pathway_tpu_torch import elastic
from pathway_tpu_torch.elastic import (
    AutoscalerPolicy,
    Membership,
    membership,
    reshard,
)
from pathway_tpu_torch.internals import telemetry
from pathway_tpu_torch.internals.config import get_pathway_config
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.persistence.backends import FileBackend, MemoryBackend
from pathway_tpu_torch.resilience import Supervisor, heartbeat, supervisor as supervisor_mod


@pytest.fixture(autouse=True)
def _no_reshard_record_leaks(monkeypatch):
    """A reshard restore keeps its record for the process's life, and later
    test files in the same worker compare ``/status`` and ``/metrics`` of
    both packages: each case here starts and leaves both records empty."""
    import pathway_tpu.elastic as ref_elastic

    monkeypatch.setattr(elastic, "_LAST_RESHARD", {})
    monkeypatch.setattr(ref_elastic, "_LAST_RESHARD", {})

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------------- membership


def test_membership_commit_read_history_roundtrip():
    MemoryBackend.clear("m-rt")
    b = MemoryBackend("m-rt")
    assert elastic.read_membership(b) is None
    m0 = membership.commit_membership(
        b, Membership(version=0, processes=2, threads=1, status={0: "active", 1: "active"})
    )
    m1 = membership.commit_membership(
        b,
        Membership(
            version=1, processes=3, threads=1, epoch=7, reason="manual:cli",
            status={0: "active", 1: "active", 2: "active"},
        ),
    )
    got = elastic.read_membership(b)
    assert got is not None and got.version == 1 and got.processes == 3
    assert got.epoch == 7 and got.reason == "manual:cli"
    assert got.n_workers == 3
    assert set(got.key_ranges()) == {0, 1, 2}
    hist = elastic.membership_history(b)
    assert [(m.version, m.processes) for m in hist] == [(0, 2), (1, 3)]
    assert m0.committed_unix <= m1.committed_unix


def test_membership_stale_version_guard_warns_once():
    membership.reset_stale_warnings()
    telemetry.clear_events()
    assert membership.check_version(3, 3, "hb:p1")
    assert membership.check_version(3, None, "hb:p1")  # unstamped = legacy, ok
    assert not membership.check_version(3, 2, "hb:p1")
    assert not membership.check_version(3, 2, "hb:p1")  # repeated: no re-warn
    events = telemetry.events("elastic.stale_membership_version")
    assert len(events) == 1
    assert events[0]["attrs"] == {"source": "hb:p1", "incoming": 2, "current": 3}


def test_moved_fraction_exact():
    assert reshard.moved_fraction(2, 2) == 0.0
    # mod-lcm census: 2→4 keeps residues {0,1} of 4 in place, moves {2,3}
    assert reshard.moved_fraction(2, 4) == 0.5
    assert 0.0 < reshard.moved_fraction(2, 3) <= 1.0
    assert reshard.moved_fraction(3, 2) == reshard.moved_fraction(3, 2)


def test_rescale_exit_code_pinned_to_supervisor():
    # the supervisor deliberately duplicates the constant (no import-order
    # coupling with the plane); this assertion keeps the two from drifting
    assert elastic.RESCALE_EXIT_CODE == supervisor_mod.RESCALE_EXIT_CODE == 75


# ------------------------------------------------------------- scale requests


def test_scale_request_roundtrip_and_cli(tmp_path, capsys):
    b = FileBackend(str(tmp_path / "pstore"))
    assert elastic.read_scale_request(b) is None
    req = elastic.write_scale_request(b, 4, source="test")
    got = elastic.read_scale_request(b)
    assert got["target"] == 4 and got["source"] == "test"
    assert got["requested_unix"] == pytest.approx(req["requested_unix"])
    membership.clear_scale_request(b)
    assert elastic.read_scale_request(b) is None
    with pytest.raises(ValueError):
        elastic.write_scale_request(b, 0)

    from pathway_tpu_torch.cli import main

    assert main(["scale", "--to", "3", "--storage", str(tmp_path / "pstore")]) == 0
    assert "3 process(es)" in capsys.readouterr().out
    assert elastic.read_scale_request(b)["target"] == 3
    assert main(["scale", "--to", "0", "--storage", str(tmp_path)]) != 0


def test_scale_http_endpoint_and_status_section(monkeypatch):
    from pathway_tpu_torch.internals.monitoring import _scale_payload

    # plane off: clear error
    monkeypatch.setenv("PATHWAY_ELASTIC", "off")
    elastic.install_from_env(object())
    doc = json.loads(_scale_payload(None, "to=3"))
    assert doc["ok"] is False and "PATHWAY_ELASTIC" in doc["error"]

    MemoryBackend.clear("scale-http")

    class _P:
        backend = MemoryBackend("scale-http")

    class _Rt:
        pid = 0
        persistence = _P()

    monkeypatch.setenv("PATHWAY_ELASTIC", "manual")
    elastic.install_from_env(_Rt())
    try:
        plane = elastic.current()
        assert plane is not None and plane.mode == "manual"
        # installing on the coordinator commits the initial membership
        assert plane.membership is not None and plane.membership.version == 0
        doc = json.loads(_scale_payload(None, ""))
        assert doc["ok"] and doc["elastic"]["mode"] == "manual"
        doc = json.loads(_scale_payload(None, "to=3"))
        assert doc["ok"] and doc["target"] == 3
        assert plane._manual_target == 3
        doc = json.loads(_scale_payload(None, "to=0"))
        assert doc["ok"] is False
        st = plane.status()
        assert st["membership"]["version"] == 0
        assert st["processes"] == 1
    finally:
        elastic.shutdown()


def test_scale_request_on_peer_forwards_through_backend(monkeypatch):
    """Review fix: only the coordinator's plane is consulted at the barrier —
    a /scale landing on a PEER's monitoring server must forward through the
    shared backend (the CLI's channel), not vanish into a local field."""
    MemoryBackend.clear("scale-peer")

    class _P:
        backend = MemoryBackend("scale-peer")

    class _Peer:
        pid = 1
        persistence = _P()

    monkeypatch.setenv("PATHWAY_ELASTIC", "manual")
    elastic.install_from_env(_Peer())
    try:
        plane = elastic.current()
        doc = plane.request_scale(4, source="http")
        assert doc["ok"] and doc.get("forwarded")
        assert plane._manual_target is None  # nothing parked locally
        req = elastic.read_scale_request(_P.backend)
        assert req["target"] == 4 and req["source"] == "http:forwarded"
    finally:
        elastic.shutdown()


def test_scale_endpoint_distinguishes_off_from_not_installed(monkeypatch):
    from pathway_tpu_torch.internals.monitoring import _scale_payload

    monkeypatch.setenv("PATHWAY_ELASTIC", "manual")
    elastic.shutdown()  # no plane installed, but the knob is on
    doc = json.loads(_scale_payload(None, "to=3"))
    assert doc["ok"] is False
    assert "not active on this runtime" in doc["error"], doc


def test_autoscaler_cooldown_survives_relaunch(monkeypatch):
    """Review fix: every scale decision ends the process, so in-memory
    cooldown state dies with it — the relaunched plane must seed cooldown
    from the membership commit or replay backlog chains joins to max."""
    MemoryBackend.clear("cooldown")
    b = MemoryBackend("cooldown")
    membership.commit_membership(
        b, Membership(version=1, processes=3, threads=1, reason="autoscale_join")
    )

    class _P:
        backend = b

    class _Rt:
        pid = 0
        persistence = _P()

    monkeypatch.setenv("PATHWAY_ELASTIC", "auto")
    monkeypatch.setenv("PATHWAY_ELASTIC_SUSTAIN_TICKS", "2")
    elastic.install_from_env(_Rt())
    try:
        plane = elastic.current()
        assert plane.policy.last_decision_at is not None, (
            "cooldown not seeded from the membership commit"
        )
        # post-relaunch replay noise: saturated readings decide nothing
        for _ in range(20):
            assert plane.policy.observe(3, 1.0) is None
    finally:
        elastic.shutdown()
    # an INITIAL membership (fresh pod, never rescaled) seeds nothing
    MemoryBackend.clear("cooldown2")
    b2 = MemoryBackend("cooldown2")
    membership.commit_membership(
        b2, Membership(version=0, processes=2, threads=1, reason="initial")
    )

    class _P2:
        backend = b2

    class _Rt2:
        pid = 0
        persistence = _P2()

    elastic.install_from_env(_Rt2())
    try:
        assert elastic.current().policy.last_decision_at is None
    finally:
        elastic.shutdown()


# ------------------------------------------------------------- reshard


def _make_log(backend, pid, events, reader=None, trimmed=0):
    backend.put(f"inputs/{pid}/chunk_{0:08d}", pickle.dumps(events))
    backend.put(
        f"inputs/{pid}/metadata",
        pickle.dumps(
            {
                "offset": trimmed + len(events),
                "chunks": 1,
                "reader": reader,
                "first_chunk": 1 if trimmed else 0,
                "trimmed_events": trimmed,
                "chunk_sizes": [len(events)],
            }
        ),
    )


def test_reshard_input_logs_rebucket_exactly_once():
    """Scale-in 3→2: the orphan worker's log re-owns by key range; every
    event lands in exactly one new log; movement accounting is exact."""
    from pathway_tpu_torch.parallel.mesh import shard_of_keys
    import numpy as np

    MemoryBackend.clear("rs-1")
    b = MemoryBackend("rs-1")
    all_events = {}
    for w in range(3):
        evs = [(w * 100 + i, (f"v{w}-{i}",), 1) for i in range(10)]
        _make_log(b, "src" if w == 0 else f"src@w{w}", evs)
        for e in evs:
            all_events[e[0]] = e
    # a second, non-partitioned source must be untouched
    _make_log(b, "solo", [(7, ("x",), 1)])

    assert elastic.orphan_workers(b, 2) == {"src": [2]}
    assert elastic.orphan_workers(b, 3) == {}
    stats = elastic.reshard_input_logs(b, 2)
    assert stats.rows_total == 30 and stats.sources == ["src"]
    assert stats.new_workers == 2 and stats.old_workers == 3
    assert 0 < stats.rows_moved <= 30 and stats.bytes_moved > 0
    seen = {}
    for w in range(2):
        pid = "src" if w == 0 else f"src@w{w}"
        raw = b.get(f"inputs/{pid}/chunk_{0:08d}")
        events = pickle.loads(raw)
        meta = pickle.loads(b.get(f"inputs/{pid}/metadata"))
        assert meta["offset"] == len(events) and meta["reader"] is None
        # the flag _PersistedInput uses to disable the now-unsound prefix-drop
        assert meta["resharded"] is True
        for e in events:
            assert e[0] not in seen, "event duplicated across logs"
            seen[e[0]] = e
            owner = int(shard_of_keys(np.array([e[0]], dtype=np.uint64), 2)[0])
            assert owner == w, "event landed off its key range"
    assert seen == all_events, "events lost in rebucketing"
    assert b.get("inputs/src@w2/metadata") is None  # orphan log removed
    assert pickle.loads(b.get("inputs/solo/chunk_00000000")) == [(7, ("x",), 1)]


def test_reshard_input_logs_refuses_compacted_history():
    MemoryBackend.clear("rs-2")
    b = MemoryBackend("rs-2")
    _make_log(b, "src", [(1, ("a",), 1)])
    _make_log(b, "src@w1", [(2, ("b",), 1)], trimmed=5)
    with pytest.raises(RuntimeError, match="compacted"):
        elastic.reshard_input_logs(b, 1)


def test_reshard_drops_seek_state_with_warning():
    MemoryBackend.clear("rs-3")
    b = MemoryBackend("rs-3")
    telemetry.clear_events()
    _make_log(b, "src", [(1, ("a",), 1)], reader={"p0": 4})
    _make_log(b, "src@w1", [(2, ("b",), 1)])
    _make_log(b, "src@w2", [(3, ("c",), 1)])
    stats = elastic.reshard_input_logs(b, 2)
    assert stats.seek_states_dropped == 1
    assert telemetry.events("elastic.reshard_seek_state_dropped")


# ------------------------------------------------------------- autoscaler


def test_autoscaler_join_needs_sustained_pressure():
    p = AutoscalerPolicy(
        min_processes=1, max_processes=4, high_pressure=0.7, low_pressure=0.1,
        sustain_ticks=3, cooldown_s=100.0,
    )
    now = 1000.0
    assert p.observe(2, 0.9, now=now) is None
    assert p.observe(2, 0.95, now=now) is None
    # one in-band reading resets the streak — hysteresis, not a counter leak
    assert p.observe(2, 0.3, now=now) is None
    assert p.observe(2, 0.9, now=now) is None
    assert p.observe(2, 0.9, now=now) is None
    d = p.observe(2, 0.9, now=now)
    assert d is not None and d["target"] == 3 and d["reason"] == "autoscale_join"
    assert d["from"] == 2 and d["streak"] == 3
    # cooldown: an immediately-following saturated run decides nothing
    for _ in range(10):
        assert p.observe(3, 1.0, now=now + 1) is None
    # past the cooldown it can decide again
    for _ in range(2):
        assert p.observe(3, 1.0, now=now + 200) is None
    assert p.observe(3, 1.0, now=now + 200)["target"] == 4


def test_autoscaler_bounds_and_drain():
    p = AutoscalerPolicy(
        min_processes=2, max_processes=3, high_pressure=0.7, low_pressure=0.1,
        sustain_ticks=2, cooldown_s=0.0,
    )
    # at max: sustained saturation decides nothing
    for _ in range(5):
        assert p.observe(3, 1.0, now=0.0) is None
    # sustained idle drains…
    assert p.observe(3, 0.0, now=0.0) is None
    d = p.observe(3, 0.0, now=0.0)
    assert d is not None and d["target"] == 2 and d["reason"] == "autoscale_drain"
    # …but never below min
    for _ in range(5):
        assert p.observe(2, 0.0, now=10.0) is None
    st = p.status()
    assert st["min_processes"] == 2 and st["decisions"]


def test_autoscaler_p99_breach_counts_as_saturation():
    p = AutoscalerPolicy(
        min_processes=1, max_processes=4, high_pressure=0.9, low_pressure=0.1,
        sustain_ticks=2, cooldown_s=0.0, slo_ms=100.0,
    )
    # low pressure but p99 over the SLO: still saturated where it matters
    assert p.observe(1, 0.2, p99_s=0.5, now=0.0) is None
    d = p.observe(1, 0.2, p99_s=0.5, now=0.0)
    assert d is not None and d["reason"] == "autoscale_join"
    with pytest.raises(ValueError, match="hysteresis"):
        AutoscalerPolicy(low_pressure=0.8, high_pressure=0.7)


def test_autoscaler_windowed_p99_reads_sink_histograms():
    """Review fix: the p99 window must hand Histogram.quantile a snapshot
    with the 'count' key (it returned None unconditionally without it — the
    SLO-breach half of the saturation signal was dead code end-to-end)."""
    from pathway_tpu_torch.observability.metrics import run_metrics

    p = AutoscalerPolicy(min_processes=1, max_processes=4, sustain_ticks=2, slo_ms=100.0)
    rm = run_metrics()
    rm.observe_sink_latency("elastic-p99-test:1", 0.4)
    v = p.windowed_p99_s()
    assert v is not None and v >= 0.4  # log-2 bucket upper bound
    # the window is a positional delta: a second read with no new
    # observations sees an empty window
    assert p.windowed_p99_s() is None
    rm.observe_sink_latency("elastic-p99-test:1", 0.3)
    assert p.windowed_p99_s() is not None
    # padded merge: mismatched counts-list lengths must not truncate the tail
    assert p._pad_sum([1, 2], [0, 0, 5]) == [1, 2, 5]
    assert p._pad_sum([0, 0, 7], [0, 0, 0, 3], -1) == [0, 0, 7, -3]


def test_supervisor_rescale_target_accepts_backend_objects(tmp_path):
    """Review fix: storage= may be a KVBackend or persistence.Backend, not
    only a filesystem path — an S3-persisted pod's rescale must not die on a
    hardcoded FileBackend read."""
    MemoryBackend.clear("sup-backend")
    b = MemoryBackend("sup-backend")
    membership.commit_membership(
        b, Membership(version=1, processes=5, threads=1, reason="manual")
    )
    sup = Supervisor([sys.executable, "-c", "pass"], processes=2, storage=b)
    assert sup._rescale_target() == 5
    sup2 = Supervisor(
        [sys.executable, "-c", "pass"],
        processes=2,
        storage=pw.persistence.Backend("memory", "sup-backend"),
    )
    assert sup2._rescale_target() == 5


def test_sharded_sink_stale_check_survives_glob_metacharacters(tmp_path, monkeypatch):
    """Review fix: a sink path containing glob metacharacters must not
    silently disable stale-part detection."""
    monkeypatch.delenv("PATHWAY_ELASTIC", raising=False)
    out = str(tmp_path / "out[2024].csv")
    open(out + ".part-0005", "w").close()
    G.clear()
    t = pw.debug.table_from_rows(pw.schema_from_types(x=int), [(1,)])
    pw.io.fs.write(t, out, format="csv", sharded=True)
    with pytest.raises(RuntimeError, match="at least 6 workers"):
        pw.run(monitoring_level="none", n_workers=2)


# ------------------------------------------------------------- config knobs


def test_elastic_knobs_defaults_and_to_dict(monkeypatch):
    for k in (
        "PATHWAY_ELASTIC",
        "PATHWAY_ELASTIC_MIN_PROCESSES",
        "PATHWAY_ELASTIC_MAX_PROCESSES",
        "PATHWAY_ELASTIC_HIGH_PRESSURE",
        "PATHWAY_ELASTIC_LOW_PRESSURE",
        "PATHWAY_ELASTIC_SUSTAIN_TICKS",
        "PATHWAY_ELASTIC_COOLDOWN",
    ):
        monkeypatch.delenv(k, raising=False)
    cfg = get_pathway_config()
    assert cfg.elastic == "off"  # off-by-default guarantee
    assert cfg.elastic_min_processes == 1
    assert cfg.elastic_max_processes == 8
    assert cfg.elastic_high_pressure == 0.75
    assert cfg.elastic_low_pressure == 0.05
    assert cfg.elastic_sustain_ticks == 50
    assert cfg.elastic_cooldown_s == 30.0
    d = cfg.to_dict()
    for key in (
        "elastic",
        "elastic_min_processes",
        "elastic_max_processes",
        "elastic_high_pressure",
        "elastic_low_pressure",
        "elastic_sustain_ticks",
        "elastic_cooldown_s",
    ):
        assert key in d, f"{key} missing from config.to_dict()"
    monkeypatch.setenv("PATHWAY_ELASTIC", "sideways")
    with pytest.raises(ValueError):
        cfg.elastic
    monkeypatch.setenv("PATHWAY_ELASTIC", "manual")
    assert cfg.elastic == "manual"
    assert elastic.reshard_enabled()
    monkeypatch.setenv("PATHWAY_ELASTIC_HIGH_PRESSURE", "1.5")
    with pytest.raises(ValueError):
        cfg.elastic_high_pressure


# ------------------------------------------------------------- heartbeat hardening


def test_heartbeat_retire_peer_drops_flow_and_messages():
    telemetry.clear_events()
    mon = heartbeat.HeartbeatMonitor(3, 0, timeout=30.0)
    try:
        s1 = socket.create_connection(("127.0.0.1", mon.port), timeout=5)
        s2 = socket.create_connection(("127.0.0.1", mon.port), timeout=5)
        heartbeat._send(s1, ("hb", 1, 5, {"flow": {"occupancy": 0.9}}))
        heartbeat._send(s2, ("hb", 2, 5, {"flow": {"occupancy": 0.1}}))
        deadline = time.time() + 5
        while len(mon.peer_flow()) < 2 and time.time() < deadline:
            time.sleep(0.01)
        assert set(mon.peer_flow()) == {1, 2}
        mon.retire_peer(2)
        assert set(mon.peer_flow()) == {1}
        assert telemetry.events("elastic.peer_retired")
        # a late message from the retired peer neither resurrects it nor
        # reads as a death — one structured warning
        heartbeat._send(s2, ("hb", 2, 6, {"flow": {"occupancy": 1.0}}))
        time.sleep(0.3)
        assert set(mon.peer_flow()) == {1}
        assert mon.dead_peer() is None
        assert telemetry.events("elastic.stale_peer_message")
        s1.close()
        s2.close()
    finally:
        mon.close()


def test_heartbeat_rejects_stale_membership_summary():
    membership.reset_stale_warnings()
    telemetry.clear_events()
    mon = heartbeat.HeartbeatMonitor(2, 0, timeout=30.0)
    mon.set_membership_version(2)
    try:
        s = socket.create_connection(("127.0.0.1", mon.port), timeout=5)
        heartbeat._send(s, ("hb", 1, 4, {"membership_version": 2, "tag": "new"}))
        deadline = time.time() + 5
        while mon.peer_summaries().get(1) is None and time.time() < deadline:
            time.sleep(0.01)
        assert mon.peer_summaries()[1]["tag"] == "new"
        # stale-stamped summary: rejected (liveness still updates)
        heartbeat._send(s, ("hb", 1, 5, {"membership_version": 1, "tag": "old"}))
        deadline = time.time() + 5
        while mon.seen_peers().get(1) != 5 and time.time() < deadline:
            time.sleep(0.01)
        assert mon.peer_summaries()[1]["tag"] == "new"  # not clobbered
        assert telemetry.events("elastic.stale_membership_version")
        s.close()
    finally:
        mon.close()


def test_heartbeat_peer_flow_drops_clean_goodbyes():
    mon = heartbeat.HeartbeatMonitor(2, 0, timeout=30.0)
    try:
        s = socket.create_connection(("127.0.0.1", mon.port), timeout=5)
        heartbeat._send(s, ("hb", 1, 3, {"flow": {"occupancy": 1.0}}))
        deadline = time.time() + 5
        while len(mon.peer_flow()) < 1 and time.time() < deadline:
            time.sleep(0.01)
        heartbeat._send(s, ("bye", 1, 4))
        deadline = time.time() + 5
        while mon.peer_flow() and time.time() < deadline:
            time.sleep(0.01)
        # a drained peer's stale occupancy no longer throttles survivors
        assert mon.peer_flow() == {}
        s.close()
    finally:
        mon.close()


# ------------------------------------------------------------- supervisor rescale

_RESCALE_CHILD = textwrap.dedent(
    """
    import os, pickle, sys, time
    sys.path.insert(0, os.environ["REPO"])
    marker = sys.argv[1]
    if not os.path.exists(marker):
        open(marker, "w").close()
        from pathway_tpu_torch.elastic import Membership, commit_membership
        from pathway_tpu_torch.persistence.backends import FileBackend
        commit_membership(
            FileBackend(os.environ["PATHWAY_PERSISTENT_STORAGE"]),
            Membership(version=1, processes=2, threads=1, reason="manual:test"),
        )
        sys.exit(75)  # RESCALE_EXIT_CODE
    sys.exit(0)
    """
)


def test_supervisor_rescale_relaunches_at_new_shape(tmp_path):
    """Exit 75 + a committed membership = relaunch at the membership's
    process count, consuming neither restart budget nor backoff."""
    script = tmp_path / "rescale.py"
    script.write_text(_RESCALE_CHILD)
    marker = str(tmp_path / "marker")
    pstore = str(tmp_path / "pstore")
    telemetry.clear_events()
    seen = []
    sup = Supervisor(
        [sys.executable, str(script), marker],
        processes=1,
        max_restarts=0,  # ANY failure would give up — rescale must not count
        backoff_s=5.0,  # a counted backoff would blow the test timeout
        env=dict(os.environ, REPO=REPO, PATHWAY_PERSISTENT_STORAGE=pstore),
        on_rescale=lambda frm, to: seen.append((frm, to)),
    )
    t0 = time.monotonic()
    result = sup.run()
    # no backoff was slept: two attempts, no restart counted, and the whole
    # run took less than the one backoff a counted restart would sleep
    assert len(result.attempts) == 2 and result.restarts == 0
    assert time.monotonic() - t0 < 5.0, "rescale must not sleep the backoff"
    assert result.rescales == 1 and result.restarts == 0
    assert seen == [(1, 2)]
    assert sup.processes == 2
    assert [a.get("rescale") for a in result.attempts] == [True, False]
    ev = telemetry.events("elastic.rescale")
    assert ev and ev[0]["attrs"]["to_processes"] == 2


def test_supervisor_rescale_without_storage_gives_up(tmp_path):
    script = tmp_path / "r.py"
    script.write_text("import sys; sys.exit(75)\n")
    env = {k: v for k, v in os.environ.items() if k != "PATHWAY_PERSISTENT_STORAGE"}
    sup = Supervisor([sys.executable, str(script)], processes=1, env=env)
    from pathway_tpu_torch.resilience import SupervisorGaveUp

    with pytest.raises(SupervisorGaveUp, match="membership"):
        sup.run()


# ------------------------------------------------------------- sharded sink parts


def _sharded_sink_run(tmp_path, n_workers):
    G.clear()
    t = pw.debug.table_from_rows(
        pw.schema_from_types(x=int), [(i,) for i in range(16)]
    )
    out = str(tmp_path / "out.csv")
    pw.io.fs.write(t, out, format="csv", sharded=True)
    pw.run(monitoring_level="none", n_workers=n_workers)
    return out


def test_sharded_sink_part_count_mismatch_raises(tmp_path, monkeypatch):
    monkeypatch.delenv("PATHWAY_ELASTIC", raising=False)
    out = str(tmp_path / "out.csv")
    # leftovers of a 6-worker layout next to a 2-worker run
    open(out + ".part-0005", "w").close()
    G.clear()
    t = pw.debug.table_from_rows(pw.schema_from_types(x=int), [(1,)])
    pw.io.fs.write(t, out, format="csv", sharded=True)
    with pytest.raises(RuntimeError, match="at least 6 workers, but this run has 2"):
        pw.run(monitoring_level="none", n_workers=2)


def test_sharded_sink_stale_parts_reclaimed_under_elastic(tmp_path, monkeypatch):
    monkeypatch.setenv("PATHWAY_ELASTIC", "manual")
    telemetry.clear_events()
    out = _sharded_sink_run(tmp_path, 2)
    # simulate a leftover from a wider previous layout, then rerun narrower
    open(out + ".part-0007", "w").close()
    out2 = _sharded_sink_run(tmp_path, 2)
    assert not os.path.exists(out2 + ".part-0007")
    assert telemetry.events("elastic.sink_parts_remapped")
    # merged output intact
    with open(out2) as fh:
        rows = [r for r in _csv.DictReader(fh)]
    assert len(rows) == 16


# ------------------------------------------------- in-process reshard smoke


class _WordSchema(pw.Schema):
    word: str
    count: int


class _ListSubject(pw.io.python.ConnectorSubject):
    def __init__(self, rows):
        super().__init__()
        self.rows = rows

    def run(self):
        for w, c in self.rows:
            self.next(word=w, count=c)


def _word_session(rows, backend, n_workers):
    G.clear()
    t = pw.io.python.read(_ListSubject(rows), schema=_WordSchema, name="src")
    agg = t.groupby(pw.this.word).reduce(
        pw.this.word, total=pw.reducers.sum(pw.this.count)
    )
    got = {}
    pw.io.subscribe(
        agg,
        on_change=lambda key, row, time, is_addition: got.__setitem__(
            row["word"], row["total"]
        )
        if is_addition
        else None,
    )
    pw.run(
        monitoring_level="none",
        n_workers=n_workers,
        persistence_config=pw.persistence.Config(
            backend=backend, persistence_mode="operator_persisting"
        ),
    )
    return got


def test_elastic_reshard_by_replay_smoke(monkeypatch):
    """Tier-1 elasticity smoke (the MemoryBackend twin of the slow subprocess
    join/drain test): an operator-persisted run restored at a DIFFERENT
    worker count reshards by replay — positional shards dropped, full logs
    replayed under the new shard map — and the final state exactly matches a
    continuation at the original count."""
    monkeypatch.setenv("PATHWAY_ELASTIC", "manual")
    MemoryBackend.clear("elastic-smoke")
    backend = pw.persistence.Backend("memory", "elastic-smoke")
    first = [("a", 1), ("b", 2), ("a", 3), ("c", 7)]
    second = [("b", 10), ("d", 5)]

    r1 = _word_session(first, backend, 2)
    assert r1 == {"a": 4, "b": 2, "c": 7}
    telemetry.clear_events()
    r2 = _word_session(first + second, backend, 3)  # scale-out 2→3 workers
    # full recompute under the new shard map: complete, nothing lost/duplicated
    assert r2 == {"a": 4, "b": 12, "c": 7, "d": 5}
    ev = telemetry.events("elastic.reshard_restore")
    assert ev and ev[0]["attrs"]["old_workers"] == 2
    assert ev[0]["attrs"]["new_workers"] == 3
    assert elastic.last_reshard()["moved_fraction"] > 0
    # /status carries the reshard record even with the plane torn down
    from pathway_tpu_torch.internals.monitoring import run_stats

    st = run_stats(pw.internals.run.current_runtime())
    assert st["elastic"]["last_reshard"]["new_workers"] == 3
    r3 = _word_session(first + second, backend, 1)  # scale-in 3→1 workers
    assert r3 == {"a": 4, "b": 12, "c": 7, "d": 5}


def test_sharded_same_shape_restart_does_not_rebucket(monkeypatch):
    """Review fix: the elastic input-log scan must see the thread-sharded
    runtime's REAL worker count — with the 1-worker default a same-shape
    restart misread every @w partition log as orphaned and rebucketed
    (duplicating) perfectly healthy history."""
    monkeypatch.setenv("PATHWAY_ELASTIC", "manual")
    MemoryBackend.clear("shard-same")
    backend = pw.persistence.Backend("memory", "shard-same")

    def session():
        G.clear()

        def make_subject(w, n):
            rows = [(i, i * 10) for i in range(12) if i % n == w]

            class S(pw.io.python.ConnectorSubject):
                def run(self):
                    for k, v in rows:
                        self.next(k=k, v=v)

            return S()

        t = pw.io.python.read_partitioned(
            make_subject, schema=pw.schema_from_types(k=int, v=int), name="src"
        )
        inserts = []
        pw.io.subscribe(
            t,
            on_change=lambda key, row, time, is_addition: inserts.append(row["k"])
            if is_addition
            else None,
        )
        pw.run(
            monitoring_level="none",
            n_workers=2,
            persistence_config=pw.persistence.Config(backend=backend),
        )
        return inserts

    assert sorted(session()) == list(range(12))
    telemetry.clear_events()
    second = session()
    # same shape: nothing rebucketed, and every row arrives exactly once
    # (replay + deterministic live prefix-drop — no duplication)
    assert not telemetry.events("elastic.reshard_input_logs")
    assert sorted(second) == list(range(12)), second


def test_partitioned_rebucket_warns_and_loses_nothing(monkeypatch):
    """Review fix: after a key-range rebucket the count-based live
    prefix-drop is unsound for a non-seekable partitioned source — it is
    disabled with a structured warning (at-least-once: nothing lost,
    duplicates possible) instead of silently dropping never-logged rows."""
    monkeypatch.setenv("PATHWAY_ELASTIC", "manual")
    MemoryBackend.clear("shard-down")
    backend = pw.persistence.Backend("memory", "shard-down")

    def session(n_workers):
        G.clear()

        def make_subject(w, n):
            rows = [(i, i * 10) for i in range(12) if i % n == w]

            class S(pw.io.python.ConnectorSubject):
                def run(self):
                    for k, v in rows:
                        self.next(k=k, v=v)

            return S()

        t = pw.io.python.read_partitioned(
            make_subject, schema=pw.schema_from_types(k=int, v=int), name="src"
        )
        inserts = []
        pw.io.subscribe(
            t,
            on_change=lambda key, row, time, is_addition: inserts.append(row["k"])
            if is_addition
            else None,
        )
        pw.run(
            monitoring_level="none",
            n_workers=n_workers,
            persistence_config=pw.persistence.Config(backend=backend),
        )
        return inserts

    assert sorted(session(2)) == list(range(12))
    telemetry.clear_events()
    second = session(1)  # scale-in: worker 1's log is orphaned and rebuckets
    assert telemetry.events("elastic.reshard_input_logs")
    assert telemetry.events("elastic.reshard_prefix_drop_disabled")
    # at-least-once across the rescale: every row present (replay), none lost
    assert set(second) == set(range(12)), sorted(set(range(12)) - set(second))


def test_elastic_off_still_refuses_worker_count_change(monkeypatch):
    monkeypatch.delenv("PATHWAY_ELASTIC", raising=False)
    MemoryBackend.clear("elastic-off")
    backend = pw.persistence.Backend("memory", "elastic-off")
    _word_session([("a", 1)], backend, 2)
    with pytest.raises(RuntimeError, match="PATHWAY_ELASTIC"):
        _word_session([("a", 1)], backend, 3)


# --------------------------------------------------- slow: cluster join/drain


def _free_port_base(n: int) -> int:
    """A free cluster base for ``n`` processes in this xdist worker's range."""
    from torch_cluster_helpers import first_port

    return first_port(n)


_RAG_PIPELINE = textwrap.dedent(
    """
    import os
    import sys

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.io.kafka import MockKafkaBroker
    from pathway_tpu_torch.stdlib.indexing import BruteForceKnnFactory
    from pathway_tpu_torch.xpacks.llm.mocks import FakeEmbedder
    from pathway_tpu_torch.xpacks.llm.rerankers import EncoderReranker

    out = sys.argv[1]
    broker = MockKafkaBroker(path=os.environ["BROKER_PATH"])
    expected = int(os.environ["EXPECTED_DOCS"])

    docs = pw.io.kafka.read(
        broker, "docs", format="plaintext", mode="streaming", name="docs"
    )
    emb = FakeEmbedder(dimension=16)
    index = BruteForceKnnFactory(embedder=emb, device="cpu").build_index(docs.data, docs)
    queries = pw.debug.table_from_rows(
        pw.schema_from_types(q=str),
        [(f"document number {i} about topic {i % 3}",) for i in range(6)],
    )
    picked = index.query(queries.q, number_of_matches=2).select(
        q=pw.left.q,
        top=pw.apply(lambda ts: ts[0] if ts else "", pw.right.data),
        score=pw.apply(
            lambda s: round(float(s[0]), 5) if s else 0.0,
            pw.right._pw_index_reply_score,
        ),
    )
    rr = EncoderReranker(emb)
    scored = picked.select(
        picked.q, picked.top, rerank=pw.apply(lambda s: round(float(s), 5), rr(picked.top, picked.q))
    )
    pw.io.fs.write(scored, out + ".csv", format="csv")

    total = docs.reduce(c=pw.reducers.count())

    def on_total(key, row, time, is_addition):
        if is_addition and row["c"] >= expected:
            rt = pw.internals.run.current_runtime()
            if rt is not None:
                rt.request_stop()

    pw.io.subscribe(total, on_change=on_total)
    pw.run(
        monitoring_level="none",
        persistence_config=pw.persistence.Config(
            backend=pw.persistence.Backend.filesystem(
                os.environ["PATHWAY_PERSISTENT_STORAGE"]
            ),
            persistence_mode="operator_persisting",
            snapshot_interval_ms=150,
        ),
    )
    """
)


def _net_csv(path: str) -> dict:
    state: dict = {}
    with open(path) as fh:
        for rec in _csv.DictReader(fh):
            key = tuple(
                v for k, v in sorted(rec.items()) if k not in ("time", "diff")
            )
            state[key] = state.get(key, 0) + int(rec["diff"])
    return {k: v for k, v in state.items() if v != 0}


def _doc_batches():
    docs = [f"document number {i} about topic {i % 3}" for i in range(36)]
    return docs[:12], docs[12:24], docs[24:]


@pytest.mark.slow
def test_elastic_join_and_drain_zero_loss(tmp_path):
    """Acceptance: a 2-process cluster streaming the
    embed→KNN→rerank pipeline adds a third process mid-stream and later
    drains back to two, with zero lost or duplicated output — the final sink
    net state exactly equals an uninterrupted fixed-size run's."""
    from pathway_tpu_torch.io.kafka import MockKafkaBroker

    script = tmp_path / "rag.py"
    script.write_text(_RAG_PIPELINE)
    b1, b2, b3 = _doc_batches()

    def launch(tag, elastic_mode):
        root = tmp_path / tag
        root.mkdir()
        broker = MockKafkaBroker(path=str(root / "broker"))
        broker.create_topic("docs", partitions=2)
        for i, d in enumerate(b1):
            broker.produce("docs", d, partition=i % 2)
        env = dict(
            os.environ,
            PYTHONPATH=REPO,
            JAX_PLATFORMS="cpu",
            BROKER_PATH=str(root / "broker"),
            PATHWAY_PERSISTENT_STORAGE=str(root / "pstore"),
            EXPECTED_DOCS=str(len(b1) + len(b2) + len(b3)),
            PATHWAY_ELASTIC=elastic_mode,
            PATHWAY_BARRIER_TIMEOUT="60",
        )
        return root, broker, env

    # --- elastic run: 2 → 3 (join) → 2 (drain) -----------------------------
    root, broker, env = launch("elastic", "manual")
    backend = FileBackend(str(root / "pstore"))
    out = str(root / "run")
    stage = {"n": 0}

    def on_rescale(frm, to):
        stage["n"] += 1
        batch = b2 if stage["n"] == 1 else b3
        for i, d in enumerate(batch):
            broker.produce("docs", d, partition=i % 2)

    def driver():
        time.sleep(4)
        elastic.write_scale_request(backend, 3)
        deadline = time.monotonic() + 90
        while stage["n"] < 1 and time.monotonic() < deadline:
            time.sleep(0.2)
        time.sleep(4)
        elastic.write_scale_request(backend, 2)

    threading.Thread(target=driver, daemon=True).start()
    sup = Supervisor(
        [sys.executable, str(script), out],
        processes=2,
        threads=1,
        first_port=_free_port_base(5),
        max_restarts=1,
        backoff_s=0.2,
        env=env,
        log_dir=str(root / "logs"),
        on_rescale=on_rescale,
    )
    result = sup.run()
    assert result.rescales == 2, result.attempts
    assert result.restarts == 0, result.attempts
    hist = [(m.version, m.processes, m.reason) for m in elastic.membership_history(backend)]
    assert [(v, p) for v, p, _ in hist] == [(0, 2), (1, 3), (2, 2)], hist
    m = elastic.read_membership(backend)
    assert m.epoch is not None  # the new shape names its source epoch

    # --- control run: fixed 2 processes, same total input ------------------
    root_c, broker_c, env_c = launch("fixed", "off")
    for i, d in enumerate(b2 + b3):
        broker_c.produce("docs", d, partition=i % 2)
    out_c = str(root_c / "run")
    sup_c = Supervisor(
        [sys.executable, str(script), out_c],
        processes=2,
        threads=1,
        first_port=_free_port_base(5),
        max_restarts=0,
        backoff_s=0.2,
        env=env_c,
        log_dir=str(root_c / "logs"),
    )
    sup_c.run()

    got, want = _net_csv(out + ".csv"), _net_csv(out_c + ".csv")
    assert got == want, (
        f"elastic run diverged from the fixed-size run: "
        f"only_elastic={sorted(set(got) - set(want))[:4]} "
        f"only_fixed={sorted(set(want) - set(got))[:4]}"
    )
    # zero duplicates: every surviving row has net multiplicity exactly 1
    assert set(got.values()) == {1}


_FLOOD_PIPELINE = textwrap.dedent(
    """
    import os
    import sys
    import time as _t

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.io.kafka import MockKafkaBroker

    out = sys.argv[1]
    broker = MockKafkaBroker(path=os.environ["BROKER_PATH"])

    words = pw.io.kafka.read(
        broker, "words", format="plaintext", mode="streaming", name="words"
    )
    payload = words.filter(words.data != "__stop__")
    counts = payload.groupby(payload.data).reduce(
        payload.data, c=pw.reducers.count()
    )
    pw.io.fs.write(counts, out + ".csv", format="csv")

    def on_word(key, row, time, is_addition):
        # ~1 ms of sink work per arriving row: while the driver floods, every
        # tick carries rows and takes far past the 15 ms SLO — the sustained
        # latency saturation the autoscaler is built to see
        if is_addition:
            _t.sleep(0.001)

    pw.io.subscribe(payload, on_change=on_word)

    def on_any(key, row, time, is_addition):
        if is_addition and row["data"] == "__stop__":
            rt = pw.internals.run.current_runtime()
            if rt is not None:
                rt.request_stop()

    pw.io.subscribe(words, on_change=on_any)
    pw.run(
        monitoring_level="none",
        persistence_config=pw.persistence.Config(
            backend=pw.persistence.Backend.filesystem(
                os.environ["PATHWAY_PERSISTENT_STORAGE"]
            ),
        ),
    )
    """
)


@pytest.mark.slow
def test_autoscale_flood_joins_then_idle_drains(tmp_path):
    """Acceptance: PATHWAY_ELASTIC=auto + the flow plane — a 10×
    flood sustains pod pressure past the high threshold and the autoscaler
    joins a process; once the flood drains and the pod idles, it drains one.
    Decisions are visible in the committed membership history (reasons) and
    the telemetry event stream."""
    from pathway_tpu_torch.io.kafka import MockKafkaBroker

    script = tmp_path / "flood.py"
    script.write_text(_FLOOD_PIPELINE)
    broker = MockKafkaBroker(path=str(tmp_path / "broker"))
    broker.create_topic("words", partitions=2)
    pstore = str(tmp_path / "pstore")
    backend = FileBackend(pstore)
    env = dict(
        os.environ,
        PYTHONPATH=REPO,
        JAX_PLATFORMS="cpu",
        BROKER_PATH=str(tmp_path / "broker"),
        PATHWAY_PERSISTENT_STORAGE=pstore,
        PATHWAY_ELASTIC="auto",
        PATHWAY_FLOW="on",
        PATHWAY_LATENCY_SLO_MS="15",  # the paced flood breaches this every tick
        PATHWAY_ELASTIC_MIN_PROCESSES="2",
        PATHWAY_ELASTIC_MAX_PROCESSES="3",
        PATHWAY_ELASTIC_HIGH_PRESSURE="0.5",
        PATHWAY_ELASTIC_LOW_PRESSURE="0.05",
        PATHWAY_ELASTIC_SUSTAIN_TICKS="8",
        PATHWAY_ELASTIC_COOLDOWN="3",
        PATHWAY_BARRIER_TIMEOUT="120",  # the post-rescale replay is one big tick
    )
    produced = [0]
    failed = {}

    def version_of() -> int:
        m = elastic.read_membership(backend)
        return m.version if m is not None else -1

    def driver():
        try:
            # paced flood: ~500 rows/s, so every tick carries rows whose sink
            # cost keeps tick time (= e2e latency) far past the 15 ms SLO —
            # sustained saturation until the autoscaler joins a process
            deadline = time.monotonic() + 120
            while version_of() < 1 and time.monotonic() < deadline:
                for _ in range(10):
                    broker.produce(
                        "words", f"w{produced[0] % 23}", partition=produced[0] % 2
                    )
                    produced[0] += 1
                time.sleep(0.02)
            if version_of() < 1:
                failed["stage"] = "join never happened"
                return
            # flood off: the pod idles, the autoscaler should drain one
            deadline = time.monotonic() + 120
            while version_of() < 2 and time.monotonic() < deadline:
                time.sleep(0.3)
            if version_of() < 2:
                failed["stage"] = "drain never happened"
            # sentinel: lets the (now 2-process again) pod finish cleanly
            broker.produce("words", "__stop__", partition=0)
        except Exception as e:  # pragma: no cover - diagnostics only
            failed["stage"] = repr(e)

    th = threading.Thread(target=driver, daemon=True)
    th.start()
    sup = Supervisor(
        [sys.executable, str(script), str(tmp_path / "out")],
        processes=2,
        threads=1,
        first_port=_free_port_base(5),
        max_restarts=1,
        backoff_s=0.2,
        env=env,
        log_dir=str(tmp_path / "logs"),
    )
    result = sup.run()
    th.join(timeout=10)
    assert not failed, failed
    assert result.rescales >= 2, result.attempts
    hist = elastic.membership_history(backend)
    assert [m.reason for m in hist][:3] == [
        "initial",
        "autoscale_join",
        "autoscale_drain",
    ], [(m.version, m.processes, m.reason) for m in hist]
    assert hist[1].processes == 3 and hist[2].processes == 2
    # zero loss across both autoscale rescales: the counted net total equals
    # exactly what the driver produced
    net = _net_csv(str(tmp_path / "out.csv"))
    assert sum(int(k[0]) for k in net) == produced[0], (sum(
        int(k[0]) for k in net
    ), produced[0])


# ------------------------------------------------------- against the reference


@pytest.mark.parametrize("old,new", [(3, 2), (4, 1), (2, 5)])
def test_rebucket_matches_the_reference(old, new):
    """The same partitioned logs rebucketed by both packages: the same
    statistics and the same events in the same new logs, byte for byte."""
    import pathway_tpu.elastic as ref_elastic
    from pathway_tpu.persistence.backends import MemoryBackend as RefMemory

    out = {}
    for name, mod, backend_cls in (("ref", ref_elastic, RefMemory), ("port", elastic, MemoryBackend)):
        root = f"rs-parity-{name}-{old}-{new}"
        backend_cls.clear(root)
        b = backend_cls(root)
        for w in range(old):
            evs = [(w * 1000 + 7 * i, (f"v{w}-{i}",), 1) for i in range(25)]
            _make_log(b, "src" if w == 0 else f"src@w{w}", evs)
        stats = mod.reshard_input_logs(b, new)
        out[name] = (stats.to_dict(), {k: b.get(k) for k in sorted(b.list_keys("inputs/"))})
    assert out["port"] == out["ref"]
    assert out["ref"][0]["rows_total"] == (25 * old if new < old else 0)


def test_reshard_by_replay_matches_the_reference(monkeypatch):
    """The reshard-by-replay sessions of ``test_elastic_reshard_by_replay_smoke``
    on both packages (2 workers, then 3, then 1): the same totals after
    each, and the same reshard record."""
    import pathway_tpu as ref_pw
    from pathway_tpu.internals.parse_graph import G as ref_G

    monkeypatch.setenv("PATHWAY_ELASTIC", "manual")
    first = [("a", 1), ("b", 2), ("a", 3), ("c", 7)]
    second = [("b", 10), ("d", 5)]
    out = {}
    for name, p, g in (("ref", ref_pw, ref_G), ("port", pw, G)):

        class Words(p.Schema):
            word: str
            count: int

        class Rows(p.io.python.ConnectorSubject):
            def __init__(self, rows):
                super().__init__()
                self._rows = rows

            def run(self):
                for w, c in self._rows:
                    self.next(word=w, count=c)

        def session(rows, n_workers, p=p, g=g, Words=Words, Rows=Rows, root=f"replay-parity-{name}"):
            g.clear()
            t = p.io.python.read(Rows(rows), schema=Words, name="src")
            agg = t.groupby(p.this.word).reduce(p.this.word, total=p.reducers.sum(p.this.count))
            got = {}
            p.io.subscribe(agg, on_change=lambda key, row, time, is_addition: got.__setitem__(
                row["word"], row["total"]) if is_addition else None)
            p.run(monitoring_level="none", n_workers=n_workers, persistence_config=p.persistence.Config(
                backend=p.persistence.Backend("memory", root), persistence_mode="operator_persisting"))
            return got

        p.persistence.backends.MemoryBackend.clear(f"replay-parity-{name}")
        totals = [session(first, 2), session(first + second, 3)]
        rec = dict(p.elastic.last_reshard())
        totals.append(session(first + second, 1))
        out[name] = (totals, {k: rec[k] for k in ("old_workers", "new_workers", "moved_fraction")})
    assert out["port"] == out["ref"]
    assert out["ref"][0][-1] == {"a": 4, "b": 12, "c": 7, "d": 5}
