"""The port's multi-process cluster (``parallel/cluster.py``) against its
single process and the reference (``tests/test_cluster.py``, and the two
cluster cases of ``tests/test_temporal_sweep.py``).

Each pipeline is written once (``tests/torch_cluster_helpers.py``): the port
runs it as a ``PATHWAY_PROCESSES`` cluster of subprocesses on loopback TCP,
and both packages run it in this process on one worker. Cluster output must
equal the port's single process byte for byte (timed sources), or in net
rows where the reference's test compares net rows; the port's single process
must equal the reference's in the same terms. A KNN reply's scores are
compared with the reference's within 1e-6 (the port scores in torch f32);
keys and tie order exactly. Ports come from the helper's per-worker ranges.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import pytest

import pathway_tpu
import pathway_tpu_torch
import torch_cluster_helpers as tc


def _solo_both(pipeline, tmp_path, name="solo"):
    """(port in-process output prefix, reference in-process output prefix)."""
    port = str(tmp_path / f"port_{name}")
    ref = str(tmp_path / f"ref_{name}")
    tc.run_in_process(pathway_tpu_torch, pipeline, port)
    tc.run_in_process(pathway_tpu, pipeline, ref)
    return port, ref


@pytest.mark.parametrize("threads", [1, 2])
def test_cluster_byte_identical(tmp_path, threads):
    port, ref = _solo_both("groupby_window", tmp_path)
    dist = str(tmp_path / "dist")
    tc.run_cluster("groupby_window", dist, processes=2, threads=threads)
    for suffix in (".groupby.csv", ".window.csv"):
        assert tc.read(dist + suffix) == tc.read(port + suffix) == tc.read(ref + suffix), suffix


def test_cluster_dead_peer_raises_other_worker_error(tmp_path):
    """A peer that never joins surfaces as a structured ``OtherWorkerError``
    naming the missing process within ``barrier_timeout``."""
    t0 = time.monotonic()
    (rc, out), = tc.launch(
        lambda pid: [sys.executable, tc.__file__, "groupby_window", str(tmp_path / "dead")],
        1,
        env={"PATHWAY_PROCESSES": "2", "PATHWAY_BARRIER_TIMEOUT": "3",
             "PATHWAY_FIRST_PORT": str(tc.first_port(2))},
        timeout=60,
    )
    elapsed = time.monotonic() - t0
    assert rc != 0
    assert "OtherWorkerError" in out, out
    assert "never joined" in out, out
    assert elapsed < 45, f"dead-peer detection took {elapsed:.1f}s"


def _replies(path):
    import csv

    with open(path) as fh:
        rows = sorted(r["r"] for r in csv.DictReader(fh))
    return [[(int(k), float.fromhex(s)) for k, s in (h.split(":") for h in r.split(";"))] for r in rows]


def test_cluster_sharded_index_byte_identical(tmp_path):
    """Docs shard across processes and queries broadcast over TCP; merged
    replies equal the single process's byte for byte, ties included."""
    port, ref = _solo_both("sharded_index", tmp_path)
    dist = str(tmp_path / "dist")
    tc.run_cluster("sharded_index", dist, processes=2, timeout=180)
    assert tc.read(dist + ".reply.csv") == tc.read(port + ".reply.csv")
    got, want = _replies(port + ".reply.csv"), _replies(ref + ".reply.csv")
    assert [[k for k, _ in r] for r in got] == [[k for k, _ in r] for r in want]
    for g, w in zip(got, want):
        assert all(abs(a - b) <= 1e-6 for (_, a), (_, b) in zip(g, w))


def test_cluster_temporal_watermark_ops_byte_identical(tmp_path):
    """Behaviors and session windows shard across processes with the
    watermark gossip: net rows equal the single process's and the
    reference's."""
    port, ref = _solo_both("temporal_watermark", tmp_path)
    dist = str(tmp_path / "dist")
    tc.run_cluster("temporal_watermark", dist, processes=2, threads=2)
    for suffix in (".behavior.csv", ".session.csv"):
        assert tc.net(dist + suffix) == tc.net(port + suffix) == tc.net(ref + suffix), suffix


def test_temporal_sweep_cluster_matches_thread(tmp_path, monkeypatch):
    """The cutoff-tie pipeline on 1 and 2 processes with the full audit plane
    live on every process (``tests/test_temporal_sweep.py:365``)."""
    monkeypatch.setenv("PATHWAY_AUDIT", "full")
    port, ref = _solo_both("sweep_cutoff", tmp_path)
    dist = str(tmp_path / "dist")
    tc.run_cluster("sweep_cutoff", dist, processes=2)
    for suffix in (".window.csv", ".buffer.csv"):
        assert tc.net(dist + suffix) == tc.net(port + suffix) == tc.net(ref + suffix), suffix
    win = tc.net(port + ".window.csv")
    assert {k: v for k, v in win.items() if k[-1] == "0" or k[0] == "0"}, win


def test_session_merge_and_prev_next_cluster_matches_thread(tmp_path, monkeypatch):
    """Session merge and prev/next churn on 1 and 2 processes with the full
    audit plane (``tests/test_temporal_sweep.py:420``)."""
    monkeypatch.setenv("PATHWAY_AUDIT", "full")
    port, ref = _solo_both("session_sort", tmp_path)
    dist = str(tmp_path / "dist")
    tc.run_cluster("session_sort", dist, processes=2)
    for suffix in (".session.csv", ".chain.csv"):
        assert tc.net(dist + suffix) == tc.net(port + suffix) == tc.net(ref + suffix), suffix
    assert tc.net(port + ".session.csv") == {("1", "0", "0"): 1, ("2", "12", "10"): 1, ("1", "20", "20"): 1}
    assert tc.net(port + ".chain.csv") == {
        ("10", "", "0"): 1,
        ("12", "0", "10"): 1,
        ("20", "10", "12"): 1,
        ("", "12", "20"): 1,
    }


def test_cluster_with_plane_byte_identical(tmp_path):
    """2 processes x 2 threads with the exchange plane forced on: output
    equal to the single process's; intra-process rows ride the shard grid,
    cross-process rows the TCP links."""
    port, ref = _solo_both("plane_groupby", tmp_path)
    dist = str(tmp_path / "dist")
    outputs = tc.run_cluster(
        "plane_groupby", dist, processes=2, threads=2, env={"PATHWAY_DEVICE_EXCHANGE": "on"}
    )
    assert tc.read(dist + ".csv") == tc.read(port + ".csv") == tc.read(ref + ".csv")
    rows = [int(line.split()[1]) for o in outputs for line in o.splitlines() if line.startswith("PLANE_ROWS")]
    assert len(rows) == 2 and any(r > 0 for r in rows), outputs


def test_flip_diff_detected_on_2proc_cluster(tmp_path):
    """``flip_diff`` on process 0 of a 2-process cluster: its audit plane
    catches the negative multiplicity at tick 2, on ``/status`` too, and its
    flight recorder dumps."""
    out = str(tmp_path / "out")
    flight = tmp_path / "flight"
    tc.run_cluster(
        "audit_flip", out, processes=2,
        env={"PATHWAY_AUDIT": "on", "PATHWAY_FAULT_PLAN": "flip_diff:proc=0,tick=2",
             "PATHWAY_FLIGHT_DIR": str(flight)},
    )
    doc = json.load(open(out + ".p0.json"))
    assert doc["violations"].get("negative_multiplicity", 0) >= 1
    assert doc["status_kinds"].get("negative_multiplicity", 0) >= 1
    rec = next(r for r in doc["recent"] if r["kind"] == "negative_multiplicity")
    assert rec["tick"] == 2
    assert list(flight.glob("flight_p0_*.json"))


def _broker(pw, path, topic, partitions):
    broker = pw.io.kafka.MockKafkaBroker(path=path)
    broker.create_topic(topic, partitions=partitions)
    return broker


def test_cluster_operator_persistence_restart(tmp_path):
    """Every process snapshots its own worker shards and process 0 commits
    the manifest after a barrier; the restart recovers O(state) and emits only
    new deltas; the final sink holds the complete diff stream."""
    broker_path = str(tmp_path / "broker")
    broker = _broker(pathway_tpu_torch, broker_path, "words", 2)
    first = [f"w{i % 11}" for i in range(80)] + [f"only{i % 3}" for i in range(20)]
    second = [f"w{i % 11}" for i in range(100)]
    for i, w in enumerate(first):
        broker.produce("words", w, partition=i % 2)
    out = str(tmp_path / "run")
    env = {"BROKER_PATH": broker_path, "PSTORE": str(tmp_path / "pstate"), "EXPECTED_WORDS": str(len(first))}
    tc.run_cluster("persist_words", out, processes=2, threads=2, env=env)
    shutil.copy(out + ".csv", out + ".first.csv")
    for i, w in enumerate(second):
        broker.produce("words", w, partition=i % 2)
    env["EXPECTED_WORDS"] = str(len(first) + len(second))
    tc.run_cluster("persist_words", out, processes=2, threads=2, env=env)

    import csv

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
    ep = pathway_tpu_torch.resilience.last_committed_epoch(
        pathway_tpu_torch.persistence.Backend.filesystem(str(tmp_path / "pstate"))
    )
    assert ep is not None and ep["acks"] == [0, 1]


@pytest.mark.parametrize(
    "env,plane",
    [({"PATHWAY_SHARDMAP": "on"}, "internals.shardmap"),
     ({"PATHWAY_FABRIC": "on"}, "fabric"),
     ({"PATHWAY_ELASTIC": "manual"}, "elastic")],
    ids=["shardmap", "fabric", "elastic"],
)
def test_cluster_unported_planes_are_a_later_slice(tmp_path, env, plane):
    """The planes a cluster run reaches lazily: the shard map, the serving
    fabric and the elasticity plane (the name is kept from the slice that
    cut them). Each is carried: the run goes through and writes what one
    worker writes (the elasticity plane, with no request and no persistence
    backend, decides nothing)."""
    results = tc.launch(
        lambda pid: [sys.executable, tc.__file__, "groupby_window", str(tmp_path / "cut")],
        2, env=env, timeout=60,
    )
    for rc, out in results:
        assert rc == 0, out
    solo = str(tmp_path / "solo")
    tc.run_in_process(pathway_tpu_torch, "groupby_window", solo)
    for suffix in (".groupby.csv", ".window.csv"):
        assert tc.read(str(tmp_path / "cut") + suffix) == tc.read(solo + suffix), suffix


def test_cluster_run_from_a_plain_script(tmp_path):
    """A user's script (no test helper on the path) runs as a 2-process
    cluster under the env contract alone."""
    script = tmp_path / "user.py"
    script.write_text(
        "import sys\nimport pathway_tpu_torch as pw\n"
        "t = pw.debug.table_from_rows(pw.schema_from_types(k=int, v=int), [(i % 7, i) for i in range(200)])\n"
        "g = t.groupby(t.k).reduce(t.k, s=pw.reducers.sum(t.v))\n"
        "pw.io.fs.write(g, sys.argv[1], format='csv')\n"
        "pw.run(monitoring_level='none')\n"
    )
    solo, dist = str(tmp_path / "solo.csv"), str(tmp_path / "dist.csv")
    env = dict(os.environ, PYTHONPATH=tc.REPO)
    env.pop("PATHWAY_PROCESSES", None)
    subprocess.run([sys.executable, str(script), solo], env=env, check=True, timeout=120)
    results = tc.launch(lambda pid: [sys.executable, str(script), dist], 2, timeout=120)
    assert all(rc == 0 for rc, _ in results), results
    assert tc.read(dist) == tc.read(solo)


def test_distributed_initialize_gloo_two_processes():
    """``parallel.distributed_initialize`` sets up ``torch.distributed`` from
    the cluster env: two CPU processes join a gloo group and all-reduce."""
    code = (
        "import torch, torch.distributed as dist\n"
        "from pathway_tpu_torch.parallel import distributed_initialize\n"
        "distributed_initialize()\n"
        "t = torch.tensor([float(dist.get_rank() + 1)])\n"
        "dist.all_reduce(t)\n"
        "print('SUM', t.item(), dist.get_backend(), dist.get_world_size(), flush=True)\n"
        "dist.destroy_process_group()\n"
    )
    results = tc.launch(lambda pid: [sys.executable, "-c", code], 2, timeout=120)
    for rc, out in results:
        assert rc == 0, out
        assert "SUM 3.0 gloo 2" in out, out


def test_distributed_initialize_is_a_no_op_for_one_process():
    import torch.distributed as dist

    from pathway_tpu_torch.parallel import distributed_initialize

    distributed_initialize()
    assert not dist.is_initialized()


def test_cluster_monitoring_and_trace_stitching(tmp_path):
    """A live 2-process cluster (``tests/test_observability.py``): each
    process serves ``/metrics`` on its offset port, the coordinator's
    ``/status`` aggregates every process's heartbeat summary, and the live
    and exported per-process traces share the run id's trace id."""
    import urllib.error
    import urllib.request

    from pathway_tpu_torch.observability.spans import derive_trace_id

    base = tc.first_port(2, span=7)
    http_base = base + 5
    env = {
        "PATHWAY_FIRST_PORT": str(base), "PATHWAY_MONITORING_HTTP_PORT": str(http_base),
        "PATHWAY_HEARTBEAT_INTERVAL": "0.1", "PATHWAY_TRACE": "on", "PATHWAY_RUN_ID": "obs-test-run",
        "PATHWAY_TRACE_FILE": str(tmp_path / "run.otlp.json"),
    }
    full = tc._env(2, 1, env)
    procs = [
        subprocess.Popen([sys.executable, tc.__file__, "monitored_feed", str(tmp_path / "out")],
                         env=dict(full, PATHWAY_PROCESS_ID=str(pid)),
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in range(2)
    ]
    got: dict = {}
    try:
        deadline = time.time() + 60
        while time.time() < deadline:
            try:
                status0 = json.loads(urllib.request.urlopen(f"http://127.0.0.1:{http_base}/status", timeout=2).read())
                cluster = status0.get("cluster")
                if cluster and cluster["n_reporting"] == 2:
                    got["status0"] = status0
                    got["metrics1"] = urllib.request.urlopen(
                        f"http://127.0.0.1:{http_base + 1}/metrics", timeout=2).read().decode()
                    got["trace0"] = json.loads(
                        urllib.request.urlopen(f"http://127.0.0.1:{http_base}/trace?since=0", timeout=2).read())
                    # the feed is live: read again until the rollup has seen
                    # a tick of every process and a watermark (under load the
                    # first two-process snapshot can precede both)
                    if status0["watermarks"] and cluster["watermark_min"] is not None and all(
                        s["tick"] is not None for s in cluster["processes"].values()
                    ):
                        break
            except (urllib.error.URLError, OSError):
                pass
            if any(p.poll() is not None for p in procs):
                break
            time.sleep(0.2)
        # the feed stays live until the test has read the live endpoints
        (tmp_path / "out.stop").write_text("")
        outs = []
        for p in procs:
            try:
                out, _ = p.communicate(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate(timeout=30)
            outs.append(out or "")
        assert all(p.returncode == 0 for p in procs), "\n---\n".join(outs)
        assert "status0" in got, "the coordinator never reported 2 processes:\n" + "\n---\n".join(outs)
        cluster = got["status0"]["cluster"]
        assert set(cluster["processes"]) == {"0", "1"}
        for pid, summary in cluster["processes"].items():
            assert summary["tick"] is not None, (pid, summary)
            assert "backlog_rows" in summary and "rows_in" in summary
        assert cluster["tick_max"] is not None and cluster["tick_max"] >= 0
        assert got["status0"]["watermarks"] and cluster["watermark_min"] is not None
        assert "pathway_operator_rows_in_total" in got["metrics1"]
        expected_trace = derive_trace_id("obs-test-run")
        assert got["trace0"]["traceId"] == expected_trace
        for pid in (0, 1):
            with open(str(tmp_path / "run.otlp.json") + f".p{pid}") as fh:
                doc = json.load(fh)
            spans = doc["resourceSpans"][0]["scopeSpans"][0]["spans"]
            assert spans and all(s["traceId"] == expected_trace for s in spans)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
