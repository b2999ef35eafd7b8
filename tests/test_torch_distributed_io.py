"""Partitioned sources and sharded sinks on the port's multi-worker runtimes,
against the reference (``tests/test_distributed_io.py``): partition-per-worker
Kafka ingest over the file-backed mock broker, keyed rows equal across worker
counts and to the reference, per-worker sink shards with an ordered
merge-commit, and partition slices ingested on both processes of a cluster.
Rows compare exactly (keys included where the reference compares keys); a
sink compares in net rows, as the reference's does.
"""

from __future__ import annotations

import csv as _csv
import json
import os

import pytest

import pathway_tpu
import pathway_tpu_torch
import torch_cluster_helpers as tc

N_MSGS = 400
N_PARTS = 4


@pytest.fixture(autouse=True)
def _fresh():
    for pw in (pathway_tpu, pathway_tpu_torch):
        pw.G.clear()
    yield
    for pw in (pathway_tpu, pathway_tpu_torch):
        pw.G.clear()


def _filled_broker(pw, path=None, parts=N_PARTS, n=N_MSGS, words=13):
    broker = pw.io.kafka.MockKafkaBroker(path=path)
    broker.create_topic("t", partitions=parts)
    for i in range(n):
        broker.produce("t", f'{{"w": "w{i % words}", "v": {i}}}', partition=i % parts)
    return broker


def _wordcount(pw, broker):
    t = pw.io.kafka.read(broker, "t", schema=pw.schema_from_types(w=str, v=int), mode="static")
    return t.groupby(t.w).reduce(t.w, c=pw.reducers.count(), s=pw.reducers.sum(t.v))


def _run_collect(pw, table, n_workers):
    got = {}
    pw.io.subscribe(
        table, on_change=lambda key, row, time, is_addition: got.__setitem__(int(key), (row, is_addition))
    )
    pw.run(monitoring_level="none", n_workers=n_workers)
    return {k: r for k, (r, add) in got.items() if add}


def test_partitioned_ingest_byte_identical_and_spread():
    pw = pathway_tpu_torch
    broker = _filled_broker(pw)
    pw.G.clear()
    truth = _run_collect(pw, _wordcount(pw, broker), n_workers=1)
    assert len(pw.internals.run.current_runtime().connectors) == 1
    pw.G.clear()
    got = _run_collect(pw, _wordcount(pw, broker), n_workers=4)
    rt4 = pw.internals.run.current_runtime()
    assert got == truth
    ref_broker = _filled_broker(pathway_tpu)
    pathway_tpu.G.clear()
    assert _run_collect(pathway_tpu, _wordcount(pathway_tpu, ref_broker), n_workers=4) == truth
    subjects = [d.subject for d in rt4.connectors]
    assert len(subjects) == 4
    consumed = {s.worker: sorted(s._offsets) for s in subjects}
    assert len([w for w, parts in consumed.items() if parts]) == N_PARTS
    for w, parts in consumed.items():
        assert all(p % 4 == w for p in parts), f"worker {w} read {parts}"
    emitted = [
        sum(n.stats_rows_out for n in rt4.workers[w].graph.nodes if getattr(n, "local_source", False))
        for w in range(4)
    ]
    assert sum(1 for e in emitted if e > 0) == N_PARTS, emitted


def test_partitioned_ingest_more_workers_than_partitions():
    pw = pathway_tpu_torch
    broker = _filled_broker(pw, parts=2, n=100, words=5)
    pw.G.clear()
    truth = _run_collect(pw, _wordcount(pw, broker), n_workers=1)
    pw.G.clear()
    assert _run_collect(pw, _wordcount(pw, broker), n_workers=4) == truth


def test_partitioned_keys_deterministic_across_worker_counts():
    """Offset-derived keys: the same message owns the same engine key at any
    worker count, and the same key as in the reference."""
    keys = {}
    for pw in (pathway_tpu, pathway_tpu_torch):
        broker = _filled_broker(pw)
        for n in (1, 4):
            pw.G.clear()
            t = pw.io.kafka.read(broker, "t", schema=pw.schema_from_types(w=str, v=int), mode="static")
            keys[(pw.__name__, n)] = set(_run_collect(pw, t, n_workers=n))
    assert keys[("pathway_tpu_torch", 1)] == keys[("pathway_tpu_torch", 4)] == keys[("pathway_tpu", 1)]


def _net(path):
    state: dict = {}
    with open(path) as fh:
        for rec in _csv.DictReader(fh):
            state[rec["w"]] = state.get(rec["w"], 0) + int(rec["c"]) * int(rec["diff"])
    return {k: v for k, v in state.items() if v}


def test_sharded_sink_merge_commit(tmp_path):
    pw = pathway_tpu_torch
    broker = _filled_broker(pw)
    solo = str(tmp_path / "solo.csv")
    pw.G.clear()
    pw.io.fs.write(_wordcount(pw, broker), solo, format="csv")
    pw.run(monitoring_level="none", n_workers=1)
    out = str(tmp_path / "sharded.csv")
    pw.G.clear()
    pw.io.fs.write(_wordcount(pw, broker), out, format="csv", sharded=True)
    pw.run(monitoring_level="none", n_workers=4)
    ref_out = str(tmp_path / "ref_sharded.csv")
    pathway_tpu.G.clear()
    pathway_tpu.io.fs.write(_wordcount(pathway_tpu, _filled_broker(pathway_tpu)), ref_out, format="csv", sharded=True)
    pathway_tpu.run(monitoring_level="none", n_workers=4)
    assert os.path.exists(out)
    assert not [p for p in os.listdir(tmp_path) if ".part-" in p], "parts left"
    assert _net(out) == _net(solo) == _net(ref_out)
    with open(out) as fh:
        times = [int(r["time"]) for r in _csv.DictReader(fh)]
    assert times == sorted(times)


def test_sharded_sink_jsonlines(tmp_path):
    pw = pathway_tpu_torch
    broker = _filled_broker(pw)
    out = str(tmp_path / "out.jsonl")
    pw.G.clear()
    pw.io.fs.write(_wordcount(pw, broker), out, format="jsonlines", sharded=True)
    pw.run(monitoring_level="none", n_workers=3)
    state: dict = {}
    with open(out) as fh:
        for line in fh:
            rec = json.loads(line)
            state[rec["w"]] = state.get(rec["w"], 0) + rec["c"] * rec["diff"]
    truth: dict = {}
    for i in range(N_MSGS):
        truth[f"w{i % 13}"] = truth.get(f"w{i % 13}", 0) + 1
    assert {k: v for k, v in state.items() if v} == truth


def test_cluster_partitioned_ingest(tmp_path):
    """2 processes x 2 threads: partition slices ingest on BOTH processes;
    net output equals the single process's and the reference's."""
    broker_path = str(tmp_path / "broker")
    _filled_broker(pathway_tpu_torch, path=broker_path)
    env = {"BROKER_PATH": broker_path}
    os.environ["BROKER_PATH"] = broker_path
    try:
        port, ref = str(tmp_path / "port_solo"), str(tmp_path / "ref_solo")
        tc.run_in_process(pathway_tpu_torch, "kafka_ingest", port)
        tc.run_in_process(pathway_tpu, "kafka_ingest", ref)
    finally:
        os.environ.pop("BROKER_PATH", None)
    dist = str(tmp_path / "dist")
    outputs = tc.run_cluster("kafka_ingest", dist, processes=2, threads=2, env=env)

    def net(path):
        state: dict = {}
        with open(path) as fh:
            for rec in _csv.DictReader(fh):
                c, s = state.get(rec["w"], (0, 0))
                d = int(rec["diff"])
                state[rec["w"]] = (c + int(rec["c"]) * d, s + int(rec["s"]) * d)
        return {k: v for k, v in state.items() if v != (0, 0)}

    assert net(dist + ".csv") == net(port + ".csv") == net(ref + ".csv")
    per_proc = [int(line.split()[1]) for o in outputs for line in o.splitlines() if line.startswith("INGESTED_SUBJECTS")]
    assert len(per_proc) == 2 and all(n >= 1 for n in per_proc), outputs
