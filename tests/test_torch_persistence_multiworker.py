"""Persistence on the port's thread-sharded runtime against the reference
(the multi-worker cases of ``tests/test_persistence.py``): per-worker
operator snapshots with an O(state) restart, the refusal of a restart at
another worker count, and the sharded sink (``fs.write(sharded=True)``) at 2
workers across a clean stop, a crash between merge and snapshot, and a
SIGKILL. Each in-process scenario runs through both packages, each on its own
storage, and both must give the same rows. The SIGKILL cases run the port in
a subprocess over the file-backed mock Kafka broker and are marked ``slow``,
as the reference marks them.
"""

from __future__ import annotations

import csv
import os
import pickle
import signal
import subprocess
import sys
import time

import pytest

import pathway_tpu
import pathway_tpu_torch
import torch_cluster_helpers as tc

PACKAGES = (pathway_tpu, pathway_tpu_torch)


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    monkeypatch.setenv("PATHWAY_PERSISTENT_STORAGE", "unset")
    monkeypatch.delenv("PATHWAY_PERSISTENT_STORAGE")
    for pw in PACKAGES:
        pw.G.clear()
    yield
    for pw in PACKAGES:
        pw.G.clear()


def _mod(pw, name):
    from importlib import import_module

    return import_module(f"{pw.__name__}.{name}")


def _session(pw, rows, backend, n_workers):
    """The reference's word-count operator session: {word: total}."""
    pw.G.clear()

    class ListSubject(pw.io.python.ConnectorSubject):
        def run(self):
            for w, c in rows:
                self.next(word=w, count=c)

    t = pw.io.python.read(ListSubject(), schema=pw.schema_from_types(word=str, count=int), name="wordsource")
    agg = t.groupby(pw.this.word).reduce(pw.this.word, total=pw.reducers.sum(pw.this.count))
    results = {}
    pw.io.subscribe(
        agg,
        on_change=lambda key, row, time, is_addition: results.__setitem__(row["word"], row["total"])
        if is_addition
        else None,
    )
    pw.run(
        n_workers=n_workers,
        monitoring_level="none",
        persistence_config=pw.persistence.Config(backend=backend, persistence_mode="operator_persisting"),
    )
    return results


def test_operator_snapshot_multiworker_o_state(tmp_path, monkeypatch):
    """A 4-worker run snapshots every worker's state shards; the 4-worker
    restart restores them, replays nothing of run 1 and emits only new
    deltas — in both packages."""
    seen = {}
    for pw in PACKAGES:
        backend = pw.persistence.Backend.filesystem(str(tmp_path / pw.__name__))
        out1 = _session(pw, [("a", 1), ("b", 2), ("a", 3), ("c", 7)], backend, 4)
        snapmod = _mod(pw, "persistence.snapshots")
        pushed: list = []
        orig = snapmod._PersistedInput.replay

        def counting(self, orig=orig, pushed=pushed):
            push = self._original_push

            def probe(key, values, diff):
                pushed.append((key, values, diff))
                push(key, values, diff)

            self._original_push = probe
            try:
                return orig(self)
            finally:
                self._original_push = push

        monkeypatch.setattr(snapmod._PersistedInput, "replay", counting)
        out2 = _session(pw, [("a", 1), ("b", 2), ("a", 3), ("c", 7), ("b", 10), ("d", 5)], backend, 4)
        monkeypatch.setattr(snapmod._PersistedInput, "replay", orig)
        seen[pw.__name__] = (out1, out2, pushed)
    assert seen["pathway_tpu_torch"] == seen["pathway_tpu"]
    out1, out2, pushed = seen["pathway_tpu_torch"]
    assert out1 == {"a": 4, "b": 2, "c": 7}
    assert pushed == []
    assert out2 == {"b": 12, "d": 5}


@pytest.mark.parametrize("pw", PACKAGES, ids=("ref", "port"))
def test_operator_snapshot_worker_count_mismatch_refused(pw, tmp_path):
    backend = pw.persistence.Backend.filesystem(str(tmp_path / "pstate"))
    _session(pw, [("a", 1), ("b", 2)], backend, 4)
    with pytest.raises(RuntimeError, match="worker"):
        _session(pw, [("a", 1), ("b", 2)], backend, 2)


def _sharded_session(pw, rows, backend, out):
    pw.G.clear()

    class ListSubject(pw.io.python.ConnectorSubject):
        def run(self):
            for w, c in rows:
                self.next(word=w, count=c)

    t = pw.io.python.read(ListSubject(), schema=pw.schema_from_types(word=str, count=int), name="wordsource")
    pw.io.fs.write(t, out, format="csv", sharded=True)
    pw.run(
        n_workers=2,
        monitoring_level="none",
        persistence_config=pw.persistence.Config(backend=backend, persistence_mode="operator_persisting"),
    )


def test_sharded_sink_clean_stop_then_restart(tmp_path):
    """A clean stop merges the parts and snapshots a ``merged`` marker; a
    restart with no new rows leaves the output untouched; one with new rows
    raises the documented error — the same in both packages."""
    rows = [("a", 1), ("b", 2), ("c", 3), ("d", 4)]
    merged = {}
    for pw in PACKAGES:
        d = tmp_path / pw.__name__
        backend = pw.persistence.Backend.filesystem(str(d / "pstate"))
        out = str(d / "out.csv")
        os.makedirs(d)
        _sharded_session(pw, rows, backend, out)
        merged1 = tc.read(out)
        assert sorted(r["word"] for r in csv.DictReader(merged1.splitlines())) == ["a", "b", "c", "d"]
        assert not [f for f in os.listdir(d) if ".part-" in f]
        _sharded_session(pw, rows, backend, out)
        assert tc.read(out) == merged1
        with pytest.raises(RuntimeError, match="merge-committed"):
            _sharded_session(pw, rows + [("e", 5)], backend, out)
        assert tc.read(out) == merged1
        merged[pw.__name__] = sorted(merged1.splitlines()[1:])
    assert merged["pathway_tpu_torch"] == merged["pathway_tpu"]


def test_sharded_sink_crash_between_merge_and_snapshot(tmp_path):
    """A crash between the merge-commit and the at-close snapshot leaves a
    snapshot of part offsets for deleted parts: the restore recognizes the
    completed merge, in both packages."""
    rows = [("a", 1), ("b", 2), ("c", 3), ("d", 4)]
    for pw in PACKAGES:
        d = tmp_path / pw.__name__
        os.makedirs(d)
        backend = pw.persistence.Backend.filesystem(str(d / "pstate"))
        out = str(d / "out.csv")
        _sharded_session(pw, rows, backend, out)
        merged1 = tc.read(out)
        fb = _mod(pw, "persistence.backends").FileBackend(str(d / "pstate"))

        def doctor():
            n = 0
            for key in fb.list_keys("operators/"):
                raw = fb.get(key)
                if raw is None or b"__sink__" not in raw:
                    continue
                st = pickle.loads(raw)
                if isinstance(st, dict) and st.get("__sink__", {}).get("merged"):
                    fb.put(key, pickle.dumps({"__sink__": {"offset": 42}}))
                    n += 1
            return n

        assert doctor(), "expected merged sink snapshots to doctor"
        _sharded_session(pw, rows, backend, out)
        assert tc.read(out) == merged1
        doctor()
        with pytest.raises(RuntimeError, match="merge-committed"):
            _sharded_session(pw, rows + [("e", 5)], backend, out)
        assert tc.read(out) == merged1


def _wait_manifest(pstore, covered_of, p):
    manifest_path = os.path.join(pstore, "operators", "manifest")
    deadline = time.time() + 90
    while time.time() < deadline:
        if os.path.exists(manifest_path):
            try:
                with open(manifest_path, "rb") as fh:
                    meta = pickle.loads(fh.read())
                if covered_of(meta["input_offsets"]):
                    return
            except Exception:
                pass  # mid-replace read; retry
        time.sleep(0.03)
    p.kill()
    raise AssertionError("no covering snapshot before deadline: " + (p.communicate()[0] or ""))


def _spawn(pipeline, out, env):
    return subprocess.Popen(
        [sys.executable, tc.__file__, pipeline, out],
        env=dict(os.environ, PYTHONPATH=os.pathsep.join([tc.REPO, tc.TESTS]), **env),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )


@pytest.mark.slow
def test_operator_kill_restart_multiworker(tmp_path):
    """SIGKILL mid-stream at ``PATHWAY_THREADS=4``; the restart recovers
    O(state) from the per-worker snapshots and the single output file is the
    complete diff stream."""
    broker_path, pstore = str(tmp_path / "broker"), str(tmp_path / "pstore")
    out = str(tmp_path / "out")
    first = [f"w{i % 17}" for i in range(160)] + [f"only{i % 5}" for i in range(40)]
    second = [f"w{i % 17}" for i in range(200)]
    broker = pathway_tpu_torch.io.kafka.MockKafkaBroker(path=broker_path)
    broker.create_topic("words", partitions=2)
    for i, w in enumerate(first):
        broker.produce("words", w, partition=i % 2)
    env = {"PATHWAY_THREADS": "4", "BROKER_PATH": broker_path, "PSTORE": pstore,
           "EXPECTED_WORDS": str(10**9), "SNAPSHOT_INTERVAL_MS": "150"}
    p = _spawn("persist_words", out, env)
    _wait_manifest(
        pstore,
        lambda offs: sum(v for k, v in offs.items() if k == "words" or k.startswith("words@w")) >= len(first),
        p,
    )
    p.send_signal(signal.SIGKILL)
    p.wait()
    run1 = tc.read(out + ".csv")
    for i, w in enumerate(second):
        broker.produce("words", w, partition=i % 2)
    env["EXPECTED_WORDS"] = str(len(first) + len(second))
    p = _spawn("persist_words", out, env)
    stdout, _ = p.communicate(timeout=120)
    assert p.returncode == 0, stdout

    state: dict = {}
    with open(out + ".csv") as fh:
        for rec in csv.DictReader(fh):
            state[rec["data"]] = state.get(rec["data"], 0) + int(rec["c"]) * int(rec["diff"])
    truth: dict = {}
    for w in first + second:
        truth[w] = truth.get(w, 0) + 1
    assert {k: v for k, v in state.items() if v} == truth
    final = tc.read(out + ".csv")
    assert final.startswith(run1)
    assert "only" not in final[len(run1):]


@pytest.mark.slow
def test_sharded_sink_exactly_once_on_kill_restart(tmp_path):
    """``fs.write(sharded=True)`` at 2 workers: SIGKILL mid-stream and a
    restart keep every part's committed prefix and re-emit the rewound suffix
    exactly once."""
    broker_path, pstore = str(tmp_path / "broker"), str(tmp_path / "pstore")
    out = str(tmp_path / "out.csv")
    first = [f"row-{i:05d}" for i in range(300)]
    second = [f"row-{i:05d}" for i in range(300, 500)]
    broker = pathway_tpu_torch.io.kafka.MockKafkaBroker(path=broker_path)
    broker.create_topic("rows", partitions=2)
    for i, w in enumerate(first):
        broker.produce("rows", w, partition=i % 2)
    env = {"PATHWAY_THREADS": "2", "BROKER_PATH": broker_path, "PSTORE": pstore, "EXPECTED_ROWS": str(10**9)}
    p = _spawn("sharded_identity", out, env)
    _wait_manifest(pstore, lambda offs: sum(v for k, v in offs.items() if k == "rows" or k.startswith("rows@w")) >= 50, p)
    parts = [f for f in os.listdir(tmp_path) if f.startswith("out.csv.part-")]
    p.send_signal(signal.SIGKILL)
    p.wait()
    assert parts, "no part files written before the kill"
    for i, w in enumerate(second):
        broker.produce("rows", w, partition=i % 2)
    env["EXPECTED_ROWS"] = str(len(first) + len(second))
    p = _spawn("sharded_identity", out, env)
    stdout, _ = p.communicate(timeout=120)
    assert p.returncode == 0, stdout
    with open(out) as fh:
        lines = [rec["data"] for rec in csv.DictReader(fh)]
    assert sorted(lines) == sorted(first + second)
