"""Persistence in the port against the reference (``tests/test_persistence.py``):
input logs and offsets, restart recovery, operator snapshots with log
compaction, the epoch manifest, sinks that survive a restart.

Each scenario is written once as a function of the package and runs through
``pathway_tpu`` and ``pathway_tpu_torch`` on the same seeded inputs, each
package writing to its own storage (a ``tmp_path`` directory or a memory-
backend root). Both must give the same restart outputs: keys, rows, times and
diffs where the source is a timed stream, keys and final rows where it is a
connector thread. Within the port, a restart must equal an uninterrupted run
bit for bit. The reference's multi-worker cases are in
``tests/test_torch_persistence_multiworker.py``.
"""

from __future__ import annotations

import csv
import importlib
import os
import pickle
import time

import pytest

import pathway_tpu
import pathway_tpu_torch
from pathway_tpu.persistence import backends as ref_backends
from pathway_tpu_torch.persistence import backends as port_backends

PACKAGES = (pathway_tpu, pathway_tpu_torch)
BACKENDS = {pathway_tpu: ref_backends, pathway_tpu_torch: port_backends}


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    """``attach`` points ``PATHWAY_PERSISTENT_STORAGE`` at a filesystem
    backend's root for the rest of the process (the reference's UDF cache
    colocation): restore it after each case. Memory roots are cleared."""
    monkeypatch.setenv("PATHWAY_PERSISTENT_STORAGE", "unset")
    monkeypatch.delenv("PATHWAY_PERSISTENT_STORAGE")
    for var in ("PATHWAY_REPLAY_STORAGE", "PATHWAY_RECORD", "PATHWAY_ELASTIC", "PATHWAY_DELIVERY"):
        monkeypatch.delenv(var, raising=False)
    roots: list[str] = []
    yield roots
    for mod in BACKENDS.values():
        for r in roots:
            mod.MemoryBackend.clear(r)
    for pw in PACKAGES:
        pw.G.clear()


def _subject(pw, rows):
    class ListSubject(pw.io.python.ConnectorSubject):
        """Deterministic bounded source: replays a list then closes."""

        def __init__(self):
            super().__init__()
            self.delivered = 0

        def run(self):
            for word, count in rows:
                self.next(word=word, count=count)
                self.delivered += 1

    return ListSubject()


def _schema(pw):
    return pw.schema_from_types(word=str, count=int)


def _storage(pw, kind, tmp_path, roots, name="pstate"):
    if kind == "filesystem":
        return pw.persistence.Backend.filesystem(str(tmp_path / pw.__name__ / name))
    root = f"{pw.__name__}-{tmp_path.name}-{name}"
    roots.append(root)
    BACKENDS[pw].MemoryBackend.clear(root)
    return pw.persistence.Backend("memory", root)


def _kv(backend_cfg):
    """The raw KV store behind a ``Backend`` config, for either package."""
    mod = port_backends if type(backend_cfg).__module__.startswith("pathway_tpu_torch") else ref_backends
    return mod.backend_from_config(backend_cfg)


def _word_session(pw, rows, backend, mode="persisting", name="wordsource"):
    """The reference's word-count session: groupby-sum over a connector
    thread; returns {key: (word, total)} of the live rows and the subject."""
    pw.G.clear()
    subj = _subject(pw, rows)
    t = pw.io.python.read(subj, schema=_schema(pw), name=name)
    agg = t.groupby(pw.this.word).reduce(pw.this.word, total=pw.reducers.sum(pw.this.count))
    results: dict = {}
    pw.io.subscribe(
        agg,
        on_change=lambda key, row, time, is_addition: results.__setitem__(
            int(key), (row["word"], row["total"])
        )
        if is_addition
        else None,
    )
    pw.run(
        monitoring_level="none",
        persistence_config=pw.persistence.Config(backend=backend, persistence_mode=mode),
    )
    pw.G.clear()
    return results, subj


# ------------------------------------------------------- input logs + offsets


@pytest.mark.parametrize("kind", ["filesystem", "memory"])
@pytest.mark.parametrize("mode", ["persisting", "operator_persisting"])
def test_restart_recovers_and_seeks(tmp_path, _isolated, kind, mode):
    """Run, finish, restart over the same storage with a longer input: the
    restart skips the persisted events and ingests only the new ones; both
    packages emit the same keyed rows in each run."""
    first = [("a", 1), ("b", 2), ("a", 3)]
    second = first + [("b", 10), ("c", 5)]
    got = {}
    for pw in PACKAGES:
        backend = _storage(pw, kind, tmp_path, _isolated)
        out1, subj1 = _word_session(pw, first, backend, mode)
        out2, _ = _word_session(pw, second, backend, mode)
        assert subj1.delivered == 3
        got[pw] = (out1, out2)
    ref, port = got[pathway_tpu], got[pathway_tpu_torch]
    assert port == ref
    assert sorted(port[0].values()) == [("a", 4), ("b", 2)]
    if mode == "persisting":  # input replay re-emits every aggregate
        assert sorted(port[1].values()) == [("a", 4), ("b", 12), ("c", 5)]
    else:  # operator snapshots: only the aggregates the suffix changed
        assert sorted(port[1].values()) == [("b", 12), ("c", 5)]


def test_restart_without_new_data(tmp_path, _isolated):
    got = {}
    for pw in PACKAGES:
        backend = _storage(pw, "filesystem", tmp_path, _isolated)
        _word_session(pw, [("x", 7)], backend)
        got[pw] = _word_session(pw, [("x", 7)], backend)[0]
    assert got[pathway_tpu_torch] == got[pathway_tpu]
    assert list(got[pathway_tpu_torch].values()) == [("x", 7)]


def test_named_source_pid_survives_pipeline_edits(tmp_path, _isolated):
    """Unrelated pipeline additions must not orphan a named source's logs."""
    got = {}
    for pw in PACKAGES:
        backend = _storage(pw, "filesystem", tmp_path, _isolated)
        _word_session(pw, [("a", 1)], backend)
        pw.G.clear()
        extra = pw.debug.table_from_markdown(
            """
            | v
        1   | 42
            """
        )
        pw.io.subscribe(extra, on_change=lambda key, row, time, is_addition: None)
        t = pw.io.python.read(_subject(pw, [("a", 1), ("b", 9)]), schema=_schema(pw), name="wordsource")
        agg = t.groupby(pw.this.word).reduce(pw.this.word, total=pw.reducers.sum(pw.this.count))
        out: dict = {}
        pw.io.subscribe(
            agg,
            on_change=lambda key, row, time, is_addition: out.__setitem__(int(key), (row["word"], row["total"]))
            if is_addition
            else None,
        )
        pw.run(monitoring_level="none", persistence_config=pw.persistence.Config(backend=backend))
        got[pw] = (out, sorted(_kv(backend).list_keys("inputs/")))
    assert got[pathway_tpu_torch] == got[pathway_tpu]
    assert sorted(got[pathway_tpu_torch][0].values()) == [("a", 1), ("b", 9)]


# ------------------------------------------------------------------ backends


def test_memory_backend_roundtrip(_isolated):
    for mod in BACKENDS.values():
        mod.MemoryBackend.clear("t1")
        b = mod.MemoryBackend("t1")
        b.put("a/b", b"xyz")
        assert b.get("a/b") == b"xyz"
        assert mod.MemoryBackend("t1").get("a/b") == b"xyz"  # shared per root
        assert b.list_keys("a/") == ["a/b"]
        b.delete("a/b")
        assert b.get("a/b") is None
        mod.MemoryBackend.clear("t1")


def test_file_backend_roundtrip(tmp_path):
    for pw, mod in BACKENDS.items():
        b = mod.FileBackend(str(tmp_path / pw.__name__))
        b.put("inputs/src-1/chunk_00000000", b"data")
        b.put("inputs/src-1/metadata", b"meta")
        assert b.get("inputs/src-1/metadata") == b"meta"
        assert b.list_keys("inputs/src-1/") == ["inputs/src-1/chunk_00000000", "inputs/src-1/metadata"]
        assert b.get("missing") is None
        with pytest.raises(ValueError):
            b.put("../escape", b"no")


def test_mock_backend_records_operations():
    ops = {}
    for pw, mod in BACKENDS.items():
        mod.MemoryBackend.clear("mockroot")
        b = mod.MockBackend("mockroot")
        b.put("k", b"v")
        b.get("k")
        ops[pw] = list(b.operations)
        mod.MemoryBackend.clear("mockroot")
    assert ops[pathway_tpu_torch] == ops[pathway_tpu] == [("put", "k"), ("get", "k")]


def test_operator_persisting_mode_accepted():
    from pathway_tpu_torch.persistence.snapshots import Persistence

    p = Persistence(
        pathway_tpu_torch.persistence.Config(
            backend=pathway_tpu_torch.persistence.Backend("memory", "accepted"),
            persistence_mode="operator_persisting",
        )
    )
    assert p.operator_mode
    port_backends.MemoryBackend.clear("accepted")


# ---------------------------------------------------------------- operator mode


def test_operator_snapshot_restart_is_o_state(tmp_path, _isolated, monkeypatch):
    """The restart restores node state and replays nothing of run 1's log."""
    got = {}
    for pw in PACKAGES:
        snapmod = __import__(f"{pw.__name__}.persistence.snapshots", fromlist=["_PersistedInput"])
        backend = _storage(pw, "filesystem", tmp_path, _isolated)
        _word_session(pw, [("a", 1), ("b", 2), ("a", 3)], backend, "operator_persisting")
        pushed: list = []
        orig_replay = snapmod._PersistedInput.replay

        def counting_replay(self, orig_replay=orig_replay, pushed=pushed):
            orig_push = self._original_push

            def probe(key, values, diff):
                pushed.append((key, values, diff))
                orig_push(key, values, diff)

            self._original_push = probe
            try:
                return orig_replay(self)
            finally:
                self._original_push = orig_push

        monkeypatch.setattr(snapmod._PersistedInput, "replay", counting_replay)
        out2, _ = _word_session(
            pw, [("a", 1), ("b", 2), ("a", 3), ("b", 10), ("c", 5)], backend, "operator_persisting"
        )
        assert pushed == []
        got[pw] = out2
    assert got[pathway_tpu_torch] == got[pathway_tpu]
    assert sorted(got[pathway_tpu_torch].values()) == [("b", 12), ("c", 5)]


def test_operator_snapshot_compacts_log(tmp_path, _isolated):
    got = {}
    for pw in PACKAGES:
        backend = _storage(pw, "filesystem", tmp_path, _isolated)
        _word_session(pw, [("a", 1), ("b", 2)], backend, "operator_persisting")
        out2, _ = _word_session(pw, [("a", 1), ("b", 2), ("c", 3)], backend, "operator_persisting")
        kv = _kv(backend)
        chunk_keys = [k for k in kv.list_keys("inputs/") if "chunk" in k]
        assert chunk_keys == [], chunk_keys
        meta = pickle.loads(kv.get("inputs/wordsource/metadata"))
        manifest = pickle.loads(kv.get("operators/manifest"))
        got[pw] = (out2, kv.list_keys(""), meta, manifest["gen"], manifest["input_offsets"], manifest["tick"])
    assert got[pathway_tpu_torch] == got[pathway_tpu]
    assert list(got[pathway_tpu_torch][0].values()) == [("c", 3)]


def test_operator_snapshot_graph_change_is_refused(tmp_path, _isolated):
    for pw in PACKAGES:
        backend = _storage(pw, "filesystem", tmp_path, _isolated)
        _word_session(pw, [("a", 1), ("b", 2)], backend, "operator_persisting")
        pw.G.clear()
        t = pw.io.python.read(_subject(pw, [("a", 1), ("b", 2), ("c", 9)]), schema=_schema(pw), name="wordsource")
        agg = t.filter(pw.this.count > 0).groupby(pw.this.word).reduce(
            pw.this.word, total=pw.reducers.sum(pw.this.count)
        )
        pw.io.subscribe(agg, on_change=lambda key, row, time, is_addition: None)
        with pytest.raises(RuntimeError, match="different pipeline graph"):
            pw.run(
                monitoring_level="none",
                persistence_config=pw.persistence.Config(backend=backend, persistence_mode="operator_persisting"),
            )


def test_operator_snapshot_join_state(tmp_path, _isolated):
    """Join state (the columnar multimap) survives a restart."""
    got = {}
    for pw in PACKAGES:
        backend = _storage(pw, "filesystem", tmp_path, _isolated)

        def session(rows, pw=pw, backend=backend):
            pw.G.clear()
            left = pw.io.python.read(_subject(pw, rows), schema=_schema(pw), name="left")
            right = pw.debug.table_from_rows(
                pw.schema_from_types(word=str, factor=int), [("a", 10), ("b", 100)]
            )
            j = left.join(right, left.word == right.word).select(word=left.word, scaled=left.count * right.factor)
            seen = {}
            pw.io.subscribe(
                j,
                on_change=lambda key, row, time, is_addition: seen.__setitem__(
                    (int(key), row["word"], row["scaled"]), is_addition
                ),
            )
            pw.run(
                monitoring_level="none",
                persistence_config=pw.persistence.Config(backend=backend, persistence_mode="operator_persisting"),
            )
            return seen

        got[pw] = (session([("a", 1)]), session([("a", 1), ("b", 3)]))
    assert got[pathway_tpu_torch] == got[pathway_tpu]
    assert {(w, s) for (_k, w, s), add in got[pathway_tpu_torch][1].items() if add} == {("b", 300)}


# ------------------------------------------------------------ timed streams

_MD1 = """
  word | count | __time__
  a    | 1     | 2
  b    | 2     | 2
  a    | 3     | 4
  c    | 7     | 4
"""
_MD2 = _MD1 + """  b    | 10    | 6
  c    | -7    | 6
  d    | 5     | 8
"""


def _timed_session(pw, md, backend, mode, interval_ms=0):
    """Word totals over a timed stream: the update stream (key, row, time,
    diff) is deterministic on both packages."""
    pw.G.clear()
    t = pw.debug.table_from_markdown(md)
    agg = t.groupby(pw.this.word).reduce(pw.this.word, total=pw.reducers.sum(pw.this.count))
    got = []
    pw.io.subscribe(
        agg,
        on_change=lambda key, row, time, is_addition: got.append(
            (int(key), (row["word"], row["total"]), time, 1 if is_addition else -1)
        ),
    )
    pw.run(
        monitoring_level="none",
        persistence_config=pw.persistence.Config(
            backend=backend, persistence_mode=mode, snapshot_interval_ms=interval_ms
        )
        if backend is not None
        else None,
    )
    pw.G.clear()
    return got


@pytest.mark.parametrize("kind", ["filesystem", "memory"])
@pytest.mark.parametrize("mode", ["persisting", "operator_persisting"])
def test_timed_restart_stream_matches_reference_and_uninterrupted(tmp_path, _isolated, kind, mode):
    """The restart's update stream is the reference's (keys, rows, times,
    diffs); under operator snapshots it is exactly the uninterrupted run's
    stream past the cut, and in both modes the final rows are the
    uninterrupted run's. The epoch manifests agree."""
    got = {}
    for pw in PACKAGES:
        backend = _storage(pw, kind, tmp_path, _isolated)
        run1 = _timed_session(pw, _MD1, backend, mode)
        run2 = _timed_session(pw, _MD2, backend, mode)
        full = _timed_session(pw, _MD2, None, mode)
        epoch = pw.persistence.last_committed_epoch(backend)
        got[pw] = (run1, run2, full, {k: epoch[k] for k in ("epoch", "tick", "input_offsets", "opsnap_gen")})
    assert got[pathway_tpu_torch] == got[pathway_tpu]
    run1, run2, full, _epoch = got[pathway_tpu_torch]
    cut = max(e[2] for e in run1)

    def final(stream):
        state: dict = {}
        for k, row, _t, d in stream:
            state[(k, row)] = state.get((k, row), 0) + d
        return {kr for kr, n in state.items() if n}

    if mode == "operator_persisting":
        assert run2 == [e for e in full if e[2] > cut]
        assert final(run1 + run2) == final(full)
    else:
        assert final(run2) == final(full)


class _StepClock:
    """``time`` for a snapshot module whose ``monotonic()`` advances a fixed
    step per reading (every other name is the real module's): the cadence
    of ``_OperatorSnapshots.due`` then follows the run's own readings, not
    the machine's load."""

    def __init__(self, step_s: float):
        self.step_s, self.now = step_s, 0.0

    def monotonic(self) -> float:
        self.now += self.step_s
        return self.now

    def __getattr__(self, name):
        return getattr(time, name)


def test_periodic_snapshots_commit_generations_and_epochs(tmp_path, _isolated, monkeypatch):
    """With a snapshot cadence, generations commit during the run; the
    manifests' generation, offsets and the epoch record agree with the
    reference's, and the log is compacted to the committed offsets. Each
    package's snapshot module reads a clock that advances 1 ms, the
    cadence, per reading (both modules read it at the same places), so the
    same ticks snapshot on both, however loaded the machine is."""
    got = {}
    for pw in PACKAGES:
        monkeypatch.setattr(importlib.import_module(f"{pw.__name__}.persistence.snapshots"), "_time", _StepClock(1e-3))
        backend = _storage(pw, "memory", tmp_path, _isolated)
        stream = _timed_session(pw, _MD2, backend, "operator_persisting", interval_ms=1)
        kv = _kv(backend)
        manifest = pickle.loads(kv.get("operators/manifest"))
        epoch = pw.persistence.last_committed_epoch(kv)
        got[pw] = (
            stream,
            manifest["gen"] >= 1,
            manifest["input_offsets"],
            epoch["input_offsets"],
            epoch["opsnap_gen"] == manifest["gen"],
            [k for k in kv.list_keys("inputs/") if "chunk" in k],
        )
    assert got[pathway_tpu_torch] == got[pathway_tpu]
    assert got[pathway_tpu_torch][1] and got[pathway_tpu_torch][4]


def test_recording_roots_replay_storage_and_record(tmp_path, _isolated, monkeypatch):
    """``PATHWAY_PERSISTENT_STORAGE`` + ``PATHWAY_RECORD`` records a run;
    ``PATHWAY_REPLAY_STORAGE`` replays the recording (the CLI's contract)."""
    got = {}
    for pw in PACKAGES:
        root = str(tmp_path / pw.__name__ / "rec")
        monkeypatch.setenv("PATHWAY_PERSISTENT_STORAGE", root)
        monkeypatch.setenv("PATHWAY_RECORD", "1")
        run1 = _timed_session(pw, _MD1, None, "persisting")
        keys = sorted(port_backends.FileBackend(root).list_keys(""))
        monkeypatch.delenv("PATHWAY_RECORD")
        monkeypatch.delenv("PATHWAY_PERSISTENT_STORAGE")
        monkeypatch.setenv("PATHWAY_REPLAY_STORAGE", root)
        replayed = _timed_session(pw, _MD1, None, "persisting")
        monkeypatch.delenv("PATHWAY_REPLAY_STORAGE")
        got[pw] = (run1, keys, replayed)
    assert got[pathway_tpu_torch] == got[pathway_tpu]
    assert any(k.startswith("inputs/") for k in got[pathway_tpu_torch][1])


# -------------------------------------------------------------------- sinks


def _sink_session(pw, rows, backend, out, **write_kw):
    pw.G.clear()
    t = pw.io.python.read(_subject(pw, rows), schema=_schema(pw), name="wordsource")
    pw.io.fs.write(t, out, format="csv", **write_kw)
    pw.run(
        monitoring_level="none",
        persistence_config=pw.persistence.Config(backend=backend, persistence_mode="operator_persisting"),
    )
    pw.G.clear()


def _words(path):
    with open(path) as fh:
        return sorted(r["word"] for r in csv.DictReader(fh))


def test_sink_survives_clean_stop_then_restart(tmp_path, _isolated):
    """The at-close snapshot records the sink's final offset: a restart with
    more data appends to the output instead of truncating it."""
    got = {}
    for pw in PACKAGES:
        backend = _storage(pw, "filesystem", tmp_path, _isolated)
        out = str(tmp_path / f"{pw.__name__}.csv")
        _sink_session(pw, [("a", 1), ("b", 2)], backend, out)
        first = _words(out)
        _sink_session(pw, [("a", 1), ("b", 2), ("c", 3)], backend, out)
        got[pw] = (first, _words(out))
    assert got[pathway_tpu_torch] == got[pathway_tpu] == (["a", "b"], ["a", "b", "c"])


def test_timed_sink_bytes_match_reference_across_a_restart(tmp_path, _isolated):
    """A timed stream into a csv sink, restarted once: the file's bytes
    (rows, times, diffs) are the reference's, and equal the uninterrupted
    run's file."""
    got = {}
    for pw in PACKAGES:
        backend = _storage(pw, "filesystem", tmp_path, _isolated)
        out = str(tmp_path / f"{pw.__name__}.csv")
        whole = str(tmp_path / f"{pw.__name__}-whole.csv")

        def session(md, path, backend, pw=pw):
            pw.G.clear()
            t = pw.debug.table_from_markdown(md)
            agg = t.groupby(pw.this.word).reduce(pw.this.word, total=pw.reducers.sum(pw.this.count))
            pw.io.fs.write(agg, path, format="csv")
            pw.run(
                monitoring_level="none",
                persistence_config=pw.persistence.Config(backend=backend, persistence_mode="operator_persisting")
                if backend is not None
                else None,
            )
            pw.G.clear()

        session(_MD1, out, backend)
        session(_MD2, out, backend)
        session(_MD2, whole, None)
        got[pw] = (open(out).read(), open(whole).read())
    assert got[pathway_tpu_torch] == got[pathway_tpu]
    assert got[pathway_tpu_torch][0] == got[pathway_tpu_torch][1]


def test_sharded_sink_clean_stop_then_restart(tmp_path, _isolated):
    """A sharded sink on one worker: a clean stop merges the part and
    snapshots a ``merged`` marker; a restart without new rows leaves the
    output untouched, and one with new rows raises the documented error."""
    got = {}
    for pw in PACKAGES:
        backend = _storage(pw, "filesystem", tmp_path, _isolated)
        out = str(tmp_path / f"{pw.__name__}.csv")
        rows = [("a", 1), ("b", 2), ("c", 3), ("d", 4)]
        _sink_session(pw, rows, backend, out, sharded=True)
        merged1 = open(out).read()
        assert not [f for f in os.listdir(str(tmp_path)) if ".part-" in f]
        _sink_session(pw, rows, backend, out, sharded=True)
        assert open(out).read() == merged1
        with pytest.raises(RuntimeError, match="merge-committed"):
            _sink_session(pw, rows + [("e", 5)], backend, out, sharded=True)
        assert open(out).read() == merged1
        got[pw] = _words(out)
    assert got[pathway_tpu_torch] == got[pathway_tpu] == ["a", "b", "c", "d"]


def test_sharded_sink_crash_between_merge_and_snapshot(tmp_path, _isolated):
    """A snapshot that still records part offsets after the merge committed
    (the crash window): the restore recognizes the completed merge."""
    for pw in PACKAGES:
        backend = _storage(pw, "filesystem", tmp_path, _isolated)
        out = str(tmp_path / f"{pw.__name__}.csv")
        rows = [("a", 1), ("b", 2), ("c", 3), ("d", 4)]
        _sink_session(pw, rows, backend, out, sharded=True)
        merged1 = open(out).read()
        fb = _kv(backend)

        def doctor(fb=fb):
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
        _sink_session(pw, rows, backend, out, sharded=True)
        assert open(out).read() == merged1
        doctor()
        with pytest.raises(RuntimeError, match="merge-committed"):
            _sink_session(pw, rows + [("e", 5)], backend, out, sharded=True)
        assert open(out).read() == merged1


# ---------------------------------------------------- SIGKILL + restart (slow)

_IDENTITY_PIPE = """
import os
import sys
import time

import pathway_tpu_torch as pw

expected = int(os.environ["EXPECTED_ROWS"])
rows_file = os.environ["ROWS_FILE"]


class Rows(pw.io.python.ConnectorSubject):
    '''Re-reads the rows file from the top (a deterministic source) and
    follows it while the run lives.'''

    def run(self):
        done = 0
        while True:
            with open(rows_file) as fh:
                lines = fh.read().splitlines()
            for line in lines[done:]:
                self.next(data=line)
                time.sleep(0.002)
            done = len(lines)
            if done >= expected:
                return
            time.sleep(0.05)


rows = pw.io.python.read(Rows(), schema=pw.schema_from_types(data=str), name="rows")
out = rows.select(data=rows.data)
pw.io.fs.write(out, sys.argv[1], format="csv", **({"sharded": True} if os.environ.get("SHARDED") else {}))

total = out.reduce(c=pw.reducers.count())


def on_total(key, row, time, is_addition):
    if is_addition and row["c"] >= expected:
        rt = pw.internals.run.current_runtime()
        if rt is not None:
            rt.request_stop()


pw.io.subscribe(total, on_change=on_total)
pw.run(
    persistence_config=pw.persistence.Config(
        backend=pw.persistence.Backend.filesystem(os.environ["PSTORE"]),
        persistence_mode="operator_persisting",
        snapshot_interval_ms=100,
    )
)
"""


def _kill_restart(tmp_path, sharded: bool):
    import signal
    import subprocess
    import sys as _sys
    import time as _time

    script = tmp_path / "ident.py"
    script.write_text(_IDENTITY_PIPE)
    pstore = str(tmp_path / "pstore")
    out = str(tmp_path / "out.csv")
    rows_file = str(tmp_path / "rows.txt")
    first = [f"row-{i:05d}" for i in range(300)]
    second = [f"row-{i:05d}" for i in range(300, 500)]
    with open(rows_file, "w") as fh:
        fh.write("\n".join(first) + "\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo, PSTORE=pstore, ROWS_FILE=rows_file, EXPECTED_ROWS=str(10**9))
    if sharded:
        env["SHARDED"] = "1"
    p = subprocess.Popen([_sys.executable, str(script), out], env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    manifest_path = os.path.join(pstore, "operators", "manifest")
    deadline = _time.time() + 90
    while _time.time() < deadline:
        if os.path.exists(manifest_path):
            try:
                with open(manifest_path, "rb") as fh:
                    meta = pickle.loads(fh.read())
                if meta["input_offsets"].get("rows", 0) >= 50:  # a mid-stream cut
                    break
            except Exception:
                pass
        _time.sleep(0.03)
    else:
        p.kill()
        raise AssertionError("no snapshot before deadline: " + (p.communicate()[0] or ""))
    p.send_signal(signal.SIGKILL)
    p.wait()
    with open(rows_file, "a") as fh:
        fh.write("\n".join(second) + "\n")
    env["EXPECTED_ROWS"] = str(len(first) + len(second))
    p = subprocess.run([_sys.executable, str(script), out], env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stdout + p.stderr
    with open(out) as fh:
        lines = [rec["data"] for rec in csv.DictReader(fh)]
    assert sorted(lines) == sorted(first + second), (
        f"{len(lines)} lines, {len(set(lines))} unique; "
        f"dups={[w for w in set(lines) if lines.count(w) > 1][:5]}"
    )


@pytest.mark.slow
def test_exactly_once_output_on_restart(tmp_path):
    """SIGKILL mid-stream + restart: the csv output holds each input row
    exactly once (the sink's frontier snapshot + rewind). The reference
    reads a mock Kafka topic; the source here re-reads a file (the Kafka
    cases are in ``tests/test_torch_persistence_multiworker.py``)."""
    _kill_restart(tmp_path, sharded=False)


@pytest.mark.slow
def test_sharded_sink_exactly_once_on_kill_restart(tmp_path):
    """The same with ``fs.write(sharded=True)`` on the port's one worker:
    the part keeps its committed prefix and the rewound suffix is re-emitted
    exactly once."""
    _kill_restart(tmp_path, sharded=True)


# ------------------------------------------------------------ planes at restore


def test_restored_run_starts_the_audit_plane_with_a_truncated_history(tmp_path, _isolated, monkeypatch):
    """A restart that replays only the log suffix retracts rows the run never
    saw inserted: the audit plane (at ``full``) starts the run with its
    history marked truncated and reports no violation, as in the reference."""
    from pathway_tpu.observability import audit as ref_audit
    from pathway_tpu_torch.observability import audit as port_audit

    audits = {pathway_tpu: ref_audit, pathway_tpu_torch: port_audit}
    monkeypatch.setenv("PATHWAY_AUDIT", "full")
    first = """
      word | count | __time__ | __diff__
      a    | 1     | 2        | 1
      b    | 2     | 2        | 1
    """
    second = first + """      a    | 1     | 6        | -1
    """
    got = {}
    for pw in PACKAGES:
        backend = _storage(pw, "memory", tmp_path, _isolated)
        runs = []
        for md in (first, second):
            stream = _timed_session(pw, md, backend, "operator_persisting")
            plane = audits[pw].current()
            runs.append((stream, plane.history_complete, list(plane.violations)))
        got[pw] = runs
    assert got[pathway_tpu_torch] == got[pathway_tpu]
    (_s1, complete1, v1), (s2, complete2, v2) = got[pathway_tpu_torch]
    assert complete1 and not complete2 and v1 == v2 == []
    assert [(row, d) for _k, row, _t, d in s2] == [(("a", 1), -1)]
