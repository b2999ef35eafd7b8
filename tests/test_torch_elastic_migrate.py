"""O(moved-state) live migration on the port: a mirror of the reference's
``tests/test_elastic_migrate.py`` with ``pathway_tpu_torch`` in place of
``pathway_tpu``, holding the port to the same expectations on the same
inputs. A cluster rescale (2 processes -> 3 -> 2 over one filesystem store,
``PATHWAY_SHARDMAP=on``) restores operator state by moving only the
re-mapped key ranges' shards: manifest input offsets are kept (replay is
O(suffix)), scale-in adopts no orphan input rows, the aggregates are the
exact union of every session's rows and input-log trim stays enabled. Unit
cases: the suffix adoption, the log-suffix reader and the node
migratability classifier. Cluster ports come from
``torch_cluster_helpers.first_port``.
"""

from __future__ import annotations

import json
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np

import pathway_tpu_torch as pw
from pathway_tpu_torch.elastic import adopt_orphan_suffixes
from pathway_tpu_torch.elastic.reshard import _read_log_suffix
from pathway_tpu_torch.internals import telemetry
from pathway_tpu_torch.persistence.backends import FileBackend, MemoryBackend

REPO = str(Path(__file__).resolve().parent.parent)


# ------------------------------------------------------------ cluster harness


def _free_port_base(n: int) -> int:
    """A base in this xdist worker's port range with ``n + 1`` free ports."""
    from torch_cluster_helpers import first_port

    return first_port(1, span=n + 1)


_MIGRATE_SCRIPT = textwrap.dedent(
    """
    import json
    import os

    import pathway_tpu_torch as pw

    rows = json.loads(os.environ["SESSION_ROWS"])  # [[id, word, count], ...]
    expected_total = int(os.environ["EXPECTED_TOTAL"])


    class WordSchema(pw.Schema):
        id: int = pw.column_definition(primary_key=True)
        word: str
        count: int


    def make_subject(w, n):
        mine = [r for i, r in enumerate(rows) if i % n == w]

        class S(pw.io.python.ConnectorSubject):
            # seekable with a no-op seek: each session's rows are disjoint,
            # so there is never a replayed live prefix to drop — and the
            # content-derived primary keys keep cross-session rows distinct
            def offset_state(self):
                return {"done": True}

            def seek(self, state):
                pass

            def run(self):
                for rid, word, cnt in mine:
                    self.next(id=rid, word=word, count=cnt)

        return S()


    t = pw.io.python.read_partitioned(
        make_subject, schema=WordSchema, name="src"
    )
    agg = t.groupby(pw.this.word).reduce(
        pw.this.word, total=pw.reducers.sum(pw.this.count)
    )
    got = {}

    def on_agg(key, row, time, is_addition):
        if is_addition:
            got[row["word"]] = row["total"]

    pw.io.subscribe(agg, on_change=on_agg)

    total = t.reduce(c=pw.reducers.count())

    def on_total(key, row, time, is_addition):
        if is_addition and row["c"] >= expected_total:
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
        ),
    )

    from pathway_tpu_torch.internals import telemetry

    def attrs(name):
        return [e["attrs"] for e in telemetry.events(name)]

    print(
        "RESULT:"
        + json.dumps(
            {
                "got": got,
                "migrate": attrs("elastic.migrate_restore"),
                "reshard": attrs("elastic.reshard_restore"),
                "rebucket": attrs("elastic.reshard_input_logs"),
                "suffixes": attrs("elastic.migrate_input_suffixes"),
                "unsupported": attrs("elastic.migrate_unsupported"),
                "replay": attrs("resilience.replay"),
            }
        ),
        flush=True,
    )
    """
)


def _run_session(script, n_proc, store, rows, expected_total, timeout=150):
    env = dict(
        os.environ,
        PATHWAY_PROCESSES=str(n_proc),
        PATHWAY_THREADS="1",
        PATHWAY_BARRIER_TIMEOUT="60",
        PATHWAY_FIRST_PORT=str(_free_port_base(2 * n_proc + 2)),
        PATHWAY_ELASTIC="manual",
        PATHWAY_SHARDMAP="on",
        PATHWAY_PERSISTENT_STORAGE=str(store),
        SESSION_ROWS=json.dumps(rows),
        EXPECTED_TOTAL=str(expected_total),
        JAX_PLATFORMS="cpu",
        PYTHONPATH=REPO,
    )
    procs = [
        subprocess.Popen(
            [sys.executable, str(script)],
            env=dict(env, PATHWAY_PROCESS_ID=str(pid)),
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for pid in range(n_proc)
    ]
    outputs = []
    for p in procs:
        try:
            stdout, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            texts = []
            for q in procs:
                q.kill()
                out, _ = q.communicate()
                texts.append(out or "")
            raise AssertionError(
                "migrate cluster hung; output:\n" + "\n---\n".join(texts)
            )
        outputs.append(stdout)
    for p, txt in zip(procs, outputs):
        assert p.returncode == 0, f"process exited {p.returncode}:\n{txt}"
    result = None
    for line in outputs[0].splitlines():
        if line.startswith("RESULT:"):
            result = json.loads(line[len("RESULT:") :])
    assert result is not None, outputs[0]
    return result


def _input_log_metas(store) -> dict[str, dict]:
    b = FileBackend(str(store))
    out = {}
    for k in b.list_keys("inputs/"):
        if k.endswith("/metadata"):
            out[k[len("inputs/") : -len("/metadata")]] = pickle.loads(b.get(k))
    return out


def test_cluster_rescale_migrates_moved_state_only(tmp_path):
    """Acceptance: 2 -> 3 -> 2 process cluster sessions over one
    store migrate operator shards instead of wiping and replaying, with
    byte-exact aggregates, zero replayed history, and bounded input logs."""
    script = tmp_path / "migrate_pipeline.py"
    script.write_text(_MIGRATE_SCRIPT)
    store = tmp_path / "pstore"

    rows1 = [[0, "a", 1], [1, "b", 2], [2, "a", 3], [3, "c", 7]]
    # three rows so EVERY worker of the 3-process session ingests (and
    # therefore persists an input log — worker 2's becomes the orphan)
    rows2 = [[10, "b", 10], [11, "d", 5], [12, "e", 6]]
    rows3 = [
        [20, "a", 100],
        [21, "b", 100],
        [22, "c", 100],
        [23, "d", 100],
        [24, "e", 100],
    ]

    # --- session 1: fresh 2-process run --------------------------------------
    r1 = _run_session(script, 2, store, rows1, expected_total=len(rows1))
    assert r1["got"].items() >= {"a": 4, "b": 2, "c": 7}.items(), r1["got"]
    assert not r1["migrate"] and not r1["reshard"], r1

    # --- session 2: scale-OUT 2 -> 3 — migrate, don't replay -----------------
    r2 = _run_session(
        script, 3, store, rows2, expected_total=len(rows1) + len(rows2)
    )
    assert r2["migrate"], f"migration did not fire: {r2}"
    assert r2["migrate"][0]["old_workers"] == 2
    assert r2["migrate"][0]["new_workers"] == 3
    assert not r2["reshard"] and not r2["rebucket"], (
        f"fell back to wipe-and-replay: {r2}"
    )
    assert not r2["unsupported"], r2["unsupported"]
    # the O(moved-state) property: NOTHING replayed from the input logs —
    # the committed snapshot already covers the whole history
    assert sum(e["events"] for e in r2["replay"]) == 0, r2["replay"]
    # moved state answers queries: 'b' merges session-1 state with new rows
    assert r2["got"]["b"] == 12 and r2["got"]["d"] == 5, r2["got"]
    assert r2["got"]["e"] == 6, r2["got"]

    # --- session 3: scale-IN 3 -> 2 — orphan logs adopted by suffix ----------
    r3 = _run_session(
        script,
        2,
        store,
        rows3,
        expected_total=len(rows1) + len(rows2) + len(rows3),
    )
    assert r3["migrate"], f"migration did not fire: {r3}"
    assert r3["migrate"][0]["old_workers"] == 3
    assert r3["migrate"][0]["new_workers"] == 2
    assert not r3["reshard"] and not r3["rebucket"], r3
    assert sum(e["events"] for e in r3["replay"]) == 0, r3["replay"]
    # scale-in adopted the orphan worker's logs but moved ZERO input rows:
    # the snapshot offsets covered every logged event (O(suffix), suffix = 0)
    assert r3["suffixes"] and r3["suffixes"][0]["rows_moved"] == 0, r3[
        "suffixes"
    ]
    # zero loss, zero duplication: the probe touches every group, so the
    # emitted totals are the exact union of all three sessions' rows
    assert r3["got"] == {
        "a": 104,
        "b": 112,
        "c": 107,
        "d": 105,
        "e": 106,
    }, r3["got"]

    # --- input logs stay bounded across TWO rescales (trim re-enabled) -------
    metas = _input_log_metas(store)
    assert metas, "no input logs found in the store"
    retained = {
        pid: m.get("offset", 0) - m.get("trimmed_events", 0)
        for pid, m in metas.items()
    }
    assert sum(retained.values()) <= len(rows3), (
        f"input logs kept history across rescales: {retained}"
    )
    assert any(m.get("trimmed_events", 0) > 0 for m in metas.values()), (
        f"trim never ran under the elastic plane: {metas}"
    )


# ------------------------------------------------------- unit: orphan suffixes


def _write_input_log(backend, pid, events, *, chunks=None, trimmed=0):
    sizes = []
    chunks = chunks or [events]
    pos = 0
    for i, chunk in enumerate(chunks):
        backend.put(f"inputs/{pid}/chunk_{i:08d}", pickle.dumps(chunk))
        sizes.append(len(chunk))
        pos += len(chunk)
    backend.put(
        f"inputs/{pid}/metadata",
        pickle.dumps(
            {
                "offset": trimmed + pos,
                "chunks": len(chunks),
                "reader": None,
                "first_chunk": 0,
                "trimmed_events": trimmed,
                "chunk_sizes": sizes,
            }
        ),
    )


def test_adopt_orphan_suffixes_moves_only_past_offset_rows():
    MemoryBackend.clear("adopt-unit")
    b = MemoryBackend("adopt-unit")
    telemetry.clear_events()
    ev = lambda k, v: (k, (v,))  # noqa: E731 — (key, values) log entries
    _write_input_log(b, "src", [ev(1, "w0-a"), ev(2, "w0-b")])
    _write_input_log(b, "src@w1", [ev(3, "keep")])
    # orphan w2: 2 events covered by the manifest offset, 1 suffix event
    _write_input_log(b, "src@w2", [ev(4, "old1"), ev(5, "old2"), ev(6, "new")])
    stats = adopt_orphan_suffixes(b, 2, {"src@w2": 2})
    assert stats.rows_moved == 1 and stats.rows_total == 1
    assert stats.sources == ["src"]
    # orphan log deleted; survivors untouched
    assert not b.list_keys("inputs/src@w2/")
    assert pickle.loads(b.get("inputs/src@w1/metadata"))["offset"] == 1
    # suffix appended to worker 0's log as a fresh FOREIGN chunk
    meta = pickle.loads(b.get("inputs/src/metadata"))
    assert meta["offset"] == 3 and meta["chunks"] == 2
    assert meta["foreign_events"] == 1
    assert pickle.loads(b.get("inputs/src/chunk_00000001")) == [ev(6, "new")]
    assert telemetry.events("elastic.migrate_input_suffixes")


def test_adopt_orphan_suffixes_zero_suffix_still_retires_orphans():
    MemoryBackend.clear("adopt-zero")
    b = MemoryBackend("adopt-zero")
    _write_input_log(b, "src", [(1, ("x",))])
    _write_input_log(b, "src@w1", [(2, ("y",)), (3, ("z",))])
    stats = adopt_orphan_suffixes(b, 1, {"src@w1": 2})
    assert stats.rows_moved == 0
    assert not b.list_keys("inputs/src@w1/")
    meta = pickle.loads(b.get("inputs/src/metadata"))
    assert meta["offset"] == 1 and meta.get("foreign_events", 0) == 0


def test_read_log_suffix_tolerates_trim_but_refuses_inconsistency():
    MemoryBackend.clear("suffix-unit")
    b = MemoryBackend("suffix-unit")
    # 5 total events: 2 trimmed away, chunks hold events [2..5)
    _write_input_log(
        b, "src", None, chunks=[[(3, ("c",)), (4, ("d",))], [(5, ("e",))]], trimmed=2
    )
    meta, suffix = _read_log_suffix(b, "src", 4)  # skip 2 surviving events
    assert suffix == [(5, ("e",))]
    _, all_surviving = _read_log_suffix(b, "src", 2)
    assert len(all_surviving) == 3
    try:
        _read_log_suffix(b, "src", 1)  # trimmed PAST the requested offset
    except RuntimeError as e:
        assert "compacted past" in str(e)
    else:
        raise AssertionError("inconsistent store must raise")


# ------------------------------------------------- unit: migratability gates


def test_nodes_migratable_classification():
    from pathway_tpu_torch.engine.graph import Node
    from pathway_tpu_torch.engine.operators import GroupByNode, StreamInputNode
    from pathway_tpu_torch.persistence.snapshots import Persistence

    gb = GroupByNode.__new__(GroupByNode)
    gb.node_index = 0
    assert gb.migrate_mode() == "keyed" and gb.migrate_aligned

    si = StreamInputNode.__new__(StreamInputNode)
    si.fabric_ingest = False
    assert si.migrate_mode() == "solo"  # worker-0-fed copy moves positionally
    si.local_source = True
    assert si.migrate_mode() == "keyed" and not si.migrate_aligned

    class _Opaque(Node):
        def snapshot_state(self):
            return {"stores": {}}

    opaque = _Opaque.__new__(_Opaque)
    opaque.node_index = 1
    assert opaque.migrate_mode() is None  # falls back

    # a single unsupported stateful node blocks whole-graph migration
    assert Persistence._nodes_migratable([gb], {0}) is True
    assert Persistence._nodes_migratable([gb, opaque], {0, 1}) is False
    # ...but not when its shard is absent from the stored generation
    assert Persistence._nodes_migratable([gb, opaque], {0}) is True


def test_groupby_migrate_restore_merges_and_filters():
    from pathway_tpu_torch.engine.operators import GroupByNode

    node = GroupByNode.__new__(GroupByNode)
    keep_even = lambda ks: np.asarray(ks, dtype=np.uint64) % 2 == 0  # noqa: E731
    shard_a = {
        "state": {2: {"g": ("x",), "acc": [1], "n": 1, "emitted": None}},
        "cstate": None,
        "use_dict": True,
        "_seq": 4,
        "_archived": [],
    }
    shard_b = {
        "state": {
            4: {"g": ("y",), "acc": [2], "n": 1, "emitted": None},
            5: {"g": ("z",), "acc": [9], "n": 1, "emitted": None},  # odd: dropped
        },
        "cstate": None,
        "use_dict": True,
        "_seq": 9,
        "_archived": [],
    }
    merged = node.migrate_restore([shard_a, shard_b], keep_even)
    assert set(merged["state"]) == {2, 4}
    assert merged["_seq"] == 9 and merged["use_dict"] is True
    assert node.migrate_restore([{"state": {}, "cstate": None}], keep_even) is None
