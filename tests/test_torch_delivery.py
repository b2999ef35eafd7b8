"""The exactly-once delivery plane in the port against the reference
(``tests/test_delivery.py``): the ledger's discipline, the writer and plane
lifecycle, the knobs, the fs transport's sidecar idempotence, the fs sink
end to end over operator persistence, the crash windows, and the
observability surfaces.

Each case runs the same calls or the same seeded pipeline through both
packages, each writing to its own memory root or ``tmp_path`` directory, and
compares what they return, stage, publish and write: file bytes included.
The Kafka and Postgres transports are a later slice of the port
(``tests/test_torch_later_slice.py``); the reference's guards that use a
Kafka sink are mirrored with the fs sink.
"""

from __future__ import annotations

import json
import os
import pickle
import time as _time
import types
import zlib

import pytest

import pathway_tpu
import pathway_tpu_torch
from pathway_tpu import delivery as ref_delivery
from pathway_tpu.persistence import backends as ref_backends
from pathway_tpu_torch import delivery as port_delivery
from pathway_tpu_torch.persistence import backends as port_backends

PACKAGES = (pathway_tpu, pathway_tpu_torch)
DELIVERY = {pathway_tpu: ref_delivery, pathway_tpu_torch: port_delivery}
BACKENDS = {pathway_tpu: ref_backends, pathway_tpu_torch: port_backends}


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    monkeypatch.setenv("PATHWAY_PERSISTENT_STORAGE", "unset")
    monkeypatch.delenv("PATHWAY_PERSISTENT_STORAGE")
    monkeypatch.delenv("PATHWAY_DELIVERY", raising=False)
    roots: list[str] = []
    yield roots
    for mod in BACKENDS.values():
        for r in roots:
            mod.MemoryBackend.clear(r)
    for pw in PACKAGES:
        pw.G.clear()


def _mem(pw, roots, root):
    roots.append(root)
    BACKENDS[pw].MemoryBackend.clear(root)
    return BACKENDS[pw].MemoryBackend(root)


class _RecordingTransport:
    def __init__(self):
        self.published: list[tuple[int, dict]] = []
        self.fail = False

    def publish(self, sink_id, epoch, parts):
        if self.fail:
            raise IOError("sink down")
        self.published.append((epoch, parts))


def _both(fn):
    """``fn(pw)`` on each package; asserts equal results, returns the port's."""
    got = {pw: fn(pw) for pw in PACKAGES}
    assert got[pathway_tpu_torch] == got[pathway_tpu]
    return got[pathway_tpu_torch]


# ---------------------------------------------------------------- ledger unit


def test_ledger_stage_load_roundtrip(_isolated):
    def run(pw):
        led = DELIVERY[pw].DeliveryLedger(_mem(pw, _isolated, "dlv1"), "sink")
        rows = led.stage(3, {0: ["a", "b", "c"], 1: ["d"]}, chunk_rows=2)
        idx = led.index(3)
        return rows, led.staged_epochs(), idx["rows"], idx["parts"], led.load(3), led.load(99), \
            led.backend.list_keys("delivery/")

    rows, epochs, n, parts, loaded, missing, keys = _both(run)
    assert (rows, epochs, n, parts) == (4, [3], 4, {0: 2, 1: 1})
    assert loaded == {0: ["a", "b", "c"], 1: ["d"]} and missing == {}
    assert keys[-1].endswith("epoch_0000000003/part_0001_0000")


def test_ledger_discard_publish_gc_and_durability(_isolated):
    def run(pw):
        b = _mem(pw, _isolated, "dlv2")
        led = DELIVERY[pw].DeliveryLedger(b, "sink")
        for e in (1, 2, 3):
            led.stage(e, {0: [f"r{e}"]}, chunk_rows=8)
        dropped = led.discard_above(1)
        left = led.staged_epochs()
        led.mark_published(1)
        return dropped, left, led.published_epoch, led.staged_epochs(), \
            DELIVERY[pw].DeliveryLedger(b, "sink").published_epoch, b.list_keys("")

    assert _both(run) == ((2, 2), [1], 1, [], 1, ["delivery/sink/meta"])


def test_ledger_oldest_unpublished(_isolated):
    for pw in PACKAGES:
        led = DELIVERY[pw].DeliveryLedger(_mem(pw, _isolated, "dlv3"), "sink")
        assert led.oldest_unpublished_unix() is None
        before = _time.time()
        led.stage(5, {0: ["x"]}, chunk_rows=8)
        assert led.oldest_unpublished_unix() >= before - 1
        led.mark_published(5)
        assert led.oldest_unpublished_unix() is None


def test_safe_sink_id_sanitized(_isolated):
    def run(pw):
        led = DELIVERY[pw].DeliveryLedger(_mem(pw, _isolated, "dlv4"), "fs./tmp/out file.csv")
        led.stage(0, {0: ["x"]}, chunk_rows=8)
        return led.sink_id, led.staged_epochs()

    sink_id, epochs = _both(run)
    assert "/" not in sink_id and " " not in sink_id and epochs == [0]


# ---------------------------------------------------------------- writer unit


def test_writer_stage_publish_counters(_isolated):
    def run(pw):
        t = _RecordingTransport()
        w = DELIVERY[pw].LedgerWriter("s", t, chunk_rows=8)
        out = [w.bind(_mem(pw, _isolated, "dlv5"))]
        w.append(0, "r1")
        w.append(1, "r2")
        out += [w.stage(0), w.depth(), w.publish_up_to(0), list(t.published), w.published_epoch,
                w.depth(), w.staged_rows_total, w.published_rows_total, w.published_epochs_total,
                w.stage(1), w.summary()]
        return out

    out = _both(run)
    assert out[:10] == [(0, 0), 2, 1, 2, [(0, {0: ["r1"], 1: ["r2"]})], 0, 0, 2, 2, 1]
    assert out[10] == 0


def test_writer_bind_discards_orphans_past_cut(_isolated):
    def run(pw):
        b = _mem(pw, _isolated, "dlv6")
        pre = DELIVERY[pw].DeliveryLedger(b, "s")
        pre.stage(5, {0: ["frozen"]}, chunk_rows=8)
        pre.stage(7, {0: ["orphan1", "orphan2"]}, chunk_rows=8)
        t = _RecordingTransport()
        w = DELIVERY[pw].LedgerWriter("s", t, chunk_rows=8)
        w.restore_sink({"staged_epoch": 5})
        return w.bind(b), list(t.published), w.discarded_rows_total, b.list_keys("")

    dropped, published, discarded, keys = _both(run)
    assert dropped == (1, 2) and published == [(5, {0: ["frozen"]})] and discarded == 2
    assert keys == ["delivery/s/meta"]


def test_writer_bind_refuses_published_past_cut(_isolated):
    for pw in PACKAGES:
        b = _mem(pw, _isolated, "dlv7")
        DELIVERY[pw].DeliveryLedger(b, "s").mark_published(3)
        w = DELIVERY[pw].LedgerWriter("s", _RecordingTransport(), chunk_rows=8)
        w.restore_sink({"staged_epoch": 1})
        with pytest.raises(RuntimeError, match="already published"):
            w.bind(b)


def test_writer_publish_failure_nonfatal_then_strict(_isolated):
    def run(pw):
        t = _RecordingTransport()
        t.fail = True
        w = DELIVERY[pw].LedgerWriter("s", t, chunk_rows=8)
        w.bind(_mem(pw, _isolated, "dlv8"))
        w.append(0, "r")
        w.stage(0)
        out = [w.publish_up_to(0), w.publish_failures, w.last_publish_error]
        with pytest.raises(RuntimeError, match="at close"):
            w.publish_up_to(0, strict=True)
        t.fail = False
        out += [w.publish_up_to(0), w.last_publish_error, w.publish_failures]
        return out

    assert _both(run) == [0, 1, "OSError: sink down", 1, None, 2]


def test_writer_depth_bound_backpressure(_isolated):
    for pw in PACKAGES:
        t = _RecordingTransport()
        t.fail = True
        w = DELIVERY[pw].LedgerWriter("s", t, chunk_rows=8)
        w.max_staged_epochs = 2
        w.bind(_mem(pw, _isolated, "dlv9"))
        for e in (0, 1):
            w.append(0, f"r{e}")
            w.stage(e)
            w.publish_up_to(e)
        w.append(0, "r2")
        with pytest.raises(RuntimeError, match="PATHWAY_DELIVERY_MAX_STAGED_EPOCHS"):
            w.stage(2)


def test_writer_sink_state_cut_roundtrip():
    for pw in PACKAGES:
        w = DELIVERY[pw].LedgerWriter("s", _RecordingTransport())
        w.staged_epoch = 11
        w2 = DELIVERY[pw].LedgerWriter("s", _RecordingTransport())
        w2.restore_sink(w.sink_state())
        assert w2._restored_cut == 11


# ------------------------------------------------------------ helpers, knobs


def test_stable_partition_deterministic():
    for pw in PACKAGES:
        sp = DELIVERY[pw].stable_partition
        assert sp("k1", 4) == zlib.crc32(b"k1") % 4
        assert sp(None, 4) == 0 and sp("anything", 1) == 0
    keys = [f"key-{i}" for i in range(64)]
    assert [port_delivery.stable_partition(k, 16) for k in keys] == [
        ref_delivery.stable_partition(k, 16) for k in keys
    ]


def test_resolve_mode(monkeypatch):
    for pw in PACKAGES:
        rm = DELIVERY[pw].resolve_mode
        assert rm("off") == "off" and rm("exactly_once") == "exactly_once"
        with pytest.raises(ValueError, match="delivery"):
            rm("at_most_once")
        monkeypatch.delenv("PATHWAY_DELIVERY", raising=False)
        assert rm(None) == "off"
        monkeypatch.setenv("PATHWAY_DELIVERY", "exactly_once")
        assert rm(None) == "exactly_once"
        monkeypatch.delenv("PATHWAY_DELIVERY")


def test_delivery_knobs(monkeypatch):
    from pathway_tpu.internals.config import get_pathway_config as ref_cfg
    from pathway_tpu_torch.internals.config import get_pathway_config as port_cfg

    for get in (ref_cfg, port_cfg):
        cfg = get()
        monkeypatch.delenv("PATHWAY_DELIVERY", raising=False)
        assert cfg.delivery == "off"
        monkeypatch.setenv("PATHWAY_DELIVERY", "bogus")
        with pytest.raises(ValueError, match="PATHWAY_DELIVERY"):
            cfg.delivery  # noqa: B018
        monkeypatch.setenv("PATHWAY_DELIVERY_STAGE_ROWS", "7")
        assert cfg.delivery_stage_rows == 7
        monkeypatch.setenv("PATHWAY_DELIVERY_MAX_STAGED_EPOCHS", "0")
        assert cfg.delivery_max_staged_epochs == 1
        monkeypatch.setenv("PATHWAY_ALERT_SINK_STALL_S", "33.5")
        assert cfg.alert_sink_stall_s == 33.5
        monkeypatch.delenv("PATHWAY_DELIVERY")
        d = cfg.to_dict()
        for k in ("delivery", "delivery_stage_rows", "delivery_max_staged_epochs", "alert_sink_stall_s"):
            assert k in d, k
        for k in ("PATHWAY_DELIVERY_STAGE_ROWS", "PATHWAY_DELIVERY_MAX_STAGED_EPOCHS", "PATHWAY_ALERT_SINK_STALL_S"):
            monkeypatch.delenv(k)


def test_writer_chunk_rows_from_the_knob(monkeypatch, _isolated):
    """``PATHWAY_DELIVERY_STAGE_ROWS`` splits a staged epoch into chunks the
    same way on both packages."""
    monkeypatch.setenv("PATHWAY_DELIVERY_STAGE_ROWS", "3")

    def run(pw):
        w = DELIVERY[pw].LedgerWriter("s", _RecordingTransport())
        b = _mem(pw, _isolated, "dlvknob")
        w.bind(b)
        for i in range(7):
            w.append(i % 2, f"r{i}")
        w.stage(0)
        return w.chunk_rows, b.list_keys("delivery/"), w.ledger.load(0)

    rows, keys, loaded = _both(run)
    assert rows == 3 and len([k for k in keys if "/part_" in k]) == 3
    assert loaded == {0: ["r0", "r2", "r4", "r6"], 1: ["r1", "r3", "r5"]}


# ---------------------------------------------------------------- fs transport


def test_fs_transport_sidecar_idempotence(tmp_path):
    def run(pw):
        path = str(tmp_path / f"{pw.__name__}.csv")
        tr = DELIVERY[pw].FsDeliveryTransport(path, header="a,b\n")
        tr.publish("fs", 0, {0: ["1,2\n"]})
        tr.publish("fs", 1, {0: ["3,4\n"]})
        first = open(path).read()
        tr.publish("fs", 1, {0: ["GARBAGE\n"]})  # already durable: skipped
        again = open(path).read()
        with open(path, "a") as fh:
            fh.write("torn-partial-line")
        tr.publish("fs", 2, {0: ["5,6\n"]})  # the torn tail is truncated first
        side = json.load(open(path + ".delivery"))
        return first, again, open(path).read(), side["epoch"], side["offset"] == os.path.getsize(path)

    assert _both(run) == ("a,b\n1,2\n3,4\n", "a,b\n1,2\n3,4\n", "a,b\n1,2\n3,4\n5,6\n", 2, True)


# ------------------------------------------------------------ fs end to end


def _ws(pw):
    return pw.schema_from_types(word=str, count=int)


def _fs_session(pw, rows, out, store, **kw):
    pw.G.clear()
    t = pw.debug.table_from_rows(_ws(pw), rows, is_stream=True)
    pw.io.fs.write(t, out, format="csv", delivery="exactly_once")
    pw.run(
        monitoring_level="none",
        persistence_config=pw.persistence.Config(
            backend=pw.persistence.Backend.filesystem(store),
            persistence_mode="operator_persisting",
            **kw,
        ),
    )
    pw.G.clear()


_ROWS = [("a", 1, 0, 1), ("b", 2, 1, 1), ("c", 3, 2, 1)]


def test_fs_exactly_once_end_to_end(tmp_path):
    """First run, replay-only restart (bytes unchanged), restart with a new
    row (the prefix survives, the suffix appends): the file's bytes are the
    reference's at each step."""

    def run(pw):
        out = str(tmp_path / f"{pw.__name__}.csv")
        store = str(tmp_path / pw.__name__ / "p")
        steps = []
        for rows in (_ROWS, _ROWS, _ROWS + [("d", 4, 3, 1)]):
            _fs_session(pw, rows, out, store)
            steps.append(open(out).read())
        side = json.load(open(out + ".delivery"))
        return steps, side["offset"] == os.path.getsize(out), side["epoch"]

    steps, offset_ok, _epoch = _both(run)
    assert offset_ok and steps[1] == steps[0] and steps[2].startswith(steps[0])
    assert [ln.split(",")[0] for ln in steps[2].splitlines()[1:]] == ["a", "b", "c", "d"]


@pytest.mark.parametrize("interval_ms", [0, 1])
def test_fs_exactly_once_restart_equals_uninterrupted(tmp_path, interval_ms):
    """A stream over several ticks, restarted once mid-way, writes the file
    an uninterrupted run writes (byte for byte), with or without periodic
    snapshots; the reference writes the same bytes."""
    rows = [(f"w{i}", i, 2 * i, 1) for i in range(12)] + [("w3", 3, 30, -1), ("w5", 5, 31, -1)]
    head = [r for r in rows if r[2] < 14]

    def run(pw):
        out = str(tmp_path / f"{pw.__name__}-{interval_ms}.csv")
        whole = str(tmp_path / f"{pw.__name__}-{interval_ms}-whole.csv")
        store = str(tmp_path / pw.__name__ / f"p{interval_ms}")
        _fs_session(pw, head, out, store, snapshot_interval_ms=interval_ms)
        _fs_session(pw, rows, out, store, snapshot_interval_ms=interval_ms)
        _fs_session(pw, rows, whole, str(tmp_path / pw.__name__ / f"w{interval_ms}"),
                    snapshot_interval_ms=interval_ms)
        return open(out).read(), open(whole).read()

    restarted, whole = _both(run)
    assert restarted == whole
    assert len(whole.splitlines()) == 1 + 14


@pytest.mark.parametrize("point", ["delivery_staged", "delivery_committed", "delivery_published"])
def test_crash_window_then_restart_writes_each_row_once(tmp_path, monkeypatch, point):
    """A crash at each of the ledger's three named windows (the run dies
    there), then a restart: the file holds every row once, as an
    uninterrupted run's file does (byte for byte where the crash came after
    the commit), and the reference writes the same bytes."""
    from pathway_tpu.resilience import faults as ref_faults
    from pathway_tpu_torch.resilience import faults as port_faults

    faults = {pathway_tpu: ref_faults, pathway_tpu_torch: port_faults}
    rows = [(f"w{i}", i, 2 * i, 1) for i in range(10)]

    class Crash(Exception):
        pass

    def run(pw):
        passes = {"n": 0}
        real = faults[pw].at_point

        def at_point(name, proc=None):
            if name == point:
                passes["n"] += 1
                if passes["n"] == 2:
                    raise Crash(name)
            return real(name, proc)

        out = str(tmp_path / f"{pw.__name__}-{point}.csv")
        store = str(tmp_path / pw.__name__ / f"p-{point}")
        monkeypatch.setattr(faults[pw], "at_point", at_point)
        with pytest.raises(Crash):
            _fs_session(pw, rows, out, store, snapshot_interval_ms=1)
        monkeypatch.setattr(faults[pw], "at_point", real)
        _fs_session(pw, rows, out, store, snapshot_interval_ms=1)
        whole = str(tmp_path / f"{pw.__name__}-{point}-whole.csv")
        _fs_session(pw, rows, whole, str(tmp_path / pw.__name__ / f"w-{point}"), snapshot_interval_ms=1)
        return open(out).read(), open(whole).read(), passes["n"] >= 2

    got, whole, crashed = _both(run)
    assert crashed

    def untimed(text):
        return [ln.rsplit(",", 2)[0] + "," + ln.rsplit(",", 1)[1] for ln in text.splitlines()]

    if point == "delivery_staged":
        # the orphan epoch was never published: replay regenerates its rows
        # in the restart's first tick, so they carry that tick's time
        assert untimed(got) == untimed(whole)
    else:  # frozen epochs re-publish their staged bytes
        assert got == whole
    words = [ln.split(",")[0] for ln in got.splitlines()[1:]]
    assert sorted(words) == sorted(r[0] for r in rows) and len(words) == len(set(words))


def test_fs_exactly_once_rejects_sharded(tmp_path):
    for pw in PACKAGES:
        pw.G.clear()
        t = pw.debug.table_from_rows(_ws(pw), [("a", 1)])
        with pytest.raises(ValueError, match="sharded"):
            pw.io.fs.write(t, str(tmp_path / "o.csv"), format="csv", sharded=True, delivery="exactly_once")


# -------------------------------------------------------------------- guards


def test_exactly_once_requires_persistence(tmp_path):
    for pw in PACKAGES:
        pw.G.clear()
        t = pw.debug.table_from_rows(_ws(pw), [("a", 1)])
        pw.io.fs.write(t, str(tmp_path / "o.csv"), format="csv", delivery="exactly_once")
        with pytest.raises(RuntimeError, match="persistence"):
            pw.run(monitoring_level="none")


def test_exactly_once_requires_operator_mode(tmp_path):
    for pw in PACKAGES:
        pw.G.clear()
        t = pw.debug.table_from_rows(_ws(pw), [("a", 1)])
        pw.io.fs.write(t, str(tmp_path / "o.csv"), format="csv", delivery="exactly_once")
        with pytest.raises(RuntimeError, match="operator_persisting"):
            pw.run(
                monitoring_level="none",
                persistence_config=pw.persistence.Config(
                    backend=pw.persistence.Backend.filesystem(str(tmp_path / pw.__name__ / "p"))
                ),
            )


def test_delivery_knob_turns_a_plain_writer_exactly_once(tmp_path, monkeypatch):
    """``PATHWAY_DELIVERY=exactly_once`` routes a writer without an explicit
    ``delivery=`` through the ledger: the sidecar appears."""
    monkeypatch.setenv("PATHWAY_DELIVERY", "exactly_once")

    def run(pw):
        out = str(tmp_path / f"{pw.__name__}-knob.csv")
        pw.G.clear()
        t = pw.debug.table_from_rows(_ws(pw), _ROWS, is_stream=True)
        pw.io.csv.write(t, out)
        pw.run(
            monitoring_level="none",
            persistence_config=pw.persistence.Config(
                backend=pw.persistence.Backend.filesystem(str(tmp_path / pw.__name__ / "knob")),
                persistence_mode="operator_persisting",
            ),
        )
        return open(out).read(), os.path.exists(out + ".delivery")

    content, sidecar = _both(run)
    assert sidecar and len(content.splitlines()) == 4


# ------------------------------------------------------------- observability


def _bound_plane(pw, roots, root="dlvobs", fail=False):
    b = _mem(pw, roots, root)
    t = _RecordingTransport()
    t.fail = fail
    w = DELIVERY[pw].LedgerWriter("obs.sink", t, chunk_rows=8)
    plane = DELIVERY[pw].DeliveryPlane([w], b, next_epoch=lambda: 0)
    plane.bind_all()
    w.append(0, "r1")
    plane.stage_tick()
    plane.publish_committed()
    return plane, w, b


def test_plane_summaries_and_prometheus(_isolated):
    def run(pw):
        plane, _w, _b = _bound_plane(pw, _isolated)
        rt = types.SimpleNamespace(persistence=types.SimpleNamespace(delivery=plane))
        bare = types.SimpleNamespace(persistence=None)
        mod = DELIVERY[pw]
        return (mod.run_summary(rt), mod.heartbeat_summary(rt), mod.prometheus_lines(rt),
                mod.run_summary(bare), mod.prometheus_lines(bare))

    summary, hb, lines, bare_summary, bare_lines = _both(run)
    assert summary["staged_rows"] == 1 and summary["published_rows"] == 1
    assert summary["sinks"]["obs.sink"]["published_epoch"] == 0
    assert hb == {"sinks": 1, "depth": 0, "staged": 1, "published": 1, "failures": 0,
                  "oldest_unpublished_unix": None}
    assert 'pathway_delivery_staged_rows_total{sink="obs.sink"} 1' in lines
    assert bare_summary is None and bare_lines == []


def test_sink_commit_stall_detector(_isolated):
    from pathway_tpu.internals.config import get_pathway_config as ref_cfg
    from pathway_tpu.observability import health as ref_health
    from pathway_tpu_torch.internals.config import get_pathway_config as port_cfg
    from pathway_tpu_torch.observability import health as port_health

    planes = {pathway_tpu: (ref_health, ref_cfg), pathway_tpu_torch: (port_health, port_cfg)}

    def run(pw):
        plane, w, b = _bound_plane(pw, _isolated, "dlvstall", fail=True)
        idx_key = w.ledger._index_key(0)
        idx = pickle.loads(b.get(idx_key))
        idx["staged_unix"] -= 10_000.0
        b.put(idx_key, pickle.dumps(idx))
        health, cfg = planes[pw]
        rt = types.SimpleNamespace(persistence=types.SimpleNamespace(delivery=plane))
        stall = [x for x in health.HealthPlane(cfg(), runtime=rt)._detectors() if x["alert"] == "sink_commit_stall"]
        return [(x["fingerprint"], x["summary"].split(" staged ")[0]) for x in stall]

    assert _both(run) == [("obs.sink", "sink obs.sink has unpublished output")]


def test_run_stats_include_delivery(_isolated):
    from pathway_tpu.internals.monitoring import run_stats as ref_stats
    from pathway_tpu_torch.internals.monitoring import run_stats as port_stats

    stats = {pathway_tpu: ref_stats, pathway_tpu_torch: port_stats}

    def run(pw):
        plane, _w, _b = _bound_plane(pw, _isolated, "dlvstats")
        rt = types.SimpleNamespace(persistence=types.SimpleNamespace(delivery=plane), scheduler=None)
        return stats[pw](rt)["delivery"]

    assert _both(run)["published_rows"] == 1
