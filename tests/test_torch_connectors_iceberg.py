"""The port's Iceberg connector and Avro codec (``pathway_tpu_torch/io``:
``iceberg``, ``_avro``) against the JAX package's, mirroring
``tests/test_iceberg.py`` case by case: the Avro container round trip (and
each package reading the other's container), write then read with the
metadata, manifest list and manifests on disk, live appends from a second
writer process, two-writer contention (a lagging version hint and three
racing processes), retractions netted on read, a typed round trip, the
gated REST catalog and snapshots accumulated over runs.

Both packages write the same warehouse path in turn (emptied between), so
path-salted row keys compare; static reads compare update streams exactly,
keys included; each table is also read by the other package.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest

from torch_connector_helpers import capture, collect, run_live, same

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fresh(path) -> str:
    shutil.rmtree(path, ignore_errors=True)
    return str(path)


def _write(pw, wh, ns, name, rows, schema=None, stream=False):
    t = pw.debug.table_from_rows(schema or pw.schema_from_types(w=str, n=int), rows, is_stream=stream)
    pw.io.iceberg.write(t, wh, ns, name)
    pw.run(monitoring_level="none")
    pw.G.clear()


def _read(pw, wh, ns, name, schema=None):
    return capture(pw, pw.io.iceberg.read(wh, ns, name, schema=schema or pw.schema_from_types(w=str, n=int),
                                          mode="static"))


def _rows(stream):
    net: dict = {}
    for _t, k, d, r in stream:
        net[(k, r)] = net.get((k, r), 0) + d
    return sorted(r for (_k, r), n in net.items() for _ in range(max(n, 0)))


AVRO_SCHEMA = {
    "type": "record", "name": "r",
    "fields": [
        {"name": "s", "type": "string"}, {"name": "n", "type": "long"}, {"name": "f", "type": "double"},
        {"name": "ok", "type": "boolean"}, {"name": "opt", "type": ["null", "long"]},
        {"name": "raw", "type": "bytes"},
        {"name": "nested", "type": {"type": "record", "name": "inner", "fields": [{"name": "x", "type": "int"}]}},
        {"name": "tags", "type": {"type": "array", "items": "string"}},
        {"name": "props", "type": {"type": "map", "values": "long"}},
    ],
}
AVRO_RECORDS = [
    {"s": "héllo\nworld", "n": -(2**40), "f": 3.5, "ok": True, "opt": None, "raw": b"\x00\xff",
     "nested": {"x": 7}, "tags": ["a", "b"], "props": {"k1": 1, "k2": -2}},
    {"s": "", "n": 0, "f": -0.25, "ok": False, "opt": 42, "raw": b"", "nested": {"x": -1}, "tags": [], "props": {}},
]


def test_avro_container_round_trip(tmp_path):
    from pathway_tpu.io import _avro as R
    from pathway_tpu_torch.io import _avro as T

    for writer, reader in ((R, T), (T, R), (T, T)):
        p = str(tmp_path / f"{writer.__name__}.avro")
        writer.write_container(p, AVRO_SCHEMA, AVRO_RECORDS)
        got_schema, got = reader.read_container(p)
        assert got == AVRO_RECORDS and got_schema == AVRO_SCHEMA


def test_iceberg_write_read_round_trip(tmp_path):
    def scenario(pw):
        wh = _fresh(tmp_path / "warehouse")
        _write(pw, wh, ["app"], "users", [("a", 1), ("b", 2), ("c", 3)])
        troot = os.path.join(wh, "app", "users")
        mdir = os.path.join(troot, "metadata")
        version = int(open(os.path.join(mdir, "version-hint.text")).read())
        meta = json.load(open(os.path.join(mdir, f"v{version}.metadata.json")))
        snap = next(s for s in meta["snapshots"] if s["snapshot-id"] == meta["current-snapshot-id"])
        avro = sys.modules[f"{pw.__name__}.io._avro"]
        _s, manifests = avro.read_container(os.path.join(troot, snap["manifest-list"]))
        _s, entries = avro.read_container(os.path.join(troot, manifests[0]["manifest_path"]))
        layout = (meta["format-version"], version, len(manifests), manifests[0]["manifest_path"].split("/")[0],
                  entries[0]["data_file"]["file_format"], entries[0]["data_file"]["record_count"])
        return layout, _read(pw, wh, ["app"], "users")

    layout, stream = same(scenario)
    assert layout[0] == 2 and layout[3:] == ("metadata", "PARQUET", 3)
    assert _rows(stream) == [("a", 1), ("b", 2), ("c", 3)]


def test_iceberg_tables_cross_read(tmp_path):
    """Each package reads the other's table with the stream it reads from
    its own."""
    import pathway_tpu
    import pathway_tpu_torch

    for pw in (pathway_tpu, pathway_tpu_torch):
        pw.G.clear()
        _write(pw, str(tmp_path / pw.__name__), ["ns"], "t", [("x", 7), ("y", 8)])
    for name in ("pathway_tpu", "pathway_tpu_torch"):
        stream = same(_read, str(tmp_path / name), ["ns"], "t")
        assert _rows(stream) == [("x", 7), ("y", 8)]


def _writer_script(pkg):
    return textwrap.dedent(f"""
        import sys
        import {pkg} as pw
        t = pw.debug.table_from_rows(pw.schema_from_types(w=str, n=int), [(sys.argv[1], int(sys.argv[2]))])
        pw.io.iceberg.write(t, sys.argv[3], ["ns"], "t")
        pw.run(monitoring_level="none")
    """)


def _env():
    return dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")


def test_iceberg_streaming_appends(tmp_path):
    def scenario(pw):
        wh = _fresh(tmp_path / "warehouse")
        _write(pw, wh, ["ns"], "t", [("a", 1)])
        state = collect(pw, pw.io.iceberg.read(wh, ["ns"], "t", schema=pw.schema_from_types(w=str, n=int)),
                        column="")

        def appender():
            time.sleep(0.3)
            subprocess.run([sys.executable, "-c", _writer_script(pw.__name__), "b", "2", wh],
                           env=_env(), check=True, capture_output=True)

        threading.Thread(target=appender, daemon=True).start()
        run_live(pw, lambda: len(state) == 2, deadline=90, settle=0.2)
        return state

    state = same(scenario)
    assert sorted((r["w"], r["n"]) for r in state.values()) == [("a", 1), ("b", 2)]


def test_iceberg_two_writer_contention_keeps_both_commits(tmp_path):
    """A writer died between creating version N and swinging the hint: the
    next commit builds on the disk's version and keeps both writers' rows."""

    def scenario(pw):
        wh = _fresh(tmp_path / "warehouse")
        _write(pw, wh, ["ns"], "t", [("a", 1)])
        hint = os.path.join(wh, "ns", "t", "metadata", "version-hint.text")
        v = int(open(hint).read().strip())
        with open(hint, "w") as fh:
            fh.write(str(v - 1))
        _write(pw, wh, ["ns"], "t", [("b", 2)])
        return _read(pw, wh, ["ns"], "t")

    assert _rows(same(scenario)) == [("a", 1), ("b", 2)]


def test_iceberg_concurrent_writers_no_lost_rows(tmp_path):
    """Three processes of a package race the version file; every committed
    row survives into the final snapshot."""

    def scenario(pw):
        wh = _fresh(tmp_path / "warehouse")
        procs = [subprocess.Popen([sys.executable, "-c", _writer_script(pw.__name__), f"w{i}", str(i), wh],
                                  env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE) for i in range(3)]
        for p in procs:
            _out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err.decode()
        return _rows(_read(pw, wh, ["ns"], "t"))

    assert same(scenario) == [("w0", 0), ("w1", 1), ("w2", 2)]


def test_iceberg_retractions_net_out(tmp_path):
    def scenario(pw):
        wh = _fresh(tmp_path / "warehouse")

        class PkS(pw.Schema):
            w: str = pw.column_definition(primary_key=True)
            n: int

        _write(pw, wh, ["ns"], "t", [("a", 1, 0, 1), ("b", 2, 0, 1), ("a", 1, 1, -1), ("a", 5, 1, 1)], PkS, True)
        static = _read(pw, wh, ["ns"], "t", PkS)
        pw.G.clear()
        r2 = pw.io.iceberg.read(wh, ["ns"], "t", schema=pw.schema_from_types(w=str, n=int), _bounded=True)
        cap = {}
        pw.io.subscribe(r2, on_change=lambda key, row, time, is_addition: cap.__setitem__(
            (row["w"], row["n"]), is_addition))
        pw.run(monitoring_level="none")
        return static, cap

    static, cap = same(scenario)
    assert _rows(static) == [("a", 5), ("b", 2)]
    assert sorted(k for k, add in cap.items() if add and k != ("a", 1)) == [("a", 5), ("b", 2)]


def test_iceberg_typed_round_trip(tmp_path):
    def scenario(pw):
        wh = _fresh(tmp_path / "warehouse")
        schema = pw.schema_from_types(w=str, ts=pw.DateTimeNaive, f=float, ok=bool)
        ts = np.datetime64("2024-03-04T05:06:07", "ns")
        _write(pw, wh, ["ns"], "typed", [("a", ts, 2.5, True)], schema)
        ((_t, _k, _d, row),) = _read(pw, wh, ["ns"], "typed", schema)
        return row

    row = same(scenario)
    assert row == ("a", ("dt", "2024-03-04T05:06:07.000000000"), 2.5, True)


def test_iceberg_rest_catalog_is_gated():
    def scenario(pw):
        with pytest.raises(NotImplementedError, match="REST catalog") as e:
            pw.io.iceberg.read("http://localhost:8181", ["ns"], "t", schema=pw.schema_from_types(w=str))
        return str(e.value)

    same(scenario)


def test_iceberg_multi_snapshot_accumulates(tmp_path):
    def scenario(pw):
        wh = _fresh(tmp_path / "warehouse")
        for batch in ([("a", 1)], [("b", 2)], [("c", 3)]):
            _write(pw, wh, ["ns"], "acc", batch)
        return _read(pw, wh, ["ns"], "acc")

    assert _rows(same(scenario)) == [("a", 1), ("b", 2), ("c", 3)]
