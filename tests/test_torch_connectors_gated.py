"""The port's Logstash, Pub/Sub, PyFilesystem, NATS and Delta Lake
connectors against the JAX package's, mirroring
``tests/test_gated_connectors.py``'s cases of those connectors (fakes for
the clients live here, as there).

Static reads compare update streams exactly, keys included; writers compare
what reached the fake (or local) endpoint; live reads compare the final
state by key; Delta tables written by either package are read by both, and
their parquet rows (with ``time`` and ``diff``) compare equal.
"""

from __future__ import annotations

import http.server
import json
import os
import socketserver
import subprocess
import sys
import textwrap
import threading
import time

import pytest

from torch_connector_helpers import both, capture, collect, norm, run_live, same

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------- logstash (stdlib http)
def _logstash(pw):
    received = []

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_POST(self):
            n = int(self.headers["Content-Length"])
            received.append(json.loads(self.rfile.read(n)))
            self.send_response(200)
            self.end_headers()
            self.wfile.write(b"ok")

        def log_message(self, *a):
            pass

    srv = socketserver.TCPServer(("127.0.0.1", 0), Handler)
    port = srv.server_address[1]
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        t = pw.debug.table_from_rows(pw.schema_from_types(w=str, n=int), [("a", 1), ("b", 2)])
        pw.io.logstash.write(t, f"http://127.0.0.1:{port}/")
        pw.run(monitoring_level="none")
    finally:
        srv.shutdown()
        srv.server_close()
    return sorted(received, key=lambda r: r["w"])


def test_logstash_write_posts_flat_json():
    got = same(_logstash)
    assert [(r["w"], r["n"], r["diff"]) for r in got] == [("a", 1, 1), ("b", 2, 1)]
    assert all("time" in r for r in got)


# ------------------------------------------------------- pubsub (fake client)
class FakePublisher:
    def __init__(self):
        self.published = []

    def topic_path(self, project, topic):
        return f"projects/{project}/topics/{topic}"

    def publish(self, topic_path, data, **attrs):
        self.published.append((topic_path, data, attrs))

        class F:
            def result(self):
                return "msg-id"

        return F()


def _pubsub(pw):
    pub = FakePublisher()
    t = pw.debug.table_from_rows(pw.schema_from_types(data=bytes), [(b"x",), (b"y",)])
    pw.io.pubsub.write(t, pub, "proj", "topic")
    pw.run(monitoring_level="none")
    pw.G.clear()
    t2 = pw.debug.table_from_rows(pw.schema_from_types(a=int, b=int), [(1, 2)])
    with pytest.raises(ValueError, match="one") as err:
        pw.io.pubsub.write(t2, pub, "proj", "topic")
    return sorted(pub.published, key=lambda p: p[1]), str(err.value)


def test_pubsub_write():
    published, _err = same(_pubsub)
    assert [d for _p, d, _a in published] == [b"x", b"y"]
    assert all(p == "projects/proj/topics/topic" for p, _d, _a in published)
    assert all(a["pathway_diff"] == "1" and "pathway_time" in a for _p, _d, a in published)


# --------------------------------------------------- pyfilesystem (fake FS)
class FakeFS:
    """PyFilesystem-shaped in-memory FS (listdir/isdir/readbytes/getinfo)."""

    def __init__(self):
        self.files: dict[str, bytes] = {}
        self.mtimes: dict[str, int] = {}

    def put(self, path, data, mtime=1):
        self.files[path] = data
        self.mtimes[path] = mtime

    def listdir(self, path):
        path = path.rstrip("/") or "/"
        seen = set()
        for f in self.files:
            if f.startswith(path + "/" if path != "/" else "/"):
                rest = f[len(path):].lstrip("/")
                seen.add(rest.split("/")[0])
        return sorted(seen)

    def isdir(self, path):
        return path not in self.files and any(f.startswith(path.rstrip("/") + "/") for f in self.files)

    def readbytes(self, path):
        return self.files[path]

    def getinfo(self, path, namespaces=()):
        mtime = self.mtimes.get(path)

        class Info:
            raw = {"details": {"modified": mtime}}
            modified = mtime

        return Info()


def test_pyfilesystem_static_read():
    def scenario(pw):
        fs = FakeFS()
        fs.put("/docs/a.jsonl", b'{"v": 1}\n{"v": 2}\n')
        fs.put("/docs/sub/b.jsonl", b'{"v": 3}\n')
        t = pw.io.pyfilesystem.read(fs, "/docs", format="json", schema=pw.schema_from_types(v=int), mode="static")
        return capture(pw, t)

    stream = same(scenario)
    assert sorted(row for *_x, row in stream) == [(1,), (2,), (3,)]


def test_pyfilesystem_static_binary_with_metadata():
    def scenario(pw):
        fs = FakeFS()
        fs.put("/d/x.txt", b"one", mtime=5)
        fs.put("/d/y.txt", b"two", mtime=6)
        return capture(pw, pw.io.pyfilesystem.read(fs, "/d", mode="static", with_metadata=True))

    stream = same(scenario)
    assert sorted(row[0] for *_x, row in stream) == [b"one", b"two"]


def test_pyfilesystem_streaming_modify_retracts():
    def scenario(pw):
        fs = FakeFS()
        fs.put("/d/x.txt", b"one\n", mtime=1)
        t = pw.io.pyfilesystem.read(fs, "/d", format="plaintext", mode="streaming", refresh_interval=0.05)
        state = collect(pw, t)

        def later():
            time.sleep(0.3)
            fs.put("/d/x.txt", b"two\n", mtime=2)  # replaced, not added

        threading.Thread(target=later, daemon=True).start()
        run_live(pw, lambda: list(state.values()) == ["two"], settle=0.2)
        return state

    state = same(scenario)
    assert sorted(state.values()) == ["two"]  # the old version retracted


# ------------------------------------------------------- nats (fake client)
class FakeNats:
    """client_factory surface: connect -> conn with subscribe/publish/close."""

    def __init__(self):
        self.topics: dict[str, list[bytes]] = {}
        self.closed = 0

    def connect(self, uri):
        mod = self

        class Conn:
            def subscribe(self, topic):
                pos = 0
                while True:
                    msgs = mod.topics.get(topic, [])
                    if pos < len(msgs):
                        yield msgs[pos]
                        pos += 1
                    else:
                        yield None

            def publish(self, topic, payload):
                mod.topics.setdefault(topic, []).append(payload)

            def close(self):
                mod.closed += 1

        return Conn()


def test_nats_write_then_read_json():
    def scenario(pw):
        fake = FakeNats()
        t = pw.debug.table_from_rows(pw.schema_from_types(w=str, n=int), [("a", 1), ("b", 2)])
        pw.io.nats.write(t, "nats://fake:4222", "out", format="json", client_factory=fake)
        pw.run(monitoring_level="none")
        published = sorted((json.loads(m) for m in fake.topics["out"]), key=lambda m: m["w"])
        pw.G.clear()
        r = pw.io.nats.read("nats://fake:4222", "out", format="json",
                            schema=pw.schema_from_types(w=str, n=int), client_factory=fake)
        state = collect(pw, r, column="")
        run_live(pw, lambda: len(state) == 2, settle=0.1)
        deadline = time.time() + 2
        while fake.closed < 1 and time.time() < deadline:
            time.sleep(0.02)  # the subject thread closes asynchronously after stop
        return published, state, fake.closed >= 1

    published, state, closed = same(scenario)
    assert [(m["w"], m["n"], m["diff"]) for m in published] == [("a", 1, 1), ("b", 2, 1)]
    assert sorted((r["w"], r["n"]) for r in state.values()) == [("a", 1), ("b", 2)]
    assert closed


def test_nats_read_plaintext():
    def scenario(pw):
        fake = FakeNats()
        fake.topics["words"] = [b"hello", b"world"]
        r = pw.io.nats.read("nats://fake:4222", "words", format="plaintext", client_factory=fake)
        state = collect(pw, r)
        run_live(pw, lambda: len(state) == 2, settle=0.1)
        return state

    state = same(scenario)
    assert sorted(state.values()) == ["hello", "world"]


# ------------------------------------------------ deltalake (real protocol)
def _parquet_rows(uri):
    import pyarrow.parquet as pq

    rows = []
    for f in sorted(os.listdir(uri)):
        if f.endswith(".parquet"):
            rows.extend(tuple(norm(v) for v in r.values()) for r in pq.read_table(os.path.join(uri, f)).to_pylist())
    return sorted(rows, key=repr)


def _fresh(path) -> str:
    """``path`` emptied: both packages write the same path in turn, so the
    path-salted row keys of their reads compare."""
    import shutil

    shutil.rmtree(path, ignore_errors=True)
    return str(path)


def _delta_write(pw, uri, rows, schema=None, stream=False):
    t = pw.debug.table_from_rows(schema or pw.schema_from_types(w=str, n=int), rows, is_stream=stream)
    pw.io.deltalake.write(t, uri)
    pw.run(monitoring_level="none")


def test_deltalake_write_read_round_trip(tmp_path):
    """Each package writes a Delta table (JSON log + parquet); the log's
    first commit carries the protocol, the Spark schema and the adds; the
    parquet rows (with time and diff) are equal; and each package reads
    either table with the same update stream."""
    import pyarrow.parquet as pq

    uris = {}

    def write(pw):
        uri = uris[pw.__name__] = str(tmp_path / pw.__name__)
        _delta_write(pw, uri, [("a", 1), ("b", 2), ("c", 3)])
        log = sorted(os.listdir(os.path.join(uri, "_delta_log")))
        first = open(os.path.join(uri, "_delta_log", log[0])).read()
        part = next(f for f in os.listdir(uri) if f.endswith(".parquet"))
        return ('"protocol"' in first and '"schemaString"' in first and '"add"' in first,
                sorted(pq.read_table(os.path.join(uri, part)).column_names), _parquet_rows(uri))

    ok, columns, rows = same(write)
    assert ok and {"w", "n", "time", "diff"} <= set(columns)
    assert [r[:2] for r in rows] == [("a", 1), ("b", 2), ("c", 3)]
    for uri in uris.values():
        stream = same(lambda pw: capture(pw, pw.io.deltalake.read(
            uri, schema=pw.schema_from_types(w=str, n=int), mode="static")))
        assert sorted(r for *_x, r in stream) == [("a", 1), ("b", 2), ("c", 3)]


def test_deltalake_streaming_appends(tmp_path):
    """A live reader of each package sees a second writer run (a process of
    the same package) append to the table."""

    def scenario(pw):
        uri = _fresh(tmp_path / "t")
        _delta_write(pw, uri, [("a", 1)])
        pw.G.clear()
        r = pw.io.deltalake.read(uri, schema=pw.schema_from_types(w=str, n=int))
        state = collect(pw, r, column="")

        def appender():
            time.sleep(0.3)
            script = textwrap.dedent(f"""
                import {pw.__name__} as pw
                t = pw.debug.table_from_rows(pw.schema_from_types(w=str, n=int), [("b", 2)])
                pw.io.deltalake.write(t, {uri!r})
                pw.run(monitoring_level="none")
            """)
            subprocess.run([sys.executable, "-c", script], check=True, capture_output=True,
                           env=dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO))

        threading.Thread(target=appender, daemon=True).start()
        run_live(pw, lambda: len(state) == 2, deadline=90, settle=0.2)
        return state

    state = same(scenario)
    assert sorted((r["w"], r["n"]) for r in state.values()) == [("a", 1), ("b", 2)]


def test_deltalake_retractions_net_out(tmp_path):
    """Updates written as retract + insert net on read: static reads
    subtract the -1 rows, streaming reads key retractions by content."""

    def scenario(pw):
        uri = _fresh(tmp_path / "t")

        class PkS(pw.Schema):
            w: str = pw.column_definition(primary_key=True)
            n: int

        _delta_write(pw, uri, [("a", 1, 0, 1), ("b", 2, 0, 1), ("a", 1, 1, -1), ("a", 5, 1, 1)], PkS, True)
        rows = _parquet_rows(uri)
        pw.G.clear()
        static = capture(pw, pw.io.deltalake.read(uri, schema=pw.schema_from_types(w=str, n=int), mode="static"))
        pw.G.clear()
        state = collect(pw, pw.io.deltalake.read(uri, schema=pw.schema_from_types(w=str, n=int)), column="")
        run_live(pw, lambda: sorted((r["w"], r["n"]) for r in state.values()) == [("a", 5), ("b", 2)], settle=0.3)
        return rows, static, state

    rows, static, state = same(scenario)
    assert [r[-1] for r in rows].count(-1) == 1
    net = {}
    for _t, k, d, r in static:
        net[(k, r)] = net.get((k, r), 0) + d
    assert sorted(r for (_k, r), n in net.items() if n > 0) == [("a", 5), ("b", 2)]
    assert sorted((r["w"], r["n"]) for r in state.values()) == [("a", 5), ("b", 2)]


def test_deltalake_tables_cross_read(tmp_path):
    """The port reads the reference's Delta table, and the reference the
    port's, with the stream it reads from its own."""
    ref_uri, port_uri = str(tmp_path / "ref"), str(tmp_path / "port")
    import pathway_tpu
    import pathway_tpu_torch

    for pw, uri in ((pathway_tpu, ref_uri), (pathway_tpu_torch, port_uri)):
        pw.G.clear()
        _delta_write(pw, uri, [("x", 7), ("y", 8)])
        pw.G.clear()

    def read(pw, uri):
        return capture(pw, pw.io.deltalake.read(uri, schema=pw.schema_from_types(w=str, n=int), mode="static"))

    on_ref, on_port = (same(read, uri) for uri in (ref_uri, port_uri))
    assert sorted(r for *_x, r in on_ref) == sorted(r for *_x, r in on_port) == [("x", 7), ("y", 8)]
