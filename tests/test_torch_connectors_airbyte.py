"""The port's Airbyte connector (``pathway_tpu_torch/io/airbyte.py``)
against the JAX package's, mirroring ``tests/test_airbyte.py`` case by case:
a real subprocess connector speaking the Airbyte protocol (discover, then
read over temp-file arguments), a YAML connection, incremental state handed
back across polls, per-stream state merged across streams, duplicate
payloads kept as distinct rows, full-refresh deletions retracted, an
injected runner, and the gates and argument errors.

Static runs compare the final rows by key; live runs compare the final
state by key and what the runner was handed. Keys are stable hashes of
(stream, content, occurrence), so they compare across the packages.
"""

from __future__ import annotations

import textwrap
import time

import pytest

from torch_connector_helpers import both, collect, run_live, same

#: a minimal Airbyte source connector speaking the protocol on stdout
_CONNECTOR = textwrap.dedent(
    """
    import argparse, json, os, sys

    CATALOG = {"streams": [
        {"name": "users", "json_schema": {}, "supported_sync_modes": ["full_refresh", "incremental"]},
        {"name": "orders", "json_schema": {}, "supported_sync_modes": ["full_refresh"]},
    ]}

    def out(msg):
        sys.stdout.write(json.dumps(msg) + "\\n")

    p = argparse.ArgumentParser()
    p.add_argument("command")
    p.add_argument("--config")
    p.add_argument("--catalog")
    p.add_argument("--state")
    a = p.parse_args()

    if a.command == "discover":
        out({"type": "CATALOG", "catalog": CATALOG})
        sys.exit(0)

    assert a.command == "read"
    cfg = json.load(open(a.config))
    state = json.load(open(a.state)) if a.state else {"cursor": 0}
    cursor = int(state.get("cursor", 0))
    print("log noise that is not protocol json")  # connectors do this
    n = int(cfg.get("n_users", 3))
    for i in range(cursor, n):
        out({"type": "RECORD", "record": {"stream": "users", "data": {"id": i, "name": f"u{i}"}, "emitted_at": 0}})
    out({"type": "RECORD", "record": {"stream": "orders", "data": {"oid": 99}, "emitted_at": 0}})
    out({"type": "STATE", "state": {"cursor": n}})
    """
)


@pytest.fixture
def connector(tmp_path):
    path = tmp_path / "source.py"
    path.write_text(_CONNECTOR)
    return str(path)


def _static(pw, *args, **kwargs):
    t = pw.io.airbyte.read(*args, mode="static", **kwargs)
    got = collect(pw, t)
    pw.run(monitoring_level="none")
    return got


def test_airbyte_executable_static_read(connector):
    got = same(_static, {"source": {"executable": connector, "config": {"n_users": 3}}}, streams=["users"])
    names = sorted(d[1]["name"] for d in got.values())
    assert names == ["u0", "u1", "u2"]
    assert all("oid" not in d[1] for d in got.values())  # orders not selected


def test_airbyte_yaml_connection_and_both_streams(connector, tmp_path):
    conn = tmp_path / "conn.yaml"
    conn.write_text(f"source:\n  executable: {connector}\n  config:\n    n_users: 2\n")
    got = same(_static, str(conn), streams=["users", "orders"])
    assert sorted(str(d[1]) for d in got.values()) == sorted(
        str(p) for p in [{"id": 0, "name": "u0"}, {"id": 1, "name": "u1"}, {"oid": 99}])


def test_airbyte_streaming_incremental_state(connector):
    """STATE hands back to the connector: the second poll resumes from the
    cursor (no duplicate users) and the new users appear live."""

    def scenario(pw):
        cfg = {"source": {"executable": connector, "config": {"n_users": 2}}}
        t = pw.io.airbyte.read(cfg, streams=["users"], mode="streaming", _poll_interval=0.1)
        got = collect(pw, t)

        def grow():
            if len(got) >= 2:
                cfg["source"]["config"]["n_users"] = 4  # two new users appear upstream
            return len(got) >= 4

        run_live(pw, grow, deadline=60, settle=0.3)
        return got

    got = same(scenario)
    assert sorted(d[1]["name"] for d in got.values()) == ["u0", "u1", "u2", "u3"]


def _stream_state(name, cursor):
    return {"type": "STREAM", "stream": {"stream_descriptor": {"name": name}, "stream_state": {"cursor": cursor}}}


class _TwoStreams:
    def __init__(self):
        self.states_seen = []

    def discover(self, config):
        return [{"name": "users", "supported_sync_modes": ["incremental"]},
                {"name": "orders", "supported_sync_modes": ["incremental"]}]

    def read(self, config, catalog, state=None):
        self.states_seen.append(state)
        cursors = {"users": 0, "orders": 0}
        for m in state or []:
            cursors[m["stream"]["stream_descriptor"]["name"]] = m["stream"]["stream_state"]["cursor"]
        out = []
        for name in ("users", "orders"):
            for i in range(cursors[name], cursors[name] + 2):
                out.append({"type": "RECORD", "record": {"stream": name, "data": {"s": name, "i": i}}})
            out.append({"type": "STATE", "state": _stream_state(name, cursors[name] + 2)})
        return out


def test_airbyte_per_stream_state_merges_across_streams():
    """STREAM-typed STATE messages are kept per stream and the merged
    document hands back on the next read: neither stream re-syncs."""

    def scenario(pw):
        r = _TwoStreams()
        t = pw.io.airbyte.read({"source": {"config": {}, "executable": "x"}}, streams=["users", "orders"],
                               mode="streaming", runner=r, _poll_interval=0.05)
        got = collect(pw, t)
        run_live(pw, lambda: len(r.states_seen) >= 3, deadline=30)
        return r.states_seen[:3], got

    (ref_states, ref_got), (port_states, port_got) = both(scenario)
    assert port_states == ref_states
    assert port_states[0] is None
    by_stream = {m["stream"]["stream_descriptor"]["name"]: m for m in port_states[1]}
    assert by_stream["users"]["stream"]["stream_state"] == {"cursor": 2}
    assert by_stream["orders"]["stream"]["stream_state"] == {"cursor": 2}
    assert {m["stream"]["stream_state"]["cursor"] for m in port_states[2]} == {4}
    # rows by key: every (stream, i) once; a run may stop one poll later
    # than the other, so the port's rows are compared on the reference's keys
    shared = set(ref_got) & set(port_got)
    assert len(shared) >= 8 and all(ref_got[k] == port_got[k] for k in shared)
    vals = sorted((d[1]["s"], d[1]["i"]) for d in port_got.values())
    assert len(vals) == len(set(vals))


class _Rows:
    def __init__(self, rows, stream="s"):
        self.rows, self.stream, self.reads = rows, stream, 0

    def discover(self, config):
        return [{"name": self.stream, "supported_sync_modes": ["full_refresh"]}]

    def read(self, config, catalog, state=None):
        self.reads += 1
        return [{"type": "RECORD", "record": {"stream": s, "data": dict(d)}} for s, d in self.rows]


def test_airbyte_duplicate_payloads_are_distinct_rows():
    got = same(_static, {"source": {"config": {}, "executable": "x"}}, streams=["s"],
               runner=_Rows([("s", {"x": 1}), ("s", {"x": 1}), ("s", {"x": 2})]))
    assert sorted(str(d[1]) for d in got.values()) == sorted(["{'x': 1}", "{'x': 1}", "{'x': 2}"])


def test_airbyte_full_refresh_retracts_deleted_rows():
    def scenario(pw):
        r = _Rows([("s", {"x": 1}), ("s", {"x": 2})])
        t = pw.io.airbyte.read({"source": {"config": {}, "executable": "x"}}, streams=["s"],
                               mode="streaming", runner=r, _poll_interval=0.05)
        got = collect(pw, t)
        seen_both = []

        def cond():
            if len(got) == 2 and not seen_both:
                seen_both.append(True)
                r.rows = [("s", {"x": 1})]  # upstream deletes {"x": 2}
            return bool(seen_both) and len(got) == 1

        run_live(pw, cond, deadline=30, settle=0.1)
        return got

    got = same(scenario)
    assert [d[1] for d in got.values()] == [{"x": 1}]


def test_airbyte_config_file_not_found():
    def scenario(pw):
        with pytest.raises(FileNotFoundError, match="conections.yaml") as e:
            pw.io.airbyte.read("conections.yaml", streams=["s"])
        return str(e.value)

    same(scenario)


def test_airbyte_unknown_option_rejected():
    def scenario(pw):
        with pytest.raises(TypeError, match="refresh_interval") as e:
            pw.io.airbyte.read({"source": {"config": {}, "executable": "x"}}, streams=["s"], refresh_interval=5000)
        return str(e.value)

    same(scenario)


def test_airbyte_injected_runner():
    def scenario(pw):
        r = _Rows([("s", {"x": 1}), ("ignored", {"x": 2})])
        return _static(pw, {"source": {"config": {}, "executable": "unused"}}, streams=["s"], runner=r), r.reads

    got, reads = same(scenario)
    assert [d[1] for d in got.values()] == [{"x": 1}] and reads == 1


def test_airbyte_gates():
    def scenario(pw):
        errors = []
        with pytest.raises(NotImplementedError, match="docker") as e:
            pw.io.airbyte.read({"source": {"docker_image": "airbyte/source-github", "config": {}}}, streams=["commits"])
        errors.append(str(e.value))
        with pytest.raises(NotImplementedError, match="remote") as e:
            pw.io.airbyte.read({"source": {"executable": "x", "config": {}}}, streams=["s"], execution_type="remote")
        errors.append(str(e.value))
        # stream validation happens on the connector thread: it surfaces
        # through the run loop's error channel
        with pytest.raises(RuntimeError, match="not found") as e:
            runner = type("R", (), {"discover": lambda self, c: [{"name": "s"}],
                                    "read": lambda self, c, cat, state=None: []})()
            t = pw.io.airbyte.read({"source": {"config": {}, "executable": "x"}}, streams=["nope"],
                                   mode="static", runner=runner)
            pw.io.subscribe(t, on_change=lambda **kw: None)
            pw.run(monitoring_level="none")
        errors.append(type(e.value).__name__)
        return errors

    same(scenario)
