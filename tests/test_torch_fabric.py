"""The port's serving fabric (``pathway_tpu_torch/fabric``) against the
reference's (``tests/test_fabric.py``, ``tests/test_fabric_shardmap.py`` and
the fabric cases of ``tests/test_timeline.py``).

Units run on both packages with the same inputs and compare what each
observes exactly: the replica store's changelog, lag and snapshot semantics,
the transport's RPC and cast contract (a port node and a reference node talk
to each other: the frames are the same pickles),
``serve_table`` on one process (status, body bytes and headers equal), and
the health plane's fabric link canaries.

The cluster cases run the port alone (the reference's promises are kept
within the port): a 2-process embed → KNN → rerank cluster with the fabric
on answers byte-identical from both doors and to a one-process run, with the
peer's forwarded request's trace stitched to the owner's under one trace
id and the coordinator's serving rollup exact; the same pipeline under the
shard map answers at each door as its owner with nothing forwarded; a
churning ``serve_table`` route answers at the peer door from its replica
within the staleness bound and settles byte-identical to the owner. The
reference's 3-door cases run here with 2 doors (the multi-process cases of
the port's files share a ~60 s budget); its SIGKILL-under-a-Supervisor case
(``slow``) is not mirrored.
"""

from __future__ import annotations

import json
import threading
import time

import pytest

import pathway_tpu
import pathway_tpu_torch
import torch_fabric_helpers as tf
from torch_cluster_helpers import first_port
from torch_http_helpers import free_port, release_port, wait_ready

PACKAGES = (pathway_tpu, pathway_tpu_torch)


def _mod(pw, name):
    import importlib

    return importlib.import_module(f"{pw.__name__}.{name}")


# ---------------------------------------------------------------------- units


def _replica_store_trace(pw) -> list:
    store = _mod(pw, "fabric.replica").ReplicaStore("/t", "name")
    seen = [store.lag_s()]
    store.apply([("a", {"name": "a", "v": 1}, 1), ("b", {"name": "b", "v": 2}, 1)], 1, 100.0)
    seen += [store.lookup("a"), len(store)]
    store.apply(
        [("a", {"name": "a", "v": 1}, -1), ("a", {"name": "a", "v": 9}, 1), ("b", {"name": "b", "v": 2}, -1)],
        2, 101.0,
    )
    seen += [store.lookup("a"), store.lookup("b"), store.seq]
    store.frontier(2, 105.0)
    seen += [store.synced_unix, store.lag_s(now_unix=106.5)]
    store.install_snapshot({"a": {"name": "a", "v": 9}, "c": {"name": "c", "v": 3}}, 3, 107.0)
    seen += [store.lookup("c"), store.seq]
    store.install_snapshot({"zz": {}}, 1, 90.0)  # an older snapshot never rolls back
    seen += [store.lookup("c"), store.seq]
    # the shard-map feed: per-source sequence, gap and slice install
    store.self_src = 0
    store.apply_from(1, [("p", {"name": "p"}, 1)], 1, 110.0)
    seen += [store.src_gap(1, 2), store.src_gap(1, 1), store.lag_from(1, 111.0), store.lag_from(0)]
    store.install_slice(1, {"q": {"name": "q"}}, 2, 112.0, lambda k: k in ("p", "q"))
    seen += [sorted(store.rows), store.src_seq]
    store.is_owner = True
    seen.append(store.lag_s())
    return seen


def test_replica_store_apply_lag_and_snapshot():
    ref, got = (_replica_store_trace(pw) for pw in PACKAGES)
    assert got == ref
    assert got[0] is None and got[-1] == 0.0 and got[3] == {"name": "a", "v": 9}


@pytest.mark.parametrize("server,client", [(1, 1), (0, 1), (1, 0)], ids=["port", "ref-server", "ref-client"])
def test_fabric_transport_rpc_and_cast(server, client):
    """The port's transport keeps the reference's RPC and cast contract, and
    speaks its frames: each side may be either package."""
    nodes = [_mod(pw, "fabric.transport") for pw in PACKAGES]
    base = first_port(2, span=8)
    n0 = nodes[server].FabricNode(0, 2, base)
    n1 = nodes[client].FabricNode(1, 2, base)
    got_casts: list = []
    try:
        n0.req_handlers["echo"] = lambda payload, reply: reply({"got": payload})

        def deferred(payload, reply):
            threading.Thread(target=lambda: reply(payload * 2), daemon=True).start()

        def boom(payload, reply):
            raise ValueError("kaboom")

        n0.req_handlers["deferred"] = deferred
        n0.req_handlers["boom"] = boom
        n1.cast_handlers["note"] = got_casts.append
        assert n1.call(0, "echo", {"x": 1}, timeout=10) == {"got": {"x": 1}}
        assert n1.call(0, "deferred", 21, timeout=10) == 42
        with pytest.raises(nodes[client].FabricUnavailable, match="kaboom"):
            n1.call(0, "boom", None, timeout=10)
        with pytest.raises(nodes[client].FabricUnavailable, match="no fabric handler"):
            n1.call(0, "nope", None, timeout=10)
        assert n0.cast(1, "note", {"seq": 1})
        deadline = time.monotonic() + 5
        while not got_casts and time.monotonic() < deadline:
            time.sleep(0.01)
        assert got_casts == [{"seq": 1}]
    finally:
        n0.close()
        n1.close()
    with pytest.raises(nodes[client].FabricUnavailable):
        n1.call(0, "echo", 1, timeout=0.5)


def test_fabric_port_bands_match_the_reference():
    ref, port = (_mod(pw, "fabric.transport") for pw in PACKAGES)
    for first, n, pid in ((20000, 2, 0), (20000, 2, 1), (31000, 4, 3)):
        assert port.fabric_port(first, n, pid) == ref.fabric_port(first, n, pid)


def _serve_table_once(pw) -> dict:
    pw.G.clear()
    port = free_port()
    prices = pw.debug.table_from_rows(pw.schema_from_types(name=str, price=int), [("apple", 3), ("pear", 5)])
    troute = pw.io.http.serve_table(prices, route="/v1/prices", key_column="name", host="127.0.0.1", port=port)
    out: dict = {}

    def client():
        try:
            wait_ready(port, pw)
            deadline = time.monotonic() + 10
            while len(troute.store) < 2 and time.monotonic() < deadline:
                time.sleep(0.02)  # the static table lands in the store
            for name, q in (("hit", "?name=pear"), ("miss", "?name=zzz"), ("noparam", "")):
                s, b, h = tf._request(f"http://127.0.0.1:{port}/v1/prices{q}")
                out[name] = (s, b, h.get("X-Pathway-Fabric"), h.get("X-Pathway-Replica-Lag-Ms"))
            out["schema"] = json.loads(tf._request(f"http://127.0.0.1:{port}/_schema")[1])
        finally:
            rt = pw.internals.run.current_runtime()
            while rt is None:
                time.sleep(0.01)
                rt = pw.internals.run.current_runtime()
            rt.request_stop()

    th = threading.Thread(target=client)
    th.start()
    pw.run(monitoring_level="none")
    th.join(timeout=60)
    out["store"] = (troute.store.is_owner, len(troute.store), troute.local_answers)
    pw.G.clear()
    return out


def test_serve_table_single_process_lookup_and_schema():
    ref, got = (_serve_table_once(pw) for pw in PACKAGES)
    for k in ("hit", "miss", "noparam", "store"):
        assert got[k] == ref[k], k
    status, body, fabric, lag = got["hit"]
    assert status == 200 and json.loads(body) == {"name": "pear", "price": 5}
    assert fabric == "owner" and float(lag) == 0.0
    assert got["miss"][0] == 404 and got["noparam"][0] == 400
    assert got["schema"]["paths"] == ref["schema"]["paths"]
    assert got["store"] == (True, 2, 3)


class _Node:
    def __init__(self, fail: bool):
        self.fail = fail
        self.calls: list = []

    def call(self, peer, kind, payload, timeout=None):
        self.calls.append((peer, kind))
        if self.fail:
            raise OSError("link down")
        return {"ok": True, "pid": peer}


class _FabricPlaneStub:
    def __init__(self, fail: bool):
        self.node = _Node(fail)
        self.n_proc = 3
        self.pid = 0
        self.runtime = None


def _canaries(pw, monkeypatch) -> tuple:
    health = _mod(pw, "observability.health")
    fabric = _mod(pw, "fabric")
    cfg = _mod(pw, "internals.config").get_pathway_config()
    plane = health.HealthPlane(cfg)
    monkeypatch.setattr(fabric, "_plane", _FabricPlaneStub(fail=False))
    plane._probe_fabric_links()
    ok = ([c[0] for c in fabric._plane.node.calls], dict(plane.canary_total), dict(plane.canary_failed))
    monkeypatch.setattr(fabric, "_plane", _FabricPlaneStub(fail=True))
    plane._probe_fabric_links()
    return ok, dict(plane.canary_failed)


def test_fabric_link_canaries_feed_slo_and_flap_detector(monkeypatch):
    """The health plane probes each fabric peer link over the transport and
    records it under ``fabric:p<peer>`` (``tests/test_timeline.py``)."""
    ref, got = (_canaries(pw, monkeypatch) for pw in PACKAGES)
    assert got == ref
    assert got[0] == ([1, 2], {"fabric:p1": 1, "fabric:p2": 1}, {})
    assert got[1] == {"fabric:p1": 1, "fabric:p2": 1}


def test_fabric_canary_req_handler_registered():
    replies = {}
    for pw in PACKAGES:
        got = []
        stub = type("P", (), {"pid": 2})()
        _mod(pw, "fabric.routing").FabricPlane._handle_canary(stub, {"from": 0}, got.append)
        replies[pw.__name__] = got
    assert replies["pathway_tpu_torch"] == replies["pathway_tpu"]
    (reply,) = replies["pathway_tpu_torch"]
    assert reply["ok"] is True and reply["pid"] == 2 and reply["from"] == 0


def test_single_process_runs_install_no_fabric(monkeypatch):
    monkeypatch.setenv("PATHWAY_FABRIC", "on")
    for pw in PACKAGES:
        fabric = _mod(pw, "fabric")
        assert fabric.install_from_env(object()) is None and fabric.current() is None


# ------------------------------------------------------------- cluster cases


@pytest.fixture(scope="module")
def single_retrieve(tmp_path_factory):
    """The retrieve pipeline's answers on one process, fabric off."""
    single = tf.run("retrieve", tmp_path_factory.mktemp("single"), 1, {"PATHWAY_MONITORING_HTTP_PORT": "0"})
    (answers,) = single["answers"].values()
    assert all(s == 200 for s, _b in answers)
    return answers


def test_fabric_two_process_byte_identity_and_trace_stitch(tmp_path, single_retrieve):
    """Both doors of a 2-process fabric answer embed → KNN → rerank
    byte-identically, and as a one-process run does; the peer forwards to
    the owner; the forwarded request's kept traces stitch ingress and owner
    spans under one trace id; the coordinator's rollup counts every door."""
    fabric = tf.run("retrieve", tmp_path, 2, {"PATHWAY_FABRIC": "on", "PATHWAY_REQUEST_TRACE_KEEP": "1.0"})
    doors = sorted(fabric["answers"], key=int)
    assert len(doors) == 2
    for door in doors:
        assert fabric["answers"][door] == single_retrieve, door
    assert fabric["fabric"][doors[1]] == ["forwarded:p0"] * 3
    assert len(set(fabric["schemas"])) == 1
    rids = [r for door in doors for r in fabric["rids"][door]]
    assert len(set(rids)) == len(rids)
    peer, owner = fabric["peer_trace"], fabric["owner_trace"]
    assert peer["ok"] and peer["kept"] and owner["ok"] and owner["kept"], (peer, owner)
    assert peer["trace_id"] == owner["trace_id"]
    assert {"fabric/forward", "serve/admission"} <= {s["name"] for s in peer["spans"]}
    assert "serve/respond" in {s["name"] for s in owner["spans"]}
    cluster = fabric["status"]["serving"]["cluster"]
    assert cluster["n_reporting"] == 2
    route = cluster["routes"]["/v1/retrieve"]
    assert (route["requests"], route["responses"]) == (6, 6)
    assert (route["forwarded_out"], route["forwarded_in"]) == (3, 3)
    assert fabric["status"]["fabric"]["enabled"] is True


def test_shardmap_zero_hop_two_doors_byte_identity(tmp_path, single_retrieve):
    """Under the shard map every door mints keys it owns and answers them
    itself: the same bytes as the fabric-off run, ``owner:p<pid>`` on every
    answer, nothing forwarded pod-wide (``tests/test_fabric_shardmap.py``)."""
    fabric = tf.run("retrieve", tmp_path, 2, {"PATHWAY_FABRIC": "on", "PATHWAY_SHARDMAP": "on"})
    doors = sorted(fabric["answers"], key=int)
    for i, door in enumerate(doors):
        assert fabric["answers"][door] == single_retrieve, door
        assert fabric["fabric"][door] == [f"owner:p{i}"] * 3
    cluster = fabric["status"]["serving"]["cluster"]
    route = cluster["routes"]["/v1/retrieve"]
    assert (route["requests"], route["responses"]) == (6, 6)
    assert (route["forwarded_out"], route["forwarded_in"]) == (0, 0)
    assert fabric["status"]["fabric"]["shardmap_version"] == 0


def test_fabric_replica_staleness_bound_under_churn(tmp_path):
    """A churning ``serve_table`` route on 2 processes: the peer answers from
    its replica with a measured lag within the bound, settles byte-identical
    to the owner, and shows the replica on its own ``/metrics`` and
    ``/status``."""
    got = tf.run("lookup", tmp_path, 2, {"PATHWAY_FABRIC": "on", "PATHWAY_FABRIC_MAX_STALENESS_MS": "2000"})
    local = [lag for s, src, lag in got["during"] if s == 200 and (src or "").startswith("replica:")]
    assert len(local) >= 0.8 * len(got["during"]), got["during"]
    assert local and max(float(lag) for lag in local) <= 2000.0
    for (so, bo, fo), (sp, bp, fp) in got["settled"]:
        assert so == sp == 200 and bo == bp
        assert fo == "owner" and fp.startswith("replica:")
    assert "pathway_fabric_replica_lag_seconds" in got["peer_metrics"]
    rep = got["peer_status"]["fabric"]["replica"]["/v1/latest"]
    assert rep["rows"] == 8 and rep["is_owner"] is False
    assert rep["local_answers"] >= len(local)


def test_rag_cluster_serve_mode_on_one_process(tmp_path):
    """``tools/rag_cluster.py --serve`` (``chip_smoke.py``'s fabric phase)
    on one process with the tiny models on the CPU: its client waits for the
    door and the whole corpus, every request is answered 200, and each doc
    comes first in its own answer."""
    import os
    import subprocess
    import sys

    from pathway_tpu_torch.tools.rag_cluster import synth_docs

    out = tmp_path / "served.json"
    port = free_port()
    release_port(port)
    env = {k: v for k, v in os.environ.items() if not k.startswith("PATHWAY_") and k != "PYTEST_XDIST_WORKER"}
    proc = subprocess.run(
        [sys.executable, "-m", "pathway_tpu_torch.tools.rag_cluster", "--out", str(out), "--docs", "32",
         "--queries", "4", "--k", "3", "--device", "cpu", "--model", "tiny", "--serve", str(port)],
        env=dict(env, PYTHONPATH=os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    (rows,) = json.loads(out.read_text()).values()
    assert [s for s, _b, _f, _ms in rows] == [200] * 4
    assert [json.loads(b)[0]["text"] for _s, b, _f, _ms in rows] == synth_docs(4)
