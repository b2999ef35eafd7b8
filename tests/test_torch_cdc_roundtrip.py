"""The CDC round-trip workload on the port: a mirror of the reference's
``tests/test_cdc_roundtrip.py`` with ``pathway_tpu_torch`` in place of
``pathway_tpu``. Debezium-in -> join + windowed aggregation -> exactly-once
Kafka and Postgres out, run uninterrupted (the truth), SIGKILLed inside each
delivery crash window and restarted by the Supervisor, and rescaled 2 -> 3
processes mid-stream over one shared store (``PATHWAY_ELASTIC=manual``,
``PATHWAY_SHARDMAP=on``). In every case the downstream net state (the
committed Kafka view folded by key, the Postgres table) equals the truth
run's, and the port's truth equals the reference's on the same input
(``test_cdc_truth_matches_the_reference``). Cluster ports come from
``torch_cluster_helpers.first_port``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

import pytest

import pathway_tpu_torch as pw  # noqa: F401  (asserts the import side of the plane)
from pathway_tpu_torch.delivery import read_committed
from pathway_tpu_torch.io._pg_fake import FakePostgres
from pathway_tpu_torch.io.kafka import MockKafkaBroker
from pathway_tpu_torch.resilience.supervisor import Supervisor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# ---------------------------------------------------------------- workload --
_NAMES = ["alpha", "beta", "gamma"]
_REGION = {"alpha": "east", "beta": "west", "gamma": "south"}


def _envelope(op, before=None, after=None) -> str:
    return json.dumps({"payload": {"op": op, "before": before, "after": after}})


def _row(i: int, amount: int) -> dict:
    return {"id": i, "name": _NAMES[i % 3], "amount": amount, "ts": i}


def _phase_a() -> list[tuple[str, str]]:
    """Initial CDC snapshot+creates: ids 0..39."""
    return [
        (json.dumps({"id": i}), _envelope("c", after=_row(i, i))) for i in range(40)
    ]


def _phase_b() -> list[tuple[str, str]]:
    """Updates (0..19, amount += 100), deletes (20..29, each followed by the
    log-compaction tombstone), late creates (40..59)."""
    msgs: list[tuple[str, str]] = []
    for i in range(20):
        msgs.append(
            (
                json.dumps({"id": i}),
                _envelope("u", before=_row(i, i), after=_row(i, i + 100)),
            )
        )
    for i in range(20, 30):
        msgs.append((json.dumps({"id": i}), _envelope("d", before=_row(i, i))))
        msgs.append((json.dumps({"id": i}), "null"))  # compaction tombstone
    for i in range(40, 60):
        msgs.append((json.dumps({"id": i}), _envelope("c", after=_row(i, i))))
    return msgs


def _expected() -> dict[str, tuple[int, int]]:
    """Net downstream aggregate computed independently in plain Python."""
    live = {i: i + 100 for i in range(20)}
    live.update({i: i for i in range(30, 60)})
    agg: dict[str, tuple[int, int]] = {}
    for i, amt in live.items():
        wkey = f"{_REGION[_NAMES[i % 3]]}:{i // 10}"
        t, n = agg.get(wkey, (0, 0))
        agg[wkey] = (t + amt, n + 1)
    return agg


def _feed(broker: MockKafkaBroker, msgs: list[tuple[str, str]]) -> None:
    broker.create_topic("cdc", 1)
    for key, value in msgs:
        broker.produce("cdc", value, key=key)


# ------------------------------------------------------------ the pipeline --
_CDC_SCRIPT = textwrap.dedent(
    """
    import json, os

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.io._pg_fake import FakePostgres
    from pathway_tpu_torch.io.kafka import MockKafkaBroker

    broker = MockKafkaBroker(os.environ["CDC_BROKER"])
    # "static" drains the pre-produced log then finishes — restart-safe even
    # when the whole stream was already committed before the crash (a
    # change-triggered stop would never re-fire after such a restart).
    # "meter" keeps streaming and stops once CDC_EXPECTED_MSGS messages are
    # counted — the cluster legs use it because each session gets fresh input.
    mode = os.environ.get("CDC_MODE", "static")

    class CdcS(pw.Schema):
        id: int = pw.column_definition(primary_key=True)
        name: str
        amount: int
        ts: int

    events = pw.io.debezium.read(
        broker, "cdc", schema=CdcS,
        mode="static" if mode == "static" else "streaming", name="cdc",
    )
    dims = pw.debug.table_from_rows(
        pw.schema_from_types(name=str, region=str),
        [("alpha", "east"), ("beta", "west"), ("gamma", "south")],
    )
    joined = events.join(dims, events.name == dims.name).select(
        region=dims.region,
        amount=events.amount,
        bucket=pw.apply_with_type(lambda t: t // 10, int, events.ts),
    )
    keyed = joined.select(
        pw.this.amount,
        wkey=pw.apply_with_type(
            lambda r, b: "%s:%d" % (r, b), str, pw.this.region, pw.this.bucket
        ),
    )
    win = keyed.groupby(pw.this.wkey).reduce(
        pw.this.wkey,
        total=pw.reducers.sum(pw.this.amount),
        n=pw.reducers.count(),
    )

    pw.io.kafka.write(
        win, broker, "out", format="json", key_column="wkey",
        delivery="exactly_once", partitions=2,
    )
    pg = FakePostgres(os.environ["CDC_PG"])
    pw.io.postgres.write_snapshot(
        win, {"connection_factory": pg.connect}, "cdc_out",
        primary_key=["wkey"], delivery="exactly_once",
    )

    if mode == "meter":
        # stop condition: a plaintext second read of the input topic gives a
        # monotone message count (retraction-proof, replay-stable)
        expected_msgs = int(os.environ["CDC_EXPECTED_MSGS"])
        raw = pw.io.kafka.read(
            broker, "cdc", format="plaintext", mode="streaming", name="rawmeter"
        )
        meter = raw.reduce(c=pw.reducers.count())

        def on_meter(key, row, time, is_addition):
            if is_addition and row["c"] >= expected_msgs:
                rt = pw.internals.run.current_runtime()
                if rt is not None:
                    rt.request_stop()

        pw.io.subscribe(meter, on_change=on_meter)

    pw.run(
        monitoring_level="none",
        persistence_config=pw.persistence.Config(
            backend=pw.persistence.Backend.filesystem(
                os.environ["PATHWAY_PERSISTENT_STORAGE"]
            ),
            persistence_mode="operator_persisting",
            snapshot_interval_ms=120,
        ),
    )
    print("CDC_DONE")
    """
)


def _write_script(tmp_path) -> str:
    path = str(tmp_path / "cdc_pipeline.py")
    with open(path, "w") as f:
        f.write(_CDC_SCRIPT)
    return path


def _make_dirs(tmp_path, name: str) -> dict[str, str]:
    root = tmp_path / name
    root.mkdir()
    env = {
        "CDC_BROKER": str(root / "broker"),
        "CDC_PG": str(root / "pg.json"),
        "PATHWAY_PERSISTENT_STORAGE": str(root / "pstore"),
    }
    # the postgres target table must pre-exist (the transport only creates
    # its own pathway_delivery commit table)
    con = FakePostgres(env["CDC_PG"]).connect()
    cur = con.cursor()
    cur.execute(
        "CREATE TABLE cdc_out (wkey TEXT PRIMARY KEY, total BIGINT, n BIGINT)"
    )
    con.commit()
    con.close()
    return env


def _base_env(extra: dict[str, str]) -> dict[str, str]:
    env = os.environ.copy()
    env.update(extra)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _free_port_base(n: int) -> int:
    """A free cluster base for ``n`` processes in this xdist worker's range."""
    from torch_cluster_helpers import first_port

    return first_port(n)


# ----------------------------------------------------------- observations --
def _kafka_net(broker_path: str) -> tuple[dict[str, tuple[int, int]], dict]:
    """Committed-read consumer view folded to net state: what a downstream
    system that honors the idempotence keys actually retains."""
    broker = MockKafkaBroker(broker_path)
    msgs, stats = read_committed(broker, "out")
    net: dict[tuple, int] = {}
    for _key, value in msgs:
        rec = json.loads(value)
        ident = (rec["wkey"], rec["total"], rec["n"])
        net[ident] = net.get(ident, 0) + rec["diff"]
    bad = {k: c for k, c in net.items() if c not in (0, 1)}
    assert not bad, f"committed stream does not net to a consistent state: {bad}"
    state = {w: (t, n) for (w, t, n), c in net.items() if c == 1}
    return state, stats


def _pg_state(pg_path: str) -> list[tuple]:
    return FakePostgres(pg_path).dump("cdc_out", order_by=["wkey"])


def _assert_downstream(env: dict[str, str], truth) -> dict:
    """Both sinks must match the uninterrupted run byte-for-byte (net state),
    with zero lost and zero consumer-visible duplicate rows."""
    expected = _expected()
    kafka_state, stats = _kafka_net(env["CDC_BROKER"])
    pg_rows = _pg_state(env["CDC_PG"])
    assert kafka_state == expected  # zero lost, zero duplicated rows
    assert pg_rows == [(w, t, n) for w, (t, n) in sorted(expected.items())]
    assert stats["uncommitted"] == 0
    assert stats["plain"] == 0
    if truth is not None:
        assert kafka_state == truth["kafka"]
        assert pg_rows == truth["pg"]
    return stats


# ------------------------------------------------------------------ truth --
def _run_truth(tmp_path) -> dict:
    env = _make_dirs(tmp_path, "truth")
    _feed(MockKafkaBroker(env["CDC_BROKER"]), _phase_a() + _phase_b())
    script = _write_script(tmp_path)
    proc = subprocess.run(
        [sys.executable, script],
        env=_base_env(env),
        capture_output=True,
        text=True,
        timeout=180,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    stats = _assert_downstream(env, truth=None)
    # the clean run must not even need the dedupe layer
    assert stats["duplicates"] == 0
    kafka_state, _ = _kafka_net(env["CDC_BROKER"])
    return {"kafka": kafka_state, "pg": _pg_state(env["CDC_PG"])}


@pytest.fixture(scope="module")
def truth(tmp_path_factory):
    return _run_truth(tmp_path_factory.mktemp("cdc_truth"))


def test_cdc_roundtrip_uninterrupted(truth):
    """The truth fixture already asserts the clean run against the
    independently computed expectation; pin its shape here."""
    assert truth["kafka"] == _expected()
    assert len(truth["pg"]) == len(_expected())


# ------------------------------------------------------- crash-window legs --
@pytest.mark.parametrize(
    "point", ["delivery_staged", "delivery_committed", "delivery_published"]
)
def test_cdc_roundtrip_survives_kill(tmp_path, truth, point):
    """SIGKILL inside each delivery crash window; the supervisor restarts the
    pipeline (clearing the fault plan), replay + sink-side idempotence keep
    the downstream state byte-identical to the uninterrupted run.

    ``delivery_staged`` is the satellite-3 window specifically: rows staged
    in the ledger but the epoch manifest not yet committed — the orphan
    stage is discarded on restart and regenerated by replay.
    """
    env = _make_dirs(tmp_path, "leg")
    _feed(MockKafkaBroker(env["CDC_BROKER"]), _phase_a() + _phase_b())
    env["PATHWAY_FAULT_PLAN"] = f"kill_point:point={point}"
    script = _write_script(tmp_path)
    sup = Supervisor(
        [sys.executable, script],
        processes=1,
        threads=1,
        first_port=_free_port_base(1),
        max_restarts=3,
        backoff_s=0.05,
        env=_base_env(env),
        log_dir=str(tmp_path / "logs"),
    )
    result = sup.run()
    assert result.restarts >= 1, "the fault plan never fired"
    stats = _assert_downstream(env, truth)
    if point == "delivery_published":
        # killed between transport.publish and mark_published: the restart
        # re-publishes the epoch and the idempotence keys must absorb it
        assert stats["duplicates"] >= 1


# ------------------------------------------------------------ rescale leg --
def _run_cluster(script: str, n: int, env_extra: dict[str, str]) -> None:
    base = _free_port_base(n)
    procs = []
    for pid in range(n):
        env = _base_env(env_extra)
        env.update(
            {
                "PATHWAY_PROCESSES": str(n),
                "PATHWAY_PROCESS_ID": str(pid),
                "PATHWAY_THREADS": "1",
                "PATHWAY_FIRST_PORT": str(base),
                "PATHWAY_BARRIER_TIMEOUT": "60",
                "PATHWAY_ELASTIC": "manual",
                "PATHWAY_SHARDMAP": "on",
            }
        )
        procs.append(
            subprocess.Popen(
                [sys.executable, script],
                env=env,
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
            )
        )
    texts = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=180)
            texts.append(out or "")
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise AssertionError(
            "cdc cluster hung; output:\n" + "\n---\n".join(texts)
        )
    codes = [p.returncode for p in procs]
    assert codes == [0] * n, "\n---\n".join(texts)


def test_cdc_roundtrip_survives_rescale(tmp_path, truth):
    """Half the stream through a 2-process pod, the rest through a 3-process
    pod over the same store — the sink ledger cut migrates with the rescale
    and the downstream state still matches the uninterrupted run exactly."""
    env = _make_dirs(tmp_path, "rescale")
    env["CDC_MODE"] = "meter"
    script = _write_script(tmp_path)
    broker = MockKafkaBroker(env["CDC_BROKER"])

    _feed(broker, _phase_a())
    env["CDC_EXPECTED_MSGS"] = str(len(_phase_a()))
    _run_cluster(script, 2, env)

    _feed(broker, _phase_b())
    env["CDC_EXPECTED_MSGS"] = str(len(_phase_a()) + len(_phase_b()))
    _run_cluster(script, 3, env)

    _assert_downstream(env, truth)


def test_cdc_truth_matches_the_reference(tmp_path, truth):
    """The reference's uninterrupted run over the same input: the same
    downstream net state in Kafka and Postgres as the port's truth run."""
    env = _make_dirs(tmp_path, "reference")
    _feed(MockKafkaBroker(env["CDC_BROKER"]), _phase_a() + _phase_b())
    script = str(tmp_path / "cdc_pipeline_reference.py")
    with open(script, "w") as f:
        f.write(_CDC_SCRIPT.replace("pathway_tpu_torch", "pathway_tpu"))
    proc = subprocess.run([sys.executable, script], env=_base_env(env), capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    kafka_state, _ = _kafka_net(env["CDC_BROKER"])
    assert kafka_state == truth["kafka"]
    assert _pg_state(env["CDC_PG"]) == truth["pg"]
