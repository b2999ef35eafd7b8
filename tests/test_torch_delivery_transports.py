"""The exactly-once delivery plane's Kafka and Postgres transports on the port:
a mirror of the reference's ``tests/test_delivery.py`` Kafka and Postgres
cases with ``pathway_tpu_torch_torch`` in place of ``pathway_tpu_torch`` (read_committed
semantics, the mock broker's batches and headers, the Postgres transport's
epoch idempotence, the fake Postgres dialect, Kafka and Postgres sinks end
to end over operator persistence, a Kafka restart without duplicates, plain
append refusing retractions), each held to the reference's expectations on
the same inputs. The end-to-end sinks also run on the reference with the
same inputs and compare what each sink holds.
"""

from __future__ import annotations

import json

import pytest

import pathway_tpu_torch as pw
from pathway_tpu_torch.delivery import (
    KAFKA_CONTROL_TOPIC,
    PG_COMMIT_TABLE,
    KafkaDeliveryTransport,
    PostgresDeliveryTransport,
    read_committed,
)
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.io._pg_fake import FakePostgres, FakePostgresError
from pathway_tpu_torch.io.kafka import MockKafkaBroker


def test_kafka_read_committed_semantics():
    broker = MockKafkaBroker()
    broker.create_topic("t", 2)
    tr = KafkaDeliveryTransport(broker, "t")
    tr.publish("s", 0, {0: [("k1", "v1")], 1: [("k2", "v2")]})
    msgs, stats = read_committed(broker, "t")
    assert sorted(msgs) == [("k1", "v1"), ("k2", "v2")]
    assert stats["duplicates"] == 0 and stats["uncommitted"] == 0
    assert stats["committed_epochs"] == {"s": 0}

    # crash-window re-publish of the same frozen epoch: deduped by headers
    tr.publish("s", 0, {0: [("k1", "v1")], 1: [("k2", "v2")]})
    msgs, stats = read_committed(broker, "t")
    assert sorted(msgs) == [("k1", "v1"), ("k2", "v2")]
    assert stats["duplicates"] == 2

    # rows staged past the last marker (epoch never committed): hidden
    broker.produce(
        "t",
        "v3",
        key="k3",
        partition=0,
        headers={"pw_sink": "s", "pw_epoch": "9", "pw_part": "0", "pw_seq": "0"},
    )
    msgs, stats = read_committed(broker, "t")
    assert ("k3", "v3") not in msgs
    assert stats["uncommitted"] == 1

    # a plain producer sharing the topic passes straight through
    broker.produce("t", "plainv", key="pk", partition=1)
    msgs, stats = read_committed(broker, "t")
    assert ("pk", "plainv") in msgs
    assert stats["plain"] == 1


def test_mock_broker_batch_and_headers_roundtrip(tmp_path):
    # file-backed log: headers survive the jsonl roundtrip, fetch() keeps the
    # legacy (key, value) tuple shape
    broker = MockKafkaBroker(path=str(tmp_path / "log"))
    broker.produce_batch(
        [{"topic": "t", "partition": 0, "key": "k", "value": "v",
          "headers": {"pw_sink": "s"}}],
        marker={"topic": KAFKA_CONTROL_TOPIC, "partition": 0, "key": "s",
                "value": json.dumps({"sink": "s", "epoch": 0})},
    )
    assert broker.fetch("t", 0, 0) == [("k", "v")]
    (rec,) = broker.fetch_records("t", 0, 0)
    assert rec["h"] == {"pw_sink": "s"}
    assert broker.fetch(KAFKA_CONTROL_TOPIC, 0, 0) != []


def _make_pg(tmp_path, ddl):
    fake = FakePostgres(str(tmp_path / "pg.db"))
    con = fake.connect()
    cur = con.cursor()
    cur.execute(ddl)
    con.commit()
    return fake


def test_postgres_transport_epoch_idempotent(tmp_path):
    fake = _make_pg(
        tmp_path, "CREATE TABLE words (word TEXT PRIMARY KEY, total BIGINT)"
    )
    upsert = (
        "INSERT INTO words (word, total) VALUES (%s, %s) "
        "ON CONFLICT (word) DO UPDATE SET total = EXCLUDED.total"
    )
    delete = "DELETE FROM words WHERE word = %s"
    tr = PostgresDeliveryTransport(
        {"connection_factory": fake.connect}, {"u": upsert, "d": delete}
    )
    tr.publish("pg.words", 0, {0: [("u", ("a", 1)), ("u", ("b", 2))]})
    tr.publish("pg.words", 1, {0: [("d", ("a",)), ("u", ("b", 5))]})
    assert fake.dump("words", order_by=["word"]) == [("b", 5)]
    # re-publishing a committed epoch is a whole-transaction no-op
    tr.publish("pg.words", 1, {0: [("d", ("b",))]})
    assert fake.dump("words", order_by=["word"]) == [("b", 5)]
    marks = fake.dump(PG_COMMIT_TABLE, order_by=["epoch"])
    assert marks == [("pg.words", 0), ("pg.words", 1)]


def test_fake_postgres_dialect(tmp_path):
    fake = FakePostgres(str(tmp_path / "db"))
    con = fake.connect()
    cur = con.cursor()
    cur.execute("CREATE TABLE t (a TEXT, b BIGINT, PRIMARY KEY (a))")
    cur.execute("INSERT INTO t (a, b) VALUES (%s, %s)", ("x", 1))
    # uncommitted state visible to this connection's SELECT, not to others
    cur.execute("SELECT * FROM t")
    assert cur.fetchall() == [("x", 1)]
    assert fake.dump("t") == []
    con.commit()
    assert fake.dump("t") == [("x", 1)]
    # upsert updates in place
    cur.execute(
        "INSERT INTO t (a, b) VALUES (%s, %s) "
        "ON CONFLICT (a) DO UPDATE SET b = EXCLUDED.b",
        ("x", 9),
    )
    con.commit()
    assert fake.dump("t") == [("x", 9)]
    # plain insert violating the PK raises and the txn rolls back
    cur.execute("INSERT INTO t (a, b) VALUES (%s, %s)", ("x", 2))
    with pytest.raises(FakePostgresError, match="duplicate key"):
        con.commit()
    con.rollback()
    cur.execute("DELETE FROM t WHERE a = %s", ("x",))
    con.commit()
    assert fake.dump("t") == []
    # rollback discards pending ops
    cur.execute("INSERT INTO t (a, b) VALUES (%s, %s)", ("y", 1))
    con.rollback()
    con.commit()
    assert fake.dump("t") == []
    with pytest.raises(FakePostgresError, match="does not exist"):
        cur.execute("SELECT * FROM missing")


class KS(pw.Schema):
    k: str
    v: int


def _operator_config(tmp_path, sub="pstate"):
    return pw.persistence.Config(
        backend=pw.persistence.Backend.filesystem(str(tmp_path / sub)),
        persistence_mode="operator_persisting",
    )


def test_kafka_exactly_once_end_to_end(tmp_path):
    broker = MockKafkaBroker()
    broker.create_topic("in", 1)
    inputs = [(f"key{i}", i) for i in range(9)]
    for k, v in inputs:
        broker.produce("in", json.dumps({"k": k, "v": v}))

    G.clear()
    t = pw.io.kafka.read(broker, "in", schema=KS, format="json", mode="static")
    pw.io.kafka.write(
        t,
        broker,
        "out",
        format="json",
        key_column="k",
        delivery="exactly_once",
        partitions=2,
    )
    pw.run(persistence_config=_operator_config(tmp_path))

    assert broker.partitions("out") == 2
    msgs, stats = read_committed(broker, "out")
    assert stats["duplicates"] == 0 and stats["uncommitted"] == 0
    assert "kafka.out" in stats["committed_epochs"]
    got = sorted((json.loads(v)["k"], json.loads(v)["v"]) for _k, v in msgs)
    assert got == sorted(inputs)
    # message keys route by the stable key hash
    for k, _v in msgs:
        assert k is not None


def test_kafka_exactly_once_restart_no_duplicates(tmp_path):
    broker = MockKafkaBroker()
    broker.create_topic("in", 1)

    def session(n_rows):
        G.clear()
        t = pw.io.kafka.read(
            broker, "in", schema=KS, format="json", mode="static", name="cdcin"
        )
        pw.io.kafka.write(
            t, broker, "out", format="json", key_column="k",
            delivery="exactly_once",
        )
        pw.run(persistence_config=_operator_config(tmp_path))

    for i in range(5):
        broker.produce("in", json.dumps({"k": f"a{i}", "v": i}))
    session(5)
    msgs1, stats1 = read_committed(broker, "out")
    assert len(msgs1) == 5 and stats1["duplicates"] == 0

    # restart over the same backend + broker with 5 more rows: the restored
    # cut means nothing re-publishes, only the new rows land
    for i in range(5, 10):
        broker.produce("in", json.dumps({"k": f"a{i}", "v": i}))
    session(10)
    msgs2, stats2 = read_committed(broker, "out")
    assert stats2["duplicates"] == 0 and stats2["uncommitted"] == 0
    keys = sorted(json.loads(v)["k"] for _k, v in msgs2)
    assert keys == sorted(f"a{i}" for i in range(10))
    # run 1's messages are a prefix of run 2's view (frozen bytes kept)
    assert msgs2[: len(msgs1)] == msgs1


class WS(pw.Schema):
    word: str
    count: int


def test_postgres_snapshot_exactly_once_end_to_end(tmp_path):
    fake = _make_pg(
        tmp_path, "CREATE TABLE words (word TEXT PRIMARY KEY, total BIGINT)"
    )
    settings = {"connection_factory": fake.connect}
    # timed stream: "a" updates across ticks, so the sink sees real
    # retract+insert pairs, exercising the diff-aware DELETE/UPSERT path
    rows = [
        ("a", 1, 0, 1),
        ("b", 2, 1, 1),
        ("a", 3, 2, 1),
    ]

    def session():
        G.clear()
        t = pw.debug.table_from_rows(WS, rows, is_stream=True)
        agg = t.groupby(pw.this.word).reduce(
            pw.this.word, total=pw.reducers.sum(pw.this.count)
        )
        pw.io.postgres.write_snapshot(
            agg, settings, "words", primary_key=["word"], delivery="exactly_once"
        )
        pw.run(persistence_config=_operator_config(tmp_path))

    session()
    assert fake.dump("words", order_by=["word"]) == [("a", 4), ("b", 2)]
    marks = fake.dump(PG_COMMIT_TABLE)
    assert marks and all(m[0] == "postgres.words" for m in marks)

    # deterministic restart: everything replays as the persisted prefix, the
    # sink publishes nothing new, downstream state is untouched
    n_marks = len(marks)
    session()
    assert fake.dump("words", order_by=["word"]) == [("a", 4), ("b", 2)]
    assert len(fake.dump(PG_COMMIT_TABLE)) == n_marks


def test_postgres_plain_append_rejects_retractions(tmp_path):
    fake = _make_pg(
        tmp_path,
        "CREATE TABLE events (word TEXT, total BIGINT, time BIGINT, diff BIGINT)",
    )
    rows = [("a", 1, 0, 1), ("a", 5, 1, 1)]
    G.clear()
    t = pw.debug.table_from_rows(WS, rows, is_stream=True)
    # the aggregate update retracts the old total — plain-append must refuse
    agg = t.groupby(pw.this.word).reduce(
        pw.this.word, total=pw.reducers.sum(pw.this.count)
    )
    pw.io.postgres.write(agg, {"connection_factory": fake.connect}, "events")
    with pytest.raises(RuntimeError, match="write_snapshot"):
        pw.run()


# ------------------------------------------------------- against the reference


def _kafka_sink_session(p, broker, tmp_path, first, n_rows):
    """Rows ``a<first> .. a<n_rows - 1>`` produced, then the whole topic
    through a Kafka source and an exactly-once Kafka sink of package ``p``,
    over operator persistence under ``tmp_path``."""
    schema = p.schema_from_types(k=str, v=int)
    for i in range(first, n_rows):
        broker.produce("in", json.dumps({"k": f"a{i}", "v": i}))
    p.G.clear()
    t = p.io.kafka.read(broker, "in", schema=schema, format="json", mode="static", name="cdcin")
    p.io.kafka.write(t, broker, "out", format="json", key_column="k", delivery="exactly_once", partitions=2)
    p.run(persistence_config=p.persistence.Config(
        backend=p.persistence.Backend.filesystem(str(tmp_path / "pstate")),
        persistence_mode="operator_persisting"))
    p.G.clear()


def test_kafka_exactly_once_sink_matches_the_reference(tmp_path):
    """Two sessions (5 rows, then 10) on each package: the committed view,
    its statistics and every partition's messages, headers included, are
    the same."""
    import pathway_tpu as ref_pw

    out = {}
    for name, p in (("ref", ref_pw), ("port", pw)):
        broker = p.io.kafka.MockKafkaBroker()
        broker.create_topic("in", 1)
        views = []
        for first, n in ((0, 5), (5, 10)):
            _kafka_sink_session(p, broker, tmp_path / name, first, n)
            msgs, stats = p.delivery.read_committed(broker, "out")
            views.append((msgs, stats["duplicates"], stats["uncommitted"], sorted(stats["committed_epochs"])))
        out[name] = views
    assert out["port"] == out["ref"]
    assert len(out["ref"][1][0]) == 10


def test_postgres_exactly_once_sink_matches_the_reference(tmp_path):
    """The snapshot sink's table and commit markers after a run and a
    deterministic restart, on each package's fake Postgres."""
    import pathway_tpu as ref_pw
    from pathway_tpu.io._pg_fake import FakePostgres as RefFakePostgres

    rows = [("a", 1, 0, 1), ("b", 2, 1, 1), ("a", 3, 2, 1), ("c", 5, 3, 1), ("b", 2, 4, -1)]
    out = {}
    for name, p, fake_cls in (("ref", ref_pw, RefFakePostgres), ("port", pw, FakePostgres)):
        d = tmp_path / name
        d.mkdir()
        fake = fake_cls(str(d / "pg.db"))
        con = fake.connect()
        con.cursor().execute("CREATE TABLE words (word TEXT PRIMARY KEY, total BIGINT)")
        con.commit()
        schema = p.schema_from_types(word=str, count=int)
        seen = []
        for _ in range(2):
            p.G.clear()
            t = p.debug.table_from_rows(schema, rows, is_stream=True)
            agg = t.groupby(p.this.word).reduce(p.this.word, total=p.reducers.sum(p.this.count))
            p.io.postgres.write_snapshot(agg, {"connection_factory": fake.connect}, "words",
                                         primary_key=["word"], delivery="exactly_once")
            p.run(persistence_config=p.persistence.Config(
                backend=p.persistence.Backend.filesystem(str(d / "pstate")),
                persistence_mode="operator_persisting"))
            seen.append((fake.dump("words", order_by=["word"]), sorted(fake.dump(PG_COMMIT_TABLE))))
        p.G.clear()
        out[name] = seen
    assert out["port"] == out["ref"]
    assert out["ref"][0][0] == [("a", 4), ("c", 5)] and out["ref"][1] == out["ref"][0]
