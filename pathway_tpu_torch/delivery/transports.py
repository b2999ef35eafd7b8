"""Idempotent sink transports for the delivery ledger.

Each transport's ``publish(sink_id, epoch, parts)`` must tolerate being called
again with the SAME frozen payload after a crash mid-publish — that is the
whole idempotence contract the ledger relies on:

- **Kafka** — a transactional producer when the client supports it (epoch rows
  + a commit marker in one transaction), else ``(sink_id, epoch, partition,
  seq)`` dedupe headers on every message plus the marker message; consumers
  read through :func:`read_committed`, which hides uncommitted tails and drops
  header-duplicate rows exactly like a ``read_committed`` Kafka consumer
  filtering aborted transactions.
- **Postgres** — one DBAPI transaction per epoch: the epoch's UPSERT/DELETE
  statements plus an ``INSERT INTO pathway_delivery (sink_id, epoch)`` marker
  row; a marker already present means the epoch landed and the transaction is
  skipped whole.
- **fs** — an offset sidecar (``<path>.delivery``, written tmp+rename):
  re-publish truncates back to the last durable offset before appending, so
  partially-written epochs never survive.

Carried from ``pathway_tpu/delivery/transports.py``: the Kafka transport over
``io.kafka`` (its ``MockKafkaBroker`` or an injected rdkafka-shaped client),
the Postgres transport over ``io.postgres`` (a DBAPI connection or
``io._pg_fake``) and the fs transport.
"""

from __future__ import annotations

import json as _json
import os
import zlib as _zlib
from typing import Any

#: single control topic carrying per-sink epoch commit markers (partition 0)
KAFKA_CONTROL_TOPIC = "__pathway_delivery"

#: commit-marker table every exactly-once postgres sink shares
PG_COMMIT_TABLE = "pathway_delivery"

_PG_COMMIT_DDL = (
    f"CREATE TABLE IF NOT EXISTS {PG_COMMIT_TABLE} "
    "(sink_id TEXT NOT NULL, epoch BIGINT NOT NULL, "
    "PRIMARY KEY (sink_id, epoch))"
)


def stable_partition(key: str | None, n: int) -> int:
    """Deterministic partition for a message key — ``hash()`` is salted per
    process, which would re-shuffle partitions across a restart and break the
    frozen-bytes contract."""
    if n <= 1 or key is None:
        return 0
    return _zlib.crc32(key.encode()) % n


class KafkaDeliveryTransport:
    """Publishes ledger epochs to Kafka. ``broker`` is a MockKafkaBroker (the
    in-process/file-backed fixture) or an rdkafka settings dict (real wire
    client, possibly injected via ``client_factory``). Records are
    ``(key, value)`` pairs as staged by the writer."""

    def __init__(self, broker, topic: str):
        self.broker = broker
        self.topic = topic
        self._producer = None
        self._txn_ready = False

    # -- real-client producer -------------------------------------------------
    def _real_producer(self):
        if self._producer is None:
            from pathway_tpu_torch.io.kafka import _client_module, _conf_of

            ck = _client_module(self.broker)
            self._producer = ck.Producer(_conf_of(self.broker))
            if "transactional.id" in self.broker and hasattr(
                self._producer, "init_transactions"
            ):
                self._producer.init_transactions()
                self._txn_ready = True
        return self._producer

    @staticmethod
    def _headers(sink_id: str, epoch: int, partition: int, seq: int) -> list:
        return [
            ("pw_sink", sink_id.encode()),
            ("pw_epoch", str(epoch).encode()),
            ("pw_part", str(partition).encode()),
            ("pw_seq", str(seq).encode()),
        ]

    def publish(self, sink_id: str, epoch: int, parts: dict[int, list]) -> None:
        marker_value = _json.dumps({"sink": sink_id, "epoch": epoch})
        if isinstance(self.broker, dict):
            producer = self._real_producer()
            if self._txn_ready:
                # transactional path: epoch rows + the commit marker become
                # visible atomically; an aborted attempt is invisible to
                # read_committed consumers
                producer.begin_transaction()
                try:
                    self._produce_real(producer, sink_id, epoch, parts, marker_value)
                except Exception:
                    producer.abort_transaction()
                    raise
                producer.commit_transaction()
            else:
                # no transactions: dedupe headers carry the idempotence key;
                # consumers drop header-duplicates (read_committed contract)
                self._produce_real(producer, sink_id, epoch, parts, marker_value)
                producer.flush()
            return
        # mock broker: one locked batch append + the marker message — the
        # marker gates read_committed visibility, the headers dedupe a
        # re-publish that raced a crash mid-batch
        msgs = []
        for p, records in sorted(parts.items()):
            for seq, (key, value) in enumerate(records):
                msgs.append(
                    {
                        "topic": self.topic,
                        "partition": p,
                        "key": key,
                        "value": value,
                        "headers": {
                            "pw_sink": sink_id,
                            "pw_epoch": str(epoch),
                            "pw_part": str(p),
                            "pw_seq": str(seq),
                        },
                    }
                )
        self.broker.produce_batch(
            msgs,
            marker={
                "topic": KAFKA_CONTROL_TOPIC,
                "partition": 0,
                "key": sink_id,
                "value": marker_value,
            },
        )

    def _produce_real(self, producer, sink_id, epoch, parts, marker_value) -> None:
        for p, records in sorted(parts.items()):
            for seq, (key, value) in enumerate(records):
                producer.produce(
                    self.topic,
                    value=value,
                    key=key,
                    headers=self._headers(sink_id, epoch, p, seq),
                )
        producer.produce(
            KAFKA_CONTROL_TOPIC, value=marker_value, key=sink_id
        )


def read_committed(broker, topic: str) -> tuple[list[tuple[Any, Any]], dict]:
    """Consumer-side view of an exactly-once topic on the mock broker: only
    messages whose epoch is covered by a control-topic commit marker are
    visible, and duplicate ``(sink, epoch, part, seq)`` idempotence keys from
    a crash-window re-publish are dropped (first occurrence wins, which is
    byte-identical to the uninterrupted run). Returns ``(messages, stats)``
    where stats counts exactly what was hidden: ``duplicates`` (idempotence-key
    repeats) and ``uncommitted`` (tail past the last marker)."""
    committed: dict[str, int] = {}
    for _k, v in broker.fetch(KAFKA_CONTROL_TOPIC, 0, 0):
        rec = _json.loads(v)
        committed[rec["sink"]] = max(committed.get(rec["sink"], -1), rec["epoch"])
    out: list[tuple[Any, Any]] = []
    seen: set[tuple] = set()
    duplicates = 0
    uncommitted = 0
    plain = 0
    for p in range(max(1, broker.partitions(topic))):
        for rec in broker.fetch_records(topic, p, 0):
            h = rec.get("h") or {}
            sink = h.get("pw_sink")
            if sink is None:
                plain += 1  # a non-delivery producer shares the topic
                out.append((rec["k"], rec["v"]))
                continue
            epoch = int(h.get("pw_epoch", -1))
            if epoch > committed.get(sink, -1):
                uncommitted += 1
                continue
            ikey = (sink, epoch, h.get("pw_part"), h.get("pw_seq"))
            if ikey in seen:
                duplicates += 1
                continue
            seen.add(ikey)
            out.append((rec["k"], rec["v"]))
    return out, {
        "duplicates": duplicates,
        "uncommitted": uncommitted,
        "plain": plain,
        "committed_epochs": dict(committed),
    }


class PostgresDeliveryTransport:
    """Publishes ledger epochs as one DBAPI transaction each. Records are
    ``(op, args)`` pairs where ``op`` selects a prepared statement from
    ``statements`` (e.g. the diff-aware UPSERT/DELETE built by
    ``io.postgres``)."""

    def __init__(self, settings: dict, statements: dict[str, str]):
        self.settings = settings
        self.statements = statements
        self._con = None
        self._ddl_done = False

    def _connection(self):
        if self._con is None:
            from pathway_tpu_torch.io.postgres import _connect

            self._con = _connect(self.settings)
        return self._con

    def publish(self, sink_id: str, epoch: int, parts: dict[int, list]) -> None:
        con = self._connection()
        try:
            with con.cursor() as cur:
                if not self._ddl_done:
                    cur.execute(_PG_COMMIT_DDL)
                    self._ddl_done = True
                cur.execute(
                    f"SELECT 1 FROM {PG_COMMIT_TABLE} "  # noqa: S608
                    "WHERE sink_id = %s AND epoch = %s",
                    (sink_id, epoch),
                )
                if cur.fetchone() is not None:
                    con.commit()  # marker present: the epoch already landed
                    return
                for _p, records in sorted(parts.items()):
                    for op, args in records:
                        cur.execute(self.statements[op], tuple(args))
                cur.execute(
                    f"INSERT INTO {PG_COMMIT_TABLE} "  # noqa: S608
                    "(sink_id, epoch) VALUES (%s, %s)",
                    (sink_id, epoch),
                )
            con.commit()
        except Exception:
            try:
                con.rollback()
            except Exception:
                pass
            raise


class FsDeliveryTransport:
    """Publishes ledger epochs as appended lines with an offset sidecar — the
    fs sink re-expressed over the ledger API. Records are ready-formatted text
    lines. The sidecar ``<path>.delivery`` records ``(offset, epoch)`` after
    every durable append (tmp+rename), so a re-publish truncates any partial
    tail first and an epoch already on disk is skipped whole."""

    def __init__(self, path: str, header: str | None = None):
        self.path = path
        self.header = header or ""
        self._sidecar = path + ".delivery"

    def _read_sidecar(self) -> dict:
        try:
            with open(self._sidecar) as fh:
                return _json.load(fh)
        except (FileNotFoundError, ValueError):
            return {"offset": None, "epoch": -1}

    def _write_sidecar(self, state: dict) -> None:
        tmp = self._sidecar + ".tmp"
        with open(tmp, "w") as fh:
            _json.dump(state, fh)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, self._sidecar)

    def publish(self, sink_id: str, epoch: int, parts: dict[int, list]) -> None:
        state = self._read_sidecar()
        if state["epoch"] >= epoch:
            return  # this epoch's bytes are already durable on disk
        if state["offset"] is None:
            # first ever publish: create the file with the header
            with open(self.path, "w", newline="") as fh:
                fh.write(self.header)
                fh.flush()
                os.fsync(fh.fileno())
                state["offset"] = fh.tell()
        with open(self.path, "r+", newline="") as fh:
            fh.truncate(state["offset"])
            fh.seek(state["offset"])
            for _p, records in sorted(parts.items()):
                for line in records:
                    fh.write(line)
            fh.flush()
            os.fsync(fh.fileno())
            new_offset = fh.tell()
        self._write_sidecar({"offset": new_offset, "epoch": epoch})
