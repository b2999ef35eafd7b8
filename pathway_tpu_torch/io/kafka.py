"""Kafka connector (reference: ``python/pathway/io/kafka`` over Rust
``KafkaReader``/``KafkaWriter``, ``src/connectors/data_storage.rs:712,1406``).

Two transports behind one API:

- ``MockKafkaBroker`` — an in-process/file-backed partitioned log. With a ``path``
  it is durable across processes (each partition is an append-only jsonl file), so
  kill/restart recovery and multi-process tests run without a broker daemon —
  the role of the reference's dockerized Kafka fixtures
  (``integration_tests/kafka/``).
- real Kafka via ``rdkafka_settings`` — requires a client library that is not in
  this image; gated with a clear error (dependency gate, not a stub).

Reads are partition-aware: a reader owns an explicit partition set, so a
multi-worker runtime can assign disjoint partitions per worker (the reference
reads Kafka partition-per-worker, ``worker-architecture.md:36-47``).

Carried from ``pathway_tpu/io/kafka.py`` unchanged. ``delivery="exactly_once"``
publishes through the delivery plane's Kafka transport
(``delivery/transports.py``).
"""

from __future__ import annotations

import json as _json
import os
import threading
import time as _time
from typing import Any

from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io._format import (
    Formatter,
    Parser,
    RawMessage,
    formatter_for,
    parser_for,
)


class MockKafkaBroker:
    """Partitioned append-only message log.

    In-memory by default; give ``path`` for a durable on-disk log shared across
    processes. Messages are (key, value) string/bytes pairs; per-partition order
    is total, cross-partition order is not — exactly Kafka's contract.
    """

    def __init__(self, path: str | None = None):
        self.path = path
        self._mem: dict[str, list[list[tuple[Any, Any]]]] = {}
        self._lock = threading.Lock()
        if path:
            os.makedirs(path, exist_ok=True)

    # ---- admin ----
    def create_topic(self, topic: str, partitions: int = 1) -> None:
        with self._lock:
            self._ensure_topic_locked(topic, partitions)

    def _ensure_topic_locked(self, topic: str, partitions: int) -> None:
        if self.path:
            tdir = os.path.join(self.path, topic)
            os.makedirs(tdir, exist_ok=True)
            for p in range(partitions):
                fp = self._file(topic, p)
                if not os.path.exists(fp):
                    open(fp, "a").close()
        else:
            plist = self._mem.setdefault(topic, [])
            while len(plist) < partitions:
                plist.append([])

    def partitions(self, topic: str) -> int:
        if self.path:
            tdir = os.path.join(self.path, topic)
            if not os.path.isdir(tdir):
                return 0
            return len([f for f in os.listdir(tdir) if f.startswith("partition_")])
        return len(self._mem.get(topic, []))

    def _file(self, topic: str, partition: int) -> str:
        return os.path.join(self.path, topic, f"partition_{partition:04d}.jsonl")

    # ---- produce ----
    def produce(
        self,
        topic: str,
        value: bytes | str,
        key: bytes | str | None = None,
        partition: int | None = None,
        headers: dict | None = None,
    ) -> None:
        n = self.partitions(topic)
        if n == 0:
            self.create_topic(topic, 1)
            n = 1
        if partition is None:
            partition = (hash(key) % n) if key is not None else 0
        with self._lock:
            self._append_locked(topic, partition, key, value, headers)

    def produce_batch(self, msgs: list[dict], marker: dict | None = None) -> None:
        """Atomically append a batch (each msg ``{"topic", "partition", "key",
        "value", "headers"}``) plus an optional trailing commit marker — the
        delivery plane's single-locked-append publish path: a concurrent
        ``fetch`` never observes a marker without its batch."""
        all_msgs = list(msgs)
        if marker is not None:
            all_msgs.append(dict(marker))
        with self._lock:
            for m in all_msgs:
                p = m.get("partition")
                self._append_locked(
                    m["topic"],
                    0 if p is None else int(p),
                    m.get("key"),
                    m["value"],
                    m.get("headers"),
                )

    def _append_locked(self, topic, partition, key, value, headers=None) -> None:
        self._ensure_topic_locked(topic, partition + 1)
        if isinstance(value, bytes):
            value = value.decode(errors="replace")
        if isinstance(key, bytes):
            key = key.decode(errors="replace")
        rec: dict = {"k": key, "v": value}
        if headers:
            # optional jsonl key: logs written before headers existed (or by
            # plain producers) read back with h absent
            rec["h"] = dict(headers)
        if self.path:
            with open(self._file(topic, partition), "a") as fh:
                fh.write(_json.dumps(rec) + "\n")
                fh.flush()
        else:
            self._mem[topic][partition].append(rec)

    # ---- consume ----
    def fetch(self, topic: str, partition: int, offset: int) -> list[tuple[Any, Any]]:
        """All messages in ``partition`` from ``offset`` (message index) on."""
        return [
            (r["k"], r["v"]) for r in self.fetch_records(topic, partition, offset)
        ]

    def fetch_records(self, topic: str, partition: int, offset: int) -> list[dict]:
        """Like :meth:`fetch` but returns full records (``{"k", "v"}`` plus
        ``"h"`` headers when present) — ``delivery.read_committed`` needs the
        idempotence headers to dedupe crash-window re-publishes."""
        if self.path:
            fp = self._file(topic, partition)
            if not os.path.exists(fp):
                return []
            out = []
            with open(fp) as fh:
                for i, line in enumerate(fh):
                    if i < offset or not line.strip():
                        continue
                    out.append(_json.loads(line))
            return out
        with self._lock:
            plist = self._mem.get(topic)
            if plist is None or partition >= len(plist):
                return []
            return [dict(r) for r in plist[partition][offset:]]


def _client_module(settings: dict):
    """Resolve a confluent-kafka-shaped client module for ``rdkafka_settings``
    dicts: the ``client_factory`` key injects any object exposing
    ``Consumer``/``Producer``/``TopicPartition`` (how CI exercises the real
    wire path on this clientless image — ``tests/test_gated_connectors.py``);
    otherwise ``confluent_kafka`` is imported."""
    factory = settings.get("client_factory")
    if factory is not None:
        return factory
    try:
        import confluent_kafka

        return confluent_kafka
    except ImportError:
        raise NotImplementedError(
            "real Kafka requires the confluent-kafka client (or a "
            "client_factory= entry in the settings dict); pass a "
            "MockKafkaBroker (optionally file-backed) instead"
        ) from None


def _conf_of(settings: dict) -> dict:
    conf = {k: v for k, v in settings.items() if k != "client_factory"}
    conf.setdefault("group.id", "pathway")
    return conf


def _kafka_event_key(subject, topic: str, partition: int, offset: int, event_idx: int, values: tuple) -> int:
    """Row key for one parsed event. pk schemas key by content (updates net in
    place); otherwise the key derives from (topic, partition, offset,
    event-within-message) — deterministic across worker counts and arrival
    interleavings, unlike a per-subject sequential counter (which would
    collide between workers' subjects), and unique per event even when one
    message parses into several rows."""
    if subject._pk_cols:
        return subject._key_of(values)
    from pathway_tpu_torch.internals.keys import stable_hash_obj

    return int(stable_hash_obj(("kafka", topic, partition, offset, event_idx)))


def _read_real(
    settings: dict,
    topic: str,
    schema,
    the_parser: Parser,
    mode: str,
    partitions: list[int] | None,
    poll_interval: float,
    name: str | None,
    service_class: str = "interactive",
):
    """Consumer-driven read over the wire protocol client (reference
    ``KafkaReader``, ``src/connectors/data_storage.rs:712``): assigned
    partitions, per-partition offsets for the persistence seek contract,
    static mode bounded by the watermark offsets captured at start.
    Partition-per-worker: each worker's subject assigns only partitions
    ``p % n_workers == worker`` (``worker-architecture.md:36-47``)."""
    from pathway_tpu_torch.io.python import (
        ConnectorSubject,
        read_partitioned as py_read_partitioned,
    )

    ck = _client_module(settings)

    class _RealKafkaSubject(ConnectorSubject):
        def __init__(self, worker: int = 0, n_workers: int = 1) -> None:
            super().__init__()
            self.worker = worker
            self.n_workers = n_workers
            self._stop = False
            self._offsets: dict[int, int] = {}
            self.sync_lock = threading.Lock()

        def run(self) -> None:
            consumer = ck.Consumer(_conf_of(settings))
            try:
                if partitions is not None:
                    # explicit assignment: tolerate transient metadata (topic
                    # mid-creation); consumption starts once leaders resolve
                    parts = partitions
                else:
                    md = consumer.list_topics(topic)
                    tmeta = (
                        md.topics.get(topic) if hasattr(md.topics, "get") else None
                    )
                    terr = getattr(tmeta, "error", None)
                    if tmeta is None or terr or not getattr(tmeta, "partitions", None):
                        raise RuntimeError(
                            f"kafka topic {topic!r} unavailable: "
                            f"{terr or 'unknown topic / no partitions'}"
                        )
                    parts = sorted(tmeta.partitions.keys())
                parts = [p for p in parts if p % self.n_workers == self.worker]
                if not parts:
                    return  # more workers than partitions: this slice is empty
                # fresh partitions start at OFFSET_BEGINNING (an absolute 0
                # can be out of retention range and silently jump to the log
                # end via auto.offset.reset)
                begin = getattr(ck, "OFFSET_BEGINNING", 0)
                consumer.assign(
                    [
                        ck.TopicPartition(topic, p, self._offsets.get(p, begin))
                        for p in parts
                    ]
                )
                ends: dict[int, int] | None = None
                if mode == "static":
                    ends = {}
                    for p in parts:
                        _lo, hi = consumer.get_watermark_offsets(
                            ck.TopicPartition(topic, p)
                        )
                        ends[p] = hi
                while not self._stop:
                    msg = consumer.poll(poll_interval)
                    if msg is None:
                        if ends is not None and all(
                            self._offsets.get(p, 0) >= ends[p] for p in parts
                        ):
                            return
                        continue
                    err = msg.error()
                    if err is not None:
                        # partition-EOF events are benign position markers;
                        # anything else (auth, unknown topic, broker down) must
                        # surface through the connector error channel, not spin
                        eof = getattr(
                            getattr(ck, "KafkaError", None), "_PARTITION_EOF", None
                        )
                        if eof is not None and getattr(err, "code", lambda: None)() == eof:
                            continue
                        raise RuntimeError(f"kafka consumer error: {err}")
                    with self.sync_lock:
                        assert self._node is not None
                        self._node.push_many(
                            (
                                _kafka_event_key(
                                    self, topic, msg.partition(), msg.offset(), j, ev.values
                                ),
                                # Debezium tombstones: pk-keyed valueless event
                                # — upsert sessions delete, native sessions
                                # drop it (the op:"d" envelope already
                                # retracted the row)
                                None if ev.tombstone else ev.values,
                                ev.diff,
                            )
                            for j, ev in enumerate(
                                the_parser.parse(
                                    RawMessage(
                                        value=msg.value(),
                                        key=msg.key(),
                                        metadata={"partition": msg.partition()},
                                    )
                                )
                            )
                        )
                        self._offsets[msg.partition()] = msg.offset() + 1
                    if ends is not None and all(
                        self._offsets.get(p, 0) >= ends[p] for p in parts
                    ):
                        return
            finally:
                consumer.close()

        # persistence contract (OffsetAntichain analogue + Reader::seek).
        # The sequential row-key counter travels with the offsets: a restart
        # that replays N logged events but reset _seq would hand the next
        # live messages the SAME row keys the replayed events already own.
        def offset_state(self) -> dict:
            return {"partitions": dict(self._offsets), "seq": self._seq}

        def seek(self, state: dict) -> None:
            if "partitions" in state:
                self._offsets = {
                    int(k): int(v) for k, v in state["partitions"].items()
                }
                self._seq = int(state.get("seq", 0))
            else:  # legacy bare partition map
                self._offsets = {int(k): int(v) for k, v in state.items()}

        def on_stop(self) -> None:
            self._stop = True

    return py_read_partitioned(
        lambda w, n: _RealKafkaSubject(w, n),
        schema=schema,
        name=name or f"kafka:{topic}",
        service_class=service_class,
    )


def read(
    broker: MockKafkaBroker | dict,
    topic: str,
    *,
    schema: schema_mod.SchemaMetaclass | None = None,
    format: str = "json",  # noqa: A002
    mode: str = "streaming",
    parser: Parser | None = None,
    partitions: list[int] | None = None,
    poll_interval: float = 0.05,
    autocommit_duration_ms: int | None = None,
    name: str | None = None,
    service_class: str = "interactive",
    **kwargs: Any,
) -> Table:
    """Consume ``topic`` into a table. ``mode="static"`` drains the current log
    then finishes; ``"streaming"`` keeps tailing until the run is stopped."""
    if schema is None:
        if format in ("plaintext", "raw"):
            schema = schema_mod.schema_from_types(data=str)
        elif format == "binary":
            schema = schema_mod.schema_from_types(data=bytes)
        else:
            raise ValueError("schema required for json/csv kafka formats")
    the_parser = parser or parser_for(format, schema)
    if isinstance(broker, dict):
        return _read_real(
            broker, topic, schema, the_parser, mode, partitions, poll_interval, name,
            service_class=service_class,
        )

    from pathway_tpu_torch.io.python import (
        ConnectorSubject,
        read_partitioned as py_read_partitioned,
    )

    class _KafkaSubject(ConnectorSubject):
        """One worker's slice of the topic. ``worker``/``n_workers`` pick the
        partition subset (``p % n_workers == worker``); under a single-worker
        runtime the subject owns every partition."""

        def __init__(self, worker: int = 0, n_workers: int = 1) -> None:
            super().__init__()
            self.worker = worker
            self.n_workers = n_workers
            self._stop = False
            self._offsets: dict[int, int] = {}
            # push-batch + offset-advance are atomic under this lock so a
            # persistence flush always sees offsets matching the pushed events
            self.sync_lock = threading.Lock()

        def _my_parts(self) -> list[int]:
            parts = partitions
            if parts is None:
                parts = list(range(max(1, broker.partitions(topic))))
            return [p for p in parts if p % self.n_workers == self.worker]

        def run(self) -> None:
            while not self._stop:
                progressed = False
                for p in self._my_parts():
                    off = self._offsets.get(p, 0)
                    msgs = broker.fetch(topic, p, off)
                    if not msgs:
                        continue
                    progressed = True
                    with self.sync_lock:
                        events = []
                        for i, (key, value) in enumerate(msgs):
                            for j, ev in enumerate(
                                the_parser.parse(
                                    RawMessage(value=value, key=key, metadata={"partition": p})
                                )
                            ):
                                events.append(
                                    (
                                        _kafka_event_key(
                                            self, topic, p, off + i, j, ev.values
                                        ),
                                        # tombstone → valueless keyed event
                                        # (upsert deletes, native drops)
                                        None if ev.tombstone else ev.values,
                                        ev.diff,
                                    )
                                )
                        assert self._node is not None
                        self._node.push_many(events)
                        self._offsets[p] = off + len(msgs)
                if not progressed:
                    if mode == "static":
                        return
                    _time.sleep(poll_interval)

        # ---- persistence contract (the per-source OffsetAntichain analogue,
        # src/persistence/frontier.rs:12 + Reader::seek). _seq travels with
        # the offsets so restarted live messages never reuse replayed keys ----
        def offset_state(self) -> dict:
            return {"partitions": dict(self._offsets), "seq": self._seq}

        def seek(self, state: dict) -> None:
            if "partitions" in state:
                self._offsets = {
                    int(k): int(v) for k, v in state["partitions"].items()
                }
                self._seq = int(state.get("seq", 0))
            else:  # legacy bare partition map
                self._offsets = {int(k): int(v) for k, v in state.items()}

        def on_stop(self) -> None:
            self._stop = True

    return py_read_partitioned(
        lambda w, n: _KafkaSubject(w, n),
        schema=schema,
        name=name or f"kafka:{topic}",
        service_class=service_class,
    )


def write(
    table: Table,
    broker: MockKafkaBroker | dict,
    topic: str,
    *,
    format: str = "json",  # noqa: A002
    formatter: Formatter | None = None,
    key_column: str | None = None,
    delivery: str | None = None,
    partitions: int = 1,
    **kwargs: Any,
) -> None:
    """Produce every output diff of ``table`` to ``topic``.

    ``delivery="exactly_once"`` (or ``PATHWAY_DELIVERY=exactly_once``) routes
    rows through the durable delivery ledger: staged per epoch, frozen at
    operator-snapshot recovery points, and published transactionally (real
    clients with ``transactional.id``) or with ``(sink, epoch, partition,
    seq)`` dedupe headers that ``delivery.read_committed`` consumers drop —
    byte-identical downstream state across SIGKILL/restart/rescale.
    ``partitions`` spreads delivery output across mock-broker partitions by a
    stable hash of the message key."""
    from pathway_tpu_torch.engine import operators as ops
    from pathway_tpu_torch.internals.logical import LogicalNode

    cols = table.column_names()
    fmt = formatter or formatter_for(format, cols, **kwargs)
    key_idx = cols.index(key_column) if key_column else None

    from pathway_tpu_torch import delivery as _delivery

    if _delivery.resolve_mode(delivery) == "exactly_once":
        n_parts = max(1, partitions)
        if not isinstance(broker, dict):
            broker.create_topic(topic, n_parts)
        transport = _delivery.KafkaDeliveryTransport(broker, topic)
        writer = _delivery.LedgerWriter(f"kafka.{topic}", transport)

        def on_batch_ledger(batch, columns) -> None:
            for key, diff, row in batch.rows():
                payload = fmt.format(int(key), row, batch.time, diff)
                if isinstance(payload, bytes):
                    payload = payload.decode(errors="replace")
                mkey = str(row[key_idx]) if key_idx is not None else None
                writer.append(
                    _delivery.stable_partition(mkey, n_parts), (mkey, payload)
                )

        def _ledger_node():
            node = ops.CallbackOutputNode(
                cols,
                on_batch_ledger,
                sink_state=writer.sink_state,
                restore_sink=writer.restore_sink,
            )
            # the persistence plane scans for this attribute to bind the
            # writer's ledger at graph build (snapshots._bind_delivery)
            node.delivery_writer = writer
            return node

        LogicalNode(
            _ledger_node, [table._node], name=f"kafka_write:{topic}"
        )._register_as_output()
        return

    if isinstance(broker, dict):
        # wire-protocol producer (reference KafkaWriter, data_storage.rs:1406)
        ck = _client_module(broker)
        producer = ck.Producer(_conf_of(broker))

        def on_batch(batch, columns) -> None:
            for key, diff, row in batch.rows():
                payload = fmt.format(int(key), row, batch.time, diff)
                mkey = str(row[key_idx]) if key_idx is not None else None
                producer.produce(topic, value=payload, key=mkey)
            producer.flush()

    else:
        broker.create_topic(topic, 1)

        def on_batch(batch, columns) -> None:
            for key, diff, row in batch.rows():
                payload = fmt.format(int(key), row, batch.time, diff)
                mkey = str(row[key_idx]) if key_idx is not None else None
                broker.produce(topic, payload, key=mkey)

    LogicalNode(
        lambda: ops.CallbackOutputNode(cols, on_batch),
        [table._node],
        name=f"kafka_write:{topic}",
    )._register_as_output()
