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

Carried from ``pathway_tpu/delivery/transports.py``: the fs transport whole.
The Kafka and Postgres transports (and ``read_committed``, the Kafka
consumer's view) need the ``io.kafka`` and ``io.postgres`` connectors, which
are a later slice: building one raises ``later_slice``.
"""

from __future__ import annotations

import json as _json
import os
import zlib as _zlib
from typing import Any

from pathway_tpu_torch.internals.later_slice import later_slice

#: single control topic carrying per-sink epoch commit markers (partition 0)
KAFKA_CONTROL_TOPIC = "__pathway_delivery"

#: commit-marker table every exactly-once postgres sink shares
PG_COMMIT_TABLE = "pathway_delivery"


def stable_partition(key: str | None, n: int) -> int:
    """Deterministic partition for a message key — ``hash()`` is salted per
    process, which would re-shuffle partitions across a restart and break the
    frozen-bytes contract."""
    if n <= 1 or key is None:
        return 0
    return _zlib.crc32(key.encode()) % n


class KafkaDeliveryTransport:
    """Publishes ledger epochs to Kafka (reference: a transactional producer,
    or ``(sink_id, epoch, partition, seq)`` dedupe headers plus a commit
    marker on ``KAFKA_CONTROL_TOPIC``). Needs ``io.kafka``: a later slice."""

    def __init__(self, broker, topic: str):
        raise later_slice("io.kafka")


def read_committed(broker, topic: str) -> tuple[list[tuple[Any, Any]], dict]:
    """Consumer-side view of an exactly-once Kafka topic (reference: only
    marker-covered epochs, header duplicates dropped). Needs ``io.kafka``."""
    raise later_slice("io.kafka")


class PostgresDeliveryTransport:
    """Publishes ledger epochs as one DBAPI transaction each, with a
    ``pathway_delivery`` marker row (reference). Needs ``io.postgres``: a
    later slice."""

    def __init__(self, settings: dict, statements: dict[str, str]):
        raise later_slice("io.postgres")


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
