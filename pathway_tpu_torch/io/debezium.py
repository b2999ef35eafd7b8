"""Debezium CDC connector (reference: ``python/pathway/io/debezium`` over
``DebeziumMessageParser``, ``src/connectors/data_format.rs:1433``).

Consumes Debezium change envelopes from a Kafka topic; ``op`` c/r/u/d become
insert/retract deltas keyed by the schema's primary keys. Envelopes arrive
with or without the Connect schema block, and null-payload log-compaction
tombstones parse into keyed deletes (``tombstones=True``, the default here —
harmless for the default diff-native session, which drops the valueless
event because the ``op: d`` envelope already retracted the row)."""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io import kafka as _kafka
from pathway_tpu_torch.io._format import DebeziumMessageParser


def read(
    broker: Any,
    topic: str,
    *,
    schema: schema_mod.SchemaMetaclass,
    mode: str = "streaming",
    name: str | None = None,
    tombstones: bool = True,
    **kwargs: Any,
) -> Table:
    if not schema.primary_key_columns():
        raise ValueError("debezium streams require a schema with primary keys")
    return _kafka.read(
        broker,
        topic,
        schema=schema,
        parser=DebeziumMessageParser(schema, tombstones=tombstones),
        format="debezium",
        mode=mode,
        name=name or f"debezium:{topic}",
        **kwargs,
    )
