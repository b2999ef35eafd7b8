"""Google Pub/Sub writer (reference ``python/pathway/io/pubsub``).

The reference's own API takes a configured ``pubsub_v1.PublisherClient``
object — client injection is the design, so the connector runs against any
publisher-shaped object (``topic_path`` + ``publish`` returning a future-like
with ``result()``); the tests drive it with a fake.
``table`` must have exactly one binary column; each change publishes its
payload with ``pathway_time``/``pathway_diff`` attributes."""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.engine import operators as ops
from pathway_tpu_torch.internals.logical import LogicalNode
from pathway_tpu_torch.internals.table import Table


def write(
    table: Table,
    publisher: Any,
    project_id: str,
    topic_id: str,
    *,
    name: str | None = None,
    **kwargs: Any,
) -> None:
    cols = table.column_names()
    if len(cols) != 1:
        raise ValueError(
            "pw.io.pubsub.write expects a table with exactly one (binary) column"
        )
    if hasattr(publisher, "topic_path"):
        topic_path = publisher.topic_path(project_id, topic_id)
    else:
        topic_path = f"projects/{project_id}/topics/{topic_id}"

    def on_batch(batch, columns) -> None:
        futures = []
        for _key, diff, row in batch.rows():
            data = row[0]
            if isinstance(data, str):
                data = data.encode()
            elif not isinstance(data, (bytes, bytearray, memoryview)):
                raise TypeError(
                    "pw.io.pubsub.write requires a binary (bytes/str) column; "
                    f"got {type(data).__name__}"
                )
            futures.append(
                publisher.publish(
                    topic_path,
                    data=bytes(data),
                    pathway_time=str(batch.time),
                    pathway_diff=str(diff),
                )
            )
        for f in futures:  # surface publish errors in the connector channel
            if hasattr(f, "result"):
                f.result()

    LogicalNode(
        lambda: ops.CallbackOutputNode(cols, on_batch),
        [table._node],
        name=name or f"pubsub_write:{topic_id}",
    )._register_as_output()
