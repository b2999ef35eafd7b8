"""MongoDB writer (reference: ``MongoWriter`` ``src/connectors/data_storage.rs:1757``).
Positive diffs insert documents (with time/diff fields); retractions delete the
matching document. Requires ``pymongo`` (an optional dependency; import-gated)."""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.engine import operators as ops
from pathway_tpu_torch.internals.logical import LogicalNode
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io._format import _plain


def write(table: Table, connection_string: str, database: str, collection: str, **kwargs: Any) -> None:
    try:
        from pymongo import MongoClient
    except ImportError:
        raise NotImplementedError(
            "pw.io.mongodb requires pymongo, which is not available in this environment"
        ) from None

    coll = MongoClient(connection_string)[database][collection]
    cols = table.column_names()

    def on_batch(batch, columns) -> None:
        for key, diff, row in batch.rows():
            doc = {c: _plain(v) for c, v in zip(columns, row)}
            if diff > 0:
                doc["_pw_key"] = str(int(key))
                doc["time"] = batch.time
                coll.insert_one(doc)
            else:
                coll.delete_one({"_pw_key": str(int(key))})

    LogicalNode(
        lambda: ops.CallbackOutputNode(cols, on_batch),
        [table._node],
        name=f"mongodb:{database}.{collection}",
    )._register_as_output()
