"""Elasticsearch writer (reference: ``ElasticSearchWriter``
``src/connectors/data_storage.rs:1479``). Each positive diff indexes the row as a
JSON document; retractions delete by id. Requires the ``elasticsearch`` client
(an optional dependency; import-gated)."""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.engine import operators as ops
from pathway_tpu_torch.internals.logical import LogicalNode
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io._format import _plain


def write(
    table: Table,
    host: str,
    auth: Any = None,
    index_name: str = "pathway",
    **kwargs: Any,
) -> None:
    try:
        from elasticsearch import Elasticsearch
    except ImportError:
        raise NotImplementedError(
            "pw.io.elasticsearch requires the elasticsearch client, which is not "
            "available in this environment"
        ) from None

    client = Elasticsearch(host, basic_auth=auth, **kwargs.get("client_kwargs", {}))
    cols = table.column_names()

    def on_batch(batch, columns) -> None:
        for key, diff, row in batch.rows():
            doc_id = str(int(key))
            if diff > 0:
                client.index(
                    index=index_name,
                    id=doc_id,
                    document={c: _plain(v) for c, v in zip(columns, row)},
                )
            else:
                client.delete(index=index_name, id=doc_id, ignore=[404])

    LogicalNode(
        lambda: ops.CallbackOutputNode(cols, on_batch),
        [table._node],
        name=f"elasticsearch_write:{index_name}",
    )._register_as_output()
