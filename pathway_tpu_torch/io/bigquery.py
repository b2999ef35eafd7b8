"""BigQuery writer (reference: ``python/pathway/io/bigquery``). Streams output
diffs into a BigQuery table via the insert-rows API, carrying time/diff columns."""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.engine import operators as ops
from pathway_tpu_torch.internals.logical import LogicalNode
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io._format import _plain


def write(
    table: Table,
    dataset_name: str,
    table_name: str,
    service_user_credentials_file: str | None = None,
    **kwargs: Any,
) -> None:
    try:
        from google.cloud import bigquery
    except ImportError:
        raise NotImplementedError(
            "pw.io.bigquery requires google-cloud-bigquery"
        ) from None

    if service_user_credentials_file is not None:
        client = bigquery.Client.from_service_account_json(service_user_credentials_file)
    else:
        client = bigquery.Client()
    ref = f"{dataset_name}.{table_name}"
    cols = table.column_names()

    def on_batch(batch, columns) -> None:
        rows = []
        for _key, diff, row in batch.rows():
            rec = {c: _plain(v) for c, v in zip(columns, row)}
            rec["time"] = batch.time
            rec["diff"] = diff
            rows.append(rec)
        if rows:
            errors = client.insert_rows_json(ref, rows)
            if errors:
                raise RuntimeError(f"bigquery insert failed: {errors}")

    LogicalNode(
        lambda: ops.CallbackOutputNode(cols, on_batch),
        [table._node],
        name=f"bigquery_write:{ref}",
    )._register_as_output()
