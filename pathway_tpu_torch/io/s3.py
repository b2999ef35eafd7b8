"""S3 / object-store connector (reference: ``scanner/s3.rs`` +
``python/pathway/io/s3``).

Real read/write logic over a boto3-style client: bucket listing with
pagination, per-object etag change tracking (the reference's metadata
trackers), Parser-layer decoding, and a block writer producing one object per
output batch. The client is resolved from ``boto3`` when importable; since
this image has neither boto3 nor egress, ``AwsS3Settings(client=...)`` (or
``read(..., client=...)``) injects any object with the same surface —
``tests/test_gated_connectors.py`` drives every path against a dict-backed
fake, so the connector logic is exercised in CI even where the real client
cannot be."""

from __future__ import annotations

import json as _json
import time as _time
from typing import Any

from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals.table import Table, table_from_static_data


class AwsS3Settings:
    def __init__(
        self,
        bucket_name: str | None = None,
        access_key: str | None = None,
        secret_access_key: str | None = None,
        region: str | None = None,
        endpoint: str | None = None,
        with_path_style: bool = False,
        *,
        client: Any = None,
    ):
        self.bucket_name = bucket_name
        self.access_key = access_key
        self.secret_access_key = secret_access_key
        self.region = region
        self.endpoint = endpoint
        self.with_path_style = with_path_style
        #: dependency-injection hook: any boto3-client-shaped object
        self.client = client


def _make_client(settings: AwsS3Settings | None, client: Any = None) -> Any:
    if client is not None:
        return client
    if settings is not None and settings.client is not None:
        return settings.client
    try:
        import boto3
    except ImportError:
        raise NotImplementedError(
            "pw.io.s3 requires boto3 (or an injected client=), neither of "
            "which is available in this environment"
        ) from None
    kwargs: dict[str, Any] = {}
    if settings is not None:
        if settings.region:
            kwargs["region_name"] = settings.region
        if settings.endpoint:
            kwargs["endpoint_url"] = settings.endpoint
        if settings.access_key:
            kwargs["aws_access_key_id"] = settings.access_key
        if settings.secret_access_key:
            kwargs["aws_secret_access_key"] = settings.secret_access_key
        if settings.with_path_style:
            from botocore.config import Config as _BotoConfig

            kwargs["config"] = _BotoConfig(s3={"addressing_style": "path"})
    return boto3.client("s3", **kwargs)


def _split_path(path: str, settings: AwsS3Settings | None) -> tuple[str, str]:
    if path.startswith("s3://"):
        rest = path[len("s3://") :]
        bucket, _, prefix = rest.partition("/")
        return bucket, prefix
    if settings is None or not settings.bucket_name:
        raise ValueError("provide an s3://bucket/prefix path or bucket_name settings")
    return settings.bucket_name, path.lstrip("/")


def _list_objects(client, bucket: str, prefix: str) -> list[tuple[str, str]]:
    """All (key, etag) pairs under ``prefix``, following continuation tokens."""
    out: list[tuple[str, str]] = []
    token: str | None = None
    while True:
        kw: dict[str, Any] = {"Bucket": bucket, "Prefix": prefix}
        if token:
            kw["ContinuationToken"] = token
        resp = client.list_objects_v2(**kw)
        for obj in resp.get("Contents", []):
            out.append((obj["Key"], obj.get("ETag", "")))
        if not resp.get("IsTruncated"):
            break
        token = resp.get("NextContinuationToken")
    return sorted(out)


def _fetch_object(client, bucket: str, key: str) -> bytes | None:
    """Object bytes, or None when the object vanished between listing and
    fetch (the one failure that is an expected race, not an error)."""
    try:
        return client.get_object(Bucket=bucket, Key=key)["Body"].read()
    except Exception:
        return None


def _object_rows(
    client, bucket: str, key: str, fmt: str, schema: schema_mod.SchemaMetaclass
) -> list[tuple]:
    from pathway_tpu_torch.io._format import rows_from_bytes

    body = client.get_object(Bucket=bucket, Key=key)["Body"].read()
    return rows_from_bytes(body, fmt, schema)


def read(
    path: str,
    aws_s3_settings: AwsS3Settings | None = None,
    *,
    format: str = "json",  # noqa: A002
    schema: schema_mod.SchemaMetaclass | None = None,
    mode: str = "streaming",
    client: Any = None,
    name: str | None = None,
    **kwargs: Any,
) -> Table:
    """Read objects under an S3 prefix. ``static`` parses the current listing
    once; ``streaming`` polls the listing and ingests new/changed objects
    (etag-tracked) from a connector thread."""
    if schema is None:
        if format in ("plaintext", "plaintext_by_object"):
            schema = schema_mod.schema_from_types(data=str)
        elif format == "binary":
            schema = schema_mod.schema_from_types(data=bytes)
        else:
            raise ValueError("schema required for csv/json formats")
    cli = _make_client(aws_s3_settings, client)
    bucket, prefix = _split_path(path, aws_s3_settings)

    if mode == "static":
        from pathway_tpu_torch.io.fs import _keys_for

        all_rows: list[tuple] = []
        for key, _etag in _list_objects(cli, bucket, prefix):
            all_rows.extend(_object_rows(cli, bucket, key, format, schema))
        keys = _keys_for(all_rows, schema, salt=hash(path) & 0xFFFF)
        return table_from_static_data(keys, all_rows, schema)

    from pathway_tpu_torch.io.python import ConnectorSubject, read as py_read

    fmt = format

    class _S3Subject(ConnectorSubject):
        def __init__(self) -> None:
            super().__init__()
            self._seen: dict[str, str] = {}
            # object key -> [(row_key, values)] currently live downstream, so
            # overwrites and deletions retract the previous version's rows
            # (the reference's metadata trackers, scanner/s3.rs)
            self._emitted: dict[str, list] = {}
            self._stop = False
            self._bounded = kwargs.get("_bounded", False)

        def _retract(self, obj_key: str) -> None:
            old = self._emitted.pop(obj_key, None)
            if old:
                assert self._node is not None
                self._node.push_many((k, v, -1) for k, v in old)

        def run(self) -> None:
            while not self._stop:
                found = False
                listing = _list_objects(cli, bucket, prefix)
                live = {key for key, _ in listing}
                for gone in [k for k in self._seen if k not in live]:
                    found = True
                    del self._seen[gone]
                    self._retract(gone)
                for key, etag in listing:
                    if self._seen.get(key) == etag:
                        continue
                    changed = key in self._seen
                    self._seen[key] = etag
                    found = True
                    if changed:  # full-object replacement: out with the old
                        self._retract(key)
                    body = _fetch_object(cli, bucket, key)
                    if body is None:
                        # deleted between listing and fetch: the next poll's
                        # listing will treat it as gone and retract
                        self._seen.pop(key, None)
                        continue
                    # parse errors are real errors: they surface through the
                    # connector error channel, not silent re-poll loops
                    from pathway_tpu_torch.io._format import rows_from_bytes

                    values = rows_from_bytes(body, fmt, schema)
                    row_keys_ = self._keys_for(values)
                    assert self._node is not None
                    pairs = [(int(k), v) for k, v in zip(row_keys_, values)]
                    self._node.push_many((k, v, 1) for k, v in pairs)
                    self._emitted[key] = pairs
                if self._bounded and not found:
                    return
                _time.sleep(0.1)

        def on_stop(self) -> None:
            self._stop = True

    return py_read(_S3Subject(), schema=schema, name=name or f"s3:{bucket}/{prefix}")


def write(
    table: Table,
    path: str,
    aws_s3_settings: AwsS3Settings | None = None,
    *,
    format: str = "json",  # noqa: A002
    client: Any = None,
    **kwargs: Any,
) -> None:
    """Write output diffs as one object per batch under ``path`` (the
    data-lake block-writer shape, ``data_lake/writer.rs``): jsonlines records
    carrying ``time``/``diff`` columns."""
    if format not in ("json", "jsonlines"):
        raise ValueError("s3 write supports jsonlines output")
    cli = _make_client(aws_s3_settings, client)
    bucket, prefix = _split_path(path, aws_s3_settings)
    cols = table.column_names()
    counter = {"n": None}

    def on_batch(batch, columns) -> None:
        lines = []
        for _key, diff, row in batch.rows():
            rec = dict(zip(cols, row))
            rec["time"] = batch.time
            rec["diff"] = diff
            lines.append(_json.dumps(rec, default=str))
        if not lines:
            return
        if counter["n"] is None:
            # resume past existing blocks: a restarted run must append, not
            # clobber the previous run's output objects
            existing = [
                k
                for k, _ in _list_objects(cli, bucket, prefix.rstrip("/") + "/block_")
            ]
            indices = []
            for k in existing:
                stem = k.rsplit("block_", 1)[-1].split(".")[0]
                if stem.isdigit():
                    indices.append(int(stem))
            counter["n"] = (max(indices) + 1) if indices else 0
        key = f"{prefix.rstrip('/')}/block_{counter['n']:08d}.jsonl"
        counter["n"] += 1
        cli.put_object(Bucket=bucket, Key=key, Body=("\n".join(lines) + "\n").encode())

    from pathway_tpu_torch.engine import operators as ops
    from pathway_tpu_torch.internals.logical import LogicalNode

    LogicalNode(
        lambda: ops.CallbackOutputNode(cols, on_batch),
        [table._node],
        name=f"s3_write:{bucket}/{prefix}",
    )._register_as_output()


def read_from_azure(*args: Any, **kwargs: Any):
    raise NotImplementedError(
        "pw.io.s3.read_from_azure requires the Azure SDK, which is not "
        "available in this environment"
    )
