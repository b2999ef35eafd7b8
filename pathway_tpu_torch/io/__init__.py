"""I/O connectors (reference ``python/pathway/io/``; carried from
``pathway_tpu/io/``, whose list and order ``__all__`` keeps). Each module
wires its source or sink engine nodes directly.

- Files: ``fs`` with its ``csv``, ``jsonlines`` and ``plaintext`` forms,
  ``pyfilesystem`` (any fs-shaped object), ``s3``, ``minio`` and ``s3_csv``
  (the client injected through ``AwsS3Settings(client=...)`` where ``boto3``
  is absent), ``gdrive`` (an injected ``client=`` transport, else the Google
  client libraries), ``deltalake`` and ``iceberg`` (the open table formats
  over ``pyarrow``; Iceberg's manifests through the port's own Avro codec).
- Databases and change streams: ``sqlite`` (static snapshot, or upserts by
  primary key polled on ``PRAGMA data_version``), ``postgres`` (a DBAPI
  connection or the in-process fake), ``debezium`` over Kafka, and the
  client-gated writers ``mongodb``, ``elasticsearch`` and ``bigquery``.
- Message buses: ``kafka`` (alias ``redpanda``), ``nats`` (an injected
  ``client_factory`` or ``nats-py``), ``pubsub`` (a publisher-shaped
  object), ``logstash`` (HTTP, stdlib only), ``slack`` (``send_alerts``;
  ``requests`` unless a transport is injected) and ``airbyte`` (a local
  executable speaking the Airbyte protocol; docker and remote runs gate).
- ``python`` (subjects), ``http`` (the REST serving plane), ``null`` and
  ``subscribe``.
"""

from pathway_tpu_torch.io import (
    airbyte,
    bigquery,
    csv,
    debezium,
    deltalake,
    elasticsearch,
    fs,
    gdrive,
    http,
    iceberg,
    jsonlines,
    kafka,
    logstash,
    minio,
    mongodb,
    nats,
    plaintext,
    postgres,
    pubsub,
    pyfilesystem,
    python,
    s3,
    s3_csv,
    slack,
    sqlite,
)
from pathway_tpu_torch.io import kafka as redpanda  # reference alias: io/redpanda = io/kafka
from pathway_tpu_torch.io._subscribe import subscribe

__all__ = [
    "airbyte",
    "bigquery",
    "csv",
    "debezium",
    "deltalake",
    "elasticsearch",
    "fs",
    "gdrive",
    "http",
    "iceberg",
    "jsonlines",
    "kafka",
    "logstash",
    "minio",
    "mongodb",
    "nats",
    "plaintext",
    "postgres",
    "pubsub",
    "pyfilesystem",
    "python",
    "redpanda",
    "s3",
    "s3_csv",
    "slack",
    "sqlite",
    "subscribe",
    "null",
]

from pathway_tpu_torch.io import null  # noqa: E402
