"""I/O connectors (reference ``python/pathway/io/``): the Python connector,
the filesystem connector with its csv, jsonlines and plaintext forms, the
null sink, ``subscribe``, the HTTP connector with the REST serving plane
(``http``), the Kafka connector over its partitioned mock broker (``kafka``,
alias ``redpanda``: partition-per-worker reads for the multi-worker
runtimes; a real broker needs a confluent-kafka-shaped client), S3 and its
MinIO and CSV forms (``s3``, ``minio``, ``s3_csv``; the client is injected
through ``AwsS3Settings(client=...)`` where ``boto3`` is absent) and
Postgres (``postgres``, a DBAPI connection or the in-process fake), and
Debezium change streams over Kafka (``debezium``). The other connectors are
a later slice.
"""

from pathway_tpu_torch.io import (
    csv, debezium, fs, http, jsonlines, kafka, minio, null, plaintext, postgres, python, s3, s3_csv,
)
from pathway_tpu_torch.io import kafka as redpanda  # reference alias: io/redpanda = io/kafka
from pathway_tpu_torch.io._subscribe import subscribe

__all__ = [
    "csv",
    "debezium",
    "fs",
    "http",
    "jsonlines",
    "kafka",
    "minio",
    "null",
    "plaintext",
    "postgres",
    "python",
    "redpanda",
    "s3",
    "s3_csv",
    "subscribe",
]
