"""I/O connectors (reference ``python/pathway/io/``): the Python connector,
the filesystem connector with its csv, jsonlines and plaintext forms, the
null sink, ``subscribe``, the HTTP connector with the REST serving plane
(``http``) and the Kafka connector over its partitioned mock broker
(``kafka``, alias ``redpanda``: partition-per-worker reads for the
multi-worker runtimes; a real broker needs a confluent-kafka-shaped client,
and its exactly-once transport is a later slice). The other connectors (s3,
...) are a later slice.
"""

from pathway_tpu_torch.io import csv, fs, http, jsonlines, kafka, null, plaintext, python
from pathway_tpu_torch.io import kafka as redpanda  # reference alias: io/redpanda = io/kafka
from pathway_tpu_torch.io._subscribe import subscribe

__all__ = [
    "csv",
    "fs",
    "http",
    "jsonlines",
    "kafka",
    "null",
    "plaintext",
    "python",
    "redpanda",
    "subscribe",
]
