"""I/O connectors (reference ``python/pathway/io/``): the Python connector,
the filesystem connector with its csv, jsonlines and plaintext forms, the
null sink, ``subscribe`` and the HTTP connector with the REST serving plane
(``http``). The other connectors (kafka, s3, ...) are a later slice.
"""

from pathway_tpu_torch.io import csv, fs, http, jsonlines, null, plaintext, python
from pathway_tpu_torch.io._subscribe import subscribe

__all__ = ["csv", "fs", "http", "jsonlines", "null", "plaintext", "python", "subscribe"]
