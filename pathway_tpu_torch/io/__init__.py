"""I/O connectors (reference ``python/pathway/io/``): the Python connector,
the filesystem connector with its csv, jsonlines and plaintext forms, the
null sink and ``subscribe``. The other connectors (kafka, http, s3, ...) are a
later slice.
"""

from pathway_tpu_torch.io import csv, fs, jsonlines, null, plaintext, python
from pathway_tpu_torch.io._subscribe import subscribe

__all__ = ["csv", "fs", "jsonlines", "null", "plaintext", "python", "subscribe"]
