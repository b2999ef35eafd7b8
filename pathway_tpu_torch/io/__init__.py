"""I/O connectors (reference ``python/pathway/io/``): the Python connector and
``subscribe``. The other connectors (fs, csv, jsonlines, kafka, http, ...) are
a later slice.
"""

from pathway_tpu_torch.io import python
from pathway_tpu_torch.io._subscribe import subscribe

__all__ = ["python", "subscribe"]
