"""Dataset download helpers (reference: ``stdlib/ml/datasets/``). Fetching
needs network access and is refused; local files load. Carried from
``pathway_tpu/stdlib/ml/datasets.py``."""

from __future__ import annotations

import os


def load_lsh_test_data(path: str | None = None):
    if path and os.path.exists(path):
        import numpy as np

        return np.load(path)
    raise NotImplementedError(
        "dataset download requires network access; pass a local path instead"
    )
