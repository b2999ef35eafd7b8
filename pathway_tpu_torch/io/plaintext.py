"""Plaintext connector (reference: ``python/pathway/io/plaintext``)."""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.io import fs


def read(path: str, *, mode: str = "streaming", **kwargs: Any):
    return fs.read(path, format="plaintext", mode=mode, **kwargs)
