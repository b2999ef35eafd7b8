"""CSV connector (reference: ``python/pathway/io/csv``)."""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.io import fs


def read(path: str, *, schema=None, mode: str = "streaming", **kwargs: Any):
    return fs.read(path, format="csv", schema=schema, mode=mode, **kwargs)


def write(table, filename: str, **kwargs: Any) -> None:
    fs.write(table, filename, format="csv", **kwargs)
