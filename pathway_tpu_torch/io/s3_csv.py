"""CSV-over-S3 (reference ``python/pathway/io/s3_csv``): ``pw.io.s3.read``
with ``format="csv"`` pre-bound."""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.io import s3 as _s3


def read(path: str, aws_s3_settings: Any = None, **kwargs: Any):
    kwargs.setdefault("format", "csv")
    return _s3.read(path, aws_s3_settings, **kwargs)
