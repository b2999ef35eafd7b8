"""Utility stdlib (reference: ``python/pathway/stdlib/utils/``).

Carried from ``pathway_tpu/stdlib/utils/__init__.py``.
"""

from pathway_tpu_torch.stdlib.utils import bucketing, col, filtering
from pathway_tpu_torch.stdlib.utils.async_transformer import AsyncTransformer
from pathway_tpu_torch.stdlib.utils.col import (
    apply_all_rows,
    groupby_reduce_majority,
    multiapply_all_rows,
    unpack_col,
)
from pathway_tpu_torch.stdlib.utils.filtering import argmax_rows, argmin_rows
from pathway_tpu_torch.stdlib.utils.pandas_transformer import pandas_transformer

__all__ = [
    "AsyncTransformer",
    "apply_all_rows",
    "argmax_rows",
    "argmin_rows",
    "bucketing",
    "col",
    "filtering",
    "groupby_reduce_majority",
    "multiapply_all_rows",
    "pandas_transformer",
    "unpack_col",
]
