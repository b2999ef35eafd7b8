"""Reductions whose rounding does not depend on the batch.

A torch reduction kernel picks its launch configuration (how the reduced
dimension is split over threads and blocks) from the tensor's shape, and with
it the order of the adds: on the H100 the same row sums to other bits in a
batch of 8 rows than in a batch of 512. Elementwise adds round each pair the
same way whatever the shape, so a sum built from them in one fixed order
gives a row the same bits in any batch. The cross-tick microbatcher relies on
that: it changes launch shapes, never values.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def fixed_order_sum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``x.sum(dim)`` in ``x``'s dtype, in one fixed pairwise order of
    elementwise adds: the dimension is zero-padded to a power of two, then
    halved (first half + second half) until one element is left."""
    x = x.movedim(dim, -1)
    width = 1 << max(0, x.shape[-1] - 1).bit_length()
    if width != x.shape[-1]:
        x = F.pad(x, (0, width - x.shape[-1]))
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] + x[..., half:]
    return x[..., 0]
