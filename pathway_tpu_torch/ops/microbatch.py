"""Accumulate-then-launch microbatching and power-of-two padding.

Copy of the host-only core of ``pathway_tpu/ops/microbatch.py``: rows buffer
per UDF, each flush pads to the next power-of-two bucket and calls the batch
function once per bucket, and results come back in submit order. The
reference's tracing, request and device-profiling hooks belong to planes the
port does not have yet, and are left out. The row-batch cap is the
``PATHWAY_MICROBATCH_MAX_BATCH`` knob (default 512), read through
``internals/config.py`` as the reference reads it.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import numpy as np

_MIN_BUCKET = 8

#: sequence-LENGTH bucketing cap (token-id padding in the encoder/reranker):
#: not the row-batch knob, which caps how many ROWS launch together
LENGTH_MAX_BUCKET = 4096


def microbatch_max_batch() -> int:
    """Device launch chunk for microbatching (``PATHWAY_MICROBATCH_MAX_BATCH``)."""
    from pathway_tpu_torch.internals.config import get_pathway_config

    return get_pathway_config().microbatch_max_batch


def bucket_size(n: int, min_bucket: int = _MIN_BUCKET, max_bucket: int | None = None) -> int:
    """Smallest power-of-two multiple of ``min_bucket`` that is >= n, clamped
    at ``max_bucket`` (default: :func:`microbatch_max_batch`)."""
    if max_bucket is None:
        max_bucket = microbatch_max_batch()
    b = min_bucket
    while b < n and b < max_bucket:
        b *= 2
    return b


class MicrobatchDispatcher:
    """Buffer rows, flush in padded power-of-two batches.

    ``fn`` is called as ``fn(items: list) -> Sequence`` where ``len(items)`` is
    always a bucket size; entries beyond the real row count are ``pad_item``
    repeats whose results are discarded.
    """

    def __init__(
        self,
        fn: Callable[[list], Sequence],
        max_batch: int | None = None,
        min_bucket: int = _MIN_BUCKET,
        pad_item: Any = None,
    ):
        self.fn = fn
        self.max_batch = microbatch_max_batch() if max_batch is None else max_batch
        self.min_bucket = min_bucket
        self.pad_item = pad_item
        self._items: list = []

    def __len__(self) -> int:
        return len(self._items)

    def submit(self, item: Any) -> None:
        self._items.append(item)

    def flush(self, only_full: bool = False) -> list:
        """Run the batch fn over everything buffered; results in submit order.
        ``only_full=True`` launches only complete ``max_batch`` chunks and
        leaves the remainder buffered."""
        out: list = []
        while self._items and (not only_full or len(self._items) >= self.max_batch):
            chunk = self._items[: self.max_batch]
            del self._items[: self.max_batch]
            n = len(chunk)
            b = bucket_size(n, self.min_bucket, self.max_batch)
            pad = chunk[-1] if self.pad_item is None else self.pad_item
            results = self.fn(chunk + [pad] * (b - n))
            if len(results) != b:
                raise ValueError(
                    f"microbatch fn returned {len(results)} results for batch of {b}"
                )
            out.extend(results[:n])
        return out

    def map(self, items: list) -> list:
        """One-shot convenience: submit all, flush."""
        for it in items:
            self.submit(it)
        return self.flush()


def pad_ragged_2d(
    rows: list[np.ndarray], bucket_len: int | None = None, fill: float = 0
) -> tuple[np.ndarray, np.ndarray]:
    """Pad a list of 1-D arrays to [n, L] plus a bool mask, L a power-of-two
    bucket."""
    n = len(rows)
    max_len = max((len(r) for r in rows), default=1)
    L = bucket_len or bucket_size(max_len, min_bucket=16, max_bucket=LENGTH_MAX_BUCKET)
    out = np.full((n, L), fill, dtype=np.asarray(rows[0]).dtype if rows else np.int32)
    mask = np.zeros((n, L), dtype=bool)
    for i, r in enumerate(rows):
        r = np.asarray(r)[:L]
        out[i, : len(r)] = r
        mask[i, : len(r)] = True
    return out, mask
