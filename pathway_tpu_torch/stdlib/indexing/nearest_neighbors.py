"""KNN inner indexes (reference ``stdlib/indexing/nearest_neighbors.py:65-262``).

``BruteForceKnn``: the ``[N, d]`` matrix lives on the card, search is one
matmul + the canonical top-k (``pathway_tpu_torch/ops/knn.py``). Carried from
``pathway_tpu/stdlib/indexing/nearest_neighbors.py``; the approximate indexes
(LSH, IVF-flat, usearch, tiered) are a later slice.
"""

from __future__ import annotations

import enum

from pathway_tpu_torch.internals.expression import ColumnExpression, ColumnReference
from pathway_tpu_torch.stdlib.indexing._engine import VectorBackend
from pathway_tpu_torch.stdlib.indexing.data_index import InnerIndex


class DistanceMetric(enum.Enum):
    COS = "cos"
    L2SQ = "l2sq"
    DOT = "dot"


def _embedder_transform(embedder):
    """Wrap a text column into vectors via the embedder UDF (batched at the UDF
    layer — ops/microbatch.py — not per row like the reference)."""
    if embedder is None:
        return None

    def transform(table, expr):
        return embedder(expr)

    return transform


class BruteForceKnn(InnerIndex):
    def __init__(
        self,
        data_column: ColumnReference,
        dimensions: int,
        *,
        reserved_space: int = 1024,
        metric: DistanceMetric | str = DistanceMetric.COS,
        metadata_column: ColumnExpression | None = None,
        embedder=None,
        device=None,
    ):
        metric_val = metric.value if isinstance(metric, DistanceMetric) else str(metric)
        transform = _embedder_transform(embedder)
        super().__init__(
            data_column,
            metadata_column=metadata_column,
            backend_factory=lambda: VectorBackend(
                dimension=dimensions,
                metric=metric_val,
                reserved_space=reserved_space,
                device=device,
            ),
            item_transform=transform,
        )
        self.dimensions = dimensions
        self.metric = metric_val
