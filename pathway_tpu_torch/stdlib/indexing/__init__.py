"""Indexing stdlib (reference ``python/pathway/stdlib/indexing/``): the
brute-force KNN inner index, DataIndex payload joins and the brute-force
retriever factory.

The index matrix lives on the card and search is one matmul + the canonical
top-k (``pathway_tpu_torch/ops/knn.py``). The BM25, hybrid, LSH, IVF-flat,
usearch and tiered indexes are a later slice.
"""

from pathway_tpu_torch.stdlib.indexing.data_index import DataIndex, InnerIndex, _SCORE
from pathway_tpu_torch.stdlib.indexing.nearest_neighbors import BruteForceKnn, DistanceMetric
from pathway_tpu_torch.stdlib.indexing.retrievers import (
    AbstractRetrieverFactory,
    BruteForceKnnFactory,
)

__all__ = [
    "AbstractRetrieverFactory",
    "BruteForceKnn",
    "BruteForceKnnFactory",
    "DataIndex",
    "DistanceMetric",
    "InnerIndex",
]
