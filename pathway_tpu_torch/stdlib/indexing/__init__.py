"""Indexing stdlib (reference ``python/pathway/stdlib/indexing/``): KNN / BM25 /
hybrid inner indexes, DataIndex payload joins, and retriever factories.

The index matrix lives on the card and search is one matmul + the canonical
top-k (``pathway_tpu_torch/ops/knn.py``); the tiered index keeps a bounded hot
shard there over a host IVF cold tier. Carried from
``pathway_tpu/stdlib/indexing/__init__.py`` with the same ``__all__``.
"""

from pathway_tpu_torch.stdlib.indexing.bm25 import BM25, TantivyBM25
from pathway_tpu_torch.stdlib.indexing.data_index import DataIndex, InnerIndex, _SCORE
from pathway_tpu_torch.stdlib.indexing.hybrid_index import HybridIndex
from pathway_tpu_torch.stdlib.indexing.nearest_neighbors import (
    BruteForceKnn,
    DistanceMetric,
    IvfFlatKnn,
    LshKnn,
    TieredKnn,
    UsearchKnn,
)
from pathway_tpu_torch.stdlib.indexing.retrievers import (
    AbstractRetrieverFactory,
    BruteForceKnnFactory,
    HybridIndexFactory,
    IvfFlatKnnFactory,
    LshKnnFactory,
    TantivyBM25Factory,
    TieredKnnFactory,
    UsearchKnnFactory,
)
from pathway_tpu_torch.stdlib.indexing.tiered import TieredKnnBackend, tier_stats

__all__ = [
    "AbstractRetrieverFactory",
    "BM25",
    "BruteForceKnn",
    "BruteForceKnnFactory",
    "DataIndex",
    "DistanceMetric",
    "HybridIndex",
    "HybridIndexFactory",
    "InnerIndex",
    "IvfFlatKnn",
    "IvfFlatKnnFactory",
    "LshKnn",
    "LshKnnFactory",
    "TantivyBM25",
    "TantivyBM25Factory",
    "TieredKnn",
    "TieredKnnBackend",
    "TieredKnnFactory",
    "UsearchKnn",
    "UsearchKnnFactory",
    "tier_stats",
]
