"""Retriever factories (reference ``stdlib/indexing/retrievers.py`` +
``nearest_neighbors.py:407-565``): deferred index construction so apps (e.g.
DocumentStore) can be configured with *how* to index before the data tables exist.

Carried from ``pathway_tpu/stdlib/indexing/retrievers.py``. ``device=``
(``None``: the card) places the indexes that have a device part, brute force
and tiered; the LSH, IVF-flat (usearch), BM25 and hybrid indexes are host code
by design.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

from pathway_tpu_torch.internals.expression import ColumnExpression, ColumnReference
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.stdlib.indexing.bm25 import TantivyBM25
from pathway_tpu_torch.stdlib.indexing.data_index import DataIndex
from pathway_tpu_torch.stdlib.indexing.hybrid_index import HybridIndex
from pathway_tpu_torch.stdlib.indexing.nearest_neighbors import (
    BruteForceKnn,
    DistanceMetric,
    IvfFlatKnn,
    LshKnn,
    UsearchKnn,
)


class AbstractRetrieverFactory:
    def build_index(
        self,
        data_column: ColumnReference,
        data_table: Table,
        metadata_column: ColumnExpression | None = None,
    ) -> DataIndex:
        raise NotImplementedError


@dataclass
class BruteForceKnnFactory(AbstractRetrieverFactory):
    """``device=None`` puts the index on the card, as for every entry point
    of the port."""

    dimensions: int | None = None
    reserved_space: int = 1024
    embedder: Any = None
    metric: DistanceMetric | str = DistanceMetric.COS
    device: Any = None
    _index_cls: type = BruteForceKnn

    def _resolved_dimensions(self) -> int:
        if self.dimensions is not None:
            return self.dimensions
        dim = getattr(self.embedder, "dimension", None)
        if callable(dim):
            dim = dim()
        if dim is None:
            raise ValueError("provide dimensions= or an embedder exposing .dimension")
        return int(dim)

    def build_index(self, data_column, data_table, metadata_column=None) -> DataIndex:
        # the LSH and usearch (IVF-flat) indexes subclassing this factory run
        # on the host and take no device
        on_device = {"device": self.device} if self._index_cls is BruteForceKnn else {}
        inner = self._index_cls(
            data_column,
            self._resolved_dimensions(),
            reserved_space=self.reserved_space,
            metric=self.metric,
            metadata_column=metadata_column,
            embedder=self.embedder,
            **on_device,
        )
        return DataIndex(data_table, inner)


@dataclass
class LshKnnFactory(BruteForceKnnFactory):
    _index_cls: type = LshKnn


@dataclass
class UsearchKnnFactory(BruteForceKnnFactory):
    _index_cls: type = UsearchKnn


@dataclass
class IvfFlatKnnFactory(BruteForceKnnFactory):
    """IVF-flat retriever (HNSW-class approximate index, ``indexing/ivf.py``)."""

    nlist: int | None = None
    nprobe: int | None = None
    min_train: int = 4096

    def build_index(self, data_column, data_table, metadata_column=None) -> DataIndex:
        inner = IvfFlatKnn(
            data_column,
            self._resolved_dimensions(),
            metric=self.metric,
            metadata_column=metadata_column,
            embedder=self.embedder,
            nlist=self.nlist,
            nprobe=self.nprobe,
            min_train=self.min_train,
        )
        return DataIndex(data_table, inner)


@dataclass
class TieredKnnFactory(BruteForceKnnFactory):
    """Tiered retriever (``indexing/tiered.py``): bounded hot shard on the
    card over a host IVF cold tier — fixed device memory at any corpus size."""

    hot_rows: int | None = None
    nlist: int | None = None
    nprobe: int | None = None
    min_train: int = 4096
    promote_hits: int | None = None

    def build_index(self, data_column, data_table, metadata_column=None) -> DataIndex:
        from pathway_tpu_torch.stdlib.indexing.nearest_neighbors import TieredKnn

        inner = TieredKnn(
            data_column,
            self._resolved_dimensions(),
            metric=self.metric,
            metadata_column=metadata_column,
            embedder=self.embedder,
            hot_rows=self.hot_rows,
            nlist=self.nlist,
            nprobe=self.nprobe,
            min_train=self.min_train,
            promote_hits=self.promote_hits,
            device=self.device,
        )
        return DataIndex(data_table, inner)


@dataclass
class TantivyBM25Factory(AbstractRetrieverFactory):
    ram_budget: int | None = None
    in_memory_index: bool = True

    def build_index(self, data_column, data_table, metadata_column=None) -> DataIndex:
        inner = TantivyBM25(
            data_column,
            metadata_column=metadata_column,
            ram_budget=self.ram_budget,
            in_memory_index=self.in_memory_index,
        )
        return DataIndex(data_table, inner)


@dataclass
class HybridIndexFactory(AbstractRetrieverFactory):
    retriever_factories: list[AbstractRetrieverFactory] = field(default_factory=list)
    k: float = 60.0

    def build_index(self, data_column, data_table, metadata_column=None) -> DataIndex:
        inners = [
            f.build_index(data_column, data_table, metadata_column).inner_index
            for f in self.retriever_factories
        ]
        return DataIndex(data_table, HybridIndex(inners, k=self.k))
