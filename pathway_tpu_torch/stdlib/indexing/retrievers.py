"""Retriever factories (reference ``stdlib/indexing/retrievers.py`` +
``nearest_neighbors.py:407-565``): deferred index construction so apps (e.g.
DocumentStore) can be configured with *how* to index before the data tables exist.

Carried from ``pathway_tpu/stdlib/indexing/retrievers.py`` with the brute-force
factory only; the LSH, usearch, IVF-flat, tiered, BM25 and hybrid factories
are a later slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from pathway_tpu_torch.internals.expression import ColumnExpression, ColumnReference
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.stdlib.indexing.data_index import DataIndex
from pathway_tpu_torch.stdlib.indexing.nearest_neighbors import BruteForceKnn, DistanceMetric


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
        inner = BruteForceKnn(
            data_column,
            self._resolved_dimensions(),
            reserved_space=self.reserved_space,
            metric=self.metric,
            metadata_column=metadata_column,
            embedder=self.embedder,
            device=self.device,
        )
        return DataIndex(data_table, inner)
