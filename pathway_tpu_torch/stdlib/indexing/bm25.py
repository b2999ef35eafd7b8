"""Full-text BM25 index (reference ``stdlib/indexing/bm25.py:41`` TantivyBM25).

The reference wraps the tantivy crate; full-text scoring is memory-bound, not
FLOP-bound, so here it is a host-side inverted index (``_engine.BM25Backend``)
with standard Okapi BM25 scoring. The class keeps the reference's name for
drop-in compatibility.
"""

from __future__ import annotations

from pathway_tpu_torch.internals.expression import ColumnExpression, ColumnReference
from pathway_tpu_torch.stdlib.indexing._engine import BM25Backend
from pathway_tpu_torch.stdlib.indexing.data_index import InnerIndex


class TantivyBM25(InnerIndex):
    def __init__(
        self,
        data_column: ColumnReference,
        *,
        metadata_column: ColumnExpression | None = None,
        ram_budget: int | None = None,  # accepted for API parity; unused
        in_memory_index: bool = True,
    ):
        super().__init__(
            data_column,
            metadata_column=metadata_column,
            backend_factory=BM25Backend,
        )


BM25 = TantivyBM25
