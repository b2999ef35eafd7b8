"""Hybrid index: reciprocal-rank fusion over sub-indexes
(reference ``stdlib/indexing/hybrid_index.py:14``).

Each sub-index answers the query independently; results fuse by
``score = Σ 1 / (k + rank_i)`` (RRF, k=60 like the reference default).
"""

from __future__ import annotations

from pathway_tpu_torch.stdlib.indexing.data_index import InnerIndex


class HybridIndex(InnerIndex):
    """Reply-level reciprocal-rank fusion: each sub-index answers independently
    (with its own representation — BM25 over text, KNN over embeddings), then the
    (doc, rank) lists fuse. Mirrors the reference's HybridIndex semantics."""

    def __init__(self, inner_indexes: list[InnerIndex], *, k: float = 60.0):
        if not inner_indexes:
            raise ValueError("HybridIndex needs at least one inner index")
        self.inner_indexes = inner_indexes
        self.k = k
        first = inner_indexes[0]
        self.data_column = first.data_column
        self.data_table = first.data_table
        self.metadata_column = first.metadata_column

    def _raw_reply(self, query_column, number_of_matches, metadata_filter, as_of_now):
        import pathway_tpu_torch as pw
        from pathway_tpu_torch.internals import dtype as dt
        from pathway_tpu_torch.stdlib.indexing.data_index import _INDEX_REPLY

        replies = [
            ix._raw_reply(query_column, number_of_matches, metadata_filter, as_of_now)
            for ix in self.inner_indexes
        ]
        base = replies[0]
        cols = {"__r0": base[_INDEX_REPLY]}
        for i, r in enumerate(replies[1:], 1):
            cols[f"__r{i}"] = r.with_universe_of(base)[_INDEX_REPLY]
        # per-query match limit: materialize k on the query table and carry it
        # alongside the replies (as-of-now replies cover every query → same keys)
        qtable = query_column.table
        if isinstance(number_of_matches, int):
            cols["__k"] = number_of_matches
        else:
            qk = qtable.select(__k=number_of_matches)
            cols["__k"] = qk.with_universe_of(base)["__k"]
        merged = base.select(**cols)
        rrf_k = self.k
        n = len(replies)

        def fuse(limit, *reply_lists):
            fused: dict = {}
            for lst in reply_lists:
                for rank, (key, _s) in enumerate(lst or ()):
                    fused[key] = fused.get(key, 0.0) + 1.0 / (rrf_k + rank + 1)
            from pathway_tpu_torch.internals.keys import tie_order

            ranked = sorted(fused.items(), key=lambda kv: (-kv[1], tie_order(kv[0])))
            return tuple(ranked[: int(limit)])

        return merged.select(
            **{
                _INDEX_REPLY: pw.apply_with_type(
                    fuse, dt.ANY, merged["__k"], *[merged[f"__r{i}"] for i in range(n)]
                )
            }
        )

    def query(self, query_column, *, number_of_matches=3, metadata_filter=None):
        return self._raw_reply(query_column, number_of_matches, metadata_filter, False)

    def query_as_of_now(self, query_column, *, number_of_matches=3, metadata_filter=None):
        return self._raw_reply(query_column, number_of_matches, metadata_filter, True)
