"""Legacy ``KNNIndex`` wrapper (reference: ``stdlib/ml/index.py``) — the
pre-DataIndex API over the LSH classifier: construct with embeddings, query
with ``get_nearest_items`` in collapsed (tuple columns per query) or flat
(row per match) form."""

from __future__ import annotations

from typing import Any

import pathway_tpu_torch as pw
from pathway_tpu_torch.stdlib.ml.classifiers import knn_lsh_classifier_train


class KNNIndex:
    """LSH-bucketed KNN over a data table's embedding column."""

    def __init__(
        self,
        data_embedding: "pw.ColumnExpression",
        data: "pw.Table",
        n_dimensions: int,
        n_or: int = 20,
        n_and: int = 10,
        bucket_length: float = 10.0,
        distance_type: str = "euclidean",
        metadata: Any = None,
    ):
        if metadata is not None:
            raise NotImplementedError(
                "KNNIndex metadata filtering is not supported; use "
                "stdlib.indexing.DataIndex (JMESPath filters) instead"
            )
        self.data = data
        embeddings = data.select(data=data_embedding)
        self._query = knn_lsh_classifier_train(
            embeddings,
            L=n_or,
            d=n_dimensions,
            M=n_and,
            A=bucket_length,
            type=distance_type,
        )

    def get_nearest_items(
        self,
        query_embedding: "pw.ColumnReference",
        k: int = 3,
        collapse_rows: bool = True,
        with_distances: bool = False,
        metadata_filter: Any = None,
    ) -> "pw.Table":
        if metadata_filter is not None:
            raise NotImplementedError(
                "KNNIndex metadata_filter is not supported; use "
                "stdlib.indexing.DataIndex (JMESPath filters) instead"
            )
        qtable = query_embedding.table
        queries = qtable.select(data=query_embedding)
        knns = self._query(queries, k)
        data = self.data
        data_cols = data.column_names()

        if collapse_rows:
            # one row per query; each data column becomes a tuple of matches
            paired = knns.select(
                pairs=pw.apply(
                    lambda ids, ds: tuple(zip(ids, ds)), knns.knns_ids, knns.knns_dists
                )
            )
            flat = paired.flatten(paired.pairs, origin_id="query_id")
            parts = flat.select(
                query_id=flat.query_id,
                doc=pw.apply(lambda p: p[0], flat.pairs),
                dist=pw.apply(lambda p: p[1], flat.pairs),
            )
            gathered = parts.select(
                query_id=parts.query_id,
                dist=parts.dist,
                **{c: data.ix(parts.doc)[c] for c in data_cols},
            )
            agg = {c: pw.reducers.tuple(gathered[c]) for c in data_cols}
            agg["dist"] = pw.reducers.tuple(gathered.dist)
            grouped = gathered.groupby(gathered.query_id).reduce(
                query_id=gathered.query_id, **agg
            )
            rekeyed = grouped.with_id(grouped.query_id)
            out_cols = list(data_cols) + (["dist"] if with_distances else [])

            def sort_by_dist(dist, *cols):
                order = sorted(range(len(dist)), key=lambda i: dist[i])
                return tuple(
                    tuple(c[i] for i in order) for c in (cols + (dist,))
                )

            packed = rekeyed.select(
                p=pw.apply(sort_by_dist, rekeyed.dist, *[rekeyed[c] for c in data_cols])
            )
            sel = {
                c: pw.apply(lambda p, j=j: p[j], packed.p)
                for j, c in enumerate(data_cols)
            }
            if with_distances:
                sel["dist"] = pw.apply(lambda p: p[-1], packed.p)
            out = packed.select(**sel)
            # queries with no matches still get a row of empty tuples
            empty = knns.select(**{c: () for c in out_cols})
            return empty.update_rows(out)

        paired = knns.select(
            pairs=pw.apply(
                lambda ids, ds: tuple(zip(ids, ds)), knns.knns_ids, knns.knns_dists
            )
        )
        flat = paired.flatten(paired.pairs, origin_id="query_id")
        parts = flat.select(
            query_id=flat.query_id,
            doc=pw.apply(lambda p: p[0], flat.pairs),
            dist=pw.apply(lambda p: p[1], flat.pairs),
        )
        extra = {"dist": parts.dist} if with_distances else {}
        return parts.select(
            query_id=parts.query_id,
            **{c: data.ix(parts.doc)[c] for c in data_cols},
            **extra,
        )

    def get_nearest_items_asof_now(self, query_embedding, **kwargs) -> "pw.Table":
        """Answers are computed as of each query's arrival; in this engine the
        LSH query path already answers against the index state at query time."""
        return self.get_nearest_items(query_embedding, **kwargs)
