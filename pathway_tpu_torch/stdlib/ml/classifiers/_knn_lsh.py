"""LSH-bucketed KNN classifier (reference: ``stdlib/ml/classifiers/_knn_lsh.py``).

Dataflow shape: training vectors flatten into (band, bucket) rows; queries
bucket the same way and equi-join on the band hash, giving per-query candidate
sets that stay incremental under training-data updates. Each query row's
candidate set resolves with ONE (n_candidates, d) distance kernel (the dense
brute-force path on the card lives in ``ops/knn.py``; LSH is the sub-linear
candidate pruner for huge training sets).

Carried from ``pathway_tpu/stdlib/ml/classifiers/_knn_lsh.py`` with imports
rewritten.
"""

from __future__ import annotations

from collections import Counter

import numpy as np

import pathway_tpu_torch as pw

from ._lsh import generate_cosine_lsh_bucketer, generate_euclidean_lsh_bucketer


class DataPoint(pw.Schema):
    data: np.ndarray


def _euclidean_dist_sq(data: np.ndarray, query: np.ndarray) -> np.ndarray:
    diff = data - query[None, :]
    return (diff * diff).sum(axis=1)


def _cosine_dist(data: np.ndarray, query: np.ndarray) -> np.ndarray:
    qn = np.linalg.norm(query) or 1.0
    dn = np.linalg.norm(data, axis=1)
    dn[dn == 0] = 1.0
    return 1.0 - (data @ query) / (dn * qn)


def knn_lsh_generic_classifier_train(data: pw.Table, bucketer, distance=_euclidean_dist_sq):
    """``data``: rows with ``data`` (vector). Returns a model whose
    ``query(queries, k)`` yields per-query candidate KNN ids."""

    def band_rows(table: pw.Table) -> pw.Table:
        banded = table.select(
            origin=table.id,
            bands=pw.apply(lambda v: tuple(int(b) for b in bucketer(v)[0]), table.data),
        )
        flat = banded.flatten(banded.bands, origin_id="row")
        return flat.select(
            origin=flat.row,
            band=flat.bands,
        )

    index = band_rows(data)

    def query_fn(queries: pw.Table, k: int) -> pw.Table:
        qbands = band_rows(queries)
        raw_hits = qbands.join(index, qbands.band == index.band).select(
            query=qbands.origin, candidate=index.origin
        )
        # multi-band matches produce duplicate (query, candidate) pairs
        hits = raw_hits.groupby(raw_hits.query, raw_hits.candidate).reduce(
            query=raw_hits.query, candidate=raw_hits.candidate
        )

        gathered = hits.select(
            query=hits.query,
            candidate=hits.candidate,
            qv=queries.ix(hits.query).data,
            cv=data.ix(hits.candidate).data,
        )
        grouped = gathered.groupby(gathered.query).reduce(
            query=gathered.query,
            qv=pw.reducers.any(gathered.qv),
            cands=pw.reducers.tuple(gathered.candidate),
            vecs=pw.reducers.tuple(gathered.cv),
        )

        def topk(qv, cands, vecs):
            # ONE (n_candidates, d) distance kernel per query row; ties break
            # by candidate id so results are worker-layout independent
            mat = np.stack([np.asarray(v, dtype=np.float64) for v in vecs])
            dists = distance(mat, np.asarray(qv, dtype=np.float64))
            order = np.lexsort((np.asarray(cands, dtype=np.uint64), dists))[:k]
            return (
                tuple(cands[i] for i in order),
                tuple(float(dists[i]) for i in order),
            )

        rekeyed = grouped.with_id(grouped.query)
        pair = rekeyed.select(
            p=pw.apply(topk, rekeyed.qv, rekeyed.cands, rekeyed.vecs)
        )
        knns = pair.select(
            knns_ids=pw.apply(lambda p: p[0], pair.p),
            knns_dists=pw.apply(lambda p: p[1], pair.p),
        )
        # queries with zero candidates still get a row (empty tuples)
        return queries.select(knns_ids=(), knns_dists=()).update_rows(knns)

    return query_fn


def knn_lsh_classifier_train(
    data: pw.Table,
    L: int = 5,
    type: str = "euclidean",  # noqa: A002 — reference-parity name
    **kwargs,
):
    """Dispatch on metric (reference ``knn_lsh_classifier_train``). kwargs:
    ``d`` (dimension, required), ``M`` (projections per band), ``A``
    (euclidean quantization width), ``seed``."""
    d = kwargs.pop("d")
    M = kwargs.pop("M", 10)
    if type == "euclidean":
        A = kwargs.pop("A", 1.0)
        bucketer = generate_euclidean_lsh_bucketer(d, M=M, L=L, A=A, **kwargs)
        return knn_lsh_generic_classifier_train(data, bucketer, _euclidean_dist_sq)
    if type == "cosine":
        bucketer = generate_cosine_lsh_bucketer(d, M=M, L=L, **kwargs)
        return knn_lsh_generic_classifier_train(data, bucketer, _cosine_dist)
    raise ValueError(f"unknown lsh metric {type!r}")


def knn_lsh_euclidean_classifier_train(data: pw.Table, d: int, M: int, L: int, A: float):
    bucketer = generate_euclidean_lsh_bucketer(d, M=M, L=L, A=A)
    return knn_lsh_generic_classifier_train(data, bucketer, _euclidean_dist_sq)


def knn_lsh_classify(knn_model, data_labels: pw.Table, queries: pw.Table, k: int) -> pw.Table:
    """Majority-vote labels of each query's k nearest training rows."""
    knns = knn_model(queries, k)
    flat = knns.flatten(knns.knns_ids, origin_id="q")
    flat = flat.select(q=flat.q, label=data_labels.ix(flat.knns_ids).label)
    votes = flat.groupby(flat.q).reduce(
        q=flat.q, labels=pw.reducers.tuple(flat.label)
    )

    def majority(labels):
        if not labels:
            return None
        return Counter(labels).most_common(1)[0][0]

    rekeyed = votes.with_id(votes.q)
    predicted = rekeyed.select(predicted_label=pw.apply(majority, rekeyed.labels))
    none_rows = knns.select(predicted_label=None)
    return none_rows.update_rows(predicted)
