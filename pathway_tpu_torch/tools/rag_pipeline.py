"""The live-RAG loop as a Pathway pipeline, written once against a ``pw``
module (``import pathway_tpu_torch as pw``, or the JAX package for a parity
run): docs stream in and feed the index a retriever factory builds (any
factory of ``stdlib.indexing``: brute-force, tiered, IVF-flat, usearch, LSH,
BM25 or hybrid; a vector index embeds through its embedder UDF), queries
stream in after the docs and are answered as of now, and a cross-encoder
reranker scores every (query, hit) pair.

The shape is ``benchmarks/streaming_bench.py::_chain_run`` taken to the full
loop: docs and queries arrive in ``tick_rows``-row ticks through
``pw.debug.table_from_rows(..., is_stream=True)``; queries start at the tick
after the last doc tick.
"""

from __future__ import annotations

from typing import Any

#: the captured columns, one row per (query, hit)
COLUMNS = ("qi", "dkey", "di", "rank", "knn", "rerank")


def build(
    pw,
    *,
    embedder: Any,
    index_factory: Any,
    reranker: Any,
    docs: list[str],
    queries: list[str],
    tick_rows: int,
    k: int = 10,
    query_tick_rows: int | None = None,
):
    """The pipeline's output table: columns :data:`COLUMNS` — query index,
    the hit's doc key, its doc index, its rank (0 = best), the KNN score and
    the rerank score. Queries arrive ``query_tick_rows`` a tick (default:
    ``tick_rows``)."""
    q_tick = query_tick_rows or tick_rows
    n_doc_ticks = -(-len(docs) // tick_rows)
    docs_t = pw.debug.table_from_rows(
        pw.schema_from_types(di=int, text=str),
        [(i, d, i // tick_rows, 1) for i, d in enumerate(docs)],
        is_stream=True,
    )
    docs_t = docs_t.select(docs_t.di, docs_t.text, dkey=docs_t.id)
    queries_t = pw.debug.table_from_rows(
        pw.schema_from_types(qi=int, q=str),
        [(i, q, n_doc_ticks + i // q_tick, 1) for i, q in enumerate(queries)],
        is_stream=True,
    )
    index = index_factory.build_index(docs_t.text, docs_t)
    answers = index.query_as_of_now(queries_t.q, number_of_matches=k).select(
        qi=pw.left.qi,
        q=pw.left.q,
        # a multi-worker run may show the join a reply row before its hits
        # arrive from the worker that grouped them (None columns, retracted
        # within the same tick): such a row has no hits
        hits=pw.apply(
            lambda dkeys, dis, texts, scores: ()
            if dkeys is None
            else tuple(zip(range(len(dkeys)), dkeys, dis, texts, scores)),
            pw.right.dkey,
            pw.right.di,
            pw.right.text,
            pw.right["_pw_index_reply_score"],
        ),
    )
    flat = answers.flatten(answers.hits)

    def field(i: int, typ):
        return pw.apply_with_type(lambda h, _i=i: h[_i], typ, flat.hits)

    pairs = flat.select(
        flat.qi,
        flat.q,
        rank=field(0, int),
        dkey=field(1, pw.Pointer),
        di=field(2, int),
        text=field(3, str),
        knn=field(4, float),
    )
    scored = pairs.select(
        pairs.qi, pairs.dkey, pairs.di, pairs.rank, pairs.knn, rerank=reranker(pairs.text, pairs.q)
    )
    return scored


def hits_by_query(rows) -> dict[int, list[tuple]]:
    """Captured rows → ``{qi: [(dkey, di, knn, rerank), ...]}`` in rank order."""
    out: dict[int, list] = {}
    for row in rows:
        qi, dkey, di, rank, knn, rerank = row
        out.setdefault(int(qi), []).append((int(rank), int(dkey), int(di), float(knn), float(rerank)))
    return {qi: [h[1:] for h in sorted(hs)] for qi, hs in out.items()}
