"""PageRank over the incremental dataflow (reference:
``python/pathway/stdlib/graphs/pagerank/impl.py``).

Integer-arithmetic ranks (damping 5/6 scaled by 1000) so the fixed point is exact
and incremental updates are deterministic. Implemented on ``pw.iterate`` with
``iteration_limit=steps`` — idiomatic here, where the reference unrolls a Python
loop of ``steps`` dataflow copies.
"""

from __future__ import annotations

import pathway_tpu_torch as pw



class Result(pw.Schema):
    rank: int


def pagerank(edges: pw.Table, steps: int = 5) -> pw.Table:
    """Ranks for every vertex appearing as an edge endpoint."""
    # vertex set = union of endpoints; out-degree counts only outgoing edges
    targets = edges.groupby(id=edges.v).reduce(degree=0)
    sources = edges.groupby(id=edges.u).reduce(degree=pw.reducers.count())
    degrees = pw.Table.update_rows(targets, sources)

    initial = degrees.select(rank=6_000)

    def step(ranks: pw.Table, edges: pw.Table, degrees: pw.Table) -> pw.Table:
        # if_else evaluates both branches; guard the divisor so sinks (degree 0)
        # don't floor-divide by zero
        outflow = degrees.select(
            flow=pw.if_else(
                degrees.degree == 0,
                0,
                (ranks.ix(degrees.id, context=degrees).rank * 5)
                // (pw.if_else(degrees.degree == 0, 1, degrees.degree) * 6),
            )
        )
        contrib = edges.select(target=edges.v, flow=outflow.ix(edges.u).flow)
        collected = contrib.groupby(id=contrib.target).reduce(
            inflow=pw.reducers.sum(contrib.flow)
        )
        # vertices with no in-edges keep only the teleport mass
        base = degrees.select(inflow=0)
        return pw.Table.update_rows(base, collected).select(
            rank=pw.this.inflow + 1_000
        )

    return pw.iterate(
        lambda ranks, edges, degrees: step(ranks, edges, degrees),
        iteration_limit=steps,
        ranks=initial,
        edges=edges,
        degrees=degrees,
    )
