"""Single-source shortest paths via fixed-point relaxation (reference:
``python/pathway/stdlib/graphs/bellman_ford/impl.py``).

Each round every vertex keeps the minimum of its current distance and the best
relaxation over incoming edges; ``pw.iterate`` drives the rounds to quiescence.
Monotone non-increasing distances guarantee convergence on graphs without
negative cycles.
"""

from __future__ import annotations

import math

import pathway_tpu_torch as pw



class Vertex(pw.Schema):
    is_source: bool


class Dist(pw.Schema):
    dist: float


class DistFromSource(pw.Schema):
    dist_from_source: float


def _relax(vertices_dist: pw.Table, edges: pw.Table) -> pw.Table:
    # candidates: keep the current distance, plus one candidate per incoming edge
    own = vertices_dist.select(
        target=vertices_dist.id, d=vertices_dist.dist_from_source
    )
    via = edges.select(
        target=edges.v,
        d=vertices_dist.ix(edges.u).dist_from_source + edges.dist,
    )
    candidates = pw.Table.concat_reindex(own, via)
    return candidates.groupby(id=candidates.target).reduce(
        dist_from_source=pw.reducers.min(candidates.d)
    )


def bellman_ford(vertices: pw.Table, edges: pw.Table) -> pw.Table:
    """``vertices``: rows with ``is_source``; ``edges``: rows with pointer
    endpoints ``u``, ``v`` and length ``dist``. Returns per-vertex
    ``dist_from_source`` (inf when unreachable)."""
    initial = vertices.select(
        dist_from_source=pw.if_else(vertices.is_source, 0.0, math.inf)
    )
    return pw.iterate(
        lambda dists, edges: _relax(dists, edges),
        dists=pw.iterate_universe(initial),
        edges=edges,
    )
