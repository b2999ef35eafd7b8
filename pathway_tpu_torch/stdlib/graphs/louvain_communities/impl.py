"""Louvain community detection (reference:
``python/pathway/stdlib/graphs/louvain_communities/impl.py``).

One level = fixed-point (``pw.iterate``) of parallel-safe greedy moves: every
vertex scores each adjacent cluster with the (unnormalized, ×m) modularity gain

    2·w(v→C) − deg(v)·(2·deg(C \\ {v}) + deg(v)) / m

takes the argmax, and a move executes only when the vertex holds the maximum
deterministic priority in both its source and target clusters among this round's
candidate movers — so no cluster participates in two simultaneous moves and the
objective increases monotonically. ``louvain_communities`` stacks levels by
contracting each level's clustering into a weighted cluster graph.

Undirected graphs are represented as both directed arcs, as in the reference.
"""

from __future__ import annotations

import pathway_tpu_torch as pw
from pathway_tpu_torch.internals.fingerprints import fingerprint
from pathway_tpu_torch.stdlib.utils.filtering import argmax_rows

from ..graph import WeightedGraph


def _one_step(WE: pw.Table, clustering: pw.Table) -> pw.Table:
    """One round of parallel-safe greedy moves. ``WE``: (u, v, weight) arcs;
    ``clustering``: per-vertex cluster pointer ``c``. Returns the new clustering."""
    total = WE.reduce(m=pw.reducers.sum(WE.weight))

    # vertex degrees (sum of outgoing arc weights; undirected graphs store both
    # arcs so this is the full incident weight). Default 0 for isolated vertices.
    out_deg = WE.groupby(id=WE.u).reduce(degree=pw.reducers.sum(WE.weight))
    degrees = clustering.select(degree=0.0).update_rows(out_deg).with_universe_of(clustering)

    # cluster degree sums
    member = clustering.select(c=pw.this.c, degree=degrees.ix(clustering.id).degree)
    cluster_deg = member.groupby(id=member.c).reduce(
        cdeg=pw.reducers.sum(member.degree)
    )

    # weight from each vertex to each adjacent cluster (self-loops excluded from
    # adjacency; their weight is invariant under any move of v)
    arcs = WE.filter(WE.u != WE.v)
    to_cluster = arcs.select(u=arcs.u, c=clustering.ix(arcs.v).c, w=arcs.weight)
    # ensure the current cluster is always a candidate, even with zero edges to it
    stay = clustering.select(u=clustering.id, c=clustering.c, w=0.0).with_id_from(
        pw.this.u, pw.this.c
    )
    linked = to_cluster.groupby(to_cluster.u, to_cluster.c).reduce(
        to_cluster.u, to_cluster.c, w=pw.reducers.sum(to_cluster.w)
    )
    candidates = stay.update_rows(linked)

    gains = candidates.select(
        u=candidates.u,
        c=candidates.c,
        gain=2.0 * candidates.w
        - degrees.ix(candidates.u).degree
        * (
            2.0
            * (
                cluster_deg.ix(candidates.c).cdeg
                # leaving-adjustment: when scoring the current cluster, the
                # vertex's own degree is not part of the surrounding mass
                - pw.if_else(
                    clustering.ix(candidates.u).c == candidates.c,
                    degrees.ix(candidates.u).degree,
                    0.0,
                )
            )
            + degrees.ix(candidates.u).degree
        )
        / total.ix_ref(context=candidates).m,
    )

    best = argmax_rows(gains, gains.u, what=gains.gain)
    # move priority is salted with the vertex's CURRENT cluster: every executed
    # move re-randomizes the winner's priority next round (no fixed-priority
    # starvation, the reference's fingerprint((x, iter)) intent) while staying
    # constant at the fixed point so pw.iterate still converges
    annotated = best.select(
        u=best.u,
        vc=best.c,
        uc=clustering.ix(best.u).c,
        r=pw.apply_with_type(
            lambda k, c: fingerprint((k, c), format="i64"), int, best.u, clustering.ix(best.u).c
        ),
    )
    movers = annotated.filter(annotated.vc != annotated.uc)

    # independent set: a move runs only if its priority is the max in both the
    # source and the target cluster among this round's movers
    touched = pw.Table.concat_reindex(
        movers.select(c=movers.uc, r=movers.r),
        movers.select(c=movers.vc, r=movers.r),
    )
    cluster_max = argmax_rows(touched, touched.c, what=touched.r).with_id(pw.this.c)
    checked = movers.select(
        u=movers.u,
        vc=movers.vc,
        r=movers.r,
        src_max=cluster_max.ix(movers.uc).r,
        dst_max=cluster_max.ix(movers.vc).r,
    )
    safe = checked.filter((checked.r == checked.src_max) & (checked.r == checked.dst_max))

    delta = safe.with_id(safe.u).select(c=pw.this.vc)
    return clustering.update_rows(delta).with_universe_of(clustering)


def louvain_level(G: WeightedGraph, iteration_limit: int | None = None) -> pw.Table:
    """Clustering that is a local maximum of the louvain objective for ``G``."""
    initial = G.V.select(c=G.V.id)
    return pw.iterate(
        lambda clustering, WE: dict(clustering=_one_step(WE, clustering)),
        iteration_limit=iteration_limit,
        clustering=initial,
        WE=G.WE,
    ).clustering


def louvain_communities(
    G: WeightedGraph, levels: int = 1, iteration_limit: int | None = 64
) -> pw.Table:
    """Multi-level louvain: run a level, contract clusters to a weighted graph,
    repeat. Returns the final vertex → community assignment (column ``c``)."""
    assignment = None  # vertex -> current-level cluster
    level_graph = G
    for _ in range(levels):
        clustering = louvain_level(level_graph, iteration_limit=iteration_limit)
        if assignment is None:
            assignment = clustering
        else:
            assignment = assignment.select(c=clustering.ix(assignment.c).c)
        level_graph = level_graph.contracted_to_weighted_simple_graph(clustering)
    return assignment


def exact_modularity(G: WeightedGraph, C: pw.Table, round_digits: int = 12) -> pw.Table:
    """Modularity of clustering ``C`` on ``G`` (testing helper): per cluster,
    (internal·m − deg²) / m², summed. Arc convention: both directions stored, so
    m and degrees already count each undirected edge twice."""
    clusters = C.groupby(id=C.c).reduce()

    deg_rows = (
        G.WE.select(c=C.ix(G.WE.u).c, w=G.WE.weight)
        .groupby(id=pw.this.c)
        .reduce(degree=pw.reducers.sum(pw.this.w))
    )
    cluster_degree = clusters.select(degree=0.0).update_rows(deg_rows).with_universe_of(clusters)

    internal_rows = (
        G.WE.select(cu=C.ix(G.WE.u).c, cv=C.ix(G.WE.v).c, w=G.WE.weight)
        .filter(pw.this.cu == pw.this.cv)
        .groupby(id=pw.this.cu)
        .reduce(internal=pw.reducers.sum(pw.this.w))
    )
    cluster_internal = clusters.select(internal=0.0).update_rows(internal_rows).with_universe_of(clusters)

    total = G.WE.reduce(m=pw.reducers.sum(G.WE.weight))

    scores = clusters.select(
        q=pw.apply_with_type(
            lambda internal, degree, m: (internal * m - degree * degree) / (m * m),
            float,
            cluster_internal.ix(clusters.id).internal,
            cluster_degree.ix(clusters.id).degree,
            total.ix_ref(context=clusters).m,
        )
    )
    return scores.reduce(
        modularity=pw.apply_with_type(
            lambda s: round(s, round_digits), float, pw.reducers.sum(scores.q)
        )
    )
