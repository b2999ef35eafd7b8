"""Graph containers + cluster contraction (reference:
``python/pathway/stdlib/graphs/graph.py``).

A ``Graph`` is a pair of tables (vertices ``V``, directed edges ``E`` with pointer
endpoints); ``WeightedGraph`` adds a weighted edge table ``WE``. Contraction maps a
clustering (vertex → cluster pointer) over the edge endpoints and re-groups
parallel edges, which is how louvain builds its next level.
"""

from __future__ import annotations

from dataclasses import dataclass

import pathway_tpu_torch as pw



def _full_clustering(
    vertices: pw.Table, clustering: pw.Table
) -> pw.Table:
    """Extend a partial clustering so unassigned vertices sit in singleton
    clusters keyed by their own id."""
    return vertices.select(c=vertices.id).update_rows(clustering)


@dataclass
class Graph:
    """Undirected, unweighted (multi)graph."""

    V: pw.Table
    E: pw.Table

    def contracted_to_multi_graph(self, clustering: pw.Table) -> "Graph":
        full = _full_clustering(self.V, clustering)
        new_V = (
            full.groupby(full.c).reduce(v=full.c).with_id(pw.this.v).select()
        )
        new_E = self.E.select(u=full.ix(self.E.u).c, v=full.ix(self.E.v).c)
        return Graph(new_V, new_E)

    def contracted_to_simple_graph(self, clustering: pw.Table) -> "Graph":
        g = self.contracted_to_multi_graph(clustering)
        g.E = g.E.groupby(g.E.u, g.E.v).reduce(g.E.u, g.E.v)
        return g

    def without_self_loops(self) -> "Graph":
        return Graph(self.V, self.E.filter(self.E.u != self.E.v))


@dataclass
class WeightedGraph(Graph):
    """Graph with a weighted edge table ``WE`` (columns u, v, weight)."""

    WE: pw.Table = None

    @staticmethod
    def from_vertices_and_weighted_edges(V: pw.Table, WE: pw.Table) -> "WeightedGraph":
        return WeightedGraph(V, WE, WE)

    def contracted_to_weighted_simple_graph(self, clustering: pw.Table) -> "WeightedGraph":
        full = _full_clustering(self.V, clustering)
        new_V = (
            full.groupby(full.c).reduce(v=full.c).with_id(pw.this.v).select()
        )
        mapped = self.WE.select(
            u=full.ix(self.WE.u).c, v=full.ix(self.WE.v).c, weight=self.WE.weight
        )
        new_WE = mapped.groupby(mapped.u, mapped.v).reduce(
            mapped.u, mapped.v, weight=pw.reducers.sum(mapped.weight)
        )
        return WeightedGraph.from_vertices_and_weighted_edges(new_V, new_WE)

    def without_self_loops(self) -> "WeightedGraph":
        return WeightedGraph.from_vertices_and_weighted_edges(
            self.V, self.WE.filter(self.WE.u != self.WE.v)
        )
