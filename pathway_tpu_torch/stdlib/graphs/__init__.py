"""Graph algorithms over the incremental dataflow (reference:
``python/pathway/stdlib/graphs/``): bellman-ford, pagerank, louvain — the
``pw.iterate`` fixed-point exercisers. Carried from
``pathway_tpu/stdlib/graphs/`` with imports rewritten."""

from __future__ import annotations

from . import bellman_ford, louvain_communities, pagerank
from .common import Clustering, Edge, Vertex, Weight
from .graph import Graph, WeightedGraph

__all__ = [
    "bellman_ford",
    "pagerank",
    "louvain_communities",
    "Clustering",
    "Edge",
    "Vertex",
    "Weight",
    "Graph",
    "WeightedGraph",
]
