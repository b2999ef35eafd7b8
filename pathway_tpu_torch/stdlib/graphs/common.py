"""Shared graph schemas (reference: ``python/pathway/stdlib/graphs/common.py``)."""

from __future__ import annotations

import pathway_tpu_torch as pw


class Vertex(pw.Schema):
    pass


class Edge(pw.Schema):
    """Directed edge between vertex rows, endpoints stored as row pointers."""

    u: pw.Pointer
    v: pw.Pointer


class Weight(pw.Schema):
    """Weight column mixin for vertices/edges."""

    weight: float


class Cluster(Vertex):
    pass


class Clustering(pw.Schema):
    """Membership relation: the row's id (a vertex) belongs to cluster ``c``."""

    c: pw.Pointer
