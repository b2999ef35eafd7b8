"""The port's ``pw.iterate`` / ``pw.iterate_universe`` and ``stdlib.graphs``
(bellman_ford, pagerank, louvain) against the JAX package's, on the same
inputs.

Mirrors the ten cases of ``tests/test_iterate_graphs.py``. Each pipeline is
written once as ``build(pw)`` and its update stream ``(time, key, diff,
values)`` is compared exactly, keys included: ranks are integers, distances
and modularities are sums of the same Python floats in the same order, and
community ids are fingerprints of the same keys (tolerance 0). The case's own
asserts then run on the port's rows.
"""

from __future__ import annotations

import math

import pathway_tpu_torch
from test_torch_temporal import rows, same_stream


def _values(stream) -> list[tuple]:
    return sorted(rows(stream).elements(), key=repr)


# ------------------------------------------------------------------ iterate


def test_iterate_collatz():
    def build(pw):
        def collatz(iterated):
            @pw.udf
            def step(x: int) -> int:
                if x == 1:
                    return 1
                return x // 2 if x % 2 == 0 else 3 * x + 1

            return iterated.select(val=step(iterated.val))

        tab = pw.debug.table_from_markdown("val\n" + "\n".join(str(i) for i in range(1, 9)))
        return pw.iterate(collatz, iterated=tab)

    assert _values(same_stream(build)) == [(1,)] * 8


def test_iterate_limit():
    def build(pw):
        tab = pw.debug.table_from_markdown("val\n1")
        return pw.iterate(lambda iterated: iterated.select(val=iterated.val * 2), iteration_limit=3, iterated=tab)

    assert _values(same_stream(build)) == [(8,)]


def test_iterate_min_label_propagation_connected_components():
    def build(pw):
        vertices = pw.debug.table_from_markdown("name\na\nb\nc\nd\ne")
        edges_raw = pw.debug.table_from_markdown(
            """
            su | sv
            a  | b
            b  | c
            d  | e
            """
        )
        names = vertices.with_id_from(pw.this.name)
        edges = edges_raw.select(u=names.pointer_from(edges_raw.su), v=names.pointer_from(edges_raw.sv))

        @pw.udf
        def label_of(name: str) -> int:
            return ord(name)

        labels = names.select(lab=label_of(names.name))

        def step(labels, edges):
            fwd = edges.select(target=edges.v, lab=labels.ix(edges.u).lab)
            bwd = edges.select(target=edges.u, lab=labels.ix(edges.v).lab)
            own = labels.select(target=labels.id, lab=labels.lab)
            allc = pw.Table.concat_reindex(own, fwd, bwd)
            return allc.groupby(id=allc.target).reduce(lab=pw.reducers.min(allc.lab))

        return pw.iterate(lambda labels, edges: step(labels, edges), labels=labels, edges=edges)

    assert sorted(v for (v,) in _values(same_stream(build))) == [ord("a")] * 3 + [ord("d")] * 2


def test_iterate_universe_argument_narrows_to_its_fixed_point():
    """An argument wrapped in ``pw.iterate_universe`` may change its key set
    between iterations: a filter applied until nothing changes."""

    def build(pw):
        tab = pw.debug.table_from_markdown("val\n" + "\n".join(str(i) for i in (3, 8, 20, 64, 100)))
        return pw.iterate(
            lambda iterated: iterated.filter(iterated.val > 10), iterated=pw.iterate_universe(tab)
        )

    assert sorted(_values(same_stream(build))) == [(20,), (64,), (100,)]


# --------------------------------------------------------------- graphs


def _vertices_edges(pw, extra: bool = False):
    vertices_raw = pw.debug.table_from_markdown(
        """
        name | is_source
        A    | true
        B    | false
        C    | false
        D    | false
        E    | false
        """
    )
    vertices = vertices_raw.with_id_from(pw.this.name)
    edges_raw = pw.debug.table_from_markdown(
        """
        su | sv | dist
        A  | B  | 1.0
        B  | C  | 2.0
        A  | C  | 10.0
        C  | D  | 1.0
        """
        + ("        A  | D  | 1.5\n" if extra else "")
    )
    edges = edges_raw.select(
        u=vertices.pointer_from(edges_raw.su),
        v=vertices.pointer_from(edges_raw.sv),
        dist=edges_raw.dist,
    )
    return vertices, edges


def _bellman_ford(extra: bool):
    def build(pw):
        from importlib import import_module

        bellman_ford = import_module(f"{pw.__name__}.stdlib.graphs.bellman_ford").bellman_ford
        vertices, edges = _vertices_edges(pw, extra)
        res = bellman_ford(vertices, edges)
        return res.select(name=vertices.ix(res.id, context=res).name, d=res.dist_from_source)

    return dict(_values(same_stream(build)))


def test_bellman_ford():
    d = _bellman_ford(extra=False)
    assert (d["A"], d["B"], d["C"], d["D"]) == (0.0, 1.0, 3.0, 4.0) and math.isinf(d["E"])


def test_bellman_ford_extra_edge():
    d = _bellman_ford(extra=True)
    assert d["D"] == 1.5 and d["C"] == 3.0


def _pagerank(md: str, steps: int) -> list[int]:
    def build(pw):
        base = pw.debug.table_from_markdown(md).with_id_from(pw.this.su)
        edges = base.select(u=base.pointer_from(base.su), v=base.pointer_from(base.sv))
        return pw.stdlib.graphs.pagerank.pagerank(edges, steps=steps)

    return [r for (r,) in _values(same_stream(build))]


def test_pagerank_star():
    ranks = _pagerank("su | sv\na | e\nb | e\nc | e\nd | e", steps=10)
    assert len(ranks) == 5
    leaves = sorted(ranks)[:-1]
    assert all(r == leaves[0] for r in leaves) and max(ranks) > 3 * leaves[0]


def test_pagerank_cycle_uniform():
    ranks = _pagerank("su | sv\na | b\nb | c\nc | a", steps=20)
    assert len(ranks) == 3 and len(set(ranks)) == 1


def _two_triangles(pw):
    vertices = pw.debug.table_from_markdown("name\na\nb\nc\nx\ny\nz").with_id_from(pw.this.name)
    arcs = pw.debug.table_from_markdown(
        """
        su | sv | weight
        a  | b  | 1.0
        b  | c  | 1.0
        a  | c  | 1.0
        x  | y  | 1.0
        y  | z  | 1.0
        x  | z  | 1.0
        c  | x  | 0.25
        """
    )
    fwd = arcs.select(u=vertices.pointer_from(arcs.su), v=vertices.pointer_from(arcs.sv), weight=arcs.weight)
    bwd = arcs.select(u=vertices.pointer_from(arcs.sv), v=vertices.pointer_from(arcs.su), weight=arcs.weight)
    graph = pw.stdlib.graphs.WeightedGraph.from_vertices_and_weighted_edges(
        vertices.select(), fwd.concat_reindex(bwd)
    )
    return graph, vertices


def _louvain(pw):
    from importlib import import_module

    return import_module(f"{pw.__name__}.stdlib.graphs.louvain_communities")


def test_louvain_two_triangles():
    def build(pw):
        graph, vertices = _two_triangles(pw)
        clustering = _louvain(pw).louvain_level(graph, iteration_limit=32)
        return clustering.select(name=vertices.ix(clustering.id, context=clustering).name, c=clustering.c)

    got = dict(_values(same_stream(build)))
    assert len(got) == 6
    left, right = {got[n] for n in "abc"}, {got[n] for n in "xyz"}
    assert len(left) == 1 and len(right) == 1 and left != right


def test_louvain_modularity_positive():
    def build(pw):
        graph, _vertices = _two_triangles(pw)
        louvain = _louvain(pw)
        return louvain.exact_modularity(graph, louvain.louvain_level(graph, iteration_limit=32))

    [(modularity,)] = _values(same_stream(build))
    assert modularity > 0.3


def test_louvain_communities_multilevel():
    def build(pw):
        graph, vertices = _two_triangles(pw)
        final = _louvain(pw).louvain_communities(graph, levels=2)
        return final.select(name=vertices.ix(final.id, context=final).name, c=final.c)

    got = dict(_values(same_stream(build)))
    assert len({got[n] for n in "abc"}) == 1 and len({got[n] for n in "xyz"}) == 1


def test_graphs_surface_matches_the_reference_exports():
    import pathway_tpu

    for ref, port in ((pathway_tpu.stdlib.graphs, pathway_tpu_torch.stdlib.graphs),):
        assert sorted(port.__all__) == sorted(ref.__all__)
    assert "graphs" in pathway_tpu_torch.stdlib.__all__
    assert pathway_tpu_torch.graphs is pathway_tpu_torch.stdlib.graphs
