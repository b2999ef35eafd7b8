"""The rest of the port's ``stdlib.ml`` against the JAX package's: the
legacy ``KNNIndex`` wrapper, the KNN-LSH classifiers, the fuzzy joins of
``smart_table_ops``, the HMM decoding reducer and ``datasets``.

Mirrors the ``KNNIndex``, fuzzy and hmm cases of ``tests/test_ml_extras.py``
and the two ``knn_lsh`` cases of ``tests/test_stdlib_fill.py``. Each pipeline
is written once as ``build(pw)`` on the same seeded numpy inputs and its
update stream ``(time, key, diff, values)`` is compared exactly, keys
included (the LSH projections are the same numpy draws from the same seed,
and distances the same numpy sums: tolerance 0). The HMM graph is a plain
object with the ``networkx.DiGraph`` methods the reducer reads, so the port
needs no ``networkx``. The ``interactive`` and ``row_transformer`` cases wait
for the next slice (ROADMAP Queue 1 item 1).
"""

from __future__ import annotations

import importlib
import math

import numpy as np
import pytest

import pathway_tpu
import pathway_tpu_torch
from test_torch_temporal import rows, same_stream


def _mod(pw, sub: str):
    return importlib.import_module(f"{pw.__name__}.{sub}")


def _values(stream) -> list[tuple]:
    return sorted(rows(stream).elements(), key=repr)


# ------------------------------------------------------------------ KNNIndex


def _knn_data(pw):
    rng = np.random.default_rng(5)
    vecs = np.vstack([rng.normal(0, 0.1, (10, 6)) + 1, rng.normal(0, 0.1, (10, 6)) - 1]).astype(np.float32)
    data = pw.debug.table_from_rows(
        pw.schema_from_types(emb=np.ndarray, label=str),
        [(v, "P" if v[0] > 0 else "N") for v in vecs],
    )
    index = _mod(pw, "stdlib.ml.index").KNNIndex(data.emb, data, n_dimensions=6, n_or=8, n_and=4, bucket_length=2.0)
    queries = pw.debug.table_from_rows(
        pw.schema_from_types(emb=np.ndarray), [(np.full(6, 0.9, dtype=np.float32),)]
    )
    return index, queries


def test_knn_index_collapsed_and_flat():
    def collapsed(pw):
        index, queries = _knn_data(pw)
        return index.get_nearest_items(queries.emb, k=3)

    def flat(pw):
        index, queries = _knn_data(pw)
        return index.get_nearest_items(queries.emb, k=3, collapse_rows=False)

    [row] = _values(same_stream(collapsed))
    labels = row[1]  # columns: emb, label
    assert set(labels) == {"P"} and len(labels) == 3
    assert len(_values(same_stream(flat))) == 3


def test_knn_index_with_distances():
    def build(pw):
        rng = np.random.default_rng(2)
        vecs = (rng.normal(0, 0.05, (8, 4)) + 1).astype(np.float32)
        data = pw.debug.table_from_rows(pw.schema_from_types(emb=np.ndarray), [(v,) for v in vecs])
        index = _mod(pw, "stdlib.ml.index").KNNIndex(data.emb, data, n_dimensions=4, n_or=6, n_and=3, bucket_length=3.0)
        queries = pw.debug.table_from_rows(pw.schema_from_types(emb=np.ndarray), [(np.ones(4, dtype=np.float32),)])
        with pytest.raises(NotImplementedError, match="metadata"):
            index.get_nearest_items(queries.emb, metadata_filter="x")
        return index.get_nearest_items(queries.emb, k=2, with_distances=True)

    [row] = _values(same_stream(build))
    dists = row[-1]
    assert len(dists) == 2 and dists[0] <= dists[1]


def test_knn_index_on_seeded_embeddings_matches_the_reference():
    """A larger seeded corpus, flat rows with distances: the same matches in
    the same order with the same bits. (``distance_type="cosine"`` raises a
    ``TypeError`` in the reference's ``KNNIndex``, which passes the
    euclidean bucketer's ``A`` to the cosine one; the port keeps that.)"""

    def build(pw):
        rng = np.random.default_rng(11)
        vecs = rng.normal(0, 1, (256, 16)).astype(np.float32)
        data = pw.debug.table_from_rows(
            pw.schema_from_types(emb=np.ndarray, doc=int), [(v, i) for i, v in enumerate(vecs)]
        )
        index = _mod(pw, "stdlib.ml.index").KNNIndex(
            data.emb, data, n_dimensions=16, n_or=10, n_and=6, bucket_length=4.0
        )
        queries = pw.debug.table_from_rows(
            pw.schema_from_types(emb=np.ndarray), [(vecs[i] + 0.01,) for i in range(0, 256, 32)]
        )
        return index.get_nearest_items(queries.emb, k=5, collapse_rows=False, with_distances=True)

    got = _values(same_stream(build))
    assert len(got) >= 8  # each query finds at least itself


# ----------------------------------------------------------------- knn_lsh


def test_knn_lsh_classifier_two_clusters():
    def build(pw):
        rng = np.random.default_rng(0)
        a = rng.normal(0, 0.2, (15, 6)) + 2.0
        b = rng.normal(0, 0.2, (15, 6)) - 2.0
        data = pw.debug.table_from_rows(pw.schema_from_types(data=np.ndarray), [(v,) for v in np.vstack([a, b])])
        labels = data.select(label=pw.apply(lambda v: "A" if float(np.asarray(v)[0]) > 0 else "B", data.data))
        queries = pw.debug.table_from_rows(
            pw.schema_from_types(data=np.ndarray), [(np.full(6, 2.1),), (np.full(6, -1.9),)]
        )
        cls = pw.stdlib.ml.classifiers
        model = cls.knn_lsh_classifier_train(data, L=5, type="euclidean", d=6, M=4, A=2.0)
        return cls.knn_lsh_classify(model, labels, queries, k=3)

    assert _values(same_stream(build)) == [("A",), ("B",)]


def test_knn_lsh_cosine_bucketer_shapes():
    out = {}
    for pw in (pathway_tpu, pathway_tpu_torch):
        bucketer = pw.stdlib.ml.classifiers.generate_cosine_lsh_bucketer(8, M=5, L=3, seed=1)
        out[pw.__name__] = (bucketer(np.ones((4, 8))), bucketer(np.ones((1, 8)))[0])
    (ref, ref_one), (port, port_one) = out["pathway_tpu"], out["pathway_tpu_torch"]
    assert port.shape == (4, 3) and np.array_equal(port, ref) and np.array_equal(port_one, ref_one)
    assert (port_one == port[0]).all()


def test_knn_lsh_classifier_surface_matches_the_reference():
    ref, port = pathway_tpu.stdlib.ml, pathway_tpu_torch.stdlib.ml
    assert sorted(port.__all__) == sorted(ref.__all__)
    assert sorted(port.classifiers.__all__) == sorted(ref.classifiers.__all__)


# ------------------------------------------------------------------- fuzzy


def _names(pw, col, values):
    return pw.debug.table_from_rows(pw.schema_from_types(**{col: str}), [(v,) for v in values])


def test_fuzzy_match_tables_pairs_similar_rows():
    def build(pw):
        left = _names(pw, "name", ["Apple Inc.", "Microsoft Corp", "Banana republic"])
        right = _names(pw, "company", ["apple incorporated", "MICROSOFT corporation", "orange llc"])
        m = pw.stdlib.ml.smart_table_ops.fuzzy_match_tables(left, right)
        return m.select(
            name=left.ix(m.left, context=m).name, company=right.ix(m.right, context=m).company, weight=m.weight
        )

    got = {(n, c) for (n, c, _w) in _values(same_stream(build))}
    assert got == {("Apple Inc.", "apple incorporated"), ("Microsoft Corp", "MICROSOFT corporation")}


def test_fuzzy_self_match_excludes_identity():
    def build(pw):
        t = _names(pw, "name", ["data pipeline alpha", "data pipeline beta", "zebra"])
        return pw.stdlib.ml.smart_table_ops.fuzzy_self_match(t)

    pairs = _values(same_stream(build))
    assert pairs and all(int(left) != int(right) for (left, right, _w) in pairs)


# --------------------------------------------------------------------- hmm


class _DiGraph:
    """The part of ``networkx.DiGraph`` the HMM reducer reads."""

    def __init__(self):
        self.nodes: dict = {}
        self._succ: dict = {}
        self.graph: dict = {}

    def add_node(self, node, **attrs):
        self.nodes[node] = attrs
        self._succ.setdefault(node, {})

    def add_edge(self, a, b, **attrs):
        self._succ.setdefault(a, {})[b] = attrs

    def successors(self, node):
        return iter(self._succ[node])

    def get_edge_data(self, a, b):
        return self._succ[a][b]


def _manul_graph():
    def emission(state):
        table = {"HUNGRY": {"GRUMPY": 0.9, "HAPPY": 0.1}, "FULL": {"GRUMPY": 0.2, "HAPPY": 0.8}}[state]
        return lambda obs: math.log(table[obs])

    g = _DiGraph()
    for s in ("HUNGRY", "FULL"):
        g.add_node(s, calc_emission_log_ppb=emission(s))
    for a in ("HUNGRY", "FULL"):
        for b in ("HUNGRY", "FULL"):
            g.add_edge(a, b, log_transition_ppb=math.log(0.6 if a == b else 0.4))
    g.graph["start_nodes"] = ["HUNGRY", "FULL"]
    return g


@pytest.mark.parametrize("beam_size,kept", [(None, None), (1, 3)])
def test_hmm_reducer_decodes_states(beam_size, kept):
    def build(pw):
        t = pw.debug.table_from_markdown(
            """
            observation | __time__
            HAPPY  | 2
            HAPPY  | 4
            GRUMPY | 6
            GRUMPY | 8
            """
        )
        reducer = _mod(pw, "stdlib.ml.hmm").create_hmm_reducer(_manul_graph(), beam_size=beam_size, num_results_kept=kept)
        return t.reduce(path=reducer(t.observation))

    stream = same_stream(build)
    [(path,)] = _values(stream)
    if kept is None:
        assert path == ("FULL", "FULL", "HUNGRY", "HUNGRY")
    assert len({t for t, _k, _d, _r in stream}) == 4  # one decoded path per tick


def test_datasets_load_a_local_file_and_refuse_a_download(tmp_path):
    arr = np.arange(12, dtype=np.float32).reshape(3, 4)
    np.save(tmp_path / "lsh.npy", arr)
    for pw in (pathway_tpu, pathway_tpu_torch):
        datasets = _mod(pw, "stdlib.ml.datasets")
        assert np.array_equal(datasets.load_lsh_test_data(str(tmp_path / "lsh.npy")), arr)
        with pytest.raises(NotImplementedError, match="network access"):
            datasets.load_lsh_test_data()
    assert pathway_tpu_torch.stdlib.ml.datasets is _mod(pathway_tpu_torch, "stdlib.ml.datasets")
