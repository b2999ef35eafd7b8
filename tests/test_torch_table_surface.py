"""The rest of the Table API surface in the port against the reference:
``pw.sql``, ``pw.load_yaml``, exported tables, universes, interactive mode,
the row-transformer API and ``stdlib.viz`` (reference tests
``test_sql_yaml_ann``, ``test_exported``, ``test_universes`` and the
``interactive`` / ``row_transformer`` cases of ``test_ml_extras``).

Each pipeline is written once as ``build(pw)`` and runs through both
packages; the captured update streams ``(time, key, diff, values)`` must be
identical, keys included. Each package's parse graph is cleared before its
run.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np
import pytest

import pathway_tpu
import pathway_tpu_torch
from pathway_tpu.debug import _capture as _capture_ref
from pathway_tpu_torch.debug import _capture as _capture_port

PACKAGES = (pathway_tpu, pathway_tpu_torch)


def _norm(v):
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, tuple):
        return tuple(_norm(x) for x in v)
    return v


def update_stream(pw, build) -> dict[str, list]:
    pw.G.clear()
    capture = _capture_port if pw is pathway_tpu_torch else _capture_ref
    out = build(pw)
    tables = out if isinstance(out, dict) else {"out": out}
    got = {
        name: [(t, k, d, tuple(_norm(v) for v in row)) for (t, k, d, row) in capture(tab).deltas]
        for name, tab in tables.items()
    }
    pw.G.clear()
    return got


def final_rows(stream):
    state: dict = {}
    for _t, k, d, row in stream:
        state[(k, row)] = state.get((k, row), 0) + d
    return sorted((row for (_k, row), n in state.items() for _ in range(n)), key=repr)


def _both(build):
    ref = update_stream(pathway_tpu, build)
    port = update_stream(pathway_tpu_torch, build)
    assert port == ref
    return port


# ------------------------------------------------------------------------ sql


def _tab(pw):
    return pw.debug.table_from_rows(pw.schema_from_types(a=int, b=int), [(1, 10), (2, 20), (3, 30), (1, 5)])


def _names(pw):
    return pw.debug.table_from_rows(pw.schema_from_types(a=int, name=str), [(1, "x"), (2, "y"), (9, "z")])


def _ax(pw):
    return pw.debug.table_from_rows(pw.schema_from_types(k=int, x=int), [(1, 100), (2, 200)])


def _bx(pw):
    return pw.debug.table_from_rows(pw.schema_from_types(k=int, x=int), [(1, -1)])


def _nullable(pw):
    return pw.debug.table_from_rows(pw.schema_from_types(a=int, s=Optional[str]), [(1, "x"), (2, None)])


#: query -> (tables it reads, the final rows the reference's test expects)
SQL = {
    "select_where_arithmetic_alias": (
        "SELECT a, b * 2 AS dbl FROM t WHERE b >= 10 AND a < 3", {"t": _tab}, [(1, 20), (2, 40)]),
    "group_by_having": (
        "SELECT a, SUM(b) AS total, COUNT(*) AS n FROM t GROUP BY a HAVING total > 10",
        {"t": _tab}, [(1, 15, 2), (2, 20, 1), (3, 30, 1)]),
    "join": (
        "SELECT t.a, names.name FROM t JOIN names ON t.a = names.a WHERE t.b > 5",
        {"t": _tab, "names": _names}, [(1, "x"), (2, "y")]),
    "left_join_pads": (
        "SELECT names.name, t.b FROM names LEFT JOIN t ON names.a = t.a",
        {"t": _tab, "names": _names}, [("x", 5), ("x", 10), ("y", 20), ("z", None)]),
    "global_aggregate": (
        "SELECT COUNT(*) AS n, AVG(b) AS m, MAX(b) AS mx FROM t", {"t": _tab}, [(4, 16.25, 30)]),
    "cte_union": (
        "WITH big AS (SELECT a FROM t WHERE b > 15) SELECT a FROM big UNION SELECT a FROM t WHERE a = 1",
        {"t": _tab}, [(1,), (2,), (3,)]),
    "union_all": ("SELECT a FROM t UNION ALL SELECT a FROM t", {"t": _tab}, [(1,)] * 4 + [(2,)] * 2 + [(3,)] * 2),
    "intersect": (
        "SELECT a FROM t WHERE b > 15 INTERSECT SELECT a FROM t WHERE a >= 2", {"t": _tab}, [(2,), (3,)]),
    "is_null": ("SELECT a FROM t WHERE s IS NULL", {"t": _nullable}, [(2,)]),
    "is_not_null_or": ("SELECT a FROM t WHERE s IS NOT NULL OR a = 2", {"t": _nullable}, [(1,), (2,)]),
    "same_named_columns": ("SELECT a.x FROM a LEFT JOIN b ON a.k = b.k", {"a": _ax, "b": _bx}, [(100,), (200,)]),
    "same_named_aliased": (
        "SELECT a.x AS ax, b.x AS bx FROM a LEFT JOIN b ON a.k = b.k", {"a": _ax, "b": _bx},
        [(100, -1), (200, None)]),
    "having_inline_aggregate": (
        "SELECT a, SUM(b) AS s FROM t GROUP BY a HAVING COUNT(*) > 1", {"t": _tab}, [(1, 15)]),
    "duplicate_names": ("SELECT SUM(a) , SUM(b) FROM t", {"t": _tab}, [(7, 65)]),
}


@pytest.mark.parametrize("case", sorted(SQL))
def test_sql_matches_reference(case):
    query, tables, expect = SQL[case]
    cols = {}

    def build(pw):
        out = pw.sql(query, **{name: make(pw) for name, make in tables.items()})
        cols[pw] = out.column_names()
        return out

    stream = _both(build)["out"]
    assert cols[pathway_tpu_torch] == cols[pathway_tpu]
    assert final_rows(stream) == sorted(expect, key=repr)


def test_sql_star_join_uniquifies_and_rejects_garbage():
    cols = {}
    for pw in PACKAGES:
        pw.G.clear()
        star = pw.sql("SELECT * FROM a JOIN b ON a.k = b.k", a=_ax(pw), b=_bx(pw))
        cols[pw] = star.column_names()
        for bad in ("DELETE FROM t", "SELECT a FROM missing"):
            with pytest.raises(ValueError):
                pw.sql(bad, t=_tab(pw))
        pw.G.clear()
    assert cols[pathway_tpu_torch] == cols[pathway_tpu]
    assert set(cols[pathway_tpu_torch]) == {"k", "x", "k_1", "x_1"}


# ----------------------------------------------------------------------- yaml


def test_yaml_tags_variables_sharing():
    spec = """
$dim: 16
$factory: !pw.stdlib.indexing.BruteForceKnnFactory
  dimensions: $dim
  reserved_space: 256
retriever: $factory
again: $factory
plain: {a: 1}
"""
    got = {}
    for pw in PACKAGES:
        out = pw.load_yaml(spec)
        assert isinstance(out["retriever"], pw.stdlib.indexing.BruteForceKnnFactory)
        assert out["retriever"] is out["again"]  # one definition -> one instance
        got[pw] = (out["retriever"].dimensions, out["retriever"].reserved_space, out["plain"])
    assert got[pathway_tpu_torch] == got[pathway_tpu] == (16, 256, {"a": 1})


def test_yaml_env_fallback_and_errors(monkeypatch):
    monkeypatch.setenv("PW_TEST_SETTING", "7")
    for pw in PACKAGES:
        assert pw.load_yaml("x: $PW_TEST_SETTING") == {"x": 7}
        with pytest.raises(KeyError):
            pw.load_yaml("x: $undefined_lowercase")
        with pytest.raises(ValueError, match="circular"):
            pw.load_yaml("$a: $b\n$b: $a\nx: $a")


def test_yaml_empty_tag_calls_constructor():
    for pw in PACKAGES:
        out = pw.load_yaml("f: !pw.stdlib.indexing.TantivyBM25Factory\n")
        assert isinstance(out["f"], pw.stdlib.indexing.TantivyBM25Factory)


# ------------------------------------------------------------------- exported


def test_export_import_round_trip():
    """Graph 1 exports aggregates; graph 2 imports and transforms them; the
    exported stream and the imported update stream are the reference's."""
    got = {}
    for pw in PACKAGES:
        pw.G.clear()
        t = pw.debug.table_from_rows(pw.schema_from_types(k=int, v=int), [(i % 5, i) for i in range(100)])
        exported = pw.export_table(t.groupby(t.k).reduce(t.k, s=pw.reducers.sum(t.v)))
        pw.run(monitoring_level="none")
        assert exported.closed and not exported.failed()
        rows, _ = exported.data_from_offset(0)
        snap = exported.snapshot_at()
        imported = update_stream(
            pw, lambda pw, e=exported: (lambda im: im.select(k=im.k, d=im.s * 2))(pw.import_table(e))
        )
        got[pw] = (sorted(rows), len(snap), exported.column_names, imported)
    assert got[pathway_tpu_torch] == got[pathway_tpu]
    truth: dict = {}
    for i in range(100):
        truth[i % 5] = truth.get(i % 5, 0) + i
    assert final_rows(got[pathway_tpu_torch][3]["out"]) == sorted((k, 2 * s) for k, s in truth.items())


def test_export_preserves_keys_and_diffs():
    got = {}
    for pw in PACKAGES:
        pw.G.clear()

        class PkS(pw.Schema):
            w: str = pw.column_definition(primary_key=True)
            n: int

        t = pw.debug.table_from_rows(
            PkS, [("a", 1, 0, 1), ("b", 2, 0, 1), ("a", 1, 1, -1), ("a", 5, 1, 1)], is_stream=True
        )
        exported = pw.export_table(t)
        pw.run(monitoring_level="none")
        rows, _ = exported.data_from_offset(0)
        pw.G.clear()
        cap = (_capture_port if pw is pathway_tpu_torch else _capture_ref)(pw.import_table(exported))
        got[pw] = (rows, dict(cap.rows))
    assert got[pathway_tpu_torch] == got[pathway_tpu]
    rows, imported = got[pathway_tpu_torch]
    assert sum(d for *_, d in rows) == 2 and any(d < 0 for *_, d in rows)
    assert set(imported) <= {k for k, *_ in rows}
    assert sorted(imported.values()) == [("a", 5), ("b", 2)]


def test_live_export_to_concurrent_import():
    """The exporting run streams on a thread while a second graph imports
    live; the importer sees every row."""
    got = {}
    for pw in PACKAGES:
        pw.G.clear()

        class Subj(pw.io.python.ConnectorSubject):
            def run(self):
                for i in range(30):
                    self.next(x=i)
                    if i % 10 == 9:
                        time.sleep(0.02)

        t = pw.io.python.read(Subj(), schema=pw.schema_from_types(x=int))
        exported = pw.export_table(t.select(x=t.x, double=t.x * 2))
        th = threading.Thread(target=lambda pw=pw: pw.run(monitoring_level="none"))
        th.start()
        seen: dict = {}
        time.sleep(0.05)
        pw.G.clear()
        imported = pw.import_table(exported)
        pw.io.subscribe(imported, on_change=lambda key, row, time, is_addition: seen.__setitem__(row["x"], row["double"]))
        pw.run(monitoring_level="none")
        th.join()
        got[pw] = seen
    assert got[pathway_tpu_torch] == got[pathway_tpu] == {i: 2 * i for i in range(30)}


def test_frontier_and_subscribe_callbacks():
    got = {}
    for pw in PACKAGES:
        pw.G.clear()
        t = pw.debug.table_from_rows(pw.schema_from_types(x=int), [(i, i // 3, 1) for i in range(9)], is_stream=True)
        exported = pw.export_table(t)
        fired = []
        exported.subscribe(lambda e=exported, f=fired: f.append(e.frontier()))
        pw.run(monitoring_level="none")
        got[pw] = (exported.frontier(), fired)
    assert got[pathway_tpu_torch] == got[pathway_tpu]
    assert got[pathway_tpu_torch][0] >= 2 and got[pathway_tpu_torch][1][-1] >= 2


def test_failed_exporter_fails_importer():
    for pw in PACKAGES:
        pw.G.clear()

        def boom(v):
            raise ValueError("boom")

        t = pw.debug.table_from_rows(pw.schema_from_types(x=int), [(1,)])
        exported = pw.export_table(t.select(y=pw.apply(boom, t.x)))
        with pytest.raises(Exception):
            pw.run(monitoring_level="none")
        assert exported.closed and exported.failed()
        pw.G.clear()
        pw.io.subscribe(pw.import_table(exported), on_change=lambda **k: None)
        with pytest.raises(RuntimeError, match="connector failed"):
            pw.run(monitoring_level="none")
        pw.G.clear()


# ------------------------------------------------------------------ universes


def _kv(pw):
    return pw.debug.table_from_rows(pw.schema_from_types(k=int, v=int), [(1, 10), (2, 20), (3, 30)])


def test_universe_promises_match_reference():
    """``pw.universes`` promises let the relational layer accept what it
    would refuse, with the reference's rows and keys."""

    def restrict(pw):
        t = _kv(pw)
        other = pw.debug.table_from_rows(pw.schema_from_types(k=int, v=int), [(1, 0)])
        with pytest.raises(Exception):
            t.restrict(other)
        pw.universes.promise_is_subset_of(other, t)
        return t.restrict(other)

    def equal(pw):
        t = _kv(pw)
        other = pw.debug.table_from_rows(pw.schema_from_types(k=int, v=int), [(9, 9), (8, 8), (7, 7)])
        with pytest.raises(Exception):
            t.select(a=t.v, b=other.v)
        pw.universes.promise_are_equal(t, other)
        pw.universes.promise_are_pairwise_disjoint(t, other)
        return t.select(a=t.v, b=other.v)

    assert final_rows(_both(restrict)["out"]) == [(1, 10)]
    assert final_rows(_both(equal)["out"]) == [(10, 9), (20, 8), (30, 7)]


def test_universe_relations_of_table_operators():
    got = {}
    for pw in PACKAGES:
        pw.G.clear()
        solver = __import__(f"{pw.__name__}.internals.universe", fromlist=["solver"]).solver()
        t = _kv(pw)
        f = t.filter(t.v > 15)
        g = f.filter(f.v > 25)
        names = pw.debug.table_from_rows(pw.schema_from_types(k=int, name=str), [(1, "a"), (2, "b")])
        j = t.join(names, t.k == names.k, id=t.id).select(v=t.v, name=names.name)
        got[pw] = (
            solver.query_is_subset(f._universe, t._universe),
            solver.query_is_subset(t._universe, f._universe),
            solver.query_is_subset(g._universe, t._universe),
            solver.query_is_subset(t.intersect(f)._universe, t._universe),
            solver.query_is_subset(t.difference(f)._universe, t._universe),
            solver.query_is_subset(j._universe, t._universe),
        )
        pw.G.clear()
    assert got[pathway_tpu_torch] == got[pathway_tpu] == (True, False, True, True, True, True)


def test_update_cells_intersect_difference_rows():
    def build(pw):
        t = _kv(pw)
        f = t.filter(t.v > 15)
        return {
            "updated": t.update_cells(t.filter(t.k == 2).select(v=t.v * 100)),
            "intersect": t.intersect(f),
            "difference": t.difference(f),
        }

    got = _both(build)
    assert final_rows(got["updated"]) == [(1, 10), (2, 2000), (3, 30)]
    assert final_rows(got["intersect"]) == [(2, 20), (3, 30)]
    assert final_rows(got["difference"]) == [(1, 10)]


# ---------------------------------------------------------- interactive mode


def test_interactive_mode_live_table(monkeypatch):
    """``pw.run`` in interactive mode returns a handle while the run goes on
    on a thread; the ``LiveTable`` converges to the reference's rows."""
    from pathway_tpu.internals import interactive as ref_interactive
    from pathway_tpu_torch.internals import interactive as port_interactive

    modes = {pathway_tpu: ref_interactive, pathway_tpu_torch: port_interactive}
    got = {}
    for pw in PACKAGES:
        pw.G.clear()

        class Subj(pw.io.python.ConnectorSubject):
            def run(self):
                for i in range(5):
                    self.next(x=i)
                    time.sleep(0.03)

        t = pw.io.python.read(Subj(), schema=pw.schema_from_types(x=int))
        view = pw.live(t.reduce(s=pw.reducers.sum(t.x)))
        monkeypatch.setattr(modes[pw], "_interactive", True)
        handle = pw.run(monitoring_level="none")
        assert handle is not None and hasattr(handle, "stop")
        deadline = time.time() + 15
        while time.time() < deadline:
            df = view.to_pandas()
            if len(df) and int(df.iloc[0]["s"]) == 10:
                break
            time.sleep(0.05)
        else:
            raise AssertionError(f"live view never converged: {view.to_pandas()}")
        handle.join(15)
        assert not handle.alive
        monkeypatch.setattr(modes[pw], "_interactive", False)
        got[pw] = (view.to_pandas().to_dict("index"), len(view))
        pw.G.clear()
    assert got[pathway_tpu_torch] == got[pathway_tpu]


def test_viz_show_prints_outside_interactive_mode(capsys):
    out = {}
    for pw in PACKAGES:
        pw.G.clear()
        assert pw.stdlib.viz.show(_kv(pw)) is None
        out[pw] = capsys.readouterr().out
        pw.G.clear()
    assert out[pathway_tpu_torch] == out[pathway_tpu] and "30" in out[pathway_tpu_torch]


def test_viz_show_is_live_in_interactive_mode(monkeypatch):
    from pathway_tpu_torch.internals import interactive as port_interactive

    pw = pathway_tpu_torch
    pw.G.clear()
    monkeypatch.setattr(port_interactive, "_interactive", True)
    view = pw.stdlib.viz.table_viz(_kv(pw))
    assert isinstance(view, pw.LiveTable)
    handle = pw.run(monitoring_level="none")
    handle.join(15)
    monkeypatch.setattr(port_interactive, "_interactive", False)
    assert sorted(view.to_pandas()["v"].tolist()) == [10, 20, 30]
    pw.G.clear()


# ------------------------------------------------------------ row transformer


def _simple(pw):
    class OutputSchema(pw.Schema):
        ret: int

    @pw.transformer
    class foo_transformer:
        class table(pw.ClassArg, output=OutputSchema):
            arg = pw.input_attribute()

            @pw.output_attribute
            def ret(self) -> int:
                return self.arg + 1

    t = pw.debug.table_from_rows(pw.schema_from_types(arg=int), [(1,), (2,), (3,)])
    return foo_transformer(t).table


def _traversal(pw):
    @pw.transformer
    class list_traversal:
        class nodes(pw.ClassArg):
            next = pw.input_attribute()
            val = pw.input_attribute()

        class requests(pw.ClassArg):
            node = pw.input_attribute()
            steps = pw.input_attribute()

            @pw.output_attribute
            def reached_value(self) -> int:
                node = self.transformer.nodes[self.node]
                for _ in range(self.steps):
                    node = self.transformer.nodes[node.next]
                return node.val

    nodes = pw.debug.table_from_rows(
        pw.schema_from_types(name=int, nxt=int, val=int), [(1, 2, 11), (2, 3, 12), (3, 3, 13)]
    ).with_id_from(pw.this.name)
    nodes = nodes.select(next=nodes.pointer_from(nodes.nxt), val=nodes.val)
    requests = pw.debug.table_from_rows(pw.schema_from_types(node=int, steps=int), [(1, 1), (3, 0)])
    requests = requests.select(node=nodes.pointer_from(requests.node), steps=requests.steps)
    return list_traversal(nodes, requests).requests


def _fib(pw):
    @pw.transformer
    class fib_transformer:
        class cells(pw.ClassArg):
            prev = pw.input_attribute()
            prev2 = pw.input_attribute()
            base = pw.input_attribute()

            @pw.output_attribute
            def value(self) -> int:
                if self.base is not None:
                    return self.base
                return self.transformer.cells[self.prev].value + self.transformer.cells[self.prev2].value

    rows = [(i, max(i - 1, 0), max(i - 2, 0), 1 if i < 2 else None) for i in range(12)]
    cells = pw.debug.table_from_rows(
        pw.schema_from_types(idx=int, p1=int, p2=int, base=Optional[int]), rows
    ).with_id_from(pw.this.idx)
    cells = cells.select(prev=cells.pointer_from(cells.p1), prev2=cells.pointer_from(cells.p2), base=cells.base)
    return fib_transformer(cells).cells


def _two_tables(pw):
    @pw.transformer
    class two_tables:
        class a(pw.ClassArg):
            x = pw.input_attribute()

            @pw.output_attribute
            def out(self):
                return self.x

        class b(pw.ClassArg):
            y = pw.input_attribute()

            @pw.output_attribute
            def dbl(self):
                return self.y * 2

    empty = pw.debug.table_from_rows(pw.schema_from_types(x=int), [])
    full = pw.debug.table_from_rows(pw.schema_from_types(y=int), [(5,), (7,)])
    res = two_tables(empty, full)
    return {"a": res.a, "b": res.b}


TRANSFORMERS = {
    "simple": (_simple, {"out": [(2,), (3,), (4,)]}),
    "cross_table_traversal": (_traversal, {"out": [(12,), (13,)]}),
    "memoized_recursion": (_fib, None),
    "empty_sibling_table": (_two_tables, {"a": [], "b": [(10,), (14,)]}),
}


@pytest.mark.parametrize("case", sorted(TRANSFORMERS))
def test_row_transformer_matches_reference(case):
    build, expect = TRANSFORMERS[case]
    got = _both(build)
    if expect is None:
        assert max(v for (v,) in final_rows(got["out"])) == 144  # fib(12)
    else:
        assert {name: final_rows(s) for name, s in got.items()} == expect


def test_row_transformer_rejects_extra_tables():
    for pw in PACKAGES:

        @pw.transformer
        class one_table:
            class t(pw.ClassArg):
                x = pw.input_attribute()

                @pw.output_attribute
                def out(self):
                    return self.x

        t1 = pw.debug.table_from_rows(pw.schema_from_types(x=int), [(1,)])
        with pytest.raises(TypeError, match="takes 1 tables"):
            one_table(t1, t1)
        with pytest.raises(TypeError, match="passed twice"):
            one_table(t1, t=t1)
        pw.G.clear()
