"""The port's dataflow engine against the JAX package's, pipeline by pipeline.

Each pipeline is written once as ``build(pw)`` and run through ``pathway_tpu``
and ``pathway_tpu_torch``; the captured update streams ``(time, key, diff,
values)`` must be identical, keys included. Both packages read the same
environment variables, so knobs are set once with ``monkeypatch`` for both,
and each package's parse graph is cleared before its run.
"""

from __future__ import annotations

import numpy as np
import pytest

import pathway_tpu
import pathway_tpu_torch
from pathway_tpu.debug import _capture as _capture_ref
from pathway_tpu_torch.debug import _capture as _capture_port


def _norm(v):
    if isinstance(v, (np.datetime64, np.timedelta64)):
        return v
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, tuple):
        return tuple(_norm(x) for x in v)
    if isinstance(v, np.ndarray):
        return ("ndarray", v.dtype.str, v.shape, tuple(v.ravel().tolist()))
    return v


def update_stream(pw, build) -> dict[str, list]:
    """Every output table of ``build(pw)`` → its update stream."""
    pw.G.clear()
    capture = _capture_port if pw is pathway_tpu_torch else _capture_ref
    out = build(pw)
    tables = out if isinstance(out, dict) else {"out": out}
    return {
        name: [(t, k, d, tuple(_norm(v) for v in row)) for (t, k, d, row) in capture(tab).deltas]
        for name, tab in tables.items()
    }


# ------------------------------------------------------------------ pipelines

_MD = """
    k | v  | g | f
    1 | 10 | a | 1.5
    2 | 20 | b | -2.25
    3 | 30 | a | 0.125
    4 | 45 | c | 3.0
    5 | 7  | b | 10.5
"""


def _base(pw):
    return pw.debug.table_from_markdown(_MD)


def p_select_filter(pw):
    t = _base(pw)
    s = t.select(t.k, w=t.v * 2 + 1, h=t.f / 2, s=t.g + "!")
    return s.filter(s.w > 21)


def p_with_columns(pw):
    t = _base(pw)
    return t.with_columns(
        big=t.v > 15,
        cls=pw.if_else(t.v % 2 == 0, "even", "odd"),
        neg=-t.f,
    )


def p_apply(pw):
    t = _base(pw)
    return t.select(
        t.k,
        a=pw.apply(lambda v, g: f"{g}{v * 3}", t.v, t.g),
        b=pw.apply_with_type(lambda f: round(f * 4), int, t.f),
    )


def p_groupby_count_sum(pw):
    t = _base(pw)
    return t.groupby(t.g).reduce(t.g, n=pw.reducers.count(), tot=pw.reducers.sum(t.v))


def p_groupby_min_max(pw):
    t = _base(pw)
    return t.groupby(t.g).reduce(
        t.g, lo=pw.reducers.min(t.f), hi=pw.reducers.max(t.v), fs=pw.reducers.sum(t.f)
    )


def p_groupby_tuple(pw):
    t = _base(pw)
    return t.groupby(t.g).reduce(t.g, vs=pw.reducers.tuple(t.v), ks=pw.reducers.sorted_tuple(t.k))


def p_reduce_global(pw):
    t = _base(pw)
    return t.reduce(n=pw.reducers.count(), tot=pw.reducers.sum(t.v), mx=pw.reducers.max(t.f))


def _right(pw):
    return pw.debug.table_from_markdown(
        """
        g | label | w
        a | alpha | 100
        b | beta  | 200
        d | delta | 400
        """
    )


def p_join_inner(pw):
    t, r = _base(pw), _right(pw)
    return t.join(r, t.g == r.g).select(t.k, r.label, s=t.v + r.w)


def p_join_left(pw):
    t, r = _base(pw), _right(pw)
    return t.join_left(r, t.g == r.g).select(t.k, t.g, lbl=r.label)


def p_ix(pw):
    t, r = _base(pw), _right(pw)
    keyed = r.with_id_from(r.g)
    ptr = t.select(t.k, p=keyed.pointer_from(t.g))
    return ptr.select(ptr.k, lbl=keyed.ix(ptr.p, optional=True).label)


def p_flatten(pw):
    t = _base(pw)
    s = t.select(t.k, parts=pw.apply(lambda v: tuple(range(v % 4)), t.v))
    return s.flatten(s.parts)


def p_concat_update_rows(pw):
    t = _base(pw)
    other = pw.debug.table_from_markdown(
        """
        k  | v   | g | f
        10 | 1   | z | 0.5
        11 | 2   | y | 0.25
        """
    )
    upd = t.filter(t.k > 3).select(t.k, v=t.v + 1000, g=t.g, f=t.f)
    return {
        "concat": t.concat_reindex(other),
        "update_rows": t.update_rows(upd),
    }


_STREAM_MD = """
    k | v  | g | __time__ | __diff__
    1 | 10 | a | 2        | 1
    2 | 20 | b | 2        | 1
    3 | 30 | a | 4        | 1
    1 | 10 | a | 6        | -1
    1 | 15 | a | 6        | 1
    2 | 20 | b | 8        | -1
    4 | 40 | b | 8        | 1
"""


def p_markdown_stream(pw):
    t = pw.debug.table_from_markdown(_STREAM_MD)
    return {
        "rows": t.select(t.k, w=t.v * 3),
        "agg": t.groupby(t.g).reduce(t.g, n=pw.reducers.count(), tot=pw.reducers.sum(t.v)),
    }


def p_stream_join(pw):
    t = pw.debug.table_from_markdown(_STREAM_MD)
    r = _right(pw)
    j = t.join(r, t.g == r.g).select(t.k, r.label, s=t.v + r.w)
    return j.groupby(j.label).reduce(j.label, tot=pw.reducers.sum(j.s))


def p_engine_chain(pw):
    """engine_bench's filter → join → groupby/sum at a CPU-test size."""
    rng = np.random.default_rng(0)
    n, m = 3000, 300

    class L(pw.Schema):
        k: int
        x: int

    class R(pw.Schema):
        k: int
        y: int

    left = pw.debug.table_from_rows(
        L, [(int(a), int(b)) for a, b in zip(rng.integers(0, m, n), rng.integers(0, 100, n))]
    )
    right = pw.debug.table_from_rows(R, [(i, i * 7 % 13) for i in range(m)])
    f = left.filter(left.x > 20)
    j = f.join(right, f.k == right.k).select(f.k, z=f.x * right.y)
    return j.groupby(j.k).reduce(j.k, tot=pw.reducers.sum(j.z), n=pw.reducers.count())


def _double_udf(pw):
    """A deterministic batched UDF of ``pw``'s UDF class."""

    class Double(pw.UDF):
        is_batched = True

        def __init__(self):
            super().__init__(_fn=lambda xs: [x * 2 + 1 for x in xs], return_type=int)

    return Double()


def _udf_events():
    return (
        [(i, 10 + i, i // 8, 1) for i in range(48)]
        + [(3, 13, 2, -1), (3, 113, 3, 1)]
        + [(40, 50, 6, -1)]
    )


def p_batched_udf(pw):
    class KS(pw.Schema):
        k: int = pw.column_definition(primary_key=True)
        x: int

    u = _double_udf(pw)
    t = pw.debug.table_from_rows(KS, _udf_events(), is_stream=True)
    s = t.select(t.k, y=u(t.x), parity=t.x % 2)
    return {"rows": s, "agg": s.groupby(s.parity).reduce(s.parity, total=pw.reducers.sum(s.y))}


def p_retract_mid_buffer(pw):
    class KS(pw.Schema):
        k: int = pw.column_definition(primary_key=True)
        x: int

    u = _double_udf(pw)
    t = pw.debug.table_from_rows(
        KS, [(1, 10, 0, 1), (3, 13, 0, 1), (2, 20, 1, 1), (3, 13, 2, -1)], is_stream=True
    )
    return t.select(t.k, y=u(t.x))


def p_pointer_and_coalesce(pw):
    t = _base(pw)
    s = t.select(t.k, p=t.pointer_from(t.g), c=pw.coalesce(None, t.v), m=pw.make_tuple(t.k, t.g))
    return s


def p_difference_intersect(pw):
    t = _base(pw)
    sub = t.filter(t.v > 15)
    return {"difference": t.difference(sub), "intersect": t.intersect(sub), "restrict": t.restrict(sub)}


def p_groupby_expression_key(pw):
    t = _base(pw)
    s = t.select(t.k, b=t.v // 10, f=t.f)
    return s.groupby(s.b).reduce(s.b, avg=pw.reducers.avg(s.f), any=pw.reducers.min(s.k))


PIPELINES = {
    "select_filter": (p_select_filter, {}),
    "with_columns": (p_with_columns, {}),
    "apply": (p_apply, {}),
    "groupby_count_sum": (p_groupby_count_sum, {}),
    "groupby_min_max": (p_groupby_min_max, {}),
    "groupby_tuple": (p_groupby_tuple, {}),
    "groupby_expression_key": (p_groupby_expression_key, {}),
    "reduce_global": (p_reduce_global, {}),
    "join_inner": (p_join_inner, {}),
    "join_left": (p_join_left, {}),
    "ix": (p_ix, {}),
    "flatten": (p_flatten, {}),
    "concat_update_rows": (p_concat_update_rows, {}),
    "difference_intersect": (p_difference_intersect, {}),
    "pointer_and_coalesce": (p_pointer_and_coalesce, {}),
    "markdown_stream": (p_markdown_stream, {}),
    "stream_join": (p_stream_join, {}),
    "engine_chain": (p_engine_chain, {}),
    "engine_chain_unfused": (p_engine_chain, {"PATHWAY_FUSE": "off"}),
    "batched_udf_off": (p_batched_udf, {"PATHWAY_MICROBATCH": "off"}),
    # a flush deadline past the run: the wall-clock deadline would make the
    # flush tick, and so the stream's times, depend on the host's speed
    "batched_udf_auto": (
        p_batched_udf,
        {"PATHWAY_MICROBATCH": "auto", "PATHWAY_MICROBATCH_FLUSH_MS": "60000"},
    ),
    "retract_mid_buffer": (
        p_retract_mid_buffer,
        {"PATHWAY_MICROBATCH": "auto", "PATHWAY_MICROBATCH_FLUSH_MS": "60000"},
    ),
}


@pytest.fixture(autouse=True)
def _fresh_port_graph():
    pathway_tpu_torch.G.clear()
    yield
    pathway_tpu_torch.G.clear()


@pytest.mark.parametrize("name", sorted(PIPELINES))
def test_update_stream_matches_reference(name, monkeypatch):
    build, env = PIPELINES[name]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    want = update_stream(pathway_tpu, build)
    got = update_stream(pathway_tpu_torch, build)
    assert want, "the pipeline produced no output table"
    assert any(want.values()), "the reference emitted no update"
    assert got == want


def test_microbatch_auto_stream_equals_off(monkeypatch):
    """The port keeps the reference's promise within itself: cross-tick
    microbatching changes launch shapes, never the final rows."""
    monkeypatch.setenv("PATHWAY_MICROBATCH", "off")
    off = update_stream(pathway_tpu_torch, p_batched_udf)
    monkeypatch.setenv("PATHWAY_MICROBATCH", "auto")
    auto = update_stream(pathway_tpu_torch, p_batched_udf)

    def final(stream):
        state: dict = {}
        for _t, k, d, row in stream:
            state[(k, row)] = state.get((k, row), 0) + d
        return {kr: n for kr, n in state.items() if n}

    for name in off:
        assert final(auto[name]) == final(off[name])


def test_unported_planes_raise_later_slice():
    # the flow plane is ported: a bulk-class subscriber sees what the
    # reference's sees
    seen = {}
    for pw in (pathway_tpu, pathway_tpu_torch):
        pw.G.clear()
        got = seen[pw.__name__] = []
        bulk = pw.debug.table_from_markdown(_MD)
        pw.io.subscribe(bulk, lambda key, row, time, is_addition, got=got: got.append((key, row, time, is_addition)),
                        service_class="bulk")
        pw.run()
        pw.G.clear()
    assert seen["pathway_tpu_torch"] == seen["pathway_tpu"] and len(seen["pathway_tpu"]) == 5
    t = pathway_tpu_torch.debug.table_from_markdown(_MD)
    with pytest.raises(NotImplementedError, match="later slice: sql"):
        pathway_tpu_torch.sql("SELECT v FROM t", t=t)
    pathway_tpu_torch.io.subscribe(t, lambda **kw: None)
    with pytest.raises(NotImplementedError, match="later slice: persistence"):
        pathway_tpu_torch.run(persistence_config=object())
    with pytest.raises(NotImplementedError, match="later slice: parallel.sharded"):
        pathway_tpu_torch.run(n_workers=2)


def _live_subject_run(pw) -> dict:
    """``pw.io.python.read`` of a live subject → groupby → ``pw.io.subscribe``
    under ``pw.run``; returns the subscriber's final state by key. Tick
    boundaries follow the connector thread's timing, so the final state, not
    the update stream, is compared."""
    pw.G.clear()

    class Subject(pw.io.python.ConnectorSubject):
        def run(self):
            for i in range(40):
                self.next(word=f"w{i % 7}", n=i)

    class S(pw.Schema):
        word: str
        n: int

    t = pw.io.python.read(Subject(), schema=S)
    agg = t.groupby(t.word).reduce(t.word, total=pw.reducers.sum(t.n), c=pw.reducers.count())
    state: dict = {}

    def on_change(key, row, time, is_addition):
        if is_addition:
            state[int(key)] = (row["word"], int(row["total"]), int(row["c"]))
        elif state.get(int(key)) == (row["word"], int(row["total"]), int(row["c"])):
            del state[int(key)]

    pw.io.subscribe(agg, on_change)
    pw.run()
    pw.G.clear()
    return state


def test_live_connector_subscribe_final_state_matches_reference():
    want = _live_subject_run(pathway_tpu)
    got = _live_subject_run(pathway_tpu_torch)
    assert len(want) == 7
    assert got == want
