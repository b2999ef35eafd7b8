"""The port's temporal layer against the JAX package's, on the same inputs.

Mirrors ``tests/test_temporal.py`` test for test: windows (tumbling, sliding,
session, intervals_over), behaviors, interval/asof/as-of-now/window joins,
sort/diff, and the buffer/forget/freeze/forget_immediately primitives. Each
pipeline is written once as ``build(pw)`` and run through ``pathway_tpu`` and
``pathway_tpu_torch``; the captured update streams ``(time, key, diff,
values)`` must be identical, keys included. Both packages compute these on the
host in numpy and Python, so every value is compared exactly. The reference
test's own assertions are then checked on the port's stream.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import pytest

import pathway_tpu
import pathway_tpu_torch
from test_torch_engine_parity import update_stream


def same_streams(build) -> dict[str, list]:
    """Both packages' update streams of ``build``; asserts them identical and
    returns the port's."""
    ref = update_stream(pathway_tpu, build)
    port = update_stream(pathway_tpu_torch, build)
    assert port.keys() == ref.keys()
    for name in ref:
        assert port[name] == ref[name], (name, port[name], ref[name])
    return port


def same_stream(build) -> list:
    return same_streams(build)["out"]


def rows(stream) -> Counter:
    """Net rows of an update stream, as a multiset of value tuples."""
    net: Counter = Counter()
    for _t, k, d, row in stream:
        net[(k, row)] += d
    out: Counter = Counter()
    for (_k, row), n in net.items():
        assert n >= 0, row
        if n:
            out[row] += n
    return out


def assert_consistent(stream) -> None:
    """Every retraction retracts a row inserted before it."""
    state: Counter = Counter()
    for t, k, d, row in stream:
        state[(k, row)] += d
        assert state[(k, row)] >= 0, f"retraction without insertion at time {t}: {row}"


def assert_rows(stream, expected) -> None:
    assert rows(stream) == Counter(expected), sorted(rows(stream).items())


_EIGHT = '''
        | instance | t
    1   | 0        |  12
    2   | 0        |  13
    3   | 0        |  14
    4   | 0        |  15
    5   | 0        |  16
    6   | 0        |  17
    7   | 1        |  10
    8   | 1        |  11
    '''


def test_tumbling_window():
    def build(pw):
        t = pw.debug.table_from_markdown(_EIGHT)
        return t.windowby(
            t.t, window=pw.temporal.tumbling(duration=5), instance=t.instance
        ).reduce(
            pw.this._pw_instance,
            pw.this._pw_window_start,
            pw.this._pw_window_end,
            count=pw.reducers.count(),
        )

    assert_rows(same_stream(build), [(0, 10, 15, 3), (0, 15, 20, 3), (1, 10, 15, 2)])


def test_sliding_window_matches_reference_docstring():
    def build(pw):
        t = pw.debug.table_from_markdown(_EIGHT)
        return t.windowby(
            t.t, window=pw.temporal.sliding(duration=10, hop=3), instance=t.instance
        ).reduce(
            pw.this._pw_instance,
            pw.this._pw_window_start,
            pw.this._pw_window_end,
            min_t=pw.reducers.min(pw.this.t),
            max_t=pw.reducers.max(pw.this.t),
            count=pw.reducers.count(),
        )

    assert_rows(same_stream(build), [
        (0, 3, 13, 12, 12, 1),
        (0, 6, 16, 12, 15, 4),
        (0, 9, 19, 12, 17, 6),
        (0, 12, 22, 12, 17, 6),
        (0, 15, 25, 15, 17, 3),
        (1, 3, 13, 10, 11, 2),
        (1, 6, 16, 10, 11, 2),
        (1, 9, 19, 10, 11, 2),
    ])


def test_session_window_matches_reference_docstring():
    def build(pw):
        t = pw.debug.table_from_markdown('''
            | instance |  t |  v
        1   | 0        |  1 |  10
        2   | 0        |  2 |  1
        3   | 0        |  4 |  3
        4   | 0        |  8 |  2
        5   | 0        |  9 |  4
        6   | 0        |  10|  8
        7   | 1        |  1 |  9
        8   | 1        |  2 |  16
        ''')
        return t.windowby(
            t.t,
            window=pw.temporal.session(predicate=lambda a, b: abs(a - b) <= 1),
            instance=t.instance,
        ).reduce(
            pw.this._pw_instance,
            pw.this._pw_window_start,
            pw.this._pw_window_end,
            min_t=pw.reducers.min(pw.this.t),
            max_v=pw.reducers.max(pw.this.v),
            count=pw.reducers.count(),
        )

    assert_rows(same_stream(build), [
        (0, 1, 2, 1, 10, 2),
        (0, 4, 4, 4, 3, 1),
        (0, 8, 10, 8, 8, 3),
        (1, 1, 2, 1, 16, 2),
    ])


def test_session_window_max_gap_incremental():
    def build(pw):
        t = pw.debug.table_from_markdown('''
            | t | __time__
        1   | 1 | 2
        2   | 5 | 2
        3   | 3 | 4
        ''')
        return t.windowby(t.t, window=pw.temporal.session(max_gap=3)).reduce(
            pw.this._pw_window_start, cnt=pw.reducers.count()
        )

    s = same_stream(build)
    assert_consistent(s)
    assert_rows(s, [(1, 3)])


def _intervals_over(lower, upper, m_md, p_md):
    def build(pw):
        m = pw.debug.table_from_markdown(m_md)
        pts = pw.debug.table_from_markdown(p_md)
        w = pw.temporal.intervals_over(at=pts.p, lower_bound=lower, upper_bound=upper, is_outer=True)
        return m.windowby(m.t, window=w).reduce(
            pw.this._pw_window_location,
            vsum=pw.reducers.sum(pw.this.v),
            cnt=pw.reducers.count(),
        )

    return build


def test_intervals_over():
    s = same_stream(_intervals_over(-2, 1, '''
        | t  | v
    1   | 1  | 10
    2   | 3  | 13
    3   | 7  | 20
    ''', '''
        | p
    1   | 2
    2   | 6
    3   | 100
    '''))
    got = {row[0]: row[1] for row in rows(s)}
    assert got[2] == 23 and got[6] == 20
    assert 100 in got


_T1 = '''
        | a | t
    1   | 1 | 3
    2   | 2 | 4
    3   | 3 | 7
    '''
_T2 = '''
        | b | t
    1   | 10 | 2
    2   | 20 | 5
    3   | 30 | 9
    '''


def test_interval_join_inner_and_outer():
    def build(pw):
        t1 = pw.debug.table_from_markdown(_T1 + "9   | 9 | 100\n")
        t2 = pw.debug.table_from_markdown(_T2)
        inner = t1.interval_join(t2, t1.t, t2.t, pw.temporal.interval(-2, 1)).select(t1.a, t2.b)
        left = pw.temporal.interval_join_left(
            t1, t2, t1.t, t2.t, pw.temporal.interval(-2, 1)
        ).select(t1.a, b=pw.coalesce(t2.b, -1))
        outer = pw.temporal.interval_join_outer(
            t1, t2, t1.t, t2.t, pw.temporal.interval(-2, 1)
        ).select(a=pw.coalesce(t1.a, -1), b=pw.coalesce(t2.b, -1))
        right = pw.temporal.interval_join_right(
            t1, t2, t1.t, t2.t, pw.temporal.interval(-2, 1)
        ).select(a=pw.coalesce(t1.a, -1), b=t2.b)
        return {"inner": inner, "left": left, "outer": outer, "right": right}

    s = same_streams(build)
    assert_rows(s["inner"], [(1, 10), (2, 10), (2, 20), (3, 20)])
    assert_rows(s["left"], [(1, 10), (2, 10), (2, 20), (3, 20), (9, -1)])
    assert_rows(s["outer"], [(1, 10), (2, 10), (2, 20), (3, 20), (9, -1), (-1, 30)])
    assert_rows(s["right"], [(1, 10), (2, 10), (2, 20), (3, 20), (-1, 30)])


def test_interval_join_with_on_condition():
    def build(pw):
        t1 = pw.debug.table_from_markdown('''
            | k | t
        1   | 1 | 3
        2   | 2 | 3
        ''')
        t2 = pw.debug.table_from_markdown('''
            | k | t | v
        1   | 1 | 4 | 100
        2   | 2 | 9 | 200
        ''')
        return t1.interval_join(
            t2, t1.t, t2.t, pw.temporal.interval(0, 2), t1.k == t2.k
        ).select(t1.k, t2.v)

    assert_rows(same_stream(build), [(1, 100)])


def test_interval_join_streaming_retraction():
    def build(pw):
        t1 = pw.debug.table_from_markdown('''
            | a | t | __time__ | __diff__
        1   | 1 | 3 | 2        | 1
        1   | 1 | 3 | 6        | -1
        ''')
        t2 = pw.debug.table_from_markdown('''
            | b | t | __time__
        1   | 10 | 2 | 4
        ''')
        return t1.interval_join(t2, t1.t, t2.t, pw.temporal.interval(-2, 2)).select(t1.a, t2.b)

    s = same_stream(build)
    assert_consistent(s)
    assert rows(s) == Counter()
    assert [(t, d) for t, _k, d, _r in s] == [(4, 1), (6, -1)]


def test_asof_join_directions():
    def build(pw):
        t1 = pw.debug.table_from_markdown(_T1)
        t2 = pw.debug.table_from_markdown(_T2)
        return {
            direction: pw.temporal.asof_join(
                t1, t2, t1.t, t2.t, how="left", direction=direction
            ).select(t1.a, b=pw.coalesce(t2.b, -1))
            for direction in ("backward", "forward", "nearest")
        }

    s = same_streams(build)
    assert_rows(s["backward"], [(1, 10), (2, 10), (3, 20)])
    assert_rows(s["forward"], [(1, 20), (2, 20), (3, 30)])
    assert_rows(s["nearest"], [(1, 10), (2, 20), (3, 20)])


def test_asof_join_updates_on_new_right_rows():
    def build(pw):
        t1 = pw.debug.table_from_markdown('''
            | a | t | __time__
        1   | 1 | 10 | 2
        ''')
        t2 = pw.debug.table_from_markdown('''
            | b | t | __time__
        1   | 100 | 2 | 2
        2   | 200 | 8 | 4
        ''')
        return pw.temporal.asof_join(t1, t2, t1.t, t2.t, how="left").select(t1.a, t2.b)

    s = same_stream(build)
    assert_consistent(s)
    assert_rows(s, [(1, 200)])
    assert any(d == -1 and row == (1, 100) for _t, _k, d, row in s)  # old match retracted


def test_asof_now_join_does_not_update():
    def build(pw):
        queries = pw.debug.table_from_markdown('''
            | q | __time__
        1   | 1 | 4
        ''')
        state = pw.debug.table_from_markdown('''
            | k | v | __time__ | __diff__
        1   | 1 | 100 | 2      | 1
        1   | 1 | 100 | 6      | -1
        2   | 1 | 999 | 6      | 1
        ''')
        inner = queries.asof_now_join(state, queries.q == state.k).select(queries.q, state.v)
        left = pw.temporal.asof_now_join_left(
            queries, state, queries.q == state.k + 1
        ).select(queries.q, v=pw.coalesce(state.v, -1))
        return {"inner": inner, "left": left}

    s = same_streams(build)
    assert_rows(s["inner"], [(1, 100)])
    assert all(row != (1, 999) for _t, _k, _d, row in s["inner"])
    assert_rows(s["left"], [(1, -1)])


def test_intervals_over_no_phantom_rows():
    s = same_stream(_intervals_over(-1, 1, '''
        | t  | v
    1   | 0  | 1
    2   | 1  | 2
    ''', '''
        | p
    1   | 1
    2   | 6
    '''))
    got = {row[0]: row[2] for row in rows(s)}
    assert got[1] == 2  # exactly t=0 and t=1, no pad
    assert got[6] == 1  # only the pad row


def test_asof_join_defaults():
    def build(pw):
        t1 = pw.debug.table_from_markdown('''
            | a | t
        1   | 1 | 1
        ''')
        t2 = pw.debug.table_from_markdown('''
            | b | t
        1   | 10 | 5
        ''')
        return pw.temporal.asof_join(
            t1, t2, t1.t, t2.t, how="left", defaults={t2.b: -7}
        ).select(t1.a, t2.b)

    assert_rows(same_stream(build), [(1, -7)])


def test_session_window_with_behavior():
    def build(pw):
        t = pw.debug.table_from_markdown('''
            | t | __time__
        1   | 1 | 2
        2   | 2 | 2
        ''')
        return t.windowby(
            t.t,
            window=pw.temporal.session(max_gap=3),
            behavior=pw.temporal.common_behavior(cutoff=100),
        ).reduce(pw.this._pw_window_start, cnt=pw.reducers.count())

    assert_rows(same_stream(build), [(1, 2)])


def test_datetime_hash_unit_invariance():
    from pathway_tpu.internals import keys as ref_keys
    from pathway_tpu_torch.internals.keys import hash_column, stable_hash_obj

    s = np.datetime64("2020-01-01", "s")
    ns = np.datetime64("2020-01-01", "ns")
    assert stable_hash_obj(s) == stable_hash_obj(ns) == ref_keys.stable_hash_obj(ns)
    assert hash_column(np.array([s]))[0] == hash_column(np.array([ns]))[0]
    obj = np.empty(1, dtype=object)
    obj[0] = s
    assert hash_column(obj)[0] == hash_column(np.array([ns]))[0] == ref_keys.hash_column(obj)[0]
    d = np.timedelta64(5, "s")
    assert stable_hash_obj(d) == ref_keys.stable_hash_obj(d)

    # a window over datetime times and durations: window rows' ids and
    # values equal the reference's bit for bit
    def build(pw):
        t = pw.debug.table_from_rows(
            pw.schema_from_types(at=pw.DateTimeNaive, v=int),
            [(np.datetime64("2020-01-01T00:00:00", "ns") + np.timedelta64(i * 7, "s"), i) for i in range(9)],
        )
        return t.windowby(
            t.at,
            window=pw.temporal.tumbling(
                duration=np.timedelta64(20, "s"), origin=np.datetime64("2020-01-01T00:00:00", "ns")
            ),
        ).reduce(pw.this._pw_window_start, pw.this._pw_window_end, n=pw.reducers.count())

    s = same_stream(build)
    assert sum(row[2] for row in rows(s)) == 9


def test_window_join():
    def build(pw):
        t1 = pw.debug.table_from_markdown(_T1)
        t2 = pw.debug.table_from_markdown(_T2)
        return {
            how: getattr(pw.temporal, f"window_join_{how}")(
                t1, t2, t1.t, t2.t, pw.temporal.tumbling(4)
            ).select(a=pw.coalesce(t1.a, -1), b=pw.coalesce(t2.b, -1))
            for how in ("inner", "left", "right", "outer")
        }

    s = same_streams(build)
    assert_rows(s["inner"], [(1, 10), (2, 20), (3, 20)])
    assert_rows(s["outer"], [(1, 10), (2, 20), (3, 20), (-1, 30)])


def test_sort_prev_next():
    def build(pw):
        t = pw.debug.table_from_markdown('''
            | x
        1   | 30
        2   | 10
        3   | 20
        ''')
        s = t.sort(t.x)
        joined = t.with_columns(prev=s.prev, next=s.next)
        nxt = t.ix(joined.next, optional=True)
        return {"joined": joined, "chase": t.select(pw.this.x, nx=nxt.x)}

    s = same_streams(build)
    by_x = {row[0]: (row[1], row[2]) for row in rows(s["joined"])}
    assert by_x[10][0] is None and by_x[30][1] is None
    assert {row[0]: row[1] for row in rows(s["chase"])} == {10: 20, 20: 30, 30: None}


def test_diff():
    def build(pw):
        m = pw.debug.table_from_markdown('''
            | t  | v | g
        1   | 1  | 10 | a
        2   | 3  | 13 | b
        3   | 7  | 20 | a
        4   | 8  | 25 | b
        ''')
        return {"all": m.diff(m.t, m.v), "per_g": m.diff(m.t, m.v, instance=m.g)}

    s = same_streams(build)
    assert_rows(s["all"], [(None,), (3,), (7,), (5,)])
    assert_rows(s["per_g"], [(None,), (None,), (10,), (12,)])


def test_buffer_releases_on_watermark():
    from pathway_tpu_torch.engine.graph import END_OF_STREAM

    def build(pw):
        s = pw.debug.table_from_markdown('''
            | t | __time__
        1   | 5 | 2
        2   | 1 | 2
        3   | 9 | 4
        ''')
        return s._buffer(pw.this.t + 2, pw.this.t)

    released = {row[0]: t for t, _k, _d, row in same_stream(build)}
    assert released[1] >= 2
    assert 5 in released and 9 in released
    assert released[9] == END_OF_STREAM  # flushed by close


def test_forget_retracts_past_cutoff():
    def build(pw):
        s = pw.debug.table_from_markdown('''
            | t | __time__
        1   | 1 | 2
        2   | 9 | 4
        ''')
        return s._forget(pw.this.t + 2, pw.this.t)

    s = same_stream(build)
    assert_consistent(s)
    assert_rows(s, [(9,)])


def test_freeze_drops_late_rows():
    def build(pw):
        s = pw.debug.table_from_markdown('''
            | t | v | __time__
        1   | 1 | 1 | 2
        2   | 9 | 2 | 4
        3   | 2 | 3 | 6
        ''')
        return s._freeze(pw.this.t + 2, pw.this.t)

    assert_rows(same_stream(build), [(1, 1), (9, 2)])


def test_forget_immediately():
    def build(pw):
        s = pw.debug.table_from_markdown('''
            | q | __time__
        1   | 7 | 2
        ''')
        return s._forget_immediately()

    s = same_stream(build)
    assert_consistent(s)
    assert rows(s) == Counter()
    assert [d for _t, _k, d, _r in s] == [1, -1]


# ------------------------------------------------ behaviors over windows


@pytest.mark.parametrize(
    "behavior",
    ["delay", "cutoff", "cutoff_forget", "exactly_once"],
)
def test_window_behaviors(behavior):
    """Each behavior the windows accept, over one out-of-order stream."""

    def build(pw):
        t = pw.debug.table_from_markdown('''
            | t  | __time__
        1   | 1  | 2
        2   | 4  | 2
        3   | 12 | 4
        4   | 3  | 6
        5   | 27 | 8
        6   | 6  | 10
        7   | 31 | 12
        ''')
        b = {
            "delay": pw.temporal.common_behavior(delay=4),
            "cutoff": pw.temporal.common_behavior(cutoff=4),
            "cutoff_forget": pw.temporal.common_behavior(cutoff=4, keep_results=False),
            "exactly_once": pw.temporal.exactly_once_behavior(shift=2),
        }[behavior]
        return t.windowby(t.t, window=pw.temporal.tumbling(duration=10), behavior=b).reduce(
            pw.this._pw_window_start, cnt=pw.reducers.count(), mx=pw.reducers.max(pw.this.t)
        )

    s = same_stream(build)
    assert_consistent(s)
    assert s


def test_interval_join_with_behavior():
    def build(pw):
        t1 = pw.debug.table_from_markdown('''
            | a | t  | __time__
        1   | 1 | 3  | 2
        2   | 2 | 20 | 4
        3   | 3 | 4  | 6
        ''')
        t2 = pw.debug.table_from_markdown('''
            | b  | t  | __time__
        1   | 10 | 2  | 2
        2   | 20 | 21 | 4
        3   | 30 | 5  | 6
        ''')
        return t1.interval_join(
            t2, t1.t, t2.t, pw.temporal.interval(-2, 2),
            behavior=pw.temporal.common_behavior(cutoff=3),
        ).select(t1.a, t2.b)

    s = same_stream(build)
    # (3, 30) arrives after the watermark reached 21: both rows are late
    assert_rows(s, [(1, 10), (2, 20)])


# ------------------------------------------------ device functions at full blocks


def test_tumbling_count_on_device_functions_at_131072_rows(monkeypatch):
    """131,072 seeded events in 2 ticks of 65,536: the fused filter/select
    chain and the window groupby's count/sum take the engine's device
    functions on CPU tensors (``PATHWAY_ENGINE_JAX=cpu``,
    ``PATHWAY_FUSE_JAX=on``), and the update stream equals the numpy routes'
    (the port's and the reference's) exactly."""
    from pathway_tpu_torch.engine import torch_kernels

    n, tick = 131_072, 65_536
    rng = np.random.default_rng(8)
    ts = np.sort(rng.integers(0, 105_000, n))  # event time in ms
    prices = rng.integers(-100, 100_000, n)
    auctions = rng.integers(0, 100, n)
    stream = [
        (int(ts[i]), int(auctions[i]), int(prices[i]), 2 * (1 + i // tick), 1) for i in range(n)
    ]

    def build(pw):
        t = pw.debug.table_from_rows(
            pw.schema_from_types(ms=int, auction=int, price=int), stream, is_stream=True
        )
        bids = t.filter(pw.this.price >= 0).select(pw.this.auction, pw.this.price, t=pw.this.ms)
        windows = bids.windowby(
            bids.t, window=pw.temporal.tumbling(duration=10_000), instance=bids.auction
        ).reduce(
            pw.this._pw_instance,
            pw.this._pw_window_start,
            n=pw.reducers.count(),
            total=pw.reducers.sum(pw.this.price),
        )
        # a second consumer ends the filter/select chain at the select, so it
        # stays one fused segment of numeric expressions
        return {"out": windows, "bids": bids.reduce(n=pw.reducers.count())}

    monkeypatch.setenv("PATHWAY_ENGINE_JAX", "0")
    monkeypatch.setenv("PATHWAY_FUSE_JAX", "off")
    ref = update_stream(pathway_tpu, build)
    torch_kernels.ROUTES.clear()
    numpy_route = update_stream(pathway_tpu_torch, build)
    assert torch_kernels.ROUTES == {}
    monkeypatch.setenv("PATHWAY_ENGINE_JAX", "cpu")
    monkeypatch.setenv("PATHWAY_FUSE_JAX", "on")
    device_route = update_stream(pathway_tpu_torch, build)
    assert torch_kernels.ROUTES.get("grouped/cpu", 0) >= 2, torch_kernels.ROUTES
    assert torch_kernels.ROUTES.get("fused/cpu", 0) >= 2, torch_kernels.ROUTES
    assert numpy_route == ref
    assert device_route == ref
    assert sum(row[2] for row in rows(ref["out"])) == int((prices >= 0).sum())
    assert rows(ref["bids"]) == {(int((prices >= 0).sum()),): 1}


# ------------------------------------------------ the Nexmark queries


@pytest.mark.parametrize("query", ["q5", "q7", "q7_cutoff", "q8", "surface"])
def test_nexmark_queries_match_the_reference(query):
    """``tools/nexmark.py``'s queries (the card phase's pipelines) over 8,192
    seeded events in ticks of 1,024: the port's update streams equal the
    reference's, keys included, with the late bids dropped the same way.
    Event time runs 64x faster than the generator's 10,000 events/s, so a
    tick spans 6.5 s of it as a 65,536-event tick does on the card, and 5% of
    the bids arrive 1-8 s late."""
    from pathway_tpu_torch.tools import nexmark

    ev = nexmark.generate(8192, seed=3, late_share=0.05, late_ms=(16, 125))
    ev["t"] = ev["t"] * 64
    streams = same_streams(lambda pw: nexmark.build(pw, query, ev, tick_rows=1024))
    for stream in streams.values():
        assert_consistent(stream)
    if query == "q7_cutoff":
        # the cutoff drops late bids: fewer counted than the plain query counts
        plain = same_streams(lambda pw: nexmark.build(pw, "q7", ev, tick_rows=1024))
        kept = sum(row[2] * m for row, m in rows(streams["q7_top"]).items())
        assert kept < sum(row[2] * m for row, m in rows(plain["q7_top"]).items())
