"""The port's temporal edge cases against the JAX package's, on the same inputs.

Mirrors the thread-runtime cases of ``tests/test_temporal_sweep.py``: a late
row at exactly the window cutoff, a same-tick watermark tie, a buffer
threshold tie at frontier close, session merge/split and the gap-boundary
tie, and prev/next relinking. Each pipeline runs through both packages and
the update streams ``(time, key, diff, values)`` must be identical, keys
included; the reference test's own assertions are then checked on the
port's stream.

Left out, and why:
- ``test_temporal_sweep_cluster_matches_thread`` and
  ``test_session_merge_and_prev_next_cluster_matches_thread`` run two
  processes; the port's multi-process runtime is ROADMAP Queue 1 item 6.
- The reference runs the sweep under its audit plane (``PATHWAY_AUDIT=full``),
  which the port does not carry (Queue 1 item 4). Here the reference still
  runs with ``full`` and its monitors must report no violation, and the port
  is held to the reference's output; ``test_reference_rows_do_not_depend_on_audit``
  shows that the reference's rows are the same with the plane on and off.
"""

from __future__ import annotations

import pytest

import pathway_tpu
from pathway_tpu.observability import audit as audit_mod
from pathway_tpu_torch.engine.graph import END_OF_STREAM
from test_torch_engine_parity import update_stream
from test_torch_temporal import assert_consistent, rows, same_stream, same_streams

DURATION = 10
CUTOFF = 5
# window A = [0, 10): freeze threshold = 10 + 5 = 15


@pytest.fixture(autouse=True)
def _full_audit(monkeypatch):
    monkeypatch.setenv("PATHWAY_AUDIT", "full")
    yield
    plane = audit_mod.current()
    assert plane is not None and plane.violation_counts == {}


def _window_counts(late_tick_time: int, wm_t: int, late_t: int = 9):
    """Tumbling windows over an on-time A row, a watermark-advancing B row,
    and a late A row arriving at ``late_tick_time``."""

    def build(pw):
        t = pw.debug.table_from_markdown(
            f'''
                | t        | __time__
            1   | 2        | 2
            2   | {wm_t}   | 2
            3   | {late_t} | {late_tick_time}
            '''
        )
        return t.windowby(
            t.t, window=pw.temporal.tumbling(duration=DURATION),
            behavior=pw.temporal.common_behavior(cutoff=CUTOFF),
        ).reduce(pw.this._pw_window_start, cnt=pw.reducers.count())

    return build


@pytest.mark.parametrize("offset,late_counted", [(-1, True), (0, False), (1, False)])
def test_late_row_exactly_at_window_cutoff_thread(offset, late_counted):
    out = rows(same_stream(_window_counts(late_tick_time=4, wm_t=15 + offset)))
    expect_a = 2 if late_counted else 1
    assert out.get((0, expect_a)) == 1, out
    assert (0, 2 if not late_counted else 1) not in out


@pytest.mark.parametrize("offset", [-1, 0, 1])
def test_same_tick_watermark_tie_is_kept_thread(offset):
    out = rows(same_stream(_window_counts(late_tick_time=2, wm_t=15 + offset)))
    assert out.get((0, 2)) == 1, out


@pytest.mark.parametrize("offset,released_late", [(-1, True), (0, False), (1, False)])
def test_buffer_threshold_tie_at_frontier_close(offset, released_late):
    def build(pw):
        t = pw.debug.table_from_markdown(
            f'''
                | t            | __time__
            1   | 5            | 2
            2   | {10 + offset} | 4
            '''
        )
        return t._buffer(pw.this.t + 5, pw.this.t)

    released = {row[0]: t for t, _k, d, row in same_stream(build) if d > 0}
    assert set(released) == {5, 10 + offset}
    if released_late:
        assert released[5] == END_OF_STREAM, released
    else:
        assert released[5] != END_OF_STREAM, released


def _session(md: str):
    def build(pw):
        t = pw.debug.table_from_markdown(md)
        return t.windowby(t.t, window=pw.temporal.session(max_gap=6)).reduce(
            start=pw.this._pw_window_start,
            end=pw.this._pw_window_end,
            cnt=pw.reducers.count(),
        )

    return build


def test_session_merge_retracts_both_emitted_sessions():
    deltas = same_stream(_session(
        '''
            | t  | __time__
        1   | 0  | 2
        2   | 10 | 2
        3   | 5  | 4
        '''
    ))
    assert rows(deltas) == {(0, 10, 3): 1}
    emitted_t2 = {d[3] for d in deltas if d[0] == 2 and d[2] > 0}
    assert (0, 0, 1) in emitted_t2 and (10, 10, 1) in emitted_t2, deltas
    retracted_t4 = {d[3] for d in deltas if d[0] == 4 and d[2] < 0}
    assert (0, 0, 1) in retracted_t4 and (10, 10, 1) in retracted_t4, deltas


def test_session_split_on_bridge_deletion():
    deltas = same_stream(_session(
        '''
            | t  | __time__ | __diff__
        1   | 0  | 2        | 1
        2   | 10 | 2        | 1
        3   | 5  | 2        | 1
        3   | 5  | 4        | -1
        '''
    ))
    assert rows(deltas) == {(0, 0, 1): 1, (10, 10, 1): 1}
    assert any(d[0] == 2 and d[2] > 0 and d[3] == (0, 10, 3) for d in deltas)
    assert any(d[0] == 4 and d[2] < 0 and d[3] == (0, 10, 3) for d in deltas)


@pytest.mark.parametrize("gap_offset,merged", [(-1, False), (0, False), (1, True)])
def test_session_gap_boundary_tie(gap_offset, merged):
    second = 6 - gap_offset
    out = rows(same_stream(_session(
        f'''
            | t         | __time__
        1   | 0         | 2
        2   | {second}  | 2
        '''
    )))
    if merged:
        assert out == {(0, second, 2): 1}, out
    else:
        assert out == {(0, 0, 1): 1, (second, second, 1): 1}, out


def _sorted_chain(md: str):
    def build(pw):
        t = pw.debug.table_from_markdown(md)
        s = t.sort(t.t)
        joined = t.with_columns(prev=s.prev, next=s.next)
        prv = t.ix(joined.prev, optional=True)
        nxt = t.ix(joined.next, optional=True)
        return t.select(pw.this.t, pt=prv.t, nt=nxt.t)

    return build


def test_prev_next_insert_between_retracts_emitted_pointers():
    deltas = same_stream(_sorted_chain(
        '''
            | t  | __time__
        1   | 10 | 2
        2   | 30 | 2
        3   | 20 | 4
        '''
    ))
    assert rows(deltas) == {(10, None, 20): 1, (20, 10, 30): 1, (30, 20, None): 1}
    emitted_t2 = {d[3] for d in deltas if d[0] == 2 and d[2] > 0}
    assert (10, None, 30) in emitted_t2 and (30, 10, None) in emitted_t2
    retracted_t4 = {d[3] for d in deltas if d[0] == 4 and d[2] < 0}
    assert (10, None, 30) in retracted_t4 and (30, 10, None) in retracted_t4


def test_prev_next_delete_middle_relinks():
    deltas = same_stream(_sorted_chain(
        '''
            | t  | __time__ | __diff__
        1   | 10 | 2        | 1
        2   | 20 | 2        | 1
        3   | 30 | 2        | 1
        2   | 20 | 4        | -1
        '''
    ))
    assert rows(deltas) == {(10, None, 30): 1, (30, 10, None): 1}
    assert any(d[0] == 4 and d[2] < 0 and d[3] == (20, 10, 30) for d in deltas)


# The two cluster pipelines of the reference's sweep, on one process: the
# cutoff-tie pipeline and the session/prev-next churn pipeline.


def _sweep_pipeline(pw):
    t = pw.debug.table_from_markdown(
        '''
            | t  | __time__
        1   | 2  | 2
        2   | 15 | 2
        3   | 9  | 4
        4   | 14 | 6
        5   | 3  | 6
        '''
    )
    w = t.windowby(
        t.t, window=pw.temporal.tumbling(duration=10),
        behavior=pw.temporal.common_behavior(cutoff=5),
    ).reduce(
        start=pw.this._pw_window_start,
        cnt=pw.reducers.count(),
        mx=pw.reducers.max(pw.this.t),
    )
    return {"window": w, "buffer": t._buffer(pw.this.t + 5, pw.this.t)}


def _session_sort_pipeline(pw):
    t = pw.debug.table_from_markdown(
        '''
            | t  | __time__ | __diff__
        1   | 0  | 2        | 1
        2   | 10 | 2        | 1
        3   | 5  | 4        | 1
        4   | 20 | 4        | 1
        3   | 5  | 6        | -1
        5   | 12 | 6        | 1
        '''
    )
    sess = t.windowby(t.t, window=pw.temporal.session(max_gap=6)).reduce(
        start=pw.this._pw_window_start,
        end=pw.this._pw_window_end,
        cnt=pw.reducers.count(),
    )
    s = t.sort(t.t)
    joined = t.with_columns(prev=s.prev, next=s.next)
    prv = t.ix(joined.prev, optional=True)
    nxt = t.ix(joined.next, optional=True)
    return {"session": sess, "chain": t.select(pw.this.t, pt=prv.t, nt=nxt.t)}


def test_cutoff_tie_pipeline_on_one_process():
    s = same_streams(_sweep_pipeline)
    for stream in s.values():
        assert_consistent(stream)
    # t=9 and t=3 arrive after the watermark reached 15 = [0, 10)'s end + 5
    assert rows(s["window"]) == {(0, 1, 2): 1, (10, 2, 15): 1}
    assert {row[0] for row in rows(s["buffer"])} == {2, 15, 9, 14, 3}


def test_session_merge_and_prev_next_pipeline_on_one_process():
    s = same_streams(_session_sort_pipeline)
    assert rows(s["session"]) == {(0, 0, 1): 1, (10, 12, 2): 1, (20, 20, 1): 1}
    assert rows(s["chain"]) == {
        (0, None, 10): 1, (10, 0, 12): 1, (12, 10, 20): 1, (20, 12, None): 1,
    }


@pytest.mark.parametrize("pipeline", ["sweep", "session_sort"])
def test_reference_rows_do_not_depend_on_audit(monkeypatch, pipeline):
    """The port carries no audit plane: the reference's rows are the same
    with its plane off as with ``full``, so holding the port to the
    reference's output under ``full`` holds it to the plane-off output too."""
    build = {"sweep": _sweep_pipeline, "session_sort": _session_sort_pipeline}[pipeline]
    full = update_stream(pathway_tpu, build)
    monkeypatch.setenv("PATHWAY_AUDIT", "off")
    off = update_stream(pathway_tpu, build)
    assert audit_mod.current() is None
    assert off == full
    monkeypatch.setenv("PATHWAY_AUDIT", "full")
    update_stream(pathway_tpu, build)  # reinstall the plane the fixture checks
