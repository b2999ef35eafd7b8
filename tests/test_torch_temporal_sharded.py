"""The temporal plane sharded across workers in the port, against the
reference (``tests/test_temporal_sharded.py``): session windows, interval
and as-of-now joins by join key, buffer/forget/freeze by row key with one
shared watermark, sort by instance.

Each pipeline is written once as ``build(pw)`` on the same seeded timed
stream and captured by the port at 1 and 4 workers and by the reference at
1: the three keyed captures must be equal, keys and rows exactly.
"""

from __future__ import annotations

import numpy as np
import pytest

import pathway_tpu
import pathway_tpu_torch
from test_torch_multiworker import _three


@pytest.fixture(autouse=True)
def _fresh():
    for pw in (pathway_tpu, pathway_tpu_torch):
        pw.G.clear()
    yield
    for pw in (pathway_tpu, pathway_tpu_torch):
        pw.G.clear()


def _stream(pw, n=400, seed=3, n_keys=16, n_times=8):
    rng = np.random.default_rng(seed)
    rows = [
        (int(k), int(v), int(t), ti // (n // n_times), 1)
        for ti, (k, v, t) in enumerate(
            zip(rng.integers(0, n_keys, n), rng.integers(0, 1000, n), rng.integers(0, 200, n))
        )
    ]
    return pw.debug.table_from_rows(pw.schema_from_types(k=int, v=int, t=int), rows, is_stream=True)


def _check(build, min_rows):
    ref, p1, p4 = _three(build)
    assert p1 == p4 == ref
    assert len(p1) > min_rows


def test_session_window_sharded_identical():
    def build(pw):
        t = _stream(pw)
        return t.windowby(t.t, window=pw.temporal.session(max_gap=3), instance=t.k).reduce(
            inst=pw.this._pw_instance,
            start=pw.this._pw_window_start,
            end=pw.this._pw_window_end,
            s=pw.reducers.sum(pw.this.v),
            c=pw.reducers.count(),
        )

    _check(build, 10)


def test_interval_join_sharded_identical():
    def build(pw):
        left, right = _stream(pw, seed=5), _stream(pw, seed=6)
        return left.interval_join(
            right, left.t, right.t, pw.temporal.interval(-2, 2), left.k == right.k
        ).select(k=left.k, lv=left.v, rv=right.v)

    _check(build, 50)


def test_asof_now_join_sharded_identical():
    def build(pw):
        state, queries = _stream(pw, seed=7), _stream(pw, seed=8, n=100)
        return queries.asof_now_join(state, queries.k == state.k).select(q=queries.k, sv=state.v)

    _check(build, 10)


def test_buffered_window_behavior_sharded_identical():
    def build(pw):
        t = _stream(pw, seed=9)
        return t.windowby(
            t.t,
            window=pw.temporal.tumbling(duration=20),
            instance=t.k,
            behavior=pw.temporal.common_behavior(delay=5, cutoff=50),
        ).reduce(inst=pw.this._pw_instance, start=pw.this._pw_window_start, s=pw.reducers.sum(pw.this.v))

    _check(build, 10)


def test_temporal_work_lands_on_multiple_workers():
    """A session window and an interval join under 4 port workers: the
    temporal nodes processed rows on more than one worker."""
    from pathway_tpu_torch.engine import operators as ops
    from pathway_tpu_torch.internals import errors as _errors
    from pathway_tpu_torch.internals.logical import LogicalNode
    from pathway_tpu_torch.internals.run import make_runtime

    pw = pathway_tpu_torch
    t = _stream(pw)
    win = t.windowby(t.t, window=pw.temporal.session(max_gap=3), instance=t.k).reduce(
        inst=pw.this._pw_instance, s=pw.reducers.sum(pw.this.v)
    )
    left, right = _stream(pw, seed=5), _stream(pw, seed=6)
    ij = left.interval_join(
        right, left.t, right.t, pw.temporal.interval(-2, 2), left.k == right.k
    ).select(k=left.k, lv=left.v, rv=right.v)
    captured = [
        LogicalNode(lambda cols=table.column_names(): ops.CaptureNode(cols), [table._node], name="capture")
        for table in (win, ij)
    ]
    runtime = make_runtime(n_workers=4, autocommit_duration_ms=5)
    prev = _errors.get_error_policy()
    try:
        runtime.run(captured)
    finally:
        _errors.set_error_policy(prev)
    for node_name in ("session_window", "temporal_join"):
        workers_with_rows = [
            w.index for w in runtime.workers
            if any(n.name == node_name and n.stats_rows_in > 0 for n in w.graph.nodes)
        ]
        assert len(workers_with_rows) > 1, (node_name, workers_with_rows)


def test_watermark_is_global_across_shards():
    def build(pw):
        rows = [(0, 10, 0, 0, 1)] + [(1, i, t, t // 3, 1) for t, i in enumerate(range(1, 13))]
        t = pw.debug.table_from_rows(pw.schema_from_types(k=int, v=int, t=int), rows, is_stream=True)
        buffered = t._buffer(t.t + 4, t.t)
        return buffered.groupby(buffered.k).reduce(buffered.k, s=pw.reducers.sum(buffered.v))

    ref, p1, p4 = _three(build)
    assert p1 == p4 == ref
    assert len(p1) == 2


def test_sort_sharded_by_instance_identical():
    def build(pw):
        t = _stream(pw, seed=11, n=300, n_keys=6)
        s = t.sort(key=t.t, instance=t.k)
        return t.select(k=t.k, t=t.t, prev=s.prev, next=s.next)

    _check(build, 100)


def test_blocked_sorted_list_contract():
    """The sort index's blocked list in the port gives the reference's
    neighbours through 4,000 random inserts and removes."""
    import bisect
    import random

    from pathway_tpu.internals.sorting import _BlockedSortedList as Ref
    from pathway_tpu_torch.internals.sorting import _BlockedSortedList as Port

    class SmallRef(Ref):
        LOAD = 8

    class SmallPort(Port):
        LOAD = 8

    rnd = random.Random(0)
    want: list = []
    ref, port = SmallRef(), SmallPort()
    for step in range(4000):
        if want and rnd.random() < 0.4:
            item = rnd.choice(want)
            want.remove(item)
            assert port.remove(item) and ref.remove(item)
        else:
            item = (rnd.randrange(1000), step)
            bisect.insort(want, item)
            port.insert(item)
            ref.insert(item)
        if want and step % 97 == 0:
            probe = rnd.choice(want)
            i = want.index(probe)
            expect = (want[i - 1] if i > 0 else None, want[i + 1] if i + 1 < len(want) else None)
            assert port.neighbors(probe) == ref.neighbors(probe) == expect
    assert len(port) == len(ref) == len(want)
