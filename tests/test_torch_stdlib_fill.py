"""The port's stateful and utility stdlib against the JAX package's, on the
same inputs.

Mirrors ``tests/test_stdlib_fill.py`` but its two ``knn_lsh`` tests (the rest
of ``stdlib/ml`` is a later slice): ``deduplicate`` with an acceptor,
``pw.stateful``, ``interpolate``, ``unpack_col``, ``multiapply_all_rows``,
``groupby_reduce_majority``, ``AsyncTransformer`` (success, failure routing,
the error log) and ``_gradual_broadcast``.

Deterministic pipelines compare their update streams ``(time, key, diff,
values)`` exactly, keys included. ``interpolate`` produces floats, and they
are compared exactly too (tolerance 0): both packages run the same Python
``lerp`` over the same Python floats, so the bits cannot differ.

``AsyncTransformer`` results re-enter the dataflow when their coroutine
finishes, so the tick a result lands in depends on wall-clock timing; its
tests compare the final rows by key (keys, values, status) and not the
ticks. Each runs ``pw.run`` in a thread that must end within its own time
limit, so a hang fails that test instead of stalling the whole run.
"""

from __future__ import annotations

import asyncio
import collections
import threading
from typing import Optional

import numpy as np
import pytest

import pathway_tpu
import pathway_tpu_torch
from test_torch_temporal import rows, same_stream, same_streams

RUN_LIMIT_S = 60.0


# ---------------------------------------------------------------- deduplicate


def test_deduplicate_acceptor_per_instance():
    def build(pw):
        stream = [
            (1, "a", 0, 1), (2, "a", 2, 1), (5, "a", 4, 1),
            (6, "a", 6, 1), (9, "a", 8, 1), (3, "b", 8, 1),
        ]
        t = pw.debug.table_from_rows(pw.schema_from_types(val=int, g=str), stream, is_stream=True)
        return t.deduplicate(value=t.val, instance=t.g, acceptor=lambda new, old: new >= old + 2)

    s = same_stream(build)
    assert sorted(rows(s).elements()) == [(3, "b"), (9, "a")]
    assert any(d < 0 for _t, _k, d, _r in s)  # accepted rows replace their predecessor


def test_stateful_deduplicate_module():
    def build(pw):
        t = pw.debug.table_from_rows(pw.schema_from_types(val=int), [(1,), (3,), (2,)])
        return pw.stdlib.stateful.deduplicate(t, col=t.val, acceptor=lambda new, old: new > old)

    assert sorted(rows(same_stream(build)).elements()) == [(3,)]


def test_deduplicate_rejects_retractions():
    for pw in (pathway_tpu, pathway_tpu_torch):
        pw.G.clear()
        t = pw.debug.table_from_rows(
            pw.schema_from_types(val=int), [(1, 0, 1), (1, 2, -1)], is_stream=True
        )
        d = t.deduplicate(value=t.val, acceptor=lambda new, old: True)
        with pytest.raises(RuntimeError, match="append-only"):
            pw.debug.table_to_dicts(d)
        pw.G.clear()


# ---------------------------------------------------------------- interpolate


def test_interpolate_linear_reference_example():
    def build(pw):
        rows_ = [
            (1, 1, 10), (2, None, None), (3, 3, None),
            (4, None, None), (5, None, None), (6, 6, 60),
        ]
        t = pw.debug.table_from_rows(
            pw.schema_from_types(timestamp=int, values_a=Optional[int], values_b=Optional[int]),
            rows_,
        )
        return t.interpolate(pw.this.timestamp, pw.this.values_a, pw.this.values_b)

    assert sorted(rows(same_stream(build)).elements()) == [
        (1, 1.0, 10.0), (2, 2.0, 20.0), (3, 3.0, 30.0),
        (4, 4.0, 40.0), (5, 5.0, 50.0), (6, 6.0, 60.0),
    ]


def test_interpolate_boundary_gaps_take_neighbor():
    def build(pw):
        t = pw.debug.table_from_rows(
            pw.schema_from_types(ts=int, v=Optional[int]), [(1, None), (2, 4), (3, None)]
        )
        return t.interpolate(pw.this.ts, pw.this.v)

    assert sorted(rows(same_stream(build)).elements()) == [(1, 4.0), (2, 4.0), (3, 4.0)]


def test_interpolate_float_column_nan_as_missing():
    def build(pw):
        t = pw.debug.table_from_rows(
            pw.schema_from_types(ts=int, v=Optional[float]),
            [(1, 2.0), (2, None), (3, None), (4, 8.0)],
        )
        return t.interpolate(pw.this.ts, pw.this.v)

    assert sorted(rows(same_stream(build)).elements()) == [(1, 2.0), (2, 4.0), (3, 6.0), (4, 8.0)]


def test_interpolate_streaming_fills_and_refills():
    """A streamed series whose later rows fill earlier gaps: the filled values
    are retracted and re-emitted as the nearest known neighbours change."""

    def build(pw):
        rng = np.random.default_rng(5)
        stream = []
        for i in range(24):
            v = None if rng.random() < 0.4 else float(rng.integers(-50, 50)) / 4
            stream.append((int(rng.integers(0, 1000)) * 3 + i % 3, v, 2 * (1 + i // 6), 1))
        t = pw.debug.table_from_rows(
            pw.schema_from_types(ts=int, v=Optional[float]), stream, is_stream=True
        )
        return t.interpolate(pw.this.ts, pw.this.v)

    s = same_stream(build)
    assert len({t for t, *_ in s}) == 4
    assert any(d < 0 for _t, _k, d, _r in s)


# ---------------------------------------------------------------- utils


def test_unpack_col():
    def build(pw):
        t = pw.debug.table_from_rows(pw.schema_from_types(p=tuple), [((1, "x"),), ((2, "y"),)])
        return pw.utils.unpack_col(t.p, "num", "name")

    assert sorted(rows(same_stream(build)).elements()) == [(1, "x"), (2, "y")]


def test_multiapply_all_rows_reference_example():
    def build(pw):
        t = pw.debug.table_from_rows(
            pw.schema_from_types(colA=int, colB=int), [(1, 10), (2, 20), (3, 30)]
        )

        def add_total_sum(col1, col2):
            s = sum(col1) + sum(col2)
            return [x + s for x in col1], [x + s for x in col2]

        return pw.utils.multiapply_all_rows(
            t.colA, t.colB, fun=add_total_sum, result_col_names=["res1", "res2"]
        )

    assert sorted(rows(same_stream(build)).elements()) == [(67, 76), (68, 86), (69, 96)]


def test_groupby_reduce_majority():
    def build(pw):
        t = pw.debug.table_from_rows(
            pw.schema_from_types(g=str, v=str),
            [("x", "a"), ("x", "a"), ("x", "b"), ("y", "c")],
        )
        return pw.utils.groupby_reduce_majority(t.g, t.v)

    assert sorted(rows(same_stream(build)).elements()) == [("x", "a"), ("y", "c")]


def test_argmax_argmin_rows_and_apply_all_rows():
    def build(pw):
        t = pw.debug.table_from_rows(
            pw.schema_from_types(g=str, v=int),
            [("x", 3), ("x", 9), ("y", 4), ("y", -2), ("x", 1)],
        )
        return {
            "max": pw.utils.argmax_rows(t, t.g, what=t.v),
            "min": pw.utils.argmin_rows(t, t.g, what=t.v),
            "all": pw.utils.apply_all_rows(
                t.v, fun=lambda vs: [v - min(vs) for v in vs], result_col_name="shifted"
            ),
        }

    s = same_streams(build)
    assert sorted(rows(s["max"]).elements()) == [("x", 9), ("y", 4)]
    assert sorted(rows(s["min"]).elements()) == [("x", 1), ("y", -2)]
    assert sorted(rows(s["all"]).elements()) == [(0,), (3,), (5,), (6,), (11,)]


def test_bucketing_truncates_like_the_reference():
    import datetime

    from pathway_tpu.stdlib.utils import bucketing as ref
    from pathway_tpu_torch.stdlib.utils import bucketing as port

    t = datetime.datetime(2024, 5, 17, 13, 42, 19, 123456)
    for name in ("truncate_to_minutes", "truncate_to_hours", "truncate_to_days"):
        assert getattr(port, name)(t) == getattr(ref, name)(t)


# ---------------------------------------------------------------- async


def _final_rows(pw, build) -> dict:
    """Final keyed rows of the tables ``build(pw)`` subscribes to, after a
    ``pw.run`` that must end within ``RUN_LIMIT_S``; under ``"error_log"``,
    the messages the run logged."""
    pw.G.clear()
    got: dict[str, dict] = {}
    for name, table in build(pw).items():
        state = got.setdefault(name, {})

        def on_change(key, row, time, is_addition, state=state):
            if is_addition:
                state[int(key)] = dict(row)
            else:
                state.pop(int(key), None)

        pw.io.subscribe(table, on_change=on_change)
    errors: list[BaseException] = []

    def run():
        try:
            pw.run(monitoring_level="none")
        except BaseException as e:  # noqa: BLE001 - re-raised in the test
            errors.append(e)

    th = threading.Thread(target=run, daemon=True)
    th.start()
    th.join(RUN_LIMIT_S)
    alive = th.is_alive()
    if alive:
        pw.internals.run.current_runtime().request_stop()
        th.join(10)
    got["error_log"] = [m for (_o, m, _t) in pw.internals.error_log._entries]
    pw.G.clear()
    assert not alive, f"pw.run did not end within {RUN_LIMIT_S} s"
    if errors:
        raise errors[0]
    return got


def _inc_class(pw):
    class _Out(pw.Schema):
        ret: int

    class _Inc(pw.AsyncTransformer, output_schema=_Out):
        async def invoke(self, value):
            await asyncio.sleep(0.01)
            if value < 0:
                raise ValueError("negative")
            return {"ret": value + 1}

    return _Inc


def _same_final_rows(build) -> dict:
    ref = _final_rows(pathway_tpu, build)
    port = _final_rows(pathway_tpu_torch, build)
    assert port == ref
    return port


def test_async_transformer_successful():
    def build(pw):
        inp = pw.debug.table_from_rows(pw.schema_from_types(value=int), [(42,), (44,)])
        tr = _inc_class(pw)(input_table=inp)
        return {"ok": tr.successful, "finished": tr.finished}

    got = _same_final_rows(build)
    assert sorted(r["ret"] for r in got["ok"].values()) == [43, 45]
    assert {r["_async_status"] for r in got["finished"].values()} == {"-SUCCESS-"}


def test_async_transformer_failure_routing():
    def build(pw):
        inp = pw.debug.table_from_rows(pw.schema_from_types(value=int), [(7,), (-1,)])
        tr = _inc_class(pw)(input_table=inp)
        return {"ok": tr.successful, "bad": tr.failed}

    got = _same_final_rows(build)
    assert [r["ret"] for r in got["ok"].values()] == [8]
    assert [r["ret"] for r in got["bad"].values()] == [None]


def test_async_transformer_failure_reaches_error_log():
    def build(pw):
        inp = pw.debug.table_from_rows(pw.schema_from_types(value=int), [(-5,)])
        return {"bad": _inc_class(pw)(input_table=inp).failed}

    got = _same_final_rows(build)
    assert [r["ret"] for r in got["bad"].values()] == [None]
    assert any("AsyncTransformer.invoke failed" in m for m in got["error_log"])


# ---------------------------------------------------------------- broadcast


def test_gradual_broadcast_fraction_and_rollup():
    def build(pw):
        t = pw.debug.table_from_rows(pw.schema_from_types(v=int), [(i,) for i in range(100)])
        thr = pw.debug.table_from_rows(
            pw.schema_from_types(lower=float, value=float, upper=float), [(0.0, 5.0, 10.0)]
        )
        stream = [(0.0, 0.0, 10.0, 0, 1), (0.0, 10.0, 10.0, 2, 1)]
        thr2 = pw.debug.table_from_rows(
            pw.schema_from_types(lower=float, value=float, upper=float), stream, is_stream=True
        )
        return {
            "half": t._gradual_broadcast(thr, thr.lower, thr.value, thr.upper),
            "rollup": t._gradual_broadcast(thr2, thr2.lower, thr2.value, thr2.upper),
        }

    s = same_streams(build)
    counts = collections.Counter(r[1] for r in rows(s["half"]).elements())
    assert sum(counts.values()) == 100
    assert 20 <= counts[10.0] <= 80 and counts[0.0] + counts[10.0] == 100
    assert collections.Counter(r[1] for r in rows(s["rollup"]).elements()) == {10.0: 100}


def test_gradual_broadcast_rows_before_first_triplet():
    def build(pw):
        t = pw.debug.table_from_rows(pw.schema_from_types(v=int), [(i,) for i in range(50)])
        thr = pw.debug.table_from_rows(
            pw.schema_from_types(lower=float, value=float, upper=float),
            [(0.0, 10.0, 10.0, 4, 1)],
            is_stream=True,
        )
        return t._gradual_broadcast(thr, thr.lower, thr.value, thr.upper)

    counts = collections.Counter(r[1] for r in rows(same_stream(build)).elements())
    assert counts == {10.0: 50}, counts


def test_pandas_transformer_over_one_table():
    pytest.importorskip("pandas")

    def build(pw):
        class Out(pw.Schema):
            total: int

        @pw.pandas_transformer(output_schema=Out)
        def totals(df):
            return df.assign(total=df["a"] + df["b"])[["total"]]

        t = pw.debug.table_from_rows(pw.schema_from_types(a=int, b=int), [(1, 2), (3, 4), (5, 6)])
        return totals(t)

    assert sorted(rows(same_stream(build)).elements()) == [(3,), (7,), (11,)]
