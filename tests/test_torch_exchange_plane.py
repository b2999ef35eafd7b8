"""The port's on-device exchange plane (``parallel/device_plane.py``) as the
sharded runtime's exchange, against the reference (``tests/test_device_plane.py``).

Each pipeline is written once as ``build(pw)``. With
``PATHWAY_DEVICE_EXCHANGE=on`` the port's 4-worker run (4 logical shards on
``cpu``) must equal its 1-worker run and the reference's 4-worker run (8
virtual devices) in keys and rows, exactly, float bits and datetimes
included, and the port's plane must have moved rows. The fused mode
(``PATHWAY_DEVICE_EXCHANGE_FUSED=on``) gives the same rows. Auto mode keeps
the host plane without a card per worker; a failed exchange under ``on``
raises instead of falling back to the host plane.
"""

from __future__ import annotations

import numpy as np
import pytest

import pathway_tpu
import pathway_tpu_torch
import test_torch_multiworker as _tm
from pathway_tpu.engine import operators as ref_ops
from pathway_tpu.internals.logical import LogicalNode as RefLogicalNode
from pathway_tpu.parallel.sharded import ShardedRuntime as RefShardedRuntime
from pathway_tpu_torch.engine import operators as port_ops
from pathway_tpu_torch.internals.logical import LogicalNode as PortLogicalNode
from pathway_tpu_torch.parallel.sharded import ShardedRuntime as PortShardedRuntime

_PARTS = {
    pathway_tpu: (ref_ops, RefLogicalNode, RefShardedRuntime),
    pathway_tpu_torch: (port_ops, PortLogicalNode, PortShardedRuntime),
}


@pytest.fixture(autouse=True)
def _fresh():
    for pw in _PARTS:
        pw.G.clear()
    yield
    for pw in _PARTS:
        pw.G.clear()


def _run_sharded(pw, build, n_workers=4):
    """Capture ``build(pw)`` under the package's ShardedRuntime: (keyed rows,
    runtime)."""
    pw.G.clear()
    ops, LogicalNode, ShardedRuntime = _PARTS[pw]
    table = build(pw)
    cols = table.column_names()
    holder = {}

    def factory():
        node = ops.CaptureNode(cols)
        holder["n"] = node
        return node

    lnode = LogicalNode(factory, [table._node], name="capture")
    rt = ShardedRuntime(n_workers=n_workers, autocommit_duration_ms=5)
    rt.run([lnode])
    return dict(holder["n"].current), rt


def _three(build):
    """(port at 1 worker, port at 4 with its runtime, reference at 4)."""
    truth, _ = _run_sharded(pathway_tpu_torch, build, n_workers=1)
    got, rt4 = _run_sharded(pathway_tpu_torch, build, n_workers=4)
    ref, _ = _run_sharded(pathway_tpu, build, n_workers=4)
    return truth, got, rt4, ref


def _mk_numeric(pw, n=3000, seed=3):
    rng = np.random.default_rng(seed)
    return pw.debug.table_from_rows(
        pw.schema_from_types(k=int, v=int, t=int),
        list(
            zip(
                rng.integers(0, 40, n).tolist(),
                rng.integers(0, 1000, n).tolist(),
                rng.integers(0, 100, n).tolist(),
            )
        ),
    )


@pytest.fixture(params=["off", "on"], ids=["plain", "fused"])
def plane_on(request, monkeypatch):
    monkeypatch.setenv("PATHWAY_DEVICE_EXCHANGE", "on")
    monkeypatch.setenv("PATHWAY_DEVICE_EXCHANGE_FUSED", request.param)
    return request.param


def test_groupby_rides_device_plane(plane_on):
    def build(pw):
        t = _mk_numeric(pw)
        return t.groupby(t.k).reduce(
            t.k, s=pw.reducers.sum(t.v), c=pw.reducers.count(), mx=pw.reducers.max(t.v)
        )

    truth, got, rt4, ref = _three(build)
    assert got == truth == ref
    assert rt4.device_plane is not None
    assert rt4.device_plane.rows_exchanged > 0, "exchange never used the shard grid"
    assert rt4.device_plane.collectives > 0
    assert rt4.device_plane._fused_active() == (plane_on == "on")


def test_join_rides_device_plane(plane_on):
    def build(pw):
        t = _mk_numeric(pw)
        d = pw.debug.table_from_rows(pw.schema_from_types(k=int, w=int), [(i, i * 3) for i in range(40)])
        j = t.join(d, t.k == d.k).select(k=t.k, v=t.v + d.w)
        return j.groupby(j.k).reduce(j.k, s=pw.reducers.sum(j.v))

    truth, got, rt4, ref = _three(build)
    assert got == truth == ref
    assert rt4.device_plane.rows_exchanged > 0


def test_windowby_rides_device_plane(plane_on):
    def build(pw):
        t = _mk_numeric(pw)
        return t.windowby(t.t, window=pw.temporal.tumbling(duration=10), instance=t.k).reduce(
            k=pw.this._pw_instance,
            start=pw.this._pw_window_start,
            s=pw.reducers.sum(pw.this.v),
        )

    truth, got, rt4, ref = _three(build)
    assert got == truth == ref
    assert rt4.device_plane.rows_exchanged > 0


def test_object_columns_fall_back_to_host(plane_on):
    def build(pw):
        rng = np.random.default_rng(7)
        t = pw.debug.table_from_rows(
            pw.schema_from_types(k=int, name=str, v=int),
            [
                (int(k), f"n{k % 5}", int(v))
                for k, v in zip(rng.integers(0, 30, 1500), rng.integers(0, 100, 1500))
            ],
        )
        return t.groupby(t.name).reduce(t.name, s=pw.reducers.sum(t.v), c=pw.reducers.count())

    truth, got, _rt4, ref = _three(build)
    assert got == truth == ref


def test_auto_mode_skips_without_a_card_per_worker(monkeypatch):
    """Auto engages only with a card for every worker (and, on one, at least
    ``min_rows``): here (no card) the host plane carries every row."""
    monkeypatch.setenv("PATHWAY_DEVICE_EXCHANGE", "auto")
    monkeypatch.setenv("PATHWAY_DEVICE_EXCHANGE_MIN_ROWS", "1")

    def build(pw):
        t = _mk_numeric(pw, n=500)
        return t.groupby(t.k).reduce(t.k, s=pw.reducers.sum(t.v))

    got, rt4 = _run_sharded(pathway_tpu_torch, build, n_workers=4)
    truth, _ = _run_sharded(pathway_tpu_torch, build, n_workers=1)
    assert got == truth
    assert rt4.device_plane is not None
    assert rt4.device_plane.rows_exchanged == 0
    assert rt4.device_plane.mesh is None


def test_off_mode_disables_plane(monkeypatch):
    monkeypatch.setenv("PATHWAY_DEVICE_EXCHANGE", "off")

    def build(pw):
        t = _mk_numeric(pw, n=500)
        return t.groupby(t.k).reduce(t.k, s=pw.reducers.sum(t.v))

    got, rt4 = _run_sharded(pathway_tpu_torch, build, n_workers=4)
    assert rt4.device_plane is None
    truth, _ = _run_sharded(pathway_tpu_torch, build, n_workers=1)
    assert got == truth


def test_float_and_datetime_columns_bit_exact(plane_on):
    rng = np.random.default_rng(11)
    n = 2000
    base = np.datetime64("2024-01-01T00:00:00", "ns")
    rows = [
        (int(k), float(f), base + np.timedelta64(int(s), "s"))
        for k, f, s in zip(rng.integers(0, 25, n), rng.standard_normal(n) * 1e10, rng.integers(0, 10**6, n))
    ]

    def build(pw):
        t = pw.debug.table_from_rows(pw.schema_from_types(k=int, f=float, ts=pw.DateTimeNaive), rows)
        return t.groupby(t.k).reduce(
            t.k, s=pw.reducers.sum(t.f), mn=pw.reducers.min(t.f), tmax=pw.reducers.max(t.ts)
        )

    truth, got, rt4, ref = _three(build)
    assert got == truth == ref
    assert rt4.device_plane.rows_exchanged > 0


def test_forced_plane_failure_raises(monkeypatch):
    """Under ``on`` a failed exchange is the run's error: nothing falls back
    to the host plane."""
    monkeypatch.setenv("PATHWAY_DEVICE_EXCHANGE", "on")
    from pathway_tpu_torch.parallel import device_exchange

    def broken(*args, **kwargs):
        raise RuntimeError("exchange launch failed")

    monkeypatch.setattr(device_exchange, "exchange_by_key_shards", broken)

    def build(pw):
        t = _mk_numeric(pw, n=500)
        return t.groupby(t.k).reduce(t.k, s=pw.reducers.sum(t.v))

    with pytest.raises(RuntimeError, match="exchange launch failed"):
        _run_sharded(pathway_tpu_torch, build, n_workers=4)


_SUITE = [n for n in dir(_tm) if n.startswith("test_")]


@pytest.mark.parametrize("case", _SUITE)
def test_multiworker_suite_with_plane(case, monkeypatch):
    """The port's multiworker parity suite re-run with the plane forced on:
    the device exchange is a drop-in for the host plane."""
    monkeypatch.setenv("PATHWAY_DEVICE_EXCHANGE", "on")
    getattr(_tm, case)()
