"""The fused device tier of chain fusion (``pathway_tpu_torch/engine/fusion.py``
with ``expression_vm.trace_fused``) on CPU tensors (``PATHWAY_ENGINE_JAX=cpu``),
held against the port's register program and against the reference's JAX tier
(``PATHWAY_FUSE_JAX=on``, JAX on the CPU), bit for bit: keys, diffs, column
dtypes and column bytes.

The reference's JAX tier computes ``int32 + float32`` and ``int64 + float32``
in float32 where its own register program (numpy) gives float64; the port's
device tier keeps numpy's promotion. Those cases are held against the
reference's register program, and the reference's deviation is asserted so
that the record stays true.
"""

from __future__ import annotations

import numpy as np
import pytest

import pathway_tpu
import pathway_tpu_torch
from pathway_tpu.debug import _capture as capture_ref
from pathway_tpu.engine import blocks as JB
from pathway_tpu.engine import fusion as JF
from pathway_tpu.engine import operators as JO
from pathway_tpu.internals import expression as JE
from pathway_tpu_torch.debug import _capture as capture_port
from pathway_tpu_torch.engine import blocks as TB
from pathway_tpu_torch.engine import expression_vm as TVM
from pathway_tpu_torch.engine import fusion as TF
from pathway_tpu_torch.engine import operators as TO
from pathway_tpu_torch.engine import torch_kernels as K
from pathway_tpu_torch.internals import expression as TE


@pytest.fixture(autouse=True)
def _cpu_tier(monkeypatch):
    monkeypatch.setenv("PATHWAY_ENGINE_JAX", "cpu")
    K.ROUTES.clear()
    pathway_tpu.G.clear()
    pathway_tpu_torch.G.clear()
    yield
    pathway_tpu.G.clear()
    pathway_tpu_torch.G.clear()


# ----------------------------------------------------------------- segments
#
# Expressions are written once as trees and built in either package:
# ("col", name) | ("const", v) | ("bin", op, l, r) | ("un", op, x) |
# ("isnone", x) | ("notnone", x) | ("ifelse", c, t, e)


def _expr(E, tree):
    kind = tree[0]
    if kind == "col":
        return E.ColumnReference(None, tree[1])
    if kind == "const":
        return E.ConstExpression(tree[1])
    if kind == "bin":
        return E.BinOpExpression(tree[1], _expr(E, tree[2]), _expr(E, tree[3]))
    if kind == "un":
        return E.UnOpExpression(tree[1], _expr(E, tree[2]))
    if kind == "isnone":
        return E.IsNoneExpression(_expr(E, tree[1]))
    if kind == "notnone":
        return E.IsNotNoneExpression(_expr(E, tree[1]))
    return E.IfElseExpression(_expr(E, tree[1]), _expr(E, tree[2]), _expr(E, tree[3]))


def _segment(F, O, E, flt, outs):
    nodes = []
    if flt is not None:
        nodes.append(O.FilterNode(None, expr=_expr(E, flt)))
    nodes.append(O.RowwiseNode(None, exprs={k: _expr(E, v) for k, v in outs.items()}))
    nodes.append(O.SelectColumnsNode(list(outs)))
    return F.ComposedSegment(nodes)


def _col(name):
    return ("col", name)


def _bin(op, a, b):
    return ("bin", op, a, b)


N_ROWS = 3000


def _block(seed: int = 0):
    """Columns of every whitelisted kind, with the values that trip promotion
    and wrapping: int extremes, NaN, signed zeros, keys above 2^63."""
    rng = np.random.default_rng(seed)
    n = N_ROWS
    i64 = rng.integers(-(2**62), 2**62, n).astype(np.int64)
    i64[:4] = [np.iinfo(np.int64).min, np.iinfo(np.int64).max, -1, 0]
    i32 = rng.integers(-(2**31), 2**31, n).astype(np.int32)
    i32[:2] = [np.iinfo(np.int32).min, np.iinfo(np.int32).max]
    f32 = (rng.normal(size=n) * 1e3).astype(np.float32)
    f64 = rng.normal(size=n) * 1e6
    f32[5:9] = [np.nan, -0.0, np.inf, -np.inf]
    f64[5:9] = [np.nan, 0.0, -0.0, np.nan]
    keys = rng.integers(0, 2**64 - 1, n, dtype=np.uint64)
    keys[::3] |= np.uint64(1 << 63)
    u64 = rng.integers(0, 2**64 - 1, n, dtype=np.uint64)
    u64[::2] = keys[::2]
    data = {
        "a": i32, "b": i64, "x": f32, "y": f64, "u": u64,
        "p": rng.random(n) < 0.5, "q": rng.random(n) < 0.3,
        "h": (rng.normal(size=n) * 100).astype(np.float16),
    }
    diffs = np.where(rng.random(n) < 0.8, 1, -1).astype(np.int64)
    return keys, diffs, data


#: name -> (filter tree or None, {output: tree}); each reaches a different
#: corner of the whitelist
CASES = {
    "int_float_promotion": (None, {
        "a_plus_x": _bin("+", _col("a"), _col("x")),  # int32 + float32 -> float64
        "b_plus_x": _bin("+", _col("b"), _col("x")),  # int64 + float32 -> float64
        "b_minus_y": _bin("-", _col("b"), _col("y")),
        "x_times_x": _bin("*", _col("x"), _col("x")),
        "a_cmp_x": _bin("<", _col("a"), _col("x")),  # compared in float64
        "b_eq_y": _bin("==", _col("b"), _col("y")),
    }),
    "int_wrap": (_bin(">", _col("x"), ("const", -1e9)), {
        "bb": _bin("*", _col("b"), _col("b")),
        "b_plus": _bin("+", _col("b"), _col("b")),
        "neg_b": ("un", "-", _col("b")),
        "aa": _bin("*", _col("a"), _col("a")),  # int32 stays int32
        "a_plus_b": _bin("+", _col("a"), _col("b")),
        "a_const": _bin("-", _col("a"), ("const", 7)),  # int32 - int64 const
        "not_b": ("un", "~", _col("b")),
    }),
    "floats": (_bin("!=", _col("y"), ("const", 0.0)), {
        "xy": _bin("*", _col("x"), _col("y")),
        "neg_x": ("un", "-", _col("x")),
        "y_ge": _bin(">=", _col("y"), _col("x")),
        "h_plus_h": _bin("+", _col("h"), _col("h")),  # float16, rounded once
        "h_times_x": _bin("*", _col("h"), _col("x")),
        "x_half": _bin("*", _col("x"), ("const", 0.5)),
    }),
    "bools": (_bin("|", _col("p"), _col("q")), {
        "and": _bin("&", _col("p"), _col("q")),
        "xor": _bin("^", _col("p"), _col("q")),
        "not_p": ("un", "~", _col("p")),
        "p_eq_q": _bin("==", _col("p"), _col("q")),
        "p_and_b": _bin("&", _col("p"), _col("b")),  # bool & int64 -> int64
        "b_or_p": _bin("|", _col("b"), _col("p")),
        "a_xor_b": _bin("^", _col("a"), _col("b")),
    }),
    "uint64_id": (_bin("<", _col("id"), _col("u")), {
        "id_lt_u": _bin("<", _col("id"), _col("u")),
        "id_ge_u": _bin(">=", _col("id"), _col("u")),
        "id_eq_u": _bin("==", _col("id"), _col("u")),
        "id_and_u": _bin("&", _col("id"), _col("u")),
        "id_xor_u": _bin("^", _col("id"), _col("u")),
        "u_or_id": _bin("|", _col("u"), _col("id")),
        "id_lt_y": _bin("<", _col("id"), _col("y")),  # uint64 vs float64
        "id_pass": _col("id"),
    }),
    "if_else_is_none": (("notnone", _col("y")), {
        "pick": ("ifelse", _bin(">", _col("x"), ("const", 0.0)), _col("b"), ("un", "-", _col("b"))),
        "pick_u": ("ifelse", _col("p"), _col("u"), _col("id")),
        "x_nan": ("isnone", _col("x")),
        "b_none": ("isnone", _col("b")),
        "y_some": ("notnone", _col("y")),
        "const_only": ("const", 3),
    }),
}

#: outputs where the reference's JAX tier promotes int + float32 to float32
#: and so disagrees with its own register program (numpy: float64)
REFERENCE_JAX_PROMOTES_TO_FLOAT32 = {"a_plus_x", "b_plus_x"}


def _bits(batch) -> tuple:
    """Everything a downstream operator can see, as bytes."""
    return (
        batch.keys.tobytes(), batch.diffs.tobytes(),
        {c: (a.dtype.str, a.tobytes()) for c, a in batch.data.items()},
    )


def _run_port(flt, outs, mode: str):
    seg = _segment(TF, TO, TE, flt, outs)
    seg._device_cfg = (mode, 0)
    keys, diffs, data = _block()
    return seg.run(TB.DeltaBatch(keys, diffs, data, 0), 0)


def _run_reference(flt, outs, jax_tier: bool):
    seg = _segment(JF, JO, JE, flt, outs)
    seg._jax_cfg = ("on", 0, True) if jax_tier else ("off", 0, False)
    keys, diffs, data = _block()
    out = seg.run(JB.DeltaBatch(keys, diffs, data, 0), 0)
    assert not seg._jax_dead, "the reference's JAX tier fell back to numpy"
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_device_tier_equals_register_program(case):
    flt, outs = CASES[case]
    fast = _run_port(flt, outs, "off")
    assert K.ROUTES == {}
    dev = _run_port(flt, outs, "on")
    assert K.ROUTES == {"fused/cpu": 1}
    assert _bits(dev) == _bits(fast)
    assert 0 < len(dev) <= N_ROWS


@pytest.mark.parametrize("case", sorted(CASES))
def test_device_tier_equals_reference(case):
    flt, outs = CASES[case]
    dev = _run_port(flt, outs, "on")
    ref_np = _run_reference(flt, outs, jax_tier=False)
    ref_jax = _run_reference(flt, outs, jax_tier=True)
    assert _bits(dev) == _bits(ref_np)
    k_dev, d_dev, c_dev = _bits(dev)
    k_jax, d_jax, c_jax = _bits(ref_jax)
    assert (k_dev, d_dev) == (k_jax, d_jax)
    for name, col in c_dev.items():
        if name in REFERENCE_JAX_PROMOTES_TO_FLOAT32:
            assert col[0] == "<f8" and c_jax[name][0] == "<f4"
        else:
            assert col == c_jax[name], name


def test_trace_fused_values_ride_as_numpy_dtypes():
    """Unsigned columns ride as the int64 view of their bits and come back as
    themselves; the torch dtype of every other kind is its own width."""
    import torch

    u = np.array([0, 1, 2**63, 2**64 - 1], dtype=np.uint64)
    t = TVM.to_torch_lanes(u, "cpu")
    assert t.dtype == torch.int64
    np.testing.assert_array_equal(TVM.from_torch_lanes(t, u.dtype), u)
    u32 = np.array([0, 2**32 - 1], dtype=np.uint32)
    back = TVM.from_torch_lanes(TVM.to_torch_lanes(u32, "cpu"), u32.dtype)
    assert back.dtype == np.uint32 and back.tolist() == u32.tolist()
    for d, want in ((np.float16, torch.float16), (np.int32, torch.int32), (np.bool_, torch.bool)):
        assert TVM.torch_dtype(np.dtype(d)) == want
    # uint64 -> float64 rounds as numpy does, at the 2^53 boundaries too
    big = np.array([2**53 + 1, 2**64 - 1, 2**63 + 2**11, 2**63 + 2**10 + 1, 12345], dtype=np.uint64)
    got = TVM._cast_lanes(TVM.to_torch_lanes(big, "cpu"), big.dtype, np.dtype(np.float64))
    np.testing.assert_array_equal(got.numpy(), big.astype(np.float64))


def test_device_tier_failure_raises(monkeypatch):
    """A failing device-tier kernel raises; it never falls back to the
    register program (the reference logs and falls back for good)."""

    def boom(*_a, **_k):
        raise RuntimeError("kernel failed")

    monkeypatch.setattr(TVM, "trace_fused", boom)
    flt, outs = CASES["floats"]
    with pytest.raises(RuntimeError, match="kernel failed"):
        _run_port(flt, outs, "on")
    assert K.ROUTES == {}


@pytest.mark.parametrize("kind", ["object", "str", "datetime"])
def test_columns_torch_cannot_hold_keep_the_register_program(kind):
    """A block carrying a column torch has no dtype for (a vector of
    objects, strings, datetimes), which the chain's stages drop, runs the
    register program: the reference's JAX tier fails on it and falls back
    to numpy, to the same values."""
    keys, diffs, data = _block()
    data["o"] = {
        "object": np.array([np.arange(i % 3) for i in range(N_ROWS)] + [None], dtype=object)[:-1],
        "str": np.array([f"s{i}" for i in range(N_ROWS)]),
        "datetime": np.arange(N_ROWS).astype("datetime64[s]"),
    }[kind]
    flt, outs = _bin(">", _col("x"), ("const", 0.0)), {"b": _col("b"), "xy": _bin("*", _col("x"), _col("y"))}
    got = {}
    for mode in ("on", "off"):
        seg = _segment(TF, TO, TE, flt, outs)
        seg._device_cfg = (mode, 0)
        got[mode] = seg.run(TB.DeltaBatch(keys, diffs, dict(data), 0), 0)
    assert K.ROUTES == {}
    ref = _segment(JF, JO, JE, flt, outs)
    ref._jax_cfg = ("off", 0, False)
    want = ref.run(JB.DeltaBatch(keys, diffs, dict(data), 0), 0)
    for out in got.values():
        assert out.keys.tobytes() == want.keys.tobytes() and out.diffs.tobytes() == want.diffs.tobytes()
        assert _bits(out) == _bits(want)


def test_device_tier_without_cuda_raises(monkeypatch):
    """Unpinned, the device tier is the card: without CUDA it raises rather
    than running on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the device tier runs there")
    monkeypatch.setenv("PATHWAY_ENGINE_JAX", "auto")
    flt, outs = CASES["floats"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _run_port(flt, outs, "on")


# ----------------------------------------------------------------- pipelines


def _churn_pipeline(pw, sizes):
    """The chain of ``tests/test_incremental_hot_path.py`` (filter → select →
    select) over ticks of the given row counts."""
    rng = np.random.default_rng(23)
    rows = []
    for tick, sz in enumerate(sizes):
        for _ in range(sz):
            rows.append((int(rng.integers(0, 50)), int(rng.integers(0, 100)), tick, 1))
    t = pw.debug.table_from_rows(pw.schema_from_types(k=int, v=int), rows, is_stream=True)
    f = t.filter(t.v > 10)
    s = f.select(k=f.k, d=f.v * 3)
    return s.select(k=s.k, e=s.d + s.k)


def _stream_bits(deltas) -> list:
    return [repr(d) for d in deltas]


def test_churning_ticks_match_and_stay_within_buckets(monkeypatch):
    """50 ticks of churning row counts: the device tier's update stream equals
    the register program's and the reference JAX tier's (keys included), and
    every padded block shape is one of the pow-2 buckets of the tick sizes."""
    rng = np.random.default_rng(23)
    sizes = [int(rng.integers(1, 900)) for _ in range(50)]
    monkeypatch.setenv("PATHWAY_FUSE", "on")

    padded: set[int] = set()
    orig = TVM.to_torch_lanes

    def spy(a, device):
        padded.add(len(a))
        return orig(a, device)

    monkeypatch.setattr(TVM, "to_torch_lanes", spy)
    streams = {}
    for mode in ("off", "on"):
        monkeypatch.setenv("PATHWAY_FUSE_JAX", mode)
        K.ROUTES.clear()
        pathway_tpu_torch.G.clear()
        streams[mode] = capture_port(_churn_pipeline(pathway_tpu_torch, sizes)).deltas
        routes = dict(K.ROUTES)
        assert (routes.get("fused/cpu", 0) > 0) == (mode == "on"), routes
    assert streams["on"] == streams["off"] and streams["on"]
    assert _stream_bits(streams["on"]) == _stream_bits(streams["off"])
    assert padded and padded <= {K._bucket(sz) for sz in sizes}

    monkeypatch.setenv("PATHWAY_FUSE_JAX", "on")
    ref = capture_ref(_churn_pipeline(pathway_tpu, sizes)).deltas
    assert _stream_bits(ref) == _stream_bits(streams["on"])


def test_auto_routes_only_blocks_at_the_threshold(monkeypatch):
    """``auto`` sends a block to the device tier from
    ``PATHWAY_FUSE_JAX_MIN_ROWS`` rows on; ``transient`` plans pin it off."""
    from pathway_tpu_torch.engine.fusion import build_plan

    monkeypatch.setenv("PATHWAY_FUSE", "on")
    monkeypatch.setenv("PATHWAY_FUSE_JAX", "auto")
    monkeypatch.setenv("PATHWAY_FUSE_JAX_MIN_ROWS", "500")
    small = capture_port(_churn_pipeline(pathway_tpu_torch, [100, 200])).deltas
    assert K.ROUTES == {}
    pathway_tpu_torch.G.clear()
    big = capture_port(_churn_pipeline(pathway_tpu_torch, [100, 800])).deltas
    assert K.ROUTES == {"fused/cpu": 1}
    assert small and big

    built = []
    orig = build_plan

    def spy(graph, exchange_aware, transient=False):
        plan = orig(graph, exchange_aware, transient=True)
        built.append(plan)
        return plan

    monkeypatch.setattr(TF, "build_plan", spy)
    K.ROUTES.clear()
    pathway_tpu_torch.G.clear()
    pinned = capture_port(_churn_pipeline(pathway_tpu_torch, [100, 800])).deltas
    assert K.ROUTES == {}
    assert _stream_bits(pinned) == _stream_bits(big)
    segs = [u[1] for p in built if p for c in p.chains for u in c.units if u[0] == "seg"]
    assert segs and all(s._device_cfg == ("off", 0) for s in segs)
