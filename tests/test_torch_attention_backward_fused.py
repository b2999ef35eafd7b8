"""The attention backward's fused route (``attention_bwd_fused`` in
``csrc/attention_short_bwd.cu``), which runs only on the card, emulated on
the CPU, and the wrapper's route choice.

The emulation repeats the kernel's arithmetic in plain torch: the forward's
tile-by-tile softmax fold for P (64-key tiles, fills 0 / −1e30 / −inf),
``D = rowsum(dO ∘ O)``, ``dP = dO·Vᵀ``, ``dS = P ∘ (dP − D)`` (0 at masked
keys), ``dQ = scale·dS·K``, ``dK = scale·dSᵀ·Q`` and ``dV = round(P)ᵀ·dO``,
summed in f32. bf16 rounds P for dV (as the plain version does) and dS for
dQ and dK (the one rounding the plain version lacks); f32 runs all five
products as split "3xTF32" products (``_einsum_3xtf32``, as the forward's
tests emulate its f32 route). It is held against
``attention_short_flat_backward_plain`` and against ``jax.vjp`` of the
reference's ``_sdpa`` (in f32 on the dtype-rounded inputs) at the chip
check's tolerances: each of dq, dk, dv within 1e-5 (|ref| + max|ref|) in
f32 and 2^-7 (|ref| + max|ref|) in bf16. Shapes: small versions of
``chip_smoke.py``'s ``BWD_SHAPES`` that take the fused route, row 0 fully
masked.
"""

from __future__ import annotations

import ctypes
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.ops import encoder as jenc
from pathway_tpu_torch.ops import _build
from pathway_tpu_torch.ops import attention_kernel as A
from test_torch_attention import _einsum_3xtf32  # the forward's split products, emulated

REL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}
TILE = 64  # keys per score tile, as the forward folds them

#: (label, (B, L, H, hd), dtypes): BWD_SHAPES cut to a few texts and heads;
#: f32 at hd 128 takes the two-pass route, so its case is bf16 only
FUSED_SHAPES = [
    ("train", (2, 128, 2, 64), (torch.float32, torch.bfloat16)),
    ("bert", (2, 128, 4, 32), (torch.float32, torch.bfloat16)),
    ("ragged", (3, 77, 2, 64), (torch.float32, torch.bfloat16)),
    ("one", (1, 16, 2, 64), (torch.float32, torch.bfloat16)),
    ("dryrun", (2, 16, 2, 32), (torch.float32, torch.bfloat16)),
    ("hd128", (2, 96, 1, 128), (torch.bfloat16,)),
]
CASES = [
    pytest.param(shape, dtype, id=f"{label}-{str(dtype).replace('torch.', '')}")
    for label, shape, dtypes in FUSED_SHAPES for dtype in dtypes
]


@pytest.fixture(scope="module", autouse=True)
def _one_cpu_thread():
    """Torch's CPU ops on one thread: results here are held to 1e-5 (see
    ``tests/test_torch_attention.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fused_emulation(q, k, v, mask, out, d_out, H, scale, round_ds=True):
    """The fused route's arithmetic in plain torch, head by head:
    ``(dq, dk, dv)`` in the input dtype; ``round_ds=False`` keeps bf16's dS
    in f32 (not what the kernel does)."""
    dtype = q.dtype
    prod = _einsum_3xtf32 if dtype == torch.float32 else torch.einsum
    B, L, D = q.shape
    hd = D // H
    nt = -(-L // TILE)
    LP = nt * TILE
    keep = torch.zeros(B, LP, dtype=torch.bool)
    keep[:, :L] = mask
    fill = torch.full((B, LP), float("-inf"))
    fill[:, :L] = torch.where(mask, 0.0, -1e30)
    grads = [torch.empty(B, L, D, dtype=dtype) for _ in range(3)]
    for h in range(H):
        sl = slice(h * hd, (h + 1) * hd)
        qh, gh, oh = (t[..., sl].float() for t in (q, d_out, out))
        kh, vh = (torch.zeros(B, LP, hd) for _ in range(2))
        kh[:, :L], vh[:, :L] = k[..., sl].float(), v[..., sl].float()
        # P: the forward's scores and fold, tile by tile in key order
        s = [prod("bqd,bkd->bqk", qh, kh[:, t * TILE:(t + 1) * TILE]) * scale
             + fill[:, None, t * TILE:(t + 1) * TILE] for t in range(nt)]
        m = torch.full((B, L, 1), float("-inf"))
        l = torch.zeros(B, L, 1)
        for st in s:
            n = torch.maximum(m, st.amax(dim=-1, keepdim=True))
            l = l * torch.exp(m - n) + torch.exp(st - n).sum(dim=-1, keepdim=True)
            m = n
        p = torch.cat([torch.exp(st - m) / l for st in s], dim=-1)
        dp = prod("bqd,bkd->bqk", gh, vh)
        row = (gh * oh).sum(dim=-1, keepdim=True)
        ds = torch.where(keep[:, None, :], p * (dp - row), 0.0)
        ds_op = ds.to(dtype).float() if round_ds else ds  # bf16: the A operand of dS·K and dSᵀ·Q
        p_op = p.to(dtype).float()
        grads[0][..., sl] = (prod("bqk,bkd->bqd", ds_op, kh) * scale).to(dtype)
        grads[1][..., sl] = (prod("bqk,bqd->bkd", ds_op, qh) * scale)[:, :L].to(dtype)
        grads[2][..., sl] = prod("bqk,bqd->bkd", p_op, gh)[:, :L].to(dtype)
    return tuple(grads)


def _inputs(B, L, H, hd, dtype, seed):
    """q, k, v, the key mask (row 0 fully masked, padded tails), the plain
    forward's output and d_out, from numpy; all rounded to ``dtype``."""
    rng = np.random.default_rng(seed)
    D = H * hd
    q, k, v, g = (torch.from_numpy(rng.standard_normal((B, L, D)).astype(np.float32)).to(dtype)
                  for _ in range(4))
    lens = rng.integers(1, L + 1, size=B)
    mask = torch.from_numpy(np.arange(L)[None, :] < lens[:, None])
    mask[0] = False
    out = A.attention_short_flat_plain(q, k, v, mask, H, hd ** -0.5)
    return q, k, v, mask, out, g


def _within(got, want, dtype, what):
    got, want = got.float(), want.float()
    err = (got - want).abs()
    bound = REL[dtype] * (want.abs() + want.abs().max())
    assert torch.isfinite(got).all(), what
    assert (err <= bound).all(), f"{what}: max |err| {float(err.max())}, worst ratio {float((err / bound).max())}"


@pytest.mark.parametrize("shape,dtype", CASES)
def test_fused_emulation_matches_plain_backward(shape, dtype):
    B, L, H, hd = shape
    assert A.backward_launch_geometry(B, L, H, hd, dtype).fused
    q, k, v, mask, out, g = _inputs(B, L, H, hd, dtype, seed=L + hd + B)
    got = _fused_emulation(q, k, v, mask, out, g, H, hd ** -0.5)
    want = A.attention_short_flat_backward_plain(q, k, v, mask, out, g, H, hd ** -0.5)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and a.shape == (B, L, H * hd)
        _within(a, b, dtype, name)
    # the fully masked row: uniform P and dS = 0, so no gradient to its q
    assert float(got[0][0].float().abs().max()) == 0.0


@pytest.mark.parametrize("shape,dtype", CASES)
def test_fused_emulation_matches_jax_vjp_of_the_reference_attention(shape, dtype):
    B, L, H, hd = shape
    D, scale = H * hd, hd ** -0.5
    q, k, v, mask, out, g = _inputs(B, L, H, hd, dtype, seed=1000 + L + hd + B)
    got = _fused_emulation(q, k, v, mask, out, g, H, scale)

    def f(qj, kj, vj):
        r = lambda t: t.reshape(B, L, H, hd)  # noqa: E731
        return jenc._sdpa(r(qj), r(kj), r(vj), jnp.asarray(mask.numpy()), scale).reshape(B, L, D)

    _, vjp = jax.vjp(f, *(t.float().numpy() for t in (q, k, v)))
    want = vjp(jnp.asarray(g.float().numpy()))
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        _within(a, torch.from_numpy(np.array(b)), dtype, name)


def test_rounding_ds_to_bf16_is_what_moves_dq_and_dk():
    """With dS left in f32, the bf16 emulation's dq and dk are closer to the
    plain version's than with dS rounded as the kernel rounds it: the tests
    above hold that rounding at the chip's tolerance, and this one shows
    that it is what moves them."""
    B, L, H, hd = 2, 128, 2, 64
    q, k, v, mask, out, g = _inputs(B, L, H, hd, torch.bfloat16, seed=5)
    want = A.attention_short_flat_backward_plain(q, k, v, mask, out, g, H, hd ** -0.5)
    got = _fused_emulation(q, k, v, mask, out, g, H, hd ** -0.5)
    unrounded = _fused_emulation(q, k, v, mask, out, g, H, hd ** -0.5, round_ds=False)
    assert torch.equal(got[2], unrounded[2])  # dV takes no dS
    for i in (0, 1):
        err_rounded = float((got[i].float() - want[i].float()).abs().max())
        err_unrounded = float((unrounded[i].float() - want[i].float()).abs().max())
        assert err_unrounded < err_rounded


# --- the wrapper's route choice ---------------------------------------------


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("hd", A.HEAD_DIMS)
def test_backward_launch_geometry_over_the_envelope(hd, dtype):
    """Every length of the envelope: the fused route exactly for L <= 128
    where its block fits at 128 rows (all but f32 at hd 128), one block per
    (text, head) of 16·ceil(L/16) rows; the two-pass route elsewhere; every
    block within the 227 KB a Hopper block may use."""
    H = 384 // hd
    elem = 2 if dtype == torch.bfloat16 else 4
    fused_name, two_pass_name = A.BACKWARD_ROUTES[dtype]
    for L in range(1, A.MAX_LEN + 1):
        geo = A.backward_launch_geometry(4, L, H, hd, dtype)
        assert geo.smem_bytes <= A._SMEM_LIMIT
        fused = L <= 128 and not (dtype == torch.float32 and hd == 128)
        assert geo.fused == fused and geo.route == (fused_name if fused else two_pass_name)
        if fused:
            rows = -(-L // 16) * 16
            assert (geo.rows, geo.warps, geo.blocks) == (rows, rows // 16, (4, H, 1))
            pad = 16 // elem
            assert geo.smem_bytes == (4 * rows * (hd + pad) + rows * (rows + pad)) * elem
        else:
            assert (geo.rows, geo.warps, geo.blocks) == (32, 8, (4, H, -(-L // 32)))


def test_fused_block_bytes_at_the_train_shape():
    """The shared bytes of the design: bf16 at hd 64 108,544 B (two blocks,
    plus 1 KB each reserved, share an SM's 228 KB), f32 at hd 64 206,848 B
    (one); f32 at hd 128 needs 270,336 B for its four tiles alone, above
    the limit (two-pass)."""
    bf = A.backward_launch_geometry(512, 128, 6, 64, torch.bfloat16)
    f32 = A.backward_launch_geometry(512, 128, 6, 64, torch.float32)
    assert (bf.route, bf.smem_bytes) == ("fused_tensor_core", 108544)
    assert 2 * (bf.smem_bytes + 1024) <= 228 * 1024
    assert (f32.route, f32.smem_bytes) == ("fused_tensor_core_3xtf32", 206848)
    assert 4 * 128 * (128 + 4) * 4 == 270336 > A._SMEM_LIMIT
    assert A._fused_smem_bytes(128, 128, 4) == 270336 + 128 * (128 + 4) * 4
    assert A.backward_launch_geometry(4, 128, 3, 128, torch.float32).route == "two_pass_simt_f32"
    assert A.backward_launch_geometry(4, 128, 3, 128, torch.bfloat16).smem_bytes == 174080
    assert set(A.BACKWARD_ROUTE_LAUNCHES) == {r for pair in A.BACKWARD_ROUTES.values() for r in pair}


# --- the source the card builds ------------------------------------------------


def _kernel_names(src: str) -> set[str]:
    """The names of the ``__global__`` functions of a CUDA source (a
    ``__launch_bounds__(...)`` between the return type and the name
    skipped, its parentheses balanced)."""
    names = set()
    for m in re.finditer(r"__global__\s+void\s+", src):
        i = m.end()
        if src.startswith("__launch_bounds__", i):
            depth, i = 0, src.index("(", i)
            while True:
                depth += {"(": 1, ")": -1}.get(src[i], 0)
                i += 1
                if depth == 0:
                    break
        names.add(re.match(r"\s*(\w+)", src[i:]).group(1))
    return names


def test_profiler_kernel_names_are_kernels_of_the_backward_source():
    """``chip_smoke.py``'s profiled step reads the backward's time under the
    names of ``BACKWARD_KERNELS``: each is a ``__global__`` function of the
    backward's source (else the step's backward time would read 0)."""
    names = _kernel_names((_build.CSRC / _build.SOURCES["attention_short_bwd"]).read_text())
    assert names == {n for group in A.BACKWARD_KERNELS.values() for n in group}
    assert "attention_tc_kernel" in _kernel_names((_build.CSRC / _build.SOURCES["attention_short"]).read_text())
    smoke = (_build.CSRC.parents[1] / "chip_smoke.py").read_text()
    assert "A.BACKWARD_KERNELS.values()" in smoke


def test_backward_entry_point_takes_the_arguments_the_wrapper_binds():
    """The C entry point's parameters, in order, against the ctypes
    argument types the wrapper sets (a wrong count would shift every
    argument after it). The route is told by ``stats`` alone (null: the
    fused route, whose rows the launcher works out from L)."""
    src = (_build.CSRC / _build.SOURCES["attention_short_bwd"]).read_text()
    sig = src[src.index('extern "C" int pw_attention_short_flat_backward('):]
    params = [p.strip() for p in sig[sig.index("(") + 1:sig.index(")")].split(",")]
    kinds = {"int": ctypes.c_int, "long long": ctypes.c_longlong, "float": ctypes.c_float}
    want = [ctypes.c_void_p if "*" in p else kinds[p.rsplit(" ", 1)[0]] for p in params]
    assert params[11:15] == ["void* stats", "long long B", "int L", "int H"]
    assert not any(p.endswith(" rows") for p in params)

    class _Lib:
        pw_attention_short_flat_backward = type("Fn", (), {})()

    saved = (_build.load, A._backward_fn)
    _build.load, A._backward_fn = (lambda name: _Lib), None
    try:
        fn = A._backward_kernel()
    finally:
        _build.load, A._backward_fn = saved
    assert list(fn.argtypes) == want
    assert fn.restype is ctypes.c_int


def test_build_digest_covers_the_shared_header(monkeypatch, tmp_path):
    """Both kernels include ``attention_tc.cuh``: an edited header names a
    new library, so a stale one is never loaded."""
    for f in _build.CSRC.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = {name: _build.library_path(name) for name in _build.SOURCES}
    with open(tmp_path / "attention_tc.cuh", "a") as fh:
        fh.write("\n// edited\n")
    after = {name: _build.library_path(name) for name in _build.SOURCES}
    assert all(before[n] != after[n] for n in _build.SOURCES)
    for name in _build.SOURCES:
        assert '#include "attention_tc.cuh"' in (tmp_path / _build.SOURCES[name]).read_text()
