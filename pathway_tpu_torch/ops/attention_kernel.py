"""Short-sequence masked multi-head attention in the flat [B, L, D] layout.

Port of ``pathway_tpu/ops/attention_kernel.py``. Heads are ``hd = D / H``
column slices of q/k/v (no [B, H, L, hd] transpose). Per head: scores
``q·kᵀ·scale`` accumulated in f32; masked keys set to −1e30, which is finite,
so a fully masked row gives the mean of v; softmax in f32; probs normalised,
then cast to the input dtype; ``probs·v`` accumulated in f32 and stored to the
head's output columns.

Its gradient (:class:`AttentionShortFlat`, taken when q, k or v requires
grad) recomputes the forward's softmax and runs ``csrc/attention_short_bwd.cu``
on the card, :func:`attention_short_flat_backward_plain` on the CPU:
:func:`backward_launch_geometry` says which of its routes a call takes (up
to 128 keys, one fused pass per (text, head) on the tensor cores; above, or
f32 at head width 128, the two-pass kernels on the FP32 pipes).

On a CUDA tensor :func:`attention_short_flat` launches the hand-written Hopper
kernel ``csrc/attention_short.cu`` (design and bound in its header note) or
raises. Both routes run one kernel on the tensor cores (``mma.sync`` with
async copies): bf16 as bf16 products, f32 as split "3xTF32" products (each
operand split into two TF32 parts, three products per product, near f32
accuracy); :func:`launch_geometry` says how either is launched. On a CPU
tensor it runs :func:`attention_short_flat_plain`, the same arithmetic in
plain PyTorch. Both devices accept the same envelope: bf16 or f32, ``hd`` in
:data:`HEAD_DIMS`, ``1 <= L <= MAX_LEN``.
"""

from __future__ import annotations

import ctypes
import contextlib
import functools
from typing import NamedTuple

import torch

#: kernel launches since the count was last reset (the kernel's own wrapper
#: adds one per launch; nothing else touches it), in all and per route
LAUNCHES = 0
ROUTE_LAUNCHES = {"tensor_core": 0, "tensor_core_3xtf32": 0}
#: backward launches (one per gradient: the fused kernel, or the two kernels
#: of the two-pass route), in all and per backward route
BACKWARD_LAUNCHES = 0
BACKWARD_ROUTE_LAUNCHES = {
    "fused_tensor_core": 0, "fused_tensor_core_3xtf32": 0,
    "two_pass_simt_bf16": 0, "two_pass_simt_f32": 0,
}
#: the backward's route names per input dtype: (fused, two-pass)
BACKWARD_ROUTES = {
    torch.bfloat16: ("fused_tensor_core", "two_pass_simt_bf16"),
    torch.float32: ("fused_tensor_core_3xtf32", "two_pass_simt_f32"),
}
#: the ``__global__`` kernels of ``attention_short_bwd.cu`` per route kind
#: (a profiler's kernel names contain them)
BACKWARD_KERNELS = {"fused": ("attention_bwd_fused",), "two_pass": ("bwd_dq", "bwd_dkv")}
#: route name per input dtype
ROUTES = {torch.bfloat16: "tensor_core", torch.float32: "tensor_core_3xtf32"}

#: head widths the kernel is instantiated for (template parameter HD)
HEAD_DIMS = (32, 64, 128)
MAX_LEN = 512
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: an H100 block may use 227 KB of dynamic shared memory
_SMEM_LIMIT = 232448

# 16 query rows per warp, up to _TC_MAX_ROWS per block, keys in tiles of
# _TC_KEY_TILE; K and V stay resident in shared memory up to
# _TC_RESIDENT_LEN, above it they stream through a 2-tile ring
_TC_MAX_ROWS = 128
_TC_KEY_TILE = 64
_TC_RESIDENT_LEN = 2 * _TC_KEY_TILE
_TC_ROW_PAD_BYTES = 16  # padding per shared row


#: the fused backward: keys (and query rows) per block up to this
_BWD_FUSED_MAX_LEN = 128
#: the two-pass backward: 32-row tiles, 256 threads
_BWD_TILE = 32


class LaunchGeometry(NamedTuple):
    route: str  #: "tensor_core" (bf16) or "tensor_core_3xtf32" (f32)
    rows: int  #: query rows per block
    warps: int  #: warps per block
    key_tile: int  #: keys per shared-memory tile
    resident: bool  #: K and V of a (batch row, head) held in shared memory at once
    smem_bytes: int  #: dynamic shared memory per block
    blocks: tuple[int, int, int]  #: grid (batch rows, heads, query-row tiles)


def _tc_smem_bytes(L: int, hd: int, rows: int, elem: int) -> int:
    """Dynamic shared memory of one block with ``elem``-byte elements;
    mirrors ``tc_smem_bytes`` in the .cu file: the Q tile, K and V
    (resident, or a 2-tile ring each) in rows padded by 16 bytes, and one
    f32 fill per key."""
    kv_rows = _TC_KEY_TILE if L <= _TC_KEY_TILE else 2 * _TC_KEY_TILE
    nt = -(-L // _TC_KEY_TILE)
    return (rows + 2 * kv_rows) * (hd * elem + _TC_ROW_PAD_BYTES) + nt * _TC_KEY_TILE * 4


@functools.lru_cache(maxsize=256)
def launch_geometry(B: int, L: int, n_heads: int, hd: int, dtype: torch.dtype) -> LaunchGeometry:
    """How the kernel is launched for one call; both routes share the
    geometry, f32 with twice the shared memory. Raises when a block would
    not fit the 227 KB of shared memory a Hopper block may use. Cached: the
    main path repeats a handful of shapes, and the wrapper's host time is
    most of a small call's time."""
    rows = min(_TC_MAX_ROWS, (L + 15) // 16 * 16)
    elem = 2 if dtype == torch.bfloat16 else 4
    geo = LaunchGeometry(
        ROUTES[dtype], rows, rows // 16, _TC_KEY_TILE,
        L <= _TC_RESIDENT_LEN, _tc_smem_bytes(L, hd, rows, elem), (B, n_heads, -(-L // rows)),
    )
    if geo.smem_bytes > _SMEM_LIMIT:
        raise ValueError(
            f"attention_short_flat: L={L}, hd={hd} in {dtype} needs {geo.smem_bytes} B "
            f"of shared memory per block, above the {_SMEM_LIMIT} B a Hopper block may use"
        )
    return geo


class BackwardGeometry(NamedTuple):
    route: str  #: a key of BACKWARD_ROUTE_LAUNCHES
    fused: bool  #: one fused kernel (else bwd_dq, then bwd_dkv)
    rows: int  #: query rows (fused: and keys) per block
    warps: int  #: warps per block
    smem_bytes: int  #: dynamic shared memory per block (two-pass: the larger kernel's)
    blocks: tuple[int, int, int]  #: grid (batch rows, heads, row tiles)


def _fused_smem_bytes(rows: int, hd: int, elem: int) -> int:
    """Shared bytes of one fused backward block; mirrors ``fused_smem_bytes``
    in ``attention_short_bwd.cu``: the Q, K, V and dO tiles and the rows x
    rows staging buffer, in ``elem``-byte elements, rows padded by 16 bytes."""
    pad = _TC_ROW_PAD_BYTES // elem
    return (4 * rows * (hd + pad) + rows * (rows + pad)) * elem


def _two_pass_geometry(B: int, L: int, n_heads: int, hd: int, dtype: torch.dtype) -> BackwardGeometry:
    """The two-pass route: 32-row tiles of f32 in rows padded by one word
    (``dkv_smem_bytes``, the larger of its two kernels')."""
    smem = (4 * _BWD_TILE * (hd + 1) + 2 * _BWD_TILE * (_BWD_TILE + 1) + 4 * _BWD_TILE) * 4
    return BackwardGeometry(
        BACKWARD_ROUTES[dtype][1], False, _BWD_TILE, 8, smem, (B, n_heads, -(-L // _BWD_TILE))
    )


@functools.lru_cache(maxsize=256)
def backward_launch_geometry(B: int, L: int, n_heads: int, hd: int, dtype: torch.dtype) -> BackwardGeometry:
    """How the backward is launched for one call: the fused route for
    ``L <= 128`` where its block fits at 128 rows (every dtype and head
    width but f32 at 128), one block per (batch row, head) of ``16 *
    ceil(L / 16)`` rows; else the two-pass route."""
    elem = 2 if dtype == torch.bfloat16 else 4
    if L <= _BWD_FUSED_MAX_LEN and _fused_smem_bytes(_BWD_FUSED_MAX_LEN, hd, elem) <= _SMEM_LIMIT:
        rows = (L + 15) // 16 * 16
        return BackwardGeometry(
            BACKWARD_ROUTES[dtype][0], True, rows, rows // 16,
            _fused_smem_bytes(rows, hd, elem), (B, n_heads, 1),
        )
    return _two_pass_geometry(B, L, n_heads, hd, dtype)


def _check(q, k, v, mask, n_heads: int) -> tuple[int, LaunchGeometry]:
    """Validate the call; returns the head width and the launch geometry."""
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"attention_short_flat: q/k/v must share one [B, L, D] shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    B, L, D = q.shape
    if mask.shape != (B, L) or mask.dtype != torch.bool:
        raise ValueError(
            f"attention_short_flat: mask must be bool [{B}, {L}], got "
            f"{mask.dtype} {tuple(mask.shape)}"
        )
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"attention_short_flat: q/k/v must all be float32 or bfloat16, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    if D % n_heads:
        raise ValueError(f"attention_short_flat: D={D} not divisible by n_heads={n_heads}")
    hd = D // n_heads
    if hd not in HEAD_DIMS:
        raise ValueError(
            f"attention_short_flat: head width {hd} not in the supported set {HEAD_DIMS}"
        )
    if not 1 <= L <= MAX_LEN:
        raise ValueError(f"attention_short_flat: L={L} outside 1..{MAX_LEN}")
    if len({t.device for t in (q, k, v, mask)}) != 1:
        raise ValueError("attention_short_flat: q, k, v and mask must share one device")
    return hd, launch_geometry(B, L, n_heads, hd, q.dtype)


def attention_short_flat_plain(q, k, v, mask, n_heads: int, scale: float):
    """The kernel's arithmetic in plain PyTorch: a per-head einsum on the flat
    layout (f32 products and sums), the −1e30 key fill, an f32 softmax
    normalised before the cast to the input dtype, and ``probs·v`` summed in
    f32."""
    B, L, D = q.shape
    hd = D // n_heads
    out = torch.empty((B, L, D), dtype=q.dtype, device=q.device)
    keep = mask[:, None, :]
    for h in range(n_heads):
        sl = slice(h * hd, (h + 1) * hd)
        scores = torch.einsum("bqd,bkd->bqk", q[..., sl].float(), k[..., sl].float()) * scale
        scores = scores.masked_fill(~keep, -1e30)
        e = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
        probs = (e / e.sum(dim=-1, keepdim=True)).to(q.dtype)
        out[..., sl] = torch.einsum("bqk,bkd->bqd", probs.float(), v[..., sl].float()).to(q.dtype)
    return out


def attention_short_flat_backward_plain(q, k, v, mask, out, d_out, n_heads: int, scale: float):
    """The gradient of :func:`attention_short_flat_plain` in plain PyTorch:
    ``(dq, dk, dv)`` in the input dtype. Per head it recomputes the forward's
    f32 scores (−1e30 at masked keys) and f32 softmax ``P``, then
    ``dP = dO·Vᵀ``, ``D = rowsum(dO ∘ O)``, ``dS = P ∘ (dP − D)`` (0 at masked
    keys: the fill blocks the gradient), ``dQ = scale·dS·K``,
    ``dK = scale·dSᵀ·Q`` and ``dV = round(P)ᵀ·dO`` with ``P`` rounded to the
    input dtype as the forward multiplies it, all summed in f32. A fully
    masked row has uniform ``P``: its dQ is 0 and it adds ``1/L`` to dV."""
    B, L, D = q.shape
    hd = D // n_heads
    grads = [torch.empty((B, L, D), dtype=q.dtype, device=q.device) for _ in range(3)]
    keep = mask[:, None, :]
    for h in range(n_heads):
        sl = slice(h * hd, (h + 1) * hd)
        qf, kf, vf = (t[..., sl].float() for t in (q, k, v))
        g = d_out[..., sl].float()
        scores = torch.einsum("bqd,bkd->bqk", qf, kf) * scale
        scores = scores.masked_fill(~keep, -1e30)
        e = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
        p = e / e.sum(dim=-1, keepdim=True)
        dp = torch.einsum("bqd,bkd->bqk", g, vf)
        row = (g * out[..., sl].float()).sum(dim=-1, keepdim=True)
        ds = (p * (dp - row)).masked_fill(~keep, 0.0)
        grads[0][..., sl] = (torch.einsum("bqk,bkd->bqd", ds, kf) * scale).to(q.dtype)
        grads[1][..., sl] = (torch.einsum("bqk,bqd->bkd", ds, qf) * scale).to(q.dtype)
        grads[2][..., sl] = torch.einsum("bqk,bqd->bkd", p.to(q.dtype).float(), g).to(q.dtype)
    return tuple(grads)


def _aligned(t: torch.Tensor) -> bool:
    es = t.element_size()
    return (
        t.stride(-1) == 1
        and t.data_ptr() % 16 == 0
        and (t.stride(0) * es) % 16 == 0
        and (t.stride(1) * es) % 16 == 0
    )


_kernel_fn = None


def _kernel():
    """The C entry point, built and bound at first use."""
    global _kernel_fn
    if _kernel_fn is None:
        from pathway_tpu_torch.ops import _build

        fn = _build.load("attention_short").pw_attention_short_flat
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 5
            + [ctypes.c_longlong] + [ctypes.c_int] * 3
            + [ctypes.c_longlong] * 7 + [ctypes.c_float, ctypes.c_void_p]
        )
        _kernel_fn = fn
    return _kernel_fn


def _launch(q, k, v, mask, n_heads: int, scale: float, hd: int, geo: LaunchGeometry):
    global LAUNCHES
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not _aligned(t):
            raise ValueError(
                f"attention_short_flat: {name} must have a contiguous last dimension "
                f"and 16-byte aligned rows (strides {t.stride()}, "
                f"{t.element_size()}-byte elements)"
            )
    B, L, D = q.shape
    if mask.stride(-1) != 1:
        mask = mask.contiguous()
    fn = _kernel()
    out = torch.empty((B, L, D), dtype=q.dtype, device=q.device)
    if B == 0:
        return out
    # switching the current device costs more host time than a small launch
    # takes on the card, so only do it when q lives on another card
    on_current = q.device.index == torch.cuda.current_device()
    with contextlib.nullcontext() if on_current else torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            _DTYPES[q.dtype], hd, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            mask.data_ptr(), out.data_ptr(), B, L, n_heads, geo.rows,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
            mask.stride(0), float(scale), stream,
        )
    if err != 0:
        raise RuntimeError(f"attention_short_flat: kernel launch failed (cudaError {err})")
    LAUNCHES += 1
    ROUTE_LAUNCHES[geo.route] += 1
    return out


_backward_fn = None


def _backward_kernel():
    """The backward's C entry point, built and bound at first use."""
    global _backward_fn
    if _backward_fn is None:
        from pathway_tpu_torch.ops import _build

        fn = _build.load("attention_short_bwd").pw_attention_short_flat_backward
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 10
            + [ctypes.c_longlong] + [ctypes.c_int] * 2
            + [ctypes.c_longlong] * 11 + [ctypes.c_float, ctypes.c_void_p]
        )
        _backward_fn = fn
    return _backward_fn


def _launch_backward(q, k, v, mask, out, d_out, n_heads: int, scale: float, hd: int, geo: BackwardGeometry):
    global BACKWARD_LAUNCHES
    # d_out is whatever autograd passes (it may be expanded or sliced): copied
    # when its rows are not 16-byte aligned; the others come from the caller
    if not _aligned(d_out):
        d_out = d_out.clone(memory_format=torch.contiguous_format)
    if mask.stride(-1) != 1:
        mask = mask.contiguous()
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        if not _aligned(t):
            raise ValueError(
                f"attention_short_flat backward: {name} must have a contiguous last "
                f"dimension and 16-byte aligned rows (strides {t.stride()}, "
                f"{t.element_size()}-byte elements)"
            )
    B, L, D = q.shape
    fn = _backward_kernel()
    dq, dk, dv = (torch.empty((B, L, D), dtype=q.dtype, device=q.device) for _ in range(3))
    if B == 0:
        return dq, dk, dv
    stats = None if geo.fused else torch.empty((3, B, n_heads, L), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            _DTYPES[q.dtype], hd, q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
            out.data_ptr(), d_out.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            None if stats is None else stats.data_ptr(), B, L, n_heads,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
            out.stride(0), out.stride(1), d_out.stride(0), d_out.stride(1), mask.stride(0),
            float(scale), stream,
        )
    if err != 0:
        raise RuntimeError(f"attention_short_flat backward: kernel launch failed (cudaError {err})")
    BACKWARD_LAUNCHES += 1
    BACKWARD_ROUTE_LAUNCHES[geo.route] += 1
    return dq, dk, dv


def attention_short_flat_backward(q, k, v, mask, out, d_out, n_heads: int, scale: float):
    """``(dq, dk, dv)`` of :func:`attention_short_flat` at ``out`` for the
    output gradient ``d_out``. CUDA tensors run ``attention_short_bwd.cu``
    on the route :func:`backward_launch_geometry` picks (or raise); CPU
    tensors run :func:`attention_short_flat_backward_plain`."""
    hd, _geo = _check(q, k, v, mask, n_heads)
    if q.device.type == "cpu":
        return attention_short_flat_backward_plain(q, k, v, mask, out, d_out, n_heads, scale)
    if q.device.type != "cuda":
        raise ValueError(f"attention_short_flat backward: no kernel for device {q.device}")
    B, L, _D = q.shape
    geo = backward_launch_geometry(B, L, n_heads, hd, q.dtype)
    return _launch_backward(q, k, v, mask, out, d_out, n_heads, scale, hd, geo)


def _forward(q, k, v, mask, n_heads: int, scale: float):
    hd, geo = _check(q, k, v, mask, n_heads)
    if q.device.type == "cpu":
        return attention_short_flat_plain(q, k, v, mask, n_heads, scale)
    if q.device.type != "cuda":
        raise ValueError(f"attention_short_flat: no kernel for device {q.device}")
    return _launch(q, k, v, mask, n_heads, scale, hd, geo)


class AttentionShortFlat(torch.autograd.Function):
    """Differentiable :func:`attention_short_flat`: the forward kernel (or its
    plain version on the CPU), and :func:`attention_short_flat_backward` for
    the gradient of q, k and v (the mask takes none)."""

    @staticmethod
    def forward(ctx, q, k, v, mask, n_heads: int, scale: float):
        out = _forward(q, k, v, mask, n_heads, scale)
        ctx.save_for_backward(q, k, v, mask, out)
        ctx.n_heads, ctx.scale = n_heads, scale
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, mask, out = ctx.saved_tensors
        dq, dk, dv = attention_short_flat_backward(
            q, k, v, mask, out, d_out, ctx.n_heads, ctx.scale
        )
        return dq, dk, dv, None, None, None


def attention_short_flat(q, k, v, mask, n_heads: int, scale: float):
    """Flat-layout attention: [B, L, D] q/k/v and a [B, L] bool key mask →
    [B, L, D] context. CUDA tensors run the Hopper kernel (or raise); CPU
    tensors run :func:`attention_short_flat_plain`. When grad is enabled and
    q, k or v requires it, the call goes through :class:`AttentionShortFlat`,
    whose backward is a kernel too."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return AttentionShortFlat.apply(q, k, v, mask, n_heads, scale)
    return _forward(q, k, v, mask, n_heads, scale)
