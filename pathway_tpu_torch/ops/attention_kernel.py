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
f32 at head widths 80-128, a dQ pass and a dK/dV pass on the tensor cores).

On a CUDA tensor :func:`attention_short_flat` launches a hand-written Hopper
kernel or raises. Both routes run on the tensor cores (``mma.sync`` with
async copies): bf16 as bf16 products, f32 as split "3xTF32" products (each
operand split into two TF32 parts, three products per product, near f32
accuracy); :func:`launch_geometry` says how either is launched. On a CPU
tensor it runs :func:`attention_short_flat_plain`, the same arithmetic in
plain PyTorch. The kernels take every head width ``hd >= 1`` and every
``L >= 1`` (:func:`in_envelope` refuses no width), for any q/k/v whose last
dimension is contiguous: a head whose rows, head offsets and pointers are
16-byte aligned and at most 128 wide runs in ``csrc/attention_short.cu``
(instantiated at the widths :data:`KERNEL_WIDTHS`, a head in
:func:`kernel_width` of its width, zero columns up to it, which add
nothing; above 128 keys K and V stream through a ring); any other head (a
bf16 head of 12 columns, the column views of a ``[B, L, 3D]`` projection
at any ``D``, a head wider than 128) runs in ``csrc/attention_any.cu`` at
the widest copy :func:`copy_width` allows (16, 8, 4 or 2 bytes) in column
blocks of :func:`any_width` (at most 128, :data:`ANY_WIDTHS`). The
backward's routes (:func:`backward_launch_geometry`) follow the same split.
"""

from __future__ import annotations

import ctypes
import contextlib
import functools
from typing import NamedTuple

import torch

#: kernel launches since the count was last reset (the kernel's own wrapper
#: adds one per launch; nothing else touches it), in all, per route and per
#: copy width in bytes (the ``*_any`` routes are ``attention_any.cu``'s)
LAUNCHES = 0
ROUTE_LAUNCHES = {"tensor_core": 0, "tensor_core_3xtf32": 0, "tensor_core_any": 0, "tensor_core_3xtf32_any": 0}
COPY_LAUNCHES = {16: 0, 8: 0, 4: 0, 2: 0}
#: backward launches (one per gradient: the fused kernel, or the two kernels
#: of the two-pass route), in all, per backward route and per copy width
BACKWARD_LAUNCHES = 0
BACKWARD_ROUTE_LAUNCHES = {
    "fused_tensor_core": 0, "fused_tensor_core_3xtf32": 0,
    "two_pass_tensor_core": 0, "two_pass_tensor_core_3xtf32": 0,
    "fused_tensor_core_any": 0, "fused_tensor_core_3xtf32_any": 0,
    "two_pass_tensor_core_cols": 0, "two_pass_tensor_core_3xtf32_cols": 0,
}
BACKWARD_COPY_LAUNCHES = {16: 0, 8: 0, 4: 0, 2: 0}
#: the backward's route names per input dtype: (fused, two-pass)
BACKWARD_ROUTES = {
    torch.bfloat16: ("fused_tensor_core", "two_pass_tensor_core"),
    torch.float32: ("fused_tensor_core_3xtf32", "two_pass_tensor_core_3xtf32"),
}
#: the ``__global__`` kernels of the backward per route kind (a profiler's
#: kernel names contain them; both libraries instantiate them)
BACKWARD_KERNELS = {"fused": ("attention_bwd_fused",), "two_pass": ("attention_two_pass_dq", "attention_two_pass_dkv")}
#: route name per input dtype
ROUTES = {torch.bfloat16: "tensor_core", torch.float32: "tensor_core_3xtf32"}
#: ``attention_any.cu``'s routes per input dtype: (forward, fused backward,
#: two-pass backward at any copy width, in column blocks above 128 columns)
ANY_ROUTES = {
    torch.bfloat16: ("tensor_core_any", "fused_tensor_core_any", "two_pass_tensor_core_cols"),
    torch.float32: ("tensor_core_3xtf32_any", "fused_tensor_core_3xtf32_any", "two_pass_tensor_core_3xtf32_cols"),
}
_ANY_FORWARD_ROUTES = frozenset(routes[0] for routes in ANY_ROUTES.values())
_ANY_BACKWARD_ROUTES = frozenset(r for routes in ANY_ROUTES.values() for r in routes[1:])

#: head widths the kernels are instantiated for (template parameter HD); a
#: head of width hd runs in kernel_width(hd)
KERNEL_WIDTHS = (16, 32, 48, 64, 80, 96, 112, 128)
#: block widths of ``attention_any.cu``'s kernels; a head of hd columns runs
#: in col_blocks(hd) blocks of any_width(hd)
ANY_WIDTHS = (16, 32, 64, 128)
#: the full widths its forward (``attention_any_kernel<T, HD>``) is
#: instantiated at: col_blocks(hd) * any_width(hd) for heads of up to
#: _ANY_FULL_COLS blocks; wider heads run ``attention_any_cols_kernel`` at 128
ANY_FORWARD_WIDTHS = (16, 32, 64, 128, 256)
_MAX_COL_BLOCK = 128
_ANY_FULL_COLS = 2
#: query rows per block of that forward at most (``kAnyRows``)
_ANY_MAX_ROWS = 64
#: streaming multiprocessors of an H100 SXM
_SM_COUNT = 132
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
#: the two-pass backward: 64 query rows (dQ pass) or keys (dK/dV pass) per
#: block, one warp per 16 (``kTpRows`` in ``attention_bwd.cuh``)
_TP_ROWS = 64


class LaunchGeometry(NamedTuple):
    route: str  #: a key of ROUTE_LAUNCHES
    rows: int  #: query rows per block
    warps: int  #: warps per block
    key_tile: int  #: keys per shared-memory tile
    resident: bool  #: K and V of a (batch row, head) held in shared memory at once
    smem_bytes: int  #: dynamic shared memory per block
    blocks: tuple[int, int, int]  #: grid (batch rows, heads, query-row tiles)
    copy_bytes: int = 16  #: bytes per copy of q, k, v and the output
    width: int = 0  #: the instantiated width (of one column block)
    col_blocks: int = 1  #: column blocks a head runs in
    ring_slots: int = 0  #: ``attention_any_kernel``'s 64-key K/V slots (0: another kernel)


def kernel_width(hd: int) -> int:
    """The instantiation a head of ``hd`` columns runs in: ``hd`` rounded up
    to 16 (``kernel_width`` in ``csrc/attention_tc.cuh``)."""
    return -(-hd // 16) * 16


def col_blocks(hd: int) -> int:
    """Column blocks of at most 128 a head of ``hd`` columns runs in on
    ``attention_any.cu``'s kernels (``col_blocks`` in ``attention_tc.cuh``)."""
    return -(-hd // _MAX_COL_BLOCK)


def any_width(hd: int) -> int:
    """The block width of ``attention_any.cu`` for a head of ``hd`` columns:
    ``ceil(hd / col_blocks(hd))`` rounded up to one of :data:`ANY_WIDTHS`
    (``any_width`` in ``attention_tc.cuh``)."""
    per = -(-hd // col_blocks(hd))
    return next(w for w in ANY_WIDTHS if w >= per)


def copy_width(hd: int, elem: int, *tensors: torch.Tensor) -> int:
    """The widest copy, 16, 8, 4 or 2 bytes, that divides ``hd * elem`` and
    every pointer and row stride of ``tensors`` (``elem``-byte elements):
    the lowest set bit of their OR."""
    x = hd * elem | 16
    for t in tensors:
        x |= t.data_ptr() | t.stride(0) * elem | t.stride(1) * elem
    return x & -x


def _copy_bytes(hd: int, elem: int, copy_bytes: int) -> int:
    """``copy_bytes`` lowered until it divides ``hd * elem``."""
    x = hd * elem | copy_bytes
    return x & -x


def _tc_smem_bytes(L: int, hd: int, rows: int, elem: int) -> int:
    """Dynamic shared memory of one block with ``elem``-byte elements at the
    instantiated width ``hd``; mirrors ``tc_smem_bytes`` in the .cu file: the
    Q tile, K and V (resident, or a 2-tile ring each) in rows padded by 16
    bytes, and one f32 fill per key of those K rows (at most 128, whatever
    ``L`` is)."""
    kv_rows = _TC_KEY_TILE if L <= _TC_KEY_TILE else 2 * _TC_KEY_TILE
    return (rows + 2 * kv_rows) * (hd * elem + _TC_ROW_PAD_BYTES) + kv_rows * 4


def _any_min_blocks(full: int, elem: int) -> int:
    """``any_min_blocks``: the blocks of 64 rows an SM the forward's registers
    allow, by its full width ``full``."""
    if full == 16 or (full == 32 and elem == 2):
        return 4
    return 3 if full <= 64 else 2 if full == 128 or elem == 2 else 1


def _any_smem_bytes(full: int, rows: int, elem: int, slots: int) -> int:
    """Dynamic shared memory of one block of ``attention_any.cu``'s forward
    at the full width ``full`` (``col_blocks * any_width``, at most 256);
    mirrors ``any_smem_bytes``: Q's rows and ``slots`` ring slots of 64 keys,
    rows padded by 16 bytes, and 64 f32 fills a slot (217,088 B at most: f32
    at 256 columns, 16 rows, 3 slots)."""
    return (rows + slots * _TC_KEY_TILE) * (full * elem + _TC_ROW_PAD_BYTES) + slots * _TC_KEY_TILE * 4


def _any_blocks_per_sm(full: int, rows: int, elem: int, slots: int) -> int:
    """``any_blocks_per_sm``: blocks of ``rows`` query rows an SM holds, by
    shared memory and by the registers the launch bound grants."""
    by_regs = _any_min_blocks(full, elem) * 64 // rows
    return min(by_regs, _SM_SMEM // (_any_smem_bytes(full, rows, elem, slots) + _BLOCK_RESERVED))


def _any_slots(full: int, rows: int, elem: int, blocks: int) -> int:
    """``any_slots``: the ring's slots for a grid of ``blocks``, the most of 4
    and 3 whose block fits and leaves an SM as many blocks as the grid can
    use (as two slots allow, at most ``ceil(blocks / 132)``); else 2."""
    want = min(-(-blocks // _SM_COUNT), _any_blocks_per_sm(full, rows, elem, 2))
    for slots in (4, 3):
        if (_any_smem_bytes(full, rows, elem, slots) <= _SMEM_LIMIT
                and _any_blocks_per_sm(full, rows, elem, slots) >= want):
            return slots
    return 2


def _any_cols_smem_bytes(width: int, rows: int, elem: int) -> int:
    """Dynamic shared memory of one block of ``attention_any.cu``'s forward
    above 256 columns (``attention_any_cols_kernel``); mirrors
    ``any_cols_smem_bytes``: the rows of one column block of Q, one K and
    one V tile of 64 keys, rows padded by 16 bytes, and the tile's 64 f32
    fills (135,424 B at most: f32 at width 128, 128 rows)."""
    return (rows + 2 * _TC_KEY_TILE) * (width * elem + _TC_ROW_PAD_BYTES) + _TC_KEY_TILE * 4


@functools.lru_cache(maxsize=256)
def launch_geometry(B: int, L: int, n_heads: int, hd: int, dtype: torch.dtype,
                    copy_bytes: int = 16) -> LaunchGeometry:
    """How the kernel is launched for one call, given the widest copy the
    pointers and row strides allow (``copy_bytes``, lowered here until it
    divides ``hd * elem``; :func:`copy_width`). A head of at most 128
    columns with 16-byte copies runs in ``attention_short.cu`` at the
    instantiated width :func:`kernel_width` of ``hd`` (~199 KB of shared
    memory at most: f32 at width 128, any ``L``); every other head in
    ``attention_any.cu`` (route ``*_any``) at its copy width, in
    :func:`col_blocks` blocks of :func:`any_width`: up to two blocks (256
    columns) held at once, Q resident, K and V through a ring of
    :func:`_any_slots` 64-key slots, up to 64 query rows a block
    (resident: one score pass, L <= 128); wider heads one block at a time,
    up to 128 rows. Both dtypes share the geometry but for the ring's
    slots, f32 with twice the shared memory. A block above the 227
    KB a Hopper block may use raises. Cached: the main path repeats a
    handful of shapes, and the wrapper's host time is most of a small
    call's time."""
    rows = min(_TC_MAX_ROWS, (L + 15) // 16 * 16)
    elem = 2 if dtype == torch.bfloat16 else 4
    vb = _copy_bytes(hd, elem, copy_bytes)
    blocks = (B, n_heads, -(-L // rows))
    if hd <= _MAX_COL_BLOCK and vb == 16:
        width = kernel_width(hd)
        geo = LaunchGeometry(
            ROUTES[dtype], rows, rows // 16, _TC_KEY_TILE, L <= _TC_RESIDENT_LEN,
            _tc_smem_bytes(L, width, rows, elem), blocks, vb, width, 1,
        )
    elif col_blocks(hd) <= _ANY_FULL_COLS:
        width, ncb = any_width(hd), col_blocks(hd)
        full = width * ncb
        rows = min(_ANY_MAX_ROWS, (L + 15) // 16 * 16)
        slots = _any_slots(full, rows, elem, B * n_heads * -(-L // rows))
        geo = LaunchGeometry(
            ANY_ROUTES[dtype][0], rows, rows // 16, _TC_KEY_TILE, L <= _TC_RESIDENT_LEN,
            _any_smem_bytes(full, rows, elem, slots), (B, n_heads, -(-L // rows)), vb, width, ncb, slots,
        )
    else:
        width = any_width(hd)
        geo = LaunchGeometry(
            ANY_ROUTES[dtype][0], rows, rows // 16, _TC_KEY_TILE, False,
            _any_cols_smem_bytes(width, rows, elem), blocks, vb, width, col_blocks(hd),
        )
    if geo.smem_bytes > _SMEM_LIMIT:
        raise ValueError(
            f"attention_short_flat: L={L}, hd={hd} in {dtype} needs {geo.smem_bytes} B "
            f"of shared memory per block, above the {_SMEM_LIMIT} B a Hopper block may use"
        )
    return geo


class BackwardGeometry(NamedTuple):
    route: str  #: a key of BACKWARD_ROUTE_LAUNCHES
    fused: bool  #: one fused kernel (else the dQ pass, then the dK/dV pass)
    rows: int  #: query rows (fused: and keys) per block
    warps: int  #: warps per block
    smem_bytes: int  #: dynamic shared memory per block (two-pass: the larger kernel's)
    blocks: tuple[int, int, int]  #: grid (batch rows, heads, row tiles [x column blocks])
    copy_bytes: int = 16  #: bytes per copy in and out
    width: int = 0  #: the instantiated width (of one column block)
    col_blocks: int = 1  #: column blocks a head runs in


def _fused_smem_bytes(rows: int, hd: int, elem: int) -> int:
    """Shared bytes of one fused backward block; mirrors ``fused_smem_bytes``
    in ``attention_bwd.cuh``: the Q, K, V and dO tiles and the rows x rows
    staging buffer, in ``elem``-byte elements, rows padded by 16 bytes."""
    pad = _TC_ROW_PAD_BYTES // elem
    return (4 * rows * (hd + pad) + rows * (rows + pad)) * elem


#: shared memory of one H100 SM, and what each resident block reserves of it
_SM_SMEM = 233_472
_BLOCK_RESERVED = 1024


def _ring_slots(two: int, one: int, cap: int) -> int:
    """``tp_slots`` of ``attention_bwd.cuh``: two ring slots where the block
    of ``two`` bytes fits and leaves as many blocks an SM as one slot (of
    ``one`` bytes) would, up to ``cap`` (what the kernels' registers allow);
    else one."""
    per_sm = lambda b: _SM_SMEM // (b + _BLOCK_RESERVED)  # noqa: E731
    return 2 if two <= _SMEM_LIMIT and per_sm(two) >= min(per_sm(one), cap) else 1


def _two_pass_smem_bytes(width: int, ncb: int, elem: int) -> tuple[int, int]:
    """Shared bytes of the two-pass route's dQ block and dK/dV block at block
    width ``width`` in ``ncb`` column blocks; mirrors ``dq_pass_bytes`` and
    ``dkv_pass_bytes`` in ``attention_bwd.cuh`` at the ring slots
    :func:`_ring_slots` picks: 64-row tiles padded by 16 bytes, 64 f32
    fills per ring slot (dQ) or per block (dK/dV), and the dK/dV block's
    64 x 64 staging buffer."""
    tile = _TP_ROWS * (width * elem + _TC_ROW_PAD_BYTES)
    fills = _TC_KEY_TILE * 4

    def dq(slots):
        return (2 + 2 * slots if ncb == 1 else 1 + 4 * slots) * tile + slots * fills

    def dkv(slots):
        return ((2 + 2 * slots if ncb == 1 else 2 + 4 * slots) * tile
                + _TP_ROWS * (_TC_KEY_TILE * elem + _TC_ROW_PAD_BYTES) + fills)

    cap = 3 if width <= 64 else 2  # blocks an SM the kernels' registers allow
    return dq(_ring_slots(dq(2), dq(1), cap)), dkv(_ring_slots(dkv(2), dkv(1), cap))


def _two_pass_geometry(B: int, L: int, n_heads: int, hd: int, dtype: torch.dtype,
                       copy_bytes: int = 16) -> BackwardGeometry:
    """The two-pass route: a dQ pass and a dK/dV pass of 64-row tiles (4
    warps) on the tensor cores, one grid block per (text, head, tile,
    output column block). 16-byte copies of a head of at most 128 columns
    run in ``attention_short_bwd.cu`` at :func:`kernel_width`; any other
    head in ``attention_any.cu`` (route ``two_pass_*_cols``) at its copy
    width in :func:`col_blocks` blocks of :func:`any_width`. The shared
    bytes are the larger of the two kernels' (:func:`_two_pass_smem_bytes`)."""
    elem = 2 if dtype == torch.bfloat16 else 4
    vb = _copy_bytes(hd, elem, copy_bytes)
    if hd <= _MAX_COL_BLOCK and vb == 16:
        width, route, ncb = kernel_width(hd), BACKWARD_ROUTES[dtype][1], 1
    else:
        width, route, ncb = any_width(hd), ANY_ROUTES[dtype][2], col_blocks(hd)
    smem = max(_two_pass_smem_bytes(width, ncb, elem))
    return BackwardGeometry(
        route, False, _TP_ROWS, _TP_ROWS // 16, smem, (B, n_heads, -(-L // _TP_ROWS) * ncb), vb, width, ncb,
    )


@functools.lru_cache(maxsize=256)
def backward_launch_geometry(B: int, L: int, n_heads: int, hd: int, dtype: torch.dtype,
                             copy_bytes: int = 16) -> BackwardGeometry:
    """How the backward is launched for one call, given the widest copy the
    pointers and row strides allow (as :func:`launch_geometry`): the fused
    route for ``L <= 128`` and ``hd <= 128`` where its block fits at 128
    rows, one block per (batch row, head) of ``16 * ceil(L / 16)`` rows,
    with 16-byte copies at :func:`kernel_width` of ``hd``
    (``attention_short_bwd.cu``: every bf16 width, f32 up to 64) or at a
    narrower copy at :func:`any_width` (``attention_any.cu``, route
    ``fused_*_any``); else the two-pass route (any ``L``, any alignment:
    :func:`_two_pass_geometry`)."""
    elem = 2 if dtype == torch.bfloat16 else 4
    vb = _copy_bytes(hd, elem, copy_bytes)
    if L <= _BWD_FUSED_MAX_LEN and hd <= _MAX_COL_BLOCK:
        width = kernel_width(hd) if vb == 16 else any_width(hd)
        if _fused_smem_bytes(_BWD_FUSED_MAX_LEN, width, elem) <= _SMEM_LIMIT:
            rows = (L + 15) // 16 * 16
            route = BACKWARD_ROUTES[dtype][0] if vb == 16 else ANY_ROUTES[dtype][1]
            return BackwardGeometry(
                route, True, rows, rows // 16, _fused_smem_bytes(rows, width, elem),
                (B, n_heads, 1), vb, width, 1,
            )
    return _two_pass_geometry(B, L, n_heads, hd, dtype, vb)


def in_envelope(L: int, hd: int) -> bool:
    """Whether the kernels take sequences of ``L`` keys in heads of ``hd``:
    every ``hd >= 1`` and ``L >= 1`` (since the copies take any alignment
    and heads wider than 128 run in column blocks); decided from the shape
    alone, before any launch."""
    return hd >= 1 and L >= 1


def _check(q, k, v, mask, n_heads: int) -> int:
    """Validate what every route needs; returns the head width."""
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
    if L < 1:
        raise ValueError(f"attention_short_flat: L={L}, no keys")
    if len({t.device for t in (q, k, v, mask)}) != 1:
        raise ValueError("attention_short_flat: q, k, v and mask must share one device")
    return D // n_heads


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


def _contiguous_rows(name: str, *tensors) -> None:
    for label, t in zip(name.split(), tensors):
        if t.stride(-1) != 1:
            raise ValueError(
                f"attention_short_flat: {label} must have a contiguous last dimension "
                f"(strides {t.stride()})"
            )


def _bind(lib: str, symbol: str, argtypes: list):
    """A C entry point of a kernel library, built and bound at first use."""
    from pathway_tpu_torch.ops import _build

    fn = getattr(_build.load(lib), symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    return fn


#: the forward's arguments after (dtype, hd[, copy width]): q, k, v, mask,
#: out, B, L, H, rows, six q/k/v strides, the mask's stride, scale, stream
_FWD_ARGS = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 3
             + [ctypes.c_longlong] * 7 + [ctypes.c_float, ctypes.c_void_p])
#: the backward's: q, k, v, mask, out, d_out, dq, dk, dv, stats, B, L, H,
#: ten strides, the mask's stride, scale, stream
_BWD_ARGS = ([ctypes.c_void_p] * 10 + [ctypes.c_longlong] + [ctypes.c_int] * 2
             + [ctypes.c_longlong] * 11 + [ctypes.c_float, ctypes.c_void_p])


_kernel_fn = _any_fn = _backward_fn = _backward_any_fn = None


def _kernel():
    """The forward's C entry point of ``attention_short.cu``, bound at first use."""
    global _kernel_fn
    if _kernel_fn is None:
        _kernel_fn = _bind("attention_short", "pw_attention_short_flat", [ctypes.c_int] * 2 + _FWD_ARGS)
    return _kernel_fn


def _any_kernel():
    """The forward's C entry point of ``attention_any.cu``, bound at first use."""
    global _any_fn
    if _any_fn is None:
        _any_fn = _bind("attention_any", "pw_attention_any_flat", [ctypes.c_int] * 3 + _FWD_ARGS)
    return _any_fn


def _backward_kernel():
    """The backward's C entry point of ``attention_short_bwd.cu``, bound at first use."""
    global _backward_fn
    if _backward_fn is None:
        _backward_fn = _bind(
            "attention_short_bwd", "pw_attention_short_flat_backward", [ctypes.c_int] * 2 + _BWD_ARGS
        )
    return _backward_fn


def _backward_any_kernel():
    """The backward's C entry point of ``attention_any.cu``, bound at first use."""
    global _backward_any_fn
    if _backward_any_fn is None:
        _backward_any_fn = _bind(
            "attention_any", "pw_attention_any_flat_backward", [ctypes.c_int] * 3 + _BWD_ARGS
        )
    return _backward_any_fn


def _launch(q, k, v, mask, n_heads: int, scale: float, hd: int):
    global LAUNCHES
    _contiguous_rows("q k v", q, k, v)
    B, L, D = q.shape
    geo = launch_geometry(B, L, n_heads, hd, q.dtype, copy_width(hd, q.element_size(), q, k, v))
    if mask.stride(-1) != 1:
        mask = mask.contiguous()
    out = torch.empty((B, L, D), dtype=q.dtype, device=q.device)
    if B == 0:
        return out
    args = (
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(), B, L, n_heads,
        geo.rows, q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
        mask.stride(0), float(scale),
    )
    # switching the current device costs more host time than a small launch
    # takes on the card, so only do it when q lives on another card
    on_current = q.device.index == torch.cuda.current_device()
    with contextlib.nullcontext() if on_current else torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if geo.route in _ANY_FORWARD_ROUTES:
            err = _any_kernel()(_DTYPES[q.dtype], hd, geo.copy_bytes, *args, stream)
        else:
            err = _kernel()(_DTYPES[q.dtype], hd, *args, stream)
    if err != 0:
        raise RuntimeError(f"attention_short_flat: kernel launch failed (cudaError {err})")
    LAUNCHES += 1
    ROUTE_LAUNCHES[geo.route] += 1
    COPY_LAUNCHES[geo.copy_bytes] += 1
    return out


def _launch_backward(q, k, v, mask, out, d_out, n_heads: int, scale: float, hd: int, geo: BackwardGeometry):
    global BACKWARD_LAUNCHES
    _contiguous_rows("q k v out", q, k, v, out)
    es = q.element_size()
    # d_out is whatever autograd passes (it may be expanded or sliced): copied
    # when it would lower the route's copy width; the others come from the
    # caller, who picked the route from their copy width
    if d_out.stride(-1) != 1 or copy_width(hd, es, d_out) < geo.copy_bytes:
        d_out = d_out.clone(memory_format=torch.contiguous_format)
    if copy_width(hd, es, q, k, v, out) < geo.copy_bytes:
        raise ValueError(
            f"attention_short_flat backward: route {geo.route} copies {geo.copy_bytes} bytes, "
            f"above what the rows of q, k, v and out allow"
        )
    if mask.stride(-1) != 1:
        mask = mask.contiguous()
    B, L, D = q.shape
    dq, dk, dv = (torch.empty((B, L, D), dtype=q.dtype, device=q.device) for _ in range(3))
    if B == 0:
        return dq, dk, dv
    stats = None if geo.fused else torch.empty((3, B, n_heads, L), dtype=torch.float32, device=q.device)
    args = (
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(), d_out.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), None if stats is None else stats.data_ptr(),
        B, L, n_heads, q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
        out.stride(0), out.stride(1), d_out.stride(0), d_out.stride(1), mask.stride(0), float(scale),
    )
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if geo.route in _ANY_BACKWARD_ROUTES:
            err = _backward_any_kernel()(_DTYPES[q.dtype], hd, geo.copy_bytes, *args, stream)
        else:
            err = _backward_kernel()(_DTYPES[q.dtype], hd, *args, stream)
    if err != 0:
        raise RuntimeError(f"attention_short_flat backward: kernel launch failed (cudaError {err})")
    BACKWARD_LAUNCHES += 1
    BACKWARD_ROUTE_LAUNCHES[geo.route] += 1
    BACKWARD_COPY_LAUNCHES[geo.copy_bytes] += 1
    return dq, dk, dv


def attention_short_flat_backward(q, k, v, mask, out, d_out, n_heads: int, scale: float):
    """``(dq, dk, dv)`` of :func:`attention_short_flat` at ``out`` for the
    output gradient ``d_out``. CUDA tensors run ``attention_short_bwd.cu``
    or ``attention_any.cu`` on the route :func:`backward_launch_geometry`
    picks (or raise); CPU tensors run :func:`attention_short_flat_backward_plain`."""
    hd = _check(q, k, v, mask, n_heads)
    if q.device.type == "cpu":
        return attention_short_flat_backward_plain(q, k, v, mask, out, d_out, n_heads, scale)
    if q.device.type != "cuda":
        raise ValueError(f"attention_short_flat backward: no kernel for device {q.device}")
    B, L, _D = q.shape
    geo = backward_launch_geometry(B, L, n_heads, hd, q.dtype, copy_width(hd, q.element_size(), q, k, v, out))
    return _launch_backward(q, k, v, mask, out, d_out, n_heads, scale, hd, geo)


def _forward(q, k, v, mask, n_heads: int, scale: float):
    hd = _check(q, k, v, mask, n_heads)
    if q.device.type == "cpu":
        return attention_short_flat_plain(q, k, v, mask, n_heads, scale)
    if q.device.type != "cuda":
        raise ValueError(f"attention_short_flat: no kernel for device {q.device}")
    return _launch(q, k, v, mask, n_heads, scale, hd)


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
    [B, L, D] context, at any head width and length. CUDA tensors run a
    Hopper kernel (or raise); CPU tensors run
    :func:`attention_short_flat_plain`. When grad is enabled and q, k or v
    requires it, the call goes through :class:`AttentionShortFlat`, whose
    backward is a kernel too."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return AttentionShortFlat.apply(q, k, v, mask, n_heads, scale)
    return _forward(q, k, v, mask, n_heads, scale)
