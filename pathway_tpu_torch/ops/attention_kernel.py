"""Short-sequence masked multi-head attention in the flat [B, L, D] layout.

Port of ``pathway_tpu/ops/attention_kernel.py``. Heads are ``hd = D / H``
column slices of q/k/v (no [B, H, L, hd] transpose). Per head: scores
``q·kᵀ·scale`` accumulated in f32; masked keys set to −1e30, which is finite,
so a fully masked row gives the mean of v; softmax in f32; probs normalised,
then cast to the input dtype; ``probs·v`` accumulated in f32 and stored to the
head's output columns.

On a CUDA tensor :func:`attention_short_flat` launches the hand-written Hopper
kernel ``csrc/attention_short.cu`` (design and bound in its header note) or
raises; on a CPU tensor it runs :func:`attention_short_flat_plain`, the same
arithmetic in plain PyTorch. Both devices accept the same envelope: bf16 or
f32, ``hd`` in :data:`HEAD_DIMS`, ``1 <= L <= MAX_LEN``.
"""

from __future__ import annotations

import ctypes

import torch

#: kernel launches since the count was last reset (the kernel's own wrapper
#: adds one per launch; nothing else touches it)
LAUNCHES = 0

#: head widths the kernel is instantiated for (template parameter HD)
HEAD_DIMS = (32, 64, 128)
MAX_LEN = 512
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: an H100 block may use 227 KB of dynamic shared memory
_SMEM_LIMIT = 232448
#: the query-row tile shrinks until a block fits here, so two blocks share an SM
_SMEM_TARGET = 96 * 1024
_MAX_ROWS = 64


def _smem_bytes(L: int, hd: int, itemsize: int, rows: int) -> int:
    """Dynamic shared memory of one block; mirrors ``launch`` in the .cu file:
    K/V rows padded by one 16-byte chunk, the rows' f32 probs, the key mask."""
    lp = (L + 31) // 32 * 32
    return lp * (hd + 16 // itemsize) * itemsize + rows * lp * 4 + lp


def _rows_per_block(L: int, hd: int, itemsize: int) -> int:
    rows = min(_MAX_ROWS, (L + 7) // 8 * 8)
    while rows > 8 and _smem_bytes(L, hd, itemsize, rows) > _SMEM_TARGET:
        rows //= 2
    if _smem_bytes(L, hd, itemsize, rows) > _SMEM_LIMIT:
        raise ValueError(
            f"attention_short_flat: L={L}, hd={hd} at {itemsize}-byte elements "
            f"needs {_smem_bytes(L, hd, itemsize, rows)} B of shared memory per "
            f"block, above the {_SMEM_LIMIT} B a Hopper block may use"
        )
    return rows


def _check(q, k, v, mask, n_heads: int) -> tuple[int, int]:
    """Validate the call; returns (head width, query rows per kernel block)."""
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
    return hd, _rows_per_block(L, hd, q.element_size())


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
            + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int]
            + [ctypes.c_longlong] * 7 + [ctypes.c_float, ctypes.c_void_p]
        )
        _kernel_fn = fn
    return _kernel_fn


def _launch(q, k, v, mask, n_heads: int, scale: float, hd: int, rows: int):
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
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            _DTYPES[q.dtype], hd, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            mask.data_ptr(), out.data_ptr(), B, L, n_heads, rows,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
            mask.stride(0), float(scale), stream,
        )
    if err != 0:
        raise RuntimeError(f"attention_short_flat: kernel launch failed (cudaError {err})")
    LAUNCHES += 1
    return out


def attention_short_flat(q, k, v, mask, n_heads: int, scale: float):
    """Flat-layout attention: [B, L, D] q/k/v and a [B, L] bool key mask →
    [B, L, D] context. CUDA tensors run the Hopper kernel (or raise); CPU
    tensors run :func:`attention_short_flat_plain`."""
    hd, rows = _check(q, k, v, mask, n_heads)
    if q.device.type == "cpu":
        return attention_short_flat_plain(q, k, v, mask, n_heads, scale)
    if q.device.type != "cuda":
        raise ValueError(f"attention_short_flat: no kernel for device {q.device}")
    return _launch(q, k, v, mask, n_heads, scale, hd, rows)
