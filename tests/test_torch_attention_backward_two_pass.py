"""The attention backward's two-pass route (``attention_two_pass_dq`` and
``attention_two_pass_dkv`` in ``csrc/attention_bwd.cuh``), which runs only
on the card, emulated on the CPU, and its launch geometry.

The emulation repeats the kernels' tiled arithmetic in plain torch. The dQ
pass: 64-key tiles, the scores ``S = Q·Kᵀ`` summed over the column blocks
of the head in column order (blocks of ``any_width(hd)`` above 128
columns), ``s·scale + fill`` (0 kept, −1e30 masked, −inf past L), folded
tile by tile in key order into the row max and sum as the forward folds
them, ``D = rowsum(dO ∘ O)`` in the same products (the diagonal of
``dO·Oᵀ``); then per key tile ``P = exp(S − m) / l``,
``dP = dO·Vᵀ`` (column blocks in order), ``dS = P ∘ (dP − D)`` (0 at
masked keys) and ``dQ += dS·K`` per output column block, key tiles in
order. The dK/dV pass: per 64-key block and 64-row query tile in order,
``dV += round(P)ᵀ·dO`` and ``dK += dSᵀ·Q``. bf16 rounds P for dV and dS
for dQ and dK; f32 runs every product as a split "3xTF32" product
(``_einsum_3xtf32``). It is held against
``attention_short_flat_backward_plain`` and against ``jax.vjp`` of the
reference's ``_sdpa`` (in f32 on the dtype-rounded inputs) at the chip
check's tolerances: each of dq, dk, dv within 1e-5 (|ref| + max|ref|) in
f32 and 2^-7 (|ref| + max|ref|) in bf16. Inputs come from numpy with a
seed; row 0 of each batch is fully masked, the others have ragged lengths.
"""

from __future__ import annotations

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
from test_torch_attention_backward_fused import _inputs, _kernel_names, _with_headers, _within

TILE = 64  # keys per tile of the dQ pass, and keys / query rows per block
LENGTHS = (129, 200, 600)
WIDTHS = (12, 64, 136, 256)
DTYPES = (torch.float32, torch.bfloat16)
CASES = [
    pytest.param(L, hd, dtype, id=f"L{L}-hd{hd}-{str(dtype).replace('torch.', '')}")
    for L in LENGTHS for hd in WIDTHS for dtype in DTYPES
]


@pytest.fixture(scope="module", autouse=True)
def _one_cpu_thread():
    """Torch's CPU ops on one thread: results here are held to 1e-5 (see
    ``tests/test_torch_attention.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _col_blocks(hd: int) -> list[slice]:
    """The column blocks the kernels sum the scores over, in order: one
    block up to 128 columns, else blocks of ``any_width(hd)``."""
    w = hd if hd <= 128 else A.any_width(hd)
    return [slice(c, min(c + w, hd)) for c in range(0, hd, w)]


def _two_pass_emulation(q, k, v, mask, out, d_out, H, scale):
    """The two-pass route's arithmetic in plain torch, head by head:
    ``(dq, dk, dv)`` in the input dtype."""
    dtype = q.dtype
    prod = _einsum_3xtf32 if dtype == torch.float32 else torch.einsum
    rnd = (lambda x: x.to(dtype).float()) if dtype == torch.bfloat16 else (lambda x: x)  # noqa: E731
    B, L, D = q.shape
    hd = D // H
    nt = -(-L // TILE)
    LP = nt * TILE
    keep = torch.zeros(B, LP, dtype=torch.bool)
    keep[:, :L] = mask
    fill = torch.full((B, LP), float("-inf"))
    fill[:, :L] = torch.where(mask, 0.0, -1e30)
    blocks = _col_blocks(hd)
    tiles = [slice(t * TILE, (t + 1) * TILE) for t in range(nt)]
    grads = [torch.empty(B, L, D, dtype=dtype) for _ in range(3)]
    for h in range(H):
        sl = slice(h * hd, (h + 1) * hd)
        qh, kh, vh, gh = (torch.zeros(B, LP, hd) for _ in range(4))
        for dst, src in ((qh, q), (kh, k), (vh, v), (gh, d_out)):
            dst[:, :L] = src[..., sl].float()
        oh = out[..., sl].float()

        def blocked(a, b, t):
            """a · bᵀ over key tile t, the column blocks summed in order."""
            acc = torch.zeros(B, LP, TILE)
            for cb in blocks:
                acc = acc + prod("bqd,bkd->bqk", a[..., cb], b[:, t, cb])
            return acc

        # dQ pass 1: the forward's fold, tile by tile in key order
        scores = [blocked(qh, kh, t) * scale + fill[:, None, t] for t in tiles]
        m = torch.full((B, LP, 1), float("-inf"))
        l = torch.zeros(B, LP, 1)
        for s in scores:
            n = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            l = l * torch.exp(m - n) + torch.exp(s - n).sum(dim=-1, keepdim=True)
            m = n
        # D = rowsum(dO ∘ O) as the kernel forms it: the diagonal of dO·Oᵀ,
        # the column blocks in order, in the route's products
        row = torch.zeros(B, LP, 1)
        for cb in blocks:
            row[:, :L] = row[:, :L] + prod("bqd,bqd->bq", gh[:, :L, cb], oh[..., cb])[..., None]
        # dQ pass 2: P, dP and dS per key tile; dQ summed over the tiles in order
        p = [torch.exp(s - m) / l for s in scores]
        ds = [torch.where(keep[:, None, t], pt * (blocked(gh, vh, t) - row), 0.0) for pt, t in zip(p, tiles)]
        dq = torch.zeros(B, LP, hd)
        for dst, t in zip(ds, tiles):
            for ob in blocks:
                dq[..., ob] += prod("bqk,bkd->bqd", rnd(dst), kh[:, t, ob])
        # the dK/dV pass: per 64-key block, the query tiles in order (the
        # same scores, so the same P and dS)
        dk, dv = torch.zeros(B, LP, hd), torch.zeros(B, LP, hd)
        for j, kt in enumerate(tiles):
            for u in tiles:
                pu, dsu = rnd(p[j][:, u]), rnd(ds[j][:, u])
                for ob in blocks:
                    dv[:, kt, ob] += prod("bqk,bqd->bkd", pu, gh[:, u, ob])
                    dk[:, kt, ob] += prod("bqk,bqd->bkd", dsu, qh[:, u, ob])
        grads[0][..., sl] = (dq[:, :L] * scale).to(dtype)
        grads[1][..., sl] = (dk[:, :L] * scale).to(dtype)
        grads[2][..., sl] = dv[:, :L].to(dtype)
    return tuple(grads)


def _heads(hd: int) -> int:
    return 2 if hd <= 64 else 1


@pytest.mark.parametrize("L,hd,dtype", CASES)
def test_two_pass_emulation_matches_plain_backward(L, hd, dtype):
    B, H = 2, _heads(hd)
    assert not A.backward_launch_geometry(B, L, H, hd, dtype).fused
    q, k, v, mask, out, g = _inputs(B, L, H, hd, dtype, seed=L + hd)
    got = _two_pass_emulation(q, k, v, mask, out, g, H, hd ** -0.5)
    want = A.attention_short_flat_backward_plain(q, k, v, mask, out, g, H, hd ** -0.5)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and a.shape == (B, L, H * hd)
        _within(a, b, dtype, name)
    # the fully masked row: uniform P and dS = 0, so no gradient to its q
    assert float(got[0][0].float().abs().max()) == 0.0


@pytest.mark.parametrize("L,hd,dtype", CASES)
def test_two_pass_emulation_matches_jax_vjp_of_the_reference_attention(L, hd, dtype):
    B, H = 2, _heads(hd)
    D, scale = H * hd, hd ** -0.5
    q, k, v, mask, out, g = _inputs(B, L, H, hd, dtype, seed=2000 + L + hd)
    got = _two_pass_emulation(q, k, v, mask, out, g, H, scale)

    def f(qj, kj, vj):
        r = lambda t: t.reshape(B, L, H, hd)  # noqa: E731
        return jenc._sdpa(r(qj), r(kj), r(vj), jnp.asarray(mask.numpy()), scale).reshape(B, L, D)

    _, vjp = jax.vjp(f, *(t.float().numpy() for t in (q, k, v)))
    want = vjp(jnp.asarray(g.float().numpy()))
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        _within(a, torch.from_numpy(np.array(b)), dtype, name)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_a_text_with_one_kept_key_gets_no_key_gradient_from_cancellation(dtype):
    """A text whose mask keeps one key: every row's P is one-hot, O is that
    key's V row, and D (formed in dP's own products) equals that key's dP
    exactly, so dS is 0 and dQ and dK are 0, as the plain version's are to
    within rounding."""
    B, L, H, hd = 3, 150, 1, 128
    q, k, v, mask, out, g = _inputs(B, L, H, hd, dtype, seed=31)
    mask[2] = False
    mask[2, 0] = True
    mask[1, :100] = True  # text 1: a real text, whose gradients set the scale
    out = A.attention_short_flat_plain(q, k, v, mask, H, hd ** -0.5)
    got = _two_pass_emulation(q, k, v, mask, out, g, H, hd ** -0.5)
    want = A.attention_short_flat_backward_plain(q, k, v, mask, out, g, H, hd ** -0.5)
    assert float(got[0][2].float().abs().max()) == 0.0 and float(got[1][2].float().abs().max()) == 0.0
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        _within(a, b, dtype, name)


# --- the launch geometry ------------------------------------------------------

_LIMIT = 232_448  # dynamic shared memory a Hopper block may use


def _slots_cu(two: int, one: int, width: int) -> int:
    """``tp_slots`` of ``attention_bwd.cuh``: two ring slots where they fit
    and leave as many blocks an SM (233,472 B, 1,024 B reserved a block) as
    one slot would, up to three at widths up to 64 and two above; else one."""
    per_sm = lambda b: 233_472 // (b + 1024)  # noqa: E731
    return 2 if two <= _LIMIT and per_sm(two) >= min(per_sm(one), 3 if width <= 64 else 2) else 1


def _two_pass_bytes_cu(width: int, ncb: int, elem: int) -> tuple[int, int]:
    """``dq_pass_bytes`` and ``dkv_pass_bytes`` of ``attention_bwd.cuh``
    written out at the slots ``tp_slots`` picks: 64-row tiles padded by 16
    bytes; dQ: Q and dO (one column block) or K of the output block, per
    slot K and V (and Q and dO) and 64 f32 fills; dK/dV: K and V or Q and
    dO of the output block, per slot Q and dO (and K and V), the 64 x (64
    + pad) staging buffer and 64 f32 fills."""
    tile = 64 * (width + 16 // elem) * elem
    dq = {s: (2 + 2 * s if ncb == 1 else 1 + 4 * s) * tile + s * 256 for s in (1, 2)}
    dkv = {s: (2 + 2 * s if ncb == 1 else 2 + 4 * s) * tile + 64 * (64 + 16 // elem) * elem + 256 for s in (1, 2)}
    return dq[_slots_cu(dq[2], dq[1], width)], dkv[_slots_cu(dkv[2], dkv[1], width)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_two_pass_geometry_at_every_head_width(dtype):
    """hd 1..256 at L 128, 129 and 600 and every copy width the pointers may
    allow: where the route is two-pass, 16-byte copies of a head of at most
    128 columns run in ``attention_short_bwd.cu`` at ``kernel_width(hd)``
    in one block, anything else in ``attention_any.cu`` at its copy width
    in ``col_blocks(hd)`` blocks of ``any_width(hd)``; 64-row tiles of 4
    warps, one grid block per (text, head, tile, output column block), and
    the shared bytes of the header's formulas, within the limit."""
    elem = torch.empty(0, dtype=dtype).element_size()
    for hd in range(1, 257):
        for L in (128, 129, 600):
            for allowed in (16, 8, 4, 2):
                if allowed < elem:
                    continue
                vb = min(allowed, (hd * elem) & -(hd * elem))
                geo = A.backward_launch_geometry(3, L, 2, hd, dtype, allowed)
                if geo.fused:
                    assert L <= 128
                    continue
                aligned = hd <= 128 and vb == 16
                width = A.kernel_width(hd) if aligned else A.any_width(hd)
                ncb = 1 if aligned else A.col_blocks(hd)
                assert geo.route == (A.BACKWARD_ROUTES[dtype][1] if aligned else A.ANY_ROUTES[dtype][2])
                assert (geo.width, geo.col_blocks, geo.copy_bytes) == (width, ncb, vb)
                assert (geo.rows, geo.warps, geo.blocks) == (64, 4, (3, 2, -(-L // 64) * ncb))
                assert geo.smem_bytes == max(_two_pass_bytes_cu(width, ncb, elem)) <= _LIMIT
                assert geo == A._two_pass_geometry(3, L, 2, hd, dtype, allowed)


def test_two_pass_ring_slots_and_bytes():
    """Two ring slots where they fit and keep as many blocks an SM as one
    slot would, up to three at widths up to 64 and two above; one where two
    would cost a block: bf16 in column blocks of 128 (157,184 B and 183,552
    B at two slots), f32 at width 64 (104,960 B dQ: two blocks, three at
    one slot) and the f32 dK/dV pass at widths 64 and 80; one where two do
    not fit (f32 in column blocks of 128: 304,640 B dQ). f32 at width 128
    in one block (heads of 80-128 columns the fused block cannot hold)
    keeps two slots, one block an SM either way: 203,264 B and 220,416 B."""
    assert A._two_pass_smem_bytes(128, 1, 4) == (203_264, 220_416)
    assert A._two_pass_smem_bytes(128, 2, 4) == (5 * 64 * 132 * 4 + 256, 6 * 64 * 132 * 4 + 64 * 68 * 4 + 256)
    assert 9 * 64 * 132 * 4 + 512 == 304_640 > _LIMIT
    assert A._two_pass_smem_bytes(128, 2, 2) == (5 * 64 * 136 * 2 + 256, 6 * 64 * 136 * 2 + 64 * 72 * 2 + 256)
    assert 233_472 // (9 * 64 * 136 * 2 + 512 + 1024) == 1
    assert A._two_pass_smem_bytes(64, 1, 2) == (55_808, 64_768)
    assert A._two_pass_smem_bytes(64, 1, 4) == (4 * 64 * 68 * 4 + 256, 4 * 64 * 68 * 4 + 64 * 68 * 4 + 256)
    assert 233_472 // (104_960 + 1024) == 2 < 233_472 // (69_888 + 1024) == 3
    assert A._two_pass_smem_bytes(96, 1, 4)[1] == 6 * 64 * 100 * 4 + 64 * 68 * 4 + 256
    for width in A.KERNEL_WIDTHS:
        for elem in (2, 4):
            for ncb in (1, 2, 3):
                assert max(A._two_pass_smem_bytes(width, ncb, elem)) <= _LIMIT


def test_two_pass_constants_mirror_the_header():
    """The wrapper's tile, key tile and shared-memory limit are the
    header's ``kTpRows``, ``kKeyTile`` and ``kSmemLimit``, and its block is
    ``kTpRows / 16`` warps."""
    cuh = (_build.CSRC / "attention_bwd.cuh").read_text()
    tc = (_build.CSRC / "attention_tc.cuh").read_text()

    def const(src, name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const(cuh, "kTpRows") == A._TP_ROWS == 64
    assert const(tc, "kKeyTile") == A._TC_KEY_TILE == 64
    assert const(cuh, "kSmemLimit") == A._SMEM_LIMIT == _LIMIT
    assert "return (int)(233472 / (bytes + 1024));" in cuh
    assert (A._SM_SMEM, A._BLOCK_RESERVED) == (233_472, 1024)
    assert "constexpr int kTpThreads = kTpRows / 16 * 32;" in cuh
    assert A._two_pass_geometry(1, 600, 1, 64, torch.bfloat16).warps == A._TP_ROWS // 16


@pytest.mark.parametrize("lib", ["attention_short_bwd", "attention_any"])
def test_two_pass_kernels_are_the_only_two_pass_kernels_of_the_source(lib):
    """Both libraries build the two tensor-core kernels of
    ``BACKWARD_KERNELS["two_pass"]`` and no other two-pass kernel: the SIMT
    kernels (``bwd_dq``, ``bwd_dkv`` and their column-blocked twins) and
    their helpers are gone."""
    names = _kernel_names(_with_headers(lib))
    assert set(A.BACKWARD_KERNELS["two_pass"]) <= names
    assert not [n for n in names if n.startswith("bwd_")]
    src = "".join(f.read_text() for f in _build.CSRC.iterdir())
    for gone in ("bwd_dq", "bwd_dkv", "load_tile", "dot_rows", "accum_rows", "dq_smem_bytes", "dkv_smem_bytes"):
        assert not re.search(rf"\b{gone}\b", src), gone


def test_route_names_and_counters():
    """The two-pass routes are named after the tensor cores, per dtype and
    library, and each has a launch counter."""
    assert A.BACKWARD_ROUTES[torch.bfloat16][1] == "two_pass_tensor_core"
    assert A.BACKWARD_ROUTES[torch.float32][1] == "two_pass_tensor_core_3xtf32"
    assert A.ANY_ROUTES[torch.bfloat16][2] == "two_pass_tensor_core_cols"
    assert A.ANY_ROUTES[torch.float32][2] == "two_pass_tensor_core_3xtf32_cols"
    two_pass = {A.BACKWARD_ROUTES[t][1] for t in DTYPES} | {A.ANY_ROUTES[t][2] for t in DTYPES}
    assert two_pass <= set(A.BACKWARD_ROUTE_LAUNCHES)
    assert not [r for r in A.BACKWARD_ROUTE_LAUNCHES if "simt" in r]


def test_backward_ablation_variants_apply_to_the_sources():
    """Every variant of ``tools/backward_ablation.py`` changes the sources
    it names (its substitutions match the tree's ``csrc/``), and only
    ``as_built`` leaves them as they are."""
    from pathway_tpu_torch.tools import backward_ablation as ab

    tree = {f.name: f.read_text() for f in _build.CSRC.iterdir() if f.is_file()}
    for name, (dtypes, subs) in ab.VARIANTS.items():
        files = ab.variant_sources(_build.CSRC, subs)
        changed = {f for f in files if files[f] != tree[f]}
        assert changed == {f for f, _old, _new in subs}, name
        assert set(dtypes) <= {"bfloat16", "float32"}
    # the tool tells the two kernels apart by these parts of their names
    dq, dkv = A.BACKWARD_KERNELS["two_pass"]
    assert "two_pass_dq" in dq and "two_pass_dq" not in dkv and "two_pass" in dkv
