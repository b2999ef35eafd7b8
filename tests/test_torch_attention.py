"""The port's flat attention against the JAX package's Pallas kernel (run in
interpret mode on the CPU, as the JAX package's own tests run it) and against
its XLA attention for lengths outside the Pallas envelope.

Tolerances: f32 at rtol = atol = 1e-5 (the two sides sum in another order,
nothing else differs). bf16: 2^-7 · (|ref| + max|v|) — one bf16 ulp (at most
2^-7 of a value) of the output, plus one ulp of every prob that rounds the
other way, which moves the output by at most 2^-7 · Σ p·|v| ≤ 2^-7 · max|v|.

Neither kernel route runs here; the tests emulate each route's arithmetic on
the CPU: the bf16 route's tiled softmax, and the f32 route's split "3xTF32"
products (operands rounded to TF32 as ``cvt.rna.tf32.f32`` does), held to the
f32 tolerance, beside one TF32 product that misses it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu_torch.ops import _build
from pathway_tpu_torch.ops import attention_kernel as A


@pytest.fixture(scope="module", autouse=True)
def _one_cpu_thread():
    """Torch's CPU ops run on one thread in this file. On a loaded CPU
    (several test processes of eight threads each on eight cores), its
    multi-threaded ops returned the plain version's output up to 5.1e-5 off
    in about 1% of processes, where every other call read 7.7e-7; at one
    thread none did (``tools/cpu_attention_stress.py``, ROADMAP Queue 3).
    These tests hold results to 1e-5 or to the bit."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(B, L, H, hd, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    D = H * hd
    q, k, v = (rng.standard_normal((B, L, D)).astype(np.float32) for _ in range(3))
    mask = np.ones((B, L), bool)
    mask[:, L - L // 4 :] = False  # padded tail
    mask[0, :] = False  # fully masked row: mean of v, not NaN
    return q, k, v, mask


def _sdpa_ref(q, k, v, mask, H, dtype):
    from pathway_tpu.ops import encoder as E

    B, L, D = q.shape
    hd = D // H
    to = lambda a: jnp.asarray(a, dtype).reshape(B, L, H, hd)
    out = E._sdpa(to(q), to(k), to(v), jnp.asarray(mask), hd ** -0.5).reshape(B, L, D)
    return np.asarray(out.astype(jnp.float32))


def _torch(a, dtype=torch.float32):
    return torch.from_numpy(a).to(dtype)


def test_plain_matches_pallas_kernel_in_interpret_mode_f32():
    from pathway_tpu.ops.attention_kernel import _attention_short_impl

    B, L, H, hd = 16, 64, 6, 64
    q, k, v, mask = _inputs(B, L, H, hd, seed=3)
    ref = _attention_short_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
        H, hd ** -0.5, 8, interpret=True,
    )
    out = A.attention_short_flat_plain(_torch(q), _torch(k), _torch(v), torch.from_numpy(mask), H, hd ** -0.5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    mean_v = np.broadcast_to(v[0].mean(axis=0), out[0].shape)
    np.testing.assert_allclose(out[0].numpy(), mean_v, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B,L,H,hd", [(10, 256, 6, 64), (1, 16, 6, 64), (3, 40, 2, 32), (2, 512, 2, 64), (2, 200, 2, 128)])
def test_plain_matches_xla_attention_outside_pallas_envelope_f32(B, L, H, hd):
    q, k, v, mask = _inputs(B, L, H, hd, seed=L)
    ref = _sdpa_ref(q, k, v, mask, H, jnp.float32)
    out = A.attention_short_flat(_torch(q), _torch(k), _torch(v), torch.from_numpy(mask), H, hd ** -0.5)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B,L", [(4, 128), (10, 256), (1, 16)])
def test_plain_matches_xla_attention_bf16(B, L):
    H, hd = 6, 64
    q, k, v, mask = _inputs(B, L, H, hd, seed=7 + L)
    # both sides start from the same bf16 values
    q, k, v = (np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)) for a in (q, k, v))
    ref = _sdpa_ref(q, k, v, mask, H, jnp.bfloat16)
    bf = torch.bfloat16
    out = A.attention_short_flat(_torch(q, bf), _torch(k, bf), _torch(v, bf), torch.from_numpy(mask), H, hd ** -0.5)
    assert out.dtype == bf
    tol = 2.0 ** -7 * (np.abs(ref) + np.abs(v).max())
    assert (np.abs(out.float().numpy() - ref) <= tol).all()


def test_wrapper_reads_strided_qkv_split_and_counts_no_cpu_launch():
    B, L, H, hd = 2, 32, 2, 64
    D = H * hd
    qkv = torch.from_numpy(np.random.default_rng(0).standard_normal((B, L, 3 * D)).astype(np.float32))
    q, k, v = qkv.split(D, dim=-1)
    mask = torch.ones(B, L, dtype=torch.bool)
    mask[1, 20:] = False
    before = A.LAUNCHES
    out = A.attention_short_flat(q, k, v, mask, H, 0.125)
    ref = A.attention_short_flat_plain(q.contiguous(), k.contiguous(), v.contiguous(), mask, H, 0.125)
    assert torch.equal(out, ref)
    assert A.LAUNCHES == before


@pytest.mark.parametrize(
    "shape,heads,dtype,mask_dtype,match",
    [
        ((2, 16, 24), 2, torch.float32, torch.bool, "head width 12"),
        ((2, 600, 272), 2, torch.float32, torch.bool, "head width 136"),
        ((2, 16, 128), 2, torch.float16, torch.bool, "float32 or bfloat16"),
        ((2, 16, 128), 2, torch.float32, torch.int32, "mask must be bool"),
        ((2, 0, 128), 2, torch.float32, torch.bool, "L=0"),
    ],
)
def test_wrapper_rejects_outside_the_kernel_envelope(shape, heads, dtype, mask_dtype, match):
    """A malformed call raises; a well-formed one at a head width that is
    not a multiple of 8, or above 128, is inside the kernels' envelope now
    (every width runs on the card, unaligned or wide heads in
    ``attention_any.cu``): the check passes it, and on a CPU tensor the call
    runs the plain version and counts no launch."""
    x = torch.zeros(shape, dtype=dtype)
    m = torch.ones(shape[:2], dtype=mask_dtype)
    if match in ("head width 12", "head width 136"):
        assert A._check(x, x, x, m, heads) == int(match.rsplit(" ", 1)[1])
        assert A.in_envelope(shape[1], shape[2] // heads)
        before = (A.LAUNCHES, dict(A.ROUTE_LAUNCHES))
        out = A.attention_short_flat(x, x, x, m, heads, 0.125)
        assert torch.equal(out, A.attention_short_flat_plain(x, x, x, m, heads, 0.125))
        assert (A.LAUNCHES, A.ROUTE_LAUNCHES) == before
        return
    with pytest.raises(ValueError, match=match):
        A.attention_short_flat(x, x, x, m, heads, 0.125)


@pytest.mark.parametrize(
    "L,hd,dtype,rows",
    [
        (128, 64, torch.bfloat16, 128),
        (16, 64, torch.bfloat16, 16),
        (256, 64, torch.bfloat16, 128),
        (512, 64, torch.float32, 128),
        (512, 128, torch.bfloat16, 128),
    ],
)
def test_row_tile_fits_shared_memory(L, hd, dtype, rows):
    geo = A.launch_geometry(2, L, 2, hd, dtype)
    assert geo.rows == rows
    assert geo.smem_bytes <= A._SMEM_LIMIT
    assert geo.smem_bytes == A._tc_smem_bytes(L, hd, rows, torch.empty(0, dtype=dtype).element_size())


@pytest.mark.parametrize("hd", A.KERNEL_WIDTHS)
def test_every_f32_geometry_in_the_envelope_fits_shared_memory(hd):
    """f32 rows take twice the bytes of bf16; at every length the block
    still fits the 227 KB a Hopper block may use (hd 128: 203,264 B, one
    block per SM; hd 64: 104,960 B, two). The key fills ride in the ring
    with their K tile, so no length adds bytes past 128 keys."""
    most = 0
    for L in [*range(1, 1025), 4096, 8192, 16_384]:
        geo = A.launch_geometry(4, L, 384 // hd, hd, torch.float32)
        assert geo.route == "tensor_core_3xtf32" and geo.smem_bytes <= A._SMEM_LIMIT
        most = max(most, geo.smem_bytes)
    assert most == 384 * (hd * 4 + 16) + 512
    assert most == {16: 31232, 32: 55808, 48: 80384, 64: 104960, 80: 129536, 96: 154112,
                    112: 178688, 128: 203264}[hd]
    assert A.launch_geometry(1024, 128, 6, 64, torch.float32).smem_bytes == 104960


def test_launch_geometry_rejects_a_block_above_shared_memory(monkeypatch):
    """hd 256 in f32 at 512 keys ran out of shared memory in one block of
    the aligned kernel; it now runs in two column blocks of 128
    (``attention_any.cu``: 64 query rows, Q and two 64-key ring slots at
    256 columns, 200,192 B). A block above the limit still raises: with the
    limit set below that block, the same call is refused."""
    geo = A.launch_geometry(1, 512, 1, 256, torch.float32)
    assert (geo.route, geo.width, geo.col_blocks, geo.rows, geo.ring_slots, geo.smem_bytes) == (
        "tensor_core_3xtf32_any", 128, 2, 64, 2, 200_192)
    A.launch_geometry.cache_clear()
    monkeypatch.setattr(A, "_SMEM_LIMIT", 200_191)
    try:
        with pytest.raises(ValueError, match="shared memory"):
            A.launch_geometry(1, 512, 1, 256, torch.float32)
    finally:
        A.launch_geometry.cache_clear()


# --- the bf16 route's algorithm, emulated on the CPU ------------------------

#: (B, L, hd) of the kernel's checked cases: the main path's embed, query and
#: reranker shapes, a length that fills no tile evenly, the longest length,
#: and the other head widths (hd 128 with K and V streamed and resident)
ALGO_SHAPES = [
    (4, 128, 64), (1, 16, 64), (10, 256, 64), (3, 77, 64), (2, 512, 64), (2, 256, 128), (2, 128, 32),
    (2, 128, 128),
]
ALGO_D = 384


def _tiled_two_pass(q, k, v, mask, H, scale, tile=64, prod=torch.einsum):
    """The tensor-core route's softmax in plain torch, tile by tile as the
    kernel runs it: keys in 64-key tiles, f32 scores ``s·scale + fill`` with
    the fill 0 for a kept key, −1e30 for a masked key and −inf for the tail
    tile's pad columns (zero-filled K and V rows). Pass 1 folds the tiles in
    key order into a running max m and a rescaled sum l, at every length
    (the kernel keeps the scores of L <= 128 in registers, and recomputes
    them above). Then probs = exp(s − m) / l, rounded to the input dtype,
    and probs·v summed in f32. ``prod(equation, a, b)`` computes both
    products (f32 einsum; :func:`_einsum_3xtf32` for the f32 route's split
    products)."""
    B, L, D = q.shape
    hd = D // H
    nt = -(-L // tile)
    LP = nt * tile
    fill = torch.full((B, LP), float("-inf"))
    fill[:, :L] = torch.where(mask, 0.0, -1e30)
    out = torch.empty(B, L, D, dtype=q.dtype)
    for h in range(H):
        sl = slice(h * hd, (h + 1) * hd)
        qh = q[..., sl].float()
        kh, vh = (torch.zeros(B, LP, hd) for _ in range(2))
        kh[:, :L], vh[:, :L] = k[..., sl].float(), v[..., sl].float()

        def scores(t):
            ts = slice(t * tile, (t + 1) * tile)
            s = prod("bqd,bkd->bqk", qh, kh[:, ts])
            return s * scale + fill[:, None, ts]  # exact: |s·scale| ≪ half an ulp of 1e30

        m = torch.full((B, L, 1), float("-inf"))
        l = torch.zeros(B, L, 1)
        for t in range(nt):  # pass 1
            s = scores(t)
            n = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            l = l * torch.exp(m - n) + torch.exp(s - n).sum(dim=-1, keepdim=True)
            m = n
        acc = torch.zeros(B, L, hd)
        for t in range(nt):  # pass 2 (the resident route reuses its scores)
            p = (torch.exp(scores(t) - m) / l).to(q.dtype).float()
            acc += prod("bqk,bkd->bqd", p, vh[:, t * tile : (t + 1) * tile])
        out[..., sl] = acc.to(q.dtype)
    return out


def _algo_inputs(B, L, hd, dtype):
    H = ALGO_D // hd
    q, k, v, mask = _inputs(B, L, H, hd, seed=B * 1000 + L + hd)
    if dtype == torch.bfloat16:  # both sides start from the same bf16 values
        q, k, v = (np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)) for a in (q, k, v))
    return H, q, k, v, mask


def _assert_close(out, ref, v, dtype):
    if dtype == torch.float32:
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    else:
        assert (np.abs(out - ref) <= 2.0 ** -7 * (np.abs(ref) + np.abs(v).max())).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,L,hd", ALGO_SHAPES)
def test_tiled_two_pass_softmax_matches_plain(B, L, hd, dtype):
    H, q, k, v, mask = _algo_inputs(B, L, hd, dtype)
    args = (_torch(q, dtype), _torch(k, dtype), _torch(v, dtype), torch.from_numpy(mask), H, hd ** -0.5)
    out = _tiled_two_pass(*args)
    plain = A.attention_short_flat_plain(*args)
    assert out.dtype == dtype
    _assert_close(out.float().numpy(), plain.float().numpy(), v, dtype)
    # row 0 is fully masked: the mean of its L real keys' v, the pad columns
    # of the last tile left out
    mean_v = v[0].mean(axis=0)
    _assert_close(out[0].float().numpy(), np.broadcast_to(mean_v, out[0].shape), v[0], dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,L,hd", ALGO_SHAPES)
def test_tiled_two_pass_softmax_matches_jax_reference(B, L, hd, dtype):
    """Against the Pallas kernel in interpret mode inside its envelope
    (L <= 128, L % 8 == 0, hd % 64 == 0), against the JAX package's XLA
    attention outside it."""
    H, q, k, v, mask = _algo_inputs(B, L, hd, dtype)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    if L <= 128 and L % 8 == 0 and hd % 64 == 0:
        from pathway_tpu.ops.attention_kernel import _attention_short_impl

        ref = _attention_short_impl(
            *(jnp.asarray(a, jdt) for a in (q, k, v)), jnp.asarray(mask),
            H, hd ** -0.5, B, interpret=True,
        )
        ref = np.asarray(ref.astype(jnp.float32))
    else:
        ref = _sdpa_ref(q, k, v, mask, H, jdt)
    out = _tiled_two_pass(_torch(q, dtype), _torch(k, dtype), _torch(v, dtype), torch.from_numpy(mask), H, hd ** -0.5)
    _assert_close(out.float().numpy(), ref, v, dtype)


#: (L, padded L) pairs: alone, a text's launch is padded to its own length
#: bucket (L <= 128 keeps keys resident); in a batch, to a longer one
PADDED_LENGTHS = [(64, 128), (64, 256), (77, 128), (128, 256), (128, 512), (256, 512)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("L,LP", PADDED_LENGTHS)
def test_tiled_softmax_gives_a_row_the_same_bits_at_any_padded_length(L, LP, dtype):
    """Both routes fold a row's sum tile by tile in key order, so keys added
    masked (exp 0, the max unchanged) leave every bit of its output as
    it was: the same rows of q, k, v in an L-key and an LP-key launch."""
    H, hd = 2, 64
    rng = np.random.default_rng(L * 1000 + LP)
    q, k, v = (rng.standard_normal((3, LP, H * hd)).astype(np.float32) * 3 for _ in range(3))
    mask = np.zeros((3, LP), bool)
    mask[:, :L] = rng.random((3, L)) < 0.8
    mask[:, 0] = True  # every row keeps a key (a fully masked row averages all L of them)
    args = lambda n: (*(_torch(a[:, :n], dtype) for a in (q, k, v)), torch.from_numpy(mask[:, :n]), H, hd ** -0.5)
    short = _tiled_two_pass(*args(L))
    padded = _tiled_two_pass(*args(LP))[:, :L]
    assert torch.equal(short, padded)


def test_one_pass_row_sum_rounds_otherwise_than_the_fold():
    """Why the kernel folds at every length: a row of 128 keys summed in one
    pass with the final max gives other bits than the running fold of its
    two 64-key tiles for some rows (those whose max lies in tile 2)."""
    rng = np.random.default_rng(0)
    s = torch.from_numpy(rng.standard_normal((4096, 128)).astype(np.float32) * 4)
    m = s.amax(dim=-1, keepdim=True)
    one_pass = torch.exp(s - m).sum(dim=-1, keepdim=True)
    m1 = s[:, :64].amax(dim=-1, keepdim=True)
    fold = torch.exp(s[:, :64] - m1).sum(dim=-1, keepdim=True) * torch.exp(m1 - m)
    fold = fold + torch.exp(s[:, 64:] - m).sum(dim=-1, keepdim=True)
    later = (m1 < m).squeeze(-1)
    assert later.any() and not torch.equal(one_pass[later], fold[later])


# --- the f32 route's split (3xTF32) products, emulated on the CPU ---------


def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 as ``cvt.rna.tf32.f32`` does (to nearest, ties away
    from zero): half a TF32 ulp added to the uint32 bits, the low 13 bits
    cleared."""
    u = x.float().contiguous().numpy().view(np.uint32)
    return torch.from_numpy(((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32))


def _split_tf32(x):
    big = _tf32_rna(x)
    return big, _tf32_rna(x - big)


def _einsum_3xtf32(eq, a, b):
    """The kernel's split product: a = a_big + a_small, b likewise, the two
    cross terms summed in f32 before big·big is added."""
    (ab, as_), (bb, bs) = _split_tf32(a), _split_tf32(b)
    return (torch.einsum(eq, as_, bb) + torch.einsum(eq, ab, bs)) + torch.einsum(eq, ab, bb)


def _einsum_1xtf32(eq, a, b):
    """One TF32 product, as a plain TF32 matmul would take it."""
    return torch.einsum(eq, _tf32_rna(a), _tf32_rna(b))


def _pallas_f32(q, k, v, mask, H, scale):
    from pathway_tpu.ops.attention_kernel import _attention_short_impl

    out = _attention_short_impl(
        *(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(mask), H, scale, q.shape[0], interpret=True
    )
    return np.asarray(out)


def _tf32_inputs(L, hd, x):
    H = ALGO_D // hd
    q, k, v, mask = _inputs(2, L, H, hd, seed=L + hd + x)
    return H, q * x, k * x, v * x, mask


def _exact_f64(q, k, v, mask, H, scale):
    """The attention of the f32 inputs computed in f64 throughout."""
    B, L, D = q.shape
    q, k, v = (torch.from_numpy(a).double().view(B, L, H, D // H) for a in (q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    p = torch.softmax(s.masked_fill(~torch.from_numpy(mask)[:, None, None, :], -1e30), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(B, L, D).numpy()


def _emulate_3xtf32(L, hd, x):
    H, q, k, v, mask = _tf32_inputs(L, hd, x)
    scale = hd ** -0.5
    out = _tiled_two_pass(_torch(q), _torch(k), _torch(v), torch.from_numpy(mask), H, scale, prod=_einsum_3xtf32)
    # row 0 is fully masked: the mean of v (probs 1/L, exact at these L)
    np.testing.assert_allclose(out[0].numpy(), np.broadcast_to(v[0].mean(axis=0), out[0].shape), rtol=1e-5, atol=1e-5)
    return out.numpy(), (q, k, v, mask, H, scale)


@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("L", [16, 128, 512])
def test_3xtf32_products_match_pallas_kernel_at_f32_tolerance(L, hd):
    """The f32 route's arithmetic (split q, k, probs and v, the kernel's
    tiled softmax) against the Pallas kernel in interpret mode at the f32
    route's rtol = atol = 1e-5, row 0 fully masked."""
    out, args = _emulate_3xtf32(L, hd, 1)
    np.testing.assert_allclose(out, _pallas_f32(*args), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("L", [16, 128, 512])
def test_3xtf32_products_are_as_accurate_as_f32_on_inputs_scaled_x4(L, hd):
    """Inputs x4 make the scores 16x larger (std ~16 after scaling) and the
    softmax nearly one-hot, so an output moves with the last bit of a score:
    the Pallas kernel's own f32 result is more than 1e-5 from the exact
    (f64) answer at each of these shapes, and no other summation order stays
    within 1e-5 of it. Here the split products are held to the reference's
    own error instead: within 4x of it (a split operand keeps 22 of f32's 24
    bits: the dropped small x small term is up to 2^-22 of a product, an f32
    rounding 2^-24)."""
    out, args = _emulate_3xtf32(L, hd, 4)
    exact = _exact_f64(*args)
    ref_err = np.abs(_pallas_f32(*args) - exact).max()
    assert ref_err > 1e-5  # why these cases are not held at 1e-5
    assert np.abs(out - exact).max() <= 4 * ref_err


@pytest.mark.parametrize("L,hd", [(128, 64), (512, 128)])
def test_one_tf32_product_misses_f32_tolerance(L, hd):
    """One TF32 product per product (what the f32 route would be without
    the split) misses rtol = atol = 1e-5 on the same inputs: the test above
    has teeth."""
    H, q, k, v, mask = _tf32_inputs(L, hd, 1)
    ref = _pallas_f32(q, k, v, mask, H, hd ** -0.5)
    out = _tiled_two_pass(_torch(q), _torch(k), _torch(v), torch.from_numpy(mask), H, hd ** -0.5, prod=_einsum_1xtf32)
    assert not np.allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
    assert np.abs(out.numpy() - ref).max() > 1e-4


def test_tf32_rounding_is_cvt_rna():
    x = torch.tensor([1.0, 1 + 2.0 ** -11, 1 + 2.0 ** -10 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 2.0 ** -12, 3.0e-39])
    want = [1.0, 1 + 2.0 ** -10, 1 + 2.0 ** -9, -(1 + 2.0 ** -10), 1.0, float(_tf32_rna(torch.tensor([3.0e-39]))[0])]
    assert _tf32_rna(x).tolist() == want
    big, small = _split_tf32(torch.tensor([1 + 2.0 ** -12 + 2.0 ** -20]))
    assert big.item() == 1.0 and small.item() == 2.0 ** -12 + 2.0 ** -20


@pytest.mark.parametrize(
    "B,L,hd,rows,warps,resident,blocks_z",
    [
        (1024, 128, 64, 128, 8, True, 1),  # embed
        (1, 16, 64, 16, 1, True, 1),  # query
        (10, 128, 64, 128, 8, True, 1),  # rerank as the main path runs it
        (10, 256, 64, 128, 8, False, 2),  # rerank at the reranker's max_len
        (3, 77, 64, 80, 5, True, 1),
        (2, 512, 128, 128, 8, False, 4),
        (2, 64, 32, 64, 4, True, 1),  # one key tile
    ],
)
def test_tensor_core_geometry_fits_two_blocks_per_sm(B, L, hd, rows, warps, resident, blocks_z):
    H = ALGO_D // hd
    geo = A.launch_geometry(B, L, H, hd, torch.bfloat16)
    assert geo.route == "tensor_core" and geo.key_tile == 64
    assert (geo.rows, geo.warps, geo.resident) == (rows, warps, resident)
    assert geo.blocks == (B, H, blocks_z)
    # two blocks (plus 1 KB each reserved by the hardware) share an SM's 228 KB
    assert 2 * (geo.smem_bytes + 1024) <= 228 * 1024


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "tensor_core"), (torch.float32, "tensor_core_3xtf32")])
@pytest.mark.parametrize("L", [1, 16, 77, 128, 256, 512])
def test_launch_geometry_picks_the_route_by_dtype(dtype, route, L):
    geo = A.launch_geometry(3, L, 6, 64, dtype)
    assert geo.route == route
    assert geo.rows * geo.blocks[2] >= L > geo.rows * (geo.blocks[2] - 1)
    assert geo.smem_bytes <= A._SMEM_LIMIT


def test_launches_count_per_route_only_on_the_card():
    x = torch.zeros(2, 16, 128, dtype=torch.bfloat16)
    m = torch.ones(2, 16, dtype=torch.bool)
    before = (A.LAUNCHES, dict(A.ROUTE_LAUNCHES))
    A.attention_short_flat(x, x, x, m, 2, 0.125)
    assert (A.LAUNCHES, A.ROUTE_LAUNCHES) == before
    assert set(A.ROUTE_LAUNCHES) == {"tensor_core", "tensor_core_3xtf32", "tensor_core_any", "tensor_core_3xtf32_any"}
    x32 = torch.zeros(2, 16, 128)
    A.attention_short_flat(x32, x32, x32, m, 2, 0.125)
    assert (A.LAUNCHES, A.ROUTE_LAUNCHES) == before


def test_kernel_build_targets_hopper_and_fails_loudly_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "find_nvcc", lambda: "nvcc")
    cmd = _build.nvcc_command("attention_short", tmp_path / "x.so")
    assert cmd[cmd.index("-gencode") + 1] == "arch=compute_90a,code=sm_90a"
    assert cmd[-1].endswith("csrc/attention_short.cu")
    monkeypatch.undo()
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    if not __import__("os").path.exists("/usr/local/cuda/bin/nvcc"):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.find_nvcc()


@pytest.mark.parametrize(
    "variant",
    [
        "as_built", "compiler_division", "exp2_folded", "no_softmax", "one_tf32_product", "no_split",
        "cvt_rna_split", "rz_big",
    ],
)
def test_ablation_variants_still_apply_to_the_kernel_source(variant):
    from pathway_tpu_torch.tools import attention_ablation as AB

    src = (_build.CSRC / _build.SOURCES["attention_short"]).read_text()
    routes, subs = AB.VARIANTS[variant]
    out = AB._variant_source(src, subs)
    kernel = src.index(AB.ROUTES_MARKER)
    assert out[:kernel] == src[:kernel]  # the header note and includes are never touched
    assert (out == src) == (variant == "as_built")
    assert set(routes) <= {"bfloat16", "float32"}
