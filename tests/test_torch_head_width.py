"""Head widths and lengths of the reference's attention, on the port.

The reference runs its Pallas kernel only inside its envelope and XLA's
``_sdpa`` everywhere else, so its encoder takes any head width and length.
So do the port's kernels: a 16-byte aligned head of at most 128 columns in
``attention_short.cu`` (instantiated at 16, 32, ..., 128, a head run in
its width rounded up to 16), every other head (a width such as 12 or 136)
in ``attention_any.cu``; on a CPU tensor ``attention_short_flat`` runs its
plain version at every width and counts no launch.

Cases: the reference's ``SMALL`` encoder (4 heads of 16 at d 64, the
multichip dry run's) encoded on both packages within 1e-5 (f32), one
contrastive train step within the chip check's f32 gradient tolerance
(1e-3 of each leaf's largest value), encoders at head widths 8, 48 and 96
and at ``max_len`` 1,024 against the reference (which runs ``_sdpa`` there)
within 1e-5, the launch geometry of both kernels over every width and
lengths up to 16,384, and 12- and 136-wide heads on the CPU's plain
version, equal to the reference's ``_sdpa`` within 1e-5, and the same calls
off the CPU routed to a kernel. ``tests/test_torch_head_width_any.py``
holds the encoders, reranker and train step at those widths.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.ops import encoder as J
from pathway_tpu_torch.convert import params_from_numpy, tree_leaves
from pathway_tpu_torch.ops import attention_kernel as A
from pathway_tpu_torch.ops import encoder as T

#: a train step's loss and every gradient leaf, against the leaf's largest
#: reference value (chip_smoke.py's TRAIN_GRAD_TOL for f32)
TRAIN_GRAD_TOL = 1e-3
SMALL = dict(vocab_size=512, d_model=64, n_heads=4, n_layers=2, d_ff=128, max_len=32)


def _cfgs():
    return J.EncoderConfig(dtype=jnp.float32, **SMALL), T.EncoderConfig(dtype=torch.float32, **SMALL)


def _ids(B=2, L=16, seed=0):
    rng = np.random.default_rng(seed)
    lens = rng.integers(4, L + 1, size=B)
    mask = np.arange(L)[None] < lens[:, None]
    ids = np.where(mask, rng.integers(3, SMALL["vocab_size"], size=(B, L)), 0).astype(np.int32)
    return ids, mask


def _reset_routes():
    A.ROUTE_LAUNCHES.update(dict.fromkeys(A.ROUTE_LAUNCHES, 0))


def test_head_width_16_is_in_the_kernel_envelope():
    assert 16 in A.KERNEL_WIDTHS and A.in_envelope(16, 16) and A.in_envelope(16_384, 16)
    assert A.in_envelope(16, 48) and A.in_envelope(600, 64) and A.in_envelope(1, 8)
    # every width is in the envelope now (12 and 136 too); no length below 1
    assert A.in_envelope(16, 12) and A.in_envelope(16, 136) and not A.in_envelope(0, 64)
    assert [hd for hd in range(1, 200) if A.in_envelope(128, hd)] == list(range(1, 200))
    assert [A.kernel_width(hd) for hd in range(8, 129, 8)] == [
        w for w in A.KERNEL_WIDTHS for _ in (0, 1)]
    for L in (16, 128):
        geo = A.launch_geometry(8, L, 4, 16, torch.float32)
        assert geo.smem_bytes <= A._SMEM_LIMIT
        bwd = A.backward_launch_geometry(8, L, 4, 16, torch.bfloat16)
        assert bwd.fused and bwd.smem_bytes <= A._SMEM_LIMIT
    assert not A.backward_launch_geometry(2, 200, 4, 16, torch.float32).fused


def test_encode_at_head_width_16_matches_the_reference():
    cj, ct = _cfgs()
    pj = J.init_params(cj, jax.random.PRNGKey(0))
    ids, mask = _ids()
    want = np.asarray(J.encode(pj, cj, jnp.asarray(ids), jnp.asarray(mask)))
    _reset_routes()
    before = A.LAUNCHES
    got = T.encode(params_from_numpy(jax.tree.map(np.asarray, pj), device="cpu"), ct,
                   torch.from_numpy(ids).long(), torch.from_numpy(mask))
    assert got.shape == (2, 64) and want.shape == (2, 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # the CPU runs the plain version: no launch on any route
    assert A.LAUNCHES == before and not any(A.ROUTE_LAUNCHES.values())


def test_train_step_at_head_width_16_matches_the_reference():
    cj, ct = _cfgs()
    pj = J.init_params(cj, jax.random.PRNGKey(0))
    ids_a, mask = _ids(B=6, seed=1)
    ids_b, _ = _ids(B=6, seed=1)
    batch = (ids_a, mask, ids_b, mask)
    zeros = jax.tree.map(jnp.zeros_like, pj)
    step_j = jax.jit(J.contrastive_train_step, static_argnames=("cfg",))
    _, grads_j, loss_j = step_j(pj, cj, zeros, batch, lr=1e-2)
    tb = tuple(torch.from_numpy(x).long() if x.dtype != bool else torch.from_numpy(x) for x in batch)
    _, grads_t, loss_t = T.contrastive_train_step(
        params_from_numpy(jax.tree.map(np.asarray, pj), device="cpu"), ct,
        params_from_numpy(jax.tree.map(np.asarray, zeros), device="cpu"), tb, lr=1e-2,
    )
    assert abs(float(loss_t) - float(loss_j)) <= TRAIN_GRAD_TOL * abs(float(loss_j))
    ref_leaves = jax.tree.leaves(jax.tree.map(np.asarray, grads_j))
    got_leaves = tree_leaves(grads_t)
    assert len(ref_leaves) == len(got_leaves)
    for r, g in zip(ref_leaves, got_leaves):
        bound = TRAIN_GRAD_TOL * max(float(np.abs(r).max()), 1e-6)
        assert float(np.abs(r - g.detach().float().numpy()).max()) <= bound


@pytest.mark.parametrize("requires_grad", [False, True])
@pytest.mark.parametrize("L,hd", [(600, 12), (40, 136), (40, 320)])
def test_outside_the_envelope_takes_the_counted_plain_route(L, hd, requires_grad):
    """hd 12 at 600 keys, hd 136 and 320 at 40: widths the aligned kernels do
    not take (rows of 24 bytes in bf16; above 128; 320 past the two column
    blocks the any-width forward holds at once), inside the envelope. On
    the CPU the call runs the plain version (its gradient the plain
    backward, through ``AttentionShortFlat``), counts no launch on any
    route, and equals the reference's ``_sdpa`` within 1e-5; the gradient
    equals autograd's through the plain version within 1e-5."""
    B, H = 2, 2
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal((B, L, H * hd)).astype(np.float32) for _ in range(3))
    mask = np.ones((B, L), dtype=bool)
    mask[1, L * 3 // 4:] = False
    want = np.asarray(J._sdpa(*(jnp.asarray(x.reshape(B, L, H, hd)) for x in (q, k, v)),
                              jnp.asarray(mask), hd ** -0.5)).reshape(B, L, H * hd)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(requires_grad) for x in (q, k, v))
    _reset_routes()
    before = A.LAUNCHES
    out = A.attention_short_flat(tq, tk, tv, torch.from_numpy(mask), H, hd ** -0.5)
    assert A.ROUTE_LAUNCHES == dict.fromkeys(A.ROUTE_LAUNCHES, 0)
    assert A.LAUNCHES == before
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=1e-5, atol=1e-5)
    if requires_grad:
        out.sum().backward()
        assert all(t.grad is not None and torch.isfinite(t.grad).all() for t in (tq, tk, tv))
        rq, rk, rv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
        A.attention_short_flat_plain(rq, rk, rv, torch.from_numpy(mask), H, hd ** -0.5).sum().backward()
        for got, ref in ((tq, rq), (tk, rk), (tv, rv)):
            np.testing.assert_allclose(got.grad.numpy(), ref.grad.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("requires_grad", [False, True])
@pytest.mark.parametrize("L,hd", [(16, 12), (600, 136), (16, 320)])
def test_outside_the_envelope_raises_off_the_cpu(L, hd, requires_grad):
    """The plain version is the CPU's alone: off the CPU the call goes to a
    kernel (hd 136, and hd 12 in bf16, whose rows of 24 bytes are not
    16-byte aligned, to ``attention_any.cu``'s route; hd 12 in f32, rows of
    48 bytes, to the aligned kernel), so on a device without kernels (``meta`` here)
    it raises before any launch and counts nothing; it never falls back to
    the plain version."""
    x = torch.zeros((2, L, 2 * hd), device="meta", requires_grad=requires_grad)
    m = torch.ones((2, L), dtype=torch.bool, device="meta")
    for dtype in (torch.bfloat16, torch.float32):
        geo = A.launch_geometry(2, L, 2, hd, dtype, 16)
        aligned = hd <= 128 and hd * torch.empty(0, dtype=dtype).element_size() % 16 == 0
        assert geo.route == (A.ROUTES[dtype] if aligned else A.ANY_ROUTES[dtype][0])
        assert geo.smem_bytes <= A._SMEM_LIMIT
    _reset_routes()
    with pytest.raises(ValueError, match="no kernel for device meta"):
        A.attention_short_flat(x, x, x, m, 2, hd ** -0.5)
    assert A.ROUTE_LAUNCHES == dict.fromkeys(A.ROUTE_LAUNCHES, 0)


@pytest.mark.parametrize(
    "hd,heads,max_len,L",
    [(8, 4, 32, 16), (48, 2, 32, 24), (96, 2, 32, 24), (64, 2, 1024, 1024)],
    ids=["hd8", "hd48", "hd96", "len1024"],
)
def test_encode_inside_the_widened_envelope_matches_the_reference(hd, heads, max_len, L):
    """Head widths 8, 48 and 96 (run in the instantiations 16, 48 and 96)
    and 1,024 keys: the reference runs ``_sdpa`` for all of them (outside
    its Pallas kernel's envelope); the port's encoder stays inside its
    kernels' envelope (as every width is), the CPU launches nothing, and
    the embeddings agree within 1e-5 (f32)."""
    shape = dict(vocab_size=512, d_model=heads * hd, n_heads=heads, n_layers=2,
                 d_ff=2 * heads * hd, max_len=max_len)
    cj, ct = J.EncoderConfig(dtype=jnp.float32, **shape), T.EncoderConfig(dtype=torch.float32, **shape)
    pj = J.init_params(cj, jax.random.PRNGKey(1))
    ids, mask = _ids(B=2, L=L, seed=3)
    want = np.asarray(J.encode(pj, cj, jnp.asarray(ids), jnp.asarray(mask)))
    _reset_routes()
    got = T.encode(params_from_numpy(jax.tree.map(np.asarray, pj), device="cpu"), ct,
                   torch.from_numpy(ids).long(), torch.from_numpy(mask))
    assert got.shape == want.shape == (2, heads * hd)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert A.ROUTE_LAUNCHES == dict.fromkeys(A.ROUTE_LAUNCHES, 0)


def _tc_smem_cu(L: int, width: int, rows: int, elem: int) -> int:
    """``tc_smem_bytes`` of ``csrc/attention_short.cu``, written out: the Q
    rows and two K/V tiles (one above 64 keys: two) in rows padded by 16
    bytes, and one f32 fill per key of the K rows."""
    kv_rows = 64 if L <= 64 else 128
    return (rows + 2 * kv_rows) * (width + 16 // elem) * elem + kv_rows * 4


def _bwd_smem_cu(L: int, width: int, elem: int) -> tuple[bool, int]:
    """The backward's route and bytes as ``attention_short_bwd.cu`` states
    them: ``fused_smem_bytes`` where the block fits at 128 rows and L <= 128,
    else the two-pass route's larger block (one column block):
    ``dq_pass_bytes`` (Q and dO, one or two ring slots of K and V in 64-row
    tiles and 64 f32 fills each) or ``dkv_pass_bytes`` (K and V, the slots
    of Q and dO, the 64 x 64 staging buffer and 64 fills); two slots
    unless one slot leaves more blocks an SM (233,472 B, 1,024 B reserved a
    block), up to three at widths up to 64 and two above."""
    pad = 16 // elem
    if L <= 128 and (4 * 128 * (width + pad) + 128 * (128 + pad)) * elem <= 232_448:
        rows = -(-L // 16) * 16
        return True, (4 * rows * (width + pad) + rows * (rows + pad)) * elem
    tile = 64 * (width + pad) * elem

    def at_slots(by_slots):
        per_sm = {s: 233_472 // (b + 1024) for s, b in by_slots.items()}
        return by_slots[2 if per_sm[2] >= min(per_sm[1], 3 if width <= 64 else 2) else 1]

    dq = at_slots({s: (2 + 2 * s) * tile + s * 64 * 4 for s in (1, 2)})
    dkv = at_slots({s: (2 + 2 * s) * tile + 64 * (64 + pad) * elem + 64 * 4 for s in (1, 2)})
    return False, max(dq, dkv)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_launch_geometry_fits_shared_memory_at_every_width_and_length(dtype):
    """Every head width of the envelope (multiples of 8 up to 128) and
    lengths up to 16,384: both kernels' blocks stay within the 232,448 B a
    Hopper block may use, with the bytes the .cu formulas give at the
    instantiated width; the fused backward takes every bf16 width and f32
    up to 64 (f32 at 80 would need 239,616 B)."""
    elem = torch.empty(0, dtype=dtype).element_size()
    lengths = [*range(1, 257), 300, 511, 512, 513, 600, 1000, 1024, 2048, 4096, 8191, 8192, 16_384]
    for hd in range(8, 129, 8):
        width = A.kernel_width(hd)
        assert width in A.KERNEL_WIDTHS and hd <= width < hd + 16
        for L in lengths:
            geo = A.launch_geometry(3, L, 2, hd, dtype)
            assert geo.smem_bytes == _tc_smem_cu(L, width, geo.rows, elem) <= A._SMEM_LIMIT
            assert geo.resident == (L <= 128) and geo.blocks == (3, 2, -(-L // geo.rows))
            bwd = A.backward_launch_geometry(3, L, 2, hd, dtype)
            assert (bwd.fused, bwd.smem_bytes) == _bwd_smem_cu(L, width, elem)
            assert bwd.smem_bytes <= A._SMEM_LIMIT
        fused_at_128 = A.backward_launch_geometry(3, 128, 2, hd, dtype).fused
        assert fused_at_128 == (dtype == torch.bfloat16 or width <= 64)
    assert A._fused_smem_bytes(128, 80, 4) == 239_616 > A._SMEM_LIMIT
