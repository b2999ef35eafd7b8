"""Every head width on the port, against the reference.

The reference's encoder runs XLA's ``_sdpa`` at every head width its Pallas
kernel does not take, so it encodes, reranks and trains at any ``D /
n_heads``. The port's kernels take every width too: a 16-byte aligned head
of at most 128 columns in ``csrc/attention_short.cu``, every other head
(unaligned rows, or wider than 128) in ``csrc/attention_any.cu`` at the
widest copy its pointers and strides allow, in column blocks of at most
128. On the CPU both run the plain version, which these cases hold to the
reference; on the card ``chip_smoke.py`` holds the kernels to the plain
version.

Cases (small: 2 layers, narrow widths; weights carried across with
``params_from_numpy``):

- encoders at hd 12 (4 heads, d 48), 20, 36 (3 heads), 136 and 200: the
  port's embeddings within 1e-5 of the reference's (f32), no launch on the
  CPU;
- the reranker's scores at hd 12 and 136 within 1e-5;
- one contrastive train step at hd 12 and 136: the loss and every gradient
  leaf within 1e-3 of the leaf's largest reference value (chip_smoke.py's
  f32 train tolerance; the reference's step is jitted XLA, the port's the
  plain attention and its hand-written backward's plain version);
- ``launch_geometry`` and ``backward_launch_geometry`` at every hd in
  1..256, L in {1, 16, 128, 129, 600}, both dtypes and every copy width:
  a route and a copy width, never a raise, at most 227 KB of shared
  memory, the bytes the .cu formulas give;
- ``copy_width`` on the column views of ``[B, L, 3D]`` projections at
  unaligned ``D``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.ops import encoder as J
from pathway_tpu.ops import reranker as JR
from pathway_tpu_torch.convert import params_from_numpy, tree_leaves
from pathway_tpu_torch.ops import attention_kernel as A
from pathway_tpu_torch.ops import encoder as T
from pathway_tpu_torch.ops import reranker as TR

#: embeddings and reranker scores (f32, both sides summing in f32 on the
#: CPU: only the order of the sums differs)
EMBED_TOL = 1e-5
#: a train step's loss and every gradient leaf, against the leaf's largest
#: reference value (chip_smoke.py's TRAIN_GRAD_TOL for f32)
TRAIN_GRAD_TOL = 1e-3

#: hd -> (heads, d_ff)
WIDTHS = {12: (4, 96), 20: (2, 80), 36: (3, 96), 136: (2, 128), 200: (1, 128)}


def _shape(hd: int, max_len: int = 32) -> dict:
    heads, d_ff = WIDTHS[hd]
    return dict(vocab_size=512, d_model=heads * hd, n_heads=heads, n_layers=2, d_ff=d_ff, max_len=max_len)


def _ids(B=2, L=16, seed=0, vocab=512):
    rng = np.random.default_rng(seed)
    lens = rng.integers(4, L + 1, size=B)
    mask = np.arange(L)[None] < lens[:, None]
    ids = np.where(mask, rng.integers(3, vocab, size=(B, L)), 0).astype(np.int32)
    return ids, mask


def _port(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


def _no_launch():
    return A.LAUNCHES, A.BACKWARD_LAUNCHES, dict(A.ROUTE_LAUNCHES), dict(A.BACKWARD_ROUTE_LAUNCHES)


@pytest.mark.parametrize("hd", sorted(WIDTHS), ids=lambda hd: f"hd{hd}")
def test_encode_at_any_head_width_matches_the_reference(hd):
    shape = _shape(hd)
    cj, ct = J.EncoderConfig(dtype=jnp.float32, **shape), T.EncoderConfig(dtype=torch.float32, **shape)
    pj = J.init_params(cj, jax.random.PRNGKey(hd))
    ids, mask = _ids(B=3, L=24, seed=hd)
    want = np.asarray(jax.jit(J.encode, static_argnames=("cfg",))(pj, cj, jnp.asarray(ids), jnp.asarray(mask)))
    before = _no_launch()
    got = T.encode(_port(pj), ct, torch.from_numpy(ids).long(), torch.from_numpy(mask))
    assert _no_launch() == before
    assert got.shape == want.shape == (3, shape["d_model"])
    np.testing.assert_allclose(got.numpy(), want, rtol=EMBED_TOL, atol=EMBED_TOL)


@pytest.mark.parametrize("hd", [12, 136], ids=lambda hd: f"hd{hd}")
def test_reranker_scores_at_any_head_width_match_the_reference(hd):
    shape = _shape(hd, max_len=48)
    cj, ct = J.EncoderConfig(dtype=jnp.float32, **shape), T.EncoderConfig(dtype=torch.float32, **shape)
    pj = JR.init_reranker_params(cj, jax.random.PRNGKey(3))
    ids, mask = _ids(B=5, L=40, seed=11)
    want = np.asarray(jax.jit(JR.score, static_argnames=("cfg",))(pj, cj, jnp.asarray(ids), jnp.asarray(mask)))
    got = TR.score(_port(pj), ct, torch.from_numpy(ids).long(), torch.from_numpy(mask))
    assert got.shape == want.shape == (5,)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=EMBED_TOL, atol=EMBED_TOL)


@pytest.mark.parametrize("hd", [12, 136], ids=lambda hd: f"hd{hd}")
def test_train_step_at_any_head_width_matches_the_reference(hd):
    shape = _shape(hd)
    cj, ct = J.EncoderConfig(dtype=jnp.float32, **shape), T.EncoderConfig(dtype=torch.float32, **shape)
    pj = J.init_params(cj, jax.random.PRNGKey(1))
    ids_a, mask = _ids(B=6, seed=1)
    ids_b, _ = _ids(B=6, seed=1)
    batch = (ids_a, mask, ids_b, mask)
    zeros = jax.tree.map(jnp.zeros_like, pj)
    step_j = jax.jit(J.contrastive_train_step, static_argnames=("cfg",))
    _, grads_j, loss_j = step_j(pj, cj, zeros, batch, lr=1e-2)
    tb = tuple(torch.from_numpy(x).long() if x.dtype != bool else torch.from_numpy(x) for x in batch)
    before = _no_launch()
    _, grads_t, loss_t = T.contrastive_train_step(_port(pj), ct, _port(zeros), tb, lr=1e-2)
    assert _no_launch() == before
    assert abs(float(loss_t) - float(loss_j)) <= TRAIN_GRAD_TOL * abs(float(loss_j))
    ref_leaves = jax.tree.leaves(jax.tree.map(np.asarray, grads_j))
    got_leaves = tree_leaves(grads_t)
    assert len(ref_leaves) == len(got_leaves)
    for r, g in zip(ref_leaves, got_leaves):
        bound = TRAIN_GRAD_TOL * max(float(np.abs(r).max()), 1e-6)
        assert float(np.abs(r - g.detach().float().numpy()).max()) <= bound


def _fwd_smem_cu(geo, L: int, elem: int) -> int:
    """The forward's bytes as the .cu files state them: ``tc_smem_bytes``
    (attention_short.cu), ``any_smem_bytes`` (attention_any.cu up to two
    column blocks: Q and the ring's slots at the full width) or
    ``any_cols_smem_bytes`` (above: one column block of Q, K and V)."""
    pad = 16 // elem
    if geo.route in A.ROUTES.values():
        kv_rows = 64 if L <= 64 else 128
        return (geo.rows + 2 * kv_rows) * (geo.width + pad) * elem + kv_rows * 4
    if geo.col_blocks <= 2:
        full = geo.width * geo.col_blocks
        return (geo.rows + geo.ring_slots * 64) * (full + pad) * elem + geo.ring_slots * 64 * 4
    return (geo.rows + 2 * 64) * (geo.width + pad) * elem + 64 * 4


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_every_head_width_has_a_route_and_a_copy_width(dtype):
    """hd 1..256 at L 1, 16, 128, 129 and 600, at every copy width the
    pointers and strides may allow (16, 8, 4, 2 bytes; at least one
    element): both geometries name a kernel route and the copy width they
    run at, which divides ``hd * elem``, never raise, and fit the 227 KB a
    Hopper block may use. 16-byte copies of a head of at most 128 columns
    keep the aligned kernels; anything else runs in ``attention_any.cu``,
    the backward on its fused route where L <= 128 and the block fits, else
    on the two-pass route (in column blocks of 128 above 128 columns), at
    the copy width, in 64-row tiles."""
    elem = torch.empty(0, dtype=dtype).element_size()
    fwd_routes = {A.ROUTES[dtype], A.ANY_ROUTES[dtype][0]}
    bwd_routes = {*A.BACKWARD_ROUTES[dtype], *A.ANY_ROUTES[dtype][1:]}
    for hd in range(1, 257):
        for L in (1, 16, 128, 129, 600):
            for allowed in (16, 8, 4, 2):
                if allowed < elem:
                    continue
                vb = min(allowed, (hd * elem) & -(hd * elem))
                geo = A.launch_geometry(3, L, 2, hd, dtype, allowed)
                assert geo.route in fwd_routes and geo.copy_bytes == vb
                assert (hd * elem) % geo.copy_bytes == 0
                assert geo.smem_bytes == _fwd_smem_cu(geo, L, elem) <= A._SMEM_LIMIT
                aligned = vb == 16 and hd <= 128
                assert (geo.route == A.ROUTES[dtype]) == aligned
                assert geo.width * geo.col_blocks >= hd and geo.width <= 128
                assert geo.col_blocks == (1 if aligned else -(-hd // 128))
                bwd = A.backward_launch_geometry(3, L, 2, hd, dtype, allowed)
                assert bwd.route in bwd_routes and bwd.smem_bytes <= A._SMEM_LIMIT
                if bwd.fused:
                    assert L <= 128 and hd <= 128 and bwd.copy_bytes == vb
                    assert bwd.route == (A.BACKWARD_ROUTES[dtype][0] if vb == 16 else A.ANY_ROUTES[dtype][1])
                    assert bwd.smem_bytes == A._fused_smem_bytes(bwd.rows, bwd.width, elem)
                else:
                    assert bwd.copy_bytes == vb
                    assert bwd.route == (A.BACKWARD_ROUTES[dtype][1] if aligned else A.ANY_ROUTES[dtype][2])
                    assert bwd.blocks[2] == -(-L // 64) * bwd.col_blocks
                # a bf16 head at L <= 128 always has the fused route; f32 up
                # to a block of 64 columns
                if L <= 128 and hd <= 128:
                    width = A.kernel_width(hd) if vb == 16 else A.any_width(hd)
                    assert bwd.fused == (dtype == torch.bfloat16 or width <= 64)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("heads,hd", [(3, 1), (3, 4), (3, 12), (2, 20), (3, 36), (2, 100), (3, 136), (1, 192), (3, 256), (6, 64)])
def test_copy_width_of_an_unaligned_projection(dtype, heads, hd):
    """q, k and v as the column views of one ``[B, L, 3D]`` projection (the
    encoder's layout) with ``D = heads * hd``: the copy width is the widest
    of 16, 8, 4, 2 bytes that divides ``D``'s row of three, the head offset
    and the view offsets, the route is the aligned kernel's only at 16
    bytes and hd <= 128, and a view at one element's offset lowers it."""
    elem = torch.empty(0, dtype=dtype).element_size()
    D = heads * hd
    q, k, v = torch.zeros(2, 16, 3 * D, dtype=dtype).split(D, dim=-1)
    x = hd * elem | 3 * D * elem | D * elem | 16
    want = x & -x
    assert A.copy_width(hd, elem, q, k, v) == want
    geo = A.launch_geometry(2, 16, heads, hd, dtype, want)
    assert geo.copy_bytes == want
    assert (geo.route == A.ROUTES[dtype]) == (want == 16 and hd <= 128)
    # the same views one element further on, in rows one element longer
    q1, k1, v1 = torch.zeros(2, 16, 3 * D + 1, dtype=dtype)[..., 1:].split(D, dim=-1)
    assert A.copy_width(hd, elem, q1, k1, v1) == elem
    # the main path's 6 heads of 64 keep 16-byte copies
    if (heads, hd) == (6, 64):
        assert want == 16 and geo.route == A.ROUTES[dtype]


def test_any_width_mirrors_the_header():
    """``any_width`` and ``col_blocks`` as ``attention_tc.cuh`` computes
    them, for hd 1..1,024: the blocks cover the head, none wider than 128,
    the last not empty. The forward (``attention_any.cu``) holds a head of
    up to two blocks at its full width ``n * w`` (``ANY_FORWARD_WIDTHS``:
    16, 32, 64, 128, or 256 for every head of 129-256 columns) and takes a
    wider head in blocks of 128."""
    for hd in range(1, 1025):
        n, w = A.col_blocks(hd), A.any_width(hd)
        per = -(-hd // n)
        assert n == -(-hd // 128) and w in A.ANY_WIDTHS and per <= w
        assert w == (16 if per <= 16 else 32 if per <= 32 else 64 if per <= 64 else 128)
        assert -(-hd // w) == n and (n - 1) * w < hd <= n * w
        if hd <= 256:
            assert n * w in A.ANY_FORWARD_WIDTHS and (n * w == 256) == (hd > 128)
        else:
            assert n > A._ANY_FULL_COLS and w == 128
