"""Head widths and lengths of the reference's attention, on the port.

The reference runs its Pallas kernel only inside its envelope and XLA's
``_sdpa`` everywhere else, so its encoder takes any head width and length.
The port's kernels are instantiated for head widths 16, 32, 64 and 128 up to
512 keys; outside that envelope ``attention_short_flat`` runs its plain
version on a CPU tensor and counts the call under the route
``plain_outside_envelope``, and raises on any other device (the card has no
plain fallback).

Cases: the reference's ``SMALL`` encoder (4 heads of 16 at d 64, the
multichip dry run's) encoded on both packages within 1e-5 (f32), one
contrastive train step within the chip check's f32 gradient tolerance
(1e-3 of each leaf's largest value), and a 48-wide head at 600 keys on the
plain route, equal to the reference's ``_sdpa`` within 1e-5, and the same
call on a non-CPU tensor refused.
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
    assert 16 in A.HEAD_DIMS and A.in_envelope(16, 16) and A.in_envelope(A.MAX_LEN, 16)
    assert not A.in_envelope(16, 48) and not A.in_envelope(A.MAX_LEN + 1, 64)
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
    got = T.encode(params_from_numpy(jax.tree.map(np.asarray, pj), device="cpu"), ct,
                   torch.from_numpy(ids).long(), torch.from_numpy(mask))
    assert got.shape == (2, 64) and want.shape == (2, 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # hd 16 is in the kernels' envelope: no call took the plain route
    assert A.ROUTE_LAUNCHES["plain_outside_envelope"] == 0


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
def test_outside_the_envelope_takes_the_counted_plain_route(requires_grad):
    """hd 48 at 600 keys: neither in HEAD_DIMS nor within MAX_LEN. The call
    runs the plain version (its gradient by autograd), counts one
    ``plain_outside_envelope`` call and no kernel launch, and equals the
    reference's ``_sdpa`` within 1e-5."""
    B, L, H, hd = 2, 600, 2, 48
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal((B, L, H * hd)).astype(np.float32) for _ in range(3))
    mask = np.ones((B, L), dtype=bool)
    mask[1, 450:] = False
    want = np.asarray(J._sdpa(*(jnp.asarray(x.reshape(B, L, H, hd)) for x in (q, k, v)),
                              jnp.asarray(mask), hd ** -0.5)).reshape(B, L, H * hd)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(requires_grad) for x in (q, k, v))
    _reset_routes()
    before = A.LAUNCHES
    out = A.attention_short_flat(tq, tk, tv, torch.from_numpy(mask), H, hd ** -0.5)
    assert A.ROUTE_LAUNCHES == {"tensor_core": 0, "tensor_core_3xtf32": 0, "plain_outside_envelope": 1}
    assert A.LAUNCHES == before
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=1e-5, atol=1e-5)
    if requires_grad:
        out.sum().backward()
        assert all(t.grad is not None and torch.isfinite(t.grad).all() for t in (tq, tk, tv))


@pytest.mark.parametrize("requires_grad", [False, True])
@pytest.mark.parametrize("L,hd", [(16, 48), (600, 64)])
def test_outside_the_envelope_raises_off_the_cpu(L, hd, requires_grad):
    """The plain route is the CPU's alone: off the CPU (a ``meta`` tensor
    here, a CUDA tensor on the card) a shape outside the envelope raises
    before any launch and counts nothing."""
    x = torch.zeros((2, L, 2 * hd), device="meta", requires_grad=requires_grad)
    m = torch.ones((2, L), dtype=torch.bool, device="meta")
    _reset_routes()
    with pytest.raises(ValueError, match="outside the kernels' envelope"):
        A.attention_short_flat(x, x, x, m, 2, hd ** -0.5)
    assert A.ROUTE_LAUNCHES == dict.fromkeys(A.ROUTE_LAUNCHES, 0)
