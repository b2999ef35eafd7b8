"""The attention's gradient: the port's plain backward
(``attention_short_flat_backward_plain``) and its ``AttentionShortFlat``
autograd function, against autograd through the plain forward and against
``jax.vjp`` of the JAX package's XLA attention (``_sdpa`` and
``_attention(..., allow_pallas=False)``, which its training step
differentiates). Inputs are made with numpy from a seed; both dtypes, head
widths 32 and 64, rows with padded key tails and a fully masked row.

Tolerances: f32 at rtol = atol = 2e-5 (the same function, summed in another
order). bf16 is compared in f32 arithmetic against an f32 reference on the
bf16-rounded inputs: the port rounds the probabilities to bf16 for the
product with v (as the forward does) and stores dq/dk/dv in bf16, so each
gradient is within 2^-6 of the largest reference gradient of its kind.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.ops import encoder as jenc
from pathway_tpu_torch.ops import attention_kernel as A

F32_TOL = 2e-5
BF16_REL = 2.0 ** -6


def _inputs(B, L, H, hd, seed, fully_masked=True):
    rng = np.random.default_rng(seed)
    D = H * hd
    qkv = rng.normal(size=(B, L, 3 * D)).astype(np.float32)
    lens = rng.integers(1, L + 1, size=B)
    mask = np.arange(L)[None, :] < lens[:, None]
    if fully_masked:
        mask[0] = False
    d_out = rng.normal(size=(B, L, D)).astype(np.float32)
    return qkv, mask, d_out


def _split(qkv_t, D):
    return qkv_t.split(D, dim=-1)


def _close(got, want, dtype, what):
    got = got.float().numpy()
    want = np.asarray(want, dtype=np.float32)
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL, err_msg=what)
    else:
        bound = BF16_REL * max(np.abs(want).max(), 1e-6)
        err = np.abs(got - want).max()
        assert err <= bound, f"{what}: max |err| {err} > {bound}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [32, 64])
def test_plain_backward_matches_autograd_through_plain_forward(dtype, hd):
    B, L, H = 3, 24, 2
    D = H * hd
    qkv, mask, d_out = _inputs(B, L, H, hd, seed=hd)
    qkv_t = torch.from_numpy(qkv).to(dtype).requires_grad_(True)
    mask_t = torch.from_numpy(mask)
    g = torch.from_numpy(d_out).to(dtype)
    q, k, v = _split(qkv_t, D)
    out = A.attention_short_flat_plain(q, k, v, mask_t, H, hd ** -0.5)
    out.backward(g)
    want = qkv_t.grad.float().split(D, dim=-1)
    with torch.no_grad():
        q, k, v = _split(qkv_t.detach(), D)
        got = A.attention_short_flat_backward_plain(q, k, v, mask_t, out.detach(), g, H, hd ** -0.5)
    for name, a, b in zip("qkv", got, want):
        assert a.dtype == dtype and a.shape == (B, L, D)
        _close(a, b.numpy(), dtype, f"d{name}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [32, 64])
def test_backward_matches_jax_vjp_of_the_reference_attention(dtype, hd):
    """``AttentionShortFlat`` on CPU tensors against ``jax.vjp`` of the
    reference's ``_sdpa`` on the [B, L, H, hd] views of the same q/k/v (in
    f32 on the dtype-rounded inputs)."""
    B, L, H = 4, 32, 3
    D = H * hd
    qkv, mask, d_out = _inputs(B, L, H, hd, seed=100 + hd)
    qkv_t = torch.from_numpy(qkv).to(dtype)
    g_t = torch.from_numpy(d_out).to(dtype)
    ref_qkv = qkv_t.float().numpy()
    ref_g = g_t.float().numpy()

    def f(q, k, v):
        r = lambda t: t.reshape(B, L, H, hd)  # noqa: E731
        return _sdpa_flat(r(q), r(k), r(v))

    def _sdpa_flat(q, k, v):
        return jenc._sdpa(q, k, v, jnp.asarray(mask), hd ** -0.5).reshape(B, L, D)

    q_j, k_j, v_j = np.split(ref_qkv, 3, axis=-1)
    out_j, vjp = jax.vjp(f, q_j, k_j, v_j)
    want = vjp(jnp.asarray(ref_g))

    leaf = qkv_t.clone().requires_grad_(True)
    q, k, v = _split(leaf, D)
    out = A.attention_short_flat(q, k, v, torch.from_numpy(mask), H, hd ** -0.5)
    assert out.grad_fn is not None and "AttentionShortFlat" in type(out.grad_fn).__name__
    _close(out.detach(), np.asarray(out_j), dtype, "forward")
    out.backward(g_t)
    got = leaf.grad.split(D, dim=-1)
    for name, a, b in zip("qkv", got, want):
        _close(a, np.asarray(b), dtype, f"d{name}")
    # the fully masked row: uniform probabilities, no gradient to q or k
    assert not mask[0].any()
    assert float(got[0][0].float().abs().max()) == 0.0
    assert float(got[1][0].float().abs().max()) == 0.0


def test_backward_through_the_reference_attention_block():
    """``_attention(x, wqkv, wo, mask, H, allow_pallas=False)`` (QKV
    projection, XLA attention, output projection) against the port's
    projection and ``attention_short_flat`` with autograd, in f32: dx,
    dwqkv and dwo."""
    B, L, H, hd = 3, 16, 2, 32
    D = H * hd
    rng = np.random.default_rng(7)
    x = rng.normal(size=(B, L, D)).astype(np.float32)
    wqkv = (rng.normal(size=(D, 3 * D)) * D ** -0.5).astype(np.float32)
    wo = (rng.normal(size=(D, D)) * D ** -0.5).astype(np.float32)
    mask = np.arange(L)[None, :] < np.array([16, 9, 1])[:, None]
    g = rng.normal(size=(B, L, D)).astype(np.float32)

    def f(x, wqkv, wo):
        return jenc._attention(x, wqkv, wo, jnp.asarray(mask), H, allow_pallas=False)

    _, vjp = jax.vjp(f, x, wqkv, wo)
    want = vjp(jnp.asarray(g))

    xt, wt, ot = (torch.from_numpy(a).requires_grad_(True) for a in (x, wqkv, wo))
    q, k, v = (xt @ wt).split(D, dim=-1)
    out = A.attention_short_flat(q, k, v, torch.from_numpy(mask), H, hd ** -0.5) @ ot
    out.backward(torch.from_numpy(g))
    for name, a, b in zip(("dx", "dwqkv", "dwo"), (xt.grad, wt.grad, ot.grad), want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-5, err_msg=name)


def test_inference_takes_the_plain_forward_without_autograd():
    """Without grad (or under ``inference_mode``) the call is the forward
    alone, as before: no autograd node, the same bits as the plain
    version."""
    B, L, H, hd = 2, 16, 2, 32
    qkv, mask, _ = _inputs(B, L, H, hd, seed=3)
    q, k, v = _split(torch.from_numpy(qkv), H * hd)
    m = torch.from_numpy(mask)
    with torch.inference_mode():
        a = A.attention_short_flat(q, k, v, m, H, hd ** -0.5)
    b = A.attention_short_flat_plain(q, k, v, m, H, hd ** -0.5)
    assert a.grad_fn is None and torch.equal(a, b)


def test_backward_counts_no_launch_on_the_cpu_and_checks_its_inputs():
    B, L, H, hd = 2, 8, 2, 32
    qkv, mask, d_out = _inputs(B, L, H, hd, seed=5)
    q, k, v = _split(torch.from_numpy(qkv), H * hd)
    m = torch.from_numpy(mask)
    before = (A.BACKWARD_LAUNCHES, dict(A.BACKWARD_ROUTE_LAUNCHES))
    out = A.attention_short_flat_plain(q, k, v, m, H, hd ** -0.5)
    A.attention_short_flat_backward(q, k, v, m, out, torch.from_numpy(d_out), H, hd ** -0.5)
    assert (A.BACKWARD_LAUNCHES, A.BACKWARD_ROUTE_LAUNCHES) == before
    with pytest.raises(ValueError, match="head width"):
        A.attention_short_flat_backward(q[..., :48], k[..., :48], v[..., :48], m, out[..., :48],
                                        out[..., :48], 3, 0.25)


def test_backward_kernel_is_built_with_the_forward():
    """The backward kernel is one of the sources ``_build`` compiles for
    ``sm_90a``, with the plain C entry point the wrapper binds."""
    from pathway_tpu_torch.ops import _build

    assert _build.SOURCES["attention_short_bwd"] == "attention_short_bwd.cu"
    src = (_build.CSRC / "attention_short_bwd.cu").read_text()
    assert 'extern "C" int pw_attention_short_flat_backward(' in src
    for hd in A.HEAD_DIMS:
        assert f"case {hd}:" in src
