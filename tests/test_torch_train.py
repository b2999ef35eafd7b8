"""The training path: ``contrastive_loss`` and ``contrastive_train_step``
against the JAX package's on the CPU, with the reference's weights and a
momentum tree carried across by ``convert.params_from_numpy``; the
TP/DP layout (``param_shardings``, ``shard_params``) on 8 logical CPU
shards against the unsharded step; and ``TorchSentenceEncoder(mesh=...)``.

The reference's step differentiates its XLA attention here (its Pallas
kernel runs only on a TPU); the port's goes through ``AttentionShortFlat``,
the plain backward on CPU tensors. These use d 64 with 2 heads of 32, and
d 128 with 2 heads of 64; the reference test's ``SMALL`` config (4 heads of
16) is ``test_torch_head_width.py``'s.

Tolerances, per leaf against the largest reference value of the leaf: f32
at 2e-5 (the loss at rtol 1e-5); bf16 at 4e-2 (the loss at rtol 1e-2): the
two frameworks round bf16 activations at other places, and one step's
gradients carry those roundings. The sharded step sums the row-parallel
partial products in another order than the whole product: 2e-5 in f32.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.ops import encoder as J
from pathway_tpu_torch.convert import params_from_numpy
from pathway_tpu_torch.ops import encoder as T
from pathway_tpu_torch.parallel.mesh import device_mesh

F32_TOL = 2e-5
BF16_TOL = 4e-2
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _cfgs(dtype: str, d: int = 64, heads: int = 2, arch: str = "preln"):
    dj, dt = DTYPES[dtype]
    kw = dict(vocab_size=256, d_model=d, n_heads=heads, n_layers=2, d_ff=2 * d, max_len=32, arch=arch)
    return J.EncoderConfig(dtype=dj, **kw), T.EncoderConfig(dtype=dt, **kw)


def _batch(B=6, L=16, seed=0, same=False):
    rng = np.random.default_rng(seed)
    lens = rng.integers(2, L + 1, size=B)
    mask = np.arange(L)[None] < lens[:, None]
    ids_a = np.where(mask, rng.integers(3, 256, size=(B, L)), 0).astype(np.int32)
    ids_b = ids_a if same else np.where(mask, rng.integers(3, 256, size=(B, L)), 0).astype(np.int32)
    return ids_a, mask, ids_b, mask


def _torch_batch(batch):
    a, ma, b, mb = batch
    return (torch.from_numpy(a).long(), torch.from_numpy(ma), torch.from_numpy(b).long(), torch.from_numpy(mb))


def _walk(a, b, fn, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _walk(a[k], b[k], fn, f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _walk(x, y, fn, f"{path}/{i}")
    else:
        fn(path, a, b)


def _close_tree(ref, got, tol):
    def check(path, r, g):
        r = np.asarray(r, dtype=np.float32)
        g = g.float().numpy()
        assert r.shape == g.shape, path
        bound = tol * max(float(np.abs(r).max()), 1e-6)
        err = float(np.abs(r - g).max())
        assert err <= bound, f"{path}: max |err| {err} > {bound}"

    _walk(ref, got, check)


def _momentum(pj, seed=3):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: (rng.normal(size=p.shape) * 0.01).astype(np.float32), pj)


@pytest.mark.parametrize("dtype,d,heads", [("float32", 64, 2), ("bfloat16", 64, 2), ("float32", 128, 2)])
def test_train_step_matches_the_reference(dtype, d, heads):
    """Loss, the gradient tree (the new momenta from a zero momentum), and
    the parameters and momenta after one step from a non-zero momentum,
    against the reference's ``contrastive_train_step`` with converted
    weights."""
    cj, ct = _cfgs(dtype, d, heads)
    pj = J.init_params(cj, jax.random.PRNGKey(0))
    pn = jax.tree.map(np.asarray, pj)
    batch = _batch()
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    loss_tol = 1e-5 if dtype == "float32" else 1e-2

    step_j = jax.jit(J.contrastive_train_step, static_argnames=("cfg",))
    # loss and gradients: the momentum after one step from zero is the gradient
    zeros = jax.tree.map(jnp.zeros_like, pj)
    _, grads_j, loss_j = step_j(pj, cj, zeros, batch, lr=1e-2)
    _, grads_t, loss_t = T.contrastive_train_step(
        params_from_numpy(pn, device="cpu"), ct,
        params_from_numpy(jax.tree.map(np.asarray, zeros), device="cpu"), _torch_batch(batch), lr=1e-2,
    )
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=loss_tol)
    _close_tree(jax.tree.map(np.asarray, grads_j), grads_t, tol)

    # one step from a non-zero momentum: parameters and momenta
    mom = _momentum(pj)
    new_pj, new_mj, _ = step_j(pj, cj, jax.tree.map(jnp.asarray, mom), batch, lr=1e-2)
    new_pt, new_mt, _ = T.contrastive_train_step(
        params_from_numpy(pn, device="cpu"), ct, params_from_numpy(mom, device="cpu"),
        _torch_batch(batch), lr=1e-2,
    )
    _close_tree(jax.tree.map(np.asarray, new_mj), new_mt, tol)
    _close_tree(jax.tree.map(np.asarray, new_pj), new_pt, tol)


def test_train_step_leaves_its_inputs_and_keeps_the_tree():
    _, ct = _cfgs("float32")
    params = T.init_params(ct, torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in params["layers"][0].items() if isinstance(v, torch.Tensor)}
    opt = {k: v for k, v in T.tree_map(torch.zeros_like, params).items()}
    new_p, new_m, loss = T.contrastive_train_step(params, ct, opt, _torch_batch(_batch()), lr=1e-2)
    for k, v in before.items():
        assert torch.equal(params["layers"][0][k], v)
        assert not new_p["layers"][0][k].requires_grad
    assert list(new_p) == list(params) and list(new_p["layers"][0]) == list(params["layers"][0])
    assert loss.ndim == 0 and torch.isfinite(loss)


def test_loss_falls_over_five_steps():
    """As the reference's ``test_ops.py`` step test: same-text pairs, lr
    1e-2, five steps, finite losses that end below the first."""
    _, ct = _cfgs("float32")
    params = T.init_params(ct, torch.Generator().manual_seed(0))
    opt = T.tree_map(torch.zeros_like, params)
    batch = _torch_batch(_batch(B=8, same=True, seed=1))
    losses = []
    for _ in range(5):
        params, opt, loss = T.contrastive_train_step(params, ct, opt, batch, lr=1e-2)
        losses.append(float(loss))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0], losses


@pytest.mark.parametrize("arch", ["preln", "bert"])
def test_param_shardings_match_the_reference_partition_specs(arch):
    from jax.sharding import Mesh

    cj, ct = _cfgs("float32", arch=arch)
    mesh_j = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    mesh_t = device_mesh({"data": 4, "model": 2}, devices=["cpu"] * 8)
    ref = J.param_shardings(cj, mesh_j)
    got = T.param_shardings(ct, mesh_t)

    def check(path, r, g):
        assert tuple(r.spec) == g.spec, (path, r.spec, g.spec)
        assert g.mesh is mesh_t

    _walk(ref, got, check)


def test_sharded_step_equals_the_unsharded_step():
    """One step on a 4 x 2 ("data", "model") grid of 8 logical CPU shards:
    the batch split on data, the matrices on model (Megatron), the InfoNCE
    negatives over the whole batch; loss, parameters and momenta equal the
    unsharded step's, and a second step continues from the pieces."""
    _, ct = _cfgs("float32")
    mesh = device_mesh({"data": 4, "model": 2}, devices=["cpu"] * 8)
    params = T.init_params(ct, torch.Generator().manual_seed(0))
    mom = T.tree_map(lambda p: torch.full_like(p, 0.01), params)
    batch = _torch_batch(_batch(B=8))

    want_p, want_m, want_loss = T.contrastive_train_step(params, ct, mom, batch, lr=1e-2)
    shardings = T.param_shardings(ct, mesh)
    sp, sm = T.shard_params(params, shardings), T.shard_params(mom, shardings)
    assert len(sp["layers"][0]["wqkv"].pieces) == 2 and sp["layers"][0]["wqkv"].pieces[0].shape == (64, 96)
    assert sp["embed"].pieces[1].shape == (128, 64) and len(sp["pos"].pieces) == 1
    got_p, got_m, got_loss = T.contrastive_train_step(sp, ct, sm, batch, lr=1e-2)
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-6)
    for want, got in ((want_p, got_p), (want_m, got_m)):
        _close_tree(T.tree_map(lambda t: t.numpy(), want), T.unshard_params(got), F32_TOL)
    # a second step from the sharded state
    want2 = T.contrastive_train_step(want_p, ct, want_m, batch, lr=1e-2)[2]
    got2 = T.contrastive_train_step(got_p, ct, got_m, batch, lr=1e-2)[2]
    np.testing.assert_allclose(float(got2), float(want2), rtol=1e-5)


def test_encoder_under_a_mesh_embeds_as_the_single_encoder():
    """``TorchSentenceEncoder(mesh=...)`` lays its weights out by
    ``param_shardings`` (pieces are views of its parameters on one device)
    and embeds as the encoder without a mesh; the bert tree too."""
    _, ct = _cfgs("float32")
    mesh = device_mesh({"data": 2, "model": 2}, devices=["cpu"] * 4)
    texts = [f"doc {i} about topic {i % 3}" for i in range(6)]
    one = T.TorchSentenceEncoder(ct, seed=1, device="cpu")
    tp = T.TorchSentenceEncoder(ct, seed=1, device="cpu", mesh=mesh)
    wqkv = tp.forward_params["layers"][0]["wqkv"].pieces[1]
    assert wqkv.untyped_storage().data_ptr() == tp.params["layers"][0]["wqkv"].untyped_storage().data_ptr()
    np.testing.assert_allclose(tp.encode_texts(texts), one.encode_texts(texts), rtol=0, atol=2e-6)

    _, cb = _cfgs("float32", arch="bert")
    rng = np.random.default_rng(4)
    d = cb.d_model
    layer = {
        "wqkv": rng.normal(size=(d, 3 * d)) * d ** -0.5, "bqkv": rng.normal(size=3 * d) * 0.1,
        "wo": rng.normal(size=(d, d)) * d ** -0.5, "bo": rng.normal(size=d) * 0.1,
        "ln1": {"g": np.ones(d), "b": np.zeros(d)}, "w1": rng.normal(size=(d, cb.d_ff)) * d ** -0.5,
        "b1": rng.normal(size=cb.d_ff) * 0.1, "w2": rng.normal(size=(cb.d_ff, d)) * cb.d_ff ** -0.5,
        "b2": rng.normal(size=d) * 0.1, "ln2": {"g": np.ones(d), "b": np.zeros(d)},
    }
    tree = {
        "embed": rng.normal(size=(cb.vocab_size, d)), "pos": rng.normal(size=(cb.max_len, d)),
        "tok_type": rng.normal(size=(2, d)), "emb_ln": {"g": np.ones(d), "b": np.zeros(d)},
        "layers": [layer, layer], "ln_f": {"g": np.ones(d), "b": np.zeros(d)},
    }
    tree = T.tree_map(lambda a: np.asarray(a, dtype=np.float32), tree)
    one = T.TorchSentenceEncoder(cb, params=params_from_numpy(tree, device="cpu"), device="cpu")
    tp = T.TorchSentenceEncoder(cb, params=params_from_numpy(tree, device="cpu"), device="cpu", mesh=mesh)
    np.testing.assert_allclose(tp.encode_texts(texts), one.encode_texts(texts), rtol=0, atol=2e-6)
