"""The port's encoder against the JAX package's, on the same parameters.

Tolerances: f32 at atol 1e-5 (only the summation order differs). bf16 at
atol 1e-2: both sides round activations to bf16 after every matmul, LN and
GELU, but not at the same places inside fused ops (XLA's bf16 GELU rounds its
intermediates, PyTorch's rounds once), so unit-norm embeddings of width 128
may differ by several bf16 ulps of their ~0.1-sized elements.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.ops import encoder as E
from pathway_tpu_torch import convert
from pathway_tpu_torch import native as tnative
from pathway_tpu_torch.ops import encoder as TE

SMALL = dict(vocab_size=1024, d_model=128, n_heads=2, n_layers=2, d_ff=256, max_len=64)


def jax_params(cfg, seed=0):
    return jax.tree.map(np.asarray, E.init_params(cfg, jax.random.PRNGKey(seed)))


def _tokens(B=5, L=48, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, SMALL["vocab_size"], size=(B, L)).astype(np.int32)
    lens = [L, 30, 7, 1, 0]  # the last row is fully padded
    mask = np.arange(L)[None, :] < np.asarray(lens[:B])[:, None]
    ids = np.where(mask, ids, 0)
    return ids, mask


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5), ("bfloat16", 1e-2)])
def test_encode_matches_jax(dtype, atol):
    jcfg = E.EncoderConfig(**SMALL, dtype=getattr(jnp, dtype))
    tcfg = TE.EncoderConfig(**SMALL, dtype=getattr(torch, dtype))
    p = jax_params(jcfg)
    ids, mask = _tokens()
    ref = np.asarray(E.encode(p, jcfg, jnp.asarray(ids), jnp.asarray(mask)))
    tp = convert.params_from_numpy(p, "cpu")
    out = TE.encode(tp, tcfg, torch.from_numpy(ids).long(), torch.from_numpy(mask))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=atol)
    assert not out[-1].any()  # fully padded row pools to zero


def test_encode_ids_widens_int16_and_masks_pad_zero():
    tcfg = TE.EncoderConfig(**SMALL, dtype=torch.float32)
    tp = convert.params_from_numpy(jax_params(E.EncoderConfig(**SMALL)), "cpu")
    ids, mask = _tokens()
    a = TE.encode_ids(tp, tcfg, torch.from_numpy(ids.astype(np.int16)))
    b = TE.encode(tp, tcfg, torch.from_numpy(ids).long(), torch.from_numpy(mask))
    assert torch.equal(a, b)


@pytest.mark.parametrize("native", [True, False])
def test_hash_tokenizer_ids_bit_identical(native, monkeypatch):
    if not native:  # the pure-Python path, as without a C compiler
        monkeypatch.setattr(TE, "_native_pwtok", lambda: None)
    elif tnative.compiler() is not None:  # a compiler is here: the C path must run
        assert TE._native_pwtok() is not None, tnative.last_error.get("pwtok")
    texts = [
        "Hello, world! The quick brown fox.",
        "word1 word2 word3 " * 30,  # longer than max_len
        "Ünïcödé café — naïve straße",  # non-ASCII: the Python path
        "",
        "tabs\tand\nnewlines\x1c separators",
    ]
    for vocab, max_len in ((32768, 128), (1024, 16), (70000, 64)):
        ref_ids, ref_mask = E.HashTokenizer(vocab, max_len)(texts)
        ids, mask = TE.HashTokenizer(vocab, max_len)(texts)
        assert ids.dtype == ref_ids.dtype
        np.testing.assert_array_equal(ids, ref_ids)
        np.testing.assert_array_equal(mask, ref_mask)
        tok = TE.HashTokenizer(vocab, max_len)
        assert tok._tok(texts[2]) == E.HashTokenizer(vocab, max_len)._tok(texts[2])


def _native_copy(tmp_path, monkeypatch):
    """The native loader pointed at a scratch copy of pwtok.c."""
    src = tmp_path / "pwtok.c"
    src.write_text(open(os.path.join(os.path.dirname(tnative.__file__), "pwtok.c")).read())
    monkeypatch.setattr(tnative, "_DIR", str(tmp_path))
    monkeypatch.setattr(tnative, "_BUILD", str(tmp_path / "_build"))
    monkeypatch.delitem(tnative.last_error, "pwtok", raising=False)


def test_native_loader_keeps_the_reason_without_a_compiler(tmp_path, monkeypatch):
    _native_copy(tmp_path, monkeypatch)
    monkeypatch.setenv("CC", "no-such-compiler-here")
    assert tnative.compiler() is None
    assert tnative.try_load("pwtok") is None
    assert "no C compiler" in tnative.last_error["pwtok"]


def test_native_loader_keeps_the_compiler_message_of_a_failed_build(tmp_path, monkeypatch):
    if tnative.compiler() is None:
        pytest.skip("no C compiler on this machine")
    _native_copy(tmp_path, monkeypatch)
    (tmp_path / "pwtok.c").write_text("this is not C\n")
    assert tnative.try_load("pwtok") is None
    first = tnative.last_error["pwtok"]
    assert "exited" in first and "pwtok.c" in first
    # a later process start skips the doomed compile and keeps the message
    assert tnative.try_load("pwtok") is None
    assert "previously failed" in tnative.last_error["pwtok"] and "exited" in tnative.last_error["pwtok"]


def test_native_loader_builds_and_clears_the_error(tmp_path, monkeypatch):
    if tnative.compiler() is None:
        pytest.skip("no C compiler on this machine")
    _native_copy(tmp_path, monkeypatch)
    tnative.last_error["pwtok"] = "stale"
    mod = tnative.try_load("pwtok")
    assert mod is not None and "pwtok" not in tnative.last_error
    ids, lens = mod.hash_tokenize(np.array(["a b"], dtype=object), 1024, 8)
    assert lens.tolist() == [2]


def test_sentence_encoder_encode_texts_matches_jax_with_converted_params():
    jcfg = E.EncoderConfig(**SMALL)  # bf16 activations, f32 params
    tcfg = TE.EncoderConfig(**SMALL)
    jenc = E.JaxSentenceEncoder(jcfg, seed=0)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jenc.params), "cpu")
    tenc = TE.TorchSentenceEncoder(tcfg, params=tp, device="cpu")
    texts = [f"document {i} about word{i * 7} and more" for i in range(6)] + ["", "naïve"]
    ref = jenc.encode_texts(texts)
    out = tenc.encode_texts(texts)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-2)
    assert tenc.param_count() == jenc.param_count()
    assert tenc.param_bytes() == jenc.param_bytes()
    np.testing.assert_allclose(tenc.encode_texts_device(texts).numpy(), out)


def test_sentence_encoder_param_dtype_and_api():
    tcfg = TE.EncoderConfig(**SMALL)
    enc = TE.TorchSentenceEncoder(tcfg, seed=1, param_dtype=torch.bfloat16, device="cpu")
    assert enc.params["layers"][0]["wqkv"].dtype == torch.bfloat16
    assert enc.params["embed"].dtype == torch.bfloat16
    assert enc.params["ln_f"]["g"].dtype == torch.float32
    assert enc.dimension == 128
    jenc = E.JaxSentenceEncoder(E.EncoderConfig(**SMALL), seed=0, param_dtype=jnp.bfloat16)
    assert enc.param_bytes() == jenc.param_bytes()
    ids, mask = enc.tokenizer(["a b c", "d e"])
    emb = enc.encode_tokens(ids, mask)
    assert emb.shape == (2, 128) and np.allclose(np.linalg.norm(emb, axis=1), 1.0, atol=1e-5)
    np.testing.assert_array_equal(emb, enc.encode_ids_device(ids).numpy())
    # a seeded generator gives the same weights every time
    again = TE.TorchSentenceEncoder(tcfg, seed=1, param_dtype=torch.bfloat16, device="cpu")
    assert torch.equal(again.params["embed"], enc.params["embed"])
    assert enc.encode_texts([]).shape == (0, 128)


def test_init_params_tree_matches_jax_layout():
    jp = jax_params(E.EncoderConfig(**SMALL))
    tp = TE.init_params(TE.EncoderConfig(**SMALL), torch.Generator().manual_seed(0))
    jleaves, jdef = jax.tree.flatten(jp)
    tleaves, tdef = jax.tree.flatten(convert.tree_map(lambda t: t.numpy(), tp))
    assert jdef == tdef
    assert [a.shape for a in jleaves] == [a.shape for a in tleaves]
    # same init scales (std of each matrix within 10% of the reference's)
    for a, b in zip(jleaves, tleaves):
        if a.ndim == 2:
            assert abs(a.std() / b.std() - 1) < 0.1


def test_params_from_numpy_takes_bf16_and_casts_matrices_only():
    p = jax.tree.map(np.asarray, {"w": jnp.arange(6, dtype=jnp.bfloat16).reshape(2, 3), "g": jnp.ones(3)})
    assert p["w"].dtype.name == "bfloat16"
    t = convert.params_from_numpy(p, "cpu")
    assert t["w"].dtype == torch.bfloat16
    assert t["w"].float().tolist() == [[0, 1, 2], [3, 4, 5]]
    t = convert.params_from_numpy(jax.tree.map(lambda a: a.astype(np.float32), p), "cpu", dtype=torch.bfloat16)
    assert t["w"].dtype == torch.bfloat16 and t["g"].dtype == torch.float32


def test_flops_and_bert_arch():
    for L in (16, 128):
        assert TE.encoder_flops_per_doc(TE.EncoderConfig(), L) == E.encoder_flops_per_doc(E.EncoderConfig(), L)
    # arch="bert" builds (the pre-LN tree, as in the JAX package, when no
    # params are given); a bert tree comes from from_pretrained or params=
    # (tests/test_torch_encoder_pretrained.py)
    enc = TE.TorchSentenceEncoder(TE.EncoderConfig(**SMALL, arch="bert"), device="cpu")
    jenc = E.JaxSentenceEncoder(E.EncoderConfig(**SMALL, arch="bert"))
    assert enc.cfg.arch == "bert" and enc.param_count() == jenc.param_count()


def test_pool_keeps_the_reference_pooling_in_a_fixed_order():
    """Masked mean in f32, divided by max(count, 1), L2-normalised with a
    1e-12 floor (``pathway_tpu/ops/encoder.py``'s pooling), within f32
    rounding of a float64 computation; a fully masked row pools to zero.
    The sums are ``fixed_order_sum``: the same bits for a row in any batch."""
    from pathway_tpu_torch.ops._fixed_order import fixed_order_sum

    rng = np.random.default_rng(5)
    x = rng.standard_normal((6, 40, 96)).astype(np.float32)
    mask = np.arange(40)[None, :] < np.array([40, 33, 7, 1, 0, 20])[:, None]
    m = mask[:, :, None].astype(np.float64)
    pooled = (x * m).sum(axis=1) / np.maximum(m.sum(axis=1), 1.0)
    want = pooled / np.maximum(np.linalg.norm(pooled, axis=-1, keepdims=True), 1e-12)
    out = TE.pool(torch.from_numpy(x).to(torch.bfloat16).float(), torch.from_numpy(mask))
    ref_bf = TE.pool(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(ref_bf.numpy(), want, rtol=0, atol=1e-6)
    assert out.dtype == torch.float32 and not out[4].any()
    t = torch.from_numpy(x)
    np.testing.assert_allclose(fixed_order_sum(t, dim=1).numpy(), x.sum(axis=1), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(fixed_order_sum(t, dim=-1).numpy(), x.sum(axis=-1), rtol=1e-5, atol=1e-5)
    assert torch.equal(fixed_order_sum(t[2:3], dim=1), fixed_order_sum(t, dim=1)[2:3])
