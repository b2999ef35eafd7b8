"""The port's cross-encoder against the JAX package's, on the same weights.

Tolerance: f32 at atol 1e-5; bf16 activations at atol 1e-2, the encoder's
bf16 tolerance carried through a head whose weights have norm ~1 (the logit
moves by at most |w|·|Δpooled|)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.ops import encoder as E
from pathway_tpu.ops import reranker as R
from pathway_tpu_torch import convert
from pathway_tpu_torch.ops import encoder as TE
from pathway_tpu_torch.ops import reranker as TR

SMALL = dict(vocab_size=1024, d_model=128, n_heads=2, n_layers=2, d_ff=256, max_len=64)

PAIRS = [
    ("what is word42 about", "word42 is about " + "filler " * 10),
    ("short", "a doc"),
    ("a much longer query " * 8, "and a much longer document " * 20),  # budget split
    ("naïve café", "ünïcode text here"),
]


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5), ("bfloat16", 1e-2)])
def test_score_pairs_matches_jax(dtype, atol):
    jce = R.JaxCrossEncoder(E.EncoderConfig(**SMALL, dtype=getattr(jnp, dtype)), seed=3)
    params = convert.params_from_numpy(jax.tree.map(np.asarray, jce.params), "cpu")
    tce = TR.TorchCrossEncoder(TE.EncoderConfig(**SMALL, dtype=getattr(torch, dtype)), params=params, device="cpu")
    ref = jce.score_pairs(PAIRS)
    out = tce.score_pairs(PAIRS)
    assert out.dtype == np.float32 and out.shape == (len(PAIRS),)
    np.testing.assert_allclose(out, ref, rtol=0, atol=atol)
    assert tce.score_pairs([]).shape == (0,)


def test_pair_ids_layout():
    tce = TR.TorchCrossEncoder(TE.EncoderConfig(**SMALL), seed=0, device="cpu")
    ids, mask = tce.pair_ids(PAIRS)
    assert ids.shape[1] == 64 and (ids[:, 0] == 1).all()
    assert np.array_equal(mask, ids != 0)
    # [CLS] q [SEP] d: the separator follows the query's tokens
    q_len = len(tce.tokenizer._tok(PAIRS[1][0]))
    assert ids[1, 1 + q_len] == TR._SEP
    # the long pair fills the budget: half for the query, the rest for the doc
    assert mask[2].sum() == 64 - 2 + 2
    assert ids[2, 1 + 31] == TR._SEP
    ids2, _ = tce.pair_ids(PAIRS[1:2])
    assert ids2.shape == (1, 16)


def test_reranker_init_layout_matches_jax():
    jp = jax.tree.map(np.asarray, R.init_reranker_params(E.EncoderConfig(**SMALL), jax.random.PRNGKey(0)))
    tp = TR.init_reranker_params(TE.EncoderConfig(**SMALL), torch.Generator().manual_seed(0))
    assert jax.tree.structure(jp) == jax.tree.structure(convert.tree_map(lambda t: t.numpy(), tp))
    assert tp["head"]["w"].shape == (128, 1) and tp["head"]["b"].shape == (1,)
