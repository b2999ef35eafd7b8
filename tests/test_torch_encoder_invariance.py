"""A row gets the same bits from the port's encoder in any launch.

The repair pinned here was found on the H100 by
``pathway_tpu_torch/tools/batch_invariance.py``: the pre-LN block in f32
runs its four products per layer through ``_dot_f32``'s fixed-row tiles, as
the bert block does (cuBLAS picks its f32 kernel by the product's rows, and
an 8-row launch gave a doc other bits than a 1,024-row one); bf16 products
keep the launch's own shape. A launch padded to another length gives a doc
the same bits because the attention kernel folds a row's softmax sum in one
tile order at every length (``tests/test_torch_attention.py`` emulates it).

The card's own checks are ``chip_smoke.py``'s ``f32_path`` gate and its
rest_serving gates; here the same functions run on CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from pathway_tpu_torch.ops import encoder as TE
from pathway_tpu_torch.tools.batch_invariance import length_check, preln_f32_check

TINY = dict(vocab_size=512, d_model=64, n_heads=2, n_layers=2, d_ff=128)


def _docs(n: int, words: int, seed: int = 0) -> list[str]:
    rng = np.random.default_rng(seed)
    vocab = [f"word{i}" for i in range(500)]
    return [" ".join(rng.choice(vocab, size=words)) for _ in range(n)]


def test_preln_f32_products_run_in_fixed_tiles(monkeypatch):
    """Four products per layer go through ``_dot_f32`` in f32 (none in
    bf16), and with tiles of 64 rows a doc gets the same bits in an 8-row
    launch as in a 40-row one, within 1e-5 of the untiled products."""
    monkeypatch.setattr(TE, "DOT_ROWS", 64)
    calls = []
    dot = TE._dot_f32

    def counted(x, w):
        calls.append(tuple(x.shape))
        return dot(x, w)

    monkeypatch.setattr(TE, "_dot_f32", counted)
    cfg = TE.EncoderConfig(**TINY, max_len=32, dtype=torch.float32)
    enc = TE.TorchSentenceEncoder(cfg, seed=0, device="cpu")
    ids, _ = enc.tokenizer(_docs(40, 20))
    full = enc.encode_ids_device(ids)
    assert len(calls) == 4 * cfg.n_layers
    calls.clear()
    few = enc.encode_ids_device(ids[:8])
    assert torch.equal(few, full[:8])
    monkeypatch.setattr(TE, "_dot_f32", lambda x, w: x.float() @ w.float())
    np.testing.assert_allclose(enc.encode_ids_device(ids).numpy(), full.numpy(), rtol=0, atol=1e-5)
    bf16 = TE.TorchSentenceEncoder(cfg._replace(dtype=torch.bfloat16), seed=0, device="cpu")
    calls.clear()
    monkeypatch.setattr(TE, "_dot_f32", counted)
    bf16.encode_ids_device(ids[:8])
    assert calls == []


def test_dot_keeps_bf16_products_at_the_launch_shape():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((3, 5, 16)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((16, 8)).astype(np.float32))
    assert torch.equal(TE._dot(x.bfloat16(), w), x.bfloat16() @ w.bfloat16())
    assert torch.equal(TE._dot(x, w), TE._dot_f32(x, w))


def test_batch_invariance_entries_hold_on_cpu():
    cfg = TE.EncoderConfig(**TINY, max_len=512)
    out = length_check(TE.TorchSentenceEncoder(cfg, seed=0, device="cpu"))
    for name in ("64_vs_256", "128_vs_256", "256_vs_512", "256_vs_256x64"):
        assert out[f"embed_len_{name}"][0], out
    f32 = TE.TorchSentenceEncoder(TE.EncoderConfig(**TINY, max_len=32, dtype=torch.float32), seed=0, device="cpu")
    got = preln_f32_check(f32, _docs(32, 20))
    assert got["preln_f32_embed_8_rows_vs_32"] == [True, 0.0] and got["preln_f32_first_differing_op"] is None
