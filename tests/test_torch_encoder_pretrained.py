"""The port's BERT checkpoint path (``TorchSentenceEncoder.from_pretrained``,
``WordPieceTokenizer``, the bert block, ``read_safetensors``) against
HuggingFace's ``BertModel`` and ``BertTokenizer`` and against the JAX
package's ``JaxSentenceEncoder.from_pretrained``, on a random tiny BERT
written locally with ``transformers`` (as ``tests/test_encoder_pretrained.py``
does), in both weight formats.

Tolerances: ids exact; f32 embeddings within 2e-5 of either reference (only
the summation order differs); bf16 within 1e-2 (both sides round
activations to bf16, at different places inside fused ops). The tiny model
has heads of width 32, a width the attention kernel takes.
"""

from __future__ import annotations

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")
safetensors_numpy = pytest.importorskip("safetensors.numpy")

from pathway_tpu.ops.encoder import JaxSentenceEncoder  # noqa: E402
from pathway_tpu.xpacks.llm.embedders import SentenceTransformerEmbedder as JEmbedder  # noqa: E402
from pathway_tpu_torch import convert  # noqa: E402
from pathway_tpu_torch.ops import encoder as TE  # noqa: E402
from pathway_tpu_torch.tools import bert_checkpoint as C  # noqa: E402
from pathway_tpu_torch.tools.batch_invariance import bert_check, bert_encoder  # noqa: E402
from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder as TEmbedder  # noqa: E402

os.environ.setdefault("HF_HUB_OFFLINE", "1")
os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")

VOCAB = [
    "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "the", "cat", "sat",
    "on", "mat", "un", "##aff", "##able", "run", "##ning", ",", ".", "!",
    "hello", "world", "café",
]
VOCAB += [f"tok{i}" for i in range(120 - len(VOCAB))]
TEXTS = [
    "the cat sat on the mat.",
    "hello unaffable running world!",
    "unknownword hello",
    "foo_bar under_scores",  # '_' splits as punctuation, as BasicTokenizer does
    "Héllo WÖRLD, the Cat!",
    "",
]
SMALL = dict(
    vocab_size=2000, hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
    intermediate_size=128, max_position_embeddings=128, type_vocab_size=2, layer_norm_eps=1e-12,
)


@pytest.fixture(scope="module")
def tiny_bert(tmp_path_factory):
    """{format: checkpoint dir} for one random tiny BertModel, and the model."""
    from transformers import BertConfig, BertModel

    cfg = BertConfig(
        vocab_size=120, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=128, max_position_embeddings=64,
    )
    torch.manual_seed(0)
    model = BertModel(cfg).eval()
    with torch.no_grad():  # random biases and LN parameters, so each term counts
        for name, p in model.named_parameters():
            if name.endswith("bias") or "LayerNorm" in name:
                p.add_(torch.randn_like(p) * 0.05)
    dirs = {}
    for fmt, safe in (("safetensors", True), ("bin", False)):
        d = str(tmp_path_factory.mktemp(f"tinybert_{fmt}"))
        model.save_pretrained(d, safe_serialization=safe)
        with open(os.path.join(d, "vocab.txt"), "w") as f:
            f.write("\n".join(VOCAB) + "\n")
        dirs[fmt] = d
    assert os.path.exists(os.path.join(dirs["safetensors"], "model.safetensors"))
    assert os.path.exists(os.path.join(dirs["bin"], "pytorch_model.bin"))
    return dirs, model


def _hf_embed(model, ids, mask):
    with torch.no_grad():
        out = model(
            input_ids=torch.tensor(ids, dtype=torch.long),
            attention_mask=torch.tensor(mask, dtype=torch.long),
        ).last_hidden_state
        m = torch.tensor(mask, dtype=torch.float32).unsqueeze(-1)
        pooled = (out * m).sum(1) / m.sum(1).clamp(min=1.0)
        return (pooled / pooled.norm(dim=-1, keepdim=True)).numpy()


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
def test_wordpiece_ids_match_bert_tokenizer_and_reference(tiny_bert, fmt):
    from transformers import BertTokenizer

    d = tiny_bert[0][fmt]
    enc = TE.TorchSentenceEncoder.from_pretrained(d, device="cpu")
    assert isinstance(enc.tokenizer, TE.WordPieceTokenizer) and enc.tokenizer.pad_id_zero
    hf = BertTokenizer(os.path.join(d, "vocab.txt"), do_lower_case=True)
    ref = JaxSentenceEncoder.from_pretrained(d).tokenizer
    ids, mask = enc.tokenizer(TEXTS)
    rids, rmask = ref(TEXTS)
    np.testing.assert_array_equal(ids, rids)
    np.testing.assert_array_equal(mask, rmask)
    for i, t in enumerate(TEXTS):
        assert ids[i][mask[i]].tolist() == hf.encode(t), t


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
def test_forward_matches_bert_model_and_reference(tiny_bert, fmt):
    dirs, model = tiny_bert
    enc = TE.TorchSentenceEncoder.from_pretrained(dirs[fmt], device="cpu")
    jenc = JaxSentenceEncoder.from_pretrained(dirs[fmt])
    assert enc.cfg.arch == "bert" and enc.cfg.dtype == torch.float32 and enc.cfg.ln_eps == 1e-12
    ids, mask = enc.tokenizer(TEXTS)
    ours = enc.encode_tokens(ids, mask)
    assert ours.shape == (len(TEXTS), 64) and np.isfinite(ours).all()
    assert np.abs(ours - _hf_embed(model, ids, mask)).max() < 2e-5
    assert np.abs(ours - jenc.encode_tokens(ids, mask)).max() < 2e-5
    # the text entry points: ids-only transfer (pad id 0), the same vectors
    np.testing.assert_array_equal(enc.encode_texts(TEXTS), ours)
    np.testing.assert_array_equal(enc.encode_texts_device(TEXTS).numpy(), ours)
    assert enc.param_count() == jenc.param_count()


def test_both_weight_formats_load_equal_parameters(tiny_bert):
    dirs, _ = tiny_bert
    a = TE.TorchSentenceEncoder.from_pretrained(dirs["safetensors"], device="cpu")
    b = TE.TorchSentenceEncoder.from_pretrained(dirs["bin"], device="cpu")
    pa, pb = dict(a.named_parameters()), dict(b.named_parameters())
    assert pa.keys() == pb.keys() and len(pa) == 3 + 2 + 2 * 12 + 2
    assert all(torch.equal(pa[k], pb[k]) for k in pa)
    assert pa["params.layers.0.wqkv"].shape == (64, 192) and pa["params.tok_type"].shape == (2, 64)


def test_bf16_forward_matches_reference(tiny_bert):
    d = tiny_bert[0]["safetensors"]
    enc = TE.TorchSentenceEncoder.from_pretrained(d, dtype=torch.bfloat16, device="cpu")
    jenc = JaxSentenceEncoder.from_pretrained(d, dtype=jnp.bfloat16)
    ids, mask = enc.tokenizer(TEXTS)
    np.testing.assert_allclose(enc.encode_tokens(ids, mask), jenc.encode_tokens(ids, mask), rtol=0, atol=1e-2)


def test_tokenizer_fallbacks_and_lowercase(tiny_bert, tmp_path):
    src = tiny_bert[0]["safetensors"]
    # tokenizer.json instead of vocab.txt, with do_lower_case off
    d = tmp_path / "tokjson"
    shutil.copytree(src, d)
    os.remove(d / "vocab.txt")
    (d / "tokenizer.json").write_text(json.dumps({"model": {"vocab": {t: i for i, t in enumerate(VOCAB)}}}))
    cfg = json.loads((d / "config.json").read_text())
    (d / "config.json").write_text(json.dumps({**cfg, "do_lower_case": False}))
    enc = TE.TorchSentenceEncoder.from_pretrained(str(d), max_len=32, device="cpu")
    jenc = JaxSentenceEncoder.from_pretrained(str(d), max_len=32)
    assert not enc.tokenizer.lowercase and enc.cfg.max_len == 32
    for texts in (TEXTS, ["The Cat " * 40]):  # the second is cut at max_len
        np.testing.assert_array_equal(enc.tokenizer(texts)[0], jenc.tokenizer(texts)[0])
    assert enc.tokenizer(["The Cat " * 40])[0].shape == (1, 32)
    # neither file: the hash tokenizer, with a warning
    os.remove(d / "tokenizer.json")
    with pytest.warns(UserWarning, match="hash tokenizer"):
        enc = TE.TorchSentenceEncoder.from_pretrained(str(d), device="cpu")
    assert isinstance(enc.tokenizer, TE.HashTokenizer)
    with pytest.raises(FileNotFoundError, match="no model.safetensors or pytorch_model.bin"):
        os.remove(d / "model.safetensors")
        TE.TorchSentenceEncoder.from_pretrained(str(d), device="cpu")


def test_from_pretrained_refuses_head_widths_the_kernel_lacks(tmp_path):
    """A checkpoint of head width 8 (4 heads at hidden 32, the reference's
    own tiny BERT's shape) loads, as the reference's does, and now runs
    inside the kernels' envelope (the instantiation of width 16, half its
    columns zero), as every width does (``tests/test_torch_head_width.py``,
    ``tests/test_torch_head_width_any.py``); the embedding is finite and
    unit-norm, and the CPU counts no launch."""
    from pathway_tpu_torch.ops import attention_kernel as A
    from transformers import BertConfig, BertModel

    BertModel(BertConfig(vocab_size=30, hidden_size=32, num_hidden_layers=1, num_attention_heads=4,
                         intermediate_size=32, max_position_embeddings=16)).save_pretrained(str(tmp_path))
    enc = TE.TorchSentenceEncoder.from_pretrained(str(tmp_path), device="cpu")
    before = (A.LAUNCHES, dict(A.ROUTE_LAUNCHES))
    emb = enc.encode_texts(["a b c"])
    assert (A.LAUNCHES, A.ROUTE_LAUNCHES) == before  # the CPU launches nothing
    assert A.in_envelope(16, 8) and A.kernel_width(8) == 16
    assert emb.shape == (1, 32) and np.isfinite(emb).all()
    np.testing.assert_allclose(np.linalg.norm(emb, axis=-1), 1.0, rtol=1e-5)


# -------------------------------------------------------------- safetensors
def test_read_safetensors_matches_the_safetensors_package(tiny_bert, tmp_path):
    from safetensors.torch import save_file

    path = os.path.join(tiny_bert[0]["safetensors"], "model.safetensors")
    ours = TE.read_safetensors(path)
    ref = safetensors_numpy.load_file(path)
    assert ours.keys() == ref.keys()
    for k in ref:
        assert ours[k].dtype == torch.float32
        np.testing.assert_array_equal(ours[k].numpy(), ref[k])
    tensors = {
        "f16": torch.randn(3, 5).half(), "bf16": torch.randn(7).bfloat16(), "i64": torch.arange(6).reshape(2, 3),
        "i8": torch.tensor([-3, 4], dtype=torch.int8), "u8": torch.tensor([255], dtype=torch.uint8),
        "b": torch.tensor([True, False]), "f64": torch.randn(2, 2, 2, dtype=torch.float64),
        "i32": torch.tensor([1 << 30], dtype=torch.int32), "i16": torch.tensor([-7], dtype=torch.int16),
        "scalar": torch.tensor(2.5), "empty": torch.zeros(0, 4),
    }
    save_file(tensors, str(tmp_path / "mixed.safetensors"), metadata={"format": "pt"})
    got = TE.read_safetensors(str(tmp_path / "mixed.safetensors"))
    assert got.keys() == tensors.keys()
    for k, t in tensors.items():
        assert got[k].dtype == t.dtype and got[k].shape == t.shape and torch.equal(got[k], t), k


@pytest.mark.parametrize(
    "blob,match",
    [
        (b"\x01\x00", "shorter than its header length"),
        ((1000).to_bytes(8, "little") + b"{}", "runs past the end"),
        (None, "unsupported dtype"),
        (None, "bad data_offsets"),
    ],
)
def test_read_safetensors_refuses_malformed_files(blob, match, tmp_path):
    if blob is None:
        info = {"dtype": "F8_E4M3", "shape": [1], "data_offsets": [0, 1]} if "dtype" in match else {
            "dtype": "F32", "shape": [4], "data_offsets": [0, 8]}
        header = json.dumps({"t": info}).encode()
        blob = len(header).to_bytes(8, "little") + header + b"\x00" * 16
    (tmp_path / "bad.safetensors").write_bytes(blob)
    with pytest.raises(ValueError, match=match):
        TE.read_safetensors(str(tmp_path / "bad.safetensors"))


# ------------------------------------------------- the bert tree, the embedder
def test_bert_tree_through_params_from_numpy(tiny_bert):
    jenc = JaxSentenceEncoder.from_pretrained(tiny_bert[0]["bin"])
    tree = convert.params_from_numpy(jax.tree.map(np.asarray, jenc.params), "cpu")
    for key in ("tok_type", "emb_ln"):
        assert key in tree
    assert {"bqkv", "bo", "b1", "b2"} <= tree["layers"][0].keys()
    cfg = TE.EncoderConfig(
        vocab_size=120, d_model=64, n_heads=2, n_layers=2, d_ff=128, max_len=64,
        dtype=torch.float32, arch="bert", ln_eps=1e-12,
    )
    tenc = TE.TorchSentenceEncoder(cfg, params=tree, tokenizer=TE.WordPieceTokenizer(jenc.tokenizer.vocab), device="cpu")
    np.testing.assert_allclose(tenc.encode_texts(TEXTS), jenc.encode_texts(TEXTS), rtol=0, atol=2e-5)
    # the xpack embedder takes the same tree and config
    jcfg = jenc.cfg
    emb_t = TEmbedder(cfg, params=tree, device="cpu")
    emb_j = JEmbedder(jcfg, params=jenc.params)
    texts = ["hello world", "the cat"]
    np.testing.assert_allclose(np.stack(emb_t.func(texts)), np.stack(emb_j.func(texts)), rtol=0, atol=2e-5)
    assert emb_t.get_embedding_dimension() == 64


def test_init_params_builds_the_preln_tree_for_either_arch():
    cfg = TE.EncoderConfig(vocab_size=64, d_model=64, n_heads=2, n_layers=1, d_ff=64, max_len=16, arch="bert")
    tree = TE.init_params(cfg, torch.Generator().manual_seed(0))
    assert set(tree) == {"embed", "pos", "layers", "ln_f"} and "bqkv" not in tree["layers"][0]


# -------------------------------------------------------- batch invariance
def test_dot_f32_gives_a_row_the_same_bits_in_any_launch(monkeypatch):
    monkeypatch.setattr(TE, "DOT_ROWS", 16)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((5, 9, 48)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((48, 24)).astype(np.float32))
    full = TE._dot_f32(x, w)
    assert full.shape == (5, 9, 24) and full.dtype == torch.float32
    np.testing.assert_allclose(full.numpy(), (x @ w).numpy(), rtol=1e-5, atol=1e-5)
    for lo in range(5):
        assert torch.equal(TE._dot_f32(x[lo : lo + 1], w), full[lo : lo + 1])
    xb = x.bfloat16()
    np.testing.assert_array_equal(TE._dot_f32(xb, w).numpy(), TE._dot_f32(xb.float(), w.bfloat16()).numpy())


@pytest.mark.parametrize("config,n_docs", [(SMALL, 64), (C.MINILM_L6, 16)], ids=["small", "minilm_widths"])
def test_bert_batch_invariance_on_cpu(config, n_docs):
    enc, vocab = bert_encoder("cpu", config)
    out = bert_check(enc, C.synthetic_docs(vocab, n_docs))
    assert out[f"bert_embed_8_rows_vs_{n_docs}"] == [True, 0.0], out
    assert out["bert_first_differing_op"] is None


# ------------------------------------------------ the synthetic checkpoint
def test_synthetic_checkpoint_tokenizes_like_bert_tokenizer(tmp_path):
    from transformers import BertTokenizer

    vocab = C.synthetic_vocab(SMALL["vocab_size"])
    assert len(vocab) == len(set(vocab)) == SMALL["vocab_size"] and vocab[0] == "[PAD]"
    docs = C.synthetic_docs(vocab, 200, seed=3)
    C.write_checkpoint(str(tmp_path), SMALL, C.random_state_dict(SMALL, seed=1), vocab)
    enc = TE.TorchSentenceEncoder.from_pretrained(str(tmp_path), max_len=128, device="cpu")
    hf = BertTokenizer(str(tmp_path / "vocab.txt"), do_lower_case=True)
    ids, mask = enc.tokenizer(docs)
    assert ids.shape[1] == 128 and (ids == enc.tokenizer.unk_id).any()
    for i, d in enumerate(docs):
        assert ids[i][mask[i]].tolist() == hf.encode(d)[:128]
    from transformers import BertModel

    model = BertModel.from_pretrained(str(tmp_path)).eval()
    np.testing.assert_allclose(enc.encode_tokens(ids[:8], mask[:8]), _hf_embed(model, ids[:8], mask[:8]), rtol=0, atol=2e-5)
