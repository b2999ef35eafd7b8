"""Transformer sentence encoders in PyTorch: the framework's pre-LN block and
the exact BERT/MiniLM block of HuggingFace checkpoints.

Port of ``pathway_tpu/ops/encoder.py``. The pre-LN block (``arch="preln"``):
token and position embeddings, per layer LN → QKV → attention → output
projection + residual → LN → tanh-GELU FFN + residual, a final LN. The BERT
block (``arch="bert"``, :meth:`TorchSentenceEncoder.from_pretrained`): word,
position and token-type embeddings with their own LN, per layer biased QKV →
attention → biased output projection → residual + LN → exact erf-GELU FFN
with biases → residual + LN, every LN two-pass with ``cfg.ln_eps``. Both end
in masked mean pooling in f32 and an L2 norm. Matrices are ``[in, out]``
(``x @ W``) as in the JAX package, and activations run in ``cfg.dtype`` with
the weights cast to it at use. Every attention goes through
:func:`~pathway_tpu_torch.ops.attention_kernel.attention_short_flat`: the
Hopper kernel on the card, its plain version on the CPU. Every launch goes
through the device plane's traced entry points (``encoder.encode``,
``encoder.encode_ids``) and reports its padded tokens and FLOPs, and the
weights are registered as ``encoder_params`` device bytes, as in the
reference.
"""

from __future__ import annotations

import functools
import json
import os
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pathway_tpu_torch._device import resolve_device
from pathway_tpu_torch.convert import ParamTree, tree_map
from pathway_tpu_torch.native import try_load as _try_load_native
from pathway_tpu_torch.observability import device as _dev_prof
from pathway_tpu_torch.ops._fixed_order import fixed_order_sum
from pathway_tpu_torch.ops.attention_kernel import HEAD_DIMS, attention_short_flat
from pathway_tpu_torch.ops.microbatch import LENGTH_MAX_BUCKET, bucket_size


class EncoderConfig(NamedTuple):
    vocab_size: int = 32768
    d_model: int = 384
    n_heads: int = 6
    n_layers: int = 6
    d_ff: int = 1536
    max_len: int = 512
    dtype: torch.dtype = torch.bfloat16
    #: "preln" = the framework's own pre-LN block; "bert" = the exact post-LN
    #: BERT/MiniLM block (biases, embedding LN, token types) of HuggingFace
    #: checkpoints, loaded by ``TorchSentenceEncoder.from_pretrained``
    arch: str = "preln"
    #: the bert block's LN epsilon (the pre-LN block's LN uses 1e-6)
    ln_eps: float = 1e-6


def init_params(cfg: EncoderConfig, generator: torch.Generator) -> dict:
    """Random f32 parameter tree ``{embed, pos, layers: [..], ln_f}`` on the
    CPU, drawn from ``generator`` (the JAX package's init scales; the numbers
    themselves differ, as any two generators do). It is the pre-LN tree for
    either arch, as in the JAX package: a bert tree comes from a checkpoint
    or from ``params=``."""
    d = cfg.d_model

    def normal(*shape, scale):
        return torch.randn(*shape, generator=generator, dtype=torch.float32) * scale

    def ln():
        return {"g": torch.ones(d), "b": torch.zeros(d)}

    params: dict = {
        "embed": normal(cfg.vocab_size, d, scale=d ** -0.5),
        "pos": normal(cfg.max_len, d, scale=d ** -0.5),
        "layers": [],
        "ln_f": ln(),
    }
    for _ in range(cfg.n_layers):
        params["layers"].append(
            {
                "ln1": ln(),
                "wqkv": normal(d, 3 * d, scale=d ** -0.5),
                "wo": normal(d, d, scale=d ** -0.5),
                "ln2": ln(),
                "w1": normal(d, cfg.d_ff, scale=d ** -0.5),
                "w2": normal(cfg.d_ff, d, scale=cfg.d_ff ** -0.5),
            }
        )
    return params


def _layer_norm(x, g, b):
    """Single-pass LN: var = E[x²] − E[x]², clamped at 0, eps 1e-6; computed
    in f32, returned in x's dtype."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = ((x32 * x32).mean(dim=-1, keepdim=True) - mu * mu).clamp_min(0.0)
    return ((x32 - mu) * torch.rsqrt(var + 1e-6) * g + b).to(x.dtype)


def _attention(x, wqkv, wo, mask, n_heads: int):
    """QKV projection, flat attention on the strided q/k/v views of the
    projection (no copies), output projection."""
    D = x.shape[-1]
    q, k, v = _dot(x, wqkv).split(D, dim=-1)
    ctx = attention_short_flat(q, k, v, mask, n_heads, (D // n_heads) ** -0.5)
    return _dot(ctx, wo)


def _layer_norm_eps(x, g, b, eps: float):
    """Two-pass LN of the bert block: var = E[(x − E[x])²], in f32, returned
    in f32."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    return (x32 - mu) * torch.rsqrt(var + eps) * g + b


#: rows of every f32 product: the bert block's, and the pre-LN block's in
#: f32 (see :func:`_dot_f32`)
DOT_ROWS = 8192


def _dot_f32(x, w):
    """``x @ w`` with ``w`` cast to x's dtype and the product accumulated
    and returned in f32 (the JAX package's ``preferred_element_type``):
    products of bf16 values are exact in f32, so this is the same function
    in either dtype.

    The rows of ``x`` (batch x tokens) go through products of exactly
    ``DOT_ROWS`` rows, the last zero-padded: cuBLAS picks its f32 kernel by
    the product's shape, and on the H100 a doc got other bits in an 8-row
    launch (1,024 token rows) than in a 1,024-row one. One shape gives every
    row the same bits in any launch."""
    lead, K = x.shape[:-1], x.shape[-1]
    w = w.to(x.dtype).float()
    rows = x.reshape(-1, K).float()
    M = rows.shape[0]
    out = torch.empty(M, w.shape[1], dtype=torch.float32, device=x.device)
    for lo in range(0, M, DOT_ROWS):
        n = min(DOT_ROWS, M - lo)
        if n == DOT_ROWS:
            torch.mm(rows[lo : lo + n], w, out=out[lo : lo + n])
        else:
            out[lo : lo + n] = (F.pad(rows[lo : lo + n], (0, 0, 0, DOT_ROWS - n)) @ w)[:n]
    return out.reshape(*lead, w.shape[1])


def _dot(x, w):
    """The pre-LN block's ``x @ w`` in ``x``'s dtype. In f32 it runs through
    :func:`_dot_f32`'s fixed-row tiles: there too a doc got other bits in an
    8-row launch than in a 1,024-row one on the H100 (the pre-LN f32 entry
    of ``tools/batch_invariance.py``; first differing: layer 0's attention
    output, whose only f32 product before it is the QKV projection). bf16
    products keep the launch's own shape, which gives a row the same bits
    in any batch on the card (its embed entries)."""
    if x.dtype == torch.float32:
        return _dot_f32(x, w)
    return x @ w.to(x.dtype)


def _attention_biased(x, wqkv, bqkv, wo, bo, mask, n_heads: int):
    """The bert block's attention: a biased QKV projection in f32, cast to
    x's dtype, flat attention on the strided q/k/v views of it, a biased
    output projection in f32, cast to x's dtype."""
    D = x.shape[-1]
    q, k, v = (_dot_f32(x, wqkv) + bqkv).to(x.dtype).split(D, dim=-1)
    ctx = attention_short_flat(q, k, v, mask, n_heads, (D // n_heads) ** -0.5)
    return (_dot_f32(ctx, wo) + bo).to(x.dtype)


def _hidden_states_bert(params, cfg: EncoderConfig, token_ids: torch.Tensor, mask: torch.Tensor):
    """The exact BERT/MiniLM forward up to pooling: the sum of word,
    position and token-type-0 embeddings and its LN, then per layer
    post-LN residuals around the biased attention and the erf-GELU FFN."""
    dt_ = cfg.dtype
    L = token_ids.shape[1]
    x = (
        params["embed"][token_ids].float()
        + params["pos"][:L][None, :, :].float()
        + params["tok_type"][0][None, None, :].float()
    )
    x = _layer_norm_eps(x, params["emb_ln"]["g"], params["emb_ln"]["b"], cfg.ln_eps).to(dt_)
    for layer in params["layers"]:
        a = _attention_biased(
            x, layer["wqkv"], layer["bqkv"], layer["wo"], layer["bo"], mask, cfg.n_heads
        )
        x = _layer_norm_eps((x + a).float(), layer["ln1"]["g"], layer["ln1"]["b"], cfg.ln_eps).to(dt_)
        h = F.gelu(_dot_f32(x, layer["w1"]) + layer["b1"], approximate="none").to(dt_)
        h = _dot_f32(h, layer["w2"]) + layer["b2"]
        x = _layer_norm_eps(x.float() + h, layer["ln2"]["g"], layer["ln2"]["b"], cfg.ln_eps).to(dt_)
    return x


def hidden_states(params, cfg: EncoderConfig, token_ids: torch.Tensor, mask: torch.Tensor):
    """The token states that are pooled: [B, L] tokens + bool mask → [B, L,
    d_model] in ``cfg.dtype`` (pre-LN: after the final LN; bert: the last
    layer's output)."""
    if cfg.arch == "bert":
        return _hidden_states_bert(params, cfg, token_ids, mask)
    x = params["embed"][token_ids].to(cfg.dtype)
    L = token_ids.shape[1]
    x = x + params["pos"][:L][None, :, :].to(cfg.dtype)
    for layer in params["layers"]:
        h = _layer_norm(x, layer["ln1"]["g"], layer["ln1"]["b"])
        x = x + _attention(h, layer["wqkv"], layer["wo"], mask, cfg.n_heads)
        h = _layer_norm(x, layer["ln2"]["g"], layer["ln2"]["b"])
        h = F.gelu(_dot(h, layer["w1"]), approximate="tanh")
        x = x + _dot(h, layer["w2"])
    return _layer_norm(x, params["ln_f"]["g"], params["ln_f"]["b"])


def pool(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked mean over the kept tokens in f32, divided by ``max(count, 1)``,
    then L2-normalised with a 1e-12 floor (the reference's pooling). The sum
    over tokens and the sum of squares run in one fixed order of
    elementwise adds (:func:`fixed_order_sum`): torch's reductions split
    them by the batch's shape, which gave a doc other bits in an 8-row
    launch than in a 512-row one on the H100."""
    m = mask.float()[:, :, None]
    pooled = fixed_order_sum(x.float() * m, dim=1) / m.sum(dim=1).clamp_min(1.0)
    norm = fixed_order_sum(pooled * pooled, dim=-1).sqrt()[:, None]
    return pooled / norm.clamp_min(1e-12)


def encode(params, cfg: EncoderConfig, token_ids: torch.Tensor, mask: torch.Tensor):
    """Forward pass: [B, L] integer tokens + bool mask → [B, d_model] f32
    unit vectors."""
    return pool(hidden_states(params, cfg, token_ids, mask), mask)


def encode_ids(params, cfg: EncoderConfig, token_ids: torch.Tensor):
    """ids-only forward: the mask is ``ids != 0`` (pad id 0), and narrow
    integer ids (int16 from the hash tokenizer) widen on the device."""
    return encode(params, cfg, token_ids.long(), token_ids != 0)


# device profiling plane: every encoder launch counts toward the per-callable
# call/shape telemetry on /status (+/metrics) — see observability/device.py
encode_jit = _dev_prof.traced_jit("encoder.encode", encode)
encode_ids_jit = _dev_prof.traced_jit("encoder.encode_ids", encode_ids)


@functools.cache
def _native_pwtok():
    """The C tokenizer kernel, built at first use (None: the Python path)."""
    return _try_load_native("pwtok")


class HashTokenizer:
    """Deterministic hashing tokenizer: whitespace and punctuation split,
    token → bucket by FNV-1a, no vocab files. Ids are bit-identical to the
    JAX package's. The per-doc loop runs in C (``native/pwtok.c``) for ASCII
    text, with the Python path for other rows and for a missing compiler.
    Emits int16 ids when the vocab fits; id 0 is padding, so ``ids != 0``
    recovers the mask on the device."""

    #: id 0 is reserved for padding by construction (real ids are >= 1)
    pad_id_zero = True

    def __init__(self, vocab_size: int = 32768, max_len: int = 128):
        self.vocab_size = vocab_size
        self.max_len = max_len

    def _tok(self, text: str) -> list[int]:
        import re

        words = re.findall(r"[A-Za-z0-9]+|[^\sA-Za-z0-9]", text.lower())
        out = []
        for w in words[: self.max_len]:
            h = 1469598103934665603
            for ch in w.encode():
                h = ((h ^ ch) * 1099511628211) & 0xFFFFFFFFFFFFFFFF
            out.append(3 + h % (self.vocab_size - 3))  # 0=pad, 1=cls, 2=sep
        return out

    def _tok_batch(self, texts: list[str]) -> tuple[np.ndarray, np.ndarray]:
        """(word_ids [N, max_len] int32, lens [N])."""
        native = _native_pwtok()
        if native is not None:
            arr = np.empty(len(texts), dtype=object)
            arr[:] = texts
            cids, lens = native.hash_tokenize(arr, self.vocab_size, self.max_len)
            for i in np.nonzero(lens < 0)[0]:  # non-ASCII rows
                t = self._tok(texts[i])
                lens[i] = len(t)
                cids[i, : len(t)] = t
            return cids, lens
        cids = np.zeros((len(texts), self.max_len), dtype=np.int32)
        lens = np.zeros(len(texts), dtype=np.int32)
        for i, text in enumerate(texts):
            t = self._tok(text)
            lens[i] = len(t)
            cids[i, : len(t)] = t
        return cids, lens

    def __call__(self, texts: list[str]) -> tuple[np.ndarray, np.ndarray]:
        cids, lens = self._tok_batch(texts)
        L = min(
            self.max_len,
            bucket_size(
                int(lens.max(initial=0)) + 1, min_bucket=16, max_bucket=LENGTH_MAX_BUCKET
            ),
        )
        n = len(texts)
        dtype = np.int16 if self.vocab_size <= 32768 else np.int32
        ids = np.zeros((n, L), dtype=dtype)
        ids[:, 0] = 1  # [CLS]
        keep = np.minimum(lens, L - 1)
        body = np.arange(L - 1)[None, :] < keep[:, None]
        ids[:, 1:] = np.where(body, cids[:, : L - 1], 0).astype(dtype)
        return ids, ids != 0


class WordPieceTokenizer:
    """Greedy longest-match-first WordPiece (the BERT/MiniLM tokenizer):
    basic split on whitespace and punctuation with lowercasing and NFD accent
    stripping, ``##`` continuation pieces, an unmatchable word as one
    ``[UNK]``, ``[CLS]`` ... ``[SEP]`` around each text, lengths padded to
    power-of-two buckets. Vocabulary from a ``vocab.txt`` (one token per
    line) or a dict. Ids are the JAX package's."""

    def __init__(
        self,
        vocab: dict,
        max_len: int = 128,
        lowercase: bool = True,
        unk_token: str = "[UNK]",
        cls_token: str = "[CLS]",
        sep_token: str = "[SEP]",
        max_word_chars: int = 100,
    ):
        self.vocab = vocab
        self.max_len = max_len
        self.lowercase = lowercase
        self.unk_id = vocab[unk_token]
        self.cls_id = vocab[cls_token]
        self.sep_id = vocab[sep_token]
        self.max_word_chars = max_word_chars
        # ids-only device transfer is safe only if vocab slot 0 is the pad
        # token (standard for BERT vocabs); otherwise the mask must ship
        self.pad_id_zero = vocab.get("[PAD]", -1) == 0

    @classmethod
    def from_vocab_file(cls, path: str, **kwargs) -> "WordPieceTokenizer":
        vocab: dict = {}
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                vocab[line.rstrip("\r\n")] = i
        return cls(vocab, **kwargs)

    def _basic(self, text: str) -> list:
        if self.lowercase:
            import unicodedata

            text = unicodedata.normalize("NFD", text.lower())
            text = "".join(c for c in text if unicodedata.category(c) != "Mn")
        out: list = []
        word = []
        for ch in text:
            if ch.isspace():
                if word:
                    out.append("".join(word))
                    word = []
            elif not ch.isalnum():
                if word:
                    out.append("".join(word))
                    word = []
                out.append(ch)
            else:
                word.append(ch)
        if word:
            out.append("".join(word))
        return out

    def _wordpiece(self, word: str) -> list:
        if len(word) > self.max_word_chars:
            return [self.unk_id]
        ids: list = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                piece = word[start:end]
                if start > 0:
                    piece = "##" + piece
                if piece in self.vocab:
                    cur = self.vocab[piece]
                    break
                end -= 1
            if cur is None:
                return [self.unk_id]  # any unmatchable span voids the word
            ids.append(cur)
            start = end
        return ids

    def _tok(self, text: str) -> list:
        ids: list = []
        for word in self._basic(text):
            ids.extend(self._wordpiece(word))
            if len(ids) >= self.max_len - 2:
                break
        return ids[: self.max_len - 2]

    def __call__(self, texts: list) -> tuple:
        toks = [[self.cls_id] + self._tok(t) + [self.sep_id] for t in texts]
        L = min(
            self.max_len,
            bucket_size(
                max((len(t) for t in toks), default=1),
                min_bucket=16,
                max_bucket=LENGTH_MAX_BUCKET,
            ),
        )
        ids = np.zeros((len(toks), L), dtype=np.int32)
        mask = np.zeros((len(toks), L), dtype=bool)
        for i, t in enumerate(toks):
            t = t[:L]
            ids[i, : len(t)] = t
            mask[i, : len(t)] = True
        return ids, mask


class TorchSentenceEncoder(nn.Module):
    """Batched text → embedding model: tokenizer plus the forward of
    ``cfg.arch`` on ``device`` (default: the card). The API mirrors the JAX
    package's ``JaxSentenceEncoder``. ``param_dtype`` stores the matrices in
    that type (bf16 on the main path) while norms and biases stay f32."""

    def __init__(
        self,
        cfg: EncoderConfig | None = None,
        seed: int = 0,
        params: dict | None = None,
        tokenizer: Any = None,
        param_dtype: torch.dtype | None = None,
        device=None,
    ):
        super().__init__()
        self.device = resolve_device(device)
        self.cfg = cfg or EncoderConfig()
        if params is None:
            params = init_params(self.cfg, torch.Generator().manual_seed(seed))
        if param_dtype is not None:
            params = tree_map(lambda p: p.to(param_dtype) if p.ndim >= 2 else p, params)
        self.param_dtype = param_dtype
        self.params = ParamTree(params).to(self.device)
        self.tokenizer = tokenizer or HashTokenizer(self.cfg.vocab_size, self.cfg.max_len)
        self._param_count: int | None = None
        # memory attribution: encoder weights show up as
        # pathway_device_bytes{component="encoder_params"} while this
        # instance lives (weakly registered — no lifetime coupling)
        _dev_prof.register_memory(self, "encoder_params", lambda enc: enc.param_bytes())

    @property
    def dimension(self) -> int:
        return self.cfg.d_model

    def param_count(self) -> int:
        if self._param_count is None:
            self._param_count = sum(p.numel() for p in self.parameters())
        return self._param_count

    def param_bytes(self) -> int:
        return sum(p.numel() * p.element_size() for p in self.parameters())

    def _note_launch(self, ids, mask=None) -> None:
        """Padding-waste + FLOP accounting for one encoder launch (rough
        transformer-forward estimate: 2 · params · tokens over the PADDED
        token grid the device actually runs)."""
        stats = _dev_prof.stats()
        if not stats.enabled:
            return
        total = int(ids.shape[0]) * int(ids.shape[1])
        real = int(np.count_nonzero(np.asarray(mask if mask is not None else ids)))
        stats.note_pad_tokens("encoder", real, total - real)
        stats.note_flops("encoder", 2.0 * self.param_count() * total)

    def forward(self, token_ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        return encode_jit(self.params, self.cfg, token_ids, mask)

    def _ids(self, ids) -> torch.Tensor:
        if isinstance(ids, np.ndarray):
            ids = torch.from_numpy(ids)
        return ids.to(self.device)

    @torch.inference_mode()
    def encode_ids_device(self, ids: np.ndarray | torch.Tensor) -> torch.Tensor:
        """Pre-tokenized ids (pad id 0) → embeddings on the device."""
        if isinstance(ids, np.ndarray):
            self._note_launch(ids)
        return encode_ids_jit(self.params, self.cfg, self._ids(ids))

    @torch.inference_mode()
    def encode_texts_device(self, texts: list[str]) -> torch.Tensor:
        """Like :meth:`encode_texts` but returns the device tensor without a
        host sync. Only the narrow id array crosses to the device when the
        tokenizer's pad id is 0; otherwise its mask is shipped too."""
        ids, mask = self.tokenizer(texts)
        self._note_launch(ids, mask)
        if getattr(self.tokenizer, "pad_id_zero", False):
            return encode_ids_jit(self.params, self.cfg, self._ids(ids))
        return encode_jit(self.params, self.cfg, self._ids(ids).long(), self._ids(mask))

    def encode_texts(self, texts: list[str]) -> np.ndarray:
        if not texts:
            return np.zeros((0, self.cfg.d_model), dtype=np.float32)
        return self.encode_texts_device(texts).cpu().numpy()

    @torch.inference_mode()
    def encode_tokens(self, ids: np.ndarray, mask: np.ndarray) -> np.ndarray:
        self._note_launch(ids, mask)
        out = encode_jit(self.params, self.cfg, self._ids(ids).long(), self._ids(mask))
        return out.cpu().numpy()

    @classmethod
    def from_pretrained(
        cls,
        path: str,
        *,
        max_len: int | None = None,
        dtype: torch.dtype | None = None,
        device=None,
    ) -> "TorchSentenceEncoder":
        """Load a local HuggingFace BERT/MiniLM checkpoint directory
        (``config.json`` + ``model.safetensors`` or ``pytorch_model.bin``,
        with ``vocab.txt`` or ``tokenizer.json``) into the exact BERT
        forward, in f32 unless ``dtype`` says otherwise. Needs neither
        ``transformers`` nor ``safetensors``: the safetensors file is read by
        :func:`read_safetensors`. Every attention runs through
        ``attention_short_flat``, so the head width must be one of its
        ``HEAD_DIMS`` (32 for MiniLM, 64 for BERT-base)."""
        with open(os.path.join(path, "config.json"), encoding="utf-8") as f:
            hf = json.load(f)
        hd = hf["hidden_size"] // hf["num_attention_heads"]
        if hd not in HEAD_DIMS:
            raise ValueError(f"{path!r}: head width {hd} not in the attention kernel's {HEAD_DIMS}")
        cfg = EncoderConfig(
            vocab_size=hf["vocab_size"],
            d_model=hf["hidden_size"],
            n_heads=hf["num_attention_heads"],
            n_layers=hf["num_hidden_layers"],
            d_ff=hf["intermediate_size"],
            max_len=min(hf.get("max_position_embeddings", 512), max_len or 512),
            dtype=dtype if dtype is not None else torch.float32,
            arch="bert",
            ln_eps=hf.get("layer_norm_eps", 1e-12),
        )
        sd = _load_state_dict(path)

        def get(name):
            for prefix in ("", "bert."):
                if prefix + name in sd:
                    return sd[prefix + name].float()
            raise KeyError(f"missing checkpoint tensor {name!r}")

        def ln(pre):
            return {"g": get(pre + "LayerNorm.weight"), "b": get(pre + "LayerNorm.bias")}

        params: dict = {
            "embed": get("embeddings.word_embeddings.weight"),
            "pos": get("embeddings.position_embeddings.weight"),
            "tok_type": get("embeddings.token_type_embeddings.weight"),
            "emb_ln": ln("embeddings."),
            "layers": [],
            "ln_f": {"g": torch.ones(cfg.d_model), "b": torch.zeros(cfg.d_model)},
        }
        for i in range(cfg.n_layers):
            pre = f"encoder.layer.{i}."
            att = pre + "attention.self."
            params["layers"].append(
                {
                    "wqkv": torch.cat([get(att + n + ".weight").T for n in ("query", "key", "value")], dim=1),
                    "bqkv": torch.cat([get(att + n + ".bias") for n in ("query", "key", "value")]),
                    "wo": get(pre + "attention.output.dense.weight").T,
                    "bo": get(pre + "attention.output.dense.bias"),
                    "ln1": ln(pre + "attention.output."),
                    "w1": get(pre + "intermediate.dense.weight").T,
                    "b1": get(pre + "intermediate.dense.bias"),
                    "w2": get(pre + "output.dense.weight").T,
                    "b2": get(pre + "output.dense.bias"),
                    "ln2": ln(pre + "output."),
                }
            )
        # the transposed matrices in C order, as params_from_numpy gives them
        params = tree_map(lambda t: t.contiguous(), params)
        lowercase = hf.get("do_lower_case", True)
        vocab_path = os.path.join(path, "vocab.txt")
        tok_json = os.path.join(path, "tokenizer.json")
        tokenizer: Any
        if os.path.exists(vocab_path):
            tokenizer = WordPieceTokenizer.from_vocab_file(
                vocab_path, max_len=cfg.max_len, lowercase=lowercase
            )
        elif os.path.exists(tok_json):
            with open(tok_json, encoding="utf-8") as f:
                vocab = json.load(f)["model"]["vocab"]
            tokenizer = WordPieceTokenizer(vocab, max_len=cfg.max_len, lowercase=lowercase)
        else:
            import warnings

            warnings.warn(
                f"{path!r} has neither vocab.txt nor tokenizer.json: falling "
                "back to the hash tokenizer — embeddings will NOT match the "
                "reference model for these weights",
                stacklevel=2,
            )
            tokenizer = HashTokenizer(cfg.vocab_size, cfg.max_len)
        return cls(cfg, params=params, tokenizer=tokenizer, device=device)


#: safetensors dtype names → torch dtypes
_SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}


def read_safetensors(path: str) -> dict[str, torch.Tensor]:
    """A ``.safetensors`` file as CPU tensors, without the ``safetensors``
    package: an 8-byte little-endian header length, a JSON header mapping
    each name to ``dtype``, ``shape`` and ``data_offsets`` (relative to the
    end of the header), then the raw little-endian data."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 8:
        raise ValueError(f"{path!r}: not a safetensors file (shorter than its header length)")
    n = int.from_bytes(data[:8], "little")
    if 8 + n > len(data):
        raise ValueError(f"{path!r}: header of {n} bytes runs past the end of the file")
    header = json.loads(data[8 : 8 + n])
    body = memoryview(data)[8 + n :]
    out: dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _SAFETENSORS_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path!r}: tensor {name!r} has unsupported dtype {info['dtype']!r}")
        start, end = info["data_offsets"]
        shape = list(info["shape"])
        nbytes = int(np.prod(shape, dtype=np.int64)) * torch.empty((), dtype=dtype).element_size()
        if not 0 <= start <= end <= len(body) or end - start != nbytes:
            raise ValueError(f"{path!r}: tensor {name!r} has bad data_offsets {info['data_offsets']}")
        # a copy of its own bytes: aligned, writable, independent of the file
        t = torch.frombuffer(bytearray(body[start:end]), dtype=dtype) if nbytes else torch.empty(0, dtype=dtype)
        out[name] = t.reshape(shape)
    return out


def _load_state_dict(path: str) -> dict[str, torch.Tensor]:
    st_path = os.path.join(path, "model.safetensors")
    if os.path.exists(st_path):
        return read_safetensors(st_path)
    bin_path = os.path.join(path, "pytorch_model.bin")
    if os.path.exists(bin_path):
        return torch.load(bin_path, map_location="cpu", weights_only=True)
    raise FileNotFoundError(f"no model.safetensors or pytorch_model.bin under {path!r}")


def encoder_flops_per_doc(cfg: EncoderConfig, seq_len: int) -> float:
    """Matmul FLOPs of one forward pass per document."""
    d, f, L = cfg.d_model, cfg.d_ff, seq_len
    per_layer = (
        2 * L * d * (3 * d)      # qkv projection
        + 2 * L * d * d          # output projection
        + 2 * 2 * L * L * d      # attention scores + context
        + 2 * L * d * f * 2      # feed-forward up + down
    )
    return float(cfg.n_layers * per_layer)
