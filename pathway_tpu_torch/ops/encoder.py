"""Pre-LN transformer sentence encoder in PyTorch.

Port of the pre-LN half of ``pathway_tpu/ops/encoder.py``: token and position
embeddings, per layer LN → QKV → attention → output projection + residual →
LN → tanh-GELU FFN + residual, a final LN, masked mean pooling in f32 and an
L2 norm. Matrices are ``[in, out]`` (``x @ W``) as in the JAX package, and
activations run in ``cfg.dtype`` (bf16 on the main path) with the weights cast
to it at use. Every attention goes through
:func:`~pathway_tpu_torch.ops.attention_kernel.attention_short_flat`: the
Hopper kernel on the card, its plain version on the CPU.

The exact BERT block (``arch="bert"``, HuggingFace checkpoints) is a later
slice of the port.
"""

from __future__ import annotations

import functools
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pathway_tpu_torch._device import resolve_device
from pathway_tpu_torch.convert import ParamTree, tree_map
from pathway_tpu_torch.native import try_load as _try_load_native
from pathway_tpu_torch.ops._fixed_order import fixed_order_sum
from pathway_tpu_torch.ops.attention_kernel import attention_short_flat
from pathway_tpu_torch.ops.microbatch import LENGTH_MAX_BUCKET, bucket_size


class EncoderConfig(NamedTuple):
    vocab_size: int = 32768
    d_model: int = 384
    n_heads: int = 6
    n_layers: int = 6
    d_ff: int = 1536
    max_len: int = 512
    dtype: torch.dtype = torch.bfloat16
    #: "preln" is the framework's own block; "bert" (HuggingFace checkpoints)
    #: is not ported yet
    arch: str = "preln"


def _check_arch(cfg: EncoderConfig) -> None:
    if cfg.arch != "preln":
        raise NotImplementedError(
            f"arch={cfg.arch!r}: the BERT block and from_pretrained are a later slice"
        )


def init_params(cfg: EncoderConfig, generator: torch.Generator) -> dict:
    """Random f32 parameter tree ``{embed, pos, layers: [..], ln_f}`` on the
    CPU, drawn from ``generator`` (the JAX package's init scales; the numbers
    themselves differ, as any two generators do)."""
    _check_arch(cfg)
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
    q, k, v = (x @ wqkv.to(x.dtype)).split(D, dim=-1)
    ctx = attention_short_flat(q, k, v, mask, n_heads, (D // n_heads) ** -0.5)
    return ctx @ wo.to(x.dtype)


def hidden_states(params, cfg: EncoderConfig, token_ids: torch.Tensor, mask: torch.Tensor):
    """The layers and the final LN: [B, L] tokens + bool mask → [B, L,
    d_model] in ``cfg.dtype``."""
    _check_arch(cfg)
    x = params["embed"][token_ids].to(cfg.dtype)
    L = token_ids.shape[1]
    x = x + params["pos"][:L][None, :, :].to(cfg.dtype)
    for layer in params["layers"]:
        h = _layer_norm(x, layer["ln1"]["g"], layer["ln1"]["b"])
        x = x + _attention(h, layer["wqkv"], layer["wo"], mask, cfg.n_heads)
        h = _layer_norm(x, layer["ln2"]["g"], layer["ln2"]["b"])
        h = F.gelu(h @ layer["w1"].to(x.dtype), approximate="tanh")
        x = x + (h @ layer["w2"].to(x.dtype))
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


class TorchSentenceEncoder(nn.Module):
    """Batched text → embedding model: tokenizer plus the pre-LN forward on
    ``device`` (default: the card). The API mirrors the JAX package's
    ``JaxSentenceEncoder``. ``param_dtype`` stores the matrices in that type
    (bf16 on the main path) while norms stay f32."""

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
        _check_arch(self.cfg)
        if params is None:
            params = init_params(self.cfg, torch.Generator().manual_seed(seed))
        if param_dtype is not None:
            params = tree_map(lambda p: p.to(param_dtype) if p.ndim >= 2 else p, params)
        self.param_dtype = param_dtype
        self.params = ParamTree(params).to(self.device)
        self.tokenizer = tokenizer or HashTokenizer(self.cfg.vocab_size, self.cfg.max_len)

    @property
    def dimension(self) -> int:
        return self.cfg.d_model

    def param_count(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def param_bytes(self) -> int:
        return sum(p.numel() * p.element_size() for p in self.parameters())

    def forward(self, token_ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        return encode(self.params, self.cfg, token_ids, mask)

    def _ids(self, ids) -> torch.Tensor:
        if isinstance(ids, np.ndarray):
            ids = torch.from_numpy(ids)
        return ids.to(self.device)

    @torch.inference_mode()
    def encode_ids_device(self, ids: np.ndarray | torch.Tensor) -> torch.Tensor:
        """Pre-tokenized ids (pad id 0) → embeddings on the device."""
        return encode_ids(self.params, self.cfg, self._ids(ids))

    @torch.inference_mode()
    def encode_texts_device(self, texts: list[str]) -> torch.Tensor:
        """Like :meth:`encode_texts` but returns the device tensor without a
        host sync. Only the narrow id array crosses to the device when the
        tokenizer's pad id is 0; otherwise its mask is shipped too."""
        ids, mask = self.tokenizer(texts)
        if getattr(self.tokenizer, "pad_id_zero", False):
            return encode_ids(self.params, self.cfg, self._ids(ids))
        return encode(self.params, self.cfg, self._ids(ids).long(), self._ids(mask))

    def encode_texts(self, texts: list[str]) -> np.ndarray:
        if not texts:
            return np.zeros((0, self.cfg.d_model), dtype=np.float32)
        return self.encode_texts_device(texts).cpu().numpy()

    @torch.inference_mode()
    def encode_tokens(self, ids: np.ndarray, mask: np.ndarray) -> np.ndarray:
        out = encode(self.params, self.cfg, self._ids(ids).long(), self._ids(mask))
        return out.cpu().numpy()


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
