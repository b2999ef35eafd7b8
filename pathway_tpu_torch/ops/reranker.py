"""Cross-encoder reranker: the pre-LN encoder plus a linear relevance head.

Port of ``pathway_tpu/ops/reranker.py``. Query and doc are joined with the
separator token ``_SEP`` (2) after ``[CLS]`` (1), the token budget is split
between them as in the reference, all pairs run in one batch padded to a
power-of-two length bucket, and the head maps the pooled unit vector to one
f32 logit per pair. Launches go through the device plane's traced
``reranker.score`` and report their padded tokens and FLOPs; the weights are
registered as ``reranker_params`` device bytes, as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from pathway_tpu_torch._device import resolve_device
from pathway_tpu_torch.convert import ParamTree
from pathway_tpu_torch.observability import device as _dev_prof
from pathway_tpu_torch.ops.encoder import EncoderConfig, HashTokenizer, encode, init_params
from pathway_tpu_torch.ops.microbatch import LENGTH_MAX_BUCKET, bucket_size

_SEP = 2  # reserved token id between query and doc


def init_reranker_params(cfg: EncoderConfig, generator: torch.Generator) -> dict:
    params = init_params(cfg, generator)
    params["head"] = {
        "w": torch.randn(cfg.d_model, 1, generator=generator) * (cfg.d_model ** -0.5),
        "b": torch.zeros(1),
    }
    return params


def score(params, cfg: EncoderConfig, token_ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """[B, L] paired-sequence tokens → [B] relevance scores (f32 logits)."""
    pooled = encode(params, cfg, token_ids, mask)  # [B, d], unit-norm
    return (pooled @ params["head"]["w"] + params["head"]["b"]).squeeze(-1)


# device profiling plane: call/shape telemetry per reranker launch
score_jit = _dev_prof.traced_jit("reranker.score", score)


class TorchCrossEncoder(nn.Module):
    """Batched (query, doc) → relevance score model on ``device`` (default:
    the card); the API mirrors the JAX package's ``JaxCrossEncoder``."""

    def __init__(
        self,
        cfg: EncoderConfig | None = None,
        seed: int = 0,
        params: dict | None = None,
        device=None,
    ):
        super().__init__()
        self.device = resolve_device(device)
        self.cfg = cfg or EncoderConfig(n_layers=4)
        if params is None:
            params = init_reranker_params(self.cfg, torch.Generator().manual_seed(seed))
        self.params = ParamTree(params).to(self.device)
        self.tokenizer = HashTokenizer(self.cfg.vocab_size, self.cfg.max_len)
        self._param_count: int | None = None
        _dev_prof.register_memory(
            self,
            "reranker_params",
            lambda ce: sum(p.numel() * p.element_size() for p in ce.parameters()),
        )

    def pair_ids(self, pairs: list[tuple[str, str]]) -> tuple[np.ndarray, np.ndarray]:
        """``[CLS] query [SEP] doc`` ids and mask, [n, L] with L a length bucket."""
        texts_ids = []
        for q, d in pairs:
            qt = self.tokenizer._tok(q)
            dt = self.tokenizer._tok(d)
            budget = self.cfg.max_len - 2
            qt = qt[: budget // 2]
            dt = dt[: budget - len(qt)]
            texts_ids.append([1] + qt + [_SEP] + dt)
        L = min(
            self.cfg.max_len,
            bucket_size(
                max(len(t) for t in texts_ids), min_bucket=16, max_bucket=LENGTH_MAX_BUCKET
            ),
        )
        ids = np.zeros((len(pairs), L), dtype=np.int32)
        mask = np.zeros((len(pairs), L), dtype=bool)
        for i, t in enumerate(texts_ids):
            t = t[:L]
            ids[i, : len(t)] = t
            mask[i, : len(t)] = True
        return ids, mask

    @torch.inference_mode()
    def score_pairs(self, pairs: list[tuple[str, str]]) -> np.ndarray:
        if not pairs:
            return np.zeros((0,), dtype=np.float32)
        ids, mask = self.pair_ids(pairs)
        stats = _dev_prof.stats()
        if stats.enabled:
            if self._param_count is None:
                self._param_count = sum(p.numel() for p in self.parameters())
            real = int(mask.sum())
            stats.note_pad_tokens("reranker", real, ids.size - real)
            stats.note_flops("reranker", 2.0 * self._param_count * ids.size)
        out = score_jit(
            self.params, self.cfg,
            torch.from_numpy(ids).to(self.device).long(), torch.from_numpy(mask).to(self.device),
        )
        return out.cpu().numpy()
