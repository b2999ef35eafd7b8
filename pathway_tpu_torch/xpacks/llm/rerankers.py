"""Rerankers (reference ``xpacks/llm/rerankers.py:59-292``).

``CrossEncoderReranker``: the reference runs one torch
``model.predict([[query, doc]])`` per row; here the port's cross-encoder
(``pathway_tpu_torch/ops/reranker.py``, with the hand-written Hopper attention
kernel) sits behind a batched UDF. ``EncoderReranker`` (bi-encoder dot
product) keeps the reference semantics.

Carried from ``pathway_tpu/xpacks/llm/rerankers.py``; ``LLMReranker`` and
``rerank_topk_filter`` are a later slice, with the LLM wiring.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from pathway_tpu_torch.internals.udfs import UDF


class CrossEncoderReranker(UDF):
    """``model``: a ``TorchCrossEncoder``, an ``EncoderConfig`` or None (the
    default configuration). Weights come from ``seed`` through the port's own
    initialiser unless ``params=`` (converted by
    ``pathway_tpu_torch.convert.params_from_numpy``) is given; the model runs
    on ``device`` (default: the card)."""

    is_batched = True
    # cross-tick microbatcher knobs (see embedders.SentenceTransformerEmbedder)
    microbatch_max_batch = 512
    microbatch_min_bucket = 8

    def __init__(
        self, model: Any = None, *, seed: int = 0, params: Any = None, device=None, **kwargs
    ):
        from pathway_tpu_torch.ops.reranker import TorchCrossEncoder

        if isinstance(model, TorchCrossEncoder):
            ce = model
        else:
            ce = TorchCrossEncoder(model, seed=seed, params=params, device=device)
        self._model = ce

        def score_batch(docs: list[str], queries: list[str]) -> list[float]:
            pairs = [(str(q), str(d)) for q, d in zip(queries, docs)]
            return [float(s) for s in ce.score_pairs(pairs)]

        kwargs.setdefault("deterministic", True)  # fixed weights, pure forward
        super().__init__(_fn=score_batch, return_type=float, **kwargs)


class EncoderReranker(UDF):
    """Bi-encoder similarity: embed query and doc, score by dot product
    (reference ``rerankers.py:224``)."""

    is_batched = True
    microbatch_max_batch = 512
    microbatch_min_bucket = 8

    def __init__(self, embedder, **kwargs):
        if not getattr(embedder, "is_batched", False):
            raise TypeError(
                "EncoderReranker needs a batched local embedder (e.g. "
                "SentenceTransformerEmbedder); async/remote embedders can't be "
                "driven synchronously inside the scoring batch"
            )
        self.embedder = embedder
        embed = embedder.func  # raw batch callable (texts -> vectors)

        def score_batch(docs: list[str], queries: list[str]) -> list[float]:
            # one combined launch for docs + queries: half the padded-bucket
            # dispatches of two separate embed calls, and the bigger batch
            # runs closer to the device's best rate
            n = len(docs)
            vecs = np.stack(
                embed([str(d) for d in docs] + [str(q) for q in queries])
            )
            return [float(x) for x in np.sum(vecs[:n] * vecs[n:], axis=-1)]

        kwargs.setdefault("deterministic", True)  # fixed weights, pure forward
        super().__init__(_fn=score_batch, return_type=float, **kwargs)
