"""Rerankers (reference ``xpacks/llm/rerankers.py:59-292``).

``CrossEncoderReranker``: the reference runs one torch
``model.predict([[query, doc]])`` per row; here the port's cross-encoder
(``pathway_tpu_torch/ops/reranker.py``, with the hand-written Hopper attention
kernel) sits behind a batched UDF. ``LLMReranker`` (LLM-as-judge 1–5
scoring), ``EncoderReranker`` (bi-encoder dot product) and
``rerank_topk_filter`` keep the reference semantics.

Carried from ``pathway_tpu/xpacks/llm/rerankers.py``.
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


class LLMReranker(UDF):
    """LLM-as-judge relevance scoring 1-5 (reference ``rerankers.py:59``)."""

    PROMPT = (
        "Given a query and a document, rate on an integer scale of 1 to 5 how "
        "relevant the document is to the query. Answer with ONLY the number.\n"
        "Query: {query}\nDocument: {doc}\nRating:"
    )

    def __init__(self, llm, *, retry_strategy=None, **kwargs):
        import asyncio
        import re

        from pathway_tpu_torch.internals.udfs import AsyncExecutor

        self.llm = llm
        # the wrapped callable keeps the chat's capacity/timeout/cache wrappers
        chat = llm._callable()
        prompt_tmpl = self.PROMPT
        if retry_strategy is not None and asyncio.iscoroutinefunction(chat):
            chat = AsyncExecutor(retry_strategy=retry_strategy).wrap(chat)

        def parse_rating(answer) -> float:
            m = re.search(r"[1-5]", str(answer))
            if m is None:
                raise ValueError(f"reranker LLM returned no 1-5 rating: {answer!r}")
            return float(m.group())

        if asyncio.iscoroutinefunction(chat):

            async def score(doc: str, query: str) -> float:
                answer = await chat(
                    [{"role": "user", "content": prompt_tmpl.format(query=query, doc=doc)}]
                )
                return parse_rating(answer)

        else:

            def score(doc: str, query: str) -> float:
                answer = chat(
                    [{"role": "user", "content": prompt_tmpl.format(query=query, doc=doc)}]
                )
                return parse_rating(answer)

        super().__init__(_fn=score, return_type=float, **kwargs)


def rerank_topk_filter(docs: Any, scores: Any, k: int = 5):
    """Keep the top-k docs by score (reference ``rerankers.py`` util). Returns
    (docs_tuple, scores_tuple)."""
    order = sorted(range(len(scores)), key=lambda i: -scores[i])[:k]
    return tuple(docs[i] for i in order), tuple(scores[i] for i in order)
