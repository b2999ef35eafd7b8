"""Deterministic fake models for tests (reference ``xpacks/llm/mocks.py``)."""

from __future__ import annotations

from typing import Any, Callable

import numpy as np

from pathway_tpu_torch.internals.udfs import UDF


class FakeChatModel(UDF):
    """Answers with a deterministic function of the prompt; default echoes."""

    def __init__(self, answer_fn: Callable[[str], str] | None = None, **kwargs):
        fn = answer_fn or (lambda prompt: f"Answer to: {prompt}")

        def chat(messages) -> str:
            if isinstance(messages, str):
                prompt = messages
            else:
                msgs = messages.value if hasattr(messages, "value") else messages
                prompt = msgs[-1]["content"] if msgs else ""
            return fn(str(prompt))

        super().__init__(_fn=chat, return_type=str, **kwargs)


class FakeEmbedder(UDF):
    """Deterministic hash-seeded unit vectors; identical texts → identical
    embeddings across runs and hosts."""

    is_batched = True

    def __init__(self, dimension: int = 16, **kwargs):
        self._dimension = dimension

        def embed_batch(texts: list[str]) -> list[np.ndarray]:
            out = []
            for t in texts:
                h = 1469598103934665603
                for ch in str(t).encode():
                    h = ((h ^ ch) * 1099511628211) & 0xFFFFFFFFFFFFFFFF
                rng = np.random.default_rng(h % 2**32)
                v = rng.normal(size=dimension).astype(np.float32)
                out.append(v / np.linalg.norm(v))
            return out

        super().__init__(_fn=embed_batch, return_type=np.ndarray, **kwargs)

    def get_embedding_dimension(self, **kwargs) -> int:
        return self._dimension

    @property
    def dimension(self) -> int:
        return self._dimension
