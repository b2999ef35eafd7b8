"""Text splitters (reference ``xpacks/llm/splitters.py:88-177``).

Splitters are UDFs: ``text -> list[(chunk, metadata)]``, flattened downstream by
the DocumentStore pipeline. ``TokenCountSplitter`` counts tokens with the
deterministic hash tokenizer (tiktoken is not a dependency; token counts are
approximate but stable), ``RecursiveSplitter`` splits on a separator hierarchy.
"""

from __future__ import annotations

import re
from typing import Any

from pathway_tpu_torch.internals.udfs import UDF


class BaseSplitter(UDF):
    pass


class NullSplitter(BaseSplitter):
    """One chunk per document (reference ``splitters.py:161``)."""

    def __init__(self, **kwargs):
        def split(text: str) -> list:
            return [(text, {})]

        super().__init__(_fn=split, return_type=list, **kwargs)


class TokenCountSplitter(BaseSplitter):
    """Greedy chunks whose token counts fall in [min_tokens, max_tokens]
    (reference ``splitters.py:177``)."""

    def __init__(self, min_tokens: int = 50, max_tokens: int = 500, encoding_name: str | None = None, **kwargs):
        self.min_tokens = min_tokens
        self.max_tokens = max_tokens

        def split(text: str) -> list:
            words = re.findall(r"\S+\s*", str(text))
            chunks: list = []
            cur: list[str] = []
            count = 0
            for w in words:
                # ~1 token per word piece; long words count proportionally
                t = max(1, len(w) // 6)
                if count + t > max_tokens and count >= min_tokens:
                    chunks.append(("".join(cur).strip(), {}))
                    cur, count = [], 0
                cur.append(w)
                count += t
            if cur:
                chunks.append(("".join(cur).strip(), {}))
            return chunks

        super().__init__(_fn=split, return_type=list, **kwargs)


class RecursiveSplitter(BaseSplitter):
    """Split on a separator hierarchy until chunks fit (reference
    ``splitters.py:88``): paragraphs → lines → sentences → words."""

    SEPARATORS = ["\n\n", "\n", ". ", " "]

    def __init__(
        self,
        chunk_size: int = 500,
        chunk_overlap: int = 0,
        separators: list[str] | None = None,
        encoding_name: str | None = None,
        model_name: str | None = None,
        **kwargs,
    ):
        seps = separators or self.SEPARATORS
        self.chunk_size = chunk_size
        self.chunk_overlap = chunk_overlap

        def measure(s: str) -> int:
            return max(1, len(s) // 4)  # ~4 chars per token

        def recurse(text: str, level: int) -> list[str]:
            if measure(text) <= chunk_size or level >= len(seps):
                return [text]
            parts = text.split(seps[level])
            out: list[str] = []
            buf = ""
            for p in parts:
                candidate = buf + (seps[level] if buf else "") + p
                if measure(candidate) <= chunk_size:
                    buf = candidate
                else:
                    if buf:
                        out.append(buf)
                    if measure(p) > chunk_size:
                        out.extend(recurse(p, level + 1))
                        buf = ""
                    else:
                        buf = p
            if buf:
                out.append(buf)
            return out

        def split(text: str) -> list:
            pieces = recurse(str(text), 0)
            out = [(p, {}) for p in pieces if p.strip()]
            if chunk_overlap > 0 and len(out) > 1:
                overlapped = []
                for i, (p, md) in enumerate(out):
                    if i > 0:
                        prev = out[i - 1][0]
                        tail = prev[-chunk_overlap * 4 :]
                        p = tail + p
                    overlapped.append((p, md))
                out = overlapped
            return out

        super().__init__(_fn=split, return_type=list, **kwargs)
