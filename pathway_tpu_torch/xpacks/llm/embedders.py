"""Embedders (reference ``xpacks/llm/embedders.py:88-440``).

The reference's ``SentenceTransformerEmbedder`` calls torch ``model.encode(input)``
**once per row** (``:385-398``). Here the local model is the port's sentence
encoder (``pathway_tpu_torch/ops/encoder.py``, with the hand-written Hopper
attention kernel) behind a **batched** UDF: the engine hands the whole delta
block's texts to one forward pass (``BatchApplyExpression``), padded to
power-of-two buckets by the cross-tick microbatcher.

Remote-API embedders (OpenAI, LiteLLM, Gemini) keep the async-UDF path with
capacity/retry wrappers; they gate on their client libraries at construction
and take an injected transport (``client=`` / ``aembedding=``) in its place.

Carried from ``pathway_tpu/xpacks/llm/embedders.py``, with the memo's pod-wide
shared tier (``drain_shared_memo`` / ``apply_shared_memo``, cast by the fabric
plane between doors whose embedders share a fingerprint) and its counters on
``/status`` and ``/metrics``.
"""

from __future__ import annotations

import threading
import weakref
from collections import deque
from typing import Any

import numpy as np

from pathway_tpu_torch.internals.udfs import UDF, async_executor
from pathway_tpu_torch.xpacks.llm._utils import require

#: live memoizing embedders (weak): the observability plane reads their
#: hit/miss/evict counters and the fabric's shared-memo tier drains/feeds
#: their memos by fingerprint
_MEMO_REGISTRY: "weakref.WeakSet[SentenceTransformerEmbedder]" = weakref.WeakSet()

#: bound on locally-encoded (text, vector) pairs queued for the pod-wide
#: shared-memo cast; overflow drops oldest (sharing is best-effort)
_MEMO_SHARE_BUF = 256


def live_memo_embedders() -> list:
    """Memoizing embedders alive in this process, fingerprint-sorted."""
    return sorted(
        (e for e in list(_MEMO_REGISTRY) if e._memo_cap > 0),
        key=lambda e: e.memo_fingerprint,
    )


def memo_stats() -> list[dict]:
    """Per-embedder memo counters for ``/status`` (and the heartbeat
    piggyback): exact hits/misses/evictions plus the shared-tier traffic."""
    out = []
    for e in live_memo_embedders():
        hits, misses = e.memo_hits, e.memo_misses
        total = hits + misses
        out.append(
            {
                "fingerprint": e.memo_fingerprint,
                "capacity": e._memo_cap,
                "entries": len(e._memo),
                "hits": hits,
                "misses": misses,
                "evictions": e.memo_evictions,
                "shared_in": e.memo_shared_in,
                "shared_out": e.memo_shared_out,
                "hit_ratio": round(hits / total, 4) if total else None,
            }
        )
    return out


def memo_prometheus_lines() -> list[str]:
    """``pathway_embedder_memo_*`` exposition lines for ``/metrics``."""
    stats = memo_stats()
    if not stats:
        return []
    from pathway_tpu_torch.internals.monitoring import escape_label_value

    lines: list[str] = []
    series = (
        ("pathway_embedder_memo_hits_total", "Embedding memo hits (no device launch)", "hits", "counter"),
        ("pathway_embedder_memo_misses_total", "Embedding memo misses (freshly encoded)", "misses", "counter"),
        ("pathway_embedder_memo_evictions_total", "Embedding memo LRU evictions", "evictions", "counter"),
        ("pathway_embedder_memo_shared_in_total", "Memo entries installed from peer casts (pod-wide shared tier)", "shared_in", "counter"),
        ("pathway_embedder_memo_shared_out_total", "Locally-encoded memo entries cast to peers", "shared_out", "counter"),
        ("pathway_embedder_memo_entries", "Embedding memo resident entries", "entries", "gauge"),
        ("pathway_embedder_memo_hit_ratio", "Embedding memo hit ratio since start", "hit_ratio", "gauge"),
    )
    for name, help_text, key, mtype in series:
        lines.append(f"# HELP {name} {help_text}")
        lines.append(f"# TYPE {name} {mtype}")
        for s in stats:
            if s[key] is None:
                continue
            label = f'embedder="{escape_label_value(s["fingerprint"])}"'
            lines.append(f"{name}{{{label}}} {s[key]}")
    return lines


def drain_shared_memo(limit: int = 64) -> dict[str, list]:
    """Fabric tick-end hook: pop up to ``limit`` freshly-encoded (text,
    vector) pairs per embedder, keyed by fingerprint, for the replica cast."""
    out: dict[str, list] = {}
    for e in live_memo_embedders():
        entries = e.drain_shared_out(limit)
        if entries:
            out.setdefault(e.memo_fingerprint, []).extend(entries)
    return out


def apply_shared_memo(fingerprint: str, entries: list) -> int:
    """Fabric cast-receive hook: install a peer's memo entries into every
    local embedder with a MATCHING fingerprint (same architecture + seed —
    the vectors would be recomputed identically here, so installing them is
    the pod-wide 'hot query set embeds once' win). Returns installs."""
    n = 0
    for e in live_memo_embedders():
        if e.memo_fingerprint == fingerprint:
            n += e.apply_shared(entries)
    return n




class BaseEmbedder(UDF):
    """Text → vector UDF; exposes the embedding dimension for index factories."""

    def get_embedding_dimension(self, **kwargs) -> int:
        raise NotImplementedError

    @property
    def dimension(self) -> int:
        return self.get_embedding_dimension()


class SentenceTransformerEmbedder(BaseEmbedder):
    """The port's sentence encoder on ``device`` (default: the card); batched
    per delta block.

    ``model`` selects an :class:`~pathway_tpu_torch.ops.encoder.EncoderConfig` preset
    (``"minilm"`` 384-d default) or accepts a config instance. Weights are
    deterministic from ``seed`` through the port's own initialiser, which
    cannot reproduce the JAX package's ``jax.random`` draw: to run the
    reference's weights, pass ``params=`` (a tree converted by
    ``pathway_tpu_torch.convert.params_from_numpy``).
    """

    is_batched = True
    # cross-tick microbatcher knobs: 512 is the measured-best device batch
    # (measured on the reference's TPU); buckets below 8 waste the device
    microbatch_max_batch = 512
    microbatch_min_bucket = 8

    _PRESETS = {
        "minilm": dict(d_model=384, n_heads=6, n_layers=6, d_ff=1536),
        "small": dict(d_model=256, n_heads=4, n_layers=4, d_ff=1024),
        "tiny": dict(d_model=128, n_heads=4, n_layers=2, d_ff=512),
    }

    def __init__(
        self,
        model: Any = "minilm",
        *,
        seed: int = 0,
        params: Any = None,
        memoize: int = 0,
        device=None,
        **kwargs,
    ):
        from collections import OrderedDict

        from pathway_tpu_torch.ops.encoder import EncoderConfig, TorchSentenceEncoder

        if isinstance(model, EncoderConfig):
            cfg = model
        else:
            preset = self._PRESETS.get(str(model), self._PRESETS["minilm"])
            cfg = EncoderConfig(**preset)
        self._encoder = TorchSentenceEncoder(cfg, seed=seed, params=params, device=device)
        encoder = self._encoder
        # serving-tier embedding memo (``memoize`` = LRU entry bound, 0 = off):
        # a text seen before returns its stored vector without a device launch.
        # In a RAG serving loop this removes the rerank stage's re-encode of
        # corpus documents and collapses microbatch pad replicas (pads
        # duplicate real rows, so in-batch dedupe encodes them once). Opt-in:
        # the encoder's length-bucketing pads by batch composition, so a
        # memoized vector can differ in final float bits from a fresh
        # mixed-length batch — the same recompute caveat ``deterministic``
        # already accepts, but off by default to keep r6-era runs bit-stable.
        self._memo: "OrderedDict[str, np.ndarray]" = OrderedDict()
        self._memo_cap = max(0, int(memoize))
        self.memo_hits = 0
        self.memo_misses = 0
        self.memo_evictions = 0
        # pod-wide shared tier: vectors THIS process encoded, queued for the
        # fabric's replica cast; peers with the same fingerprint install them
        # so a hot query embeds once per pod, not once per door
        self.memo_shared_in = 0
        self.memo_shared_out = 0
        self._memo_share_buf: "deque[tuple[str, np.ndarray]]" = deque(maxlen=_MEMO_SHARE_BUF)
        self._memo_lock = threading.Lock()
        # fingerprint = everything the forward pass depends on: two embedders
        # agree on it iff they produce identical vectors for identical
        # single-text launches. The reference's fields under the port's own
        # prefix: vectors of the two packages are not interchangeable bit for
        # bit
        self.memo_fingerprint = (
            f"torchst:{cfg.d_model}x{cfg.n_layers}x{cfg.n_heads}x{cfg.d_ff}"
            f":s{seed}:{'p' if params is not None else 'd'}"
        )
        _MEMO_REGISTRY.add(self)

        def embed_batch(texts: list[str]) -> list[np.ndarray]:
            texts = [str(t) for t in texts]
            if not self._memo_cap:
                return list(encoder.encode_texts(texts))
            memo = self._memo
            out: list[Any] = [None] * len(texts)
            want: dict[str, list[int]] = {}
            for i, t in enumerate(texts):
                v = memo.get(t)
                if v is not None:
                    memo.move_to_end(t)
                    out[i] = v
                    self.memo_hits += 1
                else:
                    want.setdefault(t, []).append(i)
            if want:
                from pathway_tpu_torch.ops.microbatch import bucket_size

                miss_texts = list(want)
                self.memo_misses += len(miss_texts)
                # re-pad the deduped misses to power-of-two buckets, chunked
                # at the microbatch launch cap: callers (the microbatch
                # dispatcher) padded THEIR batch, but dedupe shrank it to the
                # unique count — an arbitrary (or oversized) batch dim would
                # grow the encoder's launch shape set without bound
                cap = int(getattr(self, "microbatch_max_batch", 512))
                for lo in range(0, len(miss_texts), cap):
                    chunk = miss_texts[lo : lo + cap]
                    m = len(chunk)
                    padded = bucket_size(m, min_bucket=8, max_bucket=cap)
                    launch = chunk + [chunk[0]] * (padded - m)
                    for t, v in zip(chunk, encoder.encode_texts(launch)[:m]):
                        v = np.asarray(v)
                        for i in want[t]:
                            out[i] = v
                        memo[t] = v
                        self._memo_share_buf.append((t, v))
                while len(memo) > self._memo_cap:
                    memo.popitem(last=False)
                    self.memo_evictions += 1
            return out

        # deterministic: fixed weights, pure forward pass — lets the
        # microbatch node recompute retract rows instead of remembering
        # every emitted embedding
        kwargs.setdefault("deterministic", True)
        super().__init__(_fn=embed_batch, return_type=np.ndarray, **kwargs)

    def get_embedding_dimension(self, **kwargs) -> int:
        return self._encoder.dimension

    # ---------------------------------------------------- pod-wide shared tier
    def drain_shared_out(self, limit: int = 64) -> list[tuple[str, list[float]]]:
        """Pop up to ``limit`` locally-encoded (text, vector-as-list) pairs
        for the fabric cast (vectors jsonified — the transport is msgpack'd
        JSON-ish; peers re-materialize float32)."""
        out: list[tuple[str, list[float]]] = []
        with self._memo_lock:
            while self._memo_share_buf and len(out) < limit:
                t, v = self._memo_share_buf.popleft()
                out.append((t, np.asarray(v, dtype=np.float32).tolist()))
        self.memo_shared_out += len(out)
        return out

    def apply_shared(self, entries: list) -> int:
        """Install peer-encoded vectors. Peer entries never re-enter the
        share buffer (no echo loops) and never displace locally-verified
        entries (insert-if-absent), so a pod of doors converges instead of
        thrashing. Returns how many were new."""
        if not self._memo_cap:
            return 0
        memo = self._memo
        n = 0
        with self._memo_lock:
            for ent in entries:
                t, v = str(ent[0]), ent[1]
                if t in memo:
                    continue
                memo[t] = np.asarray(v, dtype=np.float32)
                n += 1
            while len(memo) > self._memo_cap:
                memo.popitem(last=False)
                self.memo_evictions += 1
        self.memo_shared_in += n
        return n


class OpenAIEmbedder(BaseEmbedder):
    """Remote OpenAI embeddings (reference ``embedders.py:88``); async UDF.
    ``client=`` injects an OpenAI-shaped transport (the wrapper's
    request/parse/retry plumbing runs against canned responses in tests)."""

    def __init__(
        self,
        model: str = "text-embedding-3-small",
        capacity: int | None = None,
        retry_strategy: Any = None,
        cache_strategy: Any = None,
        client: Any = None,
        **openai_kwargs,
    ):
        if client is None:
            require("openai", "OpenAIEmbedder")
            import openai

            client = openai.AsyncOpenAI(
                **{k: v for k, v in openai_kwargs.items() if k in ("api_key", "base_url")}
            )
        self.model = model
        extra = {k: v for k, v in openai_kwargs.items() if k not in ("api_key", "base_url")}

        async def embed(text: str) -> np.ndarray:
            r = await client.embeddings.create(input=[text or "."], model=model, **extra)
            return np.asarray(r.data[0].embedding, dtype=np.float32)

        super().__init__(
            _fn=embed,
            return_type=np.ndarray,
            executor=async_executor(capacity=capacity, retry_strategy=retry_strategy),
            cache_strategy=cache_strategy,
        )

    def get_embedding_dimension(self, **kwargs) -> int:
        return {"text-embedding-3-small": 1536, "text-embedding-3-large": 3072,
                "text-embedding-ada-002": 1536}.get(self.model, 1536)


class LiteLLMEmbedder(BaseEmbedder):
    def __init__(
        self,
        model: str,
        capacity: int | None = None,
        retry_strategy: Any = None,
        cache_strategy: Any = None,
        aembedding: Any = None,
        **kwargs,
    ):
        if aembedding is None:
            require("litellm", "LiteLLMEmbedder")
            import litellm

            aembedding = litellm.aembedding

        async def embed(text: str) -> np.ndarray:
            r = await aembedding(model=model, input=[text or "."], **kwargs)
            return np.asarray(r.data[0]["embedding"], dtype=np.float32)

        super().__init__(
            _fn=embed,
            return_type=np.ndarray,
            executor=async_executor(capacity=capacity, retry_strategy=retry_strategy),
            cache_strategy=cache_strategy,
        )


class GeminiEmbedder(BaseEmbedder):
    def __init__(
        self,
        model: str = "models/embedding-001",
        capacity: int | None = None,
        retry_strategy: Any = None,
        cache_strategy: Any = None,
        client: Any = None,
        **kwargs,
    ):
        if client is None:
            require("google.generativeai", "GeminiEmbedder")
            import google.generativeai as client  # noqa: F811 — module as client

        async def embed(text: str) -> np.ndarray:
            r = client.embed_content(model=model, content=text or ".", **kwargs)
            return np.asarray(r["embedding"], dtype=np.float32)

        super().__init__(
            _fn=embed,
            return_type=np.ndarray,
            executor=async_executor(capacity=capacity, retry_strategy=retry_strategy),
            cache_strategy=cache_strategy,
        )
