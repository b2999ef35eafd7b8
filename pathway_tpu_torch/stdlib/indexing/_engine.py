"""External-index engine node + index backends.

Counterpart of the reference's ``use_external_index_as_of_now`` machinery
(``src/engine/dataflow/operators/external_index.rs:81`` + ``external_integration/``):
the index lives OUTSIDE the incremental state, updated by the doc stream's
additions/retractions and queried per query row. Two query disciplines:

- **as-of-now** (reference behavior): each query is answered against the index
  state at its arrival tick and the answer is never revised; query retractions
  retract their answers.
- **consistent** (reference's pure-dataflow LshKnn ``query``): answers are kept
  up to date — when docs change, all live queries are re-answered and deltas
  emitted. On TPU this is the natural mode for the brute-force index: re-answering
  every query is ONE batched einsum (``ops/knn.py``), not a per-query loop.

Carried from ``pathway_tpu/stdlib/indexing/_engine.py`` with one backend,
``VectorBackend`` over the port's ``ops/knn.py`` index on the card. The
reference's BM25 and LSH backends are a later slice, and so are the hooks this
node has into planes not ported yet: persistence's incremental index
snapshots, the fabric's replica feed and the request plane's search stage.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np

from pathway_tpu_torch.engine.blocks import DeltaBatch
from pathway_tpu_torch.engine.graph import Node
from pathway_tpu_torch.internals.keys import tie_order
from pathway_tpu_torch.stdlib.indexing._filters import compile_filter


class IndexBackend:
    """add/remove/search over (key, item, metadata) triples."""

    def add(self, key: int, item: Any, metadata: Any) -> None:
        raise NotImplementedError

    def remove(self, key: int) -> None:
        raise NotImplementedError

    def search(
        self, items: list[Any], ks: list[int], filters: list[Callable[[Any], bool]]
    ) -> list[list[tuple[int, float]]]:
        """Per query: top-k (doc_key, score) pairs, best (highest score) first."""
        raise NotImplementedError


def overfetch(kmax: int, n_live: int) -> int:
    """Candidate over-fetch so post-filtering still fills k (filters are rare
    and the einsum cost is independent of k). Rounded up to a power of two:
    ``k`` is a static jit argument of the search kernels, so an unquantized
    fetch would compile a fresh kernel every time the live-row count moves.
    Shared by VectorBackend and the tiered backend — one factor to tune."""
    fetch = min(n_live, max(kmax * 10, kmax))
    return 1 << max(0, (fetch - 1)).bit_length() if fetch else 0


class VectorBackend(IndexBackend):
    """Dense KNN over the device-resident brute-force index (ops/knn.py).
    ``device=None`` means the card, as for every entry point of the port."""

    #: KNN scores are shard-independent: per-shard top-k partials merge exactly
    shardable = True

    def __init__(
        self, dimension: int, metric: str = "cos", reserved_space: int = 1024, device=None
    ):
        from pathway_tpu_torch.ops.knn import BruteForceKnnIndex

        self.index = BruteForceKnnIndex(
            dimension=dimension,
            metric=metric,
            capacity=max(reserved_space, 128),
            device=device,
        )
        self.metadata: dict[int, Any] = {}

    def add(self, key, item, metadata):
        self.index.add(key, np.asarray(item, dtype=np.float32))
        self.metadata[key] = metadata

    def remove(self, key):
        self.index.remove(key)
        self.metadata.pop(key, None)

    def search(self, items, ks, filters):
        if not items:
            return []
        n_live = len(self.index)
        if n_live == 0:
            return [[] for _ in items]
        kmax = max(ks, default=0)
        fetch = overfetch(kmax, n_live)
        batch = np.stack([np.asarray(q, dtype=np.float32) for q in items])
        raw = self.index.search(batch, fetch)
        out = []
        for hits, k, flt in zip(raw, ks, filters):
            picked = []
            for key, score in hits:
                if len(picked) >= k:
                    break
                if flt(self.metadata.get(key)):
                    picked.append((key, float(score)))
            out.append(picked)
        return out


class ExternalIndexNode(Node):
    """input0 = docs (item, metadata); input1 = queries (item, k, filter).

    With a shardable backend (KNN), docs shard by key across workers and
    queries BROADCAST to every shard: each instance answers over its local
    shard and emits a PARTIAL reply row (killing the r2 worker-0 serialization
    of the FLOP-heavy index — reference ``operators/external_index.rs:81`` runs
    on one worker; this fans out). ``MergeIndexRepliesNode`` downstream merges
    partials into the final per-query reply. Non-shardable backends keep the
    SOLO placement; their single partial passes through the same merge.
    """

    name = "external_index"

    # _filter_cache (compiled callables) is rebuilt lazily, not persisted
    snapshot_attrs = ("_live_queries", "_emitted", "_tok")

    def exchange_key(self, port):
        from pathway_tpu_torch.engine.graph import BROADCAST, SOLO

        if not getattr(self.backend, "shardable", False):
            return SOLO
        if port == 0:
            return lambda batch: batch.keys  # docs shard by key
        return BROADCAST  # queries fan out to every doc shard

    def __init__(self, backend_factory: Callable[[], IndexBackend], as_of_now: bool):
        super().__init__(n_inputs=2)
        self.backend = backend_factory()
        self.as_of_now = as_of_now
        self._live_queries: dict[int, tuple[Any, int, str | None]] = {}
        self._emitted: dict[int, tuple] = {}  # query key -> partial tuple emitted
        self._filter_cache: dict[str | None, Callable] = {}
        # identifies THIS shard's partials in the merge state (stable within a
        # run; snapshotted so operator persistence keeps partials addressable)
        import os as _os

        self._tok = int.from_bytes(_os.urandom(8), "little")

    def _filter(self, expr):
        if expr not in self._filter_cache:
            try:
                compiled = compile_filter(expr)

                def safe(md, _f=compiled):
                    # evaluation errors (type mismatches against this doc's
                    # metadata) exclude the doc, never kill the dataflow
                    try:
                        return bool(_f(md))
                    except Exception:
                        return False

                self._filter_cache[expr] = safe
            except Exception:
                # a malformed user-supplied filter poisons only its own query
                # (empty reply), never the dataflow — one bad HTTP request must
                # not kill the server
                self._filter_cache[expr] = None
        return self._filter_cache[expr]

    def _answer(self, keys: list[int]) -> list[tuple]:
        qs = [self._live_queries[k] for k in keys]
        filters = [self._filter(q[2]) for q in qs]
        good = [i for i, f in enumerate(filters) if f is not None]
        replies: list[tuple] = [()] * len(qs)  # bad-filter queries reply empty
        if good:
            answered = self.backend.search(
                [qs[i][0] for i in good],
                [qs[i][1] for i in good],
                [filters[i] for i in good],
            )
            for i, r in zip(good, answered):
                replies[i] = tuple(r)
        return replies

    def process(self, inputs, time):
        docs, queries = inputs
        docs_changed = False
        if docs is not None:
            # removals first: consolidation may reorder a same-key (-1, +1)
            # upsert pair arbitrarily, and remove() is keyed by key alone — an
            # add-then-remove ordering would silently drop the updated doc
            for i in range(len(docs)):
                if docs.diffs[i] < 0:
                    self.backend.remove(int(docs.keys[i]))
            for i in range(len(docs)):
                if docs.diffs[i] > 0:
                    self.backend.add(
                        int(docs.keys[i]), docs.data["__item"][i], docs.data["__meta"][i]
                    )
            docs_changed = len(docs) > 0

        out_keys: list[int] = []
        out_diffs: list[int] = []
        out_rows: list[tuple] = []

        def emit(k, reply, query_k, diff):
            out_keys.append(k)
            out_diffs.append(diff)
            out_rows.append((reply, query_k, self._tok))

        new_queries: list[int] = []
        if queries is not None:
            for i in range(len(queries)):  # removals first (see docs loop)
                if queries.diffs[i] < 0:
                    k = int(queries.keys[i])
                    self._live_queries.pop(k, None)
                    old = self._emitted.pop(k, None)
                    if old is not None:
                        emit(k, old[0], old[1], -1)
            for i in range(len(queries)):
                if queries.diffs[i] > 0:
                    k = int(queries.keys[i])
                    self._live_queries[k] = (
                        queries.data["__item"][i],
                        int(queries.data["__k"][i]),
                        queries.data["__filter"][i]
                        if "__filter" in queries.data
                        else None,
                    )
                    new_queries.append(k)

        if self.as_of_now:
            to_answer = new_queries
        else:
            # consistent mode: docs changed → re-answer every live query (one
            # batched search — TPU-friendly), else just the new ones
            to_answer = list(self._live_queries) if docs_changed else new_queries
        if to_answer:
            replies = self._answer(to_answer)
            for k, reply in zip(to_answer, replies):
                query_k = self._live_queries[k][1]
                old = self._emitted.get(k)
                if old is not None and old[0] == reply:
                    continue
                if old is not None:
                    emit(k, old[0], old[1], -1)
                emit(k, reply, query_k, +1)
                self._emitted[k] = (reply, query_k)
        if self.as_of_now:
            # answered queries need no further tracking (they are never revised)
            for k in to_answer:
                self._live_queries.pop(k, None)
        if not out_keys:
            return []
        return [
            DeltaBatch.from_rows(
                out_keys, out_rows, ["__part", "__k", "__tok"], time, diffs=out_diffs
            )
        ]


class MergeIndexRepliesNode(Node):
    """Merges per-shard partial replies into each query's final top-k.

    Keyed (and shard-exchanged) by the QUERY key, so the merge itself scales
    across workers too — no SOLO stage anywhere in the index path. Partials
    accumulate per (query, shard-token); at the frontier every touched query
    re-merges: sort the union by (score desc, doc-key asc), cut to the query's
    k, and emit the delta against the previously-emitted reply.
    """

    name = "index_merge"

    snapshot_attrs = ("state",)

    def __init__(self):
        super().__init__(n_inputs=1)
        # qk -> {"parts": {tok: (partial, k)}, "emitted": tuple | None}
        self.state: dict[int, dict] = {}
        self._touched: set[int] = set()

    def process(self, inputs, time):
        batch = inputs[0]
        if batch is None or not len(batch):
            return []
        parts = batch.data["__part"]
        ks = batch.data["__k"]
        toks = batch.data["__tok"]
        for i in range(len(batch)):
            qk = int(batch.keys[i])
            tok = int(toks[i])
            st = self.state.setdefault(qk, {"parts": {}, "emitted": None})
            if batch.diffs[i] > 0:
                st["parts"][tok] = (parts[i], int(ks[i]))
            else:
                st["parts"].pop(tok, None)
            self._touched.add(qk)
        return []

    def on_frontier(self, time):
        if not self._touched:
            return []
        out_keys: list[int] = []
        out_diffs: list[int] = []
        out_rows: list[tuple] = []
        for qk in sorted(self._touched):
            st = self.state.get(qk)
            if st is None:
                continue
            if st["parts"]:
                k = max(kk for (_p, kk) in st["parts"].values())
                pairs = [p for (part, _kk) in st["parts"].values() for p in part]
                pairs.sort(key=lambda ds: (-float(ds[1]), tie_order(int(ds[0]))))
                merged: tuple | None = tuple(pairs[:k])
            else:
                merged = None  # every shard retracted: the query is gone
            old = st["emitted"]
            if merged == old:
                if merged is None:
                    # insert+retract within one tick (or all shards retracted
                    # before the first merge): nothing was ever emitted — drop
                    # the entry instead of leaking {'parts': {}, 'emitted': None}
                    del self.state[qk]
                continue
            if old is not None:
                out_keys.append(qk)
                out_diffs.append(-1)
                out_rows.append((old,))
            if merged is not None:
                out_keys.append(qk)
                out_diffs.append(1)
                out_rows.append((merged,))
                st["emitted"] = merged
            else:
                del self.state[qk]
        self._touched = set()
        if not out_keys:
            return []
        return [
            DeltaBatch.from_rows(
                out_keys, out_rows, ["_pw_index_reply"], time, diffs=out_diffs
            )
        ]
