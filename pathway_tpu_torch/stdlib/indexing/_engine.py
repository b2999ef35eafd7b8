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

Carried from ``pathway_tpu/stdlib/indexing/_engine.py``. Backends:
``VectorBackend`` (the port's ``ops/knn.py`` index on the card),
``BM25Backend`` (host-side inverted index — memory-bound, not FLOP-bound, so
it stays on the host like the reference's tantivy) and ``LshVectorBackend``
(host LSH buckets, exact scores). A search records the request plane's
``index/search`` stage while a request is in flight. ``ExternalIndexNode``
snapshots its backend O(delta) under operator persistence (a compacted base
plus the mutation log since, ``PATHWAY_INDEX_SNAPSHOT`` and
``PATHWAY_INDEX_COMPACT_FRAC``), as the reference does; restoring replays the
deltas through ``backend.add``/``remove``, so a brute-force index on the card
gets the live index's slot assignment back. Under an armed retrieval route
each node feeds its backend mutations to the fabric's replica index
(``fabric/index_replica.py``).
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Any, Callable

import numpy as np

from pathway_tpu_torch.engine.blocks import DeltaBatch
from pathway_tpu_torch.engine.graph import Node
from pathway_tpu_torch.internals.keys import tie_order, tie_order_u64
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


class BM25Backend(IndexBackend):
    """Okapi BM25 over a host-side inverted index (k1=1.2, b=0.75)."""

    K1 = 1.2
    B = 0.75

    #: BM25 idf depends on GLOBAL corpus statistics; per-shard scores would
    #: change results, so this backend stays on one worker
    shardable = False

    def __init__(self):
        self.docs: dict[int, dict[str, int]] = {}
        self.metadata: dict[int, Any] = {}
        self.doc_len: dict[int, int] = {}
        self.postings: dict[str, dict[int, int]] = defaultdict(dict)
        self.total_len = 0

    @staticmethod
    def _tokens(text: str) -> list[str]:
        import re

        return re.findall(r"[a-z0-9]+", str(text).lower())

    def add(self, key, item, metadata):
        toks = self._tokens(item)
        tf: dict[str, int] = defaultdict(int)
        for t in toks:
            tf[t] += 1
        self.docs[key] = dict(tf)
        self.metadata[key] = metadata
        self.doc_len[key] = len(toks)
        self.total_len += len(toks)
        for t, c in tf.items():
            self.postings[t][key] = c

    def remove(self, key):
        tf = self.docs.pop(key, None)
        if tf is None:
            return
        self.metadata.pop(key, None)
        self.total_len -= self.doc_len.pop(key, 0)
        for t in tf:
            self.postings[t].pop(key, None)
            if not self.postings[t]:
                del self.postings[t]

    def search(self, items, ks, filters):
        n = len(self.docs)
        out = []
        avgdl = (self.total_len / n) if n else 1.0
        for query, k, flt in zip(items, ks, filters):
            scores: dict[int, float] = defaultdict(float)
            for t in self._tokens(query):
                posting = self.postings.get(t)
                if not posting:
                    continue
                idf = math.log(1 + (n - len(posting) + 0.5) / (len(posting) + 0.5))
                for key, tf in posting.items():
                    dl = self.doc_len[key] or 1
                    scores[key] += (
                        idf
                        * tf
                        * (self.K1 + 1)
                        / (tf + self.K1 * (1 - self.B + self.B * dl / avgdl))
                    )
            ranked = sorted(scores.items(), key=lambda kv: (-kv[1], tie_order(kv[0])))
            picked = [
                (key, float(s)) for key, s in ranked if flt(self.metadata.get(key))
            ][:k]
            out.append(picked)
        return out


class ExternalIndexNode(Node):
    """input0 = docs (item, metadata); input1 = queries (item, k, filter).

    With a shardable backend (KNN), docs shard by key across workers and
    queries BROADCAST to every shard: each instance answers over its local
    shard and emits a PARTIAL reply row (killing the r2 worker-0 serialization
    of the FLOP-heavy index — reference ``operators/external_index.rs:81`` runs
    on one worker; this fans out). ``MergeIndexRepliesNode`` downstream merges
    partials into the final per-query reply. Non-shardable backends (BM25:
    global idf) keep the SOLO placement; their single partial passes through
    the same merge.
    """

    name = "external_index"

    # _filter_cache (compiled callables) is rebuilt lazily, not persisted.
    # The backend payload is NOT in snapshot_attrs: query bookkeeping
    # (_live_queries/_emitted/_tok) snapshots as small positional state while
    # the backend persists through the incremental chunk-store protocol below
    # (delta log + periodic compacted base) — re-pickling a 1M×384 index on
    # the card every snapshot tick is a device-to-host copy of ~1.5 GB per
    # interval.
    snapshot_attrs = ("_live_queries", "_emitted", "_tok")

    #: opt into the persistence layer's generation-independent SnapshotStore
    #: (persistence/snapshots.py): snapshot_state_store / restore_state_store
    #: are called with a per-(worker, node) chunk store
    uses_snapshot_store = True

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
        # replica-served retrieval (fabric/index_replica): when a retrieval
        # route is armed, this worker's backend mutations — extended with the
        # raw payload text riding the docs' ``__payload`` column — feed the
        # route's IndexRoute so every door can replay them into a local
        # replica index; None costs nothing
        self.replica_feed: Any = None
        # -- incremental snapshot state (persistence plane) -------------------
        # flipped on by Persistence.on_graph_built under operator persistence;
        # off by default so non-persisted runs never grow an op log
        self.snapshot_log_enabled = False
        self._delta_log: list[tuple] = []  # ("a", key, item, meta) | ("r", key)
        self._snap_base: str | None = None  # current compacted-base chunk name
        self._snap_deltas: list[str] = []  # delta chunk names since the base
        self._snap_base_bytes = 0
        self._snap_delta_bytes = 0
        self._snap_seq = 0
        # backend mutations applied / covered by persisted chunks: lets a
        # log-less (snapshot-at-close) save skip the base rewrite when nothing
        # changed since the last one
        self._snap_mutations = 0
        self._snap_covered = 0

    # -- operator snapshots (O(delta) discipline) ----------------------------
    def snapshot_state(self):
        """Store-less fallback (direct callers / non-store persistence paths):
        small positional state plus the whole backend."""
        state = {a: getattr(self, a) for a in self.snapshot_attrs}
        state["backend_whole"] = self.backend
        return state

    def restore_state(self, state):
        state = dict(state)
        backend = state.pop("backend_whole", None)
        if backend is not None:
            self.backend = backend
        for a, v in state.items():
            setattr(self, a, v)
        if self.replica_feed is not None:
            # restored backends never re-ran process(), so the replica feed's
            # changelog slice was not re-derived — peers must not trust a
            # snapshot RPC from this process (they forward until fresh ops)
            self.replica_feed.note_restored()

    def snapshot_state_store(self, store):
        """Incremental snapshot: persist only the mutation delta log since the
        last snapshot tick; write a fresh compacted base only when the
        accumulated deltas exceed ``PATHWAY_INDEX_COMPACT_FRAC`` of the base
        bytes (or none exists yet). The generation entry carries just the
        chunk manifest + query bookkeeping — restore loads the base and
        replays the deltas in order."""
        import pickle as _pickle

        from pathway_tpu_torch.internals.config import get_pathway_config

        state = {a: getattr(self, a) for a in self.snapshot_attrs}
        cfg = get_pathway_config()
        if cfg.index_snapshot == "whole":
            state["backend_whole"] = self.backend
            self._delta_log = []
            # drop the chunk-chain bookkeeping: the store's referenced set is
            # empty this tick, so post-commit GC deletes the aux chunks — a
            # later delta-mode snapshot must start a fresh base, not commit a
            # manifest naming deleted chunks
            self._snap_base = None
            self._snap_deltas = []
            self._snap_base_bytes = 0
            self._snap_delta_bytes = 0
            return state
        payload = _pickle.dumps(self._delta_log) if self._delta_log else None
        new_bytes = len(payload) if payload is not None else 0
        need_base = (
            self._snap_base is None
            # no live delta log (snapshot-at-close runs keep it disabled):
            # a base rewrite is the only durable form of unsaved mutations
            or (
                not self.snapshot_log_enabled
                and self._snap_mutations > self._snap_covered
            )
            or (
                self._snap_delta_bytes + new_bytes
                > cfg.index_compact_frac * self._snap_base_bytes
            )
        )
        if need_base:
            base_payload = _pickle.dumps(self.backend)
            name = f"base_{self._snap_seq:08d}"
            self._snap_seq += 1
            store.put_chunk(name, base_payload)
            self._snap_base = name
            self._snap_base_bytes = len(base_payload)
            self._snap_deltas = []
            self._snap_delta_bytes = 0
            self._snap_covered = self._snap_mutations
        elif payload is not None:
            name = f"delta_{self._snap_seq:08d}"
            self._snap_seq += 1
            store.put_chunk(name, payload)
            self._snap_deltas.append(name)
            self._snap_delta_bytes += new_bytes
            self._snap_covered = self._snap_mutations
        self._delta_log = []
        store.reference(self._snap_base)
        for name in self._snap_deltas:
            store.reference(name)
        state["backend_chunks"] = {
            "base": self._snap_base,
            "deltas": list(self._snap_deltas),
            "base_bytes": self._snap_base_bytes,
            "delta_bytes": self._snap_delta_bytes,
            "seq": self._snap_seq,
        }
        return state

    def restore_state_store(self, state, store):
        import pickle as _pickle

        state = dict(state)
        chunks = state.pop("backend_chunks", None)
        backend = state.pop("backend_whole", None)
        for a, v in state.items():
            setattr(self, a, v)
        if backend is not None:  # whole-pickle snapshot (escape-hatch mode)
            self.backend = backend
            return
        if chunks is None:
            return  # nothing persisted for the backend (fresh store)
        raw = store.get_chunk(chunks["base"])
        if raw is None:
            raise RuntimeError(
                f"index snapshot base chunk {chunks['base']!r} missing from "
                "persistent storage (was the aux prefix deleted externally?)"
            )
        self.backend = _pickle.loads(raw)
        for name in chunks["deltas"]:
            ops_raw = store.get_chunk(name)
            if ops_raw is None:
                raise RuntimeError(
                    f"index snapshot delta chunk {name!r} missing from "
                    "persistent storage"
                )
            for op in _pickle.loads(ops_raw):
                if op[0] == "a":
                    self.backend.add(op[1], op[2], op[3])
                else:
                    self.backend.remove(op[1])
        # resume the chunk chain where the snapshot left it
        self._snap_base = chunks["base"]
        self._snap_deltas = list(chunks["deltas"])
        self._snap_base_bytes = chunks["base_bytes"]
        self._snap_delta_bytes = chunks["delta_bytes"]
        self._snap_seq = chunks["seq"]
        self._delta_log = []
        if self.replica_feed is not None:
            # see restore_state: a chunk-restored slice is complete in the
            # backend but absent from the replica feed — refuse snapshot RPCs
            self.replica_feed.note_restored()

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
        # under operator persistence the exact backend mutation sequence is
        # recorded; the snapshot tick flushes it as one delta chunk (restore =
        # base pickle + in-order replay, so the rebuilt backend is the state
        # the live one had — including slot assignment)
        log = self._delta_log if self.snapshot_log_enabled else None
        feed = self.replica_feed
        fops: list | None = [] if feed is not None else None
        if docs is not None:
            payloads = docs.data.get("__payload") if fops is not None else None
            # removals first: consolidation may reorder a same-key (-1, +1)
            # upsert pair arbitrarily, and remove() is keyed by key alone — an
            # add-then-remove ordering would silently drop the updated doc
            for i in range(len(docs)):
                if docs.diffs[i] < 0:
                    key = int(docs.keys[i])
                    if log is not None:
                        log.append(("r", key))
                    if fops is not None:
                        fops.append(("r", key))
                    self.backend.remove(key)
            for i in range(len(docs)):
                if docs.diffs[i] > 0:
                    key = int(docs.keys[i])
                    item = docs.data["__item"][i]
                    meta = docs.data["__meta"][i]
                    if log is not None:
                        log.append(("a", key, item, meta))
                    if fops is not None:
                        fops.append(("a", key, item, meta, payloads[i] if payloads is not None else None))
                    self.backend.add(key, item, meta)
            docs_changed = len(docs) > 0
            self._snap_mutations += len(docs)
        if fops:
            feed.note_ops(fops)

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
            from pathway_tpu_torch.observability import requests as _requests

            rp = _requests.current()
            if rp is not None and rp.hot:
                import time as _t

                w0 = _t.time_ns()
                replies = self._answer(to_answer)
                rp.note_stage(
                    None, "index/search", w0, _t.time_ns(), len(to_answer)
                )
            else:
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
        # tiered backends rebalance AFTER this tick's answers are emitted:
        # promotion/demotion is batched scatter work that must never sit on
        # the query path (stdlib/indexing/tiered.py)
        maintain = getattr(self.backend, "maintain", None)
        if maintain is not None and (docs_changed or to_answer):
            maintain()
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


class LshVectorBackend(IndexBackend):
    """Approximate KNN via LSH bucket pruning (the ANN answer to the
    reference's usearch/HNSW integrations, ``usearch_integration.rs:20``):
    candidates come from the union of a query's band buckets
    (``stdlib/ml/classifiers/_lsh.py`` bucketers), then score EXACTLY — so
    accuracy degrades only by bucket recall, never by score error, and
    per-shard candidate sets still merge exactly (scores are
    shard-independent)."""

    shardable = True

    def __init__(
        self,
        dimension: int,
        metric: str = "cos",
        n_or: int = 10,
        n_and: int = 8,
        bucket_length: float = 1.0,
        seed: int = 0,
    ):
        from pathway_tpu_torch.stdlib.ml.classifiers._lsh import (
            generate_cosine_lsh_bucketer,
            generate_euclidean_lsh_bucketer,
        )

        self.metric = metric
        if metric == "dot":
            # hyperplane buckets ignore magnitude, so the true max-inner-product
            # neighbor can be excluded from every bucket; MIPS needs an ALSH
            # transform we don't implement — use the exact brute-force index
            raise ValueError(
                "LshVectorBackend: metric='dot' is not supported (bucket recall "
                "ignores vector magnitude); use BruteForceKnnFactory for "
                "max-inner-product search"
            )
        if metric == "cos":
            self.bucketer = generate_cosine_lsh_bucketer(
                dimension, M=n_and, L=n_or, seed=seed
            )
        elif metric in ("l2sq", "euclidean"):
            self.bucketer = generate_euclidean_lsh_bucketer(
                dimension, M=n_and, L=n_or, A=bucket_length, seed=seed
            )
        else:
            raise ValueError(f"LshVectorBackend: unsupported metric {metric!r}")
        self.vectors: dict[int, np.ndarray] = {}
        self.metadata: dict[int, Any] = {}
        self.bands: dict[int, np.ndarray] = {}  # key -> its L band hashes
        self.buckets: dict[int, set[int]] = {}  # band hash -> keys

    def add(self, key, item, metadata):
        vec = np.asarray(item, dtype=np.float32)
        if key in self.vectors:
            self.remove(key)
        bands = self.bucketer(vec)[0]
        self.vectors[key] = vec
        self.metadata[key] = metadata
        self.bands[key] = bands
        for b in bands.tolist():
            self.buckets.setdefault(int(b), set()).add(key)

    def remove(self, key):
        self.vectors.pop(key, None)
        self.metadata.pop(key, None)
        bands = self.bands.pop(key, None)
        if bands is not None:
            for b in bands.tolist():
                bucket = self.buckets.get(int(b))
                if bucket is not None:
                    bucket.discard(key)
                    if not bucket:
                        del self.buckets[int(b)]

    def _score(self, cand_mat: np.ndarray, q: np.ndarray) -> np.ndarray:
        if self.metric == "cos":
            qn = np.linalg.norm(q) or 1.0
            dn = np.linalg.norm(cand_mat, axis=1)
            dn[dn == 0] = 1.0
            return (cand_mat @ q) / (dn * qn)
        if self.metric in ("l2sq", "euclidean"):
            diff = cand_mat - q[None, :]
            return -(diff * diff).sum(axis=1)
        raise ValueError(f"LshVectorBackend: unsupported metric {self.metric!r}")

    def search(self, items, ks, filters):
        out = []
        for q, k, flt in zip(items, ks, filters):
            qv = np.asarray(q, dtype=np.float32)
            cands: set[int] = set()
            for b in self.bucketer(qv)[0].tolist():
                cands |= self.buckets.get(int(b), set())
            good = [c for c in sorted(cands) if flt(self.metadata.get(c))]
            if not good:
                out.append([])
                continue
            mat = np.stack([self.vectors[c] for c in good])
            scores = self._score(mat, qv)
            order = np.lexsort((tie_order_u64(np.asarray(good, dtype=np.uint64)), -scores))[:k]
            out.append([(good[i], float(scores[i])) for i in order])
        return out
