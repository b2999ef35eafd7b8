"""Tiered KNN backend: bounded hot shard in device memory over a host-resident IVF cold
tier — the refactor that makes the "KNN as HBM einsum" flagship hold when the
corpus no longer fits in device memory (ROADMAP #4; the hot/cold discipline of
serving-scale ANN systems: FAISS-style IVF cold tiers, DiskANN-style
fixed-memory serving).

Layout
------
- **Cold tier (authoritative, host)**: every row lives in an
  :class:`~pathway_tpu_torch.stdlib.indexing.ivf.IvfFlatBackend` (k-means coarse
  quantizer, contiguous CSR lists) plus a raw-vector mirror used for device
  rescoring. Host memory scales with the corpus; HBM does not.
- **Hot tier (bounded, HBM)**: a :class:`~pathway_tpu_torch.ops.knn.BruteForceKnnIndex`
  allocated at ``PATHWAY_INDEX_HOT_ROWS`` and never grown past it — recently
  added rows plus rows the maintenance pass promotes for being frequently hit.

Query path (one tick)
---------------------
hot einsum over the resident shard (exact, HBM) ‖ IVF candidate pruning over
the cold tier (host) → cold candidates rescored on device by
``ops.knn.exact_rescore`` → canonical merge. Hot and cold candidates are
scored by the SAME kernel body (``_search_body``: one dot/norm formula, one
canonical (score desc, key asc) tie-break), so the merged top-k is the list a
single-tier brute-force index over the full corpus would return whenever the
cold tier's candidate generation covers the true top-k (always when the IVF is
untrained or probes every list; at its measured recall otherwise — the
approximation is confined to cold, infrequently-hit rows).

Promotion/demotion is **batched and off the query path**: the engine node
calls :meth:`maintain` after a tick's answers are emitted; rows hit at least
``PATHWAY_INDEX_PROMOTE_HITS`` times promote into free hot slots, least-
recently-hit residents demote to make room (they remain in the cold tier —
demotion only drops the HBM mirror). ``maintain()`` applies at most
``PATHWAY_INDEX_MAINTAIN_BATCH`` moves per pass.

Accounting is exact: ``hits_total`` / ``hot_hits`` count every emitted result
row by serving tier (``pathway_index_hot_hit_ratio``), and promotions/
demotions are monotonic counters. Hot HBM bytes report as
``pathway_device_bytes{component="knn_hot"}``, the host-resident cold tier as
``component="knn_cold"``.

Persistence note: the index node's delta-log snapshot records the add/remove
op sequence, which fully determines VectorBackend/IVF/BM25 state — their
restore is byte-for-byte. Tiered hot membership is additionally QUERY-driven
(hit counters feed promotion), which the log does not replay: a restore gets
the hot set as of the last compacted base plus add-time residency for
replayed rows, and re-warms promotions from live traffic. Answers are
unaffected wherever the cold tier's candidate recall covers the true top-k
(always in its exact regime); at lower recall a just-promoted row can sit one
recall class lower until it re-earns promotion.

Carried from ``pathway_tpu/stdlib/indexing/tiered.py``. In the port the hot
shard is ``pathway_tpu_torch.ops.knn.BruteForceKnnIndex`` on ``device`` (the
card by default, or an error without CUDA), cold candidates are rescored by
``exact_rescore`` on the same device. The hot shard registers its tensors as
``knn_hot`` device bytes and the backend its cold tier as ``knn_cold``, as in
the reference.
"""

from __future__ import annotations

import threading
import weakref
from typing import Any

import numpy as np

from pathway_tpu_torch.internals.keys import tie_order
from pathway_tpu_torch.stdlib.indexing._engine import IndexBackend
from pathway_tpu_torch.stdlib.indexing.ivf import IvfFlatBackend


def _true(_md: Any) -> bool:
    return True


#: live tiered backends (weak — no lifetime coupling), for /metrics + /status
_live_tiered: "weakref.WeakSet[TieredKnnBackend]" = weakref.WeakSet()
_registry_lock = threading.Lock()

#: process-cumulative counters (DeviceStats discipline): the Prometheus
#: counter families must stay monotonic, which a sum over live weakly-held
#: backends is not — a rebuilt pipeline dropping an old backend would read as
#: a counter reset and extrapolate phantom rate spikes
_counters = {
    "hits_total": 0,
    "hot_hits": 0,
    "promotions_total": 0,
    "demotions_total": 0,
}


def _count(name: str, n: int) -> None:
    if n:
        with _registry_lock:
            _counters[name] += n


class TieredKnnBackend(IndexBackend):
    """Bounded-HBM hot shard + host IVF cold tier with async promotion."""

    #: per-shard top-k partials merge exactly (scores are content-based and
    #: shard-independent, like the brute-force backend's)
    shardable = True

    def __init__(
        self,
        dimension: int,
        metric: str = "cos",
        hot_rows: int | None = None,
        nlist: int | None = None,
        nprobe: int | None = None,
        min_train: int = 4096,
        promote_hits: int | None = None,
        maintain_batch: int | None = None,
        seed: int = 0,
        device=None,
    ):
        from pathway_tpu_torch.internals.config import get_pathway_config
        from pathway_tpu_torch.ops.knn import BruteForceKnnIndex, _pad_to_capacity

        cfg = get_pathway_config()
        if metric not in ("cos", "dot", "l2sq"):
            raise ValueError(f"unsupported metric {metric!r}")
        self.dimension = dimension
        self.metric = metric
        self.hot_rows = hot_rows if hot_rows is not None else cfg.index_hot_rows
        if self.hot_rows < 1:
            raise ValueError(f"hot_rows must be >= 1, got {self.hot_rows}")
        self.promote_hits = (
            promote_hits if promote_hits is not None else cfg.index_promote_hits
        )
        self.maintain_batch = (
            maintain_batch if maintain_batch is not None else cfg.index_maintain_batch
        )
        # hot shard: capacity FIXED at the bound's power-of-two pad; occupancy
        # never exceeds hot_rows, so _grow() never fires and HBM stays flat
        self.hot = BruteForceKnnIndex(
            dimension=dimension,
            metric=metric,
            capacity=_pad_to_capacity(self.hot_rows),
            device=device,
            component="knn_hot",
        )
        self.device = self.hot.device
        self.cold = IvfFlatBackend(
            dimension=dimension,
            metric=metric,
            nlist=nlist,
            nprobe=nprobe,
            min_train=min_train,
            seed=seed,
        )
        # the tiered search already over-fetches via its ks (and filters at
        # the merge, never inside the cold tier) — the IVF's own post-filter
        # margin on top would compound to ~100x k of per-list selection work
        self.cold.post_filter_mult = 1
        # raw (un-normalized) vector mirror for device rescoring of cold
        # candidates — the IVF stores normalized copies under the cos metric
        cap = 1024
        self._raw = np.zeros((cap, dimension), dtype=np.float32)
        self._raw_slot: dict[int, int] = {}
        self._raw_free: list[int] = []
        self._raw_n = 0
        # hit accounting (monotonic) + per-window promotion bookkeeping
        self.hits_total = 0
        self.hot_hits = 0
        self.promotions_total = 0
        self.demotions_total = 0
        self._cold_hit_counts: dict[int, int] = {}
        self._hot_last_hit: dict[int, int] = {}
        self._clock = 0
        _register(self)

    # ------------------------------------------------------------------ sizing
    def __len__(self) -> int:
        return len(self._raw_slot)

    def cold_bytes(self) -> int:
        """Host-resident bytes of the cold tier (raw mirror + IVF arrays)."""
        b = self._raw.nbytes
        for name in ("_vecs", "_keys", "_live", "_assign"):
            b += getattr(self.cold, name).nbytes
        if self.cold._centroids is not None:
            b += self.cold._centroids.nbytes
        vcsr = getattr(self.cold, "_vecs_csr", None)
        if vcsr is not None:
            b += vcsr.nbytes
        return int(b)

    # ------------------------------------------------------------------ writes
    def _grow_raw(self) -> None:
        cap = len(self._raw) * 2
        new = np.zeros((cap, self.dimension), dtype=np.float32)
        new[: len(self._raw)] = self._raw
        self._raw = new

    def add(self, key: int, item: Any, metadata: Any) -> None:
        vec = np.asarray(item, dtype=np.float32).reshape(-1)
        if vec.shape[0] != self.dimension:
            raise ValueError(
                f"vector dimension {vec.shape[0]} != index dimension {self.dimension}"
            )
        if key in self._raw_slot:
            self.remove(key)
        if self._raw_free:
            slot = self._raw_free.pop()
        else:
            if self._raw_n == len(self._raw):
                self._grow_raw()
            slot = self._raw_n
            self._raw_n += 1
        self._raw[slot] = vec
        self._raw_slot[key] = slot
        self.cold.add(key, vec, metadata)
        if len(self.hot) < self.hot_rows:
            # recently-added rows serve from HBM until demoted
            self.hot.add(key, vec)
            self._hot_last_hit[key] = self._clock

    def remove(self, key: int) -> None:
        # tolerant of unknown keys (a corrupted retraction must poison at most
        # its own row, never the dataflow — the audit plane flags it)
        slot = self._raw_slot.pop(key, None)
        if slot is None:
            return
        self._raw_free.append(slot)
        self.cold.remove(key)
        if key in self.hot._key_to_slot:
            self.hot.remove(key)
            self._hot_last_hit.pop(key, None)
        self._cold_hit_counts.pop(key, None)

    # ------------------------------------------------------------------ search
    def search(self, items, ks, filters):
        from pathway_tpu_torch.ops.knn import _decode_hits, exact_rescore

        if not items:
            return []
        n_live = len(self._raw_slot)
        if n_live == 0:
            return [[] for _ in items]
        kmax = max(ks, default=0)
        if kmax == 0:
            return [[] for _ in items]
        # shared over-fetch heuristic (power-of-two quantized: k is a STATIC
        # jit argument — an occupancy-dependent fetch would recompile the
        # search kernels on nearly every churn tick)
        from pathway_tpu_torch.stdlib.indexing._engine import overfetch

        fetch = overfetch(kmax, n_live)
        qs = np.stack([np.asarray(q, dtype=np.float32) for q in items])
        self._clock += 1
        hot_keys = self.hot._key_to_slot
        # hot tier: exact einsum over the HBM-resident shard (search_device
        # clamps k to the FIXED hot capacity — the compile cache stays closed)
        hot_lists: list[list] = [[] for _ in items]
        if len(self.hot) > 0:
            scores, ids = self.hot.search_device(qs, fetch)
            s_np, i_np = self.hot._fetch_hits(scores, ids)
            hot_lists = _decode_hits(s_np, i_np, self.hot._slot_to_key, fetch)
        # cold tier: IVF prunes to candidate KEYS (host); hot residents are
        # excluded (already exactly scored above) and the union is rescored on
        # device by the same kernel body — scoring the union for every query
        # is sound because every candidate is a real corpus row. Skipped
        # entirely while every live row is hot-resident (small corpora / the
        # warm-up phase of big ones): the host scan would only produce
        # candidates the dedup discards
        cand: list[int] = []
        if len(self.hot) < n_live:
            cold_raw = self.cold.search(
                list(qs), [fetch] * len(items), [_true] * len(items)
            )
            seen: set[int] = set()
            for hits in cold_raw:
                for key, _s in hits:
                    if key in hot_keys or key in seen:
                        continue
                    seen.add(key)
                    cand.append(key)
        cold_lists: list[list] = [[] for _ in items]
        if cand:
            mat = self._raw[[self._raw_slot[c] for c in cand]]
            # k = fetch, NOT min(fetch, len(cand)): exact_rescore clamps k to
            # the padded power-of-two capacity, so the static (cap, k) pair
            # stays a small closed set instead of recompiling per tick
            cold_lists = exact_rescore(mat, cand, qs, fetch, self.metric, device=self.device)
        # canonical merge + post-filter + exact per-tier hit accounting
        meta = self.cold.metadata
        out = []
        for qi, (k, flt) in enumerate(zip(ks, filters)):
            merged = list(hot_lists[qi]) + list(cold_lists[qi])
            merged.sort(key=lambda kv: (-kv[1], tie_order(kv[0])))
            picked: list[tuple[int, float]] = []
            hot_n = 0
            for key, score in merged:
                if len(picked) >= k:
                    break
                if flt(meta.get(key)):
                    picked.append((key, float(score)))
                    if key in hot_keys:
                        hot_n += 1
                        self._hot_last_hit[key] = self._clock
                    else:
                        self._cold_hit_counts[key] = (
                            self._cold_hit_counts.get(key, 0) + 1
                        )
            self.hits_total += len(picked)
            self.hot_hits += hot_n
            _count("hits_total", len(picked))
            _count("hot_hits", hot_n)
            out.append(picked)
        return out

    # -------------------------------------------------------------- maintenance
    def maintain(self) -> None:
        """Batched promotion/demotion between ticks (called by the engine node
        AFTER a tick's answers are emitted — never on the query path)."""
        hot_keys = self.hot._key_to_slot
        cand = [
            (c, k)
            for k, c in self._cold_hit_counts.items()
            if c >= self.promote_hits and k in self._raw_slot and k not in hot_keys
        ]
        if cand:
            cand.sort(key=lambda ck: (-ck[0], tie_order(ck[1])))
            cand = cand[: self.maintain_batch]
            room = self.hot_rows - len(self.hot)
            need = len(cand) - room
            if need > 0:
                # demote least-recently-hit residents to make room — but never
                # a row that served a hit this very window
                lru = sorted(
                    hot_keys,
                    key=lambda k: (self._hot_last_hit.get(k, -1), tie_order(k)),
                )
                demote = [
                    k for k in lru if self._hot_last_hit.get(k, -1) < self._clock
                ][:need]
                for k in demote:
                    self.hot.remove(k)
                    self._hot_last_hit.pop(k, None)
                self.demotions_total += len(demote)
                _count("demotions_total", len(demote))
                room = self.hot_rows - len(self.hot)
            promote = cand[:room]
            if promote:
                keys = [k for _c, k in promote]
                rows = self._raw[[self._raw_slot[k] for k in keys]]
                self.hot.add_batch(keys, rows)
                for k in keys:
                    self._hot_last_hit[k] = self._clock
                self.promotions_total += len(promote)
                _count("promotions_total", len(promote))
        # the window ENDS here: counts reset every maintenance pass, so
        # promote_hits means "hits within one window" (per the knob's
        # contract) — lifetime accumulation would eventually promote every
        # occasionally-hit row and churn the hot shard forever
        self._cold_hit_counts.clear()

    # ------------------------------------------------------------------ stats
    def stats(self) -> dict[str, Any]:
        hot_n = len(self.hot)
        return {
            "hot_rows": hot_n,
            "hot_bound": self.hot_rows,
            "cold_rows": len(self._raw_slot) - hot_n,
            "hits_total": self.hits_total,
            "hot_hits": self.hot_hits,
            "hot_hit_ratio": (
                round(self.hot_hits / self.hits_total, 6) if self.hits_total else None
            ),
            "promotions_total": self.promotions_total,
            "demotions_total": self.demotions_total,
            "hot_device_bytes": self.hot.device_bytes(),
            "cold_host_bytes": self.cold_bytes(),
        }

    # ------------------------------------------------------------------ pickle
    def __setstate__(self, d):
        # the weak tier registration doesn't survive pickling
        self.__dict__.update(d)
        _register(self)


def _register(backend: TieredKnnBackend) -> None:
    from pathway_tpu_torch.observability import device as _dev_prof

    with _registry_lock:
        _live_tiered.add(backend)
    _dev_prof.register_memory(backend, "knn_cold", lambda t: t.cold_bytes())


def tier_stats() -> dict[str, Any] | None:
    """Tiered-index telemetry, or None when no backend lives — feeds
    ``pathway_index_*`` on /metrics and the ``index`` block on /status.
    Residency/bytes gauges sum over LIVE backends; hit/promotion/demotion
    counters are process-cumulative (monotonic even when a rebuilt pipeline
    drops an old backend — Prometheus counter semantics)."""
    with _registry_lock:
        insts = list(_live_tiered)
        counters = dict(_counters)
    if not insts:
        return None
    agg = {
        "backends": len(insts),
        "hot_rows": 0,
        "hot_bound": 0,
        "cold_rows": 0,
        "hot_device_bytes": 0,
        "cold_host_bytes": 0,
    }
    for b in insts:
        s = b.stats()
        for k in agg:
            if k != "backends":
                agg[k] += s[k]
    agg.update(counters)
    agg["hot_hit_ratio"] = (
        round(agg["hot_hits"] / agg["hits_total"], 6) if agg["hits_total"] else None
    )
    return agg
