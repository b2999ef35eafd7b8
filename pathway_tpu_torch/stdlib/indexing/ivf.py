"""IVF-flat approximate KNN backend (the HNSW-class retriever, VERDICT r3 #7).

The reference's default big-corpus retriever is USearch HNSW
(``src/external_integration/usearch_integration.rs:20``,
``stdlib/indexing/nearest_neighbors.py:65``). A graph-walk HNSW is a pointer-
chasing structure — the exact shape that vectorizes worst — so the TPU build's
approximate index is **IVF-flat**: k-means coarse quantizer + exact scoring
inside the ``nprobe`` nearest inverted lists. Everything is dense batched
linear algebra (assign = argmax einsum, probe = einsum over CSR slices), which
keeps the implementation vectorized end to end on host numpy today and leaves
a straight path to device (the per-list score kernel is the same einsum
``ops/knn.py`` runs in HBM).

Measured (``tests/test_ivf.py``, 100k x 64 float32, 50 queries): on a
clustered corpus (mixture of 500 gaussians — the shape embedding corpora
have) the default ``nprobe`` gives **recall@10 = 1.00 at ~0.3 ms/query vs
~2.5 ms/query exact** (≈10x). On structureless random data concentration of
measure defeats IVF (recall 0.95 needs ~60% of lists probed); that regime
belongs to ``BruteForceKnn``'s HBM einsum, and the docstrings say so.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np

from pathway_tpu_torch.internals.keys import tie_order_u64
from pathway_tpu_torch.stdlib.indexing._engine import IndexBackend


class IvfFlatBackend(IndexBackend):
    """Inverted-file flat index: train k-means centroids over the corpus,
    assign every vector to its nearest list, search only the ``nprobe``
    closest lists exactly.

    Lifecycle: below ``min_train`` vectors search is exact brute force (small
    corpora don't benefit from pruning); the first search at or past
    ``min_train`` trains the quantizer; the quantizer retrains when the corpus
    doubles past its training size (assignments drift as data grows).
    """

    #: per-shard top-k partials merge like the brute-force backend's
    shardable = True

    def __init__(
        self,
        dimension: int,
        metric: str = "cos",
        nlist: int | None = None,
        nprobe: int | None = None,
        min_train: int = 4096,
        seed: int = 0,
    ):
        if metric not in ("cos", "dot", "l2sq"):
            raise ValueError(f"unsupported metric {metric!r}")
        self.dimension = dimension
        self.metric = metric
        self.nlist_cfg = nlist
        self.nprobe_cfg = nprobe
        self.min_train = min_train
        self.seed = seed
        cap = 1024
        self._vecs = np.zeros((cap, dimension), dtype=np.float32)
        self._keys = np.zeros(cap, dtype=np.uint64)
        self._live = np.zeros(cap, dtype=bool)
        self._n = 0  # rows used (live + dead)
        self._n_live = 0
        self._slot_of: dict[int, int] = {}
        self.metadata: dict[int, Any] = {}
        # quantizer state
        self._centroids: np.ndarray | None = None
        self._assign = np.full(cap, -1, dtype=np.int32)
        self._trained_at = 0  # corpus size at last train
        self._free: list[int] = []  # dead slots recycled by add (bounds _n)
        # CSR layout is rebuilt only when enough has churned; in between,
        # removals mask rows (``_csr_alive``) and additions land in a small
        # exactly-scored tail (``_extra``) — a one-row delta per tick must not
        # pay an O(N) re-sort + full-corpus copy
        self._csr_dirty = True
        self._list_order: np.ndarray | None = None  # slots grouped by list
        self._list_starts: np.ndarray | None = None
        self._csr_alive: np.ndarray | None = None
        self._csr_pos: dict[int, int] = {}  # slot -> csr row
        self._extra: set[int] = set()  # slots added since the last rebuild
        self._csr_dead = 0
        #: per-(query, list) candidate over-fetch multiplier so post-filtering
        #: still fills k; callers that filter elsewhere (the tiered backend
        #: rescores and filters at its merge) set 1 to skip the margin
        self.post_filter_mult = 10

    # ------------------------------------------------------------------ sizing
    def __len__(self) -> int:
        return self._n_live

    @property
    def nlist(self) -> int:
        if self.nlist_cfg is not None:
            return max(1, self.nlist_cfg)
        return max(1, int(np.sqrt(max(self._n_live, 1))))

    def _nprobe(self, nlist: int) -> int:
        if self.nprobe_cfg is not None:
            return min(nlist, max(1, self.nprobe_cfg))
        # default tuned on clustered (embedding-like) corpora: recall@10 = 1.0
        # at 10x under exact scoring on 100k x 64 (tests/test_ivf.py). On
        # STRUCTURELESS data concentration of measure defeats any IVF —
        # measured recall@10 = 0.95 needs nprobe ~ 0.6*nlist there, at which
        # point brute force is the right tool: raise nprobe= explicitly or use
        # BruteForceKnn for unclustered corpora.
        return min(nlist, max(8, nlist // 16))

    # ------------------------------------------------------------------ writes
    def _norm(self, v: np.ndarray) -> np.ndarray:
        if self.metric != "cos":
            return v
        n = np.linalg.norm(v, axis=-1, keepdims=True)
        return v / np.maximum(n, 1e-12)

    def _grow(self) -> None:
        cap = len(self._keys) * 2
        for name in ("_vecs", "_keys", "_live", "_assign"):
            arr = getattr(self, name)
            shape = (cap,) + arr.shape[1:]
            fill = -1 if name == "_assign" else 0
            new = np.full(shape, fill, dtype=arr.dtype)
            new[: len(arr)] = arr
            setattr(self, name, new)

    def add(self, key: int, item: Any, metadata: Any) -> None:
        if key in self._slot_of:
            self.remove(key)
        v = self._norm(np.asarray(item, dtype=np.float32).reshape(-1))
        if v.shape[0] != self.dimension:
            raise ValueError(
                f"vector dimension {v.shape[0]} != index dimension {self.dimension}"
            )
        if self._free:
            slot = self._free.pop()
        else:
            if self._n == len(self._keys):
                self._grow()
            slot = self._n
            self._n += 1
        self._n_live += 1
        self._vecs[slot] = v
        self._keys[slot] = np.uint64(key)
        self._live[slot] = True
        self._slot_of[key] = slot
        self.metadata[key] = metadata
        if self._centroids is not None:
            self._assign[slot] = int(
                np.argmax(self._centroid_scores(v[None, :])[0])
            )
            if self._list_order is not None and not self._csr_dirty:
                self._extra.add(slot)
                self._maybe_dirty()
        else:
            self._csr_dirty = True

    def remove(self, key: int) -> None:
        slot = self._slot_of.pop(key, None)
        if slot is None:
            return
        self._live[slot] = False
        self._n_live -= 1
        self._free.append(slot)
        self.metadata.pop(key, None)
        if self._list_order is not None and not self._csr_dirty:
            # tail membership first: a recycled slot may also have a STALE
            # (already-masked) row in the CSR from its previous life
            if slot in self._extra:
                self._extra.discard(slot)
            else:
                pos = self._csr_pos.get(slot)
                if pos is not None:
                    self._csr_alive[pos] = False
                    self._csr_dead += 1
            self._maybe_dirty()
        else:
            self._csr_dirty = True

    def _maybe_dirty(self) -> None:
        churn = len(self._extra) + self._csr_dead
        if churn > max(1024, self._n_live // 10):
            self._csr_dirty = True

    # ------------------------------------------------------------------ training
    def _pairwise(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """(len_a, len_b) similarity matrix under the index metric (higher =
        closer) — the ONE scoring formula (assignment, probing, tail, train
        all route here so the metric cannot drift between paths)."""
        if self.metric == "l2sq":
            return (
                2.0 * (a @ b.T)
                - (a * a).sum(axis=1)[:, None]
                - (b * b).sum(axis=1)[None, :]  # true -||a-b||^2
            )
        return a @ b.T

    def _centroid_scores(self, q: np.ndarray) -> np.ndarray:
        """(q, nlist) similarity of queries to centroids (higher = closer)."""
        return self._pairwise(q, self._centroids)

    def _train(self) -> None:
        """Vectorized Lloyd's k-means (few iterations; subsampled)."""
        live = np.flatnonzero(self._live[: self._n])
        nlist = self.nlist
        rng = np.random.default_rng(self.seed)
        sample = live
        if len(sample) > 50_000:
            sample = rng.choice(sample, 50_000, replace=False)
        x = self._vecs[sample]
        if nlist >= len(sample):
            cents = x.copy()
        else:
            cents = x[rng.choice(len(x), nlist, replace=False)].copy()
            for _ in range(8):
                a = np.argmax(self._pairwise(x, cents), axis=1)
                counts = np.bincount(a, minlength=len(cents)).astype(np.float32)
                sums = np.zeros_like(cents)
                np.add.at(sums, a, x)
                nonempty = counts > 0
                cents[nonempty] = sums[nonempty] / counts[nonempty, None]
                # re-seed empty centroids from random points
                n_empty = int((~nonempty).sum())
                if n_empty:
                    cents[~nonempty] = x[rng.choice(len(x), n_empty)]
                if self.metric == "cos":
                    cents = self._norm(cents)
        self._centroids = np.ascontiguousarray(cents, dtype=np.float32)
        # assign ALL live rows
        scores = self._centroid_scores(self._vecs[live])
        self._assign[: self._n] = -1
        self._assign[live] = np.argmax(scores, axis=1).astype(np.int32)
        self._trained_at = self._n_live
        self._csr_dirty = True

    def _ensure_trained(self) -> bool:
        if self._n_live < self.min_train:
            return False
        if self._centroids is None or self._n_live >= 2 * max(self._trained_at, 1):
            self._train()
        return True

    def _csr(self) -> tuple[np.ndarray, np.ndarray]:
        """List-major layout: live vectors regrouped CONTIGUOUSLY by inverted
        list (``_vecs_csr``), so probing a list is a slice matmul, not a
        gather — the host analogue of keeping HBM reads coalesced."""
        if not self._csr_dirty and self._list_order is not None:
            return self._list_order, self._list_starts
        live = np.flatnonzero(self._live[: self._n])
        a = self._assign[live]
        order = np.argsort(a, kind="stable")
        slots = live[order]
        a_sorted = a[order]
        nlist = len(self._centroids)
        starts = np.searchsorted(a_sorted, np.arange(nlist + 1))
        self._list_order, self._list_starts = slots, starts
        self._vecs_csr = np.ascontiguousarray(self._vecs[slots])
        self._keys_csr = self._keys[slots]
        self._tie_csr = tie_order_u64(self._keys_csr)
        self._csr_alive = np.ones(len(slots), dtype=bool)
        self._csr_pos = {int(s): i for i, s in enumerate(slots)}
        self._extra = set()
        self._csr_dead = 0
        self._csr_dirty = False
        return slots, starts

    # ------------------------------------------------------------------ search
    def _score(self, q: np.ndarray, slots: np.ndarray) -> np.ndarray:
        return self._pairwise(self._vecs[slots], q[None, :])[:, 0]

    def _top(self, q, slots, k, flt):
        scores = self._score(q, slots)
        # canonical order: score desc, tie_order asc (matches ops/knn.py)
        keys = self._keys[slots]
        order = np.lexsort((tie_order_u64(keys), -scores))
        picked = []
        for i in order:
            if len(picked) >= k:
                break
            key = int(keys[i])
            if flt(self.metadata.get(key)):
                picked.append((key, float(scores[i])))
        return picked

    def search(self, items, ks, filters):
        if not items:
            return []
        if self._n_live == 0:
            return [[] for _ in items]
        qs = self._norm(np.stack([np.asarray(q, dtype=np.float32) for q in items]))
        if not self._ensure_trained():
            # exact path for small corpora
            live = np.flatnonzero(self._live[: self._n])
            return [
                self._top(q, live, k, flt) for q, k, flt in zip(qs, ks, filters)
            ]
        _, starts = self._csr()
        nlist = len(self._centroids)
        nprobe = self._nprobe(nlist)
        cscores = self._centroid_scores(qs)
        probe = np.argpartition(-cscores, min(nprobe, nlist) - 1, axis=1)[:, :nprobe]
        nq = len(qs)
        # over-fetch per (query, list) so post-filtering still fills k (same
        # 10x factor as VectorBackend.search; 1 when the caller filters later)
        fetch = max(ks, default=1) * getattr(self, "post_filter_mult", 10)
        # batch by LIST across queries: one slice matmul per probed list (big
        # contiguous GEMMs instead of per-query gathers)
        q_of_list: dict[int, list[int]] = {}
        for qi in range(nq):
            for li in probe[qi]:
                q_of_list.setdefault(int(li), []).append(qi)
        partial_pos: list[list[np.ndarray]] = [[] for _ in range(nq)]
        partial_scores: list[list[np.ndarray]] = [[] for _ in range(nq)]
        for li, q_idx in q_of_list.items():
            s, e = int(starts[li]), int(starts[li + 1])
            if s == e:
                continue
            block = self._vecs_csr[s:e]
            scores = self._pairwise(block, qs[q_idx])  # (len, |q_idx|)
            dead = ~self._csr_alive[s:e]
            if dead.any():  # rows removed since the last CSR rebuild
                scores[dead] = -np.inf
            m = e - s
            top = min(fetch, m)
            if top < m:
                sel = np.argpartition(-scores, top - 1, axis=0)[:top]
            else:
                sel = np.tile(np.arange(m)[:, None], (1, len(q_idx)))
            for col, qi in enumerate(q_idx):
                rows = sel[:, col]
                partial_pos[qi].append(rows + s)
                partial_scores[qi].append(scores[rows, col])
        # the un-indexed tail (added since the last CSR rebuild, bounded by
        # _maybe_dirty): scored exactly against every query
        tail = sorted(self._extra)
        tail_keys = tail_ties = tail_scores = None
        if tail:
            tslots = np.asarray(tail, dtype=np.int64)
            tblock = self._vecs[tslots]
            tail_scores = self._pairwise(tblock, qs)
            tail_keys = self._keys[tslots]
            tail_ties = tie_order_u64(tail_keys)
        out = []
        for qi, (k, flt) in enumerate(zip(ks, filters)):
            pos_parts = partial_pos[qi]
            keys_parts = [self._keys_csr[p] for p in pos_parts]
            tie_parts = [self._tie_csr[p] for p in pos_parts]
            score_parts = list(partial_scores[qi])
            if tail:
                keys_parts.append(tail_keys)
                tie_parts.append(tail_ties)
                score_parts.append(tail_scores[:, qi])
            if not keys_parts:
                out.append([])
                continue
            keys = np.concatenate(keys_parts)
            ties = np.concatenate(tie_parts)
            scores = np.concatenate(score_parts)
            # canonical order: score desc, tie_order asc (matches ops/knn.py)
            order = np.lexsort((ties, -scores))
            picked = []
            for i in order:
                if len(picked) >= k:
                    break
                if scores[i] == -np.inf:
                    break  # only masked-dead rows remain
                key = int(keys[i])
                if flt(self.metadata.get(key)):
                    picked.append((key, float(scores[i])))
            out.append(picked)
        return out
