"""Brute-force KNN index resident in device memory.

Port of ``pathway_tpu/ops/knn.py``. The matrix is a
padded ``[N, d]`` tensor whose capacity doubles from 128; add and remove work
on a slot free-list; updates are staged and land in one scatter before the
next search; a search is f32 products of one fixed shape (``_dots``) plus an
exact top-k under the canonical order (score desc, key asc), so results never
depend on slot order, batch or index size. Invalid (free or deleted) slots
score −inf.

Differences from the JAX package, none of them visible in results:
- the ingest scatter updates the index tensors in place (``index_put_``)
  where JAX donates buffers to a functional scatter;
- scatter batches are not padded to power-of-two buckets, and wide rows are
  not top-k'ed in chunks: both only bounded XLA's compile cache or TPU cost;
- key bits are stored as int32 bit patterns (torch has no full uint32 ops).

``sharded_search`` / ``ShardedBruteForceKnnIndex`` split the matrix over the
logical shards of a ``parallel.mesh.DeviceMesh``: each shard takes its own
top-k through the same scoring body, and a canonical merge of the candidates
gives the single index's answer, ties included.

Every device entry point runs through the device plane's ``traced_jit`` at
the reference's labels (``knn.search``, ``knn.rescore``, ``knn.scatter``,
``knn.pack_hits``, ``knn.invalidate``), a search reports its FLOPs and padded
rows, and an index registers its tensors' bytes (``knn_index``, or
``knn_hot`` for a tiered index's hot shard).
"""

from __future__ import annotations

import enum
import functools
import math
from typing import Any, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from pathway_tpu_torch._device import resolve_device
from pathway_tpu_torch.internals.keys import tie_order, tie_order_u64
from pathway_tpu_torch.observability import device as _dev_prof
from pathway_tpu_torch.ops._fixed_order import fixed_order_sum


class KnnMetric(enum.Enum):
    L2SQ = "l2sq"
    COS = "cos"
    DOT = "dot"


_MIN_CAPACITY = 128


def _pad_to_capacity(n: int) -> int:
    return max(_MIN_CAPACITY, 1 << math.ceil(math.log2(max(n, 1))))


def _key_bits_of(keys: Sequence[Any]) -> np.ndarray:
    """Top 32 bits of each key's canonical tie order, as uint32."""
    arr = np.asarray(keys)
    if arr.dtype.kind in ("i", "u", "b"):
        return (tie_order_u64(arr) >> np.uint64(32)).astype(np.uint32)
    return np.fromiter((tie_order(k) >> 32 for k in keys), dtype=np.uint32, count=len(keys))


def _bits_tensor(bits: np.ndarray, device) -> torch.Tensor:
    """uint32 key bits → their int32 bit patterns on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(bits, dtype=np.uint32).view(np.int32)).to(device)


def _topk_rows(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row top-k values and indices. Exact; the order among equal values
    is unspecified, which is why :func:`_canonical_select` never relies on it."""
    return torch.topk(x, k, dim=1)


def _canonical_select(
    scores: torch.Tensor,    # [Q, C] f32, -inf = invalid
    key_bits: torch.Tensor,  # [C] or [Q, C] int32 bit patterns of uint32 key bits
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k under the canonical (score desc, key asc) order, in two
    passes: pass 1 finds the k-th score per query; pass 2 takes a top-k over
    an int32 composite — 0x7FFFFFFF above that score, the inverted top 30 key
    bits for boundary ties, −1 otherwise. Fewer than k scores lie above the
    k-th, so the composite picks exactly the canonical set (equal-score keys
    that collide in those 30 bits fall back to top-k's own order, ~2^-30 per
    tied pair, as in the reference)."""
    top_scores0, _ = _topk_rows(scores, k)
    thr = top_scores0[:, -1:]
    above = scores > thr
    eq = (scores == thr) & torch.isfinite(scores)
    key30 = (key_bits.long() & 0xFFFFFFFF) >> 2
    inv_key30 = (0x3FFFFFFF - key30).to(torch.int32)
    if inv_key30.dim() == 1:
        inv_key30 = inv_key30[None, :].expand(scores.shape)
    top = torch.full_like(inv_key30, 0x7FFFFFFF)
    none = torch.full_like(inv_key30, -1)
    comp = torch.where(above, top, torch.where(eq, inv_key30, none))
    _c, top_ids = _topk_rows(comp, k)
    return torch.gather(scores, 1, top_ids), top_ids


#: query rows per score product (see :func:`_dots`)
_Q_CHUNK = 16
#: index rows per score product (see :func:`_dots`)
_N_TILE = 65536


def _row_sq_norms(x: torch.Tensor) -> torch.Tensor:
    """``Σ x²`` per row, in ``x``'s dtype, summed by
    :func:`~pathway_tpu_torch.ops._fixed_order.fixed_order_sum` (on the H100
    a 1-query norm and a 512-query norm taken by a reduction kernel round
    differently), so a row gets the same bits in any batch."""
    return fixed_order_sum(x * x, -1)


def _dots(queries: torch.Tensor, vectors: torch.Tensor) -> torch.Tensor:
    """``queries · vectorsᵀ`` in f32, as products of one fixed shape:
    ``_Q_CHUNK`` query rows (the last chunk zero-padded) times ``_N_TILE``
    index rows (the last tile zero-padded). cuBLAS picks its kernel by the
    product's shape, and kernels for other shapes round differently: on the
    H100 a query scores other bits in a 64-query than in a 512-query product,
    and a row other bits in a 4,096-row than in a 65,536-row product. With
    every product the same shape, a (query, row) pair scores the same bits in
    any query batch and in any index: the brute-force index at any capacity,
    the tiered index's hot shard and its cold-candidate rescore. So
    cross-tick microbatching changes no search result, and the tiered index
    answers as the brute-force index does. A 16 x 65,536 product still reads
    its tile of the index at the memory rate; an index below 65,536 rows pays
    for a padded tile."""
    q = queries.float()
    v = vectors.float()
    n_q, n = q.shape[0], v.shape[0]
    q_pad = -(-n_q // _Q_CHUNK) * _Q_CHUNK
    n_pad = -(-n // _N_TILE) * _N_TILE
    if q_pad != n_q:
        q = F.pad(q, (0, 0, 0, q_pad - n_q))
    if n_pad != n:
        v = F.pad(v, (0, 0, 0, n_pad - n))
    vt = v.T
    out = torch.empty((q_pad, n_pad), dtype=torch.float32, device=q.device)
    for lo in range(0, q_pad, _Q_CHUNK):
        for c in range(0, n_pad, _N_TILE):
            torch.matmul(
                q[lo : lo + _Q_CHUNK], vt[:, c : c + _N_TILE],
                out=out[lo : lo + _Q_CHUNK, c : c + _N_TILE],
            )
    return out[:n_q, :n]


def _search_body(
    vectors: torch.Tensor,   # [N, d]
    norms_sq: torch.Tensor,  # [N] f32 (row |v|^2, computed at ingest)
    valid: torch.Tensor,     # [N] bool
    key_bits: torch.Tensor,  # [N] int32
    queries: torch.Tensor,   # [Q, d]
    k: int,
    metric: str,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Scoring and selection shared by the resident search and the candidate
    rescore: one formula, so a row scores the same bits whichever touches it."""
    dots = _dots(queries, vectors)
    if metric == KnnMetric.L2SQ.value:
        qn = _row_sq_norms(queries)[:, None]
        # negative L2^2 so that "higher is better" uniformly
        scores = -(qn + norms_sq[None, :] - 2.0 * dots)
    elif metric == KnnMetric.COS.value:
        qn = _row_sq_norms(queries)[:, None].sqrt()
        denom = torch.clamp_min(qn * norms_sq.sqrt()[None, :], 1e-30)
        scores = dots / denom
    else:
        scores = dots
    scores = scores.masked_fill(~valid[None, :], -math.inf)
    if k == 0:
        q = queries.shape[0]
        return (
            torch.zeros((q, 0), dtype=scores.dtype, device=scores.device),
            torch.zeros((q, 0), dtype=torch.int64, device=scores.device),
        )
    return _canonical_select(scores, key_bits, k)


@functools.partial(_dev_prof.traced_jit, "knn.search")
@torch.inference_mode()
def _search_kernel(vectors, norms_sq, valid, key_bits, queries, k: int, metric: str):
    """(scores [Q, k], slot ids [Q, k]) over the resident index."""
    return _search_body(vectors, norms_sq, valid, key_bits, queries, k, metric)


@functools.partial(_dev_prof.traced_jit, "knn.rescore")
@torch.inference_mode()
def _rescore_kernel(rows, valid, key_bits, queries, k: int, metric: str):
    """Exact top-k over an ad-hoc candidate matrix; row norms use the ingest
    formula, so a candidate scores the same bits as in the resident index."""
    rows32 = rows.float()
    norms_sq = _row_sq_norms(rows32)
    return _search_body(rows, norms_sq, valid, key_bits, queries, k, metric)


def exact_rescore(
    rows: np.ndarray,        # [m, d] f32 candidate vectors
    keys: Sequence[Any],     # len m candidate keys
    queries,                 # [Q, d] numpy array or tensor
    k: int,
    metric: str = "cos",
    device=None,
) -> list[list[tuple[Any, float]]]:
    """Per-query exact top-k over an explicit candidate set with the resident
    search's math; the candidate count pads to a power-of-two capacity."""
    dev = resolve_device(device)
    m = len(keys)
    if m == 0:
        q = np.atleast_2d(np.asarray(queries))
        return [[] for _ in range(q.shape[0])]
    cap = _pad_to_capacity(m)
    mat = np.zeros((cap, rows.shape[1]), dtype=np.float32)
    mat[:m] = rows
    valid = np.zeros(cap, dtype=bool)
    valid[:m] = True
    bits = np.zeros(cap, dtype=np.uint32)
    bits[:m] = _key_bits_of(list(keys))
    if isinstance(queries, torch.Tensor):
        q = queries.to(dev, torch.float32)
        if q.dim() == 1:
            q = q[None, :]
    else:
        q = torch.from_numpy(np.atleast_2d(np.asarray(queries, np.float32))).to(dev)
    scores, ids = _rescore_kernel(
        torch.from_numpy(mat).to(dev), torch.from_numpy(valid).to(dev),
        _bits_tensor(bits, dev), q, k=min(k, cap), metric=metric,
    )
    slot_to_key = {i: key for i, key in enumerate(keys)}
    return _decode_hits(scores.cpu().numpy(), ids.cpu().numpy(), slot_to_key, k)


def _decode_hits(
    scores_np: np.ndarray, ids_np: np.ndarray, slot_to_key: dict, k: int
) -> list[list[tuple[Any, float]]]:
    """[Q, kk] results → per-query (key, score) lists in canonical order
    (score desc, key asc), dropping −inf entries and slots freed since the
    last flush."""
    out: list[list[tuple[Any, float]]] = []
    for qi in range(ids_np.shape[0]):
        hits: list[tuple[Any, float]] = []
        for j in range(ids_np.shape[1]):
            if not np.isfinite(scores_np[qi, j]):
                continue
            key = slot_to_key.get(int(ids_np[qi, j]))
            if key is not None:
                hits.append((key, float(scores_np[qi, j])))
        hits.sort(key=lambda kv: (-kv[1], tie_order(kv[0])))
        out.append(hits[:k])
    return out


@functools.partial(_dev_prof.traced_jit, "knn.scatter")
@torch.inference_mode()
def _scatter_block(vectors, norms_sq, valid, key_bits, slots, bits, rows) -> torch.Tensor:
    """One ingest scatter, in place: vectors (cast to the index dtype), f32
    norms computed from the rows BEFORE that cast (so host- and
    device-ingested rows score alike on a non-f32 index), validity and key
    bits."""
    rows32 = rows.float()
    vectors.index_put_((slots,), rows.to(vectors.dtype))
    norms_sq.index_put_((slots,), _row_sq_norms(rows32))
    valid.index_put_((slots,), torch.ones_like(slots, dtype=torch.bool))
    key_bits.index_put_((slots,), bits)
    # the last tensor written: the device plane waits on its stream
    return key_bits


@functools.partial(_dev_prof.traced_jit, "knn.pack_hits")
@torch.inference_mode()
def _pack_hits(scores: torch.Tensor, slot_ids: torch.Tensor) -> torch.Tensor:
    """Pack (scores [Q, k] f32, ids [Q, k]) into one [Q, 2k] f32 tensor so the
    results cross to the host in one fetch. Ids are value-cast, exact below
    2^24."""
    return torch.cat([scores.float(), slot_ids.float()], dim=1)


def _unpack_hits(packed: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    k = packed.shape[1] // 2
    return packed[:, :k], packed[:, k:].astype(np.int64)


@functools.partial(_dev_prof.traced_jit, "knn.invalidate")
@torch.inference_mode()
def _invalidate(valid: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    valid.index_put_((slots,), torch.zeros_like(slots, dtype=torch.bool))
    return valid


class BruteForceKnnIndex:
    """Single-device brute-force KNN with add/remove/search, resident on
    ``device`` (default: the card). Contract as the reference's external
    index: ``add(key, vector)``, ``remove(key)``, ``search(queries, k)``."""

    #: the device-resident state (everything else is host bookkeeping)
    _TENSORS = ("_vectors", "_norms_sq", "_valid", "_key_bits")

    def __init__(
        self,
        dimension: int,
        metric: KnnMetric | str = KnnMetric.COS,
        capacity: int = _MIN_CAPACITY,
        dtype: torch.dtype = torch.float32,
        device=None,
        component: str = "knn_index",
    ):
        self.device = resolve_device(device)
        self._mem_component = component
        self.dimension = dimension
        self.metric = KnnMetric(metric) if not isinstance(metric, KnnMetric) else metric
        self.dtype = dtype
        capacity = _pad_to_capacity(capacity)
        dev = self.device
        self._vectors = torch.zeros((capacity, dimension), dtype=dtype, device=dev)
        self._norms_sq = torch.zeros((capacity,), dtype=torch.float32, device=dev)
        self._valid = torch.zeros((capacity,), dtype=torch.bool, device=dev)
        # canonical tie-break bits per slot (top 32 bits of the key's tie order)
        self._key_bits = torch.zeros((capacity,), dtype=torch.int32, device=dev)
        # host-side bookkeeping
        self._key_to_slot: dict[Any, int] = {}
        self._slot_to_key: dict[int, Any] = {}
        self._free: list[int] = list(range(capacity - 1, -1, -1))
        # staged updates, flushed as one scatter before the next search
        self._pending_slots: list[int] = []
        self._pending_rows: list[np.ndarray] = []
        self._pending_bits: list[int] = []
        self._pending_invalidate: list[int] = []
        # device-resident staged blocks: (host slots, [m, d] device rows, host key bits)
        self._pending_device: list[tuple[np.ndarray, torch.Tensor, np.ndarray]] = []
        # memory attribution: index shards appear as
        # pathway_device_bytes{component="knn_index"} while this instance
        # lives (tiered indexes label their hot shard "knn_hot")
        _dev_prof.register_memory(self, component, lambda ix: ix.device_bytes())

    def device_bytes(self) -> int:
        """Device bytes of the index tensors (vectors, norms, validity, key bits)."""
        return sum(getattr(self, n).numel() * getattr(self, n).element_size() for n in self._TENSORS)

    def __getstate__(self):
        """Snapshot form: staged updates applied, tensors moved to the host."""
        self._flush()
        d = dict(self.__dict__)
        for name in self._TENSORS:
            d[name] = d[name].cpu()
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        for name in ("_vectors", "_norms_sq", "_valid"):
            setattr(self, name, d[name].to(self.device))
        # recompute the tie-break bits from the keys instead of trusting the
        # snapshot, which may come from another PATHWAY_HASH_SALT
        bits = np.zeros(len(d["_key_bits"]), dtype=np.uint32)
        if self._slot_to_key:
            slots = np.fromiter(self._slot_to_key, dtype=np.int64, count=len(self._slot_to_key))
            bits[slots] = _key_bits_of(list(self._slot_to_key.values()))
        self._key_bits = _bits_tensor(bits, self.device)
        # a restored index re-attributes its device bytes (weak registration
        # does not survive pickling)
        _dev_prof.register_memory(
            self,
            self.__dict__.get("_mem_component", "knn_index"),
            lambda ix: ix.device_bytes(),
        )

    # -- capacity ------------------------------------------------------------
    @property
    def capacity(self) -> int:
        return self._vectors.shape[0]

    def __len__(self) -> int:
        return len(self._key_to_slot)

    def _grow(self) -> None:
        old = self.capacity
        new = old * 2
        for name in self._TENSORS:
            t = getattr(self, name)
            setattr(self, name, torch.cat([t, torch.zeros_like(t)]))
        self._free.extend(range(new - 1, old - 1, -1))

    # -- mutation ------------------------------------------------------------
    def _stage_host(self, key: Any, vec: np.ndarray) -> None:
        if key in self._key_to_slot:
            slot = self._key_to_slot[key]  # upsert in place
        else:
            if not self._free:
                self._flush()
                self._grow()
            slot = self._free.pop()
            self._key_to_slot[key] = slot
            self._slot_to_key[slot] = key
        self._pending_slots.append(slot)
        self._pending_rows.append(vec)
        self._pending_bits.append(tie_order(key) >> 32)

    def add(self, key: Any, vector) -> None:
        vec = np.asarray(vector, dtype=np.float32)
        if vec.shape != (self.dimension,):
            raise ValueError(
                f"vector shape {vec.shape} != ({self.dimension},) for key {key!r}"
            )
        self._stage(key, vec)

    def add_batch(self, keys: Sequence[Any], vectors: np.ndarray) -> None:
        """Bulk add/upsert of host vectors."""
        vecs = np.asarray(vectors, dtype=np.float32)
        if vecs.shape != (len(keys), self.dimension):
            raise ValueError(
                f"vectors shape {vecs.shape} != ({len(keys)}, {self.dimension})"
            )
        for key, vec in zip(keys, vecs):
            self._stage(key, vec)

    def add_batch_device(self, keys: Sequence[Any], vectors: torch.Tensor) -> None:
        """Bulk add of embeddings already on the device (e.g. straight from
        the encoder): slots are assigned on the host, the rows never leave
        the device."""
        m = len(keys)
        if tuple(vectors.shape) != (m, self.dimension):
            raise ValueError(
                f"vectors shape {tuple(vectors.shape)} != ({m}, {self.dimension})"
            )
        if self._pending_slots:
            # host rows staged earlier must land first (staging order decides
            # the upsert winner)
            self._flush_host()
        slots = np.empty(m, dtype=np.int64)
        for i, key in enumerate(keys):
            slot = self._key_to_slot.get(key)
            if slot is None:
                if not self._free:
                    self._grow()
                slot = self._free.pop()
                self._key_to_slot[key] = slot
                self._slot_to_key[slot] = key
            slots[i] = slot
        bits = _key_bits_of(list(keys))
        if len(np.unique(slots)) != len(slots):
            # duplicate keys in one call: keep the last staging per slot
            last = {int(s): i for i, s in enumerate(slots)}
            keep = sorted(last.values())
            vectors = vectors[torch.as_tensor(keep, device=vectors.device)]
            slots = slots[keep]
            bits = bits[keep]
        self._pending_device.append((slots, vectors, bits))

    def remove(self, key: Any) -> None:
        slot = self._key_to_slot.pop(key, None)
        if slot is None:
            raise KeyError(f"KNN index: remove of unknown key {key!r}")
        del self._slot_to_key[slot]
        self._free.append(slot)
        self._pending_invalidate.append(slot)

    def _stage(self, key: Any, vec: np.ndarray) -> None:
        if self._pending_device:
            # keep global application order == staging order
            self._flush_device()
        self._stage_host(key, vec)

    def _flush(self) -> None:
        self._flush_host()
        self._flush_device()
        if self._pending_invalidate:
            # a slot may have been re-added after removal: only invalidate
            # slots that are free now
            free = set(self._free)
            dead = [s for s in self._pending_invalidate if s in free]
            if dead:
                _invalidate(self._valid, torch.as_tensor(dead, device=self.device))
            self._pending_invalidate = []

    def _flush_host(self) -> None:
        if self._pending_slots:
            # the same slot can be staged twice within one flush (upsert):
            # keep only the last staging per slot
            slot_arr = np.asarray(self._pending_slots, dtype=np.int64)
            rows, bits = self._pending_rows, self._pending_bits
            if len(np.unique(slot_arr)) != len(slot_arr):
                last = {int(s): i for i, s in enumerate(slot_arr)}
                keep = sorted(last.values())
                slot_arr = slot_arr[keep]
                rows = [rows[i] for i in keep]
                bits = [bits[i] for i in keep]
            # f32 rows: norms come from full precision before the cast to the
            # index dtype, as for device-ingested rows
            stacked = torch.from_numpy(np.stack(rows).astype(np.float32)).to(self.device)
            self._apply_scatter(slot_arr, np.asarray(bits, dtype=np.uint32), stacked)
            self._pending_slots, self._pending_rows, self._pending_bits = [], [], []

    def _apply_scatter(self, slots_np: np.ndarray, bits_np: np.ndarray, rows: torch.Tensor) -> None:
        _scatter_block(
            self._vectors, self._norms_sq, self._valid, self._key_bits,
            torch.from_numpy(slots_np).to(self.device), _bits_tensor(bits_np, self.device), rows,
        )

    def _flush_device(self) -> None:
        if self._pending_device:
            for slots, dev, bits in self._pending_device:
                self._apply_scatter(slots, bits, dev)
            self._pending_device = []

    # -- search --------------------------------------------------------------
    def _prep_queries(self, queries) -> torch.Tensor:
        if isinstance(queries, torch.Tensor):
            q = queries.to(self.device, self.dtype)
            if q.dim() == 1:
                q = q[None, :]
        else:
            q = torch.from_numpy(np.atleast_2d(np.asarray(queries, np.float32))).to(
                self.device, self.dtype
            )
        if q.shape[-1] != self.dimension:
            raise ValueError(f"query dim {q.shape[-1]} != {self.dimension}")
        return q

    def search_device(self, queries, k: int) -> tuple[torch.Tensor, torch.Tensor]:
        """(scores [Q, k], slot ids [Q, k]) on the device, with no host sync."""
        self._flush()
        q = self._prep_queries(queries)
        stats = _dev_prof.stats()
        if stats.enabled:
            # rough probe cost: one dot per (query, slot) pair over the PADDED
            # capacity — the padded-vs-valid gap is exactly the pad waste
            stats.note_flops(
                "knn.search", 2.0 * int(q.shape[0]) * self.capacity * self.dimension
            )
            stats.note_pad_rows("knn.search", len(self), self.capacity - len(self))
        return _search_kernel(
            self._vectors, self._norms_sq, self._valid, self._key_bits, q,
            k=min(k, self.capacity), metric=self.metric.value,
        )

    def search(self, queries, k: int) -> list[list[tuple[Any, float]]]:
        """Top-k per query as (key, score) lists, best first; scores follow
        the metric's "higher is better" convention (L2SQ is negated). Takes a
        device tensor directly (e.g. from ``encode_texts_device``); scores and
        ids come back packed in one device→host fetch."""
        scores, slot_ids = self.search_device(queries, k)
        scores_np, ids_np = self._fetch_hits(scores, slot_ids)
        return _decode_hits(scores_np, ids_np, self._slot_to_key, k)

    def _fetch_hits(
        self, scores: torch.Tensor, slot_ids: torch.Tensor
    ) -> tuple[np.ndarray, np.ndarray]:
        """One packed device→host fetch when the f32 value-cast of ids stays
        exact (capacity < 2^24); two plain fetches otherwise."""
        if self.capacity < (1 << 24):
            return _unpack_hits(_pack_hits(scores, slot_ids).cpu().numpy())
        return scores.cpu().numpy(), slot_ids.cpu().numpy()


def _shard_views(x, n_shards: int) -> list[torch.Tensor]:
    """Per-shard pieces of a global ``[N, ...]`` tensor (equal row slices,
    views), or the given per-shard list as is."""
    if isinstance(x, (list, tuple)):
        if len(x) != n_shards:
            raise ValueError(f"{len(x)} shard tensors for {n_shards} shards")
        return list(x)
    if x.shape[0] % n_shards:
        raise ValueError(f"{x.shape[0]} rows do not split into {n_shards} equal shards")
    return list(torch.chunk(x, n_shards, dim=0))


@torch.inference_mode()
def sharded_search(
    mesh,
    axis: str,
    vectors,    # [N, d] global, or one [N/n, d] tensor per shard
    norms_sq,   # [N] f32
    valid,      # [N] bool
    key_bits,   # [N] int32 bit patterns of the uint32 key bits
    queries: torch.Tensor,  # [Q, d]
    k: int,
    metric: str = "cos",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Search a KNN matrix split over the logical shards of ``mesh`` along
    ``axis``: each shard scores its rows and cuts its own top-k, the shards'
    candidates are gathered, and a global top-k merges them. Returns (scores
    [Q, k], global slot ids) on the first shard's device.

    Carried from the reference's ``sharded_search`` (``shard_map`` with an
    ``all_gather`` of the candidates). Each shard scores through
    :func:`_search_body` at ``k_local = min(k, shard_n)``, whose products
    have one fixed shape (:func:`_dots`), so a row scores the same bits as in
    a single index. Global slot ids are ``ids + shard_idx * shard_n``. The
    merge is :func:`_canonical_select` over the ``n_shards * k_local``
    candidates with their key bits, so equal-score rows are cut by key, not
    by shard order, and the shard count cannot change which ties survive.
    """
    devices = mesh.shard_devices(axis)
    n_shards = len(devices)
    vecs = _shard_views(vectors, n_shards)
    nsqs = _shard_views(norms_sq, n_shards)
    vals = _shard_views(valid, n_shards)
    bits = _shard_views(key_bits, n_shards)
    shard_n = vecs[0].shape[0]
    k_local = min(k, shard_n)
    # n_shards * k_local candidates always cover the true global top
    # min(k, N): either k_local == k or the candidate set is the whole index
    k_final = min(k, n_shards * k_local)
    first = devices[0]
    all_s, all_g, all_b = [], [], []
    for s, dev in enumerate(devices):
        sc, ids = _search_kernel(
            vecs[s].to(dev), nsqs[s].to(dev), vals[s].to(dev), bits[s].to(dev),
            queries.to(dev), k=k_local, metric=metric,
        )
        all_s.append(sc.to(first))
        all_g.append((ids + s * shard_n).to(first))
        # per-candidate key bits ride along for the merge
        all_b.append(bits[s].to(dev)[ids].to(first))
    cand_s = torch.cat(all_s, dim=1)
    cand_g = torch.cat(all_g, dim=1)
    cand_b = torch.cat(all_b, dim=1)
    ms, mi = _canonical_select(cand_s, cand_b, k_final)
    return ms, torch.gather(cand_g, 1, mi)


class ShardedBruteForceKnnIndex(BruteForceKnnIndex):
    """BruteForceKnnIndex whose slot matrix is split across the logical
    shards of a 1-D mesh axis.

    Slot ``i`` belongs to shard ``i // (N / n_shards)``; adds land in any free
    slot; search runs :func:`sharded_search`. The index tensors live on the
    first shard's device (every shard's, when the shards share one card);
    a shard on another device receives its slice at search."""

    def __init__(
        self,
        dimension: int,
        mesh,
        axis: str = "data",
        metric: KnnMetric | str = KnnMetric.COS,
        capacity: int = _MIN_CAPACITY,
        dtype: torch.dtype = torch.float32,
        component: str = "knn_index",
    ):
        self.mesh = mesh
        self.axis = axis
        n_dev = len(mesh.shard_devices(axis))
        capacity = _pad_to_capacity(max(capacity, n_dev * _MIN_CAPACITY))
        super().__init__(
            dimension, metric=metric, capacity=capacity, dtype=dtype,
            device=mesh.shard_devices(axis)[0], component=component,
        )

    def search_device(self, queries, k: int) -> tuple[torch.Tensor, torch.Tensor]:
        self._flush()
        q = self._prep_queries(queries)
        stats = _dev_prof.stats()
        if stats.enabled:
            stats.note_flops(
                "knn.search", 2.0 * int(q.shape[0]) * self.capacity * self.dimension
            )
            stats.note_pad_rows("knn.search", len(self), self.capacity - len(self))
        return sharded_search(
            self.mesh, self.axis, self._vectors, self._norms_sq, self._valid,
            self._key_bits, q, k=min(k, self.capacity), metric=self.metric.value,
        )
