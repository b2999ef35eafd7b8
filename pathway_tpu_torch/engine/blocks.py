"""Columnar delta blocks — the engine's unit of data.

The reference streams per-record ``(key, tuple, time, diff)`` updates through
differential operators (``src/engine/dataflow.rs``). That shape is hostile to XLA, so
per SURVEY §7.1.1 the TPU engine's unit is a **delta block**: aligned uint64 key
array, int64 diff (±weight) array, and a dict of columnar value arrays, all sharing a
logical timestamp. Relational kernels are vectorized over whole blocks;
consolidation is a sort + segmented reduction over (key, row-digest).

Carried from ``pathway_tpu/engine/blocks.py``, with the audit plane's
canonical-form check on every consolidated batch (``PATHWAY_AUDIT=full``).
"""

from __future__ import annotations

from typing import Any, Iterable, Mapping

import numpy as np

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.keys import hash_column, row_keys, splitmix64
from pathway_tpu_torch.observability import engine_phases as _phases


def _audit_current():
    # late import: blocks is imported before the observability package's
    # audit module finishes loading in some import orders
    from pathway_tpu_torch.observability.audit import current

    return current()


class DeltaBatch:
    __slots__ = ("keys", "diffs", "data", "time")

    def __init__(
        self,
        keys: np.ndarray,
        diffs: np.ndarray,
        data: Mapping[str, np.ndarray],
        time: int,
    ):
        self.keys = np.asarray(keys, dtype=np.uint64)
        self.diffs = np.asarray(diffs, dtype=np.int64)
        self.data = dict(data)
        self.time = time
        n = len(self.keys)
        assert len(self.diffs) == n, "diffs misaligned"
        for name, col in self.data.items():
            assert len(col) == n, f"column {name!r} misaligned: {len(col)} != {n}"

    def __len__(self) -> int:
        return len(self.keys)

    def __repr__(self) -> str:
        return f"DeltaBatch(n={len(self)}, t={self.time}, cols={list(self.data)})"

    @property
    def is_empty(self) -> bool:
        return len(self.keys) == 0

    def take(self, idx: np.ndarray) -> "DeltaBatch":
        return DeltaBatch(
            self.keys[idx],
            self.diffs[idx],
            {n: c[idx] for n, c in self.data.items()},
            self.time,
        )

    def with_data(self, data: Mapping[str, np.ndarray]) -> "DeltaBatch":
        return DeltaBatch(self.keys, self.diffs, data, self.time)

    def with_keys(self, keys: np.ndarray) -> "DeltaBatch":
        return DeltaBatch(keys, self.diffs, self.data, self.time)

    def select_columns(self, names: Iterable[str]) -> "DeltaBatch":
        return DeltaBatch(self.keys, self.diffs, {n: self.data[n] for n in names}, self.time)

    def negated(self) -> "DeltaBatch":
        return DeltaBatch(self.keys, -self.diffs, self.data, self.time)

    def rows(self) -> Iterable[tuple[int, int, tuple]]:
        # columnar → row tuples via one zip transpose (not a per-cell genexpr);
        # keys/diffs come out as python ints
        keys = self.keys.tolist()
        diffs = self.diffs.tolist()
        if self.data:
            yield from zip(keys, diffs, zip(*(column_to_list(c) for c in self.data.values())))
        else:
            empty = ()
            for k, d in zip(keys, diffs):
                yield k, d, empty

    def row_digest(self) -> np.ndarray:
        """uint64 digest of each row's values (keys excluded)."""
        n = len(self.keys)
        h = np.zeros(n, dtype=np.uint64)
        for name in sorted(self.data):
            with np.errstate(over="ignore"):
                h = splitmix64(h * np.uint64(0x100000001B3) ^ hash_column(self.data[name]))
        return h

    @staticmethod
    def empty(columns: Iterable[str], time: int) -> "DeltaBatch":
        return DeltaBatch(
            np.empty(0, dtype=np.uint64),
            np.empty(0, dtype=np.int64),
            {c: np.empty(0, dtype=object) for c in columns},
            time,
        )

    @staticmethod
    def from_rows(
        keys: Iterable[Any],
        rows: Iterable[tuple],
        columns: list[str],
        time: int,
        diffs: Iterable[int] | None = None,
        np_dtypes: Mapping[str, np.dtype] | None = None,
    ) -> "DeltaBatch":
        tok = _phases.start()
        keys_arr = (
            keys.astype(np.uint64, copy=False)
            if isinstance(keys, np.ndarray)
            else np.fromiter(keys, dtype=np.uint64)
        )
        n = len(keys_arr)
        rows = list(rows)
        data: dict[str, np.ndarray] = {}
        for j, name in enumerate(columns):
            npd = (np_dtypes or {}).get(name, np.dtype(object))
            data[name] = make_column([r[j] for r in rows], npd)
        diffs_arr = (
            np.ones(n, dtype=np.int64)
            if diffs is None
            else np.fromiter(diffs, dtype=np.int64, count=n)
        )
        _phases.stop(tok, "realloc")
        return DeltaBatch(keys_arr, diffs_arr, data, time)


def column_to_list(arr: np.ndarray) -> list:
    """Column → Python list for row-tuple assembly. datetime64/timedelta64 keep
    their numpy scalar form (``tolist()`` would yield raw ns integers)."""
    if arr.dtype.kind in ("M", "m"):
        return list(arr)
    return arr.tolist()


def make_column(values: list, np_dtype: np.dtype) -> np.ndarray:
    """Build a column array of the schema's storage dtype, falling back to object
    when values don't fit (None in an int column, etc.)."""
    if np_dtype == np.dtype(object):
        arr = np.empty(len(values), dtype=object)
        arr[:] = values
        return arr
    if np_dtype.kind == "b":
        # np.asarray silently coerces None to False, so bool needs the explicit
        # None scan before the typed conversion
        if not any(v is None for v in values):
            try:
                return np.asarray(values, dtype=np_dtype)
            except (TypeError, ValueError):
                pass
    else:
        # direct conversion first: the common all-typed case needs no None scan
        # (None raises TypeError and lands in the fallback below)
        try:
            return np.asarray(values, dtype=np_dtype)
        except (TypeError, ValueError):
            pass
    try:
        if any(v is None for v in values):
            if np_dtype.kind == "f":
                return np.asarray(
                    [np.nan if v is None else v for v in values], dtype=np_dtype
                )
            if np_dtype.kind in ("M", "m"):
                return np.asarray(
                    [np.datetime64("NaT") if v is None else v for v in values], dtype=np_dtype
                )
        arr = np.empty(len(values), dtype=object)
        arr[:] = values
        return arr
    except (TypeError, ValueError):
        arr = np.empty(len(values), dtype=object)
        arr[:] = values
        return arr


def concat_cols(parts: list[np.ndarray]) -> np.ndarray:
    """Concatenate column arrays; mixed dtypes merge into an object array.
    list() keeps datetime64/timedelta64 scalars intact (direct slice-assign
    into an object array int-ifies them)."""
    if len(parts) == 1:
        return parts[0]
    if all(p.dtype == parts[0].dtype for p in parts):
        return np.concatenate(parts)
    merged = np.empty(sum(len(p) for p in parts), dtype=object)
    ofs = 0
    for p in parts:
        merged[ofs : ofs + len(p)] = list(p) if p.dtype.kind in ("M", "m") else p
        ofs += len(p)
    return merged


def group_starts(sorted_keys: np.ndarray) -> np.ndarray:
    """Boundary indices of equal-key runs in a sorted key array."""
    n = len(sorted_keys)
    if n == 0:
        return np.empty(0, dtype=np.int64)
    boundaries = np.empty(n, dtype=bool)
    boundaries[0] = True
    boundaries[1:] = sorted_keys[1:] != sorted_keys[:-1]
    return np.flatnonzero(boundaries)


def concat_batches(batches: list[DeltaBatch]) -> DeltaBatch | None:
    batches = [b for b in batches if not b.is_empty]
    if not batches:
        return None
    if len(batches) == 1:
        return batches[0]
    tok = _phases.start()
    time = batches[-1].time
    keys = np.concatenate([b.keys for b in batches])
    diffs = np.concatenate([b.diffs for b in batches])
    names = batches[0].data.keys()
    data = {n: concat_cols([b.data[n] for b in batches]) for n in names}
    _phases.stop(tok, "realloc")
    return DeltaBatch(keys, diffs, data, time)


def consolidate(batch: DeltaBatch, unique_hint: bool = False) -> DeltaBatch:
    """Sum diffs per (key, row-digest); drop rows with net diff 0.

    The block analogue of differential's arrangement consolidation. Canonical
    output order: sorted by key, then net diff ascending (retractions precede
    insertions), then row digest — deterministic for any input permutation.

    ``unique_hint=True``: the caller expects the batch's keys to be unique
    (e.g. an incremental join's per-tick output, keyed by (left, right) row
    pairs) — attempt the digest-free unique-key fast path even for
    mixed-sign batches. Purely a cost hint; a wrong hint costs one wasted
    argsort and falls through to the general path.
    """
    if len(batch) <= 1:
        if len(batch) == 1 and batch.diffs[0] == 0:
            return batch.take(np.empty(0, dtype=np.int64))
        return batch
    tok = _phases.start()
    out = _consolidate_impl(batch, unique_hint)
    _phases.stop(tok, "consolidate")
    aud = _audit_current()
    if aud is not None:
        # PATHWAY_AUDIT=full: verify the canonical/net-free contract on every
        # consolidated batch (no-op in "on" mode — see check_canonical)
        aud.check_canonical(out, "consolidate")
    return out


def _consolidate_impl(batch: DeltaBatch, unique_hint: bool = False) -> DeltaBatch:
    # fast path — unique keys. Netting and merging happen per (key, digest),
    # so a batch with no duplicate KEY cannot net or merge at all: the
    # canonical form is just the key sort (within-key diff/digest ordering
    # is vacuous for singleton groups) with zero diffs dropped, and the
    # per-column row-digest hash — the dominant cost of the general path —
    # is skipped entirely. Attempted when the batch is all-inserts (every
    # freshly-polled input block) or the caller hinted uniqueness (an
    # incremental join's per-tick output: unique (left, right)-pair keys,
    # mixed signs under churn — r15: its digest hash was ~1ms of every
    # churn tick). Duplicate-key batches without the hint (groupby
    # retract+insert emissions) skip straight to the general path, paying
    # no speculative sort.
    if unique_hint or bool((batch.diffs > 0).all()):
        order = np.argsort(batch.keys, kind="stable")
        k = batch.keys[order]
        if not bool((k[1:] == k[:-1]).any()):
            if bool((batch.diffs != 0).all()):
                return batch.take(order)
            kept = order[batch.diffs[order] != 0]
            return batch.take(kept)
    digests = batch.row_digest()
    order = np.lexsort((digests, batch.keys))
    k = batch.keys[order]
    d = digests[order]
    boundaries = np.empty(len(k), dtype=bool)
    boundaries[0] = True
    boundaries[1:] = (k[1:] != k[:-1]) | (d[1:] != d[:-1])
    group_starts = np.flatnonzero(boundaries)
    sums = np.add.reduceat(batch.diffs[order], group_starts)
    keep = sums != 0
    kept_idx = order[group_starts[keep]]
    kept_sums = sums[keep].astype(np.int64)
    kept_keys = k[group_starts[keep]]
    # canonical order: within a key, retractions precede insertions, so stateful
    # consumers (capture/combine/join state) can apply rows in batch order
    final = np.lexsort((kept_sums, kept_keys))
    out = batch.take(kept_idx[final])
    out.diffs = kept_sums[final]
    return out


def net_input_batch(batch: DeltaBatch) -> DeltaBatch:
    """Net a freshly-polled input block — ``consolidate`` semantics, minus the
    canonical key sort when the block provably cannot net: all inserts, no
    duplicate keys, the overwhelmingly common poll shape. Such a block is
    returned AS IS, in arrival order, removing an O(n log n) +
    full-block-copy tax from every streaming tick (BASELINE §incremental).

    Arrival order is deterministic (it is the connector log's order, polled
    on the owning worker), and consolidating sinks (subscribe, output
    writers, final captured state) re-canonicalize at emission, so results
    are unchanged. The one observable difference: the RAW per-tick update
    stream of a passthrough pipeline (``CaptureNode.deltas`` /
    ``compute_and_print_update_stream``) now lists a net-free input block's
    rows in arrival order rather than key-sorted — same multiset, same
    determinism, different within-tick order."""
    if len(batch) <= 1:
        if len(batch) == 1 and batch.diffs[0] == 0:
            return batch.take(np.empty(0, dtype=np.int64))
        return batch
    if bool((batch.diffs > 0).all()):
        k = np.sort(batch.keys)
        if not bool((k[1:] == k[:-1]).any()):
            return batch
    return consolidate(batch)


def _member(keys: np.ndarray, sorted_set: np.ndarray) -> np.ndarray:
    """bool[n]: is each key in the sorted unique ``sorted_set``."""
    if not len(sorted_set) or not len(keys):
        return np.zeros(len(keys), dtype=bool)
    pos = np.searchsorted(sorted_set, keys).clip(0, len(sorted_set) - 1)
    return sorted_set[pos] == keys


def interleave_positions(
    a_keys: np.ndarray, b_keys: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Merged positions for two SORTED key runs: ``(ia, ib)`` such that
    scattering ``a`` to ``ia`` and ``b`` to ``ib`` yields one sorted run.
    On ties, ``a``'s rows precede ``b``'s (side=left/right below) — the
    order a stable argsort over their concatenation would give. The shared
    primitive behind the groupby state merge, segment compaction and
    ``merge_consolidated``."""
    ia = np.arange(len(a_keys), dtype=np.int64) + np.searchsorted(
        b_keys, a_keys, side="left"
    )
    ib = np.arange(len(b_keys), dtype=np.int64) + np.searchsorted(
        a_keys, b_keys, side="right"
    )
    return ia, ib


def scatter_cols(parts: list[np.ndarray], positions: list[np.ndarray], total: int) -> np.ndarray:
    """Scatter column parts to their merged positions (concat_cols dtype
    discipline: same dtypes keep them, mixes degrade to object with
    datetime64 scalars kept intact)."""
    live = [p for p in parts if len(p)]
    if live and all(p.dtype == live[0].dtype for p in live):
        out = np.empty(total, dtype=live[0].dtype)
    else:
        out = np.empty(total, dtype=object)
    for p, pos in zip(parts, positions):
        if not len(p):
            continue
        if out.dtype == object and p.dtype.kind in ("M", "m"):
            out[pos] = list(p)
        else:
            out[pos] = p
    return out


def merge_consolidated(base: DeltaBatch | None, delta: DeltaBatch | None) -> DeltaBatch | None:
    """O(delta)-flavored consolidation: merge two **individually consolidated**
    batches into one consolidated batch, byte-identical to
    ``consolidate(concat_batches([base, delta]))``.

    Keys present on only one side pass through untouched — no re-sort, no
    re-hash of the disjoint bulk. Only the rows of keys present on BOTH sides
    (the actually-contended state) are re-consolidated at digest granularity;
    the three sorted runs are then interleaved by searchsorted positions.
    This is the block engine's analogue of differential's merge batching: an
    already-consolidated arrangement absorbs a consolidated delta at cost
    proportional to the overlap, not the world.
    """
    if base is None or base.is_empty:
        return delta
    if delta is None or delta.is_empty:
        return base
    tok = _phases.start()
    try:
        a_keys, b_keys = base.keys, delta.keys
        a_uk = a_keys[group_starts(a_keys)]
        b_uk = b_keys[group_starts(b_keys)]
        pos = np.searchsorted(b_uk, a_uk).clip(0, len(b_uk) - 1)
        shared = a_uk[b_uk[pos] == a_uk]
        a_sh = _member(a_keys, shared)
        b_sh = _member(b_keys, shared)
        parts: list[DeltaBatch] = []
        a_rest = base.take(np.flatnonzero(~a_sh)) if a_sh.any() else base
        b_rest = delta.take(np.flatnonzero(~b_sh)) if b_sh.any() else delta
        parts.append(a_rest)
        parts.append(b_rest)
        if len(shared):
            sub = concat_batches(
                [base.take(np.flatnonzero(a_sh)), delta.take(np.flatnonzero(b_sh))]
            )
            net = _consolidate_impl(sub) if sub is not None and len(sub) > 1 else sub
            if net is not None and len(net):
                parts.append(net)
        parts = [p for p in parts if p is not None and len(p)]
        if not parts:
            return DeltaBatch.empty(base.data.keys(), delta.time)
        if len(parts) == 1:
            only = parts[0]
            return DeltaBatch(only.keys, only.diffs, only.data, delta.time)
        # interleave: keys are disjoint ACROSS parts, so each row's merged
        # position is its own index plus the count of smaller keys elsewhere
        # (the k-part generalization of interleave_positions)
        key_parts = [p.keys for p in parts]
        total = sum(len(k) for k in key_parts)
        positions: list[np.ndarray] = []
        for i, ki in enumerate(key_parts):
            pos_i = np.arange(len(ki), dtype=np.int64)
            for j, kj in enumerate(key_parts):
                if i != j:
                    pos_i += np.searchsorted(kj, ki)
            positions.append(pos_i)
        out_keys = np.empty(total, dtype=np.uint64)
        out_diffs = np.empty(total, dtype=np.int64)
        for p, pos_i in zip(parts, positions):
            out_keys[pos_i] = p.keys
            out_diffs[pos_i] = p.diffs
        names = list(base.data.keys())
        data = {
            n: scatter_cols([p.data[n] for p in parts], positions, total)
            for n in names
        }
        return DeltaBatch(out_keys, out_diffs, data, delta.time)
    finally:
        _phases.stop(tok, "consolidate")


def apply_diffs_to_state(state: dict, batch: DeltaBatch) -> None:
    """Fold a delta batch into a key→row-tuple dict (last-write-wins per key,
    respecting diffs: -1 removes, +1 inserts)."""
    cols = list(batch.data.values())
    for i in range(len(batch.keys)):
        k = int(batch.keys[i])
        if batch.diffs[i] > 0:
            state[k] = tuple(c[i] for c in cols)
        else:
            state.pop(k, None)
