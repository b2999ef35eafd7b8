"""Columnar incremental-operator state.

The reference keeps operator state in differential arrangements — sorted
(key, value, time, diff) tries maintained by merge batching
(``external/differential-dataflow/src/trace``). The block engine's analogue is a
**sorted-segment columnar multimap**: state lives in numpy arrays (LSM-style
segments with tombstones, compacted on churn), so every delta block — not just
the first load — is applied with searchsorted/repeat-expansion vectorized
kernels instead of per-row dict updates. Segments are sorted *lazily*: an
insert only parks the arrays; a probe against a still-unsorted segment sorts
the (usually much smaller) query side instead, and a segment is sorted in
place only once it keeps being probed. This keeps the incremental path within
a constant factor of the static path.

Carried from ``pathway_tpu/engine/colstore.py``. The probe routes through
``engine/torch_kernels.py``; unlike the reference, a routed probe that fails
raises instead of falling back to numpy.
"""

from __future__ import annotations

import numpy as np

from pathway_tpu_torch.engine import torch_kernels
from pathway_tpu_torch.engine.blocks import (
    concat_cols,
    group_starts,
    interleave_positions,
    scatter_cols,
)
from pathway_tpu_torch.observability import engine_phases as _phases


class _Segment:
    __slots__ = ("jk", "rk", "cols", "dead", "n_dead", "sorted", "probes")

    def __init__(
        self, jk: np.ndarray, rk: np.ndarray, cols: list[np.ndarray], is_sorted: bool
    ):
        self.jk = jk
        self.rk = rk
        self.cols = cols
        self.dead: np.ndarray | None = None  # bool mask, lazily allocated
        self.n_dead = 0
        self.sorted = is_sorted
        self.probes = 0

    def __len__(self) -> int:
        return len(self.jk)

    @property
    def n_live(self) -> int:
        return len(self.jk) - self.n_dead

    def sort(self) -> None:
        tok = _phases.start()
        order = np.argsort(self.jk, kind="stable")
        self.jk = self.jk[order]
        self.rk = self.rk[order]
        self.cols = [c[order] for c in self.cols]
        if self.dead is not None:
            self.dead = self.dead[order]
        self.sorted = True
        _phases.stop(tok, "rehash")


def _merge_sorted_segments(a: "_Segment", b: "_Segment", n_cols: int) -> "_Segment":
    """Interleave two sorted segments by searchsorted positions (no argsort).
    Equal join keys keep part order: ``a``'s rows precede ``b``'s — the same
    tie discipline a stable argsort over their concatenation would give."""
    na, nb = len(a), len(b)
    ia, ib = interleave_positions(a.jk, b.jk)
    total = na + nb
    jk = np.empty(total, dtype=np.uint64)
    jk[ia] = a.jk
    jk[ib] = b.jk
    rk = np.empty(total, dtype=np.uint64)
    rk[ia] = a.rk
    rk[ib] = b.rk
    positions = [ia, ib]
    cols = [
        scatter_cols([a.cols[i], b.cols[i]], positions, total) for i in range(n_cols)
    ]
    return _Segment(jk, rk, cols, is_sorted=True)


def _expand_ranges(lo: np.ndarray, cnt: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(probe_idx, offset) pairs for searchsorted range hits: probe ``i``
    expands to offsets ``lo[i] .. lo[i]+cnt[i]``."""
    total = int(cnt.sum())
    probe_idx = np.repeat(np.arange(len(cnt)), cnt)
    csum = np.cumsum(cnt) - cnt
    ofs = np.repeat(lo, cnt) + np.arange(total) - np.repeat(csum, cnt)
    return probe_idx, ofs


class ColumnarMultimap:
    """Multimap join-key → rows, vectorized for whole-block probe/insert/delete.

    Rows are (jk, rk, col-values...) with rk unique across the map. Inserts
    append a segment; deletes set tombstones; probes run
    searchsorted + repeat-expansion over every segment (sorting whichever of
    segment/query is cheaper). Compaction merges segments once they multiply
    or tombstones dominate.
    """

    MAX_SEGMENTS = 12
    # insert-time backstop: an arrangement that is never probed or deleted
    # (a one-sided-quiet join store) must still not fragment without bound
    MAX_SEGMENTS_HARD = 64
    # segments at most this size are sorted eagerly on first probe
    SMALL_SEGMENT = 4096

    def __init__(self, n_cols: int):
        self.n_cols = n_cols
        self.segments: list[_Segment] = []
        self.n_live = 0

    def __len__(self) -> int:
        return self.n_live

    # ------------------------------------------------------------------ writes

    def insert(self, jk: np.ndarray, rk: np.ndarray, cols: list[np.ndarray]) -> None:
        if not len(jk):
            return
        seg = _Segment(jk, rk, list(cols), is_sorted=False)
        self.segments.append(seg)
        self.n_live += len(seg)
        # segment-count compaction normally triggers on the next probe/delete
        # (see match/delete) — an arrangement that only ever absorbs inserts
        # (an insert-mostly join side whose opposite side went quiet) pays
        # nothing until something actually reads it. The HARD bound is the
        # memory-fragmentation backstop for exactly that never-read shape.
        if len(self.segments) > self.MAX_SEGMENTS_HARD:
            self._compact()

    def delete(self, jk: np.ndarray, rk: np.ndarray) -> None:
        """Tombstone the rows with the given (jk, rk) pairs (rk decides)."""
        if not len(jk):
            return
        tok = _phases.start()
        try:
            self._delete_impl(jk, rk)
        finally:
            _phases.stop(tok, "rehash")

    def _delete_impl(self, jk: np.ndarray, rk: np.ndarray) -> None:
        if len(self.segments) > self.MAX_SEGMENTS:
            self._compact_impl()
        removed = 0
        d_order: np.ndarray | None = None  # lazy sort of the delete keys
        for seg in self.segments:
            if not seg.n_live:
                continue
            if seg.sorted:
                lo = np.searchsorted(seg.jk, jk, side="left")
                hi = np.searchsorted(seg.jk, jk, side="right")
                q_idx, ofs = _expand_ranges(lo, hi - lo)
            else:
                if d_order is None:
                    d_order = np.argsort(jk, kind="stable")
                    d_sorted = jk[d_order]
                lo = np.searchsorted(d_sorted, seg.jk, side="left")
                hi = np.searchsorted(d_sorted, seg.jk, side="right")
                ofs, into_d = _expand_ranges(lo, hi - lo)
                q_idx = d_order[into_d]
            if not len(ofs):
                continue
            hit = seg.rk[ofs] == rk[q_idx]
            if seg.dead is not None:
                hit &= ~seg.dead[ofs]
            # unique: duplicate delete requests in ONE call match the same
            # still-alive offset twice — counting it twice corrupts
            # n_dead/n_live (rows turn invisible, compaction drops live
            # segments). Dedup keeps the kill-all-matching-copies semantics
            # while counting each physical row once.
            kill = np.unique(ofs[hit])
            if len(kill):
                if seg.dead is None:
                    seg.dead = np.zeros(len(seg), dtype=bool)
                seg.dead[kill] = True
                seg.n_dead += len(kill)
                removed += len(kill)
        self.n_live -= removed
        total_rows = sum(len(s) for s in self.segments)
        if total_rows and total_rows > 2 * self.n_live:
            self._compact()

    def _compact(self) -> None:
        tok = _phases.start()
        try:
            self._compact_impl()
        finally:
            _phases.stop(tok, "rehash")

    def _compact_impl(self) -> None:
        live_parts: list[_Segment] = []
        for seg in self.segments:
            if seg.n_dead == 0:
                live_parts.append(seg)
            elif seg.n_live > 0:
                keep = ~seg.dead
                live_parts.append(
                    _Segment(
                        seg.jk[keep],
                        seg.rk[keep],
                        [c[keep] for c in seg.cols],
                        bool(seg.sorted),
                    )
                )
        if not live_parts:
            self.segments = []
            return
        # O(delta) re-arrangement: the already-sorted base segment(s) are
        # MERGED, not re-sorted — only the fresh (unsorted) churn pays an
        # argsort, at its own size. Runs of consecutive unsorted parts are
        # concat+argsorted together (stable: equal keys keep part order),
        # then the sorted runs fold-merge by searchsorted positions, which
        # also keeps equal keys in part order — byte-identical to the old
        # whole-arrangement stable argsort.
        runs: list[_Segment] = []
        pending: list[_Segment] = []

        def _flush_pending() -> None:
            if not pending:
                return
            if len(pending) == 1:
                part = pending[0]
            else:
                jk = np.concatenate([s.jk for s in pending])
                rk = np.concatenate([s.rk for s in pending])
                cols = [
                    concat_cols([s.cols[i] for s in pending])
                    for i in range(self.n_cols)
                ]
                part = _Segment(jk, rk, cols, is_sorted=False)
            if not part.sorted:
                part.sort()
            runs.append(part)
            pending.clear()

        for part in live_parts:
            if part.sorted:
                _flush_pending()
                runs.append(part)
            else:
                pending.append(part)
        _flush_pending()
        merged = runs[0]
        for nxt in runs[1:]:
            merged = _merge_sorted_segments(merged, nxt, self.n_cols)
        # no-tombstone invariant for the compacted base: live_parts strips
        # dead rows before merging, and merges never introduce tombstones
        assert merged.dead is None
        self.segments = [merged]

    # ------------------------------------------------------------------ probes

    @staticmethod
    def _probe_sorted(seg: _Segment, q_jk: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(lo, count) match ranges of each probe key in a sorted segment —
        ``torch_kernels.join_probe`` for big probes, numpy searchsorted
        otherwise."""
        if torch_kernels.probe_eligible(len(seg), len(q_jk)):
            # no catch-and-fall-back: a routed probe that fails raises
            tok = _phases.start()
            try:
                return torch_kernels.join_probe(seg.jk, q_jk)
            finally:
                _phases.stop(tok, "kernel")
        lo = np.searchsorted(seg.jk, q_jk, side="left")
        cnt = np.searchsorted(seg.jk, q_jk, side="right") - lo
        return lo, cnt

    def _empty_match(self) -> tuple[np.ndarray, np.ndarray, list[np.ndarray]]:
        return (
            np.empty(0, dtype=np.int64),
            np.empty(0, dtype=np.uint64),
            [np.empty(0, dtype=object) for _ in range(self.n_cols)],
        )

    def match(
        self, q_jk: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray, list[np.ndarray]]:
        """All live rows matching each probe key.

        Returns ``(q_idx, rk, cols)`` where ``q_idx[i]`` is the index into
        ``q_jk`` that row ``i`` matched.
        """
        if not len(q_jk) or not self.segments:
            return self._empty_match()
        tok = _phases.start()
        try:
            return self._match_impl(q_jk)
        finally:
            _phases.stop(tok, "probe")

    def _match_impl(
        self, q_jk: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray, list[np.ndarray]]:
        if len(self.segments) > self.MAX_SEGMENTS:
            self._compact()
        # fast path — the steady state after compaction: one sorted,
        # tombstone-free segment. Probe and gather directly, no per-segment
        # parts lists and no concat.
        if len(self.segments) == 1:
            seg = self.segments[0]
            if seg.sorted and seg.dead is None and seg.n_live:
                lo, cnt = self._probe_sorted(seg, q_jk)
                q_idx, ofs = _expand_ranges(lo, cnt)
                if not len(ofs):
                    return self._empty_match()
                return (
                    q_idx,
                    seg.rk[ofs],
                    [seg.cols[i][ofs] for i in range(self.n_cols)],
                )
        q_parts: list[np.ndarray] = []
        rk_parts: list[np.ndarray] = []
        col_parts: list[list[np.ndarray]] = [[] for _ in range(self.n_cols)]
        q_order: np.ndarray | None = None  # lazy sort of the probe keys
        for seg in self.segments:
            if not seg.n_live:
                continue
            if not seg.sorted:
                seg.probes += 1
                # a repeatedly-probed or small segment earns its own sort;
                # otherwise sort the (smaller) query side instead
                if seg.probes >= 2 or len(seg) <= max(self.SMALL_SEGMENT, len(q_jk)):
                    seg.sort()
            if seg.sorted:
                lo, cnt = self._probe_sorted(seg, q_jk)
                q_idx, ofs = _expand_ranges(lo, cnt)
            else:
                if q_order is None:
                    q_order = np.argsort(q_jk, kind="stable")
                    q_sorted = q_jk[q_order]
                lo = np.searchsorted(q_sorted, seg.jk, side="left")
                hi = np.searchsorted(q_sorted, seg.jk, side="right")
                ofs, into_q = _expand_ranges(lo, hi - lo)
                q_idx = q_order[into_q]
            if not len(ofs):
                continue
            if seg.dead is not None:
                alive = ~seg.dead[ofs]
                q_idx = q_idx[alive]
                ofs = ofs[alive]
                if not len(ofs):
                    continue
            q_parts.append(q_idx)
            rk_parts.append(seg.rk[ofs])
            for i in range(self.n_cols):
                col_parts[i].append(seg.cols[i][ofs])
        if not q_parts:
            return self._empty_match()
        return (
            np.concatenate(q_parts),
            np.concatenate(rk_parts),
            [concat_cols(parts) for parts in col_parts],
        )

    def iter_live(self):
        """Yield (jk, rk, cols) arrays of live rows, segment by segment
        (snapshot/introspection use)."""
        for seg in self.segments:
            if not seg.n_live:
                continue
            if seg.dead is None:
                yield seg.jk, seg.rk, seg.cols
            else:
                keep = ~seg.dead
                yield seg.jk[keep], seg.rk[keep], [c[keep] for c in seg.cols]


class SortedCounts:
    """Sorted unique-key → int count, with batch add returning 0↔+ transitions
    (drives outer-join padding flips without per-key dict lookups)."""

    def __init__(self) -> None:
        self.keys = np.empty(0, dtype=np.uint64)
        self.counts = np.empty(0, dtype=np.int64)

    def get(self, q: np.ndarray) -> np.ndarray:
        if not len(self.keys):
            return np.zeros(len(q), dtype=np.int64)
        pos = np.searchsorted(self.keys, q).clip(0, len(self.keys) - 1)
        hit = self.keys[pos] == q
        out = np.zeros(len(q), dtype=np.int64)
        out[hit] = self.counts[pos[hit]]
        return out

    def add(
        self, keys: np.ndarray, deltas: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Apply per-row deltas; returns (unique_keys, prev_count, new_count)."""
        order = np.argsort(keys, kind="stable")
        ks = keys[order]
        starts = group_starts(ks)
        uniq = ks[starts]
        delta_sum = np.add.reduceat(deltas[order], starts)
        prev = self.get(uniq)
        new = prev + delta_sum
        # merge updated counts back into the sorted store
        pos = (
            np.searchsorted(self.keys, uniq).clip(0, max(len(self.keys) - 1, 0))
            if len(self.keys)
            else np.zeros(len(uniq), dtype=np.int64)
        )
        hit = (self.keys[pos] == uniq) if len(self.keys) else np.zeros(len(uniq), dtype=bool)
        self.counts[pos[hit]] = new[hit]
        fresh = ~hit
        if fresh.any():
            add_mask = fresh & (new != 0)
            if add_mask.any():
                merged_keys = np.concatenate([self.keys, uniq[add_mask]])
                merged_counts = np.concatenate([self.counts, new[add_mask]])
                o = np.argsort(merged_keys, kind="stable")
                self.keys = merged_keys[o]
                self.counts = merged_counts[o]
        # drop zeroed entries opportunistically when they accumulate
        if len(self.keys) and (self.counts == 0).sum() > len(self.keys) // 2:
            keep = self.counts != 0
            self.keys = self.keys[keep]
            self.counts = self.counts[keep]
        return uniq, prev, new




class ColumnarKeyedStore:
    """Keyed single-row-per-key columnar map over :class:`ColumnarMultimap`
    (jk == rk == the row key): upserts tombstone the previous row, probes
    return presence masks + key-aligned column arrays."""

    def __init__(self, n_cols: int):
        self.mm = ColumnarMultimap(n_cols)

    def __len__(self) -> int:
        return len(self.mm)

    def delete(self, keys: np.ndarray) -> None:
        self.mm.delete(keys, keys)

    def upsert(self, keys: np.ndarray, cols: list[np.ndarray]) -> None:
        self.mm.delete(keys, keys)
        self.mm.insert(keys, keys, cols)

    def get(self, keys: np.ndarray) -> tuple[np.ndarray, list[np.ndarray]]:
        """(present bool[n], aligned object columns with None where absent)."""
        q_idx, _rk, cols = self.mm.match(keys)
        present = np.zeros(len(keys), dtype=bool)
        present[q_idx] = True
        aligned: list[np.ndarray] = []
        for c in cols:
            out = np.empty(len(keys), dtype=object)
            if len(q_idx):
                # list() keeps datetime64 scalars intact in object storage
                out[q_idx] = list(c) if c.dtype.kind in ("M", "m") else c
            aligned.append(out)
        return present, aligned
