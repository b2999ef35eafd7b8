"""``Table._gradual_broadcast`` — churn-minimizing threshold broadcast.

Counterpart of the reference's ``gradual_broadcast.rs`` timely operator: a
(lower, value, upper) triplet stream apportions the key space so that a
``(value - lower) / (upper - lower)`` fraction of the rows (by uint64 key
order) carry ``upper`` as their ``apx_value`` and the rest carry ``lower``.
When the triplet moves, only the rows whose keys lie between the old and new
threshold flip — the whole point of the operator (used by Adaptive RAG to roll
a new parameter out to a growing fraction of queries without retracting every
row).

The columnar twist here: row keys are kept as a sorted array, so a threshold
move finds the flipped span with two ``searchsorted`` calls and emits one
block — no per-row work.

Carried from ``pathway_tpu/internals/gradual_broadcast.py``.
"""

from __future__ import annotations

import numpy as np

from pathway_tpu_torch.engine.blocks import DeltaBatch
from pathway_tpu_torch.engine.graph import SOLO, Node
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.logical import LogicalNode
from pathway_tpu_torch.internals.universe import Universe

# shy of 2**64 so float rounding can never overflow the uint64 conversion
_KEY_MAX = 2**64 - 2**12


class GradualBroadcastNode(Node):
    name = "gradual_broadcast"

    snapshot_attrs = ("keys_sorted", "triplet")

    def __init__(self, lower_col: str, value_col: str, upper_col: str):
        super().__init__(n_inputs=2)  # 0: main rows, 1: threshold triplet
        self.lower_col = lower_col
        self.value_col = value_col
        self.upper_col = upper_col
        self.keys_sorted = np.empty(0, dtype=np.uint64)
        self.triplet: tuple[float, float, float] | None = None

    def exchange_key(self, port):
        return SOLO  # threshold is a broadcast scalar; key space is global

    def _threshold_key(self) -> np.uint64:
        lower, value, upper = self.triplet
        if upper == lower:
            frac = 1.0
        else:
            frac = min(max((value - lower) / (upper - lower), 0.0), 1.0)
        return np.uint64(int(frac * _KEY_MAX))

    def _emit(self, keys: np.ndarray, diffs: np.ndarray, time: int) -> DeltaBatch:
        lower, _value, upper = self.triplet
        thr = self._threshold_key()
        vals = np.where(keys < thr, upper, lower)
        return DeltaBatch(keys, diffs, {"apx_value": vals}, time)

    def process(self, inputs, time):
        out: list[DeltaBatch] = []
        thr_batch = inputs[1]
        main_batch = inputs[0]
        # threshold moves first: flips apply to the rows present *before*
        # this tick's row additions (those emit against the new triplet)
        if thr_batch is not None and len(thr_batch):
            ins = np.flatnonzero(thr_batch.diffs > 0)
            if len(ins):
                i = ins[-1]  # latest triplet wins within a tick
                new_triplet = (
                    float(thr_batch.data[self.lower_col][i]),
                    float(thr_batch.data[self.value_col][i]),
                    float(thr_batch.data[self.upper_col][i]),
                )
                old = self.triplet
                if old is not None and len(self.keys_sorted):
                    old_thr = self._threshold_key()
                    self.triplet = new_triplet
                    new_thr = self._threshold_key()
                    lo, hi = min(old_thr, new_thr), max(old_thr, new_thr)
                    a = int(np.searchsorted(self.keys_sorted, lo))
                    b = int(np.searchsorted(self.keys_sorted, hi))
                    span = self.keys_sorted[a:b]
                    if len(span) or old[0] != new_triplet[0] or old[2] != new_triplet[2]:
                        # bounds moved or rows flipped: retract old rows, emit new
                        flipped = (
                            self.keys_sorted
                            if old[0] != new_triplet[0] or old[2] != new_triplet[2]
                            else span
                        )
                        self.triplet = old
                        out.append(
                            self._emit(flipped, np.full(len(flipped), -1, dtype=np.int64), time)
                        )
                        self.triplet = new_triplet
                        out.append(
                            self._emit(flipped, np.ones(len(flipped), dtype=np.int64), time)
                        )
                else:
                    self.triplet = new_triplet
                    if len(self.keys_sorted):
                        # rows that arrived before the first triplet emit now
                        out.append(
                            self._emit(
                                self.keys_sorted,
                                np.ones(len(self.keys_sorted), dtype=np.int64),
                                time,
                            )
                        )
        if main_batch is not None and len(main_batch):
            ins = main_batch.keys[main_batch.diffs > 0]
            dels = main_batch.keys[main_batch.diffs < 0]
            if self.triplet is not None:
                if len(dels):
                    out.append(self._emit(dels, np.full(len(dels), -1, dtype=np.int64), time))
                if len(ins):
                    out.append(self._emit(ins, np.ones(len(ins), dtype=np.int64), time))
            if len(dels):
                self.keys_sorted = self.keys_sorted[
                    ~np.isin(self.keys_sorted, dels.astype(np.uint64))
                ]
            if len(ins):
                merged = np.concatenate([self.keys_sorted, ins.astype(np.uint64)])
                merged.sort()
                self.keys_sorted = merged
        return out


def gradual_broadcast_impl(table, threshold_table, lower, value, upper):
    from pathway_tpu_torch.internals import schema as schema_mod
    from pathway_tpu_torch.internals.table import Table

    lower_ref = threshold_table._bind(lower)
    value_ref = threshold_table._bind(value)
    upper_ref = threshold_table._bind(upper)
    node = LogicalNode(
        lambda: GradualBroadcastNode(lower_ref.name, value_ref.name, upper_ref.name),
        [table._node, threshold_table._node],
        name="gradual_broadcast",
    )
    apx = Table(
        node,
        schema_mod.schema_from_dtypes({"apx_value": dt.FLOAT}),
        table._universe,
    )
    return table.with_columns(apx_value=apx.apx_value)
