"""Sorted prev/next neighbor maintenance (``Table.sort``).

Counterpart of the reference's ``prev_next.rs`` timely operator (built on its patched
bidirectional differential cursors, SURVEY §2.9): for every row, emit pointers to the
previous/next row in ``key`` order within its ``instance`` partition. Output universe
equals the input universe; columns are ``prev``/``next`` Optional[Pointer].

Incrementality: each instance's order lives in a blocked sorted list
(``_BlockedSortedList`` — list-of-blocks, the sortedcontainers design), so a
1-row change costs O(log n) search + an O(sqrt n) block memmove instead of the
flat list's O(n) memmove; neighbor queries are block-local with edge
spillover, the role of the reference's O(1) bidirectional cursors. Only the
mutated rows' neighborhoods re-derive. Instances are independent, so the node
shards by instance hash across workers (SOLO only for the global
single-instance sort).

Carried from ``pathway_tpu/internals/sorting.py``.
"""

from __future__ import annotations

import bisect
from typing import Any, Callable

import numpy as np

from pathway_tpu_torch.engine.blocks import DeltaBatch
from pathway_tpu_torch.engine.graph import Node
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.logical import LogicalNode


class _BlockedSortedList:
    """Sorted multiset of comparable items in ~sqrt(n) blocks.

    insert/remove: O(log n) block search + O(block) memmove. neighbors:
    block-local lookups spilling into adjacent blocks at the edges."""

    LOAD = 512

    __slots__ = ("_blocks", "_maxes", "_len")

    def __init__(self) -> None:
        self._blocks: list[list] = []
        self._maxes: list = []
        self._len = 0

    def __len__(self) -> int:
        return self._len

    def _block_of(self, item) -> int:
        b = bisect.bisect_left(self._maxes, item)
        return min(b, len(self._blocks) - 1)

    def insert(self, item) -> None:
        if not self._blocks:
            self._blocks.append([item])
            self._maxes.append(item)
            self._len = 1
            return
        b = self._block_of(item)
        block = self._blocks[b]
        bisect.insort(block, item)
        self._maxes[b] = block[-1]
        self._len += 1
        if len(block) > 2 * self.LOAD:
            half = len(block) // 2
            right = block[half:]
            del block[half:]
            self._blocks.insert(b + 1, right)
            self._maxes[b] = block[-1]
            self._maxes.insert(b + 1, right[-1])

    def remove(self, item) -> bool:
        if not self._blocks:
            return False
        b = self._block_of(item)
        block = self._blocks[b]
        pos = bisect.bisect_left(block, item)
        if pos >= len(block) or block[pos] != item:
            return False
        block.pop(pos)
        self._len -= 1
        if not block:
            del self._blocks[b]
            del self._maxes[b]
        elif len(block) < self.LOAD // 2 and len(self._blocks) > 1:
            # merge undersized blocks (sortedcontainers discipline) so churn
            # cannot degrade toward one-element blocks / O(n) block lists
            nb = b + 1 if b + 1 < len(self._blocks) else b - 1
            lo, hi = min(b, nb), max(b, nb)
            merged = self._blocks[lo] + self._blocks[hi]
            self._blocks[lo] = merged
            self._maxes[lo] = merged[-1]
            del self._blocks[hi]
            del self._maxes[hi]
            if len(merged) > 2 * self.LOAD:
                half = len(merged) // 2
                right = merged[half:]
                del merged[half:]
                self._blocks.insert(lo + 1, right)
                self._maxes[lo] = merged[-1]
                self._maxes.insert(lo + 1, right[-1])
        else:
            self._maxes[b] = block[-1]
        return True

    def neighbors(self, item) -> tuple[Any, Any]:
        """(previous item, next item) around ``item`` (which must be present),
        None at the ends."""
        b = self._block_of(item)
        block = self._blocks[b]
        pos = bisect.bisect_left(block, item)
        prev_item = None
        next_item = None
        if pos > 0:
            prev_item = block[pos - 1]
        elif b > 0:
            prev_item = self._blocks[b - 1][-1]
        if pos + 1 < len(block):
            next_item = block[pos + 1]
        elif b + 1 < len(self._blocks):
            next_item = self._blocks[b + 1][0]
        return prev_item, next_item

    def __contains__(self, item) -> bool:
        if not self._blocks:
            return False
        b = self._block_of(item)
        block = self._blocks[b]
        pos = bisect.bisect_left(block, item)
        return pos < len(block) and block[pos] == item


class SortNode(Node):
    name = "sort"

    snapshot_attrs = ("_row_info", "_orders", "_emitted")

    def exchange_key(self, port):
        if self.instance_fn is None:
            from pathway_tpu_torch.engine.graph import SOLO

            return SOLO  # one global order: serial
        # Per-instance orders are independent: shard by instance hash. Engine
        # contract note: updates arrive as retract+insert pairs, and each leg
        # carries its own row values — the retraction hashes the OLD instance
        # and reaches the shard holding the old entry. A bare re-insert that
        # CHANGES the instance (out of contract) would leave stale state on
        # the old shard; the in-node upsert defense below still covers bare
        # re-inserts that keep their instance (same shard).
        from pathway_tpu_torch.internals.keys import hash_column

        fn = self.instance_fn

        def key_fn(batch):
            vals = np.asarray(fn(batch))
            if vals.dtype.kind not in "OUS":
                return hash_column(vals)
            out = np.empty(len(vals), dtype=object)
            out[:] = list(vals)
            return hash_column(out)

        return key_fn

    def __init__(
        self,
        key_fn: Callable[[DeltaBatch], np.ndarray],
        instance_fn: Callable[[DeltaBatch], np.ndarray] | None,
    ):
        super().__init__(n_inputs=1)
        self.key_fn = key_fn
        self.instance_fn = instance_fn
        # row key -> (instance, sort_key); instance -> blocked sorted list of
        # (sort_key, row_key)
        self._row_info: dict[int, tuple[Any, Any]] = {}
        self._orders: dict[Any, _BlockedSortedList] = {}
        # row key -> (prev, next) currently emitted
        self._emitted: dict[int, tuple[int | None, int | None]] = {}

    def process(self, inputs, time):
        batch = inputs[0]
        if batch is None:
            return []
        sort_keys = self.key_fn(batch)
        instances = (
            self.instance_fn(batch)
            if self.instance_fn is not None
            else np.zeros(len(batch), dtype=np.int64)
        )
        # only the NEIGHBORHOODS of mutated rows can change their (prev, next)
        # pair — collect affected keys instead of rescanning whole instances
        affected: dict = {}

        def note_neighbors(inst, item) -> None:
            order = self._orders.get(inst)
            if order is None or item not in order:
                return
            prev_item, next_item = order.neighbors(item)
            aff = affected.setdefault(inst, set())
            if prev_item is not None:
                aff.add(prev_item[1])
            if next_item is not None:
                aff.add(next_item[1])

        for i in range(len(batch)):
            key = int(batch.keys[i])
            if batch.diffs[i] > 0:
                old_info = self._row_info.get(key)
                if old_info is not None:
                    # upsert: a re-inserted key must not duplicate its entry
                    note_neighbors(old_info[0], (old_info[1], key))
                    oorder = self._orders.get(old_info[0])
                    if oorder is not None:
                        oorder.remove((old_info[1], key))
                info = (instances[i], sort_keys[i])
                self._row_info[key] = info
                order = self._orders.get(info[0])
                if order is None:
                    order = self._orders[info[0]] = _BlockedSortedList()
                order.insert((info[1], key))
                aff = affected.setdefault(info[0], set())
                aff.add(key)
                note_neighbors(info[0], (info[1], key))
            else:
                info = self._row_info.pop(key, None)
                if info is None:
                    continue
                note_neighbors(info[0], (info[1], key))
                order = self._orders.get(info[0])
                if order is not None:
                    order.remove((info[1], key))

        out_keys: list[int] = []
        out_diffs: list[int] = []
        out_rows: list[tuple] = []

        def emit(key: int, pair: tuple, diff: int) -> None:
            out_keys.append(key)
            out_diffs.append(diff)
            out_rows.append(pair)

        for inst, keys in affected.items():
            order = self._orders.get(inst)
            for key in sorted(keys):
                info = self._row_info.get(key)
                if info is None:
                    continue  # deleted this batch; retraction emitted below
                prev_item, next_item = order.neighbors((info[1], key))
                prev_key = prev_item[1] if prev_item is not None else None
                next_key = next_item[1] if next_item is not None else None
                pair = (prev_key, next_key)
                old = self._emitted.get(key)
                if old == pair:
                    continue
                if old is not None:
                    emit(key, old, -1)
                emit(key, pair, +1)
                self._emitted[key] = pair
        # rows deleted from the order need their last emission retracted
        for i in range(len(batch)):
            key = int(batch.keys[i])
            if batch.diffs[i] < 0 and key not in self._row_info:
                old = self._emitted.pop(key, None)
                if old is not None:
                    emit(key, old, -1)
        if not out_keys:
            return []
        return [
            DeltaBatch.from_rows(out_keys, out_rows, ["prev", "next"], time, diffs=out_diffs)
        ]


def sort_impl(table, key_expr, instance_expr=None):
    from pathway_tpu_torch.internals import schema as schema_mod
    from pathway_tpu_torch.internals.table import Table, _compile_single

    key_fn = _compile_single(key_expr, table)
    inst_fn = _compile_single(instance_expr, table) if instance_expr is not None else None
    node = LogicalNode(lambda: SortNode(key_fn, inst_fn), [table._node], name="sort")
    schema = schema_mod.schema_from_dtypes(
        {"prev": dt.Optional(dt.Pointer()), "next": dt.Optional(dt.Pointer())}
    )
    # same universe: every input row gets exactly one (prev, next) row
    return Table(node, schema, table._universe)
