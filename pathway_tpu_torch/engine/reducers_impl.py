"""Reducer accumulators for incremental group-by.

Engine counterpart of the reference's ``src/engine/reduce.rs:22-38`` reducer set
(Count, IntSum/FloatSum/ArraySum, Unique, Min/ArgMin, Max/ArgMax, SortedTuple, Tuple,
Any, Stateful, Earliest, Latest), keeping its two styles: **semigroup** reducers
(commutative, retraction = subtraction — ``reduce.rs:40``) update from vectorized
per-batch partial aggregates; **multiset** reducers (``reduce.rs:50``) maintain a
value multiset and re-extract on change.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np

from pathway_tpu_torch.internals.errors import ERROR
from pathway_tpu_torch.internals.keys import _canonical_bytes


class ReducerImpl:
    """Per-group accumulator protocol."""

    #: semigroup reducers support vectorized batch partials
    semigroup = False

    def make(self) -> Any:
        raise NotImplementedError

    def update(self, state: Any, values: tuple, diff: int, time: int, seq: int) -> None:
        raise NotImplementedError

    def extract(self, state: Any) -> Any:
        raise NotImplementedError

    # semigroup only: partial over a slice of column arrays, then merge
    def batch_partial(self, cols: list[np.ndarray], diffs: np.ndarray, sl: slice) -> Any:
        raise NotImplementedError

    def merge_partial(self, state: Any, partial: Any) -> Any:
        raise NotImplementedError

    def grouped_partials(
        self,
        cols: list[np.ndarray],
        diffs: np.ndarray,
        order: np.ndarray,
        starts: np.ndarray,
    ) -> Any | None:
        """All-groups partials in one vectorized pass (``order`` sorts rows by
        group, ``starts`` marks group boundaries). Returns an indexable of one
        partial per group, or None to fall back to per-group ``batch_partial``."""
        return None

    #: accumulator representable as a flat numeric array, merged by addition —
    #: lets GroupByNode keep its whole state columnar (no per-group Python)
    columnar = False

    def grouped_partials_np(
        self,
        cols: list[np.ndarray],
        diffs: np.ndarray,
        order: np.ndarray,
        starts: np.ndarray,
    ) -> np.ndarray | None:
        """Columnar variant of ``grouped_partials``: one numeric array with a
        partial per group, or None when this batch's columns can't vectorize
        (object dtype)."""
        return None


class CountReducer(ReducerImpl):
    semigroup = True
    columnar = True

    def make(self):
        return 0

    def update(self, state, values, diff, time, seq):
        return state + diff

    def extract(self, state):
        return state

    def batch_partial(self, cols, diffs, sl):
        return int(diffs[sl].sum())

    def merge_partial(self, state, partial):
        return state + partial

    def grouped_partials(self, cols, diffs, order, starts):
        return np.add.reduceat(diffs[order], starts).tolist()

    def grouped_partials_np(self, cols, diffs, order, starts):
        return np.add.reduceat(diffs[order], starts)


class SumReducer(ReducerImpl):
    semigroup = True
    columnar = True

    def __init__(self, kind: str = "int"):
        self.kind = kind

    def make(self):
        return 0 if self.kind == "int" else 0.0

    def update(self, state, values, diff, time, seq):
        v = values[0]
        if v is ERROR or v is None:
            return state
        return state + diff * v

    def extract(self, state):
        return state

    def batch_partial(self, cols, diffs, sl):
        col = cols[0][sl]
        d = diffs[sl]
        if col.dtype == object:
            total = 0
            for v, dd in zip(col, d):
                if v is not ERROR and v is not None:
                    total += dd * v
            return total
        return (col * d).sum()

    def merge_partial(self, state, partial):
        return state + partial

    def grouped_partials(self, cols, diffs, order, starts):
        col = cols[0]
        if col.dtype == object:
            return None
        weighted = col[order] * diffs[order]
        return np.add.reduceat(weighted, starts).tolist()

    def grouped_partials_np(self, cols, diffs, order, starts):
        col = cols[0]
        if col.dtype == object or col.dtype.kind not in "iufb":
            return None
        weighted = col[order] * diffs[order]
        out = np.add.reduceat(weighted, starts)
        if self.kind == "float" and out.dtype.kind != "f":
            out = out.astype(np.float64)
        return out


class ArraySumReducer(ReducerImpl):
    def make(self):
        return None

    def update(self, state, values, diff, time, seq):
        v = values[0]
        contrib = np.asarray(v) * diff
        return contrib if state is None else state + contrib

    def extract(self, state):
        return state


class _MultisetState:
    __slots__ = ("items", "total")

    def __init__(self):
        # canonical-bytes -> [value, count, first_seq, extra]
        self.items: dict[bytes, list] = {}
        self.total = 0


class MultisetReducer(ReducerImpl):
    """Base for reducers re-extracted from a value multiset."""

    def make(self):
        return _MultisetState()

    def _key_values(self, values: tuple):
        return values

    def update(self, state: _MultisetState, values, diff, time, seq):
        v = self._key_values(values)
        ck = _canonical_bytes(v)
        ent = state.items.get(ck)
        if ent is None:
            ent = [v, 0, (time, seq)]
            state.items[ck] = ent
        ent[1] += diff
        if ent[1] == 0:
            del state.items[ck]
        state.total += diff
        return state


class MinReducer(MultisetReducer):
    def extract(self, state):
        return min(e[0][0] for e in state.items.values())


class MaxReducer(MultisetReducer):
    def extract(self, state):
        return max(e[0][0] for e in state.items.values())


class ArgMinReducer(MultisetReducer):
    """values = (cmp_value, id); ties broken by smallest key for determinism."""

    def extract(self, state):
        return min((e[0][0], e[0][1]) for e in state.items.values())[1]


class ArgMaxReducer(MultisetReducer):
    def extract(self, state):
        best = None
        for e in state.items.values():
            cand = (e[0][0], e[0][1])
            # max by value, min by id on ties
            if best is None or cand[0] > best[0] or (cand[0] == best[0] and cand[1] < best[1]):
                best = cand
        return best[1]


class UniqueReducer(MultisetReducer):
    def extract(self, state):
        if len(state.items) != 1:
            from pathway_tpu_torch.internals.errors import report_error

            return report_error(
                "unique reducer: group holds more than one distinct value"
            )
        return next(iter(state.items.values()))[0][0]


class AnyReducer(MultisetReducer):
    def extract(self, state):
        # deterministic: smallest canonical encoding
        ck = min(state.items.keys())
        return state.items[ck][0][0]


class TupleReducer(MultisetReducer):
    """Collect values; ordered by arrival (time, seq) for stability. With
    ``sort_by`` values are (value, sort_key) pairs ordered by sort_key."""

    def __init__(self, skip_nones: bool = False, with_sort_key: bool = False):
        self.skip_nones = skip_nones
        self.with_sort_key = with_sort_key

    def extract(self, state):
        if self.with_sort_key:
            entries = sorted(state.items.values(), key=lambda e: (e[0][1], e[2]))
        else:
            entries = sorted(state.items.values(), key=lambda e: e[2])
        out = []
        for e in entries:
            v = e[0][0]
            if self.skip_nones and v is None:
                continue
            out.extend([v] * max(e[1], 0))
        return tuple(out)


class SortedTupleReducer(MultisetReducer):
    def __init__(self, skip_nones: bool = False):
        self.skip_nones = skip_nones

    def extract(self, state):
        vals = []
        for e in state.items.values():
            v = e[0][0]
            if self.skip_nones and v is None:
                continue
            vals.extend([v] * max(e[1], 0))
        return tuple(sorted(vals))


class NdarrayReducer(MultisetReducer):
    """values = (value, sort_key); returns np.ndarray sorted by sort_key."""

    def extract(self, state):
        entries = sorted(state.items.values(), key=lambda e: (e[0][1], e[2]))
        vals = []
        for e in entries:
            vals.extend([e[0][0]] * max(e[1], 0))
        return np.asarray(vals)


class EarliestReducer(MultisetReducer):
    def extract(self, state):
        return min(state.items.values(), key=lambda e: e[2])[0][0]


class LatestReducer(MultisetReducer):
    def extract(self, state):
        return max(state.items.values(), key=lambda e: e[2])[0][0]


class StatefulReducer(ReducerImpl):
    """``stateful_single/many`` — append-only fold with a user combine fn
    (reference: ``Reducer::Stateful`` + ``custom_reducers.py``)."""

    def __init__(self, combine_fn: Callable, many: bool = False):
        self.combine_fn = combine_fn
        self.many = many

    def make(self):
        return None

    def update(self, state, values, diff, time, seq):
        if diff < 0:
            raise RuntimeError("stateful reducers don't support retractions")
        if self.many:
            return self.combine_fn(state, [(*values, diff)])
        return self.combine_fn(state, *values)

    def extract(self, state):
        return state


class CustomAccumulatorReducer(ReducerImpl):
    """``pw.reducers.udf_reducer`` over a BaseCustomAccumulator subclass
    (reference: ``internals/custom_reducers.py``)."""

    def __init__(self, acc_cls):
        self.acc_cls = acc_cls

    def make(self):
        return None

    def update(self, state, values, diff, time, seq):
        neutral = self.acc_cls.from_row(list(values))
        if diff > 0:
            return neutral if state is None else state.update(neutral) or state
        if state is None:
            raise RuntimeError("retraction before any accumulation")
        if not hasattr(state, "retract"):
            raise RuntimeError(f"{self.acc_cls.__name__} does not support retractions")
        state.retract(neutral)
        return state

    def extract(self, state):
        return state.compute_result()
