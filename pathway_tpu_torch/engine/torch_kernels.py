"""The relational hot path's two device functions, as torch ops.

Port of ``pathway_tpu/engine/jax_kernels.py``: the grouped segment-sum that
powers ``GroupByNode`` (reference ``_jit_grouped``) and the sorted probe that
powers ``ColumnarMultimap``/``JoinNode`` (reference ``_jit_probe``), behind
the same ``PATHWAY_ENGINE_JAX`` flag and thresholds. Integer results (order,
starts, keys, counts, int sums, probe positions) are bit-identical to the
numpy path (same stable ordering, same dtypes); float sums match to
accumulation order only (``index_add_`` does not reduce strictly left to
right the way ``np.add.reduceat`` does).

Keys are uint64; torch has no full uint64 sort or ``searchsorted``, so keys
cross into torch as int64 with the sign bit flipped (``k ^ 2**63``), which
maps uint64 order onto int64 order exactly. Sorts are ``stable=True`` so equal
keys keep arrival order, as numpy's stable argsort does.

Flag values:
  - unset / ``auto`` — the reference's adopted design: the probe runs on the
    host backend (torch on CPU tensors, the counterpart of the reference's XLA
    CPU backend) for large blocks; groupby stays numpy. The relational plane is
    host-columnar by the reference's measured choice.
  - ``0`` / ``false`` — numpy everywhere.
  - ``1`` — both functions on the default device, the card (raises without
    CUDA, as every entry point of the port does).
  - ``cpu`` / ``gpu`` — both functions pinned to that device.

No failure is caught here: a function routed to the card that fails raises,
so a run can never finish on the CPU after quietly missing the card.
"""

from __future__ import annotations

import os
import threading
import weakref
from typing import Any

import numpy as np

_MIN_ROWS = 32_768  # below this, dispatch overhead dominates any kernel win

_FLAGS = ("auto", "0", "false", "1", "cpu", "gpu")

#: route -> calls, e.g. ``"grouped/cuda"``, ``"probe/cpu"``: where each
#: function ran (chip_smoke prints it; counts only, no timing)
ROUTES: dict[str, int] = {}

_SIGN = np.uint64(1 << 63)


def flag() -> str:
    f = os.environ.get("PATHWAY_ENGINE_JAX", "auto").strip().lower() or "auto"
    if f not in _FLAGS:
        raise ValueError(f"PATHWAY_ENGINE_JAX must be one of {_FLAGS}, got {f!r}")
    return f


def enabled() -> bool:
    """Both functions explicitly on (groupby included)."""
    return flag() not in ("auto", "0", "false")


def _device(force_cpu: bool = False):
    import torch

    from pathway_tpu_torch._device import resolve_device

    if force_cpu or flag() == "cpu":
        return torch.device("cpu")
    return resolve_device(None)  # "1" and "gpu": the card, or raise


def _note(route: str, dev) -> None:
    name = f"{route}/{dev.type}"
    ROUTES[name] = ROUTES.get(name, 0) + 1


def _keys_tensor(keys: np.ndarray, dev):
    """uint64 keys as order-preserving int64 (sign bit flipped) on ``dev``."""
    import torch

    flipped = (np.ascontiguousarray(keys, dtype=np.uint64) ^ _SIGN).view(np.int64)
    return torch.from_numpy(flipped).to(dev)


def _host(t) -> np.ndarray:
    return t.cpu().numpy()


# ------------------------------------------------------------------ groupby


def numpy_grouped_sums(
    gkeys: np.ndarray, diffs: np.ndarray, sum_cols: list[np.ndarray]
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, list[np.ndarray]]:
    """The numpy reference for :func:`grouped_sums` — the argsort+reduceat
    recipe ``GroupByNode._process_columnar`` runs."""
    from pathway_tpu_torch.engine.blocks import group_starts

    order = np.argsort(gkeys, kind="stable")
    ks = gkeys[order]
    starts = group_starts(ks)
    counts = np.add.reduceat(diffs[order], starts) if len(ks) else np.empty(0, np.int64)
    sums = [np.add.reduceat(c[order] * diffs[order], starts) for c in sum_cols]
    return order, starts, ks[starts], counts, sums


def _grouped(keys, diffs, cols):
    """Reference ``_jit_grouped``: stable argsort of the keys, segment starts,
    segment sums of the diffs and of ``col·diff``."""
    import torch

    order = torch.argsort(keys, stable=True)
    ks = keys[order]
    newg = torch.ones_like(ks, dtype=torch.bool)
    newg[1:] = ks[1:] != ks[:-1]
    seg = torch.cumsum(newg, 0) - 1
    g = int(seg[-1].item()) + 1 if len(seg) else 0
    d = diffs[order]
    counts = torch.zeros(g, dtype=d.dtype, device=d.device).index_add_(0, seg, d)
    sums = [
        torch.zeros(g, dtype=c.dtype, device=c.device).index_add_(0, seg, c[order] * d)
        for c in cols
    ]
    return order, ks, newg, counts, sums


def grouped_sums(
    gkeys: np.ndarray, diffs: np.ndarray, sum_cols: list[np.ndarray]
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, list[np.ndarray]]:
    """Segment-sum groupby over one delta block, on the flag's device.

    Returns ``(order, starts, u_gk, counts, partials)`` with the exact values
    (and stable first-occurrence ordering) of the numpy path:
    ``order = argsort(gkeys, stable)``, ``starts`` = sorted group boundaries,
    ``counts[i] = sum(diffs of group i)``, ``partials[c][i] = sum(col_c * diff)``.
    ``sum_cols`` are already promoted to ``result_type(col, int64)``.
    """
    import torch

    dev = _device()
    keys = _keys_tensor(gkeys, dev)
    d = torch.from_numpy(np.ascontiguousarray(diffs, dtype=np.int64)).to(dev)
    cols = [torch.from_numpy(np.ascontiguousarray(c)).to(dev) for c in sum_cols]
    order, ks, newg, counts, sums = _grouped(keys, d, cols)
    _note("grouped", dev)
    order = _host(order)
    starts = np.flatnonzero(_host(newg))
    u_gk = (_host(ks)[starts].view(np.uint64)) ^ _SIGN
    return order, starts, u_gk, _host(counts), [_host(s) for s in sums]


def try_grouped(
    gkeys: np.ndarray, diffs: np.ndarray, reducer_specs, data: dict[str, np.ndarray]
):
    """Route a GroupByNode columnar block to :func:`grouped_sums` when eligible.

    Eligible = flag on, block large enough, and every reducer is a
    count/weighted-sum over a numeric column (the semigroup reducers whose
    partials are exactly a segment-sum). Returns
    ``(order, starts, u_gk, counts, partials)`` or None for the numpy path.
    """
    if not enabled() or len(gkeys) < _MIN_ROWS:
        return None
    from pathway_tpu_torch.engine.reducers_impl import CountReducer, SumReducer

    cols: list[np.ndarray] = []
    kinds: list[tuple[str, str | None]] = []
    for (_, impl, colnames) in reducer_specs:
        if isinstance(impl, CountReducer):
            kinds.append(("count", None))
        elif isinstance(impl, SumReducer):
            col = data[colnames[0]]
            if col.dtype.kind not in "iufb":
                return None
            # match numpy promotion of col * int64-diffs exactly
            cols.append(col.astype(np.result_type(col.dtype, np.int64), copy=False))
            kinds.append(("sum", impl.kind))
        else:
            return None
    order, starts, u_gk, counts, sums = grouped_sums(gkeys, diffs, cols)
    partials: list[np.ndarray] = []
    si = 0
    for kind, sumkind in kinds:
        if kind == "count":
            partials.append(counts)
        else:
            p = sums[si]
            si += 1
            if sumkind == "float" and p.dtype.kind != "f":
                p = p.astype(np.float64)
            partials.append(p)
    return order, starts, u_gk, counts, partials


# ------------------------------------------------------------------ join probe


# Persistent device-resident arrangements (PATHWAY_ARRANGE_CACHE): a sorted
# state segment is immutable between compactions, so its device copy is
# uploaded once per compaction generation and every later tick probes the
# SAME device tensor. Keyed by id() of the host array with a liveness weakref
# (ids recycle after GC); one entry per (array, device). Locked: several
# threads may probe at once.
_DEV_CACHE: dict[tuple[int, str], tuple[Any, Any]] = {}
_DEV_LOCK = threading.Lock()


def _device_state(arr: np.ndarray, dev):
    from pathway_tpu_torch.internals.config import get_pathway_config

    if not get_pathway_config().arrange_device_cache:
        return _keys_tensor(arr, dev)
    key = (id(arr), str(dev))
    with _DEV_LOCK:
        ent = _DEV_CACHE.get(key)
        if ent is not None and ent[0]() is arr:
            return ent[1]
    put = _keys_tensor(arr, dev)
    with _DEV_LOCK:
        dead = [k for k, (r, _) in _DEV_CACHE.items() if r() is None]
        for k in dead:
            del _DEV_CACHE[k]
        _DEV_CACHE[key] = (weakref.ref(arr), put)
    return put


def _probe(sorted_keys, q):
    """Reference ``_jit_probe``: left and right ``searchsorted``, giving
    ``(lo, count)``."""
    import torch

    lo = torch.searchsorted(sorted_keys, q)
    hi = torch.searchsorted(sorted_keys, q, right=True)
    return lo, hi - lo


def join_probe(sorted_jk: np.ndarray, q_jk: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Sorted-array probe (the hash-join inner kernel): for each probe key,
    the ``(lo, count)`` range of matches in the sorted state array —
    identical to the numpy two-sided searchsorted. Torch compiles nothing per
    shape, so neither side is padded to a bucket as the reference's XLA
    kernel is."""
    # auto mode adopts the probe on the host backend (the reference's measured
    # win); explicit devices are honored as given
    dev = _device(force_cpu=flag() == "auto")
    lo, cnt = _probe(_device_state(sorted_jk, dev), _keys_tensor(q_jk, dev))
    _note("probe", dev)
    return _host(lo), _host(cnt)


#: auto-adoption thresholds (the reference's): in-engine, per-call dispatch
#: only amortizes on big blocks, so auto only routes big probes
_PROBE_STATE, _PROBE_QUERY = 131072, 32768


def probe_eligible(n_state: int, n_query: int) -> bool:
    f = flag()
    if f in ("0", "false"):
        return False
    if f == "auto":
        return n_state >= _PROBE_STATE and n_query >= _PROBE_QUERY
    return n_state >= _MIN_ROWS and n_query >= 1024
