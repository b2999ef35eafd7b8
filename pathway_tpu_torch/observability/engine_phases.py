"""Per-tick engine phase accounting — where does an incremental tick go?

The device plane attributes *device* cost (compiles, pad waste, dispatch
wait). This module attributes the **host-side relational tick** the same way:
every hot-path primitive of the block engine (consolidate, key-store
sort/compact "rehash", sorted-probe, groupby state merge, block
realloc/concat, jitted kernel dispatch, worker exchange, capture-sink fold)
reports wall nanoseconds into a process-wide table, so the tax the incremental
bench chases (`engine_incremental_pct_of_static`) decomposes into named
phases instead of one opaque number.

Off by default (``PATHWAY_ENGINE_PHASES=off``): every instrumented site pays
exactly one module-global read. When on, timers nest — a probe that sorts a
lazy segment and dispatches a jitted kernel reports the sort under ``rehash``
and the dispatch under ``kernel``, and only the *exclusive* remainder under
``probe`` — so the published phases sum without double counting.

Read by ``benchmarks/engine_bench.py`` (per-phase tick breakdown) and
exposed for ad-hoc attribution via :func:`snapshot`.
"""

from __future__ import annotations

import threading
import time as _time

_ENABLED = False

_LOCK = threading.Lock()
_TOTALS: dict[str, list] = {}  # phase -> [exclusive_ns, calls]


class _Tls(threading.local):
    def __init__(self) -> None:
        self.stack: list[list] = []  # [t0_ns, child_ns] frames


_TLS = _Tls()


def enabled() -> bool:
    return _ENABLED


def enable(flag: bool = True) -> None:
    global _ENABLED
    _ENABLED = flag


def install_from_env() -> None:
    # the same boolean parse config.engine_phases uses — the /status config
    # dump and the plane must never disagree about whether it is on
    from pathway_tpu_torch.internals.config import get_pathway_config

    enable(get_pathway_config().engine_phases)


def reset() -> None:
    with _LOCK:
        _TOTALS.clear()


def start() -> list | None:
    """Open a phase frame; returns a token for :func:`stop` (None = disabled)."""
    if not _ENABLED:
        return None
    frame = [_time.perf_counter_ns(), 0]
    _TLS.stack.append(frame)
    return frame


def stop(token: list | None, phase: str) -> None:
    """Close a frame: attribute its EXCLUSIVE time (minus nested frames) to
    ``phase`` and charge the full duration to the enclosing frame's child
    counter."""
    if token is None:
        return
    now = _time.perf_counter_ns()
    stack = _TLS.stack
    # tolerate a frame orphaned by an exception between start/stop
    while stack and stack[-1] is not token:
        stack.pop()
    if stack:
        stack.pop()
    dur = now - token[0]
    if stack:
        stack[-1][1] += dur
    excl = max(0, dur - token[1])
    with _LOCK:
        acc = _TOTALS.get(phase)
        if acc is None:
            acc = _TOTALS[phase] = [0, 0]
        acc[0] += excl
        acc[1] += 1


def snapshot() -> dict[str, dict]:
    """``{phase: {"ms": exclusive wall ms, "calls": n}}`` since the last reset."""
    with _LOCK:
        return {
            k: {"ms": round(v[0] / 1e6, 3), "calls": v[1]}
            for k, v in sorted(_TOTALS.items())
        }
