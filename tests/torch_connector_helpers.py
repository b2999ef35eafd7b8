"""Helpers of the connector parity tests (``tests/test_torch_connectors_*.py``).

Each scenario is written once as ``fn(pw, ...)`` and run through both
packages in this process: the JAX package (``pathway_tpu``) and the port
(``pathway_tpu_torch``). Row keys are salted with ``hash()`` of a path or a
table name in places, which is stable within one process, so keys compare
exactly here. Live runs stop from a thread with ``request_stop()``; their
rows land in wall-clock ticks, so a live scenario compares final state by
key, not ticks.
"""

from __future__ import annotations

import threading
import time

import numpy as np

import pathway_tpu
import pathway_tpu_torch
from pathway_tpu.debug import _capture as _capture_ref
from pathway_tpu_torch.debug import _capture as _capture_port

PACKAGES = (pathway_tpu, pathway_tpu_torch)


def norm(v):
    """A value as both packages' values compare: Json by content, numpy
    scalars as Python scalars, the error value by name."""
    if type(v).__name__ == "Json" and hasattr(v, "value"):
        return ("Json", norm(v.value))
    if type(v).__name__ == "_Error":
        return "ERROR"
    if isinstance(v, (np.datetime64, np.timedelta64)):
        return ("dt", str(v))
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, dict):
        return {k: norm(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(norm(x) for x in v)
    return v


def key_of(key) -> int:
    return int(key)


def capture(pw, table) -> list:
    """The update stream ``(time, key, diff, values)`` of ``table``."""
    cap = (_capture_port if pw is pathway_tpu_torch else _capture_ref)(table)
    return [(t, int(k), d, tuple(norm(v) for v in row)) for (t, k, d, row) in cap.deltas]


def both(fn, *args, **kwargs) -> tuple:
    """``fn(pw, *args, **kwargs)`` for the reference, then the port; each
    with a clear parse graph before and after."""
    out = []
    for pw in PACKAGES:
        pw.G.clear()
        try:
            out.append(fn(pw, *args, **kwargs))
        finally:
            pw.G.clear()
    return tuple(out)


def same(fn, *args, **kwargs):
    """``both`` and assert the two results are equal; returns the port's."""
    ref, port = both(fn, *args, **kwargs)
    assert port == ref
    return port


def collect(pw, table, column: str = "data") -> dict:
    """Live state of ``table`` by key: ``column``'s value (or the row), kept
    current by a subscriber."""
    state: dict = {}

    def on_change(key, row, time, is_addition):
        value = norm(row[column]) if column else norm(dict(row))
        if is_addition:
            state[key_of(key)] = value
        else:
            state.pop(key_of(key), None)

    pw.io.subscribe(table, on_change=on_change)
    return state


def stop_when(pw, cond, deadline: float = 30.0, settle: float = 0.0) -> threading.Thread:
    """A thread that stops the current run once ``cond()`` holds (or at the
    deadline), ``settle`` seconds after it first holds."""

    def run():
        t0 = time.time()
        while time.time() - t0 < deadline and not cond():
            time.sleep(0.02)
        time.sleep(settle)
        rt = pw.internals.run.current_runtime()
        if rt is not None:
            rt.request_stop()

    th = threading.Thread(target=run, daemon=True)
    th.start()
    return th


def run_live(pw, cond, deadline: float = 30.0, settle: float = 0.0) -> None:
    """``pw.run`` until ``cond()`` holds, then ``settle`` seconds more."""
    th = stop_when(pw, cond, deadline, settle)
    pw.run(monitoring_level="none")
    th.join(timeout=deadline + settle + 5)
