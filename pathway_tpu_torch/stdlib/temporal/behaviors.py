"""Temporal behaviors: delay / cutoff / keep_results configuration.

API parity with the reference's ``stdlib/temporal/temporal_behavior.py:29,83``
(``common_behavior``, ``exactly_once_behavior``); the semantics ride the engine's
buffer/forget/freeze primitives (``pathway_tpu_torch/internals/time_ops.py``):

- ``delay`` buffers entries until the operator's tracked time (max seen) passes
  ``entry time + delay`` — batching against too-frequent updates.
- ``cutoff`` stops updating results older than ``max seen time - cutoff``: late
  entries are dropped (freeze) and state is released (forget).
- ``keep_results=False`` additionally forgets already-emitted results past cutoff.

Carried from ``pathway_tpu/stdlib/temporal/behaviors.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any


class Behavior:
    """Base class of temporal behavior configs."""


@dataclass
class CommonBehavior(Behavior):
    delay: Any | None
    cutoff: Any | None
    keep_results: bool


def common_behavior(delay=None, cutoff=None, keep_results: bool = True) -> CommonBehavior:
    if cutoff is None and not keep_results:
        raise ValueError("keep_results=False requires a cutoff")
    return CommonBehavior(delay, cutoff, keep_results)


@dataclass
class ExactlyOnceBehavior(Behavior):
    shift: Any | None


def exactly_once_behavior(shift=None) -> ExactlyOnceBehavior:
    """Each non-empty window produces exactly one output, at ``window end + shift``."""
    return ExactlyOnceBehavior(shift)


def apply_temporal_behavior(table, behavior: CommonBehavior | None, time_column="_pw_time"):
    """Apply delay/cutoff to a table carrying its event time in ``time_column``
    (reference ``temporal_behavior.py:103-116``)."""
    import pathway_tpu_torch as pw

    if behavior is None:
        return table
    t = table[time_column] if isinstance(time_column, str) else time_column
    if behavior.delay is not None:
        table = table._buffer(t + behavior.delay, t)
        t = table[time_column] if isinstance(time_column, str) else time_column
    if behavior.cutoff is not None:
        threshold = t + behavior.cutoff
        table = table._freeze(threshold, t)
        t = table[time_column] if isinstance(time_column, str) else time_column
        if not behavior.keep_results:
            table = table._forget(t + behavior.cutoff, t, behavior.keep_results)
    return table
