"""Temporal operations (reference: ``python/pathway/stdlib/temporal/``).

Windows (tumbling/sliding/session/intervals_over), temporal behaviors
(delay/cutoff/exactly-once), interval joins, asof joins, as-of-now joins, and
window joins — see the submodules for engine notes.

Carried from ``pathway_tpu/stdlib/temporal/__init__.py``.
"""

from pathway_tpu_torch.stdlib.temporal.behaviors import (
    Behavior,
    CommonBehavior,
    ExactlyOnceBehavior,
    apply_temporal_behavior,
    common_behavior,
    exactly_once_behavior,
)
from pathway_tpu_torch.stdlib.temporal._window import (
    Window,
    intervals_over,
    session,
    sliding,
    tumbling,
    windowby_impl,
)
from pathway_tpu_torch.stdlib.temporal._temporal_join import (
    Direction,
    asof_join,
    asof_join_left,
    asof_join_outer,
    asof_join_right,
    asof_now_join,
    asof_now_join_inner,
    asof_now_join_left,
    interval,
    interval_join,
    interval_join_inner,
    interval_join_left,
    interval_join_outer,
    interval_join_right,
)
from pathway_tpu_torch.stdlib.temporal._window_join import (
    window_join,
    window_join_inner,
    window_join_left,
    window_join_outer,
    window_join_right,
)

__all__ = [
    "Behavior",
    "CommonBehavior",
    "Direction",
    "ExactlyOnceBehavior",
    "Window",
    "apply_temporal_behavior",
    "asof_join",
    "asof_join_left",
    "asof_join_outer",
    "asof_join_right",
    "asof_now_join",
    "asof_now_join_inner",
    "asof_now_join_left",
    "common_behavior",
    "exactly_once_behavior",
    "interval",
    "interval_join",
    "interval_join_inner",
    "interval_join_left",
    "interval_join_outer",
    "interval_join_right",
    "intervals_over",
    "session",
    "sliding",
    "tumbling",
    "window_join",
    "window_join_inner",
    "window_join_left",
    "window_join_outer",
    "window_join_right",
    "windowby_impl",
]
