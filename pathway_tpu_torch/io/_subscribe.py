"""``pw.io.subscribe`` (reference: ``python/pathway/io/_subscribe.py``)."""

from __future__ import annotations

from typing import Any, Callable


def subscribe(
    table: Any,
    on_change: Callable,
    on_end: Callable | None = None,
    on_time_end: Callable | None = None,
    *,
    name: str | None = None,
    service_class: str = "interactive",
    route_by: Callable | None = None,
) -> None:
    """Calls ``on_change(key, row, time, is_addition)`` for every change,
    ``on_time_end(time)`` at the end of each logical time, ``on_end()`` on close.

    ``service_class`` scopes the flow plane, which is not ported yet: only
    ``"interactive"`` is accepted (``internals/later_slice.py``)."""
    from pathway_tpu_torch.internals.later_slice import interactive_only

    interactive_only(service_class)
    node = table._subscribe_node(
        on_change=on_change,
        on_time_end=on_time_end,
        on_end=on_end,
        route_by=route_by,
    )
    node._register_as_output()
