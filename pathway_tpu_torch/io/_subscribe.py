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

    ``service_class`` scopes the flow plane's latency objective
    (``PATHWAY_LATENCY_SLO_MS``): the AIMD microbatch controller reads the
    end-to-end latency histograms of ``interactive`` sinks only, so a
    ``bulk``-class subscriber (backfill mirror, audit log) never drags the
    bucket size down on behalf of traffic that doesn't care."""
    from pathway_tpu_torch.flow import validate_service_class

    node = table._subscribe_node(
        on_change=on_change,
        on_time_end=on_time_end,
        on_end=on_end,
        service_class=validate_service_class(service_class),
        route_by=route_by,
    )
    node._register_as_output()
