"""Prometheus exposition helpers (reference ``pathway_tpu/internals/monitoring.py``).

Only ``escape_label_value`` is carried, for the REST serving plane's
``serving_prometheus_lines``. The monitoring server itself (``/status``,
``/metrics``, ``/request?id=``) is a later slice (ROADMAP Queue 1 item 4).
"""

from __future__ import annotations

from typing import Any


def escape_label_value(value: Any) -> str:
    r"""Prometheus exposition label-value escaping: ``\`` → ``\\``, ``"`` →
    ``\"``, newline → ``\n`` (the spec's exhaustive list). Operator names come
    from user pipelines (UDF/table names ride along), so they can contain any
    of the three."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )
