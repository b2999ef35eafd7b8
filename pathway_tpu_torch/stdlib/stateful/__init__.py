"""Stateful stdlib (reference: ``python/pathway/stdlib/stateful/``).

Carried from ``pathway_tpu/stdlib/stateful/__init__.py``.
"""

from __future__ import annotations

from typing import Callable

import pathway_tpu_torch as pw


def deduplicate(
    table: "pw.Table",
    *,
    col=None,
    instance=None,
    acceptor: Callable | None = None,
    value=None,
) -> "pw.Table":
    """Keep, per ``instance``, the latest row whose ``col`` value the
    ``acceptor(new_value, previous_accepted)`` callback accepts
    (reference: ``stdlib/stateful/deduplicate.py``)."""
    if col is not None and value is not None:
        raise ValueError("deduplicate: pass either col= or value=, not both")
    return table.deduplicate(
        value=col if col is not None else value, instance=instance, acceptor=acceptor
    )


__all__ = ["deduplicate"]
