"""The planes of ``pathway_tpu`` that the port has not carried yet.

A call site that reaches one raises ``NotImplementedError("later slice:
<plane>")`` instead of failing with an ``ImportError`` deep in a call.
ROADMAP.md Queue 1 lists the planes in the order later slices bring them back.
"""

from __future__ import annotations


def later_slice(plane: str) -> NotImplementedError:
    """The error for a call that needs ``plane``; the caller raises it."""
    return NotImplementedError(f"later slice: {plane}")


def interactive_only(service_class: str) -> str:
    """``service_class`` scopes the flow plane's admission and latency
    objective. The flow plane is not ported, so only the reference's default
    class, ``"interactive"``, is accepted."""
    sc = str(service_class).strip().lower()
    if sc != "interactive":
        raise later_slice(f"flow (service_class={service_class!r})")
    return sc
