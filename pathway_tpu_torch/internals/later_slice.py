"""The planes of ``pathway_tpu`` that the port has not carried yet.

A call site that reaches one raises ``NotImplementedError("later slice:
<plane>")`` instead of failing with an ``ImportError`` deep in a call.
ROADMAP.md Queue 1 lists the planes in the order later slices bring them back.
"""

from __future__ import annotations


def later_slice(plane: str) -> NotImplementedError:
    """The error for a call that needs ``plane``; the caller raises it."""
    return NotImplementedError(f"later slice: {plane}")


#: the flow plane's service classes (reference ``flow/admission.py``)
SERVICE_CLASSES = ("interactive", "bulk")


def arrival_order(service_class: str) -> str:
    """A reader's ``service_class`` orders admission in the flow plane: under
    pressure, ``bulk`` sources drain behind ``interactive`` ones. The flow
    plane is not ported, so every class is served in arrival order, as the
    reference serves them while its plane is off (``PATHWAY_FLOW=off``, the
    default); the name is checked as the reference checks it."""
    sc = str(service_class).strip().lower()
    if sc not in SERVICE_CLASSES:
        raise ValueError(f"service_class must be one of {SERVICE_CLASSES}, got {service_class!r}")
    return sc


def interactive_only(service_class: str) -> str:
    """A sink's ``service_class`` scopes the flow plane's latency objective.
    The flow plane is not ported, so only the reference's default class,
    ``"interactive"``, is accepted."""
    sc = str(service_class).strip().lower()
    if sc != "interactive":
        raise later_slice(f"flow (service_class={service_class!r})")
    return sc


def cut_callable(plane: str, name: str):
    """A stand-in for the reference's ``pw.<name>``: calling it raises
    ``later_slice(plane)``, so a pipeline that reaches an unported plane
    fails at the call instead of with an ``AttributeError``."""

    def cut(*args, **kwargs):
        raise later_slice(plane)

    cut.__name__ = cut.__qualname__ = name
    cut.__doc__ = f"The reference's ``pw.{name}``; the {plane} plane is a later slice."
    return cut


class _CutClassMeta(type):
    def __call__(cls, *args, **kwargs):
        raise later_slice(cls._plane)


def cut_class(plane: str, name: str) -> type:
    """A stand-in class for the reference's ``pw.<name>``: building it or
    subclassing it raises ``later_slice(plane)``."""

    def init_subclass(sub, **kwargs):
        raise later_slice(plane)

    return _CutClassMeta(
        name,
        (),
        {
            "_plane": plane,
            "__init_subclass__": classmethod(init_subclass),
            "__doc__": f"The reference's ``pw.{name}``; the {plane} plane is a later slice.",
        },
    )
