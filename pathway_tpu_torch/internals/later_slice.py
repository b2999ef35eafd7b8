"""The planes of ``pathway_tpu`` that the port has not carried yet.

A call site that reaches one raises ``NotImplementedError("later slice:
<plane>")`` instead of failing with an ``ImportError`` deep in a call.
ROADMAP.md Queue 1 lists the planes in the order later slices bring them back.
"""

from __future__ import annotations


def later_slice(plane: str) -> NotImplementedError:
    """The error for a call that needs ``plane``; the caller raises it."""
    return NotImplementedError(f"later slice: {plane}")


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
