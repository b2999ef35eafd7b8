"""User stack-frame capture for diagnostics (reference: ``internals/trace.py``
``trace_user_frame``): every logical operator remembers the user code line
that created it, and engine failures annotate the raised exception with that
provenance — so a traceback deep in the block kernels still says which
``select``/``join``/``reduce`` in the user's pipeline it belongs to."""

from __future__ import annotations

import os
import sys
import threading

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__))) + os.sep

# the engine node whose method is currently executing on this thread — lets
# row-level failure reporting (``errors.report_error`` → the live error log)
# attribute a UDF raise to its operator without threading ids through every
# expression-VM call
_tls = threading.local()


def current_node():
    return getattr(_tls, "node", None)


def user_frame() -> tuple[str, int, str] | None:
    """(filename, lineno, code line description) of the nearest caller frame
    outside the pathway_tpu_torch package."""
    f = sys._getframe(1)
    while f is not None:
        fn = f.f_code.co_filename
        if not fn.startswith(_PKG_DIR) and "importlib" not in fn:
            return (fn, f.f_lineno, f.f_code.co_name)
        f = f.f_back
    return None


def format_frame(frame: tuple[str, int, str] | None) -> str | None:
    if frame is None:
        return None
    fn, line, func = frame
    return f"{fn}:{line} in {func}"


def annotate(exc: BaseException, op_name: str, frame: tuple[str, int, str] | None) -> None:
    """Attach operator provenance to an in-flight exception (PEP 678 note)."""
    where = format_frame(frame)
    note = f"while running operator {op_name!r}"
    if where:
        note += f" created at {where}"
    try:
        exc.add_note(note)
    except AttributeError:  # pre-3.11: emulate PEP 678's __notes__ list
        try:
            notes = getattr(exc, "__notes__", None)
            if notes is None:
                notes = exc.__notes__ = []
            notes.append(note)
        except Exception:
            pass


def run_annotated(node, method, *args):
    """Call an engine-node method, annotating any exception with the node's
    user provenance — the ONE wrapper every runtime shares. Also pins the
    node as this thread's current operator so row-level error reports
    attribute to it."""
    prev = getattr(_tls, "node", None)
    _tls.node = node
    try:
        return method(*args)
    except Exception as e:
        annotate(e, node.name, getattr(node, "user_trace", None))
        raise
    finally:
        _tls.node = prev
