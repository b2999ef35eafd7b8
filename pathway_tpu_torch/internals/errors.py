"""Error / Pending sentinel values.

Mirrors the reference's ``Value::Error`` poisoning semantics and ``Value::Pending``
(``src/engine/value.rs:207-229``): a failed row-level computation yields ERROR which
propagates through downstream expressions instead of aborting the run (when
``terminate_on_error=False``); PENDING marks fully-async UDF results not yet arrived.
"""

from __future__ import annotations


class _Error:
    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self) -> str:
        return "Error"

    def __bool__(self) -> bool:
        raise ValueError("Error value used in a boolean context")


class _Pending:
    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self) -> str:
        return "Pending"


ERROR = _Error()
PENDING = _Pending()


def is_error(v: object) -> bool:
    return v is ERROR


class EngineError(Exception):
    pass


class EngineErrorWithTrace(EngineError):
    pass


class OtherWorkerError(EngineError):
    """A cluster peer process died or stopped responding.

    Structured counterpart of the reference's worker-panic surfacing (SURVEY
    §5.3: a worker panic propagates as ``OtherWorkerError`` to the survivors,
    recovery = restart + persistence replay). Raised by the cluster barrier /
    heartbeat plane instead of a bare ``RuntimeError`` so supervisors and
    operators can see WHICH process failed and WHEN:

    - ``process_id``: the dead peer's ``PATHWAY_PROCESS_ID`` (None if unknown —
      e.g. a startup timeout before any peer identified itself),
    - ``tick``: the last logical tick the peer was known alive at (None if it
      never reported one),
    - ``reason``: short machine-readable cause — ``"disconnected"``,
      ``"heartbeat-timeout"``, ``"barrier-timeout"``, ``"never-joined"``,
      ``"coordinator-lost"``.
    """

    def __init__(
        self,
        message: str,
        *,
        process_id: int | None = None,
        tick: int | None = None,
        reason: str = "unknown",
    ):
        super().__init__(message)
        self.process_id = process_id
        self.tick = tick
        self.reason = reason


# -- error policy (reference: terminate_on_error flag threaded into the engine,
# ``src/engine/error.rs`` + ``internals/run.py``) ------------------------------

# module default is poison-mode (debug/compute tooling inspects ERROR values);
# ``pw.run`` sets the policy from its ``terminate_on_error`` kwarg for the run
_policy = {"terminate": False}


def set_error_policy(terminate: bool) -> None:
    _policy["terminate"] = terminate


def get_error_policy() -> bool:
    return _policy["terminate"]


def report_error(message: str, trace: str = "", operator_id: int = -1):
    """Row-level failure. ``terminate_on_error=True`` (the default) aborts the
    run with the original failure; ``False`` logs to ``pw.global_error_log()``
    and returns ERROR, which poisons downstream expressions instead
    (``Value::Error`` semantics, ``src/engine/value.rs:207-229``)."""
    if _policy["terminate"]:
        raise EngineErrorWithTrace(
            f"{message}\n(set terminate_on_error=False to route row-level "
            "failures to pw.global_error_log() instead)"
        )
    from pathway_tpu_torch.internals.error_log import log_error

    log_error(operator_id, message, trace)
    return ERROR
