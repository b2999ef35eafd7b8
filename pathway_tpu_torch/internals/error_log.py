"""Global error-log table + live per-operator error counters (reference:
``parse_graph.py:183-238`` — schema: operator_id, message, trace; rows appear
when ``terminate_on_error=False`` routes row-level failures to
``Value::Error`` + a log stream).

r12 wires this previously-orphaned log into the live observability plane:
every logged error also increments a per-operator counter, surfaced on
``/status`` (``errors`` section) and ``/metrics``
(``pathway_operator_errors_total{op}``). The operator label resolves from the
explicit ``operator_id`` when the caller has one, else from the engine node
currently executing on this thread (``internals.trace.current_node`` — set by
the shared ``run_annotated`` wrapper every runtime routes node calls
through), else ``"(unattributed)"``.
"""

from __future__ import annotations

import threading

from pathway_tpu_torch.internals import schema as schema_mod

_lock = threading.Lock()
_entries: list[tuple[int, str, str]] = []
_op_counts: dict[str, int] = {}


def _operator_label(operator_id: int) -> str:
    if operator_id >= 0:
        return f"op:{operator_id}"
    from pathway_tpu_torch.internals.trace import current_node

    node = current_node()
    if node is not None:
        return f"{node.name}:{node.node_index}"
    return "(unattributed)"


_recent: list[dict] = []  # bounded mirror with resolved operator labels


def log_error(operator_id: int, message: str, trace: str = "") -> None:
    label = _operator_label(operator_id)
    with _lock:
        _entries.append((operator_id, message, trace))
        _op_counts[label] = _op_counts.get(label, 0) + 1
        _recent.append({"operator": label, "message": message[:500]})
        if len(_recent) > 64:
            del _recent[:32]


def clear() -> None:
    with _lock:
        _entries.clear()
        _op_counts.clear()
        _recent.clear()


def operator_error_counts() -> dict[str, int]:
    """operator label -> errors logged (live plane: /status + /metrics)."""
    with _lock:
        return dict(_op_counts)


def summary() -> dict:
    """The ``/status`` ``errors`` section: total + per-operator counts + the
    most recent messages (bounded — the full log lives in
    ``pw.global_error_log()``)."""
    with _lock:
        return {
            "total": len(_entries),
            "by_operator": dict(_op_counts),
            "recent": list(_recent[-16:]),
        }


ERROR_LOG_SCHEMA = schema_mod.schema_from_types(
    operator_id=int, message=str, trace=str
)


def global_error_log():
    from pathway_tpu_torch.debug import table_from_rows

    with _lock:
        rows = list(_entries)
    return table_from_rows(ERROR_LOG_SCHEMA, rows)
