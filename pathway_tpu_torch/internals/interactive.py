"""Interactive (notebook) mode — ``pw.enable_interactive_mode()`` +
``pw.live(table)`` (reference: ``internals/interactive.py`` LiveTables).

With interactive mode on, ``pw.run()`` starts the runtime on a daemon thread
and returns immediately with a handle; ``LiveTable`` objects subscribe to
their table and keep a pandas snapshot that notebooks re-render as updates
stream in.

Carried from ``pathway_tpu/internals/interactive.py`` with imports rewritten."""

from __future__ import annotations

import threading
from typing import Any

_interactive = False


def enable_interactive_mode() -> None:
    global _interactive
    _interactive = True


def is_interactive_mode_enabled() -> bool:
    return _interactive


class InteractiveRunHandle:
    """Returned by ``pw.run()`` in interactive mode."""

    def __init__(self, runtime, thread: threading.Thread, on_finish=None):
        self._runtime = runtime
        self._thread = thread
        self._on_finish = on_finish

    def _finish(self) -> None:
        if self._on_finish is not None and not self._thread.is_alive():
            cb, self._on_finish = self._on_finish, None
            cb()

    def stop(self, timeout: float = 10.0) -> None:
        self._runtime.request_stop()
        self._thread.join(timeout)
        self._finish()

    def join(self, timeout: float | None = None) -> None:
        self._thread.join(timeout)
        self._finish()

    @property
    def alive(self) -> bool:
        return self._thread.is_alive()


class LiveTable:
    """A live, auto-updating snapshot of a table (create BEFORE ``pw.run``)."""

    def __init__(self, table: Any):
        from pathway_tpu_torch.io._subscribe import subscribe

        self._columns = table.column_names()
        self._rows: dict[int, tuple] = {}
        self._lock = threading.Lock()
        self.version = 0

        def on_change(key, row, time, is_addition):
            with self._lock:
                if is_addition:
                    self._rows[int(key)] = tuple(row[c] for c in self._columns)
                else:
                    self._rows.pop(int(key), None)
                self.version += 1

        subscribe(table, on_change)

    def to_pandas(self):
        import pandas as pd

        with self._lock:
            rows = dict(self._rows)
        return pd.DataFrame.from_dict(
            rows, orient="index", columns=self._columns
        ).sort_index()

    def __len__(self) -> int:
        with self._lock:
            return len(self._rows)

    def _repr_html_(self) -> str:
        return self.to_pandas()._repr_html_()

    def __repr__(self) -> str:
        return repr(self.to_pandas())


def live(table: Any) -> LiveTable:
    return LiveTable(table)
