"""``pw.export_table`` / ``pw.import_table`` — cross-graph composition.

Counterpart of the reference's ``ExportedTable`` trait + ``Scope.export_table``
/ ``Scope.import_table`` (``src/engine/graph.rs:614-624``,
``graph_runner/operator_handler.py:155,206``): one graph exports a table as a
thread-safe buffered diff stream with a frontier; another graph — typically a
later ``pw.run`` or an interactive-mode LiveTable consumer — imports it as a
live source. Keys and diffs are preserved exactly; logical times are
re-assigned by the importing graph's clock (each graph owns its frontier, as
in the reference where imported streams enter a fresh input session).

Carried from ``pathway_tpu/internals/exported.py`` with imports rewritten.
"""

from __future__ import annotations

import threading
import time as _time
from typing import Any, Callable

from pathway_tpu_torch.engine.graph import END_OF_STREAM, SOLO, Node
from pathway_tpu_torch.internals.logical import LogicalNode


class ExportedTable:
    """Buffered (key, values, time, diff) stream + frontier + callbacks —
    the ``ExportedTable`` trait surface (``graph.rs:614-624``)."""

    def __init__(self, column_names: list[str], dtypes: dict[str, Any]):
        self.column_names = list(column_names)
        self.dtypes = dict(dtypes)
        self._lock = threading.Lock()
        self._rows: list[tuple[int, tuple, int, int]] = []
        self._frontier = -1  # last completed logical time
        self._closed = False
        self._failed = False
        self._callbacks: list[Callable[[], None]] = []

    # -- reader surface ------------------------------------------------------
    def failed(self) -> bool:
        return self._failed

    @property
    def closed(self) -> bool:
        return self._closed

    def frontier(self) -> int:
        return self._frontier

    def data_from_offset(self, offset: int) -> tuple[list, int]:
        """Rows appended since ``offset`` and the next offset to poll from."""
        with self._lock:
            return self._rows[offset:], len(self._rows)

    def subscribe(self, callback: Callable[[], None]) -> None:
        """``callback()`` fires after every frontier advance and on close."""
        with self._lock:
            self._callbacks.append(callback)

    def snapshot_at(self, frontier: int | None = None) -> list[tuple[int, tuple]]:
        """Consolidated live rows at ``frontier`` (default: everything),
        sorted by key — ``ExportedTable::snapshot_at`` semantics.

        Nets on (key, values) pairs like engine consolidation: a
        key holding several distinct value tuples keeps each with its own
        multiplicity, and a retraction for values never inserted can't pin
        those values into the snapshot. Rows with multiplicity m appear m
        times, matching the engine's multiset semantics."""
        # values tuples may hold unhashable cells (ndarray columns) — net on a
        # hashable digest, keep the original tuple for the result
        def hkey(values: tuple):
            try:
                hash(values)
                return values
            except TypeError:
                from pathway_tpu_torch.internals.keys import stable_hash_obj

                return ("__digest__", int(stable_hash_obj(values)))

        net: dict[tuple[int, Any], list] = {}  # (key, digest) -> [values, count]
        with self._lock:
            rows = list(self._rows)
        for key, values, t, diff in rows:
            if frontier is not None and t > frontier:
                continue
            hk = (key, hkey(values))
            ent = net.get(hk)
            if ent is None:
                net[hk] = [values, diff]
            else:
                ent[1] += diff
        # stable sort by key only: value tuples may be incomparable (None vs int)
        return sorted(
            ((key, vals) for (key, _), (vals, d) in net.items() if d > 0 for _ in range(d)),
            key=lambda r: r[0],
        )

    # -- writer surface (ExportNode only) ------------------------------------
    def _append(self, rows: list[tuple[int, tuple, int, int]]) -> None:
        with self._lock:
            self._rows.extend(rows)

    def _advance(self, frontier: int) -> None:
        with self._lock:
            if frontier > self._frontier:
                self._frontier = frontier
            callbacks = list(self._callbacks)
        for cb in callbacks:
            cb()

    def _close(self, failed: bool = False) -> None:
        with self._lock:
            self._closed = True
            self._failed = failed
            callbacks = list(self._callbacks)
        for cb in callbacks:
            cb()


class ExportNode(Node):
    """Output node appending every diff to an :class:`ExportedTable`."""

    name = "export_table"

    def exchange_key(self, port):
        return SOLO  # output order discipline, like other sinks

    def __init__(self, columns: list[str], exported: ExportedTable):
        super().__init__(n_inputs=1)
        self.columns = columns
        self.exported = exported

    def process(self, inputs, time):
        batch = inputs[0]
        if batch is None:
            return []
        self.exported._append(
            [(key, tuple(row), time, diff) for key, diff, row in batch.rows()]
        )
        return []

    def on_tick_complete(self, time):
        # advance only once the tick fully settled (frontier rounds included):
        # a live reader seeing frontier()==t must see ALL of tick t's rows
        if time != END_OF_STREAM:
            self.exported._advance(time)

    def on_end(self):
        self.exported._close()


def fail_close_exports(runtime) -> None:
    """A crashed run never reaches ``scheduler.close()``/``on_end``; close its
    exported tables as FAILED so importers stop polling instead of hanging."""
    scheduler = getattr(runtime, "scheduler", None)
    graphs = []
    if scheduler is not None and getattr(scheduler, "graph", None) is not None:
        graphs.append(scheduler.graph)
    for w in getattr(runtime, "workers", None) or []:
        if getattr(w, "graph", None) is not None:
            graphs.append(w.graph)
    for g in graphs:
        for node in g.nodes:
            if isinstance(node, ExportNode) and not node.exported.closed:
                node.exported._close(failed=True)


def export_table(table) -> ExportedTable:
    """Register ``table`` for export; the returned handle fills during
    ``pw.run`` and stays readable afterwards."""
    exported = ExportedTable(table.column_names(), dict(table._schema.dtypes()))
    node = LogicalNode(
        lambda: ExportNode(exported.column_names, exported),
        [table._node],
        name="export_table",
    )
    node._register_as_output()
    return exported


def import_table(exported: ExportedTable):
    """A live source table over an :class:`ExportedTable` (same columns, keys
    and diffs preserved). If the exporting run already finished, the import
    is a bounded replay; if it is still running (interactive mode), rows
    stream in as the exporter's frontier advances."""
    from pathway_tpu_torch import io as pw_io
    from pathway_tpu_torch.internals import schema as schema_mod

    schema = schema_mod.schema_from_dtypes(dict(exported.dtypes))

    class _ImportSubject(pw_io.python.ConnectorSubject):
        def _push_rows(self, rows) -> None:
            if rows:
                assert self._node is not None
                self._node.push_many(
                    (key, values, diff) for key, values, _t, diff in rows
                )

        def run(self) -> None:
            offset = 0
            while True:
                if exported.closed:
                    # close implies every appended row is finalized
                    rows, offset = exported.data_from_offset(offset)
                    self._push_rows(rows)
                    if exported.failed():
                        raise RuntimeError(
                            "import_table: the exporting run failed before "
                            "completing its stream"
                        )
                    break
                # only finalized ticks cross the graph boundary: rows past the
                # exporter's frontier may still be revised within their tick
                # (pad-then-correct churn the exporter's own subscribers never
                # see). Appends are time-ordered, so the finalized rows form a
                # prefix.
                f = exported.frontier()
                rows, _next = exported.data_from_offset(offset)
                n_fin = 0
                for r in rows:
                    if r[2] > f:
                        break
                    n_fin += 1
                self._push_rows(rows[:n_fin])
                offset += n_fin
                _time.sleep(0.002)

    return pw_io.python.read(_ImportSubject(), schema=schema, name="import_table")
