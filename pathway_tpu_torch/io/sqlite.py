"""SQLite connector (reference: ``SqliteReader``, ``src/connectors/data_storage.rs:1707``
+ ``python/pathway/io/sqlite``).

``mode="static"`` snapshots the table once. ``mode="streaming"`` polls SQLite's
``data_version`` pragma and re-scans on change, emitting upsert deltas keyed by the
schema's primary keys — the reference reader's snapshot-diff behavior.
"""

from __future__ import annotations

import sqlite3
import threading
import time as _time
from typing import Any

from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io._format import coerce_scalar


def _scan(path: str, table_name: str, schema: schema_mod.SchemaMetaclass) -> list[tuple]:
    cols = schema.column_names()
    dtypes = schema.dtypes()
    con = sqlite3.connect(path)
    try:
        cur = con.execute(
            f"SELECT {', '.join(cols)} FROM {table_name}"  # noqa: S608 — names from schema
        )
        return [
            tuple(coerce_scalar(v, dtypes[c]) for v, c in zip(row, cols))
            for row in cur.fetchall()
        ]
    finally:
        con.close()


def read(
    path: str,
    table_name: str,
    schema: schema_mod.SchemaMetaclass,
    *,
    mode: str = "streaming",
    poll_interval: float = 0.2,
    autocommit_duration_ms: int | None = None,
    name: str | None = None,
    **kwargs: Any,
) -> Table:
    if mode == "static":
        from pathway_tpu_torch.io.fs import _keys_for
        from pathway_tpu_torch.internals.table import table_from_static_data

        rows = _scan(path, table_name, schema)
        keys = _keys_for(rows, schema, salt=hash(table_name) & 0xFFFF)
        return table_from_static_data(keys, rows, schema)

    if not schema.primary_key_columns():
        raise ValueError("sqlite streaming mode requires a schema with primary keys")

    from pathway_tpu_torch.io.python import ConnectorSubject, read as py_read

    class _SqliteSubject(ConnectorSubject):
        def __init__(self) -> None:
            super().__init__()
            self._stop = False
            self._snapshot: dict[tuple, tuple] = {}
            self.sync_lock = threading.Lock()

        @property
        def _session_type(self) -> str:
            return "upsert"

        def _emit_diff(self) -> None:
            pk_idx = [schema.column_names().index(c) for c in schema.primary_key_columns()]
            current = {tuple(r[i] for i in pk_idx): r for r in _scan(path, table_name, schema)}
            with self.sync_lock:
                for pk, row in current.items():
                    if self._snapshot.get(pk) != row:
                        self._push(row, diff=1)  # upsert session retracts the old row
                for pk, row in self._snapshot.items():
                    if pk not in current:
                        self._node.push(self._key_of(row), None, -1)
                self._snapshot = current

        def run(self) -> None:
            # re-scan each poll; the keyed snapshot diff emits deltas only for
            # changed rows (PRAGMA data_version is per-connection, so a fresh
            # connection per poll cannot use it as a change signal)
            while not self._stop:
                try:
                    self._emit_diff()
                except sqlite3.Error:
                    pass  # writer mid-transaction; retry next poll
                _time.sleep(poll_interval)

        def on_stop(self) -> None:
            self._stop = True

    return py_read(
        _SqliteSubject(), schema=schema, name=name or f"sqlite:{table_name}"
    )
