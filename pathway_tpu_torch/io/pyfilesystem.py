"""PyFilesystem connector (reference ``python/pathway/io/pyfilesystem``).

The reference's API takes an ``fs.base.FS`` OBJECT (``fs.open_fs(...)``) —
the filesystem itself is the injected client, so the connector runs against
any object with the small FS surface it touches (``listdir``/``isdir``/
``readbytes`` or ``open``, ``getinfo`` with a modified timestamp when
available). Static mode reads the tree once; streaming polls for new or
modified files, retracting replaced versions like the fs/s3 connectors."""

from __future__ import annotations

import time as _time
from typing import Any

from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals.table import Table, table_from_static_data


def _walk(source_fs: Any, path: str) -> list[str]:
    out: list[str] = []
    stack = [path.rstrip("/") or "/"]
    while stack:
        cur = stack.pop()
        for entry in sorted(source_fs.listdir(cur)):
            full = f"{cur.rstrip('/')}/{entry}"
            if source_fs.isdir(full):
                stack.append(full)
            else:
                out.append(full)
    return sorted(out)


def _read_bytes(source_fs: Any, path: str) -> bytes:
    if hasattr(source_fs, "readbytes"):
        return source_fs.readbytes(path)
    with source_fs.open(path, "rb") as fh:  # pragma: no cover - alt surface
        return fh.read()


def _mtime(source_fs: Any, path: str) -> Any:
    try:
        info = source_fs.getinfo(path, namespaces=["details"])
        return getattr(info, "modified", None) or info.raw.get("details", {}).get(
            "modified"
        )
    except Exception:
        return None


def read(
    source_fs: Any,
    path: str = "/",
    *,
    format: str = "binary",  # noqa: A002
    schema: schema_mod.SchemaMetaclass | None = None,
    mode: str = "streaming",
    with_metadata: bool = False,
    name: str | None = None,
    refresh_interval: float = 0.5,
    **kwargs: Any,
) -> Table:
    from pathway_tpu_torch.io._format import rows_from_bytes

    if schema is None:
        if format in ("plaintext", "plaintext_by_file"):
            schema = schema_mod.schema_from_types(data=str)
        elif format == "binary":
            schema = schema_mod.schema_from_types(data=bytes)
        else:
            raise ValueError("schema required for csv/json formats")
    base_schema = schema  # parse data columns only; _metadata appends after
    if with_metadata:
        schema = schema | schema_mod.schema_from_types(_metadata=dict)

    def file_rows(fpath: str) -> list[tuple]:
        rows = rows_from_bytes(_read_bytes(source_fs, fpath), format, base_schema)
        if with_metadata:
            from pathway_tpu_torch.internals.json import Json

            meta = Json({"path": fpath, "modified_at": str(_mtime(source_fs, fpath))})
            rows = [r + (meta,) for r in rows]
        return rows

    if mode == "static":
        from pathway_tpu_torch.io.fs import _keys_for

        all_rows: list[tuple] = []
        for fpath in _walk(source_fs, path):
            all_rows.extend(file_rows(fpath))
        keys = _keys_for(all_rows, schema, salt=hash(path) & 0xFFFF)
        return table_from_static_data(keys, all_rows, schema)

    from pathway_tpu_torch.io.python import ConnectorSubject, read as py_read

    class _FsSubject(ConnectorSubject):
        def __init__(self) -> None:
            super().__init__()
            self._seen: dict[str, Any] = {}
            self._emitted: dict[str, list] = {}
            self._stop = False
            self._bounded = kwargs.get("_bounded", False)

        def _retract(self, fpath: str) -> None:
            old = self._emitted.pop(fpath, None)
            if old:
                assert self._node is not None
                self._node.push_many((k, v, -1) for k, v in old)

        def run(self) -> None:
            while not self._stop:
                found = False
                try:
                    listing = _walk(source_fs, path)
                except Exception:
                    # transient FS error / directory raced away mid-walk:
                    # retry next poll instead of failing the pipeline
                    _time.sleep(refresh_interval)
                    continue
                live = set(listing)
                for gone in [f for f in self._seen if f not in live]:
                    found = True
                    del self._seen[gone]
                    self._retract(gone)
                for fpath in listing:
                    stamp = _mtime(source_fs, fpath)
                    if fpath in self._seen and self._seen[fpath] == stamp:
                        continue
                    changed = fpath in self._seen
                    self._seen[fpath] = stamp
                    found = True
                    if changed:
                        self._retract(fpath)
                    try:
                        values = file_rows(fpath)
                    except Exception:
                        self._seen.pop(fpath, None)  # vanished mid-read
                        continue
                    row_keys_ = self._keys_for(values)
                    assert self._node is not None
                    pairs = [(int(k), v) for k, v in zip(row_keys_, values)]
                    self._node.push_many((k, v, 1) for k, v in pairs)
                    self._emitted[fpath] = pairs
                if self._bounded and not found:
                    return
                _time.sleep(refresh_interval)

        def on_stop(self) -> None:
            self._stop = True

    return py_read(_FsSubject(), schema=schema, name=name or f"pyfilesystem:{path}")
