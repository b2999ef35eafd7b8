"""Apache Iceberg connector, implemented against the open table format.

Reference: ``python/pathway/io/iceberg`` over the Rust ``IcebergBatchWriter``
(``src/connectors/data_lake/iceberg.rs``, iceberg-rust).
That stack talks to a REST catalog; the port needs neither it nor pyiceberg, so — like the Delta connector (``io/deltalake.py``) — this module
implements the protocol itself over a filesystem/object-store warehouse
(the Hadoop-catalog layout):

```
<warehouse>/<namespace...>/<table>/
  metadata/version-hint.text         latest metadata version (int)
  metadata/v<N>.metadata.json        table metadata: schema, snapshots
  metadata/snap-<id>.avro            manifest list  (Avro, io/_avro.py)
  metadata/manifest-<n>.avro         manifest: data-file entries
  data/part-*.parquet                row data (pyarrow), with time/diff
```

Each output batch commits one snapshot: parquet data file → manifest →
manifest list (all manifests so far) → next ``v<N>.metadata.json`` →
``version-hint.text`` swing. The reader replays the current snapshot's data
files (static) or polls ``version-hint.text`` and emits rows of data files it
has not yet processed (streaming), netting recorded ``diff``s like the Delta
reader. ``catalog_uri`` accepts a filesystem path (or ``file://`` URI) as the
warehouse root; a remote REST catalog is a dependency gate (``pyiceberg``).
"""

from __future__ import annotations

import json as _json
import os
import time as _time
import uuid
from typing import Any

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals.table import Table, table_from_static_data
from pathway_tpu_torch.io import _avro
from pathway_tpu_torch.io.deltalake import _make_coercer, _stringify

_MANIFEST_SCHEMA = {
    "type": "record",
    "name": "manifest_entry",
    "fields": [
        {"name": "status", "type": "int"},
        {"name": "snapshot_id", "type": ["null", "long"]},
        {
            "name": "data_file",
            "type": {
                "type": "record",
                "name": "r2",
                "fields": [
                    {"name": "file_path", "type": "string"},
                    {"name": "file_format", "type": "string"},
                    {"name": "record_count", "type": "long"},
                    {"name": "file_size_in_bytes", "type": "long"},
                ],
            },
        },
    ],
}

_MANIFEST_LIST_SCHEMA = {
    "type": "record",
    "name": "manifest_file",
    "fields": [
        {"name": "manifest_path", "type": "string"},
        {"name": "manifest_length", "type": "long"},
        {"name": "partition_spec_id", "type": "int"},
        {"name": "added_snapshot_id", "type": ["null", "long"]},
    ],
}


def _iceberg_type(d) -> str:
    # same physical mapping as the Delta connector (shared coercion helpers
    # require the two connectors' string-degradation sets to stay identical)
    from pathway_tpu_torch.io.deltalake import _delta_type

    return {"long": "long", "double": "double", "boolean": "boolean", "binary": "binary"}.get(
        _delta_type(d), "string"
    )


def _table_root(
    catalog_uri: str, namespace: list[str], table_name: str, warehouse: str | None
) -> str:
    root = warehouse or catalog_uri
    if root.startswith("file://"):
        root = root[len("file://"):]
    if root.startswith(("http://", "https://")):
        raise NotImplementedError(
            "pw.io.iceberg: REST catalogs need a catalog client not available "
            "in this environment; pass a filesystem warehouse path instead"
        )
    return os.path.join(root, *namespace, table_name)


def _meta_dir(troot: str) -> str:
    return os.path.join(troot, "metadata")


def _current_version(troot: str) -> int:
    hint = os.path.join(_meta_dir(troot), "version-hint.text")
    try:
        with open(hint) as fh:
            return int(fh.read().strip())
    except (FileNotFoundError, ValueError):
        return 0


def _max_version_on_disk(troot: str) -> int:
    """Highest v<N>.metadata.json present — a writer may have died between
    creating vN and swinging the hint, so the hint alone can lag the disk."""
    try:
        names = os.listdir(_meta_dir(troot))
    except FileNotFoundError:
        return 0
    best = 0
    for fn in names:
        if fn.startswith("v") and fn.endswith(".metadata.json"):
            stem = fn[1 : -len(".metadata.json")]
            if stem.isdigit():
                best = max(best, int(stem))
    return best


def _load_metadata(troot: str, version: int) -> dict | None:
    p = os.path.join(_meta_dir(troot), f"v{version}.metadata.json")
    try:
        with open(p) as fh:
            return _json.load(fh)
    except FileNotFoundError:
        return None
    except ValueError:
        # truncated metadata (a writer that published without a link died
        # mid json.dump; writers publish atomically via link): treat as absent so the commit loop's
        # hint fallback engages instead of crashing every later commit
        return None


def _snapshot_files(troot: str, meta: dict) -> list[str]:
    """Data-file paths of the metadata's current snapshot."""
    snap_id = meta.get("current-snapshot-id")
    snap = next(
        (s for s in meta.get("snapshots", []) if s["snapshot-id"] == snap_id), None
    )
    if snap is None:
        return []
    _schema, manifests = _avro.read_container(
        os.path.join(troot, snap["manifest-list"])
    )
    files: list[str] = []
    seen: set[str] = set()
    for m in manifests:
        _s, entries = _avro.read_container(os.path.join(troot, m["manifest_path"]))
        for e in entries:
            fp = e["data_file"]["file_path"]
            if e["status"] != 2 and fp not in seen:  # 2 = DELETED
                seen.add(fp)
                files.append(fp)
    return files


def write(
    table: Table,
    catalog_uri: str,
    namespace: list[str],
    table_name: str,
    *,
    warehouse: str | None = None,
    name: str | None = None,
    **kwargs: Any,
) -> None:
    import pyarrow as pa
    import pyarrow.parquet as pq

    from pathway_tpu_torch.engine import operators as ops
    from pathway_tpu_torch.internals.logical import LogicalNode

    troot = _table_root(catalog_uri, namespace, table_name, warehouse)
    cols = table.column_names()
    if "time" in cols or "diff" in cols:
        raise ValueError(
            "pw.io.iceberg.write adds its own time/diff columns; rename the "
            "table's 'time'/'diff' columns before writing"
        )
    dtypes = dict(table._schema.dtypes())
    os.makedirs(_meta_dir(troot), exist_ok=True)
    os.makedirs(os.path.join(troot, "data"), exist_ok=True)
    stringly = {c for c in cols if _iceberg_type(dtypes.get(c, dt.STR)) == "string"}
    table_uuid = str(uuid.uuid4())

    def commit(data_path: str, n_rows: int) -> None:
        # optimistic concurrency on the metadata version: vN must be CREATED,
        # never overwritten; the base version scans the DISK, not just the
        # hint — a writer that died after creating vN but before the hint
        # swing must not trap every later commit in a FileExistsError spin
        while True:
            version = max(_current_version(troot), _max_version_on_disk(troot))
            # prev must be the SAME version the commit builds upon: after a
            # FileExistsError retry (or a hint lagging the disk), loading prev
            # from the stale hint would build a manifest list that silently
            # omits the winning writer's data files — a lost update
            prev = _load_metadata(troot, version)
            if prev is None and version != _current_version(troot):
                prev = _load_metadata(troot, _current_version(troot))
            new_version = version + 1
            snap_id = int(_time.time_ns() % (2**62))
            mdir = _meta_dir(troot)
            manifest_name = f"manifest-{new_version:08d}-{uuid.uuid4().hex[:8]}.avro"
            _avro.write_container(
                os.path.join(mdir, manifest_name),
                _MANIFEST_SCHEMA,
                [
                    {
                        "status": 1,  # ADDED
                        "snapshot_id": snap_id,
                        "data_file": {
                            "file_path": data_path,
                            "file_format": "PARQUET",
                            "record_count": n_rows,
                            "file_size_in_bytes": os.path.getsize(
                                os.path.join(troot, data_path)
                            ),
                        },
                    }
                ],
            )
            # manifest list = every manifest so far (full table state)
            prev_manifests: list[dict] = []
            if prev is not None and prev.get("current-snapshot-id") is not None:
                snap = next(
                    (
                        s
                        for s in prev.get("snapshots", [])
                        if s["snapshot-id"] == prev["current-snapshot-id"]
                    ),
                    None,
                )
                if snap is not None:
                    _s, prev_manifests = _avro.read_container(
                        os.path.join(troot, snap["manifest-list"])
                    )
            mlist_name = f"snap-{snap_id}-{uuid.uuid4().hex[:8]}.avro"
            mpath = os.path.join("metadata", manifest_name)
            _avro.write_container(
                os.path.join(mdir, mlist_name),
                _MANIFEST_LIST_SCHEMA,
                prev_manifests
                + [
                    {
                        "manifest_path": mpath,
                        "manifest_length": os.path.getsize(
                            os.path.join(mdir, manifest_name)
                        ),
                        "partition_spec_id": 0,
                        "added_snapshot_id": snap_id,
                    }
                ],
            )
            fields = [
                {
                    "id": i + 1,
                    "name": c,
                    "required": False,
                    "type": _iceberg_type(dtypes.get(c, dt.STR)),
                }
                for i, c in enumerate(cols)
            ]
            fields += [
                {"id": len(cols) + 1, "name": "time", "required": False, "type": "long"},
                {"id": len(cols) + 2, "name": "diff", "required": False, "type": "long"},
            ]
            snapshots = (prev.get("snapshots", []) if prev else []) + [
                {
                    "snapshot-id": snap_id,
                    "sequence-number": new_version,
                    "timestamp-ms": int(_time.time() * 1000),
                    "manifest-list": os.path.join("metadata", mlist_name),
                    "summary": {"operation": "append"},
                }
            ]
            meta = {
                "format-version": 2,
                "table-uuid": (prev or {}).get("table-uuid", table_uuid),
                "location": troot,
                "last-sequence-number": new_version,
                "schemas": [{"schema-id": 0, "type": "struct", "fields": fields}],
                "current-schema-id": 0,
                "snapshots": snapshots,
                "current-snapshot-id": snap_id,
            }
            # publish vN atomically: the file must appear fully written (a
            # concurrent writer's max-version scan may json.load it the
            # instant it exists) AND exclusively (exactly one writer may own
            # vN). Write to a private tmp, then hard-link into place — link
            # fails with FileExistsError when another writer won the version.
            vpath = os.path.join(mdir, f"v{new_version}.metadata.json")
            tmp_meta = os.path.join(
                mdir, f"v{new_version}.tmp-{os.getpid()}-{uuid.uuid4().hex[:8]}"
            )
            with open(tmp_meta, "w") as fh:
                _json.dump(meta, fh)
            try:
                os.link(tmp_meta, vpath)
            except FileExistsError:
                os.unlink(tmp_meta)
                continue  # another writer won the version: retry on top of it
            os.unlink(tmp_meta)
            tmp = os.path.join(mdir, f"version-hint.tmp{os.getpid()}")
            with open(tmp, "w") as fh:
                fh.write(str(new_version))
            os.replace(tmp, os.path.join(mdir, "version-hint.text"))
            return

    def on_batch(batch, columns) -> None:
        from pathway_tpu_torch.engine.blocks import column_to_list

        n = len(batch)
        if not n:
            return
        arrays: dict[str, list] = {}
        for c in cols:
            vals = column_to_list(batch.data[c])
            if c in stringly:
                vals = [_stringify(v) for v in vals]
            arrays[c] = vals
        arrays["time"] = [batch.time] * n
        arrays["diff"] = batch.diffs.tolist()
        part = os.path.join("data", f"part-{uuid.uuid4().hex}.parquet")
        pq.write_table(pa.table(arrays), os.path.join(troot, part))
        commit(part, n)

    LogicalNode(
        lambda: ops.CallbackOutputNode(cols, on_batch),
        [table._node],
        name=name or f"iceberg_write:{table_name}",
    )._register_as_output()


def _file_rows(troot: str, fpath: str, schema_cols: list[str], dtypes: dict) -> list[tuple]:
    import pyarrow.parquet as pq

    coercers = {
        c: _make_coercer(dtypes[c])
        for c in schema_cols
        if c in dtypes and dt.unoptionalize(dtypes[c]) not in (dt.STR, dt.ANY)
    }
    t = pq.read_table(os.path.join(troot, fpath))
    data = {c: t.column(c).to_pylist() for c in t.column_names}
    n = t.num_rows
    diffs = data.get("diff") or [1] * n
    col_lists = [data.get(c) or [None] * n for c in schema_cols]
    for i, c in enumerate(schema_cols):
        conv = coercers.get(c)
        if conv is not None and data.get(c) is not None:
            col_lists[i] = [None if v is None else conv(v) for v in col_lists[i]]
    return list(zip(zip(*col_lists) if col_lists else [()] * n, map(int, diffs)))


def read(
    catalog_uri: str,
    namespace: list[str],
    table_name: str,
    *,
    schema: schema_mod.SchemaMetaclass,
    mode: str = "streaming",
    warehouse: str | None = None,
    autocommit_duration_ms: int | None = None,
    name: str | None = None,
    **kwargs: Any,
) -> Table:
    troot = _table_root(catalog_uri, namespace, table_name, warehouse)
    cols = schema.column_names()
    if mode not in ("static", "streaming"):
        raise ValueError(f"unknown iceberg read mode {mode!r}")
    dtypes = schema.dtypes()

    if mode == "static":
        from pathway_tpu_torch.io.fs import _keys_for

        meta = _load_metadata(troot, _current_version(troot))
        net: dict[tuple, int] = {}
        order: list[tuple] = []
        if meta is not None:
            for fp in _snapshot_files(troot, meta):
                for r, d in _file_rows(troot, fp, cols, dtypes):
                    if r not in net:
                        order.append(r)
                    net[r] = net.get(r, 0) + d
        all_rows = [r for r in order for _ in range(max(net[r], 0))]
        keys = _keys_for(all_rows, schema, salt=hash(troot) & 0xFFFF)
        return table_from_static_data(keys, all_rows, schema)

    from pathway_tpu_torch.internals.keys import stable_hash_obj
    from pathway_tpu_torch.io.fs import _keys_for
    from pathway_tpu_torch.io.python import ConnectorSubject, read as py_read

    pks = schema.primary_key_columns()

    class _IcebergSubject(ConnectorSubject):
        def __init__(self) -> None:
            super().__init__()
            self._seen_version = 0
            self._seen_files: set[str] = set()
            self._stop = False
            self._bounded = kwargs.get("_bounded", False)

        def run(self) -> None:
            while not self._stop:
                version = _current_version(troot)
                found = False
                if version > self._seen_version:
                    meta = _load_metadata(troot, version)
                    if meta is not None:
                        for fp in _snapshot_files(troot, meta):
                            if fp in self._seen_files:
                                continue
                            found = True
                            vrows = _file_rows(troot, fp, cols, dtypes)
                            values_list = [r for r, _d in vrows]
                            if pks:
                                # primary-key keys: streaming and static modes
                                # agree; updates net as retract+insert in place
                                keys_ = _keys_for(values_list, schema, salt=0)
                            else:
                                # content-derived: a replayed retraction must
                                # net against its insert
                                keys_ = [int(stable_hash_obj(r)) for r in values_list]
                            assert self._node is not None
                            self._node.push_many(
                                (int(k), r, d) for k, (r, d) in zip(keys_, vrows)
                            )
                            self._seen_files.add(fp)
                        self._seen_version = version
                if self._bounded and not found:
                    return
                _time.sleep(0.1)

        # persistence contract: committed version + processed files
        def offset_state(self) -> dict:
            return {
                "version": self._seen_version,
                "files": sorted(self._seen_files),
                "seq": self._seq,
            }

        def seek(self, state: dict) -> None:
            self._seen_version = int(state.get("version", 0))
            self._seen_files = set(state.get("files", []))
            self._seq = int(state.get("seq", 0))

        def on_stop(self) -> None:
            self._stop = True

    return py_read(
        _IcebergSubject(),
        schema=schema,
        autocommit_duration_ms=autocommit_duration_ms,
        name=name or f"iceberg:{table_name}",
    )
