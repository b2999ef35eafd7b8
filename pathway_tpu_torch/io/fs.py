"""Filesystem connector (reference: ``python/pathway/io/fs`` over the Rust
``posix_like.rs`` + ``scanner/filesystem.rs`` readers and ``FileWriter``).

``mode="static"`` reads matching files once; ``mode="streaming"`` polls the glob for
new/changed files from a connector thread, emitting rows as they appear (object
deletions are detected and retracted, mirroring the reference's metadata trackers).

Carried from ``pathway_tpu/io/fs.py``. A reader's and a writer's
``service_class`` scope the flow plane (``pathway_tpu_torch/flow``); under
the elasticity plane a sharded sink's stale parts from another worker count
are removed. ``delivery="exactly_once"`` writes
through the delivery ledger (``pathway_tpu_torch/delivery``).
"""

from __future__ import annotations

import csv as _csv
import glob as _glob
import json as _json
import os
import threading
import time as _time
from typing import Any

import numpy as np

from pathway_tpu_torch.engine import operators as ops
from pathway_tpu_torch.engine.blocks import DeltaBatch
from pathway_tpu_torch.engine.graph import Node
from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals.keys import row_keys, sequential_keys
from pathway_tpu_torch.internals.logical import LogicalNode
from pathway_tpu_torch.internals.table import Table, table_from_static_data


def _list_files(path: str) -> list[str]:
    if os.path.isdir(path):
        out = []
        for root, _dirs, files in os.walk(path):
            out.extend(os.path.join(root, f) for f in sorted(files))
        return sorted(out)
    return sorted(_glob.glob(path))


def _parse_file(
    fpath: str, fmt: str, schema: schema_mod.SchemaMetaclass, csv_settings: Any = None
) -> list[tuple]:
    from pathway_tpu_torch.io._format import rows_from_bytes

    with open(fpath, "rb") as f:
        return rows_from_bytes(f.read(), fmt, schema)


def _keys_for(
    rows: list[tuple], schema: schema_mod.SchemaMetaclass, salt: int
) -> list[int]:
    pks = schema.primary_key_columns()
    cols = schema.column_names()
    if pks:
        arrays = []
        for pk in pks:
            i = cols.index(pk)
            a = np.empty(len(rows), dtype=object)
            a[:] = [r[i] for r in rows]
            arrays.append(a)
        return [int(k) for k in row_keys(arrays, n=len(rows))]
    return [int(k) for k in sequential_keys(0, len(rows), salt=salt)]


def read(
    path: str,
    *,
    format: str = "csv",  # noqa: A002
    schema: schema_mod.SchemaMetaclass | None = None,
    mode: str = "streaming",
    csv_settings: Any = None,
    autocommit_duration_ms: int | None = None,
    with_metadata: bool = False,
    name: str | None = None,
    service_class: str = "bulk",
    **kwargs: Any,
) -> Table:
    if schema is None:
        if format in ("plaintext", "plaintext_by_file"):
            schema = schema_mod.schema_from_types(data=str)
        elif format == "binary":
            schema = schema_mod.schema_from_types(data=bytes)
        else:
            raise ValueError("schema required for csv/json formats")
    base_schema = schema  # parse with the DATA columns only; the _metadata
    # column is appended afterwards (parsing with the merged schema would bind
    # a placeholder parsed from the payload instead of the real metadata)
    if with_metadata:
        schema = schema | schema_mod.schema_from_types(_metadata=dict)

    if mode == "static":
        all_rows: list[tuple] = []
        for fpath in _list_files(path):
            rows = _parse_file(fpath, format, base_schema, csv_settings)
            if with_metadata:
                rows = [r + (_metadata_for(fpath),) for r in rows]
            all_rows.extend(rows)
        keys = _keys_for(all_rows, schema, salt=hash(path) & 0xFFFF)
        return table_from_static_data(keys, all_rows, schema)

    # streaming: poll directory from a connector thread
    from pathway_tpu_torch.io.python import ConnectorSubject, read as py_read

    class _FsSubject(ConnectorSubject):
        def __init__(self) -> None:
            super().__init__()
            self._seen: dict[str, float] = {}
            self._stop = False
            self._bounded = kwargs.get("_bounded", False)

        def run(self) -> None:
            while not self._stop:
                found = False
                for fpath in _list_files(path):
                    mtime = os.path.getmtime(fpath)
                    if self._seen.get(fpath) == mtime:
                        continue
                    self._seen[fpath] = mtime
                    found = True
                    for r in _parse_file(fpath, format, base_schema, csv_settings):
                        if with_metadata:
                            r = r + (_metadata_for(fpath),)
                        self.next(**dict(zip(schema.column_names(), r)))
                if self._bounded and not found:
                    return
                _time.sleep(0.05)

        def on_stop(self) -> None:
            self._stop = True

    # directory ingestion is the canonical backfill workload: default to the
    # flow plane's bulk class so interactive query streams overtake a document
    # re-scan at tick granularity (pass service_class="interactive" to opt out)
    return py_read(
        _FsSubject(),
        schema=schema,
        name=name or f"fs:{path}",
        service_class=service_class,
    )


def _metadata_for(fpath: str) -> Any:
    from pathway_tpu_torch.internals.json import Json

    st = os.stat(fpath)
    return Json(
        {
            "path": os.path.abspath(fpath),
            "size": st.st_size,
            "modified_at": int(st.st_mtime),
            "seen_at": int(_time.time()),
        }
    )


def write(
    table: Table,
    filename: str,
    *,
    format: str = "csv",  # noqa: A002
    sharded: bool = False,
    service_class: str = "interactive",
    delivery: str | None = None,
    **kwargs: Any,
) -> None:
    """Append output diffs to a file with time/diff columns (reference FileWriter +
    DsvFormatter/JsonLinesFormatter semantics).

    ``sharded=True``: every worker writes its own key-shard's rows to
    ``filename.part-<w>``; when the last shard closes, the parts merge-commit
    into ``filename`` ordered by logical time (ties broken by worker index) and
    the parts are removed. Under a multi-process cluster the parts remain on
    disk per process (no cross-process close ordering) — consume them as a
    part-file set, Spark-style.

    ``service_class="bulk"`` excludes this writer's end-to-end latency from
    the flow plane's SLO (an fsync-bound audit mirror must not drag the AIMD
    microbatch bucket down).

    ``delivery="exactly_once"`` re-expresses the writer over the delivery
    ledger: formatted lines stage durably per epoch and append to the file
    only at operator-snapshot recovery points, guarded by the
    ``<filename>.delivery`` offset sidecar (truncate-to-offset on re-publish)
    — the file's bytes are identical across SIGKILL/restart. Not combinable
    with ``sharded=True`` (the ledger funnels through the SOLO sink path)."""
    from pathway_tpu_torch.flow import validate_service_class

    service_class = validate_service_class(service_class)
    from pathway_tpu_torch import delivery as _delivery

    if _delivery.resolve_mode(delivery) == "exactly_once":
        if sharded:
            raise ValueError(
                "fs.write: delivery='exactly_once' routes every row through "
                "the SOLO delivery ledger and cannot be combined with "
                "sharded=True"
            )
        return _write_ledger(
            table, filename, format=format, service_class=service_class
        )
    if sharded:
        return _write_sharded(
            table, filename, format=format, service_class=service_class, **kwargs
        )
    parent = os.path.dirname(os.path.abspath(filename))
    if not os.path.isdir(parent):
        # fail at graph build like the eager-open era did, not mid-run
        raise FileNotFoundError(f"fs.write: output directory does not exist: {parent}")
    cols = table.column_names()
    line_fn, header = _row_formatter(format, cols)
    lock = threading.Lock()
    # LAZY open (exactly-once): opening "w" at graph build would truncate
    # a previous run's output BEFORE the persistence layer can restore the
    # snapshot write position; the handle opens on first write — or in
    # restore_sink, which rewinds the existing file to the snapshot cut
    state: dict[str, Any] = {"fh": None, "final_offset": None}

    def _ensure_open():
        if state["fh"] is None:
            fh = open(filename, "w", newline="")
            if header is not None:
                fh.write(header)
            state["fh"] = fh
        return state["fh"]

    def on_batch(batch: DeltaBatch, columns: list[str]) -> None:
        with lock:
            fh = _ensure_open()
            for _key, diff, row in batch.rows():
                fh.write(line_fn(row, batch.time, diff))
            fh.flush()

    def on_done() -> None:
        # on_end fires on the owning (worker-0) replica only
        with lock:
            fh = _ensure_open()  # a zero-row run still yields the (header) file
            if not fh.closed:
                fh.flush()
                # the at-close snapshot runs AFTER on_end: remember the final
                # position so sink_state doesn't report "nothing written" and
                # doom the next restart to truncating the completed output
                state["final_offset"] = fh.tell()
                fh.close()

    def sink_state() -> dict:
        """Durable write position at a quiesced tick boundary — snapshotted
        with the operator generation so restart rewinds to a consistent cut."""
        with lock:
            fh = state["fh"]
            if fh is None or fh.closed:
                return {"offset": state["final_offset"]}
            fh.flush()
            return {"offset": fh.tell()}

    def restore_sink(s: dict) -> None:
        with lock:
            if state["fh"] is not None:
                return  # already restored (other worker replicas share state)
            off = s.get("offset")
            if off is None or not os.path.exists(filename):
                return  # nothing had been written at the snapshot: fresh file
            size = os.path.getsize(filename)
            if off > size:
                # the snapshot says `off` bytes were durably written but the
                # file is shorter: it was externally truncated/replaced, and
                # the consumed input prefix is already compacted — recovery
                # cannot reconstruct it, so fail loudly instead of silently
                # NUL-padding a corrupt output
                raise RuntimeError(
                    f"fs.write exactly-once restore: {filename!r} is {size} "
                    f"bytes but the snapshot recorded {off}; the output file "
                    "was modified outside the pipeline — remove it and the "
                    "persistence storage to start fresh"
                )
            fh = open(filename, "r+", newline="")
            fh.truncate(off)
            fh.seek(off)
            state["fh"] = fh

    def factory() -> Node:
        from pathway_tpu_torch.internals.logical import current_build

        ctx = current_build()
        # only global worker 0's replica owns the handle: a SOLO sink routes
        # every row there, and peer replicas (other workers/processes) must
        # not create-or-truncate the file from their own on_end
        owner = ctx is None or ctx.worker_index == 0
        return ops.CallbackOutputNode(
            cols,
            on_batch,
            on_done if owner else None,
            sink_state=sink_state if owner else None,
            restore_sink=restore_sink if owner else None,
            service_class=service_class,
        )

    LogicalNode(factory, [table._node], name=f"fs_write:{filename}")._register_as_output()


def _write_ledger(
    table: Table,
    filename: str,
    *,
    format: str,  # noqa: A002
    service_class: str = "interactive",
) -> None:
    """The fs sink re-expressed over the delivery ledger API: rows buffer as
    formatted lines, stage per epoch, and the FsDeliveryTransport appends them
    behind the offset sidecar at recovery points."""
    from pathway_tpu_torch import delivery as _delivery

    parent = os.path.dirname(os.path.abspath(filename))
    if not os.path.isdir(parent):
        raise FileNotFoundError(f"fs.write: output directory does not exist: {parent}")
    cols = table.column_names()
    line_fn, header = _row_formatter(format, cols)
    transport = _delivery.FsDeliveryTransport(filename, header=header)
    writer = _delivery.LedgerWriter(f"fs.{filename}", transport)

    def on_batch(batch: DeltaBatch, columns: list[str]) -> None:
        for _key, diff, row in batch.rows():
            writer.append(0, line_fn(row, batch.time, diff))

    def factory() -> Node:
        node = ops.CallbackOutputNode(
            cols,
            on_batch,
            sink_state=writer.sink_state,
            restore_sink=writer.restore_sink,
            service_class=service_class,
        )
        node.delivery_writer = writer
        return node

    LogicalNode(factory, [table._node], name=f"fs_write:{filename}")._register_as_output()


def _row_formatter(format: str, cols: list[str]):  # noqa: A002
    """line(row, time, diff) -> str, shared by the solo and sharded writers."""
    if format == "csv":
        import io as _io

        def line(row, time, diff) -> str:
            buf = _io.StringIO()
            _csv.writer(buf).writerow(list(row) + [time, diff])
            return buf.getvalue()

        hbuf = _io.StringIO()
        _csv.writer(hbuf).writerow(cols + ["time", "diff"])
        return line, hbuf.getvalue()
    if format in ("json", "jsonlines"):
        from pathway_tpu_torch.internals.json import Json

        def line(row, time, diff) -> str:
            rec = {}
            for c, v in zip(cols, row):
                if isinstance(v, Json):
                    v = v.value
                elif isinstance(v, np.generic):
                    v = v.item()
                elif isinstance(v, tuple):
                    v = list(v)
                rec[c] = v
            rec["time"] = time
            rec["diff"] = diff
            return _json.dumps(rec) + "\n"

        return line, None
    raise ValueError(f"unknown format {format!r}")


def _write_sharded(
    table: Table,
    filename: str,
    *,
    format: str,  # noqa: A002
    service_class: str = "interactive",
    **kwargs: Any,
) -> None:
    """Per-worker sink shards + ordered merge-commit.

    Persistence: part files get the same
    lazy-open + per-part offset snapshot/restore hooks as the solo writer —
    each worker's replica snapshots ITS part's durable offset with the
    operator generation and a restart rewinds that part to the cut, so a
    kill mid-stream can no longer truncate previously-committed part rows.
    A restart AFTER the parts merge-committed (parts deleted) restores a
    ``merged`` marker instead: re-appending to a merged output is
    unsupported and raises a clear error rather than corrupting it."""
    import heapq

    cols = table.column_names()
    line_fn, header = _row_formatter(format, cols)
    lock = threading.Lock()
    state: dict[str, Any] = {
        "parts": {},
        "closed": set(),
        "n_workers": 1,
        "merged_done": False,
        "restored_merged": False,
    }

    def _merge() -> None:
        """All shards closed: merge parts into ``filename`` ordered by
        (time, worker), then remove them. Parts are time-ordered internally
        (ticks are monotonic), so a k-way stable merge suffices."""

        def part_rows(w: int, path: str):
            if format == "csv":
                # csv.reader handles quoted embedded newlines (a raw line scan
                # would split multi-physical-line records); re-serialize each
                # record so the merged file stays one valid csv stream
                import io as _io

                with open(path, newline="") as fh:
                    for i, rec in enumerate(_csv.reader(fh)):
                        if i == 0 or not rec:
                            continue  # per-part header
                        buf = _io.StringIO()
                        _csv.writer(buf).writerow(rec)
                        yield (int(rec[len(cols)]), w, buf.getvalue())
            else:
                with open(path) as fh:
                    for raw in fh:
                        if not raw.strip():
                            continue
                        yield (int(_json.loads(raw)["time"]), w, raw)

        parts = sorted(state["parts"].items())
        with open(filename, "w", newline="") as out:
            if header is not None:
                out.write(header)
            for _t, _w, raw in heapq.merge(
                *(part_rows(w, p) for w, p in parts), key=lambda r: (r[0], r[1])
            ):
                out.write(raw)
        for _w, p in parts:
            os.remove(p)

    def _check_stale_parts(n: int) -> None:
        """Part files from a previous run under a DIFFERENT worker count:
        ``part-<w>`` for w outside the current worker set would silently
        survive as stale output next to the live parts. Formatted part rows
        carry no keys, so remapping them by key range is impossible from the
        files alone — with the elasticity plane enabled the stale parts are
        removed (every row regenerates from the replayed input logs,
        re-routed by the new shard map); otherwise fail with a clear error
        naming the mismatch."""
        import glob as _glob

        stale = []
        # escape the sink path: a filename with glob metacharacters must not
        # silently disable the detection this guard exists for
        for p in _glob.glob(_glob.escape(filename) + ".part-*"):
            suffix = p.rsplit(".part-", 1)[1]
            if suffix.isdigit() and int(suffix) >= n:
                stale.append(p)
        if not stale:
            return
        from pathway_tpu_torch import elastic as _elastic
        from pathway_tpu_torch.internals.telemetry import record_event

        if _elastic.reshard_enabled():
            for p in stale:
                try:
                    os.remove(p)
                except FileNotFoundError:
                    pass  # another cluster process won the race
            record_event("elastic.sink_parts_remapped", sink=filename, removed=len(stale), n_workers=n)
            return
        old_n = max(int(p.rsplit(".part-", 1)[1]) for p in stale) + 1
        raise RuntimeError(
            f"fs.write(sharded=True) restore: found part file(s) "
            f"{sorted(os.path.basename(p) for p in stale)} from a run with "
            f"at least {old_n} workers, but this run has {n}; part rows "
            "carry no keys so they cannot be remapped by key range — "
            "restart with the original worker count, remove the stale parts "
            "and the persistence storage, or enable PATHWAY_ELASTIC to "
            "rebuild every part from the replayed input logs"
        )

    def factory() -> Node:
        from pathway_tpu_torch.internals.logical import current_build

        ctx = current_build()
        w = ctx.worker_index if ctx is not None else 0
        n = ctx.n_workers if ctx is not None else 1
        part_path = f"{filename}.part-{w:04d}"
        with lock:
            state["parts"][w] = part_path
            state["n_workers"] = max(state["n_workers"], n)
            if not state.get("stale_checked"):
                state["stale_checked"] = True
                _check_stale_parts(n)
        # LAZY open (same rule as the solo writer): opening "w" at graph build
        # would truncate a previous run's part BEFORE restore_sink can rewind
        # it to the snapshot cut
        pstate: dict[str, Any] = {"fh": None, "final_offset": None}

        def _ensure_open():
            if pstate["fh"] is None:
                if state["restored_merged"]:
                    raise RuntimeError(
                        f"fs.write(sharded=True) restore: {filename!r} was "
                        "already merge-committed by the previous run; "
                        "appending new rows to a merged output is not "
                        "supported — remove the output file and the "
                        "persistence storage to start fresh"
                    )
                fh = open(part_path, "w", newline="")
                if header is not None:
                    fh.write(header)
                pstate["fh"] = fh
            return pstate["fh"]

        def on_batch(batch: DeltaBatch, columns: list[str]) -> None:
            fh = _ensure_open()
            for _key, diff, row in batch.rows():
                fh.write(line_fn(row, batch.time, diff))
            fh.flush()

        def sink_state() -> dict:
            """This part's durable offset at a quiesced tick boundary (or the
            merged marker once the parts were merge-committed)."""
            with lock:
                if state["merged_done"] or state["restored_merged"]:
                    return {"merged": True}
                fh = pstate["fh"]
                if fh is None or fh.closed:
                    return {"offset": pstate["final_offset"]}
                fh.flush()
                return {"offset": fh.tell()}

        def restore_sink(s: dict) -> None:
            with lock:
                if s.get("merged"):
                    state["restored_merged"] = True
                    return
                if pstate["fh"] is not None:
                    return
                off = s.get("offset")
                if off is None:
                    return  # nothing durably written at the snapshot: fresh part
                if not os.path.exists(part_path):
                    # the snapshot says this part held `off` bytes but the part
                    # is gone — parts are only ever removed by _merge(), so a
                    # crash landed between the merge-commit and the at-close
                    # snapshot. The merged output IS the completed run; treat
                    # it as merged (appending later raises the clear error)
                    # rather than silently re-merging only the replayed tail
                    # over it. A missing merged file too means outside
                    # interference — refuse.
                    if os.path.exists(filename):
                        state["restored_merged"] = True
                        return
                    raise RuntimeError(
                        f"fs.write(sharded=True) restore: {part_path!r} is "
                        f"missing but the snapshot recorded {off} bytes and "
                        f"no merged output {filename!r} exists; the files "
                        "were removed outside the pipeline — clear the "
                        "persistence storage to start fresh"
                    )
                size = os.path.getsize(part_path)
                if off > size:
                    raise RuntimeError(
                        f"fs.write(sharded=True) restore: {part_path!r} is "
                        f"{size} bytes but the snapshot recorded {off}; the "
                        "part file was modified outside the pipeline — remove "
                        "it and the persistence storage to start fresh"
                    )
                fh = open(part_path, "r+", newline="")
                fh.truncate(off)
                fh.seek(off)
                pstate["fh"] = fh

        def on_done() -> None:
            with lock:
                if state["restored_merged"]:
                    # previous run completed and merged; nothing new arrived
                    # (a write would have raised in _ensure_open)
                    state["closed"].add(w)
                    return
            fh = _ensure_open()  # a zero-row shard still yields a (header) part
            with lock:
                if not fh.closed:
                    fh.flush()
                    pstate["final_offset"] = fh.tell()
                    fh.close()
                state["closed"].add(w)
                # thread plane: the last shard to close merge-commits; a
                # cluster process only ever sees its local shards and leaves
                # the part files for the consumer
                if (
                    len(state["closed"]) == state["n_workers"]
                    and len(state["parts"]) == state["n_workers"]
                ):
                    _merge()
                    state["merged_done"] = True

        return ops.CallbackOutputNode(
            cols,
            on_batch,
            on_done,
            sharded=True,
            sink_state=sink_state,
            restore_sink=restore_sink,
            service_class=service_class,
        )

    LogicalNode(factory, [table._node], name=f"fs_write:{filename}")._register_as_output()
