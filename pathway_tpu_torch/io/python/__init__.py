"""Python connector: ``pw.io.python.read`` + ``ConnectorSubject``.

Mirrors the reference's ``python/pathway/io/python/__init__.py:47``
(``ConnectorSubject``: a user thread pushing rows through a queue into the engine —
Rust side ``PythonReader`` at ``src/connectors/data_storage.rs:927``). Here the
subject pushes directly into a ``StreamInputNode``; the run loop stamps whatever
arrived between autocommit ticks with the next logical time.
"""

from __future__ import annotations

import json as _json
import threading
from typing import Any

import numpy as np

from pathway_tpu_torch.engine import operators as ops
from pathway_tpu_torch.engine.graph import Node
from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals.keys import row_keys, sequential_keys
from pathway_tpu_torch.internals.later_slice import arrival_order
from pathway_tpu_torch.internals.logical import LogicalNode
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.internals.universe import Universe


class ConnectorSubject:
    """Subclass and implement ``run()`` calling ``self.next(**kwargs)``."""

    def __init__(self, datasource_name: str = "python"):
        self._node: ops.StreamInputNode | None = None
        self._columns: list[str] = []
        self._pk_cols: list[str] | None = None
        self._seq = 0
        self._closed = False
        self._started = threading.Event()

    # ---- user API ----
    def run(self) -> None:
        raise NotImplementedError

    def next(self, **kwargs: Any) -> None:
        values = tuple(kwargs.get(c) for c in self._columns)
        self._push(values, diff=1)

    def next_json(self, data: dict) -> None:
        self.next(**data)

    def next_batch(self, rows: list[dict]) -> None:
        """Microbatch ingestion: one lock acquisition and vectorized key
        generation for a whole block of rows — the block-first counterpart of
        per-row ``next`` (which hashes and locks per event). Keys are
        bit-identical to calling ``next`` row by row."""
        if not rows:
            return
        values = [tuple(r.get(c) for c in self._columns) for r in rows]
        keys = self._keys_for(values)
        assert self._node is not None, "subject not attached to a running graph"
        self._node.push_many(
            (int(k), v, 1) for k, v in zip(keys, values)
        )

    def next_str(self, line: str) -> None:
        self.next(data=line)

    def next_bytes(self, data: bytes) -> None:
        self.next(data=data)

    def commit(self) -> None:
        pass  # ticks auto-commit; kept for API parity

    def close(self) -> None:
        self._closed = True

    def on_stop(self) -> None:
        pass

    @property
    def _session_type(self) -> str:
        return "native"

    # ---- internals ----
    def _keys_for(self, values: list[tuple]) -> np.ndarray:
        """Row keys for a block of value tuples — the single source of the
        key-derivation recipe, shared by per-row ``next``/``_remove`` (n=1)
        and ``next_batch`` so the two stay bit-identical by construction."""
        n = len(values)
        if self._pk_cols:
            idx = [self._columns.index(c) for c in self._pk_cols]
            arrs = []
            for i in idx:
                a = np.empty(n, dtype=object)
                a[:] = [v[i] for v in values]
                arrs.append(a)
            return row_keys(arrs, n=n)
        start = self._seq + 1
        self._seq += n
        return sequential_keys(start, n)

    def _key_of(self, values: tuple) -> int:
        return int(self._keys_for([values])[0])

    def _push(self, values: tuple, diff: int) -> None:
        assert self._node is not None, "subject not attached to a running graph"
        self._node.push(self._key_of(values), values, diff)

    def _remove(self, **kwargs: Any) -> None:
        if not self._pk_cols:
            raise RuntimeError("_remove requires a schema with primary keys")
        values = tuple(kwargs.get(c) for c in self._columns)
        self._node.push(self._key_of(values), values, -1)


class _SubjectDriver:
    """Runs the subject's ``run()`` in a thread (reference: connector thread per
    input, ``src/connectors/mod.rs:91``). A subject exception is captured and
    surfaced by the runtime's main loop (the reference's ErrorReporter channel,
    SURVEY §5.3) instead of dying silently with the thread."""

    virtual = False

    def __init__(self, subject: ConnectorSubject):
        self.subject = subject
        self.thread: threading.Thread | None = None
        self.error: BaseException | None = None
        self._error_pre_stop = False
        self._stopped = False

    def start(self) -> None:
        def target() -> None:
            try:
                self.subject.run()
            except BaseException as e:  # noqa: BLE001 — transported to the run loop
                self._error_pre_stop = not self._stopped
                self.error = e
            finally:
                self.subject.close()

        self.thread = threading.Thread(target=target, daemon=True)
        self.thread.start()

    def failure(self) -> BaseException | None:
        # errors raised after a requested stop (e.g. a socket torn down
        # mid-read) are shutdown noise, not pipeline failures; errors raised
        # before the stop stay visible even once stop() runs in the finally
        # block, so the run loop's post-loop check can still surface them
        return self.error if self._error_pre_stop else None

    def is_finished(self) -> bool:
        node = self.subject._node
        return (
            self.subject._closed
            and (self.thread is None or not self.thread.is_alive())
            and (node is None or not node._pending)
        )

    def stop(self) -> None:
        self._stopped = True
        self.subject.on_stop()


class _StaticStreamSubject(ConnectorSubject):
    """Deterministic timed fixture: events = [(time, key, values, diff)].

    Plays the role of the reference's ``pw.debug.StreamGenerator``
    (``debug/__init__.py:508``): exact logical times, no real threads.
    """

    def __init__(self, events: list[tuple[int, int, tuple, int]], columns: list[str]):
        super().__init__()
        self.events = events
        self._columns = columns

    def run(self) -> None:
        pass


class _TimedInputNode(ops.StreamInputNode):
    """Input node emitting pre-timed events when the tick reaches their time.

    Fast path (r5, incremental-engine throughput): the whole fixture
    columnarizes ONCE (numpy key/diff/time arrays + typed value columns) and
    every tick emits an array slice — no per-event Python in the run loop.
    When persistence hooks the node's push functions (input logging), the
    per-event push path is kept so the log sees every event.
"""

    def __init__(self, events, columns, np_dtypes, upsert=False, arrays=None):
        super().__init__(columns, np_dtypes, upsert=upsert)
        self.events = events  # sorted by time
        self.idx = 0
        self._times: np.ndarray | None = None
        if arrays is not None:  # pre-columnarized at fixture construction
            self._times, self._keys_arr, self._diffs_arr, self._data_arrs = arrays

    @staticmethod
    def columnarize(events, columns, np_dtypes) -> tuple:
        """(times, keys, diffs, data) arrays for a sorted event list — done
        once at fixture construction so no per-event Python (or fromiter
        pass) runs inside the measured engine loop."""
        from pathway_tpu_torch.engine.blocks import make_column

        n = len(events)
        times = np.fromiter((e[0] for e in events), np.int64, count=n)
        keys = np.fromiter((e[1] for e in events), np.uint64, count=n)
        diffs = np.fromiter((e[3] for e in events), np.int64, count=n)
        rows = [e[2] for e in events]
        data = {
            c: make_column([r[j] for r in rows], np_dtypes.get(c, np.dtype(object)))
            for j, c in enumerate(columns)
        }
        return times, keys, diffs, data

    def _materialize(self) -> None:
        self._times, self._keys_arr, self._diffs_arr, self._data_arrs = (
            self.columnarize(self.events, self.columns, self.np_dtypes)
        )

    def _hooked(self) -> bool:
        # persistence replaces push/push_many with logging wrappers as
        # INSTANCE attributes; their presence forces the per-event path
        return "push" in self.__dict__ or "push_many" in self.__dict__

    def poll(self, time: int):
        from pathway_tpu_torch.engine.blocks import DeltaBatch, net_input_batch
        from pathway_tpu_torch.engine.graph import END_OF_STREAM

        if self.upsert or self._hooked():
            emit_until = self.idx
            while emit_until < len(self.events) and (
                self.events[emit_until][0] <= time or time == END_OF_STREAM
            ):
                emit_until += 1
            if emit_until == self.idx:
                return super().poll(time)
            # one lock + extend for the whole tick's slice, not a lock per event
            self.push_many(
                (key, values, diff)
                for (_t, key, values, diff) in self.events[self.idx : emit_until]
            )
            self.idx = emit_until
            return super().poll(time)

        if time == END_OF_STREAM:
            # parity with StreamInputNode: the close tick emits nothing
            # (drivers hold the run open until every event was emitted)
            return super().poll(time)
        if self._times is None:
            self._materialize()
        emit_until = int(np.searchsorted(self._times, time, side="right"))
        if emit_until <= self.idx:
            return super().poll(time)  # drains stray pushes (none normally)
        sl = slice(self.idx, emit_until)
        # copies, not views: the columnarized fixture arrays are shared across
        # every worker's build and across successive pw.run calls on the same
        # fixture — a downstream in-place mutation of a view would corrupt the
        # fixture for other workers/runs
        # watermark probes (the per-row push path stamps these in push();
        # this columnarized fast lane must stamp them itself)
        import time as _t

        now_ns = _t.time_ns()
        self.wm_rows += emit_until - sl.start
        self.wm_ingest_ns = now_ns
        if self.event_time_index is not None:
            col = self._data_arrs[self.columns[self.event_time_index]][sl]
            try:
                et = float(max(col))
                if self.wm_event_time is None or et > self.wm_event_time:
                    self.wm_event_time = et
            except (TypeError, ValueError):
                pass
        from pathway_tpu_torch.observability.metrics import run_metrics

        run_metrics().note_tick_ingest(time, now_ns)
        batch = DeltaBatch(
            self._keys_arr[sl].copy(),
            self._diffs_arr[sl].copy(),
            {c: a[sl].copy() for c, a in self._data_arrs.items()},
            time,
        )
        self.idx = emit_until
        self.polled_total += emit_until - sl.start
        return [net_input_batch(batch)]

    @property
    def max_time(self) -> int:
        return self.events[-1][0] if self.events else 0


class _TimedDriver:
    virtual = True

    def __init__(self, node_holder: dict):
        self.holder = node_holder

    def start(self) -> None:
        pass

    def is_finished(self) -> bool:
        node = self.holder.get("node")
        return node is not None and node.idx >= len(node.events) and not node._pending

    def stop(self) -> None:
        pass


def read(
    subject: ConnectorSubject,
    *,
    schema: schema_mod.SchemaMetaclass,
    autocommit_duration_ms: int | None = None,
    name: str | None = None,
    event_time_column: str | None = None,
    service_class: str = "interactive",
    **kwargs: Any,
) -> Table:
    # service_class scopes the flow plane (not ported yet)
    arrival_order(service_class)
    columns = schema.column_names()
    np_dtypes = schema.np_dtypes()
    subject._columns = columns
    subject._pk_cols = schema.primary_key_columns()
    # observability: the named column drives this input's EVENT-TIME watermark
    # (``/metrics`` pathway_input_watermark, the audit plane's watermark
    # monotonicity monitor; default is processing time)
    event_time_index = (
        columns.index(event_time_column) if event_time_column is not None else None
    )

    if isinstance(subject, _StaticStreamSubject):
        holder: dict[str, Any] = {}
        events = subject.events
        # columnarize once at fixture construction — runs re-using the fixture
        # (each _capture / pw.run builds fresh nodes) share the arrays
        arrays = _TimedInputNode.columnarize(events, columns, np_dtypes)

        def factory() -> Node:
            node = _TimedInputNode(events, columns, np_dtypes, arrays=arrays)
            node.event_time_index = event_time_index
            node.input_name = name or "stream_fixture"
            holder["node"] = node
            return node

        def hook(node: Node, runtime: Any) -> None:
            if runtime is not None:
                runtime.register_connector(_TimedDriver(holder))

        lnode = LogicalNode(factory, [], name=name or "stream_fixture", runtime_hook=hook)
        return Table(lnode, schema, Universe())

    def factory() -> Node:
        node = ops.StreamInputNode(
            columns, np_dtypes, upsert=subject._session_type == "upsert"
        )
        node.event_time_index = event_time_index
        # the watermark plane's label (``/status`` watermarks, ``/metrics``)
        node.input_name = name or getattr(subject, "datasource_name", None) or "python"
        subject._node = node
        return node

    def hook(node: Node, runtime: Any) -> None:
        if runtime is not None:
            runtime.register_connector(_SubjectDriver(subject))

    lnode = LogicalNode(factory, [], name=name or "python_connector", runtime_hook=hook)
    return Table(lnode, schema, Universe())


read_subject = read


def read_partitioned(
    make_subject,
    *,
    schema: schema_mod.SchemaMetaclass,
    autocommit_duration_ms: int | None = None,
    name: str | None = None,
    service_class: str = "interactive",
) -> Table:
    """Partition-per-worker ingest (reference: Kafka read partition-per-worker,
    ``worker-architecture.md:36-47``; r5 kills the worker-0 SOLO pin).

    ``make_subject(worker_index, n_workers) -> ConnectorSubject`` builds one
    subject per worker, each owning a disjoint slice of the source (e.g. Kafka
    partitions ``p % n_workers == worker_index``). Every worker's node polls
    locally (``local_source``); downstream co-location happens through the
    normal key exchange. Under a single-worker runtime this degenerates to
    ``read(make_subject(0, 1), ...)``.
    """
    from pathway_tpu_torch.internals.logical import current_build

    arrival_order(service_class)
    columns = schema.column_names()
    np_dtypes = schema.np_dtypes()

    def factory() -> Node:
        ctx = current_build()
        w = ctx.worker_index if ctx is not None else 0
        n = ctx.n_workers if ctx is not None else 1
        subject = make_subject(w, n)
        subject._columns = columns
        subject._pk_cols = schema.primary_key_columns()
        node = ops.StreamInputNode(
            columns, np_dtypes, upsert=subject._session_type == "upsert"
        )
        node.local_source = True  # poll on the owning worker, not worker 0
        node.source_worker = w
        subject._node = node
        if ctx is not None and ctx.register is not None:
            ctx.register(_SubjectDriver(subject))
        return node

    lnode = LogicalNode(factory, [], name=name or "python_connector_partitioned")
    return Table(lnode, schema, Universe())
