"""Engine operator nodes.

Block-oriented counterparts of the reference's dataflow operators
(``src/engine/dataflow.rs`` lowering of the ``Graph`` trait,
``src/engine/graph.rs:647-1015``): rowwise map/filter/reindex are stateless block
kernels; group-by keeps per-group accumulators (``reduce.rs`` styles); combine covers
update_rows/update_cells/restrict/intersect/difference/having; join is an incremental
symmetric hash join with outer-padding accounting; flatten explodes sequence columns.
All state lives keyed by uint64 row keys, diffs are ±weights.

Carried from ``pathway_tpu/engine/operators.py``, with the metrics plane's
ingest watermarks and sink-latency histograms and the live-tracing span around
a microbatch launch, the audit plane's sink digests and the lineage plane's
key edges and the flow plane's credit-gated ingest and AIMD launch cap.
The grouped aggregation routes through ``engine/torch_kernels.py``.
"""

from __future__ import annotations

import threading
import time as _time_mod
from collections import OrderedDict
from typing import Any, Callable, Iterable

import numpy as np

from pathway_tpu_torch.engine.blocks import (
    DeltaBatch,
    column_to_list,
    concat_batches,
    concat_cols,
    consolidate,
    group_starts,
    interleave_positions,
    make_column,
    merge_consolidated,
    net_input_batch,
    scatter_cols,
)
from pathway_tpu_torch.engine import torch_kernels
from pathway_tpu_torch.engine.colstore import ColumnarKeyedStore, ColumnarMultimap, SortedCounts
from pathway_tpu_torch.observability import audit as _audit
from pathway_tpu_torch.observability import engine_phases as _phases
from pathway_tpu_torch.observability import lineage as _lineage
from pathway_tpu_torch.engine.graph import END_OF_STREAM, SOLO, Node
from pathway_tpu_torch.engine.reducers_impl import ReducerImpl
from pathway_tpu_torch.internals.keys import combine_keys, row_keys, splitmix64

# ---------------------------------------------------------------------------- inputs


class StaticInputNode(Node):
    name = "static_input"

    snapshot_attrs = ("_emitted",)

    def exchange_key(self, port):
        return SOLO  # sources/sinks live on worker 0

    def __init__(self, batch_factory: Callable[[int], DeltaBatch]):
        super().__init__(n_inputs=0)
        self.batch_factory = batch_factory
        self._emitted = False

    def poll(self, time: int) -> list[DeltaBatch]:
        if self._emitted or time == END_OF_STREAM:
            return []
        self._emitted = True
        return [self.batch_factory(time)]


class StreamInputNode(Node):
    """Receives events from connector threads via a lock-protected queue.

    The engine-side half of the reference's connector loop
    (``src/connectors/mod.rs:91`` + ``adaptors.rs:20-47`` InputSession/UpsertSession):
    events accumulate between ticks; ``poll`` drains them as one delta block per tick.
    ``upsert=True`` gives UpsertSession semantics: a new row for an existing key
    retracts the previous one; value ``None`` deletes.
    """

    name = "stream_input"

    snapshot_attrs = ("_state",)

    #: flow plane opt-in: live connector queues are credit-gated when
    #: ``PATHWAY_FLOW=on``; deterministic timed fixtures opt out (they replay
    #: pre-timed events, not a live producer)
    flow_gated = True

    #: set (as an instance attribute) by the persistence input-log wrapper:
    #: its log captures events BEFORE the gate, so gating must stand down on
    #: that node (see ``_push_gated``)
    flow_ungated = False

    #: set (as an instance attribute) by serving connectors under the shard
    #: map (``PATHWAY_SHARDMAP=on``): every fabric door pushes requests into
    #: its OWN process's copy of this node, so exchange must route each row
    #: by its key instead of funnelling everything to global worker 0 —
    #: otherwise zero-hop admission would re-introduce the worker-0 hop.
    fabric_ingest = False

    def exchange_key(self, port):
        if self.fabric_ingest:
            return lambda batch: batch.keys  # zero-hop: stay on the owner
        return SOLO  # sources/sinks live on worker 0

    #: upsert state is keyed by engine key but PLACED by the connector's
    #: partition slice, which need not follow key ownership — a migration
    #: must scan every old worker's (small) upsert dict, not only the
    #: shard-map overlap set
    migrate_aligned = False

    def migrate_mode(self) -> str | None:
        # a non-partitioned source is only ever fed through global worker 0's
        # copy, so its whole upsert dict must stay there (positional); only
        # partition-fed or door-fed copies hold per-worker state worth a
        # keyed merge
        if getattr(self, "local_source", False) or self.fabric_ingest:
            return "keyed"
        return "solo"

    def migrate_restore(self, shards: list[dict], keep) -> dict | None:
        """Upsert-session memory (key → current row) re-owned by the NEW shard
        map so a later upsert/delete of a migrated key still finds the row to
        retract. Keys are engine keys, so the keep mask applies directly;
        non-upsert sources carry an empty dict and merge trivially."""
        merged: dict[int, tuple] = {}
        for s in shards:
            st = s.get("_state") or {}
            if not st:
                continue
            ks = np.fromiter(st.keys(), dtype=np.uint64, count=len(st))
            mask = keep(ks)
            for k, keepit in zip(st.keys(), mask):
                if keepit:
                    merged[k] = st[k]
        return {"_state": merged}

    def __init__(self, columns: list[str], np_dtypes: dict | None = None, upsert: bool = False):
        super().__init__(n_inputs=0)
        self.columns = columns
        self.np_dtypes = np_dtypes or {}
        self.upsert = upsert
        self._lock = threading.Lock()
        self._pending: list[tuple[int, tuple | None, int]] = []  # (key, values, diff)
        # flow control (``pathway_tpu_torch/flow``): the credit gate bounding this
        # queue, or None when the plane is off — push/poll pay one is-None test
        from pathway_tpu_torch import flow as _flow

        self.service_class = _flow.INTERACTIVE
        self.flow_gate = _flow.register_input(self)
        # shed-policy pairing memory: (key, values) -> count of SHED inserts,
        # so a later retract of a shed row is absorbed instead of reaching
        # the engine as an unpaired -1 (negative multiplicity). Bounded;
        # overflow falls back to the documented append-mostly caveat.
        self._shed_pairs: dict = {}
        self._state: dict[int, tuple] = {}  # upsert sessions remember current row
        # input events drained by poll() so far — the operator-snapshot offset:
        # state at a snapshot reflects exactly this many log events
        self.polled_total = 0
        # watermark probes (observability plane, read by
        # ``observability.metrics.input_watermarks``): ingest wall clock of
        # the newest event, oldest still-undrained event (feeds the per-tick
        # ingest stamp the sink latency histograms subtract), total rows, and
        # — when the connector declares an event-time column — the event-time
        # high-water mark
        self.wm_rows = 0
        self.wm_ingest_ns: int | None = None
        self.wm_oldest_pending_ns: int | None = None
        self.wm_event_time: float | None = None
        self.event_time_index: int | None = None
        self.input_name: str | None = None

    def _observe_event_time(self, values: tuple | None) -> None:
        idx = self.event_time_index
        if idx is None or values is None:
            return
        try:
            et = float(values[idx])
        except (TypeError, ValueError, IndexError):
            return
        if self.wm_event_time is None or et > self.wm_event_time:
            self.wm_event_time = et

    # called from connector threads
    def push(self, key: int, values: tuple | None, diff: int = 1) -> None:
        gate = self.flow_gate
        if gate is not None:
            self._push_gated([(int(key), values, diff)], gate)
            return
        now = _time_mod.time_ns()
        with self._lock:
            self._pending.append((int(key), values, diff))
            self.wm_rows += 1
            self.wm_ingest_ns = now
            if self.wm_oldest_pending_ns is None:
                self.wm_oldest_pending_ns = now
            self._observe_event_time(values)

    def push_many(self, events: Iterable[tuple[int, tuple | None, int]]) -> None:
        events = list(events)
        gate = self.flow_gate
        if gate is not None:
            self._push_gated(events, gate)
            return
        self._append_events(events)

    def _append_events(self, events: list[tuple[int, tuple | None, int]]) -> None:
        """One lock + extend for a block of events, with the watermark stamps
        the per-row push path maintains."""
        if not events:
            return
        now = _time_mod.time_ns()
        with self._lock:
            self._pending.extend(events)
            self.wm_rows += len(events)
            self.wm_ingest_ns = now
            if self.wm_oldest_pending_ns is None:
                self.wm_oldest_pending_ns = now
            if self.event_time_index is not None:
                for _k, values, _d in events:
                    self._observe_event_time(values)

    # ---- flow-gated ingest (PATHWAY_FLOW=on) ----
    def _push_gated(self, events: list, gate) -> None:
        """Credit-gated ingest: inserts acquire one credit per row (blocking
        the producer or shedding overflow per ``PATHWAY_FLOW_POLICY``); a
        retract whose insert is still queued cancels it in place and RETURNS
        the insert's credit — the pair never reaches the engine."""
        if self.flow_ungated:
            # the persistence input-log wrapper set this flag: its log
            # captures every event BEFORE it reaches this gate, so a shed or
            # cancelled event would exist in the durable log but never in
            # polled_total, corrupting the epoch offset arithmetic — and
            # blocking here can deadlock seekable sources, whose sync_lock
            # is held across push while the persistence flush wants it on
            # the tick path. Persisted inputs therefore bypass credit gating
            # (the input log already bounds replay; poll-side priority
            # budgets still apply, they only defer draining).
            self._append_events(events)
            return
        n = len(events)
        i = 0
        while i < n:
            ev = events[i]
            if ev[2] < 0 or ev[1] is None:
                # retracts — and upsert DELETE tombstones (values=None) — are
                # never shed: their insert is already in downstream state and
                # dropping the removal would leave a phantom row forever. A
                # retract whose insert was itself SHED is absorbed instead
                # (the engine must not see an unpaired -1); otherwise
                # admit_retract bypasses the shed overflow check.
                if (
                    not self._try_cancel_queued(ev, gate)
                    and not self._absorb_shed_retract(ev, gate)
                    and gate.admit_retract()
                ):
                    self._append_events([ev])
                i += 1
                continue
            j = i
            while j < n and events[j][2] >= 0 and events[j][1] is not None:
                j += 1
            while i < j:
                chunk = events[i : min(j, i + gate.chunk_rows())]
                take = gate.admit(len(chunk))
                if take:
                    self._append_events(chunk[:take])
                if take < len(chunk):
                    self._note_shed(chunk[take:])
                i += len(chunk)

    #: bounded size of the shed-pair memory; past it, retracts of shed rows
    #: fall back to the documented append-mostly shed caveat
    _SHED_PAIRS_MAX = 65536

    def _note_shed(self, dropped: list) -> None:
        """Remember shed inserts by (key, values) so their retracts can be
        absorbed later. Unhashable values (array payloads) are skipped."""
        pairs = self._shed_pairs
        for k, v, d in dropped:
            if len(pairs) >= self._SHED_PAIRS_MAX:
                return
            try:
                pk = (k, v)
                pairs[pk] = pairs.get(pk, 0) + d
            except TypeError:
                continue

    def _absorb_shed_retract(self, ev: tuple, gate) -> bool:
        """A retract whose matching insert was shed cancels against the
        shed-pair memory — counted as shed so produced == admitted + shed."""
        if ev[2] != -1 or not self._shed_pairs:
            return False
        try:
            pk = (ev[0], ev[1])
            count = self._shed_pairs.get(pk, 0)
        except TypeError:
            return False
        if count <= 0:
            return False
        if count == 1:
            del self._shed_pairs[pk]
        else:
            self._shed_pairs[pk] = count - 1
        gate.note_absorbed_retract()
        return True

    #: newest queued entries scanned for a retract-cancel match. The cancel is
    #: purely an optimization (an unmatched pair flows to the engine and nets
    #: out there), so capping the scan keeps retract-heavy streams off an
    #: O(retracts × queue-bound) cliff while still catching the common
    #: insert-then-immediately-retract pattern.
    _CANCEL_SCAN_WINDOW = 256

    def _try_cancel_queued(self, ev: tuple, gate) -> bool:
        """Cancel the newest still-queued insert matching a retract's key and
        values (bounded backward scan under the node lock). Multiset sessions
        only: in an upsert session the queued ``(k, v1, +1)`` is a REPLACE of
        the settled ``v0`` and its ``-1`` a delete — cancelling the pair would
        resurrect ``v0`` instead of deleting ``k``."""
        key, values, diff = ev
        if diff != -1 or self.upsert:
            return False
        with self._lock:
            floor = max(0, len(self._pending) - self._CANCEL_SCAN_WINDOW) - 1
            for idx in range(len(self._pending) - 1, floor, -1):
                k2, v2, d2 = self._pending[idx]
                if k2 != key or d2 != 1:
                    continue
                try:
                    match = v2 == values
                except Exception:
                    match = False
                if match:
                    del self._pending[idx]
                    break
            else:
                return False
        gate.cancel(1)
        return True

    def poll(self, time: int) -> list[DeltaBatch]:
        gate = self.flow_gate
        with self._lock:
            budget = gate.budget if gate is not None else None
            if (
                budget is not None
                and time != END_OF_STREAM
                and budget < len(self._pending)
            ):
                # priority admission: drain only this tick's budget. The
                # drained rows include the queue's oldest, so THIS tick's
                # ingest stamp is exact; the tail (strictly newer rows whose
                # exact arrival times aren't retained) re-stamps to now —
                # slightly understating tail age beats reusing the drained
                # stamp forever, which would grow every sink's measured
                # latency monotonically under sustained budgeted draining
                # and wedge the AIMD controller at full throttle
                pending = self._pending[:budget]
                self._pending = self._pending[budget:]
                oldest_ns = self.wm_oldest_pending_ns
                self.wm_oldest_pending_ns = _time_mod.time_ns()
            else:
                pending, self._pending = self._pending, []
                oldest_ns, self.wm_oldest_pending_ns = self.wm_oldest_pending_ns, None
        if gate is not None and pending and time != END_OF_STREAM:
            gate.on_drain(len(pending))
        if time == END_OF_STREAM:
            return []
        if pending and oldest_ns is not None:
            from pathway_tpu_torch.observability.metrics import run_metrics

            run_metrics().note_tick_ingest(time, oldest_ns)
        self.polled_total += len(pending)
        if not pending:
            return []
        if not self.upsert:
            # native sessions: one C-speed filter+transpose, no per-row loop
            if any(e[1] is None for e in pending):
                pending = [e for e in pending if e[1] is not None]
                if not pending:
                    return []
            keys, rows, diffs = map(list, zip(*pending))
            batch = DeltaBatch.from_rows(
                keys, rows, self.columns, time, diffs=diffs, np_dtypes=self.np_dtypes
            )
            return [net_input_batch(batch)]
        keys: list[int] = []
        diffs: list[int] = []
        rows: list[tuple] = []
        for key, values, diff in pending:
            if self.upsert:
                old = self._state.get(key)
                if old is not None:
                    keys.append(key)
                    diffs.append(-1)
                    rows.append(old)
                if values is not None and diff > 0:
                    keys.append(key)
                    diffs.append(1)
                    rows.append(values)
                    self._state[key] = values
                elif key in self._state:
                    del self._state[key]
            else:
                if values is None:
                    continue
                keys.append(key)
                diffs.append(diff)
                rows.append(values)
        if not keys:
            return []
        batch = DeltaBatch.from_rows(
            keys, rows, self.columns, time, diffs=diffs, np_dtypes=self.np_dtypes
        )
        return [net_input_batch(batch)]


# ---------------------------------------------------------------------------- rowwise


class RowwiseNode(Node):
    """select/with_columns: stateless block program.

    Stateless stages normally process where their input was produced (no
    exchange). A stage marked ``expensive`` (it runs python/numpy UDFs, e.g.
    embedders) instead exchanges by row key, spreading the per-row compute
    across workers — otherwise every UDF chained after a worker-0 source would
    serialize there."""

    name = "rowwise"

    def exchange_key(self, port):
        if self.expensive:
            return lambda batch: batch.keys
        return None  # stateless: process where produced

    def __init__(
        self,
        program: Callable[[DeltaBatch], dict[str, np.ndarray]],
        expensive: bool = False,
        exprs: dict | None = None,
    ):
        super().__init__(n_inputs=1)
        self.program = program
        self.expensive = expensive
        #: the named expression ASTs ``program`` was compiled from, when the
        #: builder has them — lets the chain-fusion pass compose consecutive
        #: rowwise stages into one block program / jitted kernel
        #: (``engine/fusion.py``); None keeps the node opaque (closure-only
        #: programs, e.g. iterate internals)
        self.exprs = exprs

    def process(self, inputs, time):
        batch = inputs[0]
        if batch is None:
            return []
        return [batch.with_data(self.program(batch))]


class FilterNode(Node):
    name = "filter"

    def exchange_key(self, port):
        return None  # stateless: process where produced

    def __init__(
        self, predicate: Callable[[DeltaBatch], np.ndarray], expr: Any = None
    ):
        super().__init__(n_inputs=1)
        self.predicate = predicate
        #: predicate AST for the chain-fusion pass (see RowwiseNode.exprs)
        self.expr = expr

    def process(self, inputs, time):
        batch = inputs[0]
        if batch is None:
            return []
        mask = self.predicate(batch)
        if mask.dtype != np.bool_:
            from pathway_tpu_torch.internals.errors import ERROR

            mask = np.fromiter(
                (v is not None and v is not ERROR and bool(v) for v in mask),
                dtype=bool,
                count=len(mask),
            )
        return [batch.take(np.flatnonzero(mask))]


class ReindexNode(Node):
    """with_id_from / groupby key derivation: new keys from a key program."""

    name = "reindex"

    def exchange_key(self, port):
        return None  # stateless: process where produced

    def __init__(self, key_program: Callable[[DeltaBatch], np.ndarray]):
        super().__init__(n_inputs=1)
        self.key_program = key_program

    def process(self, inputs, time):
        batch = inputs[0]
        if batch is None:
            return []
        new_keys = self.key_program(batch)
        lin = _lineage.current()
        if lin is not None:
            lin.record_edge(self, new_keys, batch.keys)
        return [batch.with_keys(new_keys)]


class SelectColumnsNode(Node):
    name = "select_columns"

    def exchange_key(self, port):
        return None  # stateless: process where produced

    def __init__(self, columns: list[str], rename: dict[str, str] | None = None):
        super().__init__(n_inputs=1)
        self.columns = columns
        self.rename = rename or {}

    def process(self, inputs, time):
        batch = inputs[0]
        if batch is None:
            return []
        data = {self.rename.get(c, c): batch.data[c] for c in self.columns}
        return [batch.with_data(data)]


class ConcatNode(Node):
    """Disjoint union (``concat``); with ``salts`` reindexes each side so ids
    cannot collide (``concat_reindex``)."""

    name = "concat"

    def exchange_key(self, port):
        return None  # stateless: process where produced

    def __init__(self, n_inputs: int, columns: list[str], salts: list[int] | None = None):
        super().__init__(n_inputs=n_inputs)
        self.columns = columns
        self.salts = salts

    def process(self, inputs, time):
        out = []
        for port, batch in enumerate(inputs):
            if batch is None:
                continue
            batch = batch.select_columns(self.columns)
            if self.salts is not None:
                new_keys = splitmix64(batch.keys ^ np.uint64(self.salts[port]))
                lin = _lineage.current()
                if lin is not None:
                    lin.record_edge(self, new_keys, batch.keys)
                batch = batch.with_keys(new_keys)
            out.append(batch)
        return out


class FlattenNode(Node):
    """Explode a sequence column; output keys = hash(key, index)
    (reference: ``flatten_table``, ``src/engine/graph.rs``)."""

    name = "flatten"

    def exchange_key(self, port):
        return None  # stateless: process where produced

    def __init__(self, flatten_col: str, other_cols: list[str]):
        super().__init__(n_inputs=1)
        self.flatten_col = flatten_col
        self.other_cols = other_cols

    def process(self, inputs, time):
        batch = inputs[0]
        if batch is None:
            return []
        keys_out: list[int] = []
        diffs_out: list[int] = []
        flat_vals: list[Any] = []
        other_idx: list[int] = []
        col = batch.data[self.flatten_col]
        for i in range(len(batch)):
            seq = col[i]
            if seq is None:
                continue
            if isinstance(seq, np.ndarray):
                items = list(seq)
            elif isinstance(seq, (tuple, list, str, bytes)):
                items = list(seq)
            else:
                from pathway_tpu_torch.internals.json import Json

                items = list(seq.value) if isinstance(seq, Json) else list(seq)
            for j, item in enumerate(items):
                keys_out.append(int(combine_keys(
                    np.asarray([batch.keys[i]], dtype=np.uint64),
                    splitmix64(np.asarray([j], dtype=np.uint64)),
                )[0]))
                diffs_out.append(int(batch.diffs[i]))
                flat_vals.append(item)
                other_idx.append(i)
        data = {self.flatten_col: make_column(flat_vals, np.dtype(object))}
        idx = np.asarray(other_idx, dtype=np.int64)
        lin = _lineage.current()
        if lin is not None and len(idx):
            lin.record_edge(
                self, np.asarray(keys_out, dtype=np.uint64), batch.keys[idx]
            )
        for c in self.other_cols:
            data[c] = batch.data[c][idx]
        return [
            DeltaBatch(
                np.asarray(keys_out, dtype=np.uint64),
                np.asarray(diffs_out, dtype=np.int64),
                data,
                time,
            )
        ]


# ------------------------------------------------------------------- microbatch UDF


class MicrobatchUdfSpec:
    """One ``is_batched`` UDF column of a microbatched select: the compiled
    argument program plus the raw batch callable."""

    __slots__ = (
        "name", "args_program", "fn", "kw_names", "propagate_none",
        "min_bucket", "deterministic",
    )

    def __init__(
        self, name, args_program, fn, kw_names, propagate_none,
        min_bucket=8, deterministic=False,
    ):
        self.name = name
        #: batch -> (list of positional arg arrays, list of kwarg arrays)
        self.args_program = args_program
        self.fn = fn
        self.kw_names = kw_names
        self.propagate_none = propagate_none
        self.min_bucket = min_bucket
        self.deterministic = deterministic


def _launch_udf_batch(spec: MicrobatchUdfSpec, items: list) -> list:
    """Run one padded bucket through the UDF's batch fn. ``items`` are
    ``(args_tuple, kwargs_tuple)`` rows; a failing batch retries row by row so
    one bad input poisons only its own row (the inline BatchApply discipline,
    ``expression_vm._eval_batch_apply``)."""
    from pathway_tpu_torch.internals.errors import report_error

    args = [list(col) for col in zip(*(it[0] for it in items))]
    kwargs = {
        k: [it[1][j] for it in items] for j, k in enumerate(spec.kw_names)
    }
    try:
        results = spec.fn(*args, **kwargs)
        if len(results) != len(items):
            raise ValueError(
                f"batch UDF returned {len(results)} results for {len(items)} rows"
            )
        return list(results)
    except Exception:
        out = []
        # pad rows are the SAME object as the last real item (repeat-last
        # padding) — the identity cache computes each distinct row once, so
        # the error path never re-runs the bucket's padding copies
        cache: dict[int, Any] = {}
        for it in items:
            if id(it) in cache:
                out.append(cache[id(it)])
                continue
            try:
                r = spec.fn(
                    *[[v] for v in it[0]],
                    **{k: [it[1][j]] for j, k in enumerate(spec.kw_names)},
                )
                val = r[0]
            except Exception as e:
                val = report_error(
                    f"apply {getattr(spec.fn, '__name__', spec.fn)!s}: {e!r}"
                )
            cache[id(it)] = val
            out.append(val)
        return out


class MicrobatchApplyNode(Node):
    """Cross-tick accumulate-then-launch select for ``is_batched`` device UDFs.

    The wiring the framework's founding bet demands (PAPER.md, SURVEY §7.1.5):
    instead of one jitted call per delta block — a streaming tick of 64 rows
    dispatches a 64-row encoder call at a fraction of batch-512 device
    throughput — rows are buffered **across ticks** per UDF, padded to
    power-of-two buckets (``ops/microbatch.py``, compile-cache discipline) and
    launched once per bucket. Full ``max_batch`` chunks launch as soon as they
    accumulate; the tail flushes when the oldest buffered row ages past the
    autocommit deadline, so added latency is bounded by
    ``autocommit_duration_ms``. Static runs flush at their single tick's
    frontier and behave exactly like the inline path.

    ``mode="hold"`` (the measured default): buffered rows are invisible
    downstream until their batch completes, then appear at the flush tick —
    value-identical to per-block dispatch, timestamps may shift later.
    ``mode="pending"``: rows appear immediately with ``PENDING`` in the UDF
    columns and settle via a retract/insert correction on the completing tick —
    the ``Value::Pending`` future discipline; consume through
    ``Table.await_futures()``.

    Retraction semantics: a retract of a still-buffered key cancels in-buffer
    (the launch never sees it); a retract of a settled key replays the
    remembered output row, so nondeterministic UDFs retract exactly what they
    inserted. Output rows are remembered only while some UDF is NOT declared
    deterministic (the reference caches non-deterministic UDF results for the
    same reason); all-deterministic selects keep zero per-row state and
    recompute retract rows, exactly like the inline path.
    """

    name = "microbatch_select"

    snapshot_attrs = ("waiting", "emitted")

    #: replay-cache FIFO bound — sized past any in-flight serving window
    _RECENT_MAX = 8192

    def exchange_key(self, port):
        # device UDF rows spread across workers by key shard, same as an
        # expensive RowwiseNode — each worker accumulates and launches its shard
        return lambda batch: batch.keys

    def __init__(
        self,
        out_columns: list[str],
        pass_names: list[str],
        pre_program: Callable[[DeltaBatch], dict[str, np.ndarray]],
        udf_specs: list[MicrobatchUdfSpec],
        np_dtypes: dict | None = None,
        mode: str = "hold",
        max_batch: int = 512,
        flush_ms: float | None = None,
        runtime: Any = None,
    ):
        super().__init__(n_inputs=1)
        self.out_columns = out_columns
        self.pass_names = pass_names
        self.pre_program = pre_program
        self.udf_specs = udf_specs
        self.np_dtypes = np_dtypes or {}
        self.mode = mode
        self.max_batch = max_batch
        self.flush_ms = flush_ms
        self.runtime = runtime
        # out column -> ("pass", i) | ("udf", j)
        udf_pos = {s.name: j for j, s in enumerate(udf_specs)}
        pass_pos = {n: i for i, n in enumerate(pass_names)}
        self._slots = [
            ("udf", udf_pos[n]) if n in udf_pos else ("pass", pass_pos[n])
            for n in out_columns
        ]
        # key -> [diff, enqueue_wall_time, passthrough tuple, cells]; cells[j]
        # is ("done", value) for instantly-decided rows (ERROR poisoning /
        # propagate_none) or ("args", args_tuple, kwargs_tuple) awaiting launch
        # (a later same-key insert overwrites: keyed last-write-wins, the
        # discipline every keyed store in this engine follows)
        self.waiting: dict[int, list] = {}
        # key -> [count, row tuple] of settled rows live downstream. Retained
        # ONLY while some UDF is not declared deterministic — retracts must
        # then replay exactly what was inserted (the reference caches
        # non-deterministic UDF results for the same reason). All-deterministic
        # selects keep no state and recompute retract rows like the inline path.
        self._remember = any(not s.deterministic for s in udf_specs)
        self.emitted: dict[int, list] = {}
        # bounded replay cache for all-DETERMINISTIC selects: key ->
        # (input signature, output row) of recent emissions. A retract of a
        # recently-emitted row replays the cached output instead of re-running
        # the device UDF — value-identical by the determinism contract, and
        # load-bearing for the serving plane, where every served query row is
        # retracted one tick after its response (delete_completed_queries):
        # without it each retract re-embeds its row in a tiny padded launch.
        # Pure cache: a miss falls back to recompute, so the FIFO bound and
        # its absence from snapshots cost correctness nothing.
        self._recent: "OrderedDict[int, tuple]" = OrderedDict()

    def restore_state(self, state: dict) -> None:
        super().restore_state(state)
        # snapshot-restored enqueue stamps came from another process's
        # perf_counter epoch — reset so the deadline clock starts now
        import time as _t

        now = _t.perf_counter()
        for entry in self.waiting.values():
            entry[1] = now

    # ------------------------------------------------------------- helpers

    def _assemble(self, pass_vals: tuple, udf_vals: list) -> tuple:
        return tuple(
            pass_vals[i] if kind == "pass" else udf_vals[i]
            for kind, i in self._slots
        )

    def _pending_row(self, entry: list) -> tuple:
        from pathway_tpu_torch.internals.errors import PENDING

        cells = entry[3]
        return self._assemble(
            entry[2],
            [c[1] if c[0] == "done" else PENDING for c in cells],
        )

    def _entry_rows(self, sub: DeltaBatch):
        """(keys, diffs, pass tuples, cells) for an insert sub-batch."""
        from pathway_tpu_torch.internals.errors import ERROR

        pre = self.pre_program(sub)
        pass_lists = [column_to_list(np.asarray(pre[n])) for n in self.pass_names]
        per_spec = [spec.args_program(sub) for spec in self.udf_specs]
        n = len(sub)
        rows_cells: list[list] = []
        for r in range(n):
            cells = []
            for (arg_arrays, kw_arrays), spec in zip(per_spec, self.udf_specs):
                vals = tuple(a[r] for a in arg_arrays)
                kwvals = tuple(a[r] for a in kw_arrays)
                if any(v is ERROR for v in vals) or any(v is ERROR for v in kwvals):
                    cells.append(("done", ERROR))
                elif spec.propagate_none and (
                    any(v is None for v in vals) or any(v is None for v in kwvals)
                ):
                    cells.append(("done", None))
                else:
                    cells.append(("args", vals, kwvals))
            rows_cells.append(cells)
        pass_tuples = [tuple(pl[r] for pl in pass_lists) for r in range(n)]
        return sub.keys.tolist(), sub.diffs.tolist(), pass_tuples, rows_cells

    def _launch(self, all_cells: list[list]) -> list[list]:
        """Run every awaiting cell through the padded dispatcher; returns one
        value list per row, aligned with ``self.udf_specs``."""
        from pathway_tpu_torch.ops.microbatch import MicrobatchDispatcher

        n = len(all_cells)
        max_batch = self._effective_max_batch()
        out = [[None] * len(self.udf_specs) for _ in range(n)]
        for j, spec in enumerate(self.udf_specs):
            need = [(i, all_cells[i][j]) for i in range(n) if all_cells[i][j][0] == "args"]
            if need:
                d = MicrobatchDispatcher(
                    lambda items, s=spec: _launch_udf_batch(s, items),
                    max_batch=max_batch,
                    min_bucket=spec.min_bucket,
                    label=spec.name,
                )
                results = d.map([(cell[1], cell[2]) for _, cell in need])
                for (i, _), rv in zip(need, results):
                    out[i][j] = rv
            for i in range(n):
                cell = all_cells[i][j]
                if cell[0] == "done":
                    out[i][j] = cell[1]
        return out

    def _rows_for(self, sub: DeltaBatch) -> list[tuple]:
        """Synchronous fallback: compute output rows for a sub-batch right now
        (retractions of keys this node has no memory of — restored snapshots
        excepted, only possible for rows that predate the node)."""
        _keys, _diffs, pass_tuples, cells = self._entry_rows(sub)
        udf_vals = self._launch(cells)
        return [self._assemble(p, v) for p, v in zip(pass_tuples, udf_vals)]

    # ------------------------------------------------------------- operator

    def process(self, inputs, time):
        batch = inputs[0]
        if batch is None or not len(batch):
            return []
        batch = consolidate(batch)
        if not len(batch):
            return []
        out: list[DeltaBatch] = []
        dels = np.flatnonzero(batch.diffs < 0)
        if len(dels):
            out.extend(self._retract(batch, dels, time))
        ins = np.flatnonzero(batch.diffs > 0)
        if len(ins):
            out.extend(self._enqueue(batch, ins, time))
        if len(self.waiting) >= self._effective_max_batch():
            out.extend(self._flush(time, only_full=True))
        return out

    def _effective_max_batch(self) -> int:
        """Launch bucket for this flush: the static ``max_batch`` cap, tuned
        down live by the flow plane's AIMD controller when sinks approach
        their latency SLO (``pathway_tpu_torch/flow/controller.py``). Smaller
        buckets change launch SHAPES only — values stay byte-identical."""
        from pathway_tpu_torch import flow as _flow

        plane = _flow.current()
        if plane is None:
            return self.max_batch
        return max(1, min(self.max_batch, plane.target_batch()))

    def _entry_sig(self, pass_vals: tuple, cells: list) -> tuple:
        """Flat input signature of an entry — pass-through values + every UDF
        arg — for matching a retract against a buffered insert by VALUE."""
        flat = list(pass_vals)
        for c in cells:
            if c[0] == "done":
                flat.append(c[1])
            else:
                flat.extend(c[1])
                flat.extend(c[2])
        return tuple(flat)

    @staticmethod
    def _sig_matches(a: tuple, b: tuple) -> bool:
        """NaN-tolerant value equality: a retract row must match the buffered
        copy of ITSELF even when an input value is NaN (NaN != NaN would
        otherwise turn the cancel into a phantom retract + re-insert)."""
        if len(a) != len(b):
            return False
        for x, y in zip(a, b):
            if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
                try:
                    if not np.array_equal(x, y, equal_nan=True):
                        return False
                except TypeError:  # non-float dtypes reject equal_nan
                    if not np.array_equal(x, y):
                        return False
            elif x != y:
                if isinstance(x, float) and isinstance(y, float) \
                        and np.isnan(x) and np.isnan(y):
                    continue
                return False
        return True

    def _retract(self, batch, idx, time):
        out_keys: list[int] = []
        out_diffs: list[int] = []
        out_rows: list[tuple] = []
        unknown: list[tuple[int, int]] = []  # (row index, residual diff)
        # input signatures of every retract row whose key is buffered (or in
        # the recent-emission replay cache) — one vectorized _entry_rows pass,
        # not a 1-row program per retract
        cand = [
            int(i)
            for i in idx
            if int(batch.keys[i]) in self.waiting
            or int(batch.keys[i]) in self._recent
        ]
        sigs: dict[int, tuple] = {}
        if cand:
            _k, _d, pts, cls = self._entry_rows(
                batch.take(np.asarray(cand, dtype=np.int64))
            )
            sigs = {i: self._entry_sig(p, c) for i, p, c in zip(cand, pts, cls)}
        for i in idx:
            i = int(i)
            k = int(batch.keys[i])
            d = int(batch.diffs[i])
            w = self.waiting.get(k)
            if w is not None:
                # only a retract whose input VALUES match the buffered entry
                # cancels in-buffer — a cross-tick upsert may retract the old
                # settled version of the key after buffering the new one, and
                # that retract must instead replay/recompute the settled row
                if not self._sig_matches(sigs[i], self._entry_sig(w[2], w[3])):
                    w = None
            if w is not None:
                # cancel at most the buffered count; any excess (consolidate
                # may merge retracts of the buffered AND settled copies into
                # one diff) falls through to the settled row below
                cancel = max(d, -w[0])
                if cancel:
                    if self.mode == "pending":
                        out_keys.append(k)
                        out_diffs.append(cancel)
                        out_rows.append(self._pending_row(w))
                    w[0] += cancel
                    if w[0] <= 0:
                        del self.waiting[k]
                    d -= cancel
                if d == 0:
                    continue
            e = self.emitted.get(k)
            if e is not None:
                out_keys.append(k)
                out_diffs.append(d)
                out_rows.append(e[1])
                e[0] += d
                if e[0] <= 0:
                    del self.emitted[k]
                continue
            rec = self._recent.get(k)
            if rec is not None and self._sig_matches(sigs[i], rec[0]):
                # deterministic replay: the cached emission IS what a
                # recompute would produce for these inputs — skip the launch
                out_keys.append(k)
                out_diffs.append(d)
                out_rows.append(rec[1])
                continue
            unknown.append((i, d))
        if unknown:
            sub = batch.take(np.asarray([i for i, _ in unknown], dtype=np.int64))
            for (i, dd), row in zip(unknown, self._rows_for(sub)):
                out_keys.append(int(batch.keys[i]))
                out_diffs.append(dd)
                out_rows.append(row)
        if not out_keys:
            return []
        return [
            DeltaBatch.from_rows(
                out_keys, out_rows, self.out_columns, time,
                diffs=out_diffs, np_dtypes=self.np_dtypes,
            )
        ]

    def _enqueue(self, batch, idx, time):
        import time as _t

        sub = batch.take(idx)
        keys, diffs, pass_tuples, cells = self._entry_rows(sub)
        now = _t.perf_counter()
        entries = []
        for r in range(len(keys)):
            k = int(keys[r])
            entry = [int(diffs[r]), now, pass_tuples[r], cells[r]]
            prev = self.waiting.get(k)
            if prev is not None:
                entry[0] += prev[0]
                entry[1] = prev[1]  # keep the oldest age for the deadline
            self.waiting[k] = entry
            entries.append(entry)
        if self.mode != "pending":
            return []
        rows = [self._pending_row(e) for e in entries]
        return [
            DeltaBatch.from_rows(
                [int(k) for k in keys], rows, self.out_columns, time,
                diffs=[int(d) for d in diffs], np_dtypes=self.np_dtypes,
            )
        ]

    def _flush(self, time, only_full: bool = False):
        n = len(self.waiting)
        max_batch = self._effective_max_batch()
        consume = (n // max_batch) * max_batch if only_full else n
        if consume == 0:
            return []
        keys = list(self.waiting.keys())[:consume]
        entries = [self.waiting.pop(k) for k in keys]
        from pathway_tpu_torch import observability as _obs

        tracer = _obs.current()
        if tracer is not None and tracer.tick_span_id is not None:
            w0 = _time_mod.time_ns()
            udf_vals = self._launch([e[3] for e in entries])
            tracer.span(
                "microbatch/launch",
                w0,
                _time_mod.time_ns(),
                **{
                    "pathway.operator.id": self.node_index,
                    "pathway.rows": consume,
                    "pathway.only_full": only_full,
                    "pathway.udfs": ",".join(s.name for s in self.udf_specs),
                },
            )
        else:
            udf_vals = self._launch([e[3] for e in entries])
        out_keys: list[int] = []
        out_diffs: list[int] = []
        out_rows: list[tuple] = []
        for k, entry, vals in zip(keys, entries, udf_vals):
            diff = entry[0]
            row = self._assemble(entry[2], vals)
            if self.mode == "pending":
                out_keys.append(k)
                out_diffs.append(-diff)
                out_rows.append(self._pending_row(entry))
            out_keys.append(k)
            out_diffs.append(diff)
            out_rows.append(row)
            if self._remember:
                e = self.emitted.get(k)
                if e is None:
                    self.emitted[k] = [diff, row]
                else:
                    e[0] += diff
                    e[1] = row
            else:
                rec = self._recent
                rec[k] = (self._entry_sig(entry[2], entry[3]), row)
                if len(rec) > self._RECENT_MAX:
                    rec.popitem(last=False)
        return [
            DeltaBatch.from_rows(
                out_keys, out_rows, self.out_columns, time,
                diffs=out_diffs, np_dtypes=self.np_dtypes,
            )
        ]

    def _should_flush(self, time) -> bool:
        if time == END_OF_STREAM:
            return True
        rt = self.runtime
        if rt is None or not getattr(rt, "streaming", False):
            # static run: exactly one tick — flush at its frontier (emissions
            # re-enter the same logical time, matching the inline path)
            return True
        conns = getattr(rt, "connectors", None)
        if conns and all(d.is_finished() for d in conns):
            # drain tick: sources exhausted, nothing more will accumulate
            return True
        first = next(iter(self.waiting.values()))
        deadline = self.flush_ms
        if deadline is None:
            deadline = getattr(rt, "autocommit_duration_ms", 20) or 20
        import time as _t

        return (_t.perf_counter() - first[1]) * 1000.0 >= deadline

    def on_frontier(self, time):
        if not self.waiting or not self._should_flush(time):
            return []
        return self._flush(time)


# ---------------------------------------------------------------------------- groupby


class GroupByNode(Node):
    """Incremental grouped aggregation.

    State per group: reducer accumulators + the last emitted output row; an update
    retracts the previous aggregate row and emits the new one at the same timestamp —
    exactly the visible behavior of the reference's ``group_by_table`` +
    ``reduce.rs`` reducers, but driven by whole blocks with vectorized per-batch
    partial aggregation for semigroup reducers.
    """

    name = "groupby"

    snapshot_attrs = ("state", "cstate", "use_dict", "_seq", "_archived")

    def exchange_key(self, port):
        return self._gkeys  # co-locate rows of one group

    def __init__(
        self,
        group_cols: list[str],
        reducer_specs: list[tuple[str, ReducerImpl, list[str]]],
        key_col: str | None = None,
        out_group_cols: list[str] | None = None,
    ):
        super().__init__(n_inputs=1)
        self.group_cols = group_cols
        self.key_col = key_col
        self.reducer_specs = reducer_specs
        self.out_group_cols = out_group_cols if out_group_cols is not None else group_cols
        # gkey -> {"g": group values tuple, "acc": [state...], "emitted": tuple|None}
        self.state: dict[int, dict] = {}
        self._seq = 0
        self.out_columns = list(self.out_group_cols) + [s[0] for s in self.reducer_specs]
        # first-load fast path: per-group partials parked as arrays; folded into
        # the dict state only if incremental deltas arrive later
        self._archived: list[dict] = []
        # fully-columnar state (sorted gk → n/accumulator/group-value arrays):
        # active while every reducer is additive-columnar and every batch's
        # aggregated columns are numeric; falls back to the dict path otherwise
        self.use_dict = not all(spec[1].columnar for spec in reducer_specs)
        self.cstate: dict | None = None

    GLOBAL_KEY = 0x6A09E667F3BCC908  # single group for global reduce()

    NONE_KEY = 0xBB67AE8584CAA73B  # groups rows whose id-expression is (transiently) None

    def _gkeys(self, batch: DeltaBatch) -> np.ndarray:
        if self.key_col is not None:
            col = batch.data[self.key_col]
            if col.dtype == object:
                # tolerate None ids: mid-tick outer-join padding may flow through
                # before the matching side arrives; corrections retract it later
                gkeys = np.fromiter(
                    (self.NONE_KEY if v is None else int(v) for v in col),
                    dtype=np.uint64,
                    count=len(col),
                )
            else:
                gkeys = col.astype(np.uint64)
        elif not self.group_cols:
            gkeys = np.full(len(batch), self.GLOBAL_KEY, dtype=np.uint64)
        else:
            gkeys = row_keys([batch.data[c] for c in self.group_cols], n=len(batch))
        lin = _lineage.current()
        if lin is not None and len(gkeys):
            # lineage: a group key derives from the input row keys it absorbs
            lin.record_edge(self, gkeys, batch.keys)
        return gkeys

    def _vector_first_load(self, batch: DeltaBatch, time: int) -> list[DeltaBatch] | None:
        """All-new groups, semigroup-only reducers: aggregate with reduceat and
        emit columns directly from arrays; park partials for lazy state build."""
        gkeys = self._gkeys(batch)
        order = np.argsort(gkeys, kind="stable")
        gk_sorted = gkeys[order]
        starts = group_starts(gk_sorted)
        diffs = batch.diffs
        counts = np.add.reduceat(diffs[order], starts)
        partials: list[Any] = []
        for (_, impl, cols) in self.reducer_specs:
            arrays = [batch.data[c] for c in cols]
            p = impl.grouped_partials(arrays, diffs, order, starts)
            if p is None:
                return None  # column needs the per-group path
            partials.append(p)
        first_rows = order[starts]
        gk_arr = gk_sorted[starts]
        group_arrays = [batch.data[c][first_rows] for c in self.group_cols]

        extracted: list[list] = []
        for r, (_, impl, _) in enumerate(self.reducer_specs):
            extracted.append([impl.extract(p) for p in partials[r]])

        self._archived.append(
            {
                "gk": gk_arr.tolist(),
                "gvals": [column_to_list(a) for a in group_arrays],
                "counts": counts.tolist(),
                "partials": partials,
                "extracted": extracted,
            }
        )

        emit_mask = (counts > 0) & (gk_arr != np.uint64(self.NONE_KEY))
        idx = np.flatnonzero(emit_mask)
        if not len(idx):
            return []
        data: dict[str, np.ndarray] = {}
        for name, arr in zip(self.out_group_cols, group_arrays):
            data[name] = arr[idx]
        for r, (name, _, _) in enumerate(self.reducer_specs):
            vals = [extracted[r][i] for i in idx]
            probe = np.asarray(vals[:1]) if vals else None
            npd = probe.dtype if probe is not None and probe.ndim == 1 and probe.dtype.kind in "iufb" else np.dtype(object)
            data[name] = make_column(vals, npd)
        return [
            DeltaBatch(gk_arr[idx], np.ones(len(idx), dtype=np.int64), data, time)
        ]

    def _materialize_archived(self) -> None:
        for arch in self._archived:
            gks = arch["gk"]
            gvals = arch["gvals"]
            counts = arch["counts"]
            partials = arch["partials"]
            extracted = arch["extracted"]
            for i in range(len(gks)):
                gk = gks[i]
                g_tuple = tuple(col[i] for col in gvals)
                st = self.state.get(gk)
                if st is None:
                    st = {
                        "g": g_tuple,
                        "acc": [spec[1].make() for spec in self.reducer_specs],
                        "n": 0,
                        "emitted": None,
                    }
                    self.state[gk] = st
                st["n"] += counts[i]
                for r, spec in enumerate(self.reducer_specs):
                    st["acc"][r] = spec[1].merge_partial(st["acc"][r], partials[r][i])
                if st["n"] > 0 and gk != self.NONE_KEY:
                    st["emitted"] = g_tuple[: len(self.out_group_cols)] + tuple(
                        extracted[r][i] for r in range(len(self.reducer_specs))
                    )
                elif st["n"] <= 0:
                    del self.state[gk]
        self._archived = []

    def _process_columnar(self, batch: DeltaBatch, time: int) -> list[DeltaBatch] | None:
        """Whole-state vectorized aggregation: state is sorted arrays, a delta
        block merges in with searchsorted + reduceat; no per-group Python.
        Returns None when this batch's columns can't vectorize (→ dict path)."""
        gkeys = self._gkeys(batch)
        diffs = batch.diffs
        routed = torch_kernels.try_grouped(gkeys, diffs, self.reducer_specs, batch.data)
        if routed is not None:
            order, starts, u_gk, counts, partials = routed
        else:
            order = np.argsort(gkeys, kind="stable")
            gk_sorted = gkeys[order]
            starts = group_starts(gk_sorted)
            partials = []
            for (_, impl, cols) in self.reducer_specs:
                arrays = [batch.data[c] for c in cols]
                p = impl.grouped_partials_np(arrays, diffs, order, starts)
                if p is None:
                    return None
                partials.append(p)
            u_gk = gk_sorted[starts]
            counts = np.add.reduceat(diffs[order], starts)
        first_rows = order[starts]
        batch_gcols = [batch.data[c][first_rows] for c in self.group_cols]

        st = self.cstate
        if st is None:
            st = self.cstate = {
                "gk": np.empty(0, dtype=np.uint64),
                "n": np.empty(0, dtype=np.int64),
                "accs": [np.empty(0, dtype=p.dtype) for p in partials],
                "gcols": [a[:0] for a in batch_gcols],
            }
        sgk = st["gk"]
        if len(sgk):
            pos = np.searchsorted(sgk, u_gk).clip(0, len(sgk) - 1)
            exists = sgk[pos] == u_gk
        else:
            pos = np.zeros(len(u_gk), dtype=np.int64)
            exists = np.zeros(len(u_gk), dtype=bool)
        old_n = np.where(exists, st["n"][pos] if len(sgk) else 0, 0)
        new_n = old_n + counts
        old_accs: list[np.ndarray] = []
        new_accs: list[np.ndarray] = []
        for acc_arr, p in zip(st["accs"], partials):
            dt = np.result_type(acc_arr.dtype, p.dtype)
            old = np.zeros(len(u_gk), dtype=dt)
            if len(acc_arr):
                ex = np.flatnonzero(exists)
                old[ex] = acc_arr[pos[ex]]
            old_accs.append(old)
            new_accs.append(old + p)

        # emission: retract the previously-emitted aggregate of every changed
        # group, emit the new one (None-id group excluded, see on_end)
        not_none = u_gk != np.uint64(self.NONE_KEY)
        was = exists & (old_n > 0) & not_none
        now = (new_n > 0) & not_none
        changed = np.zeros(len(u_gk), dtype=bool)
        for old, new in zip(old_accs, new_accs):
            changed |= old != new
        emit_retract = was & (~now | changed)
        emit_insert = now & (~was | changed)

        # group-col values: the state's first-seen copy for existing groups,
        # the batch's for new groups
        g_out: list[np.ndarray] = []
        for sc, bc in zip(st["gcols"], batch_gcols):
            if not len(sc):
                g_out.append(bc)
                continue
            ex = np.flatnonzero(exists)
            if sc.dtype == bc.dtype:
                merged = bc.copy()
                merged[ex] = sc[pos[ex]]
            else:
                merged = np.empty(len(u_gk), dtype=object)
                merged[:] = list(bc) if bc.dtype.kind in ("M", "m") else bc
                picked = sc[pos[ex]]
                merged[ex] = list(picked) if sc.dtype.kind in ("M", "m") else picked
            g_out.append(merged)

        # update state: in-place for surviving groups, rebuild for add/remove
        remove = exists & (new_n <= 0)
        add = ~exists & (new_n > 0)
        upd = exists & (new_n > 0)
        if upd.any():
            ui = pos[upd]
            st["n"][ui] = new_n[upd]
            for r in range(len(st["accs"])):
                vals = new_accs[r][upd]
                if st["accs"][r].dtype != vals.dtype:
                    st["accs"][r] = st["accs"][r].astype(
                        np.result_type(st["accs"][r].dtype, vals.dtype)
                    )
                st["accs"][r][ui] = vals
        if remove.any() or add.any():
            keep = np.ones(len(sgk), dtype=bool)
            keep[pos[remove]] = False
            kept_gk = sgk[keep]
            add_gk = u_gk[add]
            # persistent arrangement discipline: both runs are sorted and
            # DISJOINT (added groups were absent from state), so the merged
            # arrangement is a two-way interleave by searchsorted positions —
            # no argsort of the whole state per tick (the re-arrangement tax
            # BASELINE §incremental attributes)
            ia, ib = interleave_positions(kept_gk, add_gk)
            total = len(kept_gk) + len(add_gk)
            positions = [ia, ib]
            gk_m = np.empty(total, dtype=np.uint64)
            gk_m[ia] = kept_gk
            gk_m[ib] = add_gk
            st["gk"] = gk_m
            n_m = np.empty(total, dtype=np.int64)
            n_m[ia] = st["n"][keep]
            n_m[ib] = new_n[add]
            st["n"] = n_m
            for r in range(len(st["accs"])):
                a, b = st["accs"][r][keep], new_accs[r][add]
                dt = np.result_type(a.dtype, b.dtype)
                acc_m = np.empty(total, dtype=dt)
                acc_m[ia] = a
                acc_m[ib] = b
                st["accs"][r] = acc_m
            st["gcols"] = [
                scatter_cols([sc[keep], bc[add]], positions, total)
                for sc, bc in zip(st["gcols"], batch_gcols)
            ]

        r_idx = np.flatnonzero(emit_retract)
        i_idx = np.flatnonzero(emit_insert)
        if not len(r_idx) and not len(i_idx):
            return []
        keys_out = np.concatenate([u_gk[r_idx], u_gk[i_idx]])
        diffs_out = np.concatenate(
            [np.full(len(r_idx), -1, dtype=np.int64), np.ones(len(i_idx), dtype=np.int64)]
        )
        data: dict[str, np.ndarray] = {}
        for name, col in zip(self.out_group_cols, g_out):
            data[name] = concat_cols([col[r_idx], col[i_idx]])
        for r, (name, _, _) in enumerate(self.reducer_specs):
            data[name] = np.concatenate([old_accs[r][r_idx], new_accs[r][i_idx]])
        return [DeltaBatch(keys_out, diffs_out, data, time)]

    def _cstate_entries(self, st: dict, out: dict) -> None:
        """Expand one columnar state block into per-group dict entries."""
        gk_list = st["gk"].tolist()
        n_list = st["n"].tolist()
        gcol_lists = [column_to_list(c) for c in st["gcols"]]
        acc_lists = [a.tolist() for a in st["accs"]]
        for i, gk in enumerate(gk_list):
            g_tuple = tuple(col[i] for col in gcol_lists)
            accs = [acc_lists[r][i] for r in range(len(acc_lists))]
            emitted = None
            if n_list[i] > 0 and gk != self.NONE_KEY:
                emitted = g_tuple[: len(self.out_group_cols)] + tuple(accs)
            out[gk] = {
                "g": g_tuple, "acc": accs, "n": n_list[i], "emitted": emitted,
            }

    def _decolumnarize(self) -> None:
        """A batch arrived that the columnar path can't aggregate (object
        column): convert the array state to dict state and stay there."""
        self.use_dict = True
        st = self.cstate
        self.cstate = None
        if st is None:
            return
        self._cstate_entries(st, self.state)

    def migrate_restore(self, shards: list[dict], keep) -> dict | None:
        """O(moved-state) rescale merge: group keys route by ``_gkeys`` so
        every group lives on its shard-map owner — old shards are key-disjoint
        and a plain filtered union rebuilds this worker's state. Columnar
        blocks merge as sorted disjoint runs; if ANY old shard had fallen back
        to the dict path the merged state must too (the dict path ignores
        ``cstate``), so columnar blocks decolumnarize during the merge."""
        state: dict[int, dict] = {}
        archived: list[dict] = []
        cparts: list[dict] = []
        seq = 0
        any_dict = any(s.get("use_dict") for s in shards)
        for s in shards:
            seq = max(seq, int(s.get("_seq", 0)))
            for gk, gst in (s.get("state") or {}).items():
                if bool(keep(np.asarray([gk], dtype=np.uint64))[0]):
                    state[gk] = gst
            for arch in s.get("_archived") or []:
                gk_arr = np.asarray(arch["gk"], dtype=np.uint64)
                mask = keep(gk_arr)
                if not mask.any():
                    continue
                idx = np.flatnonzero(mask)
                archived.append(
                    {
                        "gk": [arch["gk"][i] for i in idx],
                        "gvals": [[col[i] for i in idx] for col in arch["gvals"]],
                        "counts": [arch["counts"][i] for i in idx],
                        "partials": [
                            p[idx] if isinstance(p, np.ndarray) else [p[i] for i in idx]
                            for p in arch["partials"]
                        ],
                        "extracted": [[ex[i] for i in idx] for ex in arch["extracted"]],
                    }
                )
            cst = s.get("cstate")
            if cst is not None and len(cst["gk"]):
                mask = keep(cst["gk"])
                if not mask.any():
                    continue
                part = {
                    "gk": cst["gk"][mask],
                    "n": cst["n"][mask],
                    "accs": [a[mask] for a in cst["accs"]],
                    "gcols": [c[mask] for c in cst["gcols"]],
                }
                if any_dict:
                    self._cstate_entries(part, state)
                else:
                    cparts.append(part)
        cstate = None
        if cparts:
            if len(cparts) == 1:
                cstate = cparts[0]
            else:
                gk = np.concatenate([p["gk"] for p in cparts])
                order = np.argsort(gk, kind="stable")
                cstate = {
                    "gk": gk[order],
                    "n": np.concatenate([p["n"] for p in cparts])[order],
                    "accs": [
                        np.concatenate([p["accs"][r] for p in cparts])[order]
                        for r in range(len(cparts[0]["accs"]))
                    ],
                    "gcols": [
                        concat_cols([p["gcols"][c] for p in cparts])[order]
                        for c in range(len(cparts[0]["gcols"]))
                    ],
                }
        if not state and not archived and cstate is None:
            return None
        return {
            "state": state,
            "cstate": cstate,
            "use_dict": any_dict,
            "_seq": seq,
            "_archived": archived,
        }

    def process(self, inputs, time):
        tok = _phases.start()
        try:
            return self._process_impl(inputs, time)
        finally:
            _phases.stop(tok, "groupby")

    def _process_impl(self, inputs, time):
        batch = inputs[0]
        if batch is None or not len(batch):
            return []
        if not self.use_dict:
            res = self._process_columnar(batch, time)
            if res is not None:
                return res
            self._decolumnarize()
        if not self.state and len(batch) and bool((batch.diffs > 0).all()):
            if all(spec[1].semigroup for spec in self.reducer_specs) and not self._archived:
                fast = self._vector_first_load(batch, time)
                if fast is not None:
                    return fast
        if self._archived:
            self._materialize_archived()
        gkeys = self._gkeys(batch)
        order = np.argsort(gkeys, kind="stable")
        gk_sorted = gkeys[order]
        starts = group_starts(gk_sorted)
        ends = np.append(starts[1:], len(gk_sorted))

        group_arrays = [batch.data[c] for c in self.group_cols]
        diffs = batch.diffs
        spec_arrays = [
            [batch.data[c] for c in cols] for (_, _, cols) in self.reducer_specs
        ]

        # one vectorized pass for group counts and semigroup partials; only
        # multiset/stateful reducers fall back to per-row updates inside the loop
        n_groups = len(starts)
        group_counts = (
            np.add.reduceat(diffs[order], starts).tolist() if n_groups else []
        )
        grouped: list[Any | None] = []
        for spec, arrays in zip(self.reducer_specs, spec_arrays):
            impl = spec[1]
            if impl.semigroup and n_groups:
                grouped.append(impl.grouped_partials(arrays, diffs, order, starts))
            else:
                grouped.append(None)
        first_rows = order[starts] if n_groups else order
        group_val_lists = [column_to_list(arr[first_rows]) for arr in group_arrays]
        gk_list = gk_sorted[starts].tolist() if n_groups else []

        out_keys: list[int] = []
        out_diffs: list[int] = []
        out_rows: list[tuple] = []

        for gi in range(n_groups):
            s = starts[gi]
            e = ends[gi]
            gk = gk_list[gi]
            st = self.state.get(gk)
            if st is None:
                st = {
                    "g": tuple(col[gi] for col in group_val_lists),
                    "acc": [spec[1].make() for spec in self.reducer_specs],
                    "n": 0,
                    "emitted": None,
                }
                self.state[gk] = st
            # update accumulators
            st["n"] += int(group_counts[gi])
            for r, (spec, arrays) in enumerate(zip(self.reducer_specs, spec_arrays)):
                impl = spec[1]
                if grouped[r] is not None:
                    st["acc"][r] = impl.merge_partial(st["acc"][r], grouped[r][gi])
                elif impl.semigroup:
                    idx = order[s:e]
                    cols_slice = [arr[idx] for arr in arrays]
                    partial = impl.batch_partial(cols_slice, diffs[idx], slice(None))
                    st["acc"][r] = impl.merge_partial(st["acc"][r], partial)
                else:
                    for i in order[s:e]:
                        st["acc"][r] = (
                            impl.update(
                                st["acc"][r],
                                tuple(arr[i] for arr in arrays),
                                int(diffs[i]),
                                time,
                                self._seq,
                            )
                            or st["acc"][r]
                        )
                        self._seq += 1
            # emit — except the None-id group: mid-tick join padding may put rows
            # there transiently; if they persist, they are dropped from output
            # (reference: error-keyed rows go to the error log, not results)
            if gk == self.NONE_KEY:
                continue
            old = st["emitted"]
            if st["n"] <= 0:
                new = None
                del self.state[gk]
            else:
                g_vals = st["g"][: len(self.out_group_cols)]
                new = g_vals + tuple(
                    spec[1].extract(st["acc"][r])
                    for r, spec in enumerate(self.reducer_specs)
                )
                st["emitted"] = new
            if old == new and not _tuple_differs(old, new):
                continue
            if old is not None:
                out_keys.append(gk)
                out_diffs.append(-1)
                out_rows.append(old)
            if new is not None:
                out_keys.append(gk)
                out_diffs.append(1)
                out_rows.append(new)

        if not out_keys:
            return []
        return [
            DeltaBatch.from_rows(out_keys, out_rows, self.out_columns, time, diffs=out_diffs)
        ]

    def on_end(self):
        # join padding parks rows under NONE_KEY transiently and corrections
        # normally clear it; rows still there when the stream closes had a
        # genuinely-None id-expression and were excluded from output — say so
        # instead of losing them silently (reference routes error-keyed rows to
        # the error log)
        n_none = 0
        st = self.state.get(self.NONE_KEY)
        if st is not None:
            n_none = st["n"]
        elif self.cstate is not None and len(self.cstate["gk"]):
            pos = int(np.searchsorted(self.cstate["gk"], np.uint64(self.NONE_KEY)))
            if pos < len(self.cstate["gk"]) and self.cstate["gk"][pos] == np.uint64(self.NONE_KEY):
                n_none = int(self.cstate["n"][pos])
        if n_none > 0:
            import warnings

            warnings.warn(
                f"groupby: {n_none} row(s) with a None grouping id were "
                "excluded from the output",
                stacklevel=2,
            )


def _tuple_differs(a, b) -> bool:
    if (a is None) != (b is None):
        return True
    if a is None:
        return False
    if len(a) != len(b):
        return True
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            if not np.array_equal(x, y):
                return True
        elif x != y:
            return True
    return False


# ---------------------------------------------------------------------------- combine


class SideSpec:
    __slots__ = ("required", "negated")

    def __init__(self, required: bool = True, negated: bool = False):
        self.required = required
        self.negated = negated


class CombineNode(Node):
    """Key-aligned N-way combine, fully columnar.

    One node covers the reference's same-universe operator family:
    ``update_rows``/``update_cells`` (override semantics), ``restrict``/
    ``intersect`` (required sides), ``difference`` (negated side), ``having``,
    and cross-table aligned selects over equal universes. State per side is a
    :class:`ColumnarKeyedStore`; a tick applies every side's delta block, then
    re-combines only the affected keys with mode-specific vectorized assembly.
    Change detection uses row digests (the same digest discipline
    ``consolidate`` already relies on).

    Modes: ``"side0"`` (emit side 0's row under the presence gate),
    ``"update_rows"`` (later sides override whole rows),
    ``"update_cells"`` (side 1 overrides the listed columns of side 0),
    ``"concat"`` (concatenate all sides' rows in order).
    """

    name = "combine"

    snapshot_attrs = ("stores", "emitted")

    def __init__(
        self,
        sides: list["SideSpec"],
        side_columns: list[list[str]],
        mode: str,
        out_columns: list[str],
        np_dtypes: dict | None = None,
        override_positions: list[tuple[int, int]] | None = None,
    ):
        super().__init__(n_inputs=len(sides))
        self.sides = sides
        self.side_columns = side_columns
        self.mode = mode
        self.out_columns = out_columns
        self.np_dtypes = np_dtypes or {}
        # update_cells: (index in side-1 columns, index in out columns)
        self.override_positions = override_positions or []
        # update_rows: per-side (src idx, out idx) by NAME — a side whose
        # column order differs from out_columns must not write cross-column
        out_pos = {n: i for i, n in enumerate(out_columns)}
        self._side_out_maps = [
            [(j, out_pos[n]) for j, n in enumerate(cols) if n in out_pos]
            for cols in side_columns
        ]
        self.stores = [ColumnarKeyedStore(len(cols)) for cols in side_columns]
        self.emitted = ColumnarKeyedStore(len(out_columns))

    def process(self, inputs, time):
        affected_parts: list[np.ndarray] = []
        for port, batch in enumerate(inputs):
            if batch is None or not len(batch):
                continue
            # same-tick insert+retract of one row must net out BEFORE the
            # delete-then-insert application order below
            batch = consolidate(batch)
            if not len(batch):
                continue
            store = self.stores[port]
            dels = np.flatnonzero(batch.diffs < 0)
            if len(dels):
                store.delete(batch.keys[dels])
            ins = np.flatnonzero(batch.diffs > 0)
            if len(ins):
                cols = [batch.data[c][ins] for c in self.side_columns[port]]
                store.upsert(batch.keys[ins], cols)
            affected_parts.append(batch.keys)
        if not affected_parts:
            return []
        keys = np.unique(np.concatenate(affected_parts))

        presents: list[np.ndarray] = []
        aligned: list[list[np.ndarray]] = []
        for store in self.stores:
            p, cols = store.get(keys)
            presents.append(p)
            aligned.append(cols)

        gate = np.ones(len(keys), dtype=bool)
        for spec, present in zip(self.sides, presents):
            if spec.required:
                gate &= ~present if spec.negated else present
        # a key with no contributing side left (fully retracted) emits nothing
        contributing = [
            p for spec, p in zip(self.sides, presents) if not spec.negated
        ]
        if contributing:
            gate &= np.logical_or.reduce(contributing)

        new_cols = self._assemble(keys, presents, aligned)
        was, old_cols = self.emitted.get(keys)

        changed = np.ones(len(keys), dtype=bool)
        both = was & gate
        if both.any():
            idx = np.flatnonzero(both)
            new_d = row_keys([c[idx] for c in new_cols], n=len(idx))
            old_d = row_keys([c[idx] for c in old_cols], n=len(idx))
            changed[idx] = new_d != old_d

        retract = was & (~gate | changed)
        insert = gate & (~was | changed)
        r_idx = np.flatnonzero(retract)
        i_idx = np.flatnonzero(insert)
        if not len(r_idx) and not len(i_idx):
            return []

        if len(r_idx):
            self.emitted.delete(keys[r_idx])
        if len(i_idx):
            self.emitted.upsert(keys[i_idx], [c[i_idx] for c in new_cols])

        out_keys = np.concatenate([keys[r_idx], keys[i_idx]])
        out_diffs = np.concatenate(
            [np.full(len(r_idx), -1, dtype=np.int64), np.ones(len(i_idx), dtype=np.int64)]
        )
        data: dict[str, np.ndarray] = {}
        for j, name in enumerate(self.out_columns):
            arr = concat_cols([old_cols[j][r_idx], new_cols[j][i_idx]])
            npd = self.np_dtypes.get(name)
            if npd is not None and npd != np.dtype(object) and arr.dtype == object:
                arr = make_column(arr.tolist(), npd)
            data[name] = arr
        return [DeltaBatch(out_keys, out_diffs, data, time)]

    def _assemble(
        self,
        keys: np.ndarray,
        presents: list[np.ndarray],
        aligned: list[list[np.ndarray]],
    ) -> list[np.ndarray]:
        if self.mode == "side0":
            return aligned[0]
        if self.mode == "update_rows":
            # later sides override whole rows where present (column mapping by
            # NAME: side orders may differ from out_columns)
            out = [np.empty(len(keys), dtype=object) for _ in self.out_columns]
            for src_j, dst_j in self._side_out_maps[0]:
                out[dst_j][:] = aligned[0][src_j]
            for s in range(1, len(aligned)):
                idx = np.flatnonzero(presents[s])
                for src_j, dst_j in self._side_out_maps[s]:
                    out[dst_j][idx] = aligned[s][src_j][idx]
            return out
        if self.mode == "update_cells":
            out = [c.copy() for c in aligned[0]]
            idx = np.flatnonzero(presents[1])
            for src_j, dst_j in self.override_positions:
                out[dst_j][idx] = aligned[1][src_j][idx]
            return out
        if self.mode == "concat":
            return [c for cols in aligned for c in cols]
        raise ValueError(f"combine: unknown mode {self.mode!r}")


# ---------------------------------------------------------------------------- join


class JoinNode(Node):
    """Incremental symmetric hash equi-join with outer padding.

    The block counterpart of ``join_tables`` (``src/engine/graph.rs:783`` region),
    with state held the way differential holds arrangements — columnar and sorted
    (``engine/colstore.py``) — so every delta block, first load or late-stream,
    is probed and applied with searchsorted/repeat-expansion kernels; there is no
    per-row dict path at all. For outer variants, a ``SortedCounts`` per side
    tracks live-row counts per join key; its batch 0↔+ transitions drive padded
    (null-extended) row flips. Output row keys are ``hash(left_key, right_key)``
    (padded rows: hash with a side salt), matching the reference's
    id-from-both-sides discipline.
    """

    name = "join"

    snapshot_attrs = ("store", "jk_counts")

    def exchange_key(self, port):
        col = self.left_on if port == 0 else self.right_on

        def key_fn(batch, c=col):
            arr = batch.data[c]
            if arr.dtype == object:
                # null join keys never match; shard 0 handles their padding
                return np.fromiter(
                    (0 if v is None else int(v) for v in arr),
                    dtype=np.uint64,
                    count=len(arr),
                )
            return arr.astype(np.uint64)

        return key_fn

    def migrate_restore(self, shards: list[dict], keep) -> dict | None:
        """O(moved-state) rescale merge: both arrangements and the outer-pad
        counts are addressed by the join key — the same key ``exchange_key``
        routes by — so old shards are jk-disjoint and a filtered union of
        their live rows rebuilds this worker's state. Tombstoned rows are
        dropped in transit (``iter_live``), so the migrated store starts
        compacted."""
        store = [
            ColumnarMultimap(len(self.left_cols)),
            ColumnarMultimap(len(self.right_cols)),
        ]
        jk_counts = [SortedCounts(), SortedCounts()]
        moved = 0
        for s in shards:
            for side in (0, 1):
                for jk, rk, cols in s["store"][side].iter_live():
                    if not len(jk):
                        continue
                    mask = keep(jk)
                    if mask.any():
                        store[side].insert(
                            jk[mask], rk[mask], [c[mask] for c in cols]
                        )
                        moved += int(mask.sum())
                sc = s["jk_counts"][side]
                if len(sc.keys):
                    mask = keep(sc.keys) & (sc.counts != 0)
                    if mask.any():
                        jk_counts[side].add(sc.keys[mask], sc.counts[mask])
                        moved += int(mask.sum())
        if not moved:
            return None
        return {"store": store, "jk_counts": jk_counts}

    def __init__(
        self,
        left_cols: list[str],
        right_cols: list[str],
        left_on: str,
        right_on: str,
        how: str = "inner",  # inner | left | right | outer
        out_columns: list[str] | None = None,
        left_id_only: bool = False,
    ):
        super().__init__(n_inputs=2)
        self.left_cols = left_cols
        self.right_cols = right_cols
        self.left_on = left_on
        self.right_on = right_on
        self.how = how
        self.left_id_only = left_id_only
        self.out_columns = out_columns or (
            ["__left_id__", "__right_id__"] + left_cols + right_cols
        )
        # columnar per-side state: sorted segments of (jk, rk, values)
        self.store = [ColumnarMultimap(len(left_cols)), ColumnarMultimap(len(right_cols))]
        # per-side live-row counts per jk (outer padding only)
        self.jk_counts = [SortedCounts(), SortedCounts()]

    # -------------------------------------------------------------- block kernels

    def _jk_valid(self, batch: DeltaBatch, side: int) -> tuple[np.ndarray, np.ndarray]:
        col = batch.data[self.left_on if side == 0 else self.right_on]
        if col.dtype == object:
            n = len(col)
            valid = np.fromiter((v is not None for v in col), dtype=bool, count=n)
            jk = np.zeros(n, dtype=np.uint64)
            nz = np.flatnonzero(valid)
            if len(nz):
                jk[nz] = np.fromiter((int(col[i]) for i in nz), dtype=np.uint64, count=len(nz))
            return jk, valid
        return col.astype(np.uint64), np.ones(len(col), dtype=bool)

    def _side_cols(self, side: int) -> list[str]:
        return self.left_cols if side == 0 else self.right_cols

    def _out_col_names(self) -> tuple[str, str, list[str], list[str]]:
        nl = len(self.left_cols)
        return (
            self.out_columns[0],
            self.out_columns[1],
            self.out_columns[2 : 2 + nl],
            self.out_columns[2 + nl :],
        )

    def _pad_arrays(
        self,
        side: int,
        rk: np.ndarray,
        cols: list[np.ndarray],
        diffs: np.ndarray,
        time: int,
    ) -> DeltaBatch:
        """Null-padded output rows for unmatched rows of ``side``."""
        lid, rid, l_names, r_names = self._out_col_names()
        if side == 0:
            out_keys = rk if self.left_id_only else splitmix64(rk ^ np.uint64(0xA0B0))
        else:
            out_keys = splitmix64(rk ^ np.uint64(0xB0A0))
        lin = _lineage.current()
        if lin is not None and len(rk):
            lin.record_edge(self, out_keys, rk)
        none_col = np.full(len(rk), None, dtype=object)
        data: dict[str, np.ndarray] = {}
        data[lid] = rk if side == 0 else none_col
        data[rid] = rk if side == 1 else none_col
        my_names = l_names if side == 0 else r_names
        other_names = r_names if side == 0 else l_names
        for name, arr in zip(my_names, cols):
            data[name] = arr
        for name in other_names:
            data[name] = none_col
        return DeltaBatch(out_keys, diffs.astype(np.int64), data, time)

    def _matched_arrays(
        self,
        side: int,
        my_rk: np.ndarray,
        my_cols: list[np.ndarray],
        o_rk: np.ndarray,
        o_cols: list[np.ndarray],
        diffs: np.ndarray,
        time: int,
    ) -> DeltaBatch:
        """Matched output rows: ``side``'s delta rows × the other side's state."""
        lid, rid, l_names, r_names = self._out_col_names()
        if side == 0:
            lk, rk, l_cols, r_cols = my_rk, o_rk, my_cols, o_cols
        else:
            lk, rk, l_cols, r_cols = o_rk, my_rk, o_cols, my_cols
        out_keys = lk if self.left_id_only else combine_keys(lk, rk)
        lin = _lineage.current()
        if lin is not None and len(out_keys):
            # a matched join row derives from BOTH side rows
            lin.record_edge(self, out_keys, lk)
            lin.record_edge(self, out_keys, rk)
        data: dict[str, np.ndarray] = {lid: lk, rid: rk}
        for name, arr in zip(l_names, l_cols):
            data[name] = arr
        for name, arr in zip(r_names, r_cols):
            data[name] = arr
        return DeltaBatch(out_keys, diffs.astype(np.int64), data, time)

    def _apply_side(self, side: int, batch: DeltaBatch, time: int) -> list[DeltaBatch]:
        """Apply one side's delta block against the other side's columnar state."""
        jk, valid = self._jk_valid(batch, side)
        diffs = batch.diffs
        my_cols = [batch.data[c] for c in self._side_cols(side)]
        pad_mine = self.how in ("left", "outer") if side == 0 else self.how in ("right", "outer")
        pad_other = self.how in ("right", "outer") if side == 0 else self.how in ("left", "outer")
        other = self.store[1 - side]
        out: list[DeltaBatch] = []
        # null join keys never match; padded if outer on my side
        if pad_mine and not valid.all():
            inv = np.flatnonzero(~valid)
            out.append(
                self._pad_arrays(
                    side, batch.keys[inv], [c[inv] for c in my_cols], diffs[inv], time
                )
            )
        for sign in (-1, 1):  # retractions before insertions
            idx = np.flatnonzero(valid & ((diffs < 0) if sign < 0 else (diffs > 0)))
            if not len(idx):
                continue
            q_jk = jk[idx]
            q_rk = batch.keys[idx]
            q_diff = diffs[idx]
            q_cols = [c[idx] for c in my_cols]
            # matched rows appear/disappear with my delta's sign
            m_q, m_rk, m_cols = other.match(q_jk)
            if len(m_q):
                out.append(
                    self._matched_arrays(
                        side, q_rk[m_q], [c[m_q] for c in q_cols],
                        m_rk, m_cols, q_diff[m_q], time,
                    )
                )
            # my padded rows exist exactly while the other side has no match
            if pad_mine:
                unmatched = np.flatnonzero(self.jk_counts[1 - side].get(q_jk) == 0)
                if len(unmatched):
                    out.append(
                        self._pad_arrays(
                            side, q_rk[unmatched],
                            [c[unmatched] for c in q_cols], q_diff[unmatched], time,
                        )
                    )
            # apply my delta to my state; 0<->+ transitions flip the other
            # side's padded rows. My jk counts are only consulted when the
            # OTHER side pads (== pad_other), so one-sided joins track one side.
            if not pad_other:
                if sign < 0:
                    self.store[side].delete(q_jk, q_rk)
                else:
                    self.store[side].insert(q_jk, q_rk, q_cols)
                continue
            uniq, prev, new = self.jk_counts[side].add(q_jk, q_diff)
            if sign < 0:
                self.store[side].delete(q_jk, q_rk)
                flipped = uniq[(prev > 0) & (new <= 0)]
                flip_diff = 1  # other side lost its last match: padded rows appear
            else:
                self.store[side].insert(q_jk, q_rk, q_cols)
                flipped = uniq[(prev <= 0) & (new > 0)]
                flip_diff = -1  # other side gained a first match: padded rows retract
            if len(flipped):
                f_q, f_rk, f_cols = other.match(flipped)
                if len(f_q):
                    out.append(
                        self._pad_arrays(
                            1 - side, f_rk, f_cols,
                            np.full(len(f_rk), flip_diff, dtype=np.int64), time,
                        )
                    )
        return out

    def process(self, inputs, time):
        tok = _phases.start()
        try:
            return self._process_impl(inputs, time)
        finally:
            _phases.stop(tok, "join")

    def _process_impl(self, inputs, time):
        # Sides apply sequentially (left first), each probing the other's
        # state as of that moment — the batch-granular equivalent of the
        # reference's record-at-a-time symmetric join discipline.
        out: list[DeltaBatch] = []
        for side in (0, 1):
            batch = inputs[side]
            if batch is not None and len(batch):
                out.extend(self._apply_side(side, batch, time))
        out = [b for b in out if not b.is_empty]
        if not out:
            return []
        if len(out) == 1:
            # every batch _apply_side emits is sign-pure (per-sign sub-batches,
            # flips are constant-diff), so a lone batch cannot net against itself
            return out
        merged = concat_batches(out)
        if merged is None:
            return []
        # unique_hint: a tick's matched output keys are (left, right)-pair
        # hashes, distinct within the tick except same-tick upserts — the
        # digest-free canonicalization almost always applies
        return [consolidate(merged, unique_hint=True)]


# ---------------------------------------------------------------------------- outputs


def _observe_sink_latency(node: Node, time: int) -> None:
    """End-to-end latency probe shared by the sinks: wall time from the
    oldest event ingested for this tick (stamped by ``StreamInputNode.poll``)
    to the tick's emission here — accumulated into the sink's log-bucketed
    histogram (``/metrics`` Prometheus histograms, ``/status`` quantiles)."""
    from pathway_tpu_torch.observability.metrics import run_metrics

    m = run_metrics()
    ingest_ns = m.tick_ingest_ns(time)
    if ingest_ns is None:
        return  # static tick / no live ingest stamped for this time
    m.observe_sink_latency(
        f"{node.name}:{node.node_index}",
        max(0.0, (_time_mod.time_ns() - ingest_ns) / 1e9),
    )


class SubscribeNode(Node):
    """``pw.io.subscribe`` (reference: ``io/_subscribe.py`` → ``subscribe_table``,
    ``src/engine/graph.rs:543``).

    Callbacks fire once per logical time with the tick's emissions
    CONSOLIDATED (net diffs per key+row), matching the reference's
    ``BatchWrapper`` per-time delivery — intra-tick churn (e.g. an as-of-now
    reply overwriting the query-tick padding, or a sweep-round partial that a
    later round corrects) is invisible to user callbacks."""

    name = "subscribe"

    #: sink marker + service class: the flow plane's AIMD controller reads
    #: latency histograms only from ``interactive``-class sinks (the ones the
    #: SLO governs); ``pw.io.subscribe(..., service_class="bulk")`` opts out
    is_sink = True

    def exchange_key(self, port):
        # default: sources/sinks live on worker 0. With ``route_by`` set
        # (shard-map zero-hop serving), callbacks instead fire on the worker
        # owning each row's route key — every process observes exactly its
        # own slice of the changelog, so N doors answer independently.
        return self.route_by if self.route_by is not None else SOLO

    def __init__(
        self,
        columns: list[str],
        on_change: Callable | None = None,
        on_time_end: Callable | None = None,
        on_end: Callable | None = None,
        route_by: Callable | None = None,
    ):
        super().__init__(n_inputs=1)
        self.service_class = "interactive"
        self.columns = columns
        self.on_change = on_change
        self.on_time_end = on_time_end
        self._on_end = on_end
        self.route_by = route_by
        self._pending: list[DeltaBatch] = []

    def process(self, inputs, time):
        batch = inputs[0]
        if batch is not None:
            aud = _audit.current()
            if aud is not None:
                # raw-side incremental digest: accumulated from the deltas as
                # they arrive, BEFORE the tick netting below — the shadow
                # audit's independent path through the consolidation machinery
                aud.on_sink_delta(self, batch)
            self._pending.append(batch)
        return []

    def on_tick_complete(self, time):
        if not self._pending:
            return
        batches, self._pending = self._pending, []
        # incremental tick netting: each emission is consolidated at its own
        # size and merged in O(overlap) — byte-identical to consolidating the
        # tick's whole concatenation (the merge_consolidated ≡
        # consolidate∘concat property, swept in tests/test_incremental_hot_path.py)
        net = None
        for b in batches:
            net = merge_consolidated(net, consolidate(b))
        aud = _audit.current()
        if aud is not None:
            # net-side fold + invariant checks + sampled shadow compare
            aud.on_sink_net(self, net, time)
        if net is not None and len(net) and self.on_change is not None:
            for key, diff, row in net.rows():
                row_dict = dict(zip(self.columns, row))
                self.on_change(
                    key=key, row=row_dict, time=time, is_addition=diff > 0
                )
        # on_time_end is a per-time commit signal: it fires whenever raw data
        # arrived this tick, even if consolidation nets to zero (a retract +
        # re-insert of identical rows still marks the time as processed);
        # only on_change is gated on the net batch
        if self.on_time_end is not None and time != END_OF_STREAM:
            self.on_time_end(time)
        _observe_sink_latency(self, time)

    def on_end(self):
        if self._on_end is not None:
            self._on_end()


class CaptureNode(Node):
    """Accumulates the final consolidated state (debug/compute_and_print) and the
    full stream of deltas (stream assertions).

    The tick path is O(1) per block: batches are parked columnar (they ARE the
    delta log) and folded lazily on access. ``current`` folds with one
    vectorized last-op-wins pass — identical to sequential per-row apply,
    since a key's final dict entry is exactly its LAST operation's effect
    (earlier sets/pops are overwritten) — and builds row tuples only for keys
    whose last op is an insert. ``deltas`` materializes row tuples only when a
    stream assertion actually reads them. The per-row dict loop this replaces
    was the single largest phase of the incremental bench (BASELINE
    §incremental: ~half the tick under churny groupby retract+insert output).
    """

    name = "capture"

    snapshot_attrs = ("current", "deltas")

    def exchange_key(self, port):
        return SOLO  # sources/sinks live on worker 0

    def __init__(self, columns: list[str]):
        super().__init__(n_inputs=1)
        self.columns = columns
        self._current: dict[int, tuple] = {}
        self._deltas: list[tuple[int, int, int, tuple]] = []  # (time, key, diff, row)
        self._batches: list[DeltaBatch] = []  # parked blocks, in arrival order
        self._cur_upto = 0  # _batches fold cursor for _current
        self._deltas_upto = 0  # _batches materialization cursor for _deltas

    def process(self, inputs, time):
        batch = inputs[0]
        if batch is None or batch.is_empty:
            return []
        self._batches.append(batch)
        return []

    def _fold_current(self) -> None:
        if self._cur_upto >= len(self._batches):
            return
        tok = _phases.start()
        bs = self._batches[self._cur_upto :]
        self._cur_upto = len(self._batches)
        if len(bs) == 1:
            keys, diffs, cols = bs[0].keys, bs[0].diffs, list(bs[0].data.values())
        else:
            keys = np.concatenate([b.keys for b in bs])
            diffs = np.concatenate([b.diffs for b in bs])
            cols = [
                concat_cols([b.data[n] for b in bs]) for n in bs[0].data.keys()
            ]
        n = len(keys)
        # last occurrence of each key across the concatenated (ordered) log
        uniq, rev_first = np.unique(keys[::-1], return_index=True)
        last = n - 1 - rev_first
        set_mask = diffs[last] > 0
        set_idx = last[set_mask]
        if len(set_idx):
            if cols:
                rows = zip(*(column_to_list(c[set_idx]) for c in cols))
            else:
                rows = iter([()] * len(set_idx))
            self._current.update(zip(uniq[set_mask].tolist(), rows))
        pops = uniq[~set_mask]
        if len(pops):
            cur = self._current
            for k in pops.tolist():
                cur.pop(k, None)
        self._prune_batches()
        _phases.stop(tok, "capture")

    def _materialize_deltas(self) -> None:
        if self._deltas_upto >= len(self._batches):
            return
        bs = self._batches[self._deltas_upto :]
        self._deltas_upto = len(self._batches)
        for batch in bs:
            keys = batch.keys.tolist()
            diffs = batch.diffs.tolist()
            if batch.data:
                rows = list(zip(*(column_to_list(c) for c in batch.data.values())))
            else:
                rows = [()] * len(keys)
            self._deltas.extend(zip([batch.time] * len(keys), keys, diffs, rows))
        self._prune_batches()

    def _prune_batches(self) -> None:
        """Drop parked blocks both folds have consumed — a long-running job
        that reads both ``current`` and ``deltas`` (e.g. every persistence
        snapshot) must not hold the delta log twice."""
        done = min(self._cur_upto, self._deltas_upto)
        if done:
            del self._batches[:done]
            self._cur_upto -= done
            self._deltas_upto -= done

    @property
    def current(self) -> dict[int, tuple]:
        self._fold_current()
        return self._current

    @property
    def deltas(self) -> list[tuple[int, int, int, tuple]]:
        self._materialize_deltas()
        return self._deltas

    def snapshot_state(self) -> dict | None:
        # materialized forms only: parked DeltaBatches stay out of snapshots
        return {"current": dict(self.current), "deltas": list(self.deltas)}

    def restore_state(self, state: dict) -> None:
        self._current = dict(state.get("current", {}))
        self._deltas = list(state.get("deltas", []))
        self._batches = []
        self._cur_upto = 0
        self._deltas_upto = 0


class CallbackOutputNode(Node):
    """Generic per-batch sink for io writers.

    ``sharded=True`` (r5) keeps each row's output on the worker owning its key
    shard instead of funneling everything to worker 0 — per-worker sink
    shards with an ordered merge-commit (see ``io/fs.py`` write(sharded=True);
    reference: per-worker writers, ``worker-architecture.md:36-47``)."""

    name = "output"

    is_sink = True  # flow controller SLO scope (see SubscribeNode)

    def exchange_key(self, port):
        if self.sharded:
            return lambda batch: batch.keys  # co-locate by row key shard
        return SOLO  # sources/sinks live on worker 0

    def __init__(
        self,
        columns: list[str],
        on_batch: Callable,
        on_done: Callable | None = None,
        sharded: bool = False,
        sink_state: Callable | None = None,
        restore_sink: Callable | None = None,
        service_class: str = "interactive",
    ):
        super().__init__(n_inputs=1)
        # flow plane SLO scope (see SubscribeNode): a bulk-class writer (e.g.
        # an fsync-bound audit mirror) must not drag the AIMD bucket down on
        # behalf of traffic that doesn't care about latency
        self.service_class = service_class
        self.columns = columns
        self.on_batch = on_batch
        self.on_done = on_done
        self.sharded = sharded
        # exactly-once hooks (r5, beating the reference's at-least-once OSS
        # tier, README.md:96 / src/persistence/state.rs:291): a sink that can
        # report a durable write position (sink_state) and rewind to it
        # (restore_sink) participates in operator snapshots — restart
        # truncates the output back to the snapshot cut, and the replayed
        # suffix re-emits each output row exactly once
        self.sink_state_fn = sink_state
        self.restore_sink_fn = restore_sink
        self._tick_buffer: list[DeltaBatch] = []

    def snapshot_state(self) -> dict | None:
        if self.sink_state_fn is None:
            return None
        return {"__sink__": self.sink_state_fn()}

    def restore_state(self, state: dict) -> None:
        if self.restore_sink_fn is not None and "__sink__" in state:
            self.restore_sink_fn(state["__sink__"])

    def process(self, inputs, time):
        # buffer within the tick; emission happens sorted at the frontier so the
        # written order is independent of worker count / block arrival order
        batch = inputs[0]
        if batch is not None and not batch.is_empty:
            aud = _audit.current()
            if aud is not None:
                aud.on_sink_delta(self, batch)  # raw-side digest (see SubscribeNode)
            self._tick_buffer.append(batch)
        return []

    def on_frontier(self, time):
        if self._tick_buffer:
            merged = concat_batches(self._tick_buffer)
            self._tick_buffer = []
            if merged is not None and not merged.is_empty:
                # net out same-tick churn (mid-tick corrections differ by worker
                # topology); consolidate returns canonical (key, diff) order, so
                # output is byte-identical for any thread/process layout
                merged = consolidate(merged)
            aud = _audit.current()
            if aud is not None:
                aud.on_sink_net(self, merged, time)
            if merged is not None and not merged.is_empty:
                self.on_batch(merged, self.columns)
                _observe_sink_latency(self, time)
        return []

    def on_end(self):
        self.on_frontier(END_OF_STREAM)
        if self.on_done is not None:
            self.on_done()
