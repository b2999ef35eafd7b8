"""Input snapshots + offsets + operator snapshots.

Block-engine counterpart of the reference's persistence core (``src/persistence/``):

- **Input snapshots** (``input_snapshot.rs:66,217``): every event a connector pushes
  into a ``StreamInputNode`` is appended to a per-source chunked event log; on
  restart the log replays into the node *before* live reading, and the stored
  event-count offset tells the (deterministic) source how many leading events to
  skip — the engine-level analogue of ``OffsetAntichain`` + ``seek``
  (``src/connectors/mod.rs:100-105``). Sources are identified by a stable
  persistent id: the logical node's user ``name`` or its graph position.
- **Metadata** (``state.rs:17,35``): per-source committed offset + last logical
  time, written on every flush; the restart point is what all sources have
  committed (single-process: the minimum is trivial).
- **Operator snapshots** (``operator_snapshot.rs:21,26,342``): in
  ``persistence_mode="operator_persisting"``, every stateful engine node
  (declared via ``Node.snapshot_attrs``) is pickled at snapshot ticks together
  with a manifest recording, per source, how many log events that state
  reflects (``StreamInputNode.polled_total`` — a quiesced engine has applied
  exactly the polled prefix). Restart restores node state, replays only the
  log suffix past the manifest offset, and seeks live sources — recovery is
  O(state + suffix), not O(history). Event-log chunks fully covered by the
  manifest offset are deleted (compaction), and a snapshot generation is only
  referenced by the manifest after all its node states are durable, so a crash
  mid-save falls back to the previous generation.

Consistency level: at-least-once on restart for plain sinks (SURVEY §5.3);
``delivery="exactly_once"`` sinks publish through the delivery ledger
(``pathway_tpu_torch/delivery``), bound here at restore.

Carried from ``pathway_tpu/persistence/snapshots.py`` for every runtime:
the single worker, the thread-sharded runtime (per-worker operator shards,
per-worker peer copies of partitioned sources) and the multi-process cluster
(per-process shard saves over barriers, partitioned peer inputs, the global
epoch manifest committed by process 0), with the elasticity plane's restores
(``PATHWAY_ELASTIC``): input logs rebucketed by key range or extended with
orphan workers' suffixes, operator shards dropped and recomputed by replay,
or migrated O(moved state) under the shard map. A snapshot pickles the
port's own classes and torch tensors; an index snapshot taken on the card
opens only where the card is.
"""

from __future__ import annotations

import pickle
import time as _time
from typing import Any

from pathway_tpu_torch.engine import operators as ops
from pathway_tpu_torch.persistence.backends import KVBackend, backend_from_config

_CHUNK = "chunk"
_META = "metadata"
_MANIFEST = "operators/manifest"
_EPOCH_MANIFEST = "epochs/manifest"


class _PersistedInput:
    """Wraps one StreamInputNode: logs pushes, skips re-read events on restart."""

    def __init__(
        self,
        pid: str,
        node: ops.StreamInputNode,
        backend: KVBackend,
        live_after_replay: bool = True,
        subject: Any = None,
        replay_skip: int = 0,
    ):
        self.pid = pid
        self.node = node
        self.backend = backend
        self.live_after_replay = live_after_replay
        # seekable sources (offset_state/seek, e.g. Kafka partitions) restart by
        # seeking past the persisted offsets instead of dropping a replayed
        # event-count prefix — the prefix-drop is only sound for sources that
        # re-produce events in identical order
        self.subject = subject
        self.seekable = subject is not None and hasattr(subject, "seek") and hasattr(
            subject, "offset_state"
        )
        self.reader_state: Any = None
        self.buffer: list[tuple[int, tuple | None, int]] = []
        self.stored_offset = 0  # events already persisted (skip this many live)
        self.seen_live = 0
        self.n_chunks = 0
        self.first_chunk = 0  # chunks below this were compacted away
        self.trimmed_events = 0  # events contained in compacted chunks
        self.chunk_sizes: list[int] = []  # sizes of chunks [first_chunk, n_chunks)
        self.resharded = False  # log was key-range rebucketed by a rescale
        # events appended from ORPHAN workers' logs by a scale-in migration
        # (elastic/reshard.adopt_orphan_suffixes) — foreign to this log's live
        # subject, so they must not count toward its prefix-drop offset
        self.foreign_events = 0
        self._load_metadata()
        self.persisted = self.stored_offset
        # operator snapshots: state already covers this absolute log prefix
        self.replay_skip = min(replay_skip, self.persisted)
        if self.seekable:
            if self.reader_state is not None:
                subject.seek(self.reader_state)
            self.stored_offset = 0  # seek replaces the prefix-drop entirely
        elif self.foreign_events and self.stored_offset and not self.resharded:
            # adopted-suffix log: the subject re-produces only its OWN rows, so
            # the exact drop count is the persisted total minus the adopted
            # foreign rows — the subject's slice stays exactly-once across the
            # rescale (the foreign rows replay from the log; their reassigned
            # live partitions are at-least-once, see adopt_orphan_suffixes)
            self.stored_offset = max(0, self.stored_offset - self.foreign_events)
        elif self.resharded and self.stored_offset:
            # the rebucketed log holds a KEY-RANGE slice; the subject's live
            # slice follows its own (changed) partition map, so the
            # count-based prefix-drop would discard never-logged rows.
            # Disable it — at-least-once across this one edge (replayed rows
            # the subject re-produces may duplicate), matching the
            # seek-state-dropped posture and WARNED, never silent
            from pathway_tpu_torch.internals.telemetry import record_event

            record_event("elastic.reshard_prefix_drop_disabled", source=self.pid)
            import logging

            logging.getLogger(__name__).warning(
                "elastic reshard: input log %r was re-bucketed by key range; "
                "the live prefix-drop is disabled for this non-seekable "
                "partitioned source (at-least-once across the rescale)",
                self.pid,
            )
            self.stored_offset = 0
        self._install()

    # -- storage ------------------------------------------------------------
    def _key(self, name: str) -> str:
        return f"inputs/{self.pid}/{name}"

    def _load_metadata(self) -> None:
        raw = self.backend.get(self._key(_META))
        if raw is not None:
            meta = pickle.loads(raw)
            self.stored_offset = meta["offset"]
            self.n_chunks = meta["chunks"]
            self.reader_state = meta.get("reader")
            self.first_chunk = meta.get("first_chunk", 0)
            self.trimmed_events = meta.get("trimmed_events", 0)
            self.chunk_sizes = meta.get("chunk_sizes", [])
            self.resharded = meta.get("resharded", False)
            self.foreign_events = meta.get("foreign_events", 0)
            if len(self.chunk_sizes) != self.n_chunks - self.first_chunk:
                # metadata predates size tracking: reconstruct from the chunks
                # themselves so trim() never mis-accounts legacy storage
                self.chunk_sizes = []
                for i in range(self.first_chunk, self.n_chunks):
                    c = self.backend.get(self._key(f"{_CHUNK}_{i:08d}"))
                    self.chunk_sizes.append(len(pickle.loads(c)) if c is not None else 0)

    def _flush_metadata(self) -> None:
        self.backend.put(
            self._key(_META),
            pickle.dumps(
                {
                    "offset": self.persisted,
                    "chunks": self.n_chunks,
                    "reader": self.reader_state,
                    "first_chunk": self.first_chunk,
                    "trimmed_events": self.trimmed_events,
                    "chunk_sizes": self.chunk_sizes,
                    # rescale bookkeeping must survive a live flush, or the
                    # NEXT restart would mis-drop this subject's prefix
                    "resharded": self.resharded,
                    "foreign_events": self.foreign_events,
                }
            ),
        )

    def replay(self) -> int:
        """Push the stored event log into the node (before live reads start) —
        through the ORIGINAL push so replay isn't counted as live traffic.
        With an operator snapshot, only the suffix past ``replay_skip`` runs.
        Returns the number of events actually replayed (the O(suffix) part of
        recovery — the resilience telemetry and tests assert on it)."""
        to_skip = self.replay_skip - self.trimmed_events
        replayed = 0
        for i in range(self.first_chunk, self.n_chunks):
            raw = self.backend.get(self._key(f"{_CHUNK}_{i:08d}"))
            if raw is None:
                # chunk deleted by trim() but the crash hit before its metadata
                # flush: consume its skip credit so later chunks stay aligned
                # (trim only ever deletes fully-consumed chunks)
                size = self.chunk_sizes[i - self.first_chunk]
                to_skip = max(0, to_skip - size)
                continue
            events = pickle.loads(raw)
            if to_skip >= len(events):
                to_skip -= len(events)
                continue
            tail = events[to_skip:]
            append = getattr(self.node, "_append_events", None)
            if append is not None:
                # bulk append, BYPASSING the flow plane's credit gate: replay
                # runs on the main thread before the tick loop starts, so a
                # gated push would wait forever for tick-completion credits
                # (block policy) or shed committed history (shed policy) —
                # the log suffix already bounds replay memory
                append([(int(k), v, d) for k, v, d in tail])
            else:
                for key, values, diff in tail:
                    self._original_push(key, values, diff)
            replayed += len(tail)
            to_skip = 0
        return replayed

    def flush(self) -> None:
        # for seekable sources, buffer capture + reader-state read happen under
        # the subject's sync_lock so the stored offsets exactly cover the
        # persisted events (no torn batch on crash)
        lock = getattr(self.subject, "sync_lock", None) if self.seekable else None
        if lock is not None:
            with lock:
                if not self.buffer:
                    return
                chunk, self.buffer = self.buffer, []
                self.reader_state = self.subject.offset_state()
        else:
            if not self.buffer:
                return
            chunk, self.buffer = self.buffer, []
        self.backend.put(
            self._key(f"{_CHUNK}_{self.n_chunks:08d}"), pickle.dumps(chunk)
        )
        self.chunk_sizes.append(len(chunk))
        self.n_chunks += 1
        self.persisted += len(chunk)
        self._flush_metadata()

    def consumed(self) -> int:
        """Absolute log-event count the engine has applied (valid when the
        engine is quiesced, i.e. at tick boundaries)."""
        return self.replay_skip + self.node.polled_total

    def trim(self, consumed: int) -> None:
        """Delete log chunks fully covered by an operator snapshot at
        ``consumed`` (compaction; ``operator_snapshot.rs:342`` semantics)."""
        changed = False
        while self.first_chunk < self.n_chunks and self.chunk_sizes:
            size = self.chunk_sizes[0]
            if self.trimmed_events + size > consumed:
                break
            self.backend.delete(self._key(f"{_CHUNK}_{self.first_chunk:08d}"))
            self.trimmed_events += size
            self.first_chunk += 1
            self.chunk_sizes.pop(0)
            changed = True
        if changed:
            self._flush_metadata()

    # -- node wrapping ------------------------------------------------------
    def _install(self) -> None:
        original_push = self.node.push
        self._original_push = original_push
        me = self

        def push(key: int, values: tuple | None, diff: int = 1) -> None:
            me.seen_live += 1
            if me.seen_live <= me.stored_offset:
                return  # already replayed from the snapshot; deterministic
                # sources re-produce their prefix — drop it (offset seek)
            if not me.live_after_replay:
                return  # replay-only run (continue_after_replay=False):
                # the recording is the whole input; live traffic is ignored
            me.buffer.append((key, values, diff))
            original_push(key, values, diff)

        def push_many(events) -> None:
            for key, values, diff in events:
                push(key, values, diff)

        self.node.push = push  # type: ignore[method-assign]
        self.node.push_many = push_many  # type: ignore[method-assign]
        # this log captures events before the flow plane's credit gate; the
        # gate must stand down on logged nodes (offset-arithmetic + lock
        # ordering — see StreamInputNode._push_gated)
        self.node.flow_ungated = True


class SnapshotStore:
    """Stable-keyed auxiliary chunk store for INCREMENTAL operator snapshots.

    Generation entries are deleted wholesale when the next generation commits,
    which forces every node to re-pickle its entire state each snapshot tick —
    exactly the ~1.5 GB/interval tax the index plane pays at 1M×384. Nodes that declare ``uses_snapshot_store = True``
    instead write named chunks under a per-(worker, node) prefix that SURVIVES
    generations (a compacted base + delta chunks), and their generation entry
    holds only a small manifest naming the chunks it needs.

    Durability contract mirrors the input-log path: chunks are written in
    ``save_shards`` (before the manifest commit), and chunks no longer
    referenced by the new state are deleted only AFTER the commit is durable
    (``_OperatorSnapshots.flush_aux_gc``) — a crash mid-save leaves the
    previous generation's chunk set fully intact, and a crash between commit
    and GC only delays deletion.
    """

    def __init__(self, backend: KVBackend, prefix: str):
        self.backend = backend
        self.prefix = prefix
        self.referenced: set[str] = set()
        self.put_bytes = 0  # bytes written this snapshot tick (tests/bench)

    def put_chunk(self, name: str, payload: bytes) -> None:
        key = self.prefix + name
        self.backend.put(key, payload)
        self.referenced.add(key)
        self.put_bytes += len(payload)

    def get_chunk(self, name: str) -> bytes | None:
        return self.backend.get(self.prefix + name)

    def reference(self, name: str) -> None:
        """Mark a chunk as still needed by the state being saved (kept at GC)."""
        self.referenced.add(self.prefix + name)


class _OperatorSnapshots:
    """Generation-addressed node-state store + manifest."""

    def __init__(self, backend: KVBackend, interval_s: float):
        self.backend = backend
        self.interval_s = interval_s
        self.manifest = self._load_manifest()
        self.gen = (self.manifest["gen"] + 1) if self.manifest else 0
        self._last_save = _time.monotonic()
        # SnapshotStores whose unreferenced chunks await post-commit deletion
        self._pending_gc: list[SnapshotStore] = []

    def _load_manifest(self) -> dict | None:
        raw = self.backend.get(_MANIFEST)
        return pickle.loads(raw) if raw is not None else None

    def due(self) -> bool:
        # interval<=0: snapshot only at close (pickling whole join/groupby
        # state every tick would put O(state) on the hot path)
        if self.interval_s <= 0:
            return False
        return _time.monotonic() - self._last_save >= self.interval_s

    def validate(self, signature: list) -> bool:
        """A changed graph shape invalidates operator snapshots (node identity
        is positional). The signature covers node names, arities, output
        columns and wiring — NOT operator parameters (a changed filter
        constant or reducer expression with identical shape is the user's
        responsibility, as in the reference's persistent-id contract)."""
        return self.manifest is not None and self.manifest.get("node_names") == signature

    def stored_workers(self) -> int:
        return self.manifest.get("n_workers", 1) if self.manifest else 1

    def restore(self, worker_nodes: dict[int, list]) -> None:
        """Per-worker state restore (reference: every worker's operators are
        wrapped individually, ``dataflow/persist.rs:843``). State shards are
        positional per (worker, node), so worker count must match — checked
        by the caller against the manifest. Stores written before per-worker
        layout (manifest without ``n_workers``) used un-prefixed node keys;
        they are single-worker by construction (the old code refused
        multi-worker runtimes) and restore through the legacy path."""
        g = self.manifest["gen"]
        legacy = "n_workers" not in self.manifest
        for w, nodes in worker_nodes.items():
            for node in nodes:
                key = (
                    f"operators/gen_{g:08d}/node_{node.node_index:05d}"
                    if legacy
                    else f"operators/gen_{g:08d}/worker_{w:03d}/node_{node.node_index:05d}"
                )
                raw = self.backend.get(key)
                if raw is not None:
                    state = pickle.loads(raw)
                    if getattr(node, "uses_snapshot_store", False):
                        node.restore_state_store(state, self._aux_store(w, node))
                    else:
                        node.restore_state(state)

    def _aux_store(self, worker: int, node) -> SnapshotStore:
        """Generation-independent chunk store for one (worker, node) shard.
        ``operators/aux/`` is disjoint from ``operators/gen_*/`` so the
        generation GC in :meth:`commit` never touches it."""
        return SnapshotStore(
            self.backend,
            f"operators/aux/worker_{worker:03d}/node_{node.node_index:05d}/",
        )

    def save_shards(self, worker_nodes: dict[int, list]) -> None:
        """Write this process's worker shards for the CURRENT generation
        (no commit yet — the manifest is the only commit point)."""
        g = self.gen
        for w, nodes in worker_nodes.items():
            for node in nodes:
                if getattr(node, "uses_snapshot_store", False):
                    store = self._aux_store(w, node)
                    state = node.snapshot_state_store(store)
                    self._pending_gc.append(store)
                else:
                    state = node.snapshot_state()
                if state is None:
                    continue
                self.backend.put(
                    f"operators/gen_{g:08d}/worker_{w:03d}/node_{node.node_index:05d}",
                    pickle.dumps(state),
                )

    def flush_aux_gc(self) -> None:
        """Delete auxiliary chunks no longer referenced by the committed
        state (covered delta chunks after a base compaction, plus any orphans
        from a crash mid-save). Called only after the manifest commit is
        durable — before that, the previous generation still needs them."""
        for store in self._pending_gc:
            for k in self.backend.list_keys(store.prefix):
                if k not in store.referenced:
                    self.backend.delete(k)
        self._pending_gc = []

    def commit(
        self,
        node_names: list,
        input_offsets: dict[str, int],
        tick: int,
        n_workers: int,
        shardmap_version: int | None = None,
    ) -> None:
        """Publish the current generation (single writer — worker/process 0)
        and garbage-collect the previous one. ``shardmap_version`` pins which
        committed shard map placed these shards, so a later O(moved-state)
        migration can diff exactly from it."""
        g = self.gen
        self.backend.put(
            _MANIFEST,
            pickle.dumps(
                {
                    "gen": g,
                    "tick": tick,
                    "input_offsets": input_offsets,
                    "node_names": node_names,
                    "n_workers": n_workers,
                    "shardmap_version": shardmap_version,
                }
            ),
        )
        if g > 0:
            for k in self.backend.list_keys(f"operators/gen_{g - 1:08d}/"):
                self.backend.delete(k)

    def advance(self) -> None:
        self.gen += 1
        self._last_save = _time.monotonic()

    def save(
        self,
        worker_nodes: dict[int, list],
        node_names: list,
        input_offsets: dict[str, int],
        tick: int,
    ) -> None:
        """Single-process path: snapshot every worker's node shards at a
        quiesced tick boundary, then commit.

        The global-consistency argument mirrors the reference's finalized-time
        consensus (``src/persistence/state.rs:291``): this runs from
        ``on_tick_done``, after ``run_tick`` has drained every worker and the
        barrier rounds found no pending work anywhere — so all workers' state
        reflects exactly the same input prefix (the one ``input_offsets``
        records), and a single manifest commit covers all shards atomically.
        """
        self.save_shards(worker_nodes)
        self.commit(node_names, input_offsets, tick, len(worker_nodes))
        self.flush_aux_gc()
        self.advance()


class _EpochLog:
    """Global checkpoint-epoch manifest (resilience subsystem).

    The reference's restart point is the min-over-workers finalized time
    (``src/persistence/state.rs:291``); here it is the newest FULLY-committed
    epoch: a record process 0 publishes only after every process has reported
    its input-log flushes (and, in operator mode, its state shards) durable.
    Supervisors (``resilience.Supervisor``) and operators read it through
    ``resilience.last_committed_epoch`` to know where a relaunch resumes."""

    def __init__(self, backend: KVBackend):
        self.backend = backend
        prev = read_epoch_manifest(backend)
        self.epoch = prev["epoch"] if prev else -1
        self._last_offsets: dict | None = prev["input_offsets"] if prev else None

    def commit(
        self,
        tick: int,
        offsets: dict[str, int],
        *,
        opsnap_gen: int | None = None,
        acks: list[int] | None = None,
        force: bool = False,
    ) -> bool:
        """Publish a new epoch when the durable input frontier moved (or a new
        operator generation committed). Returns True when an epoch was written."""
        if not force and offsets == self._last_offsets and opsnap_gen is None:
            return False
        self.epoch += 1
        self._last_offsets = dict(offsets)
        self.backend.put(
            _EPOCH_MANIFEST,
            pickle.dumps(
                {
                    "epoch": self.epoch,
                    "tick": tick,
                    "input_offsets": dict(offsets),
                    "opsnap_gen": opsnap_gen,
                    "acks": sorted(acks) if acks is not None else [0],
                    "committed_unix": _time.time(),
                }
            ),
        )
        from pathway_tpu_torch.internals.telemetry import record_event

        record_event(
            "resilience.epoch_committed",
            epoch=self.epoch,
            tick=tick,
            opsnap_gen=opsnap_gen if opsnap_gen is not None else -1,
            n_inputs=len(offsets),
        )
        from pathway_tpu_torch import observability as _obs

        tracer = _obs.current()
        if tracer is not None:
            tracer.event(
                "persist/epoch_commit",
                **{
                    "pathway.epoch": self.epoch,
                    "pathway.tick": tick,
                    "pathway.n_inputs": len(offsets),
                },
            )
        return True


def read_epoch_manifest(backend_or_config) -> dict | None:
    """Newest fully-committed epoch record, or None. Accepts a raw KVBackend,
    a ``persistence.Backend``, or a ``persistence.Config``."""
    backend = backend_or_config
    if hasattr(backend, "backend") and not isinstance(backend, KVBackend):
        backend = backend.backend  # Config → Backend
    if not isinstance(backend, KVBackend):
        backend = backend_from_config(backend)  # Backend → KVBackend
    raw = backend.get(_EPOCH_MANIFEST)
    return pickle.loads(raw) if raw is not None else None


class Persistence:
    def __init__(self, config, runtime=None):
        self.config = config
        self.runtime = runtime
        self.backend = backend_from_config(config.backend)
        self.operator_mode = config.persistence_mode == "operator_persisting"
        self.inputs: list[_PersistedInput] = []
        self.opsnap: _OperatorSnapshots | None = None
        self.epochs: _EpochLog | None = None
        #: exactly-once delivery plane — bound on process 0 / the solo
        #: runtime when any sink writer opted into delivery="exactly_once"
        self.delivery = None
        self.replayed_events = 0
        self._worker_nodes: dict[int, list] = {}
        self._node_names: list = []
        self._is_cluster = False
        self._pid = 0
        self._total_workers = 1
        #: (stored workers, current workers) when this restore resharded by
        #: replay instead of restoring positional shards (PATHWAY_ELASTIC)
        self._reshard_restore: tuple[int, int] | None = None
        #: (old map, new map) when this restore migrates O(moved state) per the
        #: shard-map diff (PATHWAY_SHARDMAP_MIGRATION) — resolved once, used by
        #: BOTH the input-log step and the operator-shard step so every process
        #: takes the same path (the decision is deterministic from shared
        #: backend state + env, so no extra barrier is needed)
        self._migrate_plan: tuple | None = None
        self._migrate_checked = False
        #: every persisted node of the CURRENT graph supports keyed/solo
        #: migration — the condition under which elastic input-log trim is
        #: sound again (a future rescale will never need the full history)
        self._migratable_graph = False

    # called by Runtime once the engine graph is built, before drivers start
    def on_graph_built(self, ctx) -> None:
        offsets: dict[str, int] = {}
        # cluster detection happens for EVERY persistence mode (not just
        # operator persisting): peers must take the partitioned-peer path
        # below or they would clobber process 0's input logs in the shared
        # backend, and the per-tick epoch barrier needs symmetric membership
        cluster_workers = getattr(self.runtime, "local_workers", None)
        if cluster_workers is not None:
            self._is_cluster = True
            self._pid = self.runtime.pid
            self._total_workers = self.runtime.n_workers
        else:
            # thread-sharded runtimes: the worker count must be known BEFORE
            # the elastic input-log scan below — with the 1-worker default a
            # same-shape restart would misread every @w partition log as
            # orphaned and rebucket (duplicating) perfectly healthy history
            workers = getattr(self.runtime, "workers", None)
            if workers:
                self._total_workers = len(workers)
        if self._pid == 0:
            # single-writer plane: only process 0 (or the solo runtime)
            # commits epoch manifests; peers report durability over the barrier
            self.epochs = _EpochLog(self.backend)
        # elasticity (PATHWAY_ELASTIC != off): partitioned input logs owned by
        # workers the new shape no longer has would otherwise never replay —
        # re-bucket them across the new worker set by key range BEFORE any
        # input wrapping reads them. Single writer (process 0 / the solo
        # runtime); cluster peers wait on a barrier.
        from pathway_tpu_torch import elastic as _elastic

        if _elastic.reshard_enabled():
            self._elastic_reshard_inputs()
        if self.operator_mode:
            # worker shards keyed by GLOBAL worker index: the single runtime is
            # {0: nodes}, the thread-sharded runtime {0..W-1}, and a cluster
            # process contributes only the workers it hosts (every process
            # snapshots/restores its own shards; process 0 commits)
            local_workers = cluster_workers
            workers = getattr(self.runtime, "workers", None)
            if local_workers is not None:
                self._worker_nodes = {
                    gi: list(lw.graph.nodes) for gi, lw in local_workers.items()
                }
            elif workers:
                self._worker_nodes = {w.index: list(w.graph.nodes) for w in workers}
                self._total_workers = len(workers)
            else:
                self._worker_nodes = {0: list(ctx.graph.nodes)}
                self._total_workers = 1
            # nodes with incremental (chunk-store) snapshots start recording
            # their mutation delta logs only under operator persistence WITH a
            # periodic snapshot cadence — a non-persisted run (or a
            # snapshot-at-close run, interval <= 0, whose single save could
            # otherwise sit behind an O(total mutations) log) must not
            # accumulate one; at-close saves write a fresh compacted base
            # instead. Enabled BEFORE restore/replay so post-snapshot replay
            # ops are captured for the next delta chunk.
            if self.config.snapshot_interval_ms > 0:
                for nodes in self._worker_nodes.values():
                    for n in nodes:
                        if getattr(n, "uses_snapshot_store", False):
                            n.snapshot_log_enabled = True
            self._node_names = [
                (
                    n.name,
                    n.n_inputs,
                    tuple(getattr(n, "columns", None) or getattr(n, "out_columns", []) or []),
                    tuple(ctx.graph.edges.get(n.node_index, [])),
                )
                for n in next(iter(self._worker_nodes.values()))
            ]
            from pathway_tpu_torch import elastic as _elastic2

            self._migratable_graph = (
                _elastic2.migration_enabled()
                and getattr(self.runtime, "shardmap", None) is not None
                and self._nodes_migratable(
                    next(iter(self._worker_nodes.values()))
                )
            )
            self.opsnap = _OperatorSnapshots(
                self.backend, self.config.snapshot_interval_ms / 1000.0
            )
            if self.opsnap.manifest is not None:
                if not self.opsnap.validate(self._node_names):
                    # operator snapshots are positional AND compaction already
                    # dropped the consumed log prefix — a different graph can
                    # neither restore nor recompute; refuse loudly instead of
                    # silently losing the compacted history
                    raise RuntimeError(
                        "operator_persisting: persisted snapshots were taken "
                        "for a different pipeline graph "
                        f"(stored {self.opsnap.manifest.get('node_names')}, "
                        f"current {self._node_names}); clear the persistence "
                        "storage or revert the pipeline change"
                    )
                if self.opsnap.stored_workers() != self._total_workers:
                    plan = self._migration_mode()
                    if plan is not None:
                        # O(moved-state): keep the manifest offsets so replay
                        # stays O(suffix), move only re-mapped ranges' shards
                        offsets = self._elastic_migrate_opsnap(*plan)
                    else:
                        self._elastic_reshard_opsnap()
                else:
                    offsets = dict(self.opsnap.manifest["input_offsets"])
                    self.opsnap.restore(self._worker_nodes)
        if self._is_cluster and self._pid != 0:
            # non-partitioned sources poll only on process 0; partitioned
            # sources DO live on peer processes — persist those locally
            # (worker-scoped pids in the shared backend; seekable subjects
            # recover by seeking, the at-least-once OSS tier)
            self._add_partitioned_peer_inputs(offsets)
            self._replay_all()
            return
        # exactly-once delivery: bind ledger writers AFTER the operator
        # restore above (restore_sink has delivered each sink's snapshot cut)
        # and BEFORE replay queues any input — binding discards orphan staged
        # epochs past the cut and resumes publication of frozen epochs the
        # previous process died before handing to the sink. Sinks are SOLO
        # (global worker 0), so only process 0 / the solo runtime binds.
        self._bind_delivery(ctx)
        # pid stability: a source keeps its snapshots across unrelated pipeline
        # edits — use the connector's name alone when unique among sources, and
        # only disambiguate same-named sources by their order among sources
        sources = [
            (lnode, node)
            for lnode, node in ctx.build_order
            if isinstance(node, ops.StreamInputNode)
        ]
        name_counts: dict[str, int] = {}
        for lnode, _ in sources:
            name_counts[lnode.name] = name_counts.get(lnode.name, 0) + 1
        seen: dict[str, int] = {}
        pid_by_index: dict[int, str] = {}  # node_index -> pid (for peer copies)
        for lnode, node in sources:
            if name_counts[lnode.name] == 1:
                pid = lnode.name
            else:
                i = seen.get(lnode.name, 0)
                seen[lnode.name] = i + 1
                pid = f"{lnode.name}-{i}"
            pid_by_index[node.node_index] = pid
            self.inputs.append(
                _PersistedInput(
                    pid,
                    node,
                    self.backend,
                    live_after_replay=getattr(self.config, "continue_after_replay", True),
                    subject=self._subject_of(node),
                    replay_skip=offsets.get(pid, 0),
                )
            )
        # partitioned sources also poll on workers 1..W-1 of a thread-sharded
        # runtime (worker graphs align by node_index); each peer copy gets a
        # worker-scoped pid so its partition offsets persist independently
        workers = getattr(self.runtime, "workers", None) or []
        peer_graphs = [(w.index, w.graph) for w in workers[1:]]
        # cluster process 0 may host local workers beyond global worker 0
        local_workers = getattr(self.runtime, "local_workers", None) or {}
        peer_graphs += [(gi, lw.graph) for gi, lw in local_workers.items() if gi != 0]
        for w_idx, graph in peer_graphs:
            for node in graph.nodes:
                if getattr(node, "local_source", False) and node.node_index in pid_by_index:
                    pid = f"{pid_by_index[node.node_index]}@w{w_idx}"
                    self.inputs.append(
                        _PersistedInput(
                            pid,
                            node,
                            self.backend,
                            live_after_replay=getattr(
                                self.config, "continue_after_replay", True
                            ),
                            subject=self._subject_of(node),
                            replay_skip=offsets.get(pid, 0),
                        )
                    )
        self._replay_all()

    def _elastic_reshard_inputs(self) -> None:
        """Re-own orphaned partitioned input logs under the new worker count
        (elasticity plane). Runs on every restore while PATHWAY_ELASTIC is
        enabled; a no-op scan when the layout already matches.

        Under an O(moved-state) migration (``_migration_mode``) the full
        key-range rebucket is replaced by :func:`elastic.adopt_orphan_suffixes`
        — only the orphan workers' log SUFFIXES past the snapshot offsets move
        (their prefixes are already reflected in the operator shards that
        migrate), so this step is O(suffix) instead of O(history)."""
        from pathway_tpu_torch import elastic as _elastic

        if self._pid == 0:
            if self._migration_mode() is not None:
                manifest = pickle.loads(self.backend.get(_MANIFEST))
                self._migrate_input_stats = _elastic.adopt_orphan_suffixes(
                    self.backend,
                    self._total_workers,
                    manifest.get("input_offsets", {}),
                )
            else:
                orphans = _elastic.orphan_workers(self.backend, self._total_workers)
                if orphans:
                    old = max(max(v) for v in orphans.values()) + 1
                    stats = _elastic.reshard_input_logs(
                        self.backend,
                        self._total_workers,
                        shard_map=getattr(self.runtime, "shardmap", None),
                    )
                    _elastic.note_reshard_restore(old, self._total_workers, stats)
        if self._is_cluster:
            # peers must not wrap inputs until the coordinator's rebucket is
            # durable; symmetric barrier (reshard_enabled is env-driven, so
            # every process takes this path or none does)
            self.runtime._barrier(
                ("elastic_reshard", self._pid, {}), lambda reports: {"ok": True}
            )

    def _template_nodes(self) -> list | None:
        """One worker's node list (graphs align by ``node_index`` across
        workers AND processes), available before ``_worker_nodes`` is built."""
        local_workers = getattr(self.runtime, "local_workers", None)
        if local_workers:
            return list(next(iter(local_workers.values())).graph.nodes)
        workers = getattr(self.runtime, "workers", None)
        if workers:
            return list(workers[0].graph.nodes)
        return None

    @staticmethod
    def _nodes_migratable(template: list, indices: set | None = None) -> bool:
        """Every (relevant) node supports keyed or solo migration. With
        ``indices`` — the node positions that actually have stored shards —
        only those can block; without it (the input-log trim gate, where the
        future rescale's shard set is unknown) any node that would persist
        state must support migration."""
        for n in template:
            if indices is not None:
                if n.node_index not in indices:
                    continue
            else:
                try:
                    if (
                        not getattr(n, "uses_snapshot_store", False)
                        and n.snapshot_state() is None
                    ):
                        continue  # provably stateless — cannot block
                except Exception:
                    pass  # can't prove stateless: require migration support
            if getattr(n, "uses_snapshot_store", False):
                # aux chunk stores (index plane) are positional by
                # construction — no keyed migration yet
                return False
            if n.migrate_mode() is None:
                return False
        return True

    def _migration_mode(self) -> tuple | None:
        """``(old map, new map)`` when this restore migrates O(moved state)
        instead of resharding by replay, else None. The answer is
        deterministic from shared backend state + env + the (aligned) graph,
        so every process resolves the same path with no extra barrier."""
        if self._migrate_checked:
            return self._migrate_plan
        self._migrate_checked = True
        from pathway_tpu_torch import elastic as _elastic
        from pathway_tpu_torch.internals import shardmap as _shardmap
        from pathway_tpu_torch.internals.telemetry import record_event

        if not self.operator_mode or not _elastic.migration_enabled():
            return None
        new_map = getattr(self.runtime, "shardmap", None)
        if new_map is None or new_map.n_workers != self._total_workers:
            return None
        raw = self.backend.get(_MANIFEST)
        if raw is None:
            return None  # nothing persisted: nothing to migrate
        manifest = pickle.loads(raw)
        stored = manifest.get("n_workers", 1)
        if stored == self._total_workers:
            return None  # same shape: plain positional restore
        smv = manifest.get("shardmap_version")
        old_map = (
            _shardmap.read_shardmap_version(self.backend, smv)
            if smv is not None
            else None
        )
        if old_map is None or old_map.n_workers != stored:
            # the previous shape ran without the shard-map plane (or its map
            # history is gone) — its placement cannot be reconstructed, so the
            # general replay path must recompute
            return None
        template = self._template_nodes()
        if template is None:
            return None
        g = manifest["gen"]
        indices: set[int] = set()
        for k in self.backend.list_keys(f"operators/gen_{g:08d}/"):
            tail = k.rsplit("node_", 1)
            if len(tail) == 2:
                try:
                    indices.add(int(tail[1]))
                except ValueError:
                    pass
        if not self._nodes_migratable(template, indices):
            record_event(
                "elastic.migrate_unsupported",
                old_workers=stored,
                new_workers=self._total_workers,
                process_id=self._pid,
            )
            return None
        self._migrate_plan = (old_map, new_map)
        return self._migrate_plan

    def _elastic_migrate_opsnap(self, old_map, new_map) -> dict:
        """O(moved-state) restore for a worker-count change: keep the manifest
        offsets (replay stays O(suffix)!) and rebuild each LOCAL worker's node
        state from the old generation's shards — positionally for solo nodes,
        by filtered merge of the shard-map-overlapping old shards for keyed
        nodes. The old generation is only read, never written: a crash before
        the next commit re-runs the (idempotent) migration; the next commit's
        generation GC reclaims it."""
        import numpy as np

        from pathway_tpu_torch import elastic as _elastic
        from pathway_tpu_torch.internals import shardmap as _shardmap

        t0 = _time.monotonic()
        manifest = self.opsnap.manifest
        g = manifest["gen"]
        stored = self.opsnap.stored_workers()
        moved = _shardmap.diff(old_map, new_map)
        rows_moved = 0
        bytes_moved = 0

        def entry_count(st: dict) -> int:
            n = 0
            for v in st.values():
                if isinstance(v, dict) and all(
                    isinstance(x, (int, np.integer)) for x in list(v)[:3]
                ):
                    n += len(v)  # key-addressed entries (state/_state dicts)
            cst = st.get("cstate")
            if isinstance(cst, dict) and "gk" in cst:
                n += len(cst["gk"])
            return n

        for w, nodes in self._worker_nodes.items():
            overlap = _shardmap.overlap_sources(old_map, new_map, w)

            def keep(keys, _w=w):
                arr = np.asarray(keys, dtype=np.uint64)
                return new_map.owner_of_keys(arr) == _w

            for node in nodes:
                mode = node.migrate_mode()
                if mode == "solo":
                    # serial operator: its single shard lives on global worker
                    # 0 under EVERY shape — positional restore there
                    if w != 0:
                        continue
                    raw = self.backend.get(
                        f"operators/gen_{g:08d}/worker_{0:03d}"
                        f"/node_{node.node_index:05d}"
                    )
                    if raw is not None:
                        node.restore_state(pickle.loads(raw))
                    continue
                if mode != "keyed":
                    continue  # no stored shard (guaranteed by _migration_mode)
                srcs = (
                    overlap
                    if getattr(node, "migrate_aligned", True)
                    else range(stored)
                )
                shards: list[dict] = []
                for ow in srcs:
                    raw = self.backend.get(
                        f"operators/gen_{g:08d}/worker_{ow:03d}"
                        f"/node_{node.node_index:05d}"
                    )
                    if raw is None:
                        continue
                    st = pickle.loads(raw)
                    shards.append(st)
                    if int(ow) != w:
                        bytes_moved += len(raw)
                        rows_moved += entry_count(st)
                if not shards:
                    continue
                state = node.migrate_restore(shards, keep)
                if state is not None:
                    node.restore_state(state)

        in_stats = getattr(self, "_migrate_input_stats", None)
        if in_stats is not None:
            rows_moved += in_stats.rows_moved
            bytes_moved += in_stats.bytes_moved
        pause_s = _time.monotonic() - t0
        _elastic.note_migrate_restore(
            stored,
            self._total_workers,
            _shardmap.moved_fraction(old_map, new_map),
            rows_moved,
            bytes_moved,
            len(moved),
            pause_s,
        )
        return dict(manifest["input_offsets"])

    def _elastic_reshard_opsnap(self) -> None:
        """Worker count changed under operator persistence: positional shards
        cannot restore into a different worker set. With PATHWAY_ELASTIC
        enabled, reshard by replay — drop the shards and let the (untrimmed;
        elastic mode suspends log compaction) input logs recompute every
        operator's state, each replayed row re-routed by the new shard map.
        Without it, refuse loudly (the contract without elasticity)."""
        from pathway_tpu_torch import elastic as _elastic

        stored = self.opsnap.stored_workers()
        if not _elastic.reshard_enabled():
            raise RuntimeError(
                "operator_persisting: persisted snapshots were taken "
                f"with {stored} worker(s) but "
                f"this run has {self._total_workers}; restart with "
                "the same worker count, clear the persistence storage, or "
                "enable PATHWAY_ELASTIC to reshard by key range from the "
                "replayed input logs"
            )
        self._reshard_restore = (stored, self._total_workers)
        _elastic.note_reshard_restore(stored, self._total_workers)
        # the dropped shards (all generations, all old workers' aux chunk
        # sets) will never be read again — reclaim them now, single writer,
        # then every process re-inits its generation bookkeeping from the
        # now-empty manifest so generation numbers stay aligned pod-wide
        if self._pid == 0:
            for k in self.backend.list_keys("operators/"):
                self.backend.delete(k)
        if self._is_cluster:
            self.runtime._barrier(
                ("elastic_opsnap_reset", self._pid, {}), lambda reports: {"ok": True}
            )
        self.opsnap = _OperatorSnapshots(
            self.backend, self.config.snapshot_interval_ms / 1000.0
        )

    def _replay_all(self) -> None:
        """Replay every persisted input, recording the O(suffix) cost: a run
        recovering from operator snapshots replays only the log tail past the
        committed offsets, and the telemetry gauge lets tests (and operators)
        assert recovery was NOT a full-history recompute."""
        if self._reshard_restore is not None:
            # reshard-by-replay needs the FULL history: a log whose prefix was
            # compacted (pre-elastic storage) cannot recompute the dropped
            # operator shards — fail naming the source, never silently lose
            # its prefix
            for p in self.inputs:
                if p.trimmed_events > 0:
                    raise RuntimeError(
                        f"elastic reshard: input log {p.pid!r} had "
                        f"{p.trimmed_events} leading event(s) compacted away "
                        "under a previous non-elastic run, so operator state "
                        "cannot be recomputed for the new worker count; "
                        "restart with the original "
                        f"{self._reshard_restore[0]} worker(s) or clear the "
                        "persistence storage"
                    )
        if any(getattr(p, "replay_skip", 0) > 0 for p in self.inputs):
            # suffix-only replay: the stream prefix is invisible to this run,
            # so the audit plane's history-dependent monitors (multiplicity,
            # shadow digests) must stand down or they would report legal
            # retractions of pre-snapshot rows as violations
            from pathway_tpu_torch.observability import audit as _audit

            _audit.note_history_truncated()
        replayed = 0
        for p in self.inputs:
            # `or 0`: replay() wrappers in tests may not return the count
            replayed += p.replay() or 0
        self.replayed_events = replayed
        if self.inputs:
            from pathway_tpu_torch.internals.telemetry import record_event

            record_event(
                "resilience.replay",
                events=replayed,
                n_inputs=len(self.inputs),
                process_id=self._pid,
            )

    @staticmethod
    def _dedup_source_pids(graph) -> dict[int, str]:
        """node_index → persistent base pid, with the SAME dedup-suffix rule
        process 0 applies to ctx.build_order (build order == node_index
        order, and graphs are aligned across processes) — so a peer's
        \"name-1@w3\" matches process 0's manifest bookkeeping."""
        sources = [
            n for n in graph.nodes if isinstance(n, ops.StreamInputNode)
        ]
        name_counts: dict[str, int] = {}
        for n in sources:
            name_counts[n.name] = name_counts.get(n.name, 0) + 1
        seen: dict[str, int] = {}
        out: dict[int, str] = {}
        for n in sources:
            if name_counts[n.name] == 1:
                out[n.node_index] = n.name
            else:
                i = seen.get(n.name, 0)
                seen[n.name] = i + 1
                out[n.node_index] = f"{n.name}-{i}"
        return out

    def _add_partitioned_peer_inputs(self, offsets: dict) -> None:
        """Cluster peers: wrap this process's partitioned source nodes
        (local_source) in per-worker persisted inputs."""
        local_workers = getattr(self.runtime, "local_workers", None) or {}
        for gi, lw in local_workers.items():
            base_pids = self._dedup_source_pids(lw.graph)
            for node in lw.graph.nodes:
                if getattr(node, "local_source", False):
                    pid = f"{base_pids[node.node_index]}@w{gi}"
                    self.inputs.append(
                        _PersistedInput(
                            pid,
                            node,
                            self.backend,
                            live_after_replay=getattr(
                                self.config, "continue_after_replay", True
                            ),
                            subject=self._subject_of(node),
                            replay_skip=offsets.get(pid, 0),
                        )
                    )

    def _bind_delivery(self, ctx) -> None:
        """Collect the sink writers that opted into ``delivery='exactly_once'``
        (their CallbackOutputNodes carry a ``delivery_writer`` attribute) and
        bind them to the persistence backend. Runs on process 0 / the solo
        runtime only — sinks are SOLO nodes living on global worker 0, and the
        restore above already delivered each writer's snapshot cut through its
        ``restore_sink`` hook."""
        writers: list = []
        seen: set[int] = set()
        for _lnode, node in ctx.build_order:
            w = getattr(node, "delivery_writer", None)
            if w is not None and id(w) not in seen:
                seen.add(id(w))
                writers.append(w)
        if not writers:
            return
        if not self.operator_mode:
            raise RuntimeError(
                "delivery='exactly_once' requires "
                "persistence_mode='operator_persisting': publication gates on "
                "operator-snapshot recovery points (a replayed suffix re-nets "
                "ticks, so per-epoch output cannot be aligned with what was "
                "already published)"
            )
        from pathway_tpu_torch.delivery import DeliveryPlane

        plane = DeliveryPlane(
            writers, self.backend, next_epoch=lambda: self.epochs.epoch + 1
        )
        plane.bind_all(
            rescaled=self._migrate_plan is not None
            or self._reshard_restore is not None
        )
        self.delivery = plane

    def _subject_of(self, node) -> Any:
        """Find the connector subject feeding ``node`` (for seekable sources)."""
        for driver in getattr(self.runtime, "connectors", []) or []:
            subject = getattr(driver, "subject", None)
            if subject is not None and getattr(subject, "_node", None) is node:
                return subject
        return None

    def _save_operators(self, time: int) -> None:
        assert self.opsnap is not None
        offsets = {p.pid: p.consumed() for p in self.inputs}
        gen = self.opsnap.gen
        self.opsnap.save(self._worker_nodes, self._node_names, offsets, time)
        if self.epochs is not None:
            self.epochs.commit(time, offsets, opsnap_gen=gen, force=True)
        self._trim_inputs(lambda p: offsets[p.pid])
        if self.delivery is not None:
            # the snapshot that just committed carried each sink's staged cut:
            # everything at or below it is frozen — hand it to the sinks (a
            # failure here is retried at the next recovery point; strict only
            # at close, where unpublished output would otherwise be silent)
            self.delivery.publish_committed(final=time < 0)

    def _trim_inputs(self, offset_of) -> None:
        """Log compaction after a durable operator commit — SUSPENDED while
        the elasticity plane is enabled AND the pipeline cannot migrate:
        reshard-by-replay needs the full history to recompute state for a new
        worker count, so such runs trade compaction for reshardability
        (README "Elasticity"). When every persisted node supports keyed/solo
        migration under the shard map (``_migratable_graph``), a future
        rescale moves state instead of replaying it, so elastic runs compact
        again — input logs stay bounded across rescales."""
        from pathway_tpu_torch import elastic as _elastic

        if _elastic.reshard_enabled() and not self._migratable_graph:
            return
        for p in self.inputs:
            p.trim(offset_of(p))

    @staticmethod
    def _merge_offsets(reports):
        """Barrier decide: union the per-process {source pid → offset} maps
        (sources are process-disjoint) and record which processes acked."""
        merged: dict[str, int] = {}
        acks: list[int] = []
        for _tag, rpid, offs in reports:
            acks.append(int(rpid))
            merged.update(offs)
        return {"offsets": merged, "acks": sorted(acks)}

    def _save_operators_cluster(self, time: int) -> None:
        """Cross-process snapshot (the reference's per-worker persist wrappers
        + finalized-time consensus, ``persist.rs:843`` / ``state.rs:291``):
        every process writes its local worker shards for the current
        generation AND reports its own input offsets over the barrier; process
        0 commits the manifest with the MERGED offsets (so peer partitions
        recover O(suffix) too) plus the global epoch record, a second barrier
        proves the commit durable, then every process compacts its own logs.
        A crash mid-save leaves the previous generation authoritative on every
        process; a crash between commit and trim only delays GC."""
        assert self.opsnap is not None
        self.opsnap.save_shards(self._worker_nodes)
        local_offsets = {p.pid: p.consumed() for p in self.inputs}
        decision = self.runtime._barrier(
            ("persist_done", self._pid, local_offsets), self._merge_offsets
        )
        if self._pid == 0:
            gen = self.opsnap.gen
            sm = getattr(self.runtime, "shardmap", None)
            self.opsnap.commit(
                self._node_names,
                decision["offsets"],
                time,
                self._total_workers,
                shardmap_version=sm.version if sm is not None else None,
            )
            if self.epochs is not None:
                self.epochs.commit(
                    time,
                    decision["offsets"],
                    opsnap_gen=gen,
                    acks=decision["acks"],
                    force=True,
                )
        # trim only after the commit is proven durable everywhere — trimming
        # against an uncommitted generation could orphan replay history
        self.runtime._barrier(
            ("commit_done", self._pid, {}), lambda reports: {"ok": True}
        )
        self._trim_inputs(lambda p: decision["offsets"].get(p.pid, 0))
        self.opsnap.flush_aux_gc()  # each process GCs its own shards' chunks
        self.opsnap.advance()
        # delivery publication only after the commit_done barrier: every peer
        # has acked the manifest durable, so the frozen cut can never roll back
        if self._pid == 0 and self.delivery is not None:
            self.delivery.publish_committed(final=time < 0)

    def _commit_epoch(self, time: int, force: bool = False) -> None:
        """Input-frontier epochs: after this tick's flushes, publish a global
        epoch manifest of the durable per-source offsets. In cluster mode a
        barrier first collects every process's flushed offsets — the commit
        is by construction 'all processes reported durable'. ``force`` commits
        even when the frontier did not move (the delivery plane staged output
        rows this tick, which must map onto a committed epoch number)."""
        if not self._is_cluster:
            if self.epochs is not None:
                self.epochs.commit(
                    time, {p.pid: p.persisted for p in self.inputs}, force=force
                )
            return
        local = {p.pid: p.persisted for p in self.inputs}
        decision = self.runtime._barrier(
            ("epoch", self._pid, local), self._merge_offsets
        )
        if self.epochs is not None:  # process 0 is the single epoch writer
            self.epochs.commit(
                time, decision["offsets"], acks=decision["acks"], force=force
            )

    def on_tick_done(self, time: int) -> None:
        for p in self.inputs:
            p.flush()
        # exactly-once delivery: durably stage this tick's output rows
        # under epoch N+1 BEFORE the epoch commit — once the manifest lands the
        # staged batch is addressable; a crash in between leaves an orphan
        # index that restore discards (see delivery/ledger.py crash windows)
        staged = self.delivery.stage_tick() if self.delivery is not None else 0
        self._commit_epoch(time, force=staged > 0)
        if not self.operator_mode or self.opsnap is None:
            return
        if not self._is_cluster:
            if self.opsnap.due():
                self._save_operators(time)
            return
        if self.opsnap.interval_s <= 0:
            return  # snapshot-at-close only: skip the per-tick barrier
            # (config is identical on every process, so the skip is symmetric)
        # cluster: process 0 decides due-ness (monotonic clocks differ across
        # processes) and the decision broadcasts over the barrier — every
        # process calls the same barrier sequence every tick
        due = self.opsnap.due() if self._pid == 0 else False
        decision = self.runtime._barrier(
            ("persist", due), lambda reports: {"do": reports[0][1]}
        )
        if decision["do"]:
            self._save_operators_cluster(time)

    def on_close(self) -> None:
        for p in self.inputs:
            p.flush()
        if self.delivery is not None:
            # rows emitted since the last tick boundary: stage them under one
            # final epoch so the closing snapshot freezes and publishes them
            self.delivery.stage_tick()
        if not self.operator_mode or self.opsnap is None:
            self._commit_epoch(-1)
            return
        if not self._is_cluster:
            self._save_operators(-1)
            return
        # forced final snapshot: every operator-mode process reaches on_close
        # in lockstep and _save_operators_cluster carries its own barriers
        self._save_operators_cluster(-1)


def attach(runtime, config) -> None:
    """All runtimes support operator persistence: single, thread-sharded
    (per-worker shards), and the multi-process cluster (per-process shard
    writes over the shared backend + barrier-consensus manifest commit)."""
    runtime.persistence = Persistence(config, runtime)
    if config.backend.kind == "filesystem" and config.backend.path:
        # colocate UDF DiskCache with the persistent storage (reference:
        # UdfCaching rides the same machinery, internals/udfs/caches.py:35)
        import os

        os.environ.setdefault("PATHWAY_PERSISTENT_STORAGE", config.backend.path)
