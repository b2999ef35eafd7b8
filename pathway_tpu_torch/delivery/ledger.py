"""Exactly-once delivery ledger (reference: the OSS tier's at-least-once output
vs the commercial tier's transactional sinks, SURVEY §5.3).

Every external sink that opts into ``delivery="exactly_once"`` writes through a
:class:`LedgerWriter` instead of straight to the transport. The protocol is an
outbox keyed ``(epoch, sink_id, partition)`` over the persistence KV backend:

1. **Stage** — each tick's consolidated output rows are written durably under
   ``delivery/<sink>/staged/epoch_<n>/…`` in ``on_tick_done``, BEFORE process 0
   commits the epoch manifest (the coordinated-commit discipline: delivery
   is acked ahead of the commit point). Staged-but-uncommitted chunks are never
   visible to the sink.
2. **Freeze** — when an operator snapshot commits (the recovery point), each
   sink's ``staged_epoch`` cut rides the snapshot itself via the
   ``sink_state``/``restore_sink`` hooks, so "which staged epochs the restored
   state already accounts for" is atomic with the manifest commit.
3. **Publish** — epochs ≤ the frozen cut are published to the external system
   with idempotence keys ``(sink_id, epoch, partition, seq)`` and the published
   frontier advances monotonically in the ledger meta.

Why publication gates on recovery points rather than every epoch: a restart
replays the input-log suffix in ONE tick, so per-tick consolidation nets
differently than the original run (an insert at tick 3 retracted at tick 7
nets to nothing in a single replay tick) — regenerated output can NOT be
aligned row-by-row with previously published output. Staged chunks beyond the
last recovery point are therefore discarded on restore and regenerated (safe:
they were never published), while chunks at or below the cut are frozen bytes
that re-publish identically however many times the process dies mid-publish.

Crash windows and their resolution:

- after stage, before manifest commit → orphan staged chunks discarded on
  restore, output regenerated by replay (never published, no external effect);
- after manifest commit, before publish → restart sees published < cut and
  publishes the frozen staged bytes;
- mid-publish / after publish but before the published-marker write → the
  epoch re-publishes in full and the transport-side idempotence (Kafka
  transaction or dedupe headers, the Postgres ``pathway_delivery`` commit
  table, the fs offset sidecar) absorbs the duplicate.

Carried from ``pathway_tpu/delivery/ledger.py`` with imports rewritten. The
three crash windows call the port's ``resilience.faults.at_point``
(``delivery_staged``, ``delivery_committed``, ``delivery_published``).
"""

from __future__ import annotations

import pickle
import threading
import time as _time
from typing import Any, Callable

_PREFIX = "delivery"


def _safe_sink_id(sink_id: str) -> str:
    import re

    return re.sub(r"[^A-Za-z0-9._-]", "_", sink_id)


class DeliveryLedger:
    """Durable staged-output store for ONE sink over the persistence backend.

    Chunk discipline mirrors the SnapshotStore: data chunks are written
    first, then a per-epoch ``index`` record — the index is the commit point of
    a staged epoch, so a crash mid-stage leaves no readable epoch behind."""

    def __init__(self, backend, sink_id: str):
        self.backend = backend
        self.sink_id = _safe_sink_id(sink_id)
        self._meta_key = f"{_PREFIX}/{self.sink_id}/meta"
        raw = backend.get(self._meta_key)
        meta = pickle.loads(raw) if raw is not None else {}
        #: newest epoch fully handed to the transport (monotone frontier)
        self.published_epoch: int = meta.get("published_epoch", -1)

    # -- keys -----------------------------------------------------------------
    def _epoch_prefix(self, epoch: int) -> str:
        return f"{_PREFIX}/{self.sink_id}/staged/epoch_{epoch:010d}/"

    def _index_key(self, epoch: int) -> str:
        return self._epoch_prefix(epoch) + "index"

    def _chunk_key(self, epoch: int, partition: int, chunk: int) -> str:
        return self._epoch_prefix(epoch) + f"part_{partition:04d}_{chunk:04d}"

    # -- staging --------------------------------------------------------------
    def stage(self, epoch: int, parts: dict[int, list], chunk_rows: int) -> int:
        """Durably stage one epoch's per-partition record lists. Returns rows."""
        index: dict[str, Any] = {"parts": {}, "rows": 0, "staged_unix": _time.time()}
        for p, records in sorted(parts.items()):
            n_chunks = 0
            for lo in range(0, len(records), chunk_rows):
                self.backend.put(
                    self._chunk_key(epoch, p, n_chunks),
                    pickle.dumps(records[lo : lo + chunk_rows]),
                )
                n_chunks += 1
            index["parts"][int(p)] = n_chunks
            index["rows"] += len(records)
        self.backend.put(self._index_key(epoch), pickle.dumps(index))
        return index["rows"]

    # -- reading --------------------------------------------------------------
    def staged_epochs(self) -> list[int]:
        """Epochs with a committed index record, ascending."""
        prefix = f"{_PREFIX}/{self.sink_id}/staged/"
        out = set()
        for k in self.backend.list_keys(prefix):
            if not k.endswith("/index"):
                continue
            tail = k[len(prefix) :].split("/", 1)[0]
            if tail.startswith("epoch_"):
                try:
                    out.add(int(tail[len("epoch_") :]))
                except ValueError:
                    pass
        return sorted(out)

    def index(self, epoch: int) -> dict | None:
        raw = self.backend.get(self._index_key(epoch))
        return pickle.loads(raw) if raw is not None else None

    def load(self, epoch: int) -> dict[int, list]:
        """The epoch's frozen records per partition (exact staged bytes)."""
        idx = self.index(epoch)
        if idx is None:
            return {}
        parts: dict[int, list] = {}
        for p, n_chunks in sorted(idx["parts"].items()):
            records: list = []
            for c in range(n_chunks):
                raw = self.backend.get(self._chunk_key(epoch, p, c))
                if raw is not None:
                    records.extend(pickle.loads(raw))
            parts[int(p)] = records
        return parts

    # -- lifecycle ------------------------------------------------------------
    def _delete_epoch(self, epoch: int) -> int:
        rows = 0
        idx = self.index(epoch)
        if idx is not None:
            rows = idx.get("rows", 0)
        for k in self.backend.list_keys(self._epoch_prefix(epoch)):
            self.backend.delete(k)
        return rows

    def discard_above(self, cut: int) -> tuple[int, int]:
        """Drop staged epochs past the restored cut (orphans of a crash between
        stage and manifest commit, or in-flight entries across a rescale) —
        they were never published and replay will regenerate their rows under
        the current shard map. Returns (epochs dropped, rows dropped)."""
        epochs = [e for e in self.staged_epochs() if e > cut]
        rows = 0
        for e in epochs:
            rows += self._delete_epoch(e)
        return len(epochs), rows

    def oldest_unpublished_unix(self) -> float | None:
        """Stage time of the oldest staged epoch past the published frontier
        (feeds the ``sink_commit_stall`` detector)."""
        for e in self.staged_epochs():
            if e > self.published_epoch:
                idx = self.index(e)
                if idx is not None:
                    return idx.get("staged_unix")
        return None

    def mark_published(self, epoch: int) -> None:
        """Advance the durable published frontier, then GC the staged bytes at
        or below it (a crash between the two only delays deletion)."""
        self.published_epoch = max(self.published_epoch, epoch)
        self.backend.put(
            self._meta_key, pickle.dumps({"published_epoch": self.published_epoch})
        )
        for e in self.staged_epochs():
            if e <= self.published_epoch:
                self._delete_epoch(e)


class LedgerWriter:
    """One sink's outbox: buffers formatted output rows per partition, stages
    them per epoch, and publishes frozen epochs through an idempotent
    transport. Shared by every worker copy of the sink's CallbackOutputNode
    (sinks are SOLO — only global worker 0's copy receives rows)."""

    def __init__(self, sink_id: str, transport, *, chunk_rows: int | None = None):
        self.sink_id = _safe_sink_id(sink_id)
        self.transport = transport
        from pathway_tpu_torch.internals.config import get_pathway_config

        cfg = get_pathway_config()
        if chunk_rows is None:
            chunk_rows = cfg.delivery_stage_rows
        self.chunk_rows = max(1, int(chunk_rows))
        self.max_staged_epochs = cfg.delivery_max_staged_epochs
        self.ledger: DeliveryLedger | None = None
        self._lock = threading.Lock()
        self._pending: dict[int, list] = {}
        self._pending_rows = 0
        #: newest epoch staged by this run — the cut that rides the operator
        #: snapshot via sink_state/restore_sink
        self.staged_epoch = -1
        self._restored_cut: int | None = None
        # counters (telemetry / /status / prometheus)
        self.staged_rows_total = 0
        self.published_rows_total = 0
        self.published_epochs_total = 0
        self.discarded_rows_total = 0
        self.publish_failures = 0
        self.last_publish_error: str | None = None

    # -- sink-side hooks (engine tick thread) ---------------------------------
    def append(self, partition: int, record) -> None:
        with self._lock:
            self._pending.setdefault(int(partition), []).append(record)
            self._pending_rows += 1

    def sink_state(self) -> dict:
        return {"staged_epoch": self.staged_epoch}

    def restore_sink(self, state: dict) -> None:
        self._restored_cut = int(state.get("staged_epoch", -1))

    # -- persistence-plane hooks (pid 0 / solo runtime only) ------------------
    def bind(self, backend) -> tuple[int, int]:
        """Attach the durable ledger on restart/first run: discard orphan
        staged epochs past the restored cut, then resume publication of frozen
        epochs the previous process died before handing to the sink. Returns
        (orphan epochs dropped, orphan rows dropped)."""
        self.ledger = DeliveryLedger(backend, self.sink_id)
        cut = self._restored_cut if self._restored_cut is not None else -1
        if self.ledger.published_epoch > cut:
            raise RuntimeError(
                f"exactly-once delivery: sink {self.sink_id!r} already published "
                f"through epoch {self.ledger.published_epoch} but the restored "
                f"snapshot cut is {cut} — the sink's snapshot state was lost "
                "(reshard-by-replay drops positional sink shards). Restart with "
                "the previous worker count, or enable the shard-map migration "
                "path (PATHWAY_SHARDMAP=on) which moves the cut instead of "
                "dropping it."
            )
        dropped_epochs, dropped_rows = self.ledger.discard_above(cut)
        self.discarded_rows_total += dropped_rows
        self.staged_epoch = cut
        self.publish_up_to(cut)
        return dropped_epochs, dropped_rows

    def stage(self, epoch: int) -> int:
        """Durably stage this tick's pending rows under ``epoch``. No-op (and
        no epoch force-commit) when the sink emitted nothing."""
        with self._lock:
            if self._pending_rows == 0:
                return 0
            pending, self._pending = self._pending, {}
            rows, self._pending_rows = self._pending_rows, 0
        assert self.ledger is not None, "LedgerWriter.stage before bind()"
        if self.depth() >= self.max_staged_epochs:
            # backpressure bound: the sink has rejected publishes for this
            # many recovery points — fail the run instead of staging
            # unbounded output (PATHWAY_DELIVERY_MAX_STAGED_EPOCHS)
            raise RuntimeError(
                f"exactly-once delivery: sink {self.sink_id!r} has "
                f"{self.depth()} staged-but-unpublished epochs "
                f"(last error: {self.last_publish_error}); bound is "
                f"{self.max_staged_epochs} (PATHWAY_DELIVERY_MAX_STAGED_EPOCHS)"
            )
        self.ledger.stage(epoch, pending, self.chunk_rows)
        self.staged_epoch = epoch
        self.staged_rows_total += rows
        return rows

    def publish_up_to(self, cut: int, *, strict: bool = False) -> int:
        """Publish every staged epoch in ``(published, cut]`` in order through
        the transport, advancing the durable frontier per epoch. A transport
        failure leaves the remaining epochs staged (retried at the next
        recovery point — the ``sink_commit_stall`` detector watches their age)
        unless ``strict`` (the final at-close publish), which re-raises."""
        if self.ledger is None:
            return 0
        from pathway_tpu_torch.resilience import faults as _faults

        rows = 0
        for e in self.ledger.staged_epochs():
            if e > cut or e <= self.ledger.published_epoch:
                continue
            parts = self.ledger.load(e)
            n = sum(len(v) for v in parts.values())
            try:
                self.transport.publish(self.sink_id, e, parts)
            except Exception as exc:
                self.publish_failures += 1
                self.last_publish_error = f"{type(exc).__name__}: {exc}"
                from pathway_tpu_torch.internals.telemetry import record_event

                record_event(
                    "delivery.publish_failed",
                    sink=self.sink_id,
                    epoch=e,
                    error=self.last_publish_error,
                )
                if strict:
                    raise RuntimeError(
                        f"exactly-once delivery: sink {self.sink_id!r} failed "
                        f"to publish epoch {e} at close: {exc}"
                    ) from exc
                return rows
            # crash window 4: published to the sink but frontier not yet
            # durable — the whole epoch re-publishes next time and the
            # transport-side idempotence keys absorb it
            _faults.at_point("delivery_published")
            self.ledger.mark_published(e)
            self.published_rows_total += n
            self.published_epochs_total += 1
            self.last_publish_error = None
            rows += n
        return rows

    # -- observability --------------------------------------------------------
    @property
    def published_epoch(self) -> int:
        return self.ledger.published_epoch if self.ledger is not None else -1

    def depth(self) -> int:
        """Staged-but-unpublished epoch depth (delivery lag in epochs)."""
        return max(0, self.staged_epoch - self.published_epoch)

    def oldest_unpublished_unix(self) -> float | None:
        return self.ledger.oldest_unpublished_unix() if self.ledger else None

    def summary(self) -> dict:
        return {
            "sink": self.sink_id,
            "staged_epoch": self.staged_epoch,
            "published_epoch": self.published_epoch,
            "depth": self.depth(),
            "staged_rows": self.staged_rows_total,
            "published_rows": self.published_rows_total,
            "published_epochs": self.published_epochs_total,
            "discarded_rows": self.discarded_rows_total,
            "publish_failures": self.publish_failures,
            "last_error": self.last_publish_error,
        }


class DeliveryPlane:
    """All bound ledger writers of one run (process 0 / the solo runtime),
    driven by the persistence layer: ``stage_tick`` in ``on_tick_done`` before
    the epoch commit, ``publish_committed`` after each operator-snapshot
    commit (and at close)."""

    def __init__(self, writers: list[LedgerWriter], backend, next_epoch: Callable[[], int]):
        self.writers = writers
        self.backend = backend
        self._next_epoch = next_epoch
        self.repartitioned_rows = 0

    def bind_all(self, *, rescaled: bool = False) -> None:
        from pathway_tpu_torch.internals.telemetry import record_event

        for w in self.writers:
            dropped_epochs, dropped_rows = w.bind(self.backend)
            if dropped_rows and rescaled:
                # in-flight (staged, unpublished) entries across a membership
                # change: dropped here and re-derived by replay under the NEW
                # shard map — the no-double-emit path for elastic rescale
                self.repartitioned_rows += dropped_rows
                record_event(
                    "delivery.repartitioned",
                    sink=w.sink_id,
                    epochs=dropped_epochs,
                    rows=dropped_rows,
                )
            elif dropped_rows:
                record_event(
                    "delivery.discarded",
                    sink=w.sink_id,
                    epochs=dropped_epochs,
                    rows=dropped_rows,
                )

    def stage_tick(self) -> int:
        """Stage every sink's pending rows under the NEXT epoch number (the
        epoch the caller is about to commit). Returns total rows staged — a
        nonzero return makes the caller force the epoch commit so every staged
        batch corresponds to a real committed epoch."""
        epoch = self._next_epoch()
        total = 0
        for w in self.writers:
            total += w.stage(epoch)
        if total:
            from pathway_tpu_torch.internals.telemetry import record_event
            from pathway_tpu_torch.resilience import faults as _faults

            record_event("delivery.staged", epoch=epoch, rows=total, sinks=len(self.writers))
            from pathway_tpu_torch import observability as _obs

            tracer = _obs.current()
            if tracer is not None:
                tracer.event(
                    "delivery/stage",
                    **{"pathway.epoch": epoch, "pathway.rows": total},
                )
            # crash window 1 (the sharded-sink lesson): staged durable,
            # manifest commit NOT yet reached — a kill here must discard the
            # orphans on restart and regenerate by replay
            _faults.at_point("delivery_staged")
        return total

    def publish_committed(self, *, final: bool = False) -> int:
        """Publish every sink's frozen epochs up to its snapshot cut. Called
        after the operator-snapshot commit is durable (post-barrier in
        cluster mode); ``final`` makes transport failures fatal."""
        from pathway_tpu_torch.resilience import faults as _faults

        # crash window 2: manifest committed, nothing published yet — a kill
        # here must re-publish the frozen staged bytes on restart
        _faults.at_point("delivery_committed")
        rows = 0
        for w in self.writers:
            rows += w.publish_up_to(w.staged_epoch, strict=final)
        if rows:
            from pathway_tpu_torch.internals.telemetry import record_event

            record_event("delivery.published", rows=rows, sinks=len(self.writers))
            from pathway_tpu_torch import observability as _obs

            tracer = _obs.current()
            if tracer is not None:
                tracer.event(
                    "delivery/publish",
                    **{
                        "pathway.rows": rows,
                        "pathway.epoch": max(w.published_epoch for w in self.writers),
                    },
                )
        return rows

    # -- observability --------------------------------------------------------
    def summary(self) -> dict:
        sinks = {w.sink_id: w.summary() for w in self.writers}
        return {
            "sinks": sinks,
            "depth_max": max((w.depth() for w in self.writers), default=0),
            "staged_rows": sum(w.staged_rows_total for w in self.writers),
            "published_rows": sum(w.published_rows_total for w in self.writers),
            "discarded_rows": sum(w.discarded_rows_total for w in self.writers),
            "repartitioned_rows": self.repartitioned_rows,
            "publish_failures": sum(w.publish_failures for w in self.writers),
        }

    def heartbeat_summary(self) -> dict:
        """Compact form that rides every heartbeat to the coordinator."""
        oldest = [
            t for t in (w.oldest_unpublished_unix() for w in self.writers) if t is not None
        ]
        return {
            "sinks": len(self.writers),
            "depth": max((w.depth() for w in self.writers), default=0),
            "staged": sum(w.staged_rows_total for w in self.writers),
            "published": sum(w.published_rows_total for w in self.writers),
            "failures": sum(w.publish_failures for w in self.writers),
            "oldest_unpublished_unix": min(oldest) if oldest else None,
        }
