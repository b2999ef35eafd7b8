"""Key-range resharding of persisted state across membership changes.

Ownership is ``(key & SHARD_MASK) % n_workers`` (``internals/keys.py``), so a
worker-count change moves every key whose residue lands on a different owner
under the new modulus — :func:`moved_fraction` computes exactly how much.

What actually moves, and how:

- **Operator state** does not move as bytes at all: positional per-worker
  snapshot shards are discarded and the new shape *recomputes* them by
  replaying the (untrimmed — elastic mode suspends log compaction) input
  logs, with every replayed row re-routed by the new shard map the moment it
  enters the dataflow. Reshard-by-replay trades recovery time for total
  generality: any operator, any state shape, zero per-node reshard code.
  ``persistence/snapshots.py`` drives this from ``on_graph_built`` when the
  stored worker count mismatches.
- **Partitioned input logs** (``<src>@w<i>`` pids) DO move as bytes: a log
  owned by a worker that no longer exists would otherwise never replay (lost
  rows on scale-in). :func:`reshard_input_logs` re-buckets every event of an
  affected source across the new worker set by key range, exactly once, and
  accounts rows/bytes moved (the ``pathway_elastic_reshard_*`` metrics).
- **Index snapshot chunks** (``SnapshotStore`` delta logs) follow the
  operator rule: recomputed by replay, with the old ``operators/aux/`` chunk
  sets of vanished workers garbage-collected on the next commit.

Seek-state caveat: a seekable partitioned source's reader state describes the
OLD partition slice; after a re-partition there is no sound mapping, so the
state is dropped with a structured ``elastic.reshard_seek_state_dropped``
event — live continuation of such a source is at-least-once across a rescale
(the OSS tier's posture; the log replay itself stays exactly-once).
"""

from __future__ import annotations

import math
import pickle
import re
from dataclasses import dataclass, field

import numpy as np

from pathway_tpu_torch.internals.telemetry import record_event
from pathway_tpu_torch.internals.keys import shard_of_keys
from pathway_tpu_torch.persistence.backends import KVBackend

_META = "metadata"
_PART_RE = re.compile(r"^(?P<base>.+)@w(?P<w>\d+)$")


def moved_fraction(old_workers: int, new_workers: int) -> float:
    """Fraction of the key space whose owner changes between the two shapes:
    residues are uniform under the hash keys, so counting residue classes mod
    lcm(old, new) is exact."""
    if old_workers == new_workers:
        return 0.0
    l = math.lcm(old_workers, new_workers)
    moved = sum(1 for r in range(l) if r % old_workers != r % new_workers)
    return moved / l


@dataclass
class ReshardStats:
    old_workers: int = 0
    new_workers: int = 0
    rows_total: int = 0
    #: events whose owning worker changed (written into a different log)
    rows_moved: int = 0
    #: serialized bytes of the moved events
    bytes_moved: int = 0
    sources: list[str] = field(default_factory=list)
    seek_states_dropped: int = 0

    def to_dict(self) -> dict:
        return {
            "old_workers": self.old_workers,
            "new_workers": self.new_workers,
            "rows_total": self.rows_total,
            "rows_moved": self.rows_moved,
            "bytes_moved": self.bytes_moved,
            "sources": list(self.sources),
            "seek_states_dropped": self.seek_states_dropped,
        }


def _partitioned_inputs(backend: KVBackend) -> dict[str, dict[int, str]]:
    """base source pid → {worker id → full pid} over every ``@w`` input log
    in the backend (worker 0's partition logs under the bare base pid join
    the family when any sibling exists)."""
    families: dict[str, dict[int, str]] = {}
    bare: set[str] = set()
    for key in backend.list_keys("inputs/"):
        if not key.endswith("/" + _META):
            continue
        pid = key[len("inputs/") : -len("/" + _META)]
        m = _PART_RE.match(pid)
        if m:
            families.setdefault(m.group("base"), {})[int(m.group("w"))] = pid
        else:
            bare.add(pid)
    for base, members in families.items():
        if base in bare:
            members.setdefault(0, base)  # worker 0's slice has no @w suffix
    return families


def orphan_workers(backend: KVBackend, new_total: int) -> dict[str, list[int]]:
    """base source → worker ids holding logs but absent from the new worker
    set. Non-empty means :func:`reshard_input_logs` must run or rows would
    silently never replay."""
    out: dict[str, list[int]] = {}
    for base, members in _partitioned_inputs(backend).items():
        orphans = sorted(w for w in members if w >= new_total)
        if orphans:
            out[base] = orphans
    return out


def _read_log(backend: KVBackend, pid: str) -> tuple[dict, list[tuple]]:
    meta_raw = backend.get(f"inputs/{pid}/{_META}")
    if meta_raw is None:
        return {}, []
    meta = pickle.loads(meta_raw)
    if meta.get("trimmed_events", 0) or meta.get("first_chunk", 0):
        raise RuntimeError(
            f"elastic reshard: input log {pid!r} was compacted "
            f"({meta.get('trimmed_events', 0)} leading events trimmed) so its "
            "history cannot be re-bucketed; elastic mode suspends log "
            "compaction — this storage predates PATHWAY_ELASTIC. Restart at "
            "the original worker count or clear the persistence storage."
        )
    events: list[tuple] = []
    for i in range(meta.get("chunks", 0)):
        raw = backend.get(f"inputs/{pid}/chunk_{i:08d}")
        if raw is not None:
            events.extend(pickle.loads(raw))
    return meta, events


def _delete_log(backend: KVBackend, pid: str) -> None:
    for k in backend.list_keys(f"inputs/{pid}/"):
        backend.delete(k)


def _write_log(backend: KVBackend, pid: str, events: list[tuple]) -> None:
    _delete_log(backend, pid)
    if events:
        backend.put(f"inputs/{pid}/chunk_{0:08d}", pickle.dumps(events))
    backend.put(
        f"inputs/{pid}/{_META}",
        pickle.dumps(
            {
                "offset": len(events),
                "chunks": 1 if events else 0,
                "reader": None,
                "first_chunk": 0,
                "trimmed_events": 0,
                "chunk_sizes": [len(events)] if events else [],
                # the log now holds a KEY-RANGE slice unrelated to the
                # subject's partition slice: count-based live prefix-drop is
                # no longer sound (``_PersistedInput`` disables it and warns)
                "resharded": True,
            }
        ),
    )


def reshard_input_logs(
    backend: KVBackend, new_total: int, shard_map=None
) -> ReshardStats:
    """Re-bucket partitioned input logs into the new worker set by key range.

    Runs once, on the coordinator, before inputs are wrapped (peers wait on a
    barrier). Only sources with orphan logs are touched — on pure scale-out
    the old logs replay in place and routing redistributes the rows, so
    nothing needs to move. Every event of an affected source is re-owned by
    ``shard_of_keys(key, new_total, shard_map)`` — the versioned shard map
    when the plane is on, the modulo rule otherwise — and written exactly
    once; ordering stays stable per (old worker, log position), matching the
    engine's arrival-order tolerance (sinks re-canonicalize per tick)."""
    stats = ReshardStats(new_workers=new_total)
    families = _partitioned_inputs(backend)
    for base, members in sorted(families.items()):
        orphans = [w for w in members if w >= new_total]
        if not orphans:
            continue
        stats.old_workers = max(stats.old_workers, max(members) + 1)
        stats.sources.append(base)
        merged: list[tuple[int, tuple]] = []  # (old worker, event)
        for w in sorted(members):
            meta, events = _read_log(backend, members[w])
            if meta.get("reader") is not None:
                stats.seek_states_dropped += 1
                record_event(
                    "elastic.reshard_seek_state_dropped",
                    source=base,
                    worker=w,
                )
            merged.extend((w, ev) for ev in events)
        # vectorized ownership for the whole family at once
        keys = np.array([ev[0] for _w, ev in merged], dtype=np.uint64)
        owners = (
            shard_of_keys(keys, new_total, shard_map=shard_map)
            if len(keys)
            else np.array([], dtype=np.int32)
        )
        by_owner: dict[int, list[tuple]] = {w: [] for w in range(new_total)}
        for (old_w, ev), owner in zip(merged, owners):
            by_owner[int(owner)].append(ev)
            stats.rows_total += 1
            if int(owner) != old_w:
                stats.rows_moved += 1
                stats.bytes_moved += len(pickle.dumps(ev))
        for old_pid in members.values():
            _delete_log(backend, old_pid)
        for w in range(new_total):
            pid = base if w == 0 else f"{base}@w{w}"
            _write_log(backend, pid, by_owner[w])
    if stats.sources:
        record_event(
            "elastic.reshard_input_logs",
            sources=len(stats.sources),
            rows_total=stats.rows_total,
            rows_moved=stats.rows_moved,
            bytes_moved=stats.bytes_moved,
            new_workers=new_total,
        )
    return stats


def _read_log_suffix(
    backend: KVBackend, pid: str, from_offset: int
) -> tuple[dict, list[tuple]]:
    """Events of ``pid``'s log past absolute position ``from_offset`` —
    tolerating a compacted prefix, unlike :func:`_read_log`: migration only
    ever needs the suffix past the operator-snapshot offset, and trim never
    deletes a chunk the committed manifest still covers, so
    ``trimmed_events <= from_offset`` always holds for a sane store."""
    meta_raw = backend.get(f"inputs/{pid}/{_META}")
    if meta_raw is None:
        return {}, []
    meta = pickle.loads(meta_raw)
    trimmed = meta.get("trimmed_events", 0)
    if trimmed > from_offset:
        raise RuntimeError(
            f"elastic migrate: input log {pid!r} was compacted past the "
            f"operator-snapshot offset ({trimmed} trimmed > {from_offset} "
            "committed) — the store is inconsistent; clear the persistence "
            "storage"
        )
    to_skip = from_offset - trimmed
    events: list[tuple] = []
    for i in range(meta.get("first_chunk", 0), meta.get("chunks", 0)):
        raw = backend.get(f"inputs/{pid}/chunk_{i:08d}")
        if raw is None:
            continue
        chunk = pickle.loads(raw)
        if to_skip >= len(chunk):
            to_skip -= len(chunk)
            continue
        events.extend(chunk[to_skip:])
        to_skip = 0
    return meta, events


def adopt_orphan_suffixes(
    backend: KVBackend, new_total: int, manifest_offsets: dict[str, int]
) -> ReshardStats:
    """Scale-in under O(moved-state) migration: an orphan worker's input log
    holds (a) a prefix the operator snapshot already covers — its state
    migrates as shards, nothing to replay — and (b) a suffix past the
    snapshot offset that NO surviving worker would replay. Append each
    orphan's suffix to the family's worker-0 log as a fresh chunk (replay
    routes the rows to their new owners through the exchange) and delete the
    orphan log — O(suffix) bytes, never O(history) like
    :func:`reshard_input_logs`.

    The adopted rows are foreign to worker 0's live subject, so the meta's
    cumulative ``foreign_events`` count lets the count-based live prefix-drop
    stay EXACT for the subject's own rows (``_PersistedInput`` subtracts it);
    the orphan partitions' live continuation is at-least-once — their
    reassigned subject may re-produce adopted rows — matching the
    seek-state-dropped posture."""
    stats = ReshardStats(new_workers=new_total)
    for base, members in sorted(_partitioned_inputs(backend).items()):
        orphans = sorted(w for w in members if w >= new_total)
        if not orphans:
            continue
        stats.old_workers = max(stats.old_workers, max(members) + 1)
        stats.sources.append(base)
        adopted: list[tuple] = []
        for w in orphans:
            pid = members[w]
            meta, suffix = _read_log_suffix(
                backend, pid, int(manifest_offsets.get(pid, 0))
            )
            if meta.get("reader") is not None:
                stats.seek_states_dropped += 1
                record_event(
                    "elastic.reshard_seek_state_dropped", source=base, worker=w
                )
            adopted.extend(suffix)
            _delete_log(backend, pid)
        base_pid = members.get(0, base)
        meta_raw = backend.get(f"inputs/{base_pid}/{_META}")
        meta = (
            pickle.loads(meta_raw)
            if meta_raw is not None
            else {
                "offset": 0,
                "chunks": 0,
                "reader": None,
                "first_chunk": 0,
                "trimmed_events": 0,
                "chunk_sizes": [],
            }
        )
        if adopted:
            payload = pickle.dumps(adopted)
            backend.put(
                f"inputs/{base_pid}/chunk_{meta['chunks']:08d}", payload
            )
            meta["chunks"] = meta.get("chunks", 0) + 1
            meta["offset"] = meta.get("offset", 0) + len(adopted)
            meta.setdefault("chunk_sizes", []).append(len(adopted))
            meta["foreign_events"] = meta.get("foreign_events", 0) + len(adopted)
            stats.rows_total += len(adopted)
            stats.rows_moved += len(adopted)
            stats.bytes_moved += len(payload)
        backend.put(f"inputs/{base_pid}/{_META}", pickle.dumps(meta))
    if stats.sources:
        record_event(
            "elastic.migrate_input_suffixes",
            sources=len(stats.sources),
            rows_moved=stats.rows_moved,
            bytes_moved=stats.bytes_moved,
            new_workers=new_total,
        )
    return stats
