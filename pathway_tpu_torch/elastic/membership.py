"""Versioned cluster membership: the elasticity plane's source of truth.

Carried from ``pathway_tpu/elastic/membership.py`` unchanged; the plane
that commits it is ``elastic/__init__.py``.

Without elasticity the cluster's shape is an env contract (``PATHWAY_PROCESSES``) fixed
for the life of a job. Elasticity makes the shape *state*: a
:class:`Membership` record — version, process/thread counts, per-process
status, the checkpoint epoch it derives from — committed to the persistence
backend under ``elastic/membership`` (latest) plus an immutable
``elastic/membership_v<N>`` history. Everyone reads it through one door:

- the **coordinator** commits version N+1 when a scale decision lands (after
  the pod quiesced to its final committed epoch, so the new shape always
  references durable state);
- the **Supervisor** reads it between attempts to learn the process count a
  relaunch should use (``resilience/supervisor.py`` rescale path);
- **monitoring** surfaces it as the ``elastic`` /status section and the
  ``pathway_cluster_processes`` gauge.

Key-range ownership goes through the single placement authority
``internals/keys.shard_of_keys``: by default worker ``w`` of an ``n``-worker
pod owns the residue class ``(key & SHARD_MASK) % n == w`` (the reference's
low-16-bit shard rule, derived, not stored); under ``PATHWAY_SHARDMAP`` the
versioned :class:`~pathway_tpu_torch.internals.shardmap.ShardMap` committed
alongside each membership version stores contiguous residue ranges instead. A
membership change therefore IS a reshard plan: under the modulo rule every key
whose residue maps to a different owner under the new modulus moves
(:func:`moved_fraction` quantifies how much); under the shard map only the
minimal re-mapped ranges move (``shardmap.moved_fraction``).

Stale-version hygiene: any message carrying a ``membership_version`` older
than the current one comes from a process that predates the last reshard
(e.g. a just-retired peer's last heartbeat). :func:`check_version` rejects it
with a structured ``elastic.stale_membership_version`` warning instead of
letting it corrupt coordinator state.
"""

from __future__ import annotations

import pickle
import time as _time
from dataclasses import dataclass, field
from typing import Any

from pathway_tpu_torch.internals.telemetry import record_event
from pathway_tpu_torch.persistence.backends import KVBackend

#: backend key of the LATEST membership record
_MEMBERSHIP = "elastic/membership"
#: backend key of a pending manual scale request (``pathway_tpu_torch scale``)
_SCALE_REQUEST = "elastic/scale_request"


@dataclass
class Membership:
    version: int
    processes: int
    threads: int
    #: pid → "active" | "joining" | "draining" (transitional states exist only
    #: inside a rescale window; a committed record is normally all-active)
    status: dict[int, str] = field(default_factory=dict)
    #: the committed checkpoint epoch this shape derives from (state for the
    #: moved key ranges loads from it), or None when no epoch exists yet
    epoch: int | None = None
    #: why this version exists: initial | manual | autoscale_join |
    #: autoscale_drain
    reason: str = "initial"
    committed_unix: float = 0.0

    @property
    def n_workers(self) -> int:
        return self.processes * self.threads

    def key_ranges(self, shard_map=None) -> dict[int, str]:
        """worker → human-readable description of its owned key range (the
        residue class of ``shard_of_keys``, or the shard map's contiguous
        residue ranges when one is active); /status and docs read this."""
        if shard_map is not None:
            return shard_map.key_ranges()
        n = self.n_workers
        return {
            w: f"(key & SHARD_MASK) % {n} == {w}" for w in range(n)
        }

    def to_dict(self) -> dict[str, Any]:
        return {
            "version": self.version,
            "processes": self.processes,
            "threads": self.threads,
            "status": dict(self.status),
            "epoch": self.epoch,
            "reason": self.reason,
            "committed_unix": self.committed_unix,
        }

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Membership":
        return cls(
            version=int(d["version"]),
            processes=int(d["processes"]),
            threads=int(d.get("threads", 1)),
            status={int(k): v for k, v in (d.get("status") or {}).items()},
            epoch=d.get("epoch"),
            reason=d.get("reason", "initial"),
            committed_unix=float(d.get("committed_unix", 0.0)),
        )


def read_membership(backend: KVBackend) -> Membership | None:
    raw = backend.get(_MEMBERSHIP)
    return Membership.from_dict(pickle.loads(raw)) if raw is not None else None


def commit_membership(backend: KVBackend, m: Membership) -> Membership:
    """Publish ``m`` as the latest membership plus an immutable history entry.
    Single-writer plane (the coordinator / process 0), same discipline as the
    epoch manifest."""
    m.committed_unix = _time.time()
    payload = pickle.dumps(m.to_dict())
    # history first, latest last: a crash between the two leaves the previous
    # latest intact and the history entry orphaned (harmless)
    backend.put(f"elastic/membership_v{m.version:06d}", payload)
    backend.put(_MEMBERSHIP, payload)
    record_event(
        "elastic.membership_committed",
        version=m.version,
        processes=m.processes,
        threads=m.threads,
        reason=m.reason,
        epoch=m.epoch if m.epoch is not None else -1,
    )
    return m


def membership_history(backend: KVBackend) -> list[Membership]:
    out = []
    for k in backend.list_keys("elastic/membership_v"):
        raw = backend.get(k)
        if raw is not None:
            out.append(Membership.from_dict(pickle.loads(raw)))
    return sorted(out, key=lambda m: m.version)


def check_version(current: int, incoming: int | None, source: str) -> bool:
    """True iff a message stamped ``incoming`` is current. A stale stamp (a
    just-retired process's last message arriving after the reshard) is
    rejected with ONE structured warning per (source, version) — never an
    exception: the control plane must shrug off zombies, not crash on them."""
    if incoming is None or incoming >= current:
        return True
    key = (source, incoming)
    if key not in _stale_warned:
        _stale_warned.add(key)
        record_event(
            "elastic.stale_membership_version",
            source=str(source),
            incoming=int(incoming),
            current=int(current),
        )
        import logging

        logging.getLogger(__name__).warning(
            "elastic: rejected stale membership version %d from %s "
            "(current %d) — sender predates the last reshard",
            incoming,
            source,
            current,
        )
    return False


_stale_warned: set = set()


def reset_stale_warnings() -> None:
    """Per-run reset (tests + plane install)."""
    _stale_warned.clear()


# ---------------------------------------------------------------- scale requests


def write_scale_request(backend: KVBackend, target: int, source: str = "cli") -> dict:
    """Record a manual scale request (``pathway_tpu_torch scale --to N``). The
    coordinator polls this key on the tick-continuation barrier and adopts
    newer requests."""
    if target < 1:
        raise ValueError(f"scale target must be >= 1, got {target}")
    req = {"target": int(target), "requested_unix": _time.time(), "source": source}
    backend.put(_SCALE_REQUEST, pickle.dumps(req))
    return req


def read_scale_request(backend: KVBackend) -> dict | None:
    raw = backend.get(_SCALE_REQUEST)
    return pickle.loads(raw) if raw is not None else None


def clear_scale_request(backend: KVBackend) -> None:
    backend.delete(_SCALE_REQUEST)
