"""Resilience: coordinated checkpoints, failure detection, supervised restart.

The cluster-plane fault-tolerance subsystem (reference: SURVEY §5.3–5.4 —
worker panic → ``OtherWorkerError``, recovery = restart + persistence replay,
fault injection by killing a subprocess mid-run). Three coupled pieces:

- **Coordinated checkpoint epochs** (``persistence/snapshots.py``): every
  cluster process persists its own input-log/operator shards; process 0
  commits a global epoch manifest only after a barrier proves every process's
  shards durable. :func:`last_committed_epoch` reads the newest fully-committed
  epoch — the restart point.
- **Failure detection** (:mod:`.heartbeat`): peer heartbeats to process 0 turn
  a dead or wedged peer into a structured
  :class:`~pathway_tpu_torch.internals.errors.OtherWorkerError` (which process, what
  tick) well within ``barrier_timeout``.
- **Supervised restart + fault injection** (:mod:`.supervisor`, :mod:`.faults`):
  :class:`Supervisor` runs the cluster as child processes and relaunches from
  the last committed epoch with bounded exponential backoff;
  :class:`FaultPlan` (``PATHWAY_FAULT_PLAN``) injects kills / dropped polls /
  delayed barriers for recovery tests and chaos drills.

Consistency on restart is at-least-once input replay (the reference's OSS
tier); sinks with exactly-once hooks (``fs.write``) rewind to the epoch cut so
final outputs match an uninterrupted run byte for byte.

Carried from ``pathway_tpu/resilience/__init__.py`` unchanged.
"""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.internals.errors import OtherWorkerError
from pathway_tpu_torch.resilience.faults import FaultPlan, FaultSpec
from pathway_tpu_torch.resilience.heartbeat import HeartbeatClient, HeartbeatMonitor
from pathway_tpu_torch.resilience.supervisor import (
    Supervisor,
    SupervisorGaveUp,
    SupervisorResult,
    supervise,
)


def last_committed_epoch(backend_or_config: Any) -> dict | None:
    """The newest fully-committed checkpoint epoch in a persistence backend
    (``persistence.Backend`` / ``persistence.Config`` / raw ``KVBackend``) —
    ``{"epoch", "tick", "input_offsets", "opsnap_gen", "acks", ...}`` or None
    when nothing has committed yet."""
    from pathway_tpu_torch.persistence.snapshots import read_epoch_manifest

    return read_epoch_manifest(backend_or_config)


__all__ = [
    "FaultPlan",
    "FaultSpec",
    "HeartbeatClient",
    "HeartbeatMonitor",
    "OtherWorkerError",
    "Supervisor",
    "SupervisorGaveUp",
    "SupervisorResult",
    "last_committed_epoch",
    "supervise",
]
