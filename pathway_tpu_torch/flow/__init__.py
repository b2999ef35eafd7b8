"""Adaptive flow-control plane: the r8 metrics plane turned into a control
plane.

Three cooperating pieces (``PATHWAY_FLOW=on``; default ``off`` keeps today's
behavior byte-for-byte):

- ``credit``     — bounded per-connector ingest queues whose credits are
  replenished by downstream tick completion; ``block`` producers or ``shed``
  overflow with exact, telemetry-visible drop counts
  (``PATHWAY_INPUT_QUEUE_ROWS``, ``PATHWAY_FLOW_POLICY``);
- ``admission``  — two service classes on the input plane (``interactive`` /
  ``bulk``): query traffic overtakes backfill at tick granularity, bulk keeps
  a guaranteed minimum (``PATHWAY_FLOW_BULK_MIN_ROWS``);
- ``controller`` — an AIMD controller reading the r8 sink-latency histograms
  and backlog gauges each tick, retuning the microbatch launch bucket between
  its minimum and ``PATHWAY_MICROBATCH_MAX_BATCH`` against
  ``PATHWAY_LATENCY_SLO_MS``.

Cluster-wide: peers piggyback their gate occupancy on the existing heartbeat
summaries; the tick-continuation barrier broadcasts the merged pressure back,
so a slow peer throttles every producer in the pod instead of OOMing one host.

Lifecycle mirrors ``observability``: each runtime ``run()`` calls
:func:`install_from_env` before the graph builds (gates attach as input nodes
are constructed) and :func:`shutdown` in its teardown; :func:`current` is the
hot-path accessor — **None when the plane is off**, so engine loops pay one
``is None`` test.

Carried from ``pathway_tpu/flow/__init__.py`` with imports rewritten. On a
cluster, :meth:`FlowPlane.cluster_signal` merges the peers' gate occupancy
on the coordinator and :meth:`FlowPlane.apply_cluster_signal` applies the
broadcast on every process (``parallel/cluster.py``).
"""

from __future__ import annotations

import threading
from typing import Any

from pathway_tpu_torch.flow.admission import (
    BULK,
    INTERACTIVE,
    SERVICE_CLASSES,
    AdmissionScheduler,
    validate_service_class,
)
from pathway_tpu_torch.flow.controller import AimdController
from pathway_tpu_torch.flow.credit import IngestGate


class FlowPlane:
    """Per-run flow-control state: the gates, the admission scheduler, and
    the AIMD microbatch controller."""

    def __init__(self, cfg):
        self.bound = cfg.input_queue_rows
        self.policy = cfg.flow_policy
        self.controller = AimdController(
            slo_ms=cfg.latency_slo_ms, max_bucket=cfg.microbatch_max_batch
        )
        self.admission = AdmissionScheduler(
            bulk_min_rows=cfg.flow_bulk_min_rows,
            bulk_max_rows=cfg.flow_bulk_max_rows,
        )
        self._lock = threading.Lock()
        self.gates: list[IngestGate] = []
        self.cluster_pressure = 0.0  # last merged pod-wide pressure seen

    # ------------------------------------------------------------ registration
    def register_input(self, node: Any) -> IngestGate:
        gate = IngestGate(node, bound=self.bound, policy=self.policy)
        with self._lock:
            self.gates.append(gate)
        return gate

    # --------------------------------------------------------------- tick hook
    def on_tick_complete(self, runtime: Any, tick: int) -> None:
        """Runs inside the tick scheduler after the tick settled (before the
        tick trace span closes): replenish credits FIRST so blocked producers
        wake regardless of what the controller decides, then fold the tick's
        measurements into the controller and plan the next tick's admission."""
        with self._lock:
            gates = list(self.gates)
        for gate in gates:
            gate.on_tick_complete()
        scheduler = getattr(runtime, "scheduler", None)
        tracer = getattr(scheduler, "tracer", None)
        self.controller.step(scheduler, tick, gates, tracer=tracer)
        self.admission.plan(gates, self.effective_pressure())

    # ----------------------------------------------------------------- signals
    def target_batch(self) -> int:
        """The microbatch launch bucket the controller currently allows —
        read by ``MicrobatchApplyNode`` on every flush decision."""
        return self.controller.target

    def effective_pressure(self) -> float:
        """Local controller pressure merged with the cluster's (a slow peer
        must throttle THIS host's producers too)."""
        return max(self.controller.pressure, self.cluster_pressure)

    def cluster_signal(self, peer_flows: dict[int, dict] | None = None) -> dict:
        """Coordinator side: the pod-wide flow signal broadcast on the tick
        continuation barrier — max pressure over the local controller and
        every peer's heartbeat-piggybacked gate occupancy."""
        pressure = self.controller.pressure
        for summary in (peer_flows or {}).values():
            if not summary:
                continue
            bound = summary.get("bound") or 0
            occupied = summary.get("occupied") or 0
            if bound > 0:
                pressure = max(pressure, min(1.0, occupied / bound))
            pressure = max(pressure, float(summary.get("pressure") or 0.0))
        return {"pressure": round(min(1.0, pressure), 4)}

    def apply_cluster_signal(self, signal: dict | None) -> None:
        """Peer side: fold the broadcast pressure into local admission and
        scale every gate's effective bound down while the pod is pressured."""
        if not signal:
            return
        pressure = min(1.0, max(0.0, float(signal.get("pressure") or 0.0)))
        self.cluster_pressure = pressure
        scale = 1.0 - 0.5 * pressure  # full pressure halves local credit
        with self._lock:
            gates = list(self.gates)
        for gate in gates:
            gate.set_remote_scale(scale)
        self.admission.plan(gates, self.effective_pressure())

    # --------------------------------------------------------------- telemetry
    def status(self) -> dict[str, Any]:
        with self._lock:
            gates = list(self.gates)
        # sharded builds construct one node instance per worker; only the one
        # wired to the live subject sees pushes — merge rows by input label so
        # /status shows one entry per logical connector
        merged: dict[str, dict[str, Any]] = {}
        for g in gates:
            snap = g.snapshot()
            row = merged.get(snap["input"])
            if row is None:
                merged[snap["input"]] = snap
                continue
            for k in ("queued", "in_flight", "admitted_rows", "shed_rows",
                      "cancelled_rows"):
                row[k] += snap[k]
            row["blocked_ms"] = round(row["blocked_ms"] + snap["blocked_ms"], 3)
        return {
            "policy": self.policy,
            "queue_bound": self.bound,
            "pressure": round(self.effective_pressure(), 4),
            "cluster_pressure": round(self.cluster_pressure, 4),
            "shed_rows_total": sum(g.shed_rows for g in gates),
            "inputs": [merged[k] for k in sorted(merged)],
            "controller": self.controller.snapshot(),
        }

    def heartbeat_summary(self) -> dict[str, Any]:
        """Compact per-process flow summary piggybacked on heartbeats (the
        coordinator's pressure merge + /status cluster section read this).
        ``bound``/``occupied`` cover INTERACTIVE gates only — a peer's full
        bulk queue is ordinary bounded backpressure and must not throttle the
        whole pod (same rule as the local controller's queue ratio)."""
        with self._lock:
            gates = list(self.gates)
        inter = [
            g for g in gates
            if getattr(g.node, "service_class", "interactive") == "interactive"
        ]
        # WORST single gate, not sums: sharded builds register one idle gate
        # clone per worker (only the subject-wired one sees pushes), so summed
        # bounds would dilute a saturated queue's ratio by the worker count.
        # UNSCALED bound: a ratio against the cluster-scaled effective bound
        # would let a scale-down inflate the ratio and ratchet pod pressure
        # upward (positive feedback).
        worst = max(
            inter,
            key=lambda g: (g.queued + g.in_flight) / g.bound if g.bound else 0.0,
            default=None,
        )
        return {
            "bound": worst.bound if worst is not None else 0,
            "occupied": (worst.queued + worst.in_flight) if worst is not None else 0,
            "shed_rows": sum(g.shed_rows for g in gates),
            "pressure": round(self.controller.pressure, 4),
        }

    # ---------------------------------------------------------------- teardown
    def close(self) -> None:
        with self._lock:
            gates = list(self.gates)
        for gate in gates:
            gate.close()


_plane: FlowPlane | None = None


def current() -> FlowPlane | None:
    """The installed flow plane, or None when ``PATHWAY_FLOW=off``."""
    return _plane


def install_from_env(runtime=None) -> FlowPlane | None:
    """Install the run's flow plane (called by every runtime's ``run`` BEFORE
    the graph builds, so input nodes constructed during the build attach their
    gates). Idempotent per run — a previous run's plane is closed first."""
    global _plane
    from pathway_tpu_torch.internals.config import get_pathway_config

    if _plane is not None:
        _plane.close()
        _plane = None
    cfg = get_pathway_config()
    if cfg.flow == "off":
        return None
    _plane = FlowPlane(cfg)
    return _plane


def shutdown() -> None:
    """Close the plane: wake every producer blocked on credit so connector
    threads can exit. The plane object is RETAINED (closed) so post-run
    ``/status`` still reports exact shed/cancel counts — the next
    :func:`install_from_env` replaces it. Never raises — runs in runtime
    ``finally`` blocks."""
    plane = _plane
    if plane is None:
        return
    try:
        plane.close()
    except Exception:
        pass


def register_input(node: Any) -> IngestGate | None:
    """Gate for a newly built connector input node; None when the plane is
    off or the node opted out (deterministic timed fixtures)."""
    plane = _plane
    if plane is None or not getattr(type(node), "flow_gated", True):
        return None
    return plane.register_input(node)


def status(runtime=None) -> dict[str, Any] | None:
    plane = _plane
    return None if plane is None else plane.status()


__all__ = [
    "BULK",
    "INTERACTIVE",
    "SERVICE_CLASSES",
    "AdmissionScheduler",
    "AimdController",
    "FlowPlane",
    "IngestGate",
    "current",
    "install_from_env",
    "register_input",
    "shutdown",
    "status",
    "validate_service_class",
]
