"""Elasticity plane: live scale-out / scale-in for a running pod.

The reference runs a fixed worker set for the life of a job (SURVEY §5.3: "no
live elasticity"). This subsystem lets the pod change shape mid-stream with
zero lost or duplicated output, assembled from pieces earlier rounds built:

1. **Decide** — on the tick-continuation barrier the coordinator consults
   this plane: a manual ``pathway_tpu_torch scale --to N`` request (polled from the
   persistence backend, or pushed via the monitoring server's ``/scale``
   endpoint) in ``manual`` mode, plus the :class:`AutoscalerPolicy` reading
   the flow plane's merged pod-pressure signal and sink p99-vs-SLO in ``auto`` mode.
2. **Quiesce** — the decision broadcasts with the continue verdict; every
   process drains its final tick, stops connectors and runs the normal close
   path, whose cluster persistence hooks commit one last coordinated
   checkpoint epoch — the pod's complete state at a single cut.
3. **Commit membership** — the coordinator publishes membership version N+1
   (``elastic/membership`` in the backend) naming the new process count and
   the epoch it derives from, then every process exits with
   :data:`RESCALE_EXIT_CODE`.
4. **Relaunch + reshard** — the Supervisor recognizes the rescale status,
   reads the membership table and relaunches at the new shape WITHOUT
   spending restart budget. On restore, ``persistence/`` reshards by key
   range: orphaned partitioned input logs re-bucket to their new owners
   (``reshard.reshard_input_logs``), positional operator shards are dropped
   and recomputed by full-log replay under the new shard map
   (reshard-by-replay — elastic mode suspends log compaction to keep this
   always possible), and producers/device-exchange routing follow the new
   worker count automatically because ownership is derived from it.

``PATHWAY_ELASTIC=off`` (default) installs nothing: the run loop pays one
``is None`` test and behavior is byte-for-byte that of a run without the
plane.

Carried from ``pathway_tpu/elastic/__init__.py`` with imports rewritten; the
request comes from ``python -m pathway_tpu_torch scale --to N`` or the
monitoring server's ``/scale?to=N``, and the supervisor is
``resilience.Supervisor`` (``python -m pathway_tpu_torch supervise``).
"""

from __future__ import annotations

import time as _time
from typing import Any

from pathway_tpu_torch.elastic.autoscaler import AutoscalerPolicy
from pathway_tpu_torch.elastic.membership import (
    Membership,
    check_version,
    clear_scale_request,
    commit_membership,
    membership_history,
    read_membership,
    read_scale_request,
    reset_stale_warnings,
    write_scale_request,
)
from pathway_tpu_torch.elastic.reshard import (
    ReshardStats,
    adopt_orphan_suffixes,
    moved_fraction,
    orphan_workers,
    reshard_input_logs,
)
from pathway_tpu_torch.internals.config import get_pathway_config
from pathway_tpu_torch.internals.telemetry import record_event

#: exit status of a process leaving for a coordinated rescale (EX_TEMPFAIL —
#: "try again", which is literally the contract: relaunch me at the new shape)
RESCALE_EXIT_CODE = 75

#: how often the coordinator re-reads the scale-request key from the backend
_REQUEST_POLL_S = 0.25


class ClusterRescale(SystemExit):
    """Raised (on every process) after a clean quiesce-to-epoch when the pod
    must relaunch at a new shape. A ``SystemExit`` subclass so an unhandled
    escape exits the process with :data:`RESCALE_EXIT_CODE` — exactly what a
    supervising parent needs to see — instead of a traceback."""

    def __init__(self, target: int, version: int, reason: str):
        super().__init__(RESCALE_EXIT_CODE)
        self.target = target
        self.version = version
        self.reason = reason

    def __str__(self) -> str:  # shown if NOT supervised
        return (
            f"cluster rescale to {self.target} process(es) "
            f"(membership v{self.version}, {self.reason}); relaunch under "
            f"`python -m pathway_tpu_torch supervise` to make this seamless"
        )


class ElasticPlane:
    """Per-run elasticity state: membership view, pending requests, policy."""

    def __init__(self, mode: str, runtime: Any):
        cfg = get_pathway_config()
        self.mode = mode
        self.runtime = runtime
        self.processes = cfg.processes
        self.threads = cfg.threads
        persistence = getattr(runtime, "persistence", None)
        self.backend = getattr(persistence, "backend", None)
        self._warned_no_backend = False
        self._warned_no_pressure = False
        self._manual_target: int | None = None
        self._manual_source = ""
        self._last_request_unix: float = 0.0
        self._last_poll = 0.0
        self.decided: dict | None = None
        self.policy = (
            AutoscalerPolicy(
                min_processes=cfg.elastic_min_processes,
                max_processes=cfg.elastic_max_processes,
                high_pressure=cfg.elastic_high_pressure,
                low_pressure=cfg.elastic_low_pressure,
                sustain_ticks=cfg.elastic_sustain_ticks,
                cooldown_s=cfg.elastic_cooldown_s,
                slo_ms=cfg.latency_slo_ms,
            )
            if mode == "auto"
            else None
        )
        self.membership: Membership | None = None
        if self.backend is not None:
            self.membership = read_membership(self.backend)
            if self.membership is None and getattr(runtime, "pid", 0) == 0:
                self.membership = commit_membership(
                    self.backend,
                    Membership(
                        version=0,
                        processes=self.processes,
                        threads=self.threads,
                        status={p: "active" for p in range(self.processes)},
                        reason="initial",
                    ),
                )
            elif self.membership is not None:
                # a consumed request from a previous incarnation must not
                # re-fire: only requests newer than the last commit count
                self._last_request_unix = self.membership.committed_unix
                if self.policy is not None and self.membership.reason != "initial":
                    # cooldown must survive the rescale it guards: the policy
                    # object dies with the old incarnation, so seed the new
                    # one from the membership commit's wall clock — a fresh
                    # pod replaying its backlog reads as sustained saturation
                    # and would otherwise chain joins straight to max
                    elapsed = max(0.0, _time.time() - self.membership.committed_unix)
                    if elapsed < self.policy.cooldown_s:
                        self.policy.last_decision_at = _time.monotonic() - elapsed

    # ------------------------------------------------------------- requests
    def request_scale(self, target: int, source: str = "http") -> dict:
        """Manual request (monitoring ``/scale`` endpoint). Only the
        coordinator's plane is consulted at the continuation barrier, so a
        request landing on a peer's monitoring server forwards through the
        shared backend — the same channel the CLI uses — instead of being
        acknowledged into a local field nothing ever reads."""
        target = int(target)
        if target < 1:
            raise ValueError(f"scale target must be >= 1, got {target}")
        if getattr(self.runtime, "pid", 0) != 0:
            if self.backend is None:
                return {
                    "ok": False,
                    "error": "this is not the coordinator and the run has no "
                    "persistence backend to forward the request through; "
                    "send the request to process 0's monitoring server",
                }
            write_scale_request(self.backend, target, source=f"{source}:forwarded")
            return {"ok": True, "target": target, "mode": self.mode, "forwarded": True}
        self._manual_target = target
        self._manual_source = source
        return {"ok": True, "target": target, "mode": self.mode}

    def _poll_request(self) -> None:
        if self.backend is None:
            return
        now = _time.monotonic()
        if now - self._last_poll < _REQUEST_POLL_S:
            return
        self._last_poll = now
        req = read_scale_request(self.backend)
        if req and req.get("requested_unix", 0.0) > self._last_request_unix:
            self._last_request_unix = req["requested_unix"]
            self._manual_target = int(req["target"])
            self._manual_source = str(req.get("source", "cli"))

    # ------------------------------------------------------------- decision
    def maybe_decide(
        self, runtime: Any, tick: int, pod_pressure: float | None
    ) -> dict | None:
        """Coordinator-side: one consultation per tick-continuation barrier.
        Returns the rescale decision to broadcast, or None."""
        if self.decided is not None:
            return None  # one decision per incarnation; the pod is exiting
        if self.backend is None:
            if not self._warned_no_backend:
                self._warned_no_backend = True
                record_event("elastic.no_persistence", mode=self.mode)
                import logging

                logging.getLogger(__name__).warning(
                    "PATHWAY_ELASTIC=%s but the run has no persistence "
                    "backend: a rescale would lose all state, so scale "
                    "requests are ignored (attach persistence_config)",
                    self.mode,
                )
            return None
        self._poll_request()
        target: int | None = None
        reason = "manual"
        if self._manual_target is not None:
            target = self._manual_target
            reason = f"manual:{self._manual_source}" if self._manual_source else "manual"
            self._manual_target = None
        elif self.policy is not None:
            if pod_pressure is None:
                if not self._warned_no_pressure:
                    self._warned_no_pressure = True
                    record_event("elastic.no_pressure_signal", mode=self.mode)
                    import logging

                    logging.getLogger(__name__).warning(
                        "PATHWAY_ELASTIC=auto needs the flow plane's pressure "
                        "signal (set PATHWAY_FLOW=on); autoscaling is inert"
                    )
            else:
                p99 = self.policy.windowed_p99_s()
                d = self.policy.observe(
                    self.processes, pod_pressure, p99, tick=tick
                )
                if d is not None:
                    target = d["target"]
                    reason = d["reason"]
        if target is None or target == self.processes:
            if target == self.processes:
                clear_scale_request(self.backend)  # no-op request: consume it
            return None
        version = (self.membership.version if self.membership else 0) + 1
        self.decided = {
            "target": int(target),
            "version": version,
            "reason": reason,
            "from": self.processes,
            "tick": tick,
        }
        if self.policy is not None:
            self.policy.note_decision()  # manual decisions start cooldown too
        record_event(
            "elastic.rescale_decided",
            target=int(target),
            version=version,
            reason=reason,
            processes=self.processes,
            tick=tick,
        )
        from pathway_tpu_torch import observability as _obs

        tracer = _obs.current()
        if tracer is not None:
            tracer.event(
                "elastic/rescale",
                **{
                    "pathway.elastic.target": int(target),
                    "pathway.elastic.version": version,
                    "pathway.elastic.reason": reason,
                    "pathway.tick": tick,
                },
            )
        return self.decided

    def finalize_rescale(self, runtime: Any, decision: dict) -> None:
        """After the pod quiesced to its final committed epoch: commit the new
        membership (coordinator only) and leave via :class:`ClusterRescale`.
        Runs on EVERY process; only process 0 writes."""
        if getattr(runtime, "pid", 0) == 0 and self.backend is not None:
            from pathway_tpu_torch.persistence.snapshots import read_epoch_manifest

            ep = read_epoch_manifest(self.backend)
            target = int(decision["target"])
            mon = getattr(runtime, "hb_monitor", None)
            if mon is not None:
                # drained peers are retired from the failure detector: their
                # shutdown (or a last in-flight heartbeat) must not read as a
                # death, and their gate occupancy leaves the pressure merge
                for p in range(target, self.processes):
                    mon.retire_peer(p)
            status = {p: "active" for p in range(target)}
            for p in range(target, self.processes):
                status[p] = "draining"  # retired by this rescale
            commit_membership(
                self.backend,
                Membership(
                    version=int(decision["version"]),
                    processes=target,
                    threads=self.threads,
                    status=status,
                    epoch=ep["epoch"] if ep else None,
                    reason=str(decision["reason"]),
                ),
            )
            if get_pathway_config().shardmap == "on":
                # the shard map versions in lockstep with the membership: the
                # minimal-movement rebalance for the new shape commits in the
                # same finalize step, so the relaunched pod (and any door that
                # reads the backend) sees one consistent (membership, map) pair
                from pathway_tpu_torch.internals import shardmap as _shardmap

                stored = _shardmap.read_shardmap(self.backend)
                base = (
                    stored
                    if stored is not None
                    else _shardmap.ShardMap.initial(
                        self.processes * self.threads,
                        version=self.membership.version if self.membership else 0,
                    )
                )
                new_total = target * self.threads
                if base.n_workers != new_total:
                    _shardmap.commit_shardmap(
                        self.backend,
                        base.rebalance(new_total, version=int(decision["version"])),
                    )
                elif stored is None:
                    _shardmap.commit_shardmap(self.backend, base)
            clear_scale_request(self.backend)
        raise ClusterRescale(
            int(decision["target"]), int(decision["version"]), str(decision["reason"])
        )

    # --------------------------------------------------------------- status
    def status(self) -> dict[str, Any]:
        out: dict[str, Any] = {
            "mode": self.mode,
            "processes": self.processes,
            "threads": self.threads,
            "membership": self.membership.to_dict() if self.membership else None,
            "pending_decision": self.decided,
        }
        if self.policy is not None:
            out["autoscaler"] = self.policy.status()
        rs = _LAST_RESHARD.get("stats")
        if rs is not None:
            out["last_reshard"] = rs
        return out


# ------------------------------------------------------------- module plane

_PLANE: ElasticPlane | None = None
#: survives plane teardown within the process: the reshard that restored THIS
#: run (set by persistence), read by /status and /metrics
_LAST_RESHARD: dict[str, Any] = {}


def install_from_env(runtime: Any) -> None:
    global _PLANE
    mode = get_pathway_config().elastic
    if mode == "off":
        _PLANE = None
        return
    reset_stale_warnings()
    _PLANE = ElasticPlane(mode, runtime)


def current() -> ElasticPlane | None:
    return _PLANE


def shutdown() -> None:
    global _PLANE
    _PLANE = None


def reshard_enabled() -> bool:
    """True when restores may reshard (drop positional shards, replay the full
    logs under the new shard map) instead of refusing a worker-count change.
    Read by ``persistence/snapshots.py`` and ``io/fs.py`` — config-driven, so
    it holds even before any plane installs."""
    return get_pathway_config().elastic != "off"


def shardmap_enabled() -> bool:
    """True when the versioned shard-map plane owns key placement
    (``PATHWAY_SHARDMAP=on``): cluster routing, fabric doors, and rescale all
    consult the committed ``internals/shardmap.ShardMap`` instead of the
    derived modulo rule."""
    return get_pathway_config().shardmap == "on"


def migration_enabled() -> bool:
    """True when a rescale restore may MIGRATE state — load only the re-mapped
    key ranges' operator shards per the shard-map V→V+1 diff — instead of the
    wipe + full-log replay. Requires the shard-map plane."""
    cfg = get_pathway_config()
    return cfg.shardmap == "on" and cfg.shardmap_migration == "on"


def note_reshard_restore(
    old_workers: int, new_workers: int, stats: ReshardStats | None = None
) -> None:
    """Persistence reports the reshard it performed during restore. Called up
    to twice per restore (input-log rebucket, then the operator-shard drop) —
    the record merges so byte counters from the first call survive."""
    doc = _LAST_RESHARD.get("stats") or {}
    if stats is not None:
        doc.update(stats.to_dict())
    doc.update(
        {
            "old_workers": old_workers,
            "new_workers": new_workers,
            "moved_fraction": round(moved_fraction(old_workers, new_workers), 4),
            "at_unix": _time.time(),
        }
    )
    _LAST_RESHARD["stats"] = doc
    record_event(
        "elastic.reshard_restore",
        old_workers=old_workers,
        new_workers=new_workers,
        rows_moved=stats.rows_moved if stats else 0,
        bytes_moved=stats.bytes_moved if stats else 0,
    )


def note_migrate_restore(
    old_workers: int,
    new_workers: int,
    moved_fraction_: float,
    rows_moved: int,
    bytes_moved: int,
    ranges_moved: int,
    pause_s: float,
) -> None:
    """Persistence reports an O(moved-state) migration restore (the shard-map
    alternative to :func:`note_reshard_restore`'s replay path)."""
    _LAST_RESHARD["stats"] = {
        "mode": "migrate",
        "old_workers": old_workers,
        "new_workers": new_workers,
        "moved_fraction": round(moved_fraction_, 4),
        "rows_moved": rows_moved,
        "bytes_moved": bytes_moved,
        "ranges_moved": ranges_moved,
        "pause_s": round(pause_s, 4),
        "at_unix": _time.time(),
    }
    record_event(
        "elastic.migrate_restore",
        old_workers=old_workers,
        new_workers=new_workers,
        rows_moved=rows_moved,
        bytes_moved=bytes_moved,
        ranges_moved=ranges_moved,
    )


def last_reshard() -> dict | None:
    return _LAST_RESHARD.get("stats")


def status(runtime: Any) -> dict | None:
    """The ``elastic`` /status section (None when the plane is off and no
    reshard restored this run — the section only appears when it has news)."""
    if _PLANE is not None:
        return _PLANE.status()
    if _LAST_RESHARD.get("stats") is not None:
        return {"mode": "off", "last_reshard": _LAST_RESHARD["stats"]}
    return None


def prometheus_lines(runtime: Any) -> list[str]:
    """``pathway_cluster_processes`` + reshard movement counters."""
    cfg = get_pathway_config()
    lines = [
        "# HELP pathway_cluster_processes Processes in the current cluster membership",
        "# TYPE pathway_cluster_processes gauge",
        f"pathway_cluster_processes {cfg.processes}",
    ]
    if _PLANE is not None and _PLANE.membership is not None:
        lines += [
            "# HELP pathway_elastic_membership_version Version of the committed membership table",
            "# TYPE pathway_elastic_membership_version gauge",
            f"pathway_elastic_membership_version {_PLANE.membership.version}",
        ]
    sm = getattr(runtime, "shardmap", None)
    if sm is not None:
        lines += [
            "# HELP pathway_shardmap_version Version of the active shard map",
            "# TYPE pathway_shardmap_version gauge",
            f"pathway_shardmap_version {sm.version}",
            "# HELP pathway_shardmap_segments Contiguous ownership segments in the active shard map",
            "# TYPE pathway_shardmap_segments gauge",
            f"pathway_shardmap_segments {len(sm.starts)}",
        ]
    rs = _LAST_RESHARD.get("stats")
    if rs is not None:
        lines += [
            "# HELP pathway_elastic_reshard_rows_total Input-log rows re-owned by the last reshard restore",
            "# TYPE pathway_elastic_reshard_rows_total counter",
            f"pathway_elastic_reshard_rows_total {rs.get('rows_moved', 0)}",
            "# HELP pathway_elastic_reshard_bytes_total Serialized bytes moved by the last reshard restore",
            "# TYPE pathway_elastic_reshard_bytes_total counter",
            f"pathway_elastic_reshard_bytes_total {rs.get('bytes_moved', 0)}",
        ]
    return lines


__all__ = [
    "AutoscalerPolicy",
    "ClusterRescale",
    "ElasticPlane",
    "Membership",
    "RESCALE_EXIT_CODE",
    "ReshardStats",
    "check_version",
    "commit_membership",
    "current",
    "install_from_env",
    "last_reshard",
    "membership_history",
    "migration_enabled",
    "moved_fraction",
    "note_migrate_restore",
    "adopt_orphan_suffixes",
    "orphan_workers",
    "read_membership",
    "read_scale_request",
    "reshard_enabled",
    "reshard_input_logs",
    "shardmap_enabled",
    "write_scale_request",
]
