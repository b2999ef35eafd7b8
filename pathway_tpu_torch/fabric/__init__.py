"""Distributed serving fabric: every cluster process is a front door.

``PATHWAY_FABRIC=on`` (cluster runs only) installs a :class:`FabricPlane`
per process after the dataflow builds:

- **routing** (``routing.py``): peer processes start mirror front doors for
  every registered route; requests landing on a non-owner door are forwarded
  over the fabric transport to the owning process and answered byte-identical
  to hitting the coordinator, with the request trace stitching ingress
  and owner spans under one trace id;
- **replicas** (``replica.py``): ``pw.io.http.serve_table`` routes answer
  read-only lookups locally from a changelog-fed replica with bounded,
  measured staleness (``pathway_fabric_replica_lag_seconds``);
- **index replicas** (``index_replica.py``): ``/v1/retrieve``-style KNN
  routes answer locally at every door from a changelog-fed replica INDEX
  within ``PATHWAY_REPLICA_MAX_STALENESS_MS`` (``pathway_replica_lag_seconds``,
  ``pathway_replica_index_rows``), falling back to the owner forward when
  stale — read qps scales with doors instead of pinning to the owner;
- **limits** (``limits.py``): per-route token buckets and API-key auth run
  at every door (the coordinator's included — those two work without the
  fabric and without a cluster).

Lifecycle mirrors the other planes (flow/elastic/audit): ``install_from_env``
from the cluster runtime once connectors are up, ``current()`` for hot-path
guards, ``shutdown()`` with the run.

Carried from ``pathway_tpu/fabric``.
"""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.fabric import index_replica, limits, replica, transport  # noqa: F401
from pathway_tpu_torch.fabric.index_replica import ReplicaIndex  # noqa: F401
from pathway_tpu_torch.fabric.limits import ApiKeyGuard, TokenBucket  # noqa: F401
from pathway_tpu_torch.fabric.replica import ReplicaStore, serve_table  # noqa: F401
from pathway_tpu_torch.fabric.transport import FabricUnavailable  # noqa: F401

_plane = None


def current():
    """The installed fabric plane, or None (single-process runs, fabric off)."""
    return _plane


def install_from_env(runtime: Any):
    """Install the fabric on a cluster runtime when ``PATHWAY_FABRIC=on``.
    Called after the graph builds and connectors start (the route registry
    and the owner's webserver are live by then); a single-process run or
    ``off`` installs nothing and costs nothing."""
    global _plane
    from pathway_tpu_torch.internals.config import get_pathway_config

    cfg = get_pathway_config()
    if cfg.fabric == "off" or cfg.processes <= 1:
        _plane = None
        return None
    from pathway_tpu_torch.fabric.routing import FabricPlane

    _plane = FabricPlane(runtime, cfg)
    _plane.install()
    return _plane


def shutdown() -> None:
    global _plane
    if _plane is not None:
        _plane.close()
    _plane = None


def status(runtime: Any) -> dict | None:
    """The ``/status`` fabric section: the plane's view on cluster runs, or
    a replica-only view when ``serve_table`` routes live without a fabric
    (single-process runs)."""
    if _plane is not None and _plane.runtime is runtime:
        return _plane.status()
    routes = replica.live_table_routes(runtime)
    iroutes = index_replica.live_index_routes(runtime)
    if not routes and not iroutes:
        return None
    return {
        "enabled": False,
        "replica": {t.route: t.replica_snapshot() for t in routes},
        "index": {r.route: r.replica_snapshot() for r in iroutes},
    }


def prometheus_lines(runtime: Any) -> list[str]:
    """``pathway_fabric_*`` exposition lines for ``/metrics``."""
    from pathway_tpu_torch.internals.monitoring import escape_label_value

    routes = replica.live_table_routes(runtime)
    lines: list[str] = []
    if routes:
        lines.append(
            "# HELP pathway_fabric_replica_lag_seconds Measured staleness of a served table's local replica (0 on the owner)"
        )
        lines.append("# TYPE pathway_fabric_replica_lag_seconds gauge")
        for t in routes:
            lag = t.store.lag_s()
            if lag is not None:
                label = f'route="{escape_label_value(t.route)}"'
                lines.append(
                    f"pathway_fabric_replica_lag_seconds{{{label}}} {round(lag, 6)}"
                )
        lines.append(
            "# HELP pathway_fabric_replica_rows Rows held by a served table's local store"
        )
        lines.append("# TYPE pathway_fabric_replica_rows gauge")
        for t in routes:
            label = f'route="{escape_label_value(t.route)}"'
            lines.append(f"pathway_fabric_replica_rows{{{label}}} {len(t.store)}")
        lines.append(
            "# HELP pathway_fabric_replica_local_answers_total Lookups answered from the local store"
        )
        lines.append("# TYPE pathway_fabric_replica_local_answers_total counter")
        for t in routes:
            label = f'route="{escape_label_value(t.route)}"'
            lines.append(
                f"pathway_fabric_replica_local_answers_total{{{label}}} {t.local_answers}"
            )
        lines.append(
            "# HELP pathway_fabric_replica_fallback_total Stale-replica lookups forwarded to the owner"
        )
        lines.append("# TYPE pathway_fabric_replica_fallback_total counter")
        for t in routes:
            label = f'route="{escape_label_value(t.route)}"'
            lines.append(
                f"pathway_fabric_replica_fallback_total{{{label}}} {t.fallbacks}"
            )
    iroutes = index_replica.live_index_routes(runtime)
    if iroutes:
        plane = _plane if _plane is not None and _plane.runtime is runtime else None
        n_proc = plane.n_proc if plane is not None else None
        series = [
            (
                "pathway_replica_lag_seconds",
                "gauge",
                "Worst-peer staleness of the local replica index (absent while unsynced)",
            ),
            (
                "pathway_replica_index_rows",
                "gauge",
                "Rows held by the local replica index",
            ),
            (
                "pathway_replica_local_answers_total",
                "counter",
                "Retrieval requests answered from the local replica index",
            ),
            (
                "pathway_replica_fallback_total",
                "counter",
                "Retrieval requests forwarded to the owner (stale/unsynced/unanswerable)",
            ),
            (
                "pathway_replica_gaps_total",
                "counter",
                "Changelog sequence gaps detected (each triggers a snapshot resync)",
            ),
            (
                "pathway_replica_resyncs_total",
                "counter",
                "Snapshot resyncs completed against peer slices",
            ),
        ]
        snaps = [(r, r.replica_snapshot(n_proc)) for r in iroutes]
        keys = {
            "pathway_replica_index_rows": "rows",
            "pathway_replica_local_answers_total": "local_answers",
            "pathway_replica_fallback_total": "fallbacks",
            "pathway_replica_gaps_total": "gaps_total",
            "pathway_replica_resyncs_total": "resyncs_total",
        }
        for name, mtype, help_text in series:
            lines.append(f"# HELP {name} {help_text}")
            lines.append(f"# TYPE {name} {mtype}")
            for r, snap in snaps:
                label = f'route="{escape_label_value(r.route)}"'
                if name == "pathway_replica_lag_seconds":
                    lag = snap.get("lag_s")
                    if lag is not None:
                        lines.append(f"{name}{{{label}}} {round(lag, 6)}")
                else:
                    lines.append(f"{name}{{{label}}} {snap.get(keys[name], 0)}")
    if _plane is not None and _plane.runtime is runtime:
        lines.append(
            "# HELP pathway_fabric_forward_errors_total Forwards that failed at the fabric transport"
        )
        lines.append("# TYPE pathway_fabric_forward_errors_total counter")
        lines.append(
            f"pathway_fabric_forward_errors_total {_plane.forward_errors_total}"
        )
        lines.append(
            "# HELP pathway_fabric_replica_casts_total Changelog broadcasts sent by the owner"
        )
        lines.append("# TYPE pathway_fabric_replica_casts_total counter")
        lines.append(f"pathway_fabric_replica_casts_total {_plane.casts_total}")
    return lines


__all__ = [
    "ApiKeyGuard",
    "FabricUnavailable",
    "ReplicaIndex",
    "index_replica",
    "ReplicaStore",
    "TokenBucket",
    "current",
    "install_from_env",
    "limits",
    "prometheus_lines",
    "replica",
    "serve_table",
    "shutdown",
    "status",
    "transport",
]
