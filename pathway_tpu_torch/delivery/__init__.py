"""Exactly-once delivery plane: epoch-transactional external sinks.

Writers opt in with ``delivery="exactly_once"`` (``pw.io.kafka.write``,
``pw.io.postgres.write_snapshot``, ``pw.io.fs.write``) or the
``PATHWAY_DELIVERY`` knob. Output rows then flow through a durable
:class:`~pathway_tpu_torch.delivery.ledger.DeliveryLedger` keyed
``(epoch, sink_id, partition)``: staged each epoch before the commit barrier,
frozen at operator-snapshot recovery points, and published to the sink with
idempotence keys — restart replays only uncommitted epochs and the sink-side
dedupe (Kafka transactions/headers, the Postgres ``pathway_delivery`` commit
table, the fs offset sidecar) keeps downstream state byte-identical across
SIGKILL, Supervisor restart, and elastic rescale. Requires
``persistence_mode="operator_persisting"`` (publication gates on recovery
points — see ``ledger.py`` for why per-epoch publication cannot be aligned
with replay).

Carried from ``pathway_tpu/delivery/__init__.py`` with imports rewritten:
exactly-once writers are ``pw.io.fs.write`` (and ``csv``/``jsonlines``),
``pw.io.kafka.write`` and ``pw.io.postgres.write``/``write_snapshot``.
"""

from __future__ import annotations

from pathway_tpu_torch.delivery.ledger import (  # noqa: F401
    DeliveryLedger,
    DeliveryPlane,
    LedgerWriter,
)
from pathway_tpu_torch.delivery.transports import (  # noqa: F401
    KAFKA_CONTROL_TOPIC,
    PG_COMMIT_TABLE,
    FsDeliveryTransport,
    KafkaDeliveryTransport,
    PostgresDeliveryTransport,
    read_committed,
    stable_partition,
)


def resolve_mode(delivery: str | None) -> str:
    """Writer-side knob resolution: an explicit ``delivery=`` argument wins,
    else ``PATHWAY_DELIVERY`` decides (default ``off``)."""
    if delivery is None:
        from pathway_tpu_torch.internals.config import get_pathway_config

        delivery = get_pathway_config().delivery
    if delivery not in ("off", "exactly_once"):
        raise ValueError(
            f"delivery={delivery!r}: expected 'off' or 'exactly_once'"
        )
    return delivery


def plane_of(runtime) -> DeliveryPlane | None:
    """The run's delivery plane (bound on process 0 / the solo runtime when
    any sink opted in), or None."""
    persistence = getattr(runtime, "persistence", None)
    return getattr(persistence, "delivery", None)


def run_summary(runtime) -> dict | None:
    plane = plane_of(runtime)
    return plane.summary() if plane is not None else None


def heartbeat_summary(runtime) -> dict | None:
    plane = plane_of(runtime)
    return plane.heartbeat_summary() if plane is not None else None


def prometheus_lines(runtime) -> list[str]:
    """``pathway_delivery_*`` series for the /metrics endpoint."""
    plane = plane_of(runtime)
    if plane is None:
        return []
    lines = [
        "# TYPE pathway_delivery_staged_rows_total counter",
        "# TYPE pathway_delivery_published_rows_total counter",
        "# TYPE pathway_delivery_discarded_rows_total counter",
        "# TYPE pathway_delivery_publish_failures_total counter",
        "# TYPE pathway_delivery_uncommitted_epochs gauge",
        "# TYPE pathway_delivery_published_epoch gauge",
    ]
    for w in plane.writers:
        lab = f'{{sink="{w.sink_id}"}}'
        lines.append(f"pathway_delivery_staged_rows_total{lab} {w.staged_rows_total}")
        lines.append(
            f"pathway_delivery_published_rows_total{lab} {w.published_rows_total}"
        )
        lines.append(
            f"pathway_delivery_discarded_rows_total{lab} {w.discarded_rows_total}"
        )
        lines.append(
            f"pathway_delivery_publish_failures_total{lab} {w.publish_failures}"
        )
        lines.append(f"pathway_delivery_uncommitted_epochs{lab} {w.depth()}")
        lines.append(f"pathway_delivery_published_epoch{lab} {w.published_epoch}")
    return lines
