"""PostgreSQL writer (reference: ``PsqlWriter`` ``src/connectors/data_storage.rs:1326``
+ ``PsqlUpdatesFormatter``/``PsqlSnapshotFormatter`` ``data_format.rs:1733,1826``).

``write``: every diff appends an INSERT carrying time/diff columns (updates mode)
— append-only by construction, so retractions are rejected with a pointer to
``write_snapshot``. ``write_snapshot``: maintains one live row per primary key
via diff-aware UPSERT/DELETE — the snapshot mode; with
``delivery="exactly_once"`` the statements route through the delivery ledger
and land one transaction per epoch guarded by the ``pathway_delivery`` commit
table. Requires ``psycopg2`` (not in this image; import-gated) or a DBAPI
connection injected via ``connection=`` / ``connection_factory=`` in the
settings dict (e.g. the in-process :class:`~pathway_tpu_torch.io._pg_fake.FakePostgres`)."""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.engine import operators as ops
from pathway_tpu_torch.internals.logical import LogicalNode
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io._pg_fake import FakePostgres, FakePostgresError  # noqa: F401


def _connect(settings: dict):
    # DI hooks: a pre-built DBAPI connection, or a zero-arg factory producing
    # one (the factory form survives fork/exec — how the exactly-once tests
    # exercise the write paths on this driverless image)
    if "connection" in settings:
        return settings["connection"]
    if "connection_factory" in settings:
        return settings["connection_factory"]()
    try:
        import psycopg2  # noqa: F401
    except ImportError:
        raise NotImplementedError(
            "pw.io.postgres requires psycopg2 (or a pre-built connection= / "
            "connection_factory= in the settings dict), which is not "
            "available in this environment"
        ) from None
    import psycopg2

    return psycopg2.connect(**settings)


def _register_writer(table: Table, on_batch, name: str, writer=None) -> None:
    cols = table.column_names()

    def _node():
        if writer is None:
            return ops.CallbackOutputNode(cols, on_batch)
        node = ops.CallbackOutputNode(
            cols,
            on_batch,
            sink_state=writer.sink_state,
            restore_sink=writer.restore_sink,
        )
        node.delivery_writer = writer
        return node

    LogicalNode(_node, [table._node], name=name)._register_as_output()


def write(table: Table, postgres_settings: dict, table_name: str, **kwargs: Any) -> None:
    con = _connect(postgres_settings)
    cols = table.column_names()
    placeholders = ", ".join(["%s"] * (len(cols) + 2))
    stmt = (
        f"INSERT INTO {table_name} ({', '.join(cols)}, time, diff) "  # noqa: S608
        f"VALUES ({placeholders})"
    )

    def on_batch(batch, columns) -> None:
        with con.cursor() as cur:
            for _key, diff, row in batch.rows():
                if diff < 0:
                    raise RuntimeError(
                        f"pw.io.postgres.write({table_name!r}): retraction for "
                        f"row {tuple(row)!r} in plain-append mode — appended "
                        "INSERTs cannot express a deletion; use "
                        "pw.io.postgres.write_snapshot(primary_key=[...]) for "
                        "diff-aware UPSERT/DELETE output"
                    )
                cur.execute(stmt, tuple(row) + (batch.time, diff))
        con.commit()

    _register_writer(table, on_batch, f"postgres_write:{table_name}")


def _snapshot_sql(table_name: str, cols: list[str], pk: list[str]):
    """The diff-aware statement pair: PK-conflict UPSERT for ``diff > 0``,
    PK-match DELETE for ``diff < 0`` (shared by the direct writer and the
    delivery transport). Returns ``(upsert, delete, pk_idx)``."""
    non_pk = [c for c in cols if c not in pk]
    placeholders = ", ".join(["%s"] * len(cols))
    updates = ", ".join(f"{c} = EXCLUDED.{c}" for c in non_pk) or f"{pk[0]} = EXCLUDED.{pk[0]}"
    upsert = (
        f"INSERT INTO {table_name} ({', '.join(cols)}) VALUES ({placeholders}) "  # noqa: S608
        f"ON CONFLICT ({', '.join(pk)}) DO UPDATE SET {updates}"
    )
    delete = (
        f"DELETE FROM {table_name} WHERE "  # noqa: S608
        + " AND ".join(f"{c} = %s" for c in pk)
    )
    pk_idx = [cols.index(c) for c in pk]
    return upsert, delete, pk_idx


def _net_snapshot_ops(batch, pk_idx: list[int]):
    """Net one output batch per primary key (reference
    ``PsqlSnapshotFormatter``): an update arrives as retract(old)+insert(new)
    for the SAME pk within one consolidated tick, and replaying those in raw
    batch order would let a pk-only DELETE land after the UPSERT and wipe the
    live row. Per pk, an insertion anywhere in the batch wins (UPSERT with the
    newest values); a pk seeing only retractions is a genuine DELETE."""
    live: dict[tuple, tuple] = {}
    dead: dict[tuple, None] = {}
    for _key, diff, row in batch.rows():
        pkv = tuple(row[i] for i in pk_idx)
        if diff > 0:
            live[pkv] = tuple(row)
            dead.pop(pkv, None)
        elif pkv not in live:
            dead[pkv] = None
    for pkv in dead:
        yield "d", pkv
    for row in live.values():
        yield "u", row


def write_snapshot(
    table: Table,
    postgres_settings: dict,
    table_name: str,
    primary_key: list[str],
    *,
    delivery: str | None = None,
    **kwargs: Any,
) -> None:
    cols = table.column_names()
    pk = list(primary_key)
    upsert, delete, pk_idx = _snapshot_sql(table_name, cols, pk)

    from pathway_tpu_torch import delivery as _delivery

    if _delivery.resolve_mode(delivery) == "exactly_once":
        # exactly-once: UPSERT/DELETE records stage in the durable ledger and
        # land as one transaction per epoch; the pathway_delivery commit table
        # makes a crash-window re-publish a no-op (delivery/transports.py)
        transport = _delivery.PostgresDeliveryTransport(
            postgres_settings, {"u": upsert, "d": delete}
        )
        writer = _delivery.LedgerWriter(f"postgres.{table_name}", transport)

        def on_batch_ledger(batch, columns) -> None:
            for op, args in _net_snapshot_ops(batch, pk_idx):
                writer.append(0, (op, args))

        _register_writer(
            table,
            on_batch_ledger,
            f"postgres_snapshot:{table_name}",
            writer=writer,
        )
        return

    con = _connect(postgres_settings)

    def on_batch(batch, columns) -> None:
        with con.cursor() as cur:
            for op, args in _net_snapshot_ops(batch, pk_idx):
                cur.execute(upsert if op == "u" else delete, args)
        con.commit()

    _register_writer(table, on_batch, f"postgres_snapshot:{table_name}")
