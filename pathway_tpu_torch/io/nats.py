"""NATS connector (reference ``python/pathway/io/nats``): subscribe a topic
into a table (raw / plaintext / json formats) and publish a table's change
stream.

The ``nats-py`` client is asyncio-based and optional; a
``client_factory`` kwarg injects any object exposing the small synchronous
surface the connector uses (``connect(uri) -> conn`` with
``subscribe(topic) -> iterator of payload bytes`` / ``publish(topic, bytes)``
/ ``close()``) — CI drives it with an in-memory fake. When ``nats-py`` IS
importable, the real client is adapted onto that surface with a private
asyncio loop per connector thread."""

from __future__ import annotations

import queue as _queue
import time as _time
from typing import Any

from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io._format import parser_for


class _NatsPyAdapter:
    """nats-py (asyncio) → the connector's synchronous client surface."""

    def connect(self, uri: str):
        import asyncio
        import threading

        import nats  # gated import

        loop = asyncio.new_event_loop()
        threading.Thread(target=loop.run_forever, daemon=True).start()

        def call(coro):
            import asyncio as _a

            return _a.run_coroutine_threadsafe(coro, loop).result(30)

        nc = call(nats.connect(uri))

        class _Conn:
            def subscribe(self, topic):
                q: _queue.Queue = _queue.Queue()

                async def cb(msg):
                    q.put(msg.data)

                call(nc.subscribe(topic, cb=cb))

                def it():
                    while True:
                        try:
                            yield q.get(timeout=0.1)
                        except _queue.Empty:
                            yield None

                return it()

            def publish(self, topic, payload: bytes):
                call(nc.publish(topic, payload))

            def close(self):
                call(nc.drain())
                loop.call_soon_threadsafe(loop.stop)

        return _Conn()


def _client(kwargs: dict):
    factory = kwargs.pop("client_factory", None)
    if factory is not None:
        return factory
    try:
        import nats  # noqa: F401
    except ImportError:
        raise NotImplementedError(
            "pw.io.nats requires the nats-py client (or a client_factory= "
            "kwarg), which is not available in this environment"
        ) from None
    return _NatsPyAdapter()


def read(
    uri: str,
    topic: str,
    *,
    schema: schema_mod.SchemaMetaclass | None = None,
    format: str = "raw",  # noqa: A002
    name: str | None = None,
    **kwargs: Any,
) -> Table:
    factory = _client(kwargs)
    if format == "raw":
        schema = schema_mod.schema_from_types(data=bytes)
        parser = None
    elif format == "plaintext":
        schema = schema_mod.schema_from_types(data=str)
        parser = None
    elif format == "json":
        if schema is None:
            raise ValueError("schema required for the json format")
        parser = parser_for("json", schema)
    else:
        raise ValueError(f"unknown NATS format {format!r}")

    from pathway_tpu_torch.io._format import RawMessage
    from pathway_tpu_torch.io.python import ConnectorSubject, read as py_read

    fmt = format

    class _NatsSubject(ConnectorSubject):
        def __init__(self) -> None:
            super().__init__()
            self._stop = False

        def run(self) -> None:
            conn = factory.connect(uri)
            try:
                for payload in conn.subscribe(topic):
                    if self._stop:
                        return
                    if payload is None:
                        continue
                    if fmt == "raw":
                        self.next(data=bytes(payload))
                    elif fmt == "plaintext":
                        self.next(
                            data=payload.decode(errors="replace")
                            if isinstance(payload, bytes)
                            else str(payload)
                        )
                    else:
                        for ev in parser.parse(RawMessage(value=payload)):
                            self._push(ev.values, diff=ev.diff)
            finally:
                try:
                    conn.close()
                except Exception:
                    pass

        def on_stop(self) -> None:
            self._stop = True

    return py_read(_NatsSubject(), schema=schema, name=name or f"nats:{topic}")


def write(
    table: Table,
    uri: str,
    topic: str,
    *,
    format: str = "json",  # noqa: A002
    name: str | None = None,
    **kwargs: Any,
) -> None:
    from pathway_tpu_torch.io._format import formatter_for

    if format not in ("json", "raw", "plaintext"):
        raise ValueError(f"unknown NATS format {format!r}")
    factory = _client(kwargs)
    cols = table.column_names()
    if format != "json" and len(cols) != 1:
        raise ValueError(
            f"NATS {format!r} write requires a single-column table; "
            f"got {len(cols)} columns (use format='json')"
        )
    fmt = formatter_for("json", cols) if format == "json" else None
    conn_holder: dict = {}

    def on_batch(batch, columns) -> None:
        conn = conn_holder.get("c")
        if conn is None:
            conn = conn_holder["c"] = factory.connect(uri)
        for key, diff, row in batch.rows():
            if fmt is not None:
                payload = fmt.format(int(key), row, batch.time, diff)
                if not isinstance(payload, bytes):
                    payload = payload.encode()
            else:  # raw/plaintext single column
                v = row[0]
                payload = v if isinstance(v, bytes) else str(v).encode()
            conn.publish(topic, payload)

    def on_done() -> None:
        conn = conn_holder.pop("c", None)
        if conn is not None:
            # drain buffered publishes (the real nats-py adapter's close()
            # flushes; without it tail messages die in the transport buffer)
            conn.close()

    from pathway_tpu_torch.engine import operators as ops
    from pathway_tpu_torch.internals.logical import LogicalNode

    LogicalNode(
        lambda: ops.CallbackOutputNode(cols, on_batch, on_done),
        [table._node],
        name=name or f"nats_write:{topic}",
    )._register_as_output()
