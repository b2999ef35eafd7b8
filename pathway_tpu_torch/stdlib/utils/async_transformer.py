"""``pw.AsyncTransformer`` — async row transforms looped back into the dataflow.

Counterpart of the reference's async-transformer pair
(``python/pathway/stdlib/utils/async_transformer.py:370`` +
``src/engine/dataflow/async_transformer.rs``): each insertion of the input
table schedules ``invoke(**row)`` on a dedicated asyncio loop thread; each
completion is pushed — keyed by the ORIGINAL row id — into an upsert stream
source that re-enters the graph, so results arrive at later logical times
without ever blocking a tick. Deletions/updates of input rows retract or
replace their result rows (upsert session semantics).

Output surface matches the reference: ``output_table`` /
``finished`` (adds ``_async_status`` = "-SUCCESS-" | "-FAILURE-"),
``successful`` (status filtered out), ``failed``.

Carried from ``pathway_tpu/stdlib/utils/async_transformer.py``.
"""

from __future__ import annotations

import asyncio
import threading
from typing import Any

import pathway_tpu_torch as pw
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import schema as schema_mod

_ASYNC_STATUS_COLUMN = "_async_status"
_SUCCESS = "-SUCCESS-"
_FAILURE = "-FAILURE-"


class _ResultSubject(pw.io.python.ConnectorSubject):
    """Bridge from the asyncio loop back into the engine: results arrive via
    direct keyed pushes; ``run`` just waits for the transformer to drain."""

    def __init__(self, owner: "AsyncTransformer"):
        super().__init__()
        self.owner = owner
        self._done = threading.Event()

    @property
    def _session_type(self) -> str:
        return "upsert"

    def run(self) -> None:
        self._done.wait()

    def push_result(self, key: int, values: tuple | None) -> None:
        if self._node is not None:
            self._node.push(key, values, 1 if values is not None else -1)

    def finish(self) -> None:
        self._done.set()


class _AsyncDriver:
    """Connector driver: keeps the run alive while invocations are in flight.
    Finishes only after two consecutive idle checks (one-tick hysteresis), so
    results dispatched during the final drain tick still get ingested."""

    virtual = False

    def __init__(self, owner: "AsyncTransformer"):
        self.owner = owner
        self.subject = owner._subject
        self._prev_snapshot: tuple[int, int] | None = None

    def start(self) -> None:
        self.owner._start_loop()

    def is_finished(self) -> bool:
        o = self.owner
        snapshot = (o._dispatched, o._completed)
        idle = (
            o._dispatched == o._completed
            and snapshot == self._prev_snapshot
            and o._subject._node is not None
            and not o._subject._node._pending
        )
        self._prev_snapshot = snapshot
        if idle:
            self.subject.finish()
        return idle

    def stop(self) -> None:
        self.subject.finish()
        o = self.owner
        if o._loop is not None:
            o._loop.call_soon_threadsafe(lambda: None)


class AsyncTransformer:
    """Subclass with ``output_schema`` and an ``async def invoke(self, **row)``
    returning a dict matching the schema."""

    output_schema: Any = None

    def __init_subclass__(cls, /, output_schema=None, **kwargs):
        super().__init_subclass__(**kwargs)
        if output_schema is not None:
            cls.output_schema = output_schema

    def __init__(
        self,
        input_table: "pw.Table",
        *,
        instance: Any = None,
        autocommit_duration_ms: int | None = None,
    ):
        if self.output_schema is None:
            raise TypeError(
                "AsyncTransformer subclass needs output_schema "
                "(class Mine(pw.AsyncTransformer, output_schema=...))"
            )
        self._input_table = input_table
        self._loop: asyncio.AbstractEventLoop | None = None
        self._loop_thread: threading.Thread | None = None
        self._dispatched = 0
        self._completed = 0
        self._subject = _ResultSubject(self)

        out_cols = dict(self.output_schema.dtypes())
        out_cols[_ASYNC_STATUS_COLUMN] = dt.STR
        self._result_schema = schema_mod.schema_from_dtypes(out_cols)

        # the result source table (upsert by input-row key)
        self._output = pw.io.python.read(
            self._subject, schema=self._result_schema, name="async_transformer"
        )
        # register the driver + input subscription
        self._install()

    # -- user API -----------------------------------------------------------
    async def invoke(self, **kwargs) -> dict:
        raise NotImplementedError

    def open(self) -> None:
        """Called once on the loop thread before the first invoke."""

    def close(self) -> None:
        """Called once after the stream ends."""

    @property
    def output_table(self) -> "pw.Table":
        return self._output

    @property
    def finished(self) -> "pw.Table":
        return self._output

    @property
    def successful(self) -> "pw.Table":
        t = self._output
        ok = t.filter(t[_ASYNC_STATUS_COLUMN] == _SUCCESS)
        names = self.output_schema.column_names()
        return ok.select(**{n: ok[n] for n in names})

    @property
    def failed(self) -> "pw.Table":
        t = self._output
        bad = t.filter(t[_ASYNC_STATUS_COLUMN] == _FAILURE)
        names = self.output_schema.column_names()
        return bad.select(**{n: bad[n] for n in names})

    def with_options(self, **kwargs) -> "AsyncTransformer":
        if kwargs:
            import warnings

            warnings.warn(
                "AsyncTransformer.with_options: "
                f"{sorted(kwargs)} are not implemented yet and have NO effect "
                "(no retries, no capacity limit, no caching)",
                stacklevel=2,
            )
        return self

    # -- internals ----------------------------------------------------------
    def _start_loop(self) -> None:
        if self._loop_thread is not None:
            return
        ready = threading.Event()

        def loop_main() -> None:
            self._loop = asyncio.new_event_loop()
            asyncio.set_event_loop(self._loop)
            self.open()
            ready.set()
            self._loop.run_forever()

        self._loop_thread = threading.Thread(target=loop_main, daemon=True)
        self._loop_thread.start()
        ready.wait()

    def _install(self) -> None:
        in_cols = self._input_table._schema.column_names()
        out_names = self.output_schema.column_names()

        def on_change(key, row, time, is_addition):
            if not is_addition:
                # retraction: upsert session drops the result row
                self._subject.push_result(int(key), None)
                return
            self._start_loop()
            self._dispatched += 1

            async def task(key=int(key), row=dict(row)):
                try:
                    result = await self.invoke(**row)
                    values = tuple(result.get(n) for n in out_names) + (_SUCCESS,)
                except Exception as e:
                    import traceback

                    from pathway_tpu_torch.internals.error_log import log_error

                    log_error(
                        -1,
                        f"AsyncTransformer.invoke failed: {e!r}",
                        traceback.format_exc(),
                    )
                    values = tuple(None for _ in out_names) + (_FAILURE,)
                self._subject.push_result(key, values)
                self._completed += 1

            asyncio.run_coroutine_threadsafe(task(), self._loop)

        pw.io.subscribe(
            self._input_table, on_change=on_change, on_end=self._on_input_end
        )
        # the driver that holds the run open is registered by read(); add ours
        # for lifecycle: piggyback on the result subject's driver via hook
        from pathway_tpu_torch.internals.logical import LogicalNode

        output_lnode = self._output._node
        orig_hook = output_lnode.runtime_hook

        def hook(node, runtime):
            if orig_hook is not None:
                orig_hook(node, runtime)
            if runtime is not None:
                # replace the subject's thread driver with the async driver
                runtime.connectors[-1] = _AsyncDriver(self)

        output_lnode.runtime_hook = hook

    def _on_input_end(self) -> None:
        try:
            self.close()
        finally:
            pass
