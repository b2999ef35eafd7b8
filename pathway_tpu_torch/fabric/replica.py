"""Read-only serving replicas: serve a table from every process.

``pw.io.http.serve_table(table, route=..., key_column=...)`` turns a live
table into a GET lookup endpoint. The authoritative copy lives where the
table's changelog lands (the subscribe sink on worker 0 — the write pod);
with the fabric on, every OTHER process keeps a :class:`ReplicaStore` fed by
the changelog casts the owner broadcasts at tick end, and its front door
answers lookups LOCALLY — query fan-out scales beyond the write pod, which
is the whole point of a serving replica.

Staleness is bounded and measured, never silent: every cast (delta or
empty frontier stamp) carries the owner's wall clock; a replica's lag is
``now - last_stamp``, exposed per route on ``/status`` and as the
``pathway_fabric_replica_lag_seconds`` gauge. A replica whose lag exceeds
``PATHWAY_FABRIC_MAX_STALENESS_MS`` stops answering locally and forwards
the lookup to the owner (counted as a fallback) until the feed catches up.
A replica that detects a sequence gap (it missed a cast — e.g. it joined
late or a cast send failed) re-syncs by pulling a full snapshot over the
fabric RPC plane; per-key last-write-wins application makes overlapping
snapshot+delta replay convergent.

Single-process runs serve the same route from the authoritative store with
zero staleness — ``serve_table`` needs no fabric to be useful.

Carried from ``pathway_tpu/fabric/replica.py``.
"""

from __future__ import annotations

import json as _json
import threading
import time as _time
import weakref
from typing import Any

#: every serve_table route ever defined (weak; the fabric filters by graph
#: generation, exactly like the REST route registry)
_TABLE_ROUTES: "weakref.WeakSet[TableRoute]" = weakref.WeakSet()


class ReplicaStore:
    """One table route's key→row state plus changelog bookkeeping."""

    def __init__(self, route: str, key_column: str):
        self.route = route
        self.key_column = key_column
        self._lock = threading.Lock()
        self.rows: dict[str, dict] = {}
        #: last applied changelog sequence (one per owner tick that changed
        #: the table); replicas detect missed casts by gaps here
        self.seq = 0
        #: owner wall-clock stamp of the last applied cast/frontier — the
        #: measured-staleness anchor (0.0 = never synced)
        self.synced_unix = 0.0
        self.applied_total = 0
        #: True on the process whose subscribe feeds this store directly
        self.is_owner = False
        # ---- shard-map mode (PATHWAY_SHARDMAP=on): ownership of a served
        # table is PER KEY RANGE, so the changelog has one authoritative
        # source per process and freshness must be tracked per source —
        # a replica fresh for p1's slice may be stale for p2's
        #: this process's source id (its pid) once the fabric binds it
        self.self_src: int | None = None
        #: per-source last applied changelog sequence
        self.src_seq: dict[int, int] = {}
        #: per-source owner wall-clock stamp of the last cast/frontier
        self.src_synced: dict[int, float] = {}

    def __len__(self) -> int:
        with self._lock:
            return len(self.rows)

    def apply(self, deltas: list, seq: int, ts_unix: float) -> None:
        """Apply one changelog batch: ``(key_str, row_dict, diff)`` in emission
        order (retract-then-insert within a key is an upsert). Last write
        wins per key, so replaying an overlap (snapshot + already-applied
        deltas) converges instead of corrupting."""
        with self._lock:
            for k, row, diff in deltas:
                if diff > 0:
                    self.rows[k] = row
                else:
                    self.rows.pop(k, None)
            if seq > self.seq:
                self.seq = seq
            if ts_unix > self.synced_unix:
                self.synced_unix = ts_unix
            self.applied_total += len(deltas)

    def frontier(self, seq: int, ts_unix: float) -> None:
        """An empty cast: nothing changed, but the owner is alive at
        ``ts_unix`` — freshness advances without data."""
        with self._lock:
            if seq > self.seq:
                self.seq = seq
            if ts_unix > self.synced_unix:
                self.synced_unix = ts_unix

    def install_snapshot(self, rows: dict, seq: int, ts_unix: float) -> None:
        with self._lock:
            if seq < self.seq:
                return  # raced an already-newer delta feed; keep it
            self.rows = dict(rows)
            self.seq = seq
            if ts_unix > self.synced_unix:
                self.synced_unix = ts_unix

    def lookup(self, key: str) -> dict | None:
        with self._lock:
            return self.rows.get(key)

    def lag_s(self, now_unix: float | None = None) -> float | None:
        """Measured staleness in seconds: 0 on the owner, ``None`` on a
        replica that has never synced (maximally stale), else the age of the
        last owner stamp."""
        if self.is_owner:
            return 0.0
        if self.synced_unix == 0.0:
            return None
        return max(0.0, (now_unix or _time.time()) - self.synced_unix)

    # ---------------------------------------------------- shard-map (per-src)
    def apply_from(self, src: int, deltas: list, seq: int, ts_unix: float) -> None:
        """:meth:`apply`, attributed to one authoritative source process —
        the shard-map replica feed where every process casts its own slice."""
        with self._lock:
            for k, row, diff in deltas:
                if diff > 0:
                    self.rows[k] = row
                else:
                    self.rows.pop(k, None)
            if seq > self.src_seq.get(src, 0):
                self.src_seq[src] = seq
            if ts_unix > self.src_synced.get(src, 0.0):
                self.src_synced[src] = ts_unix
            self.applied_total += len(deltas)

    def frontier_from(self, src: int, seq: int, ts_unix: float) -> None:
        with self._lock:
            if seq > self.src_seq.get(src, 0):
                self.src_seq[src] = seq
            if ts_unix > self.src_synced.get(src, 0.0):
                self.src_synced[src] = ts_unix

    def src_gap(self, src: int, prev_seq: int) -> bool:
        """True when ``src``'s pending deltas don't connect to local state."""
        with self._lock:
            return prev_seq > self.src_seq.get(src, 0)

    def lag_from(self, src: int, now_unix: float | None = None) -> float | None:
        """Staleness of ``src``'s slice: 0 when this process IS the source,
        ``None`` when that slice never synced, else the stamp's age."""
        if src == self.self_src:
            return 0.0
        ts = self.src_synced.get(src, 0.0)
        if ts == 0.0:
            return None
        return max(0.0, (now_unix or _time.time()) - ts)

    def install_slice(
        self, src: int, rows: dict, seq: int, ts_unix: float, owned_fn
    ) -> None:
        """Install a snapshot of ONE source's slice: drop every local row the
        source owns (``owned_fn(key) -> True``) that the snapshot no longer
        carries, then last-write-wins the snapshot rows in — convergent under
        concurrent delta casts from the same source."""
        with self._lock:
            if seq < self.src_seq.get(src, 0):
                return  # raced an already-newer delta feed; keep it
            for k in [k for k in self.rows if owned_fn(k) and k not in rows]:
                del self.rows[k]
            self.rows.update(rows)
            self.src_seq[src] = seq
            if ts_unix > self.src_synced.get(src, 0.0):
                self.src_synced[src] = ts_unix


class TableRoute:
    """One served table: route metadata + the local store + replica counters."""

    def __init__(self, route: str, key_column: str, state: Any, store: ReplicaStore):
        self.route = route
        self.key_column = key_column
        self.state = state  # the _RouteServing carrying door counters/limits
        self.store = store
        self.local_answers = 0  # lookups answered from the local store
        self.fallbacks = 0  # stale-replica lookups forwarded to the owner
        self.casts_out = 0  # owner: changelog casts broadcast

    def replica_snapshot(self) -> dict[str, Any]:
        store = self.store
        lag = store.lag_s()
        out = {
            "route": self.route,
            "rows": len(store),
            "seq": store.seq,
            "lag_s": None if lag is None else round(lag, 3),
            "is_owner": store.is_owner,
            "local_answers": self.local_answers,
            "fallbacks": self.fallbacks,
            "applied_total": store.applied_total,
        }
        if store.src_seq:  # shard-map mode only: per-source feed positions
            out["srcs"] = {str(s): store.src_seq[s] for s in sorted(store.src_seq)}
        return out


def live_table_routes(runtime=None) -> list[TableRoute]:
    """Table routes attached to ``runtime`` (its driver hook or the fabric
    bound them), or — with ``runtime=None`` — the current graph generation's."""
    if runtime is not None:
        return sorted(
            (t for t in list(_TABLE_ROUTES) if t.state.runtime is runtime),
            key=lambda t: t.route,
        )
    from pathway_tpu_torch.internals.parse_graph import G

    return sorted(
        (t for t in list(_TABLE_ROUTES) if t.state.graph_gen == G.generation),
        key=lambda t: t.route,
    )


def lookup_response(troute: TableRoute, key: str | None) -> tuple[int, str]:
    """(status, body) of one lookup against a store — shared by the owner's
    HTTP handler, replica doors and the owner-side fabric RPC, so every
    door's bytes match."""
    if key is None:
        return 400, _json.dumps({"error": f"missing {troute.key_column}="})
    row = troute.store.lookup(str(key))
    if row is None:
        return 404, _json.dumps({"error": "unknown key", troute.key_column: key})
    from pathway_tpu_torch.io.http._server import _jsonable

    return 200, _json.dumps(_jsonable(row))


def serve_table(
    table: Any,
    *,
    route: str,
    key_column: str,
    host: str = "0.0.0.0",
    port: int = 8080,
    webserver: Any = None,
    documentation: Any = None,
    rate_limit: float | None = None,
    api_keys: Any = None,
) -> TableRoute:
    """Serve ``table`` as a read-only GET lookup endpoint at ``route``.

    ``GET {route}?{key_column}=<value>`` answers the current row whose
    ``key_column`` stringifies to ``<value>`` (404 for unknown keys) — the
    classic serving-cache shape. The backing store applies the table's own
    changelog (a subscribe sink), so answers track the live dataflow; with
    the fabric on, every cluster process answers locally from its replica
    within the configured staleness bound. Front-door protection
    (``rate_limit`` / ``api_keys`` / the ``PATHWAY_SERVE_*`` env knobs)
    applies exactly like ``rest_connector`` routes.
    """
    from pathway_tpu_torch.internals import schema as schema_mod
    from pathway_tpu_torch.io.http import _server as S

    ws = webserver or S.PathwayWebserver(host=host, port=port)
    store = ReplicaStore(route, key_column)
    # the lookup key arrives as a query-param string; the schema documents it
    schema = schema_mod.schema_from_types(**{key_column: str})
    state = S._RouteServing(route, ("GET",), schema)
    if rate_limit is not None:
        state.rate_limit_override = float(rate_limit)
    if api_keys is not None:
        state.api_keys_override = tuple(api_keys)
    S._ROUTES.add(state)
    troute = TableRoute(route, key_column, state, store)
    _TABLE_ROUTES.add(troute)
    state.extra_snapshot = troute.replica_snapshot

    from pathway_tpu_torch.io.http import _wire

    async def handler(request: _wire.Request) -> _wire.Response:
        state.requests_total += 1
        gated = S.gate_check(state, request.headers)
        if gated is not None:
            status, body, hdrs = gated
            return _wire.json_response(body, status=status, headers=hdrs or None)
        t0 = _time.time_ns()
        key = _wire.query_get(request, key_column)
        from pathway_tpu_torch import fabric as _fabric

        plane = _fabric.current()
        if plane is not None and getattr(plane, "shardmap", None) is not None:
            # shard-map mode: this door's store is authoritative only for its
            # own key ranges — route the lookup exactly like a peer door does
            status, body, headers = await plane.serve_table_lookup(troute, key)
        else:
            status, body = lookup_response(troute, key)
            troute.local_answers += 1
            lag = store.lag_s()
            headers = {
                "X-Pathway-Fabric": "owner" if store.is_owner else "local",
                **(
                    {"X-Pathway-Replica-Lag-Ms": str(round(lag * 1e3, 1))}
                    if lag is not None
                    else {}
                ),
            }
        if status == 200:
            state.responses_total += 1
            state.latency.observe((_time.time_ns() - t0) / 1e9)
        else:
            state.errors_total += 1
        return _wire.Response(status, body.encode("utf-8"), _wire.JSON, headers)

    ws._add_route(
        route,
        ["GET"],
        handler,
        meta={
            "schema": schema,
            "documentation": documentation,
            "serving": state,
            "table_route": troute,
        },
    )

    # the changelog feed: a subscribe sink on the served table. Callbacks run
    # on the process owning worker 0 (subscribe is SOLO-exchanged) — that
    # process is the authoritative store; at tick end the batch applies
    # locally and queues for the fabric's replica cast.
    columns = table.column_names()
    pending: list = []

    def on_change(key: int, row: dict, time: int, is_addition: bool) -> None:
        k = str(row.get(key_column))
        pending.append(
            (k, {c: row.get(c) for c in columns}, 1 if is_addition else -1)
        )

    def on_time_end(time: int) -> None:
        if not pending:
            return
        batch, pending[:] = list(pending), []
        store.apply(batch, store.seq + 1, _time.time())
        from pathway_tpu_torch import fabric as _fabric

        plane = _fabric.current()
        if plane is not None:
            plane.replica_publish(troute, batch)

    from pathway_tpu_torch.flow import validate_service_class
    from pathway_tpu_torch.internals.config import get_pathway_config

    # shard-map mode: route each changelog row to the worker owning the
    # LOOKUP key's hash — the same hash a door computes from the query param
    # (``stable_hash_obj(str(value))``) — so every process's subscribe slice
    # is exactly the key ranges it serves authoritatively
    route_by = None
    if get_pathway_config().shardmap == "on":
        import numpy as _np

        from pathway_tpu_torch.internals.keys import hash_column

        def route_by(batch):
            col = batch.data.get(key_column)
            if col is None:
                return batch.keys
            return hash_column(_np.array([str(v) for v in col], dtype=object))

    sub_lnode = table._subscribe_node(
        on_change=on_change,
        on_time_end=on_time_end,
        on_end=None,
        service_class=validate_service_class("interactive"),
        route_by=route_by,
    )
    sub_lnode._register_as_output()

    class _TableRouteDriver:
        """Starts the owner's webserver for the run (the rest_connector
        driver's little sibling — no engine input to flush)."""

        virtual = False

        def start(self) -> None:
            state.configure()
            store.is_owner = True
            ws.start()

        def is_finished(self) -> bool:
            return False  # a server runs until runtime.request_stop()

        def stop(self) -> None:
            with state.lock:
                state.closed = True
            ws.stop()

    def hook(node: Any, runtime: Any) -> None:
        if runtime is not None:
            state.runtime = runtime
            runtime.register_connector(_TableRouteDriver())

    # piggyback the driver registration on the subscribe node's build: the
    # hook fires once, on the primary build (worker 0's process)
    sub_lnode.runtime_hook = hook
    return troute
