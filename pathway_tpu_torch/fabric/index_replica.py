"""Replica-served retrieval: KNN answered at every front door.

The fabric (``routing.py``) makes every cluster process a front door, but an
engine-backed route —
``/v1/retrieve`` above all — still pays a fabric hop to the owner for every
request, so read qps is pinned to one process no matter how many doors the
pod opens. This module closes that gap for the dominant read-heavy RAG mix:

- **Changelog capture.** The :class:`~pathway_tpu_torch.stdlib.indexing._engine.
  ExternalIndexNode` already applies an exact per-tick backend mutation
  sequence (the same ops its delta snapshots persist). When a retrieval
  route is armed, every index node instance records those ops — extended
  with the raw document payload text — into its route's :class:`IndexRoute`
  feed. Because docs shard by key across workers, each PROCESS owns a
  disjoint slice of the changelog and casts it to every peer at tick end
  over the fabric's replica cast (membership-version-stamped, gap-detected,
  snapshot-RPC resync, idle frontier stamps — the plane in ``routing.py``).
- **Replica index.** Every process replays every slice through the SAME
  backend mutation API (``backend_factory()`` → ``add``/``remove``) into a
  full-corpus :class:`ReplicaIndex`, so a replica search is byte-identical
  to the owner's sharded search + merge in the exact regime (BruteForce /
  the tiered backend's exact tiers; IVF/LSH stay approximate and are
  covered by the recall@10 gate instead).
- **Local answers.** A door answers ``/v1/retrieve`` from its replica while
  every peer slice is fresher than ``PATHWAY_REPLICA_MAX_STALENESS_MS``;
  stale, never-synced, resyncing, or unembeddable-locally requests fall
  back to the owner forward — counted, never silently stale. The
  response bytes reproduce ``DocumentStore.retrieve_query`` exactly: same
  filter merge, same filter-compile error semantics, same
  ``(-score, tie_order)`` ordering, same JSON shape.

Staleness caveats are explicit rather than silent: a process restored from
an operator snapshot cannot re-derive its changelog slice (the backend
rebuilds from chunks without re-running ``process()``), so it answers the
snapshot RPC with ``None`` and peers poison that source — the route falls
back to forwarding until fresh ops repopulate it. Input-log replay (the
default cluster resilience path) re-derives the slice completely and
converges by last-write-wins.

Carried from ``pathway_tpu/fabric/index_replica.py``.
"""

from __future__ import annotations

import asyncio
import json as _json
import threading
import time as _time
import weakref
from typing import Any, Callable

#: every armed retrieval route ever defined (weak; the fabric filters by
#: graph generation, exactly like the REST route / table-route registries)
_INDEX_ROUTES: "weakref.WeakSet[IndexRoute]" = weakref.WeakSet()

#: the route being wired by DataIndex._raw_reply right now (see capturing())
_CAPTURE: "IndexRoute | None" = None

#: sentinel: the query cannot be embedded on this door (async/remote
#: embedder) — the caller must forward to the owner
_UNEMBEDDABLE = object()


def current_capture() -> "IndexRoute | None":
    """The :class:`IndexRoute` being wired right now, or None — read by
    ``DataIndex._raw_reply`` to decide whether to capture the index node."""
    return _CAPTURE


class _Capturing:
    def __init__(self, iroute: "IndexRoute | None"):
        self._iroute = iroute
        self._prev: "IndexRoute | None" = None

    def __enter__(self):
        global _CAPTURE
        self._prev = _CAPTURE
        _CAPTURE = self._iroute
        return self._iroute

    def __exit__(self, *exc):
        global _CAPTURE
        _CAPTURE = self._prev
        return False


def capturing(iroute: "IndexRoute | None") -> _Capturing:
    """Arm ``iroute`` as the capture target while a retrieval handler's
    dataflow is being defined (``capturing(None)`` is a no-op context)."""
    return _Capturing(iroute)


class ReplicaIndex:
    """Full-corpus replica of one route's index, replayed per source slice.

    ``rows`` shadows the backend with ``key -> (item, meta, payload, src)``
    so local answers can join scores back to the raw text and snapshot RPCs
    can serve exactly this process's authoritative slice. Freshness, gap
    detection and snapshot install are per SOURCE process — docs shard by
    key, so slices are disjoint and interleaving across sources is safe.
    """

    def __init__(self, backend_factory: Callable[[], Any]):
        self._backend_factory = backend_factory
        self._lock = threading.RLock()
        self.backend = backend_factory()
        self.rows: dict[int, tuple] = {}
        self.self_src: int = 0
        self.src_seq: dict[int, int] = {}
        self.src_synced: dict[int, float] = {}
        #: sources whose changelog cannot be trusted complete (their snapshot
        #: RPC was refused after a restore) — lag_from() treats them as
        #: never-synced until a snapshot installs
        self.poisoned: set[int] = set()
        #: False once this process restored its index from an operator
        #: snapshot: the slice rows were never re-derived, so the snapshot
        #: RPC must refuse rather than hand peers a silently-empty slice
        self.self_authoritative = True
        self.applied_total = 0
        self.gaps_total = 0
        self.resyncs_total = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self.rows)

    def _maintain(self) -> None:
        maintain = getattr(self.backend, "maintain", None)
        if maintain is not None:
            maintain()

    def apply_ops(
        self, src: int, ops: list, seq: int | None, ts_unix: float
    ) -> None:
        """Replay one changelog batch — ``("a", key, item, meta, payload)`` /
        ``("r", key)`` in emission order — through the backend mutation API.
        Re-adding a live key removes it first (last write wins), so replaying
        a snapshot/delta overlap converges instead of corrupting."""
        with self._lock:
            for op in ops:
                key = int(op[1])
                if op[0] == "a":
                    if key in self.rows:
                        self.backend.remove(key)
                    self.backend.add(key, op[2], op[3])
                    self.rows[key] = (op[2], op[3], op[4], src)
                else:
                    self.backend.remove(key)
                    self.rows.pop(key, None)
            self.applied_total += len(ops)
            if seq is not None and seq > self.src_seq.get(src, 0):
                self.src_seq[src] = seq
            if ts_unix > self.src_synced.get(src, 0.0):
                self.src_synced[src] = ts_unix
            if ops:
                self._maintain()

    def frontier_from(self, src: int, seq: int, ts_unix: float) -> None:
        """Empty cast: the source is alive at ``ts_unix`` — freshness
        advances without data."""
        with self._lock:
            if seq > self.src_seq.get(src, 0):
                self.src_seq[src] = seq
            if ts_unix > self.src_synced.get(src, 0.0):
                self.src_synced[src] = ts_unix

    def src_gap(self, src: int, prev_seq: int) -> bool:
        """True when a source's pending ops don't connect to local state."""
        with self._lock:
            return prev_seq > self.src_seq.get(src, 0)

    def reset_src(self, src: int) -> None:
        """A source restarted its changelog counter (first cast has
        ``prev_seq == 0`` below our held position): accept the new epoch."""
        with self._lock:
            self.src_seq[src] = 0

    def poison(self, src: int) -> None:
        with self._lock:
            self.poisoned.add(src)

    def lag_from(self, src: int, now_unix: float | None = None) -> float | None:
        """Staleness of ``src``'s slice: 0 when this process IS the source,
        None when never synced (or poisoned), else the stamp's age."""
        with self._lock:
            if src == self.self_src:
                return 0.0
            if src in self.poisoned:
                return None
            ts = self.src_synced.get(src, 0.0)
        if ts == 0.0:
            return None
        return max(0.0, (now_unix or _time.time()) - ts)

    def remote_lag_s(self, n_proc: int) -> float | None:
        """Worst-case staleness over every REMOTE slice — the number a door
        compares against the staleness bound (None = some slice never
        synced, i.e. maximally stale)."""
        worst = 0.0
        now = _time.time()
        for src in range(n_proc):
            lag = self.lag_from(src, now)
            if lag is None:
                return None
            worst = max(worst, lag)
        return worst

    def self_slice(self) -> tuple[dict, int, float]:
        """This process's authoritative slice for the snapshot RPC:
        ``key -> (item, meta, payload)`` plus its changelog position."""
        with self._lock:
            rows = {
                k: (v[0], v[1], v[2])
                for k, v in self.rows.items()
                if v[3] == self.self_src
            }
            return rows, self.src_seq.get(self.self_src, 0), _time.time()

    def install_slice(
        self, src: int, rows: dict, seq: int, ts_unix: float
    ) -> None:
        """Install a snapshot of ONE source's slice: drop local rows
        attributed to that source the snapshot no longer carries, then
        last-write-wins the snapshot rows in. Accepts sequence regressions —
        a restarted source restarts its counter and its snapshot is still
        the freshest truth for its slice."""
        with self._lock:
            self.poisoned.discard(src)
            for k in [
                k for k, v in self.rows.items() if v[3] == src and k not in rows
            ]:
                self.backend.remove(k)
                del self.rows[k]
            for k, ent in rows.items():
                k = int(k)
                if k in self.rows:
                    self.backend.remove(k)
                self.backend.add(k, ent[0], ent[1])
                self.rows[k] = (ent[0], ent[1], ent[2], src)
            self.src_seq[src] = max(seq, 0)
            if ts_unix > self.src_synced.get(src, 0.0):
                self.src_synced[src] = ts_unix
            self._maintain()

    def search_one(self, item: Any, k: int, flt: Callable) -> list[tuple]:
        """One query against the full-corpus replica: ``(key, score, row)``
        triples, backend order (the caller re-sorts by the owner's merge
        discipline)."""
        with self._lock:
            hits = self.backend.search([item], [k], [flt])[0]
            return [
                (int(key), float(score), self.rows.get(int(key)))
                for key, score in hits
            ]


class IndexRoute:
    """One armed retrieval route: capture wiring + the replica + counters."""

    def __init__(self, route: str, embedder: Any, graph_gen: int):
        self.route = route
        self.embedder = embedder
        self.graph_gen = graph_gen
        self.state: Any = None  # the route's _RouteServing, set by the server
        self.inner: Any = None  # the captured InnerIndex
        self.replica: ReplicaIndex | None = None
        #: True when more than one InnerIndex bound (hybrid/composite index):
        #: a single replica cannot reproduce the composition — always forward
        self.composite = False
        self._lock = threading.Lock()
        self._pending: list = []
        self._self_seq = 0
        self._build_token: int | None = None
        self._filter_cache: dict = {}
        self.local_answers = 0
        self.fallbacks = 0
        self.fallback_reasons: dict[str, int] = {}
        self.casts_out = 0

    # -------------------------------------------------------------- wiring
    def bind(self, inner: Any) -> None:
        """Called by ``DataIndex._raw_reply`` under ``capturing(self)``."""
        if self.inner is not None and inner is not self.inner:
            self.composite = True
            return
        self.inner = inner
        if self.replica is None and inner.backend_factory is not None:
            self.replica = ReplicaIndex(inner.backend_factory)

    def attach_node(self, node: Any) -> None:
        """Called from the captured node factory at BUILD time, on every
        worker of every process. The first attach of a new run resets the
        replica (graphs rebuild per run; stale state must not leak), then
        every instance feeds the same route."""
        from pathway_tpu_torch.internals.logical import current_build

        b = current_build()
        token = (
            id(b.shared_runtime)
            if b is not None and b.shared_runtime is not None
            else id(b)
        )
        if token != self._build_token:
            self._build_token = token
            self.reset()
        node.replica_feed = self

    def reset(self) -> None:
        with self._lock:
            self._pending = []
            self._self_seq = 0
        if self.inner is not None and self.inner.backend_factory is not None:
            self.replica = ReplicaIndex(self.inner.backend_factory)
            from pathway_tpu_torch.internals.config import get_pathway_config

            self.replica.self_src = get_pathway_config().process_id

    # ---------------------------------------------------------------- feed
    def note_ops(self, ops: list) -> None:
        """Engine thread: one tick's backend mutations for this worker's doc
        shard. Applied to the local replica immediately (the self slice has
        zero lag) and queued for the next peer cast."""
        rep = self.replica
        if rep is None:
            return
        rep.apply_ops(rep.self_src, ops, None, _time.time())
        with self._lock:
            self._pending.extend(ops)

    def note_restored(self) -> None:
        """The engine restored this route's index from an operator snapshot:
        the changelog slice was never re-derived, so this process must not
        serve snapshot RPCs claiming completeness."""
        rep = self.replica
        if rep is not None:
            rep.self_authoritative = False

    def outbox_pending(self) -> bool:
        with self._lock:
            return bool(self._pending)

    def drain_ops(self) -> tuple[list, int, int]:
        """Fabric tick-end drain: ``(ops, prev_seq, seq)``. The sequence
        advances only on non-empty drains, so empty frontier stamps never
        masquerade as missed data casts."""
        with self._lock:
            ops, self._pending = self._pending, []
            prev = self._self_seq
            if ops:
                self._self_seq += 1
            seq = self._self_seq
        rep = self.replica
        if rep is not None and ops:
            with rep._lock:
                if seq > rep.src_seq.get(rep.self_src, 0):
                    rep.src_seq[rep.self_src] = seq
        return ops, prev, seq

    # --------------------------------------------------------- local answer
    def _filter(self, expr: str | None):
        """Compile a merged filter with EXACTLY the engine node's error
        semantics: evaluation errors exclude the doc, a malformed filter
        yields None → the empty reply (never an exception)."""
        if expr not in self._filter_cache:
            from pathway_tpu_torch.stdlib.indexing._filters import compile_filter

            try:
                compiled = compile_filter(expr)

                def safe(md, _f=compiled):
                    try:
                        return bool(_f(md))
                    except Exception:
                        return False

                self._filter_cache[expr] = safe
            except Exception:
                self._filter_cache[expr] = None
        return self._filter_cache[expr]

    def embed_query(self, text: str) -> Any:
        """The query item, embedded exactly like the owner's microbatch path
        embeds it, or :data:`_UNEMBEDDABLE` when this door can't reproduce
        it (async/remote embedders always forward)."""
        emb = self.embedder
        if emb is None:
            return text  # lexical backends (BM25) search the raw text
        try:
            fn = emb.func
        except Exception:
            return _UNEMBEDDABLE
        if fn is None or asyncio.iscoroutinefunction(fn):
            return _UNEMBEDDABLE
        cap = getattr(emb, "_memo_cap", None)
        try:
            if cap is not None and cap == 0:
                # unmemoized encoder embedder: the owner's microbatch dispatcher
                # pads the launch to a power-of-two bucket with replicas of
                # real rows, and length-bucketing makes final float bits
                # depend on batch composition — reproduce the solo-query pad
                from pathway_tpu_torch.ops.microbatch import bucket_size

                n = bucket_size(
                    1,
                    min_bucket=int(getattr(emb, "microbatch_min_bucket", 8)),
                    max_bucket=int(getattr(emb, "microbatch_max_batch", 512)),
                )
                return fn([text] * n)[0]
            # memoized (the memo path re-pads deduped misses identically) or
            # batch-independent embedders: a bare single-text call matches
            return fn([text])[0]
        except Exception:
            return _UNEMBEDDABLE

    def replica_snapshot(self, n_proc: int | None = None) -> dict[str, Any]:
        rep = self.replica
        out: dict[str, Any] = {
            "route": self.route,
            "armed": rep is not None and not self.composite,
            "rows": 0 if rep is None else len(rep),
            "local_answers": self.local_answers,
            "fallbacks": self.fallbacks,
            "fallback_reasons": dict(self.fallback_reasons),
            "casts_out": self.casts_out,
        }
        if rep is not None:
            with rep._lock:
                out["applied_total"] = rep.applied_total
                out["gaps_total"] = rep.gaps_total
                out["resyncs_total"] = rep.resyncs_total
                out["self_authoritative"] = rep.self_authoritative
                out["srcs"] = {
                    str(s): rep.src_seq[s] for s in sorted(rep.src_seq)
                }
            if n_proc is not None:
                lag = rep.remote_lag_s(n_proc)
                out["lag_s"] = None if lag is None else round(lag, 3)
        return out


def live_index_routes(runtime=None) -> list[IndexRoute]:
    """Armed index routes attached to ``runtime`` (their serving state was
    bound), or — with ``runtime=None`` — the current graph generation's."""
    if runtime is not None:
        return sorted(
            (
                r
                for r in list(_INDEX_ROUTES)
                if r.state is not None and r.state.runtime is runtime
            ),
            key=lambda r: r.route,
        )
    from pathway_tpu_torch.internals.parse_graph import G

    return sorted(
        (r for r in list(_INDEX_ROUTES) if r.graph_gen == G.generation),
        key=lambda r: r.route,
    )


def maybe_arm(route: str, document_store: Any) -> IndexRoute | None:
    """Create an :class:`IndexRoute` for a DocumentStore retrieval endpoint
    when replica serving can apply (cluster run, fabric on, replica on) —
    else None and the owner-forward path stays byte-for-byte. The caller must
    hold the returned route (the registry is weak) and define the retrieval
    dataflow under ``capturing(route)``."""
    from pathway_tpu_torch.internals.config import get_pathway_config

    cfg = get_pathway_config()
    if cfg.replica == "off" or cfg.fabric == "off" or cfg.processes <= 1:
        return None
    from pathway_tpu_torch.internals.parse_graph import G

    embedder = getattr(document_store.retriever_factory, "embedder", None)
    iroute = IndexRoute(route, embedder, G.generation)
    _INDEX_ROUTES.add(iroute)
    return iroute


def local_retrieve_response(
    iroute: IndexRoute, vals: dict[str, Any]
) -> tuple[str, list] | None:
    """Answer one ``/v1/retrieve`` request from the replica: ``(body, spans)``
    with bytes identical to ``DocumentStore.retrieve_query`` through the
    owner, or None → the door falls back to forwarding. ``vals`` is the
    schema-ordered row mapping (query, k, metadata_filter,
    filepath_globpattern) the door already built."""
    rep = iroute.replica
    if rep is None or iroute.composite:
        return None
    query = vals.get("query")
    k = vals.get("k")
    if query is None or k is None:
        return None  # the owner path defines the (error) behavior
    try:
        k = int(k)
    except (TypeError, ValueError):
        return None
    from pathway_tpu_torch.xpacks.llm.document_store import _as_dict, combine_filters

    flt_expr = combine_filters(
        vals.get("metadata_filter"), vals.get("filepath_globpattern")
    )
    flt = iroute._filter(flt_expr)
    spans: list = []
    if flt is None:
        pairs: list[tuple] = []  # malformed filter → the empty reply
    else:
        e0 = _time.time_ns()
        item = iroute.embed_query(str(query))
        e1 = _time.time_ns()
        if item is _UNEMBEDDABLE:
            return None
        spans.append(("replica/embed", e0, e1, None))
        s0 = _time.time_ns()
        pairs = rep.search_one(item, k, flt)
        spans.append(("replica/search", s0, _time.time_ns(), {"rows": len(pairs)}))
    # the owner's MergeIndexRepliesNode orders the merged union by
    # (score desc, tie-order asc) and cuts to k; the groupby sort and the
    # final dist sort are stable, so reproducing that order here reproduces
    # the response bytes
    from pathway_tpu_torch.internals.keys import tie_order

    pairs.sort(key=lambda ent: (-ent[1], tie_order(ent[0])))
    out = []
    for _key, score, row in pairs[:k]:
        if row is None or row[2] is None:
            # the row raced a removal, or its payload text was never cast
            # (restored source): the replica cannot build the owner's bytes
            return None
        out.append(
            {"text": row[2], "metadata": _as_dict(row[1]), "dist": -score}
        )
    out.sort(key=lambda d: d["dist"])
    from pathway_tpu_torch.io.http._server import _jsonable

    return _json.dumps(_jsonable(out)), spans


def heartbeat_summary(runtime, n_proc: int | None = None) -> dict | None:
    """route → compact replica counters for this process — rides the
    heartbeat telemetry block so the coordinator can roll replica health up
    cluster-wide, as the serving counters do."""
    routes = live_index_routes(runtime)
    if not routes:
        return None
    out = {}
    for r in routes:
        snap = r.replica_snapshot(n_proc)
        out[r.route] = {
            "rows": snap["rows"],
            "lag_s": snap.get("lag_s"),
            "local": snap["local_answers"],
            "fallbacks": snap["fallbacks"],
            "gaps": snap.get("gaps_total", 0),
            "resyncs": snap.get("resyncs_total", 0),
        }
    return out
