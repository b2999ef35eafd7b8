"""Row lineage: bounded provenance rings + the ``/explain`` backward walk.

"Why is this row here?" — the question every incremental pipeline operator
eventually asks a sink. This module answers it without a general provenance
database: the engine's key discipline already encodes most of the lineage
(stateless operators PRESERVE row keys; only a small closed set of operators
derives new keys — reindex, groupby, join, flatten, salted concat), so it is
enough to remember, at each key-DERIVING operator edge, a bounded ring of
``output key → contributing input keys``, plus a bounded ring of recent rows
at every input connector and sink. ``/explain?sink=&key=`` then walks the operator graph backward from the
sink: key-deriving nodes map the key set through their recorded ring,
key-preserving nodes pass it unchanged, and the walk bottoms out at input
connectors, reporting the contributing input rows, the operator path, and the
trace span ids of the ticks that carried them (when ``PATHWAY_TRACE`` is on,
so the answer links straight into the span stream).

Overhead discipline (shared with the audit plane): recording on the tick path
only PARKS array references — one list append per batch at key-deriving
edges, inputs and sinks — and the per-row ring fold runs lazily when
``/explain`` or ``/status`` actually reads, over at most the bounded recent
window. Bounded by design: each ring holds ``PATHWAY_LINEAGE_KEYS`` output
keys (oldest evicted first) with at most 8 contributing input keys each;
parked logs drop their oldest batches past ~2× that many rows, so a
long-running stream pins O(cap) memory per edge. Lineage rides the audit
plane (``PATHWAY_AUDIT``) and is disabled with it, or alone via
``PATHWAY_LINEAGE_KEYS=0``.

Carried from ``pathway_tpu/observability/lineage.py`` with imports rewritten.
Left out: the reference's ``pathway_tpu explain`` command line (``cli.py``,
ROADMAP Queue 1 item 7); ``/explain`` on the monitoring server serves the
same walk.
"""

from __future__ import annotations

import itertools
import threading
import time as _time
from typing import Any

import numpy as np

from pathway_tpu_torch import observability as _obs

#: contributing input keys remembered per output key (a groupby group or a
#: flatten fan-in beyond this keeps its first seen contributors)
_MAX_CONTRIB = 8

#: upstream breadth cap for one /explain walk — keeps a hub key (e.g. a
#: global-reduce group) from dragging the whole input through the response
_WALK_KEYS = 64


class _Ring:
    """Bounded insertion-ordered map out_key -> list of contributor entries."""

    __slots__ = ("cap", "data")

    def __init__(self, cap: int):
        self.cap = cap
        self.data: dict[int, list] = {}

    def add(self, out_key: int, contrib: Any) -> None:
        lst = self.data.get(out_key)
        if lst is None:
            if len(self.data) >= self.cap:
                # evict a batch of the oldest (insertion order) so eviction
                # amortizes — recent rows stay explainable. Collect keys
                # FIRST: deleting while iterating invalidates the iterator.
                n = max(1, self.cap // 64)
                for k in list(itertools.islice(iter(self.data), n)):
                    del self.data[k]
            self.data[out_key] = [contrib]
        elif len(lst) < _MAX_CONTRIB and contrib not in lst:
            lst.append(contrib)

    def put(self, out_key: int, entry: Any) -> None:
        """Last-write-wins single-entry slot (input/sink row rings)."""
        self.data.pop(out_key, None)
        self.add(out_key, entry)


class _ParkedLog:
    """Hot-path side of a ring: parked per-batch records, bounded by total
    rows (oldest dropped first — recent rows are what /explain serves).
    Trimming happens inline on park, so a never-read log on a long-running
    stream pins O(bound) memory, not O(history)."""

    __slots__ = ("items", "rows", "bound")

    def __init__(self, bound: int):
        from collections import deque

        self.items: Any = deque()
        self.rows = 0
        self.bound = bound

    def park(self, rec: tuple, n: int) -> None:
        self.items.append((rec, n))
        self.rows += n
        while self.rows > self.bound and len(self.items) > 1:
            _, dropped = self.items.popleft()
            self.rows -= dropped

    def drain(self) -> list[tuple]:
        """Take the parked records (already bounded by park)."""
        items, self.items = self.items, type(self.items)()
        self.rows = 0
        return [rec for rec, _ in items]


class LineageStore:
    """Per-run provenance state (one per process; nodes index by position)."""

    def __init__(self, cap: int):
        self.cap = cap
        self._lock = threading.Lock()
        # folded rings
        self.edges: dict[int, _Ring] = {}  # node_index -> out_key -> [in_key]
        self.inputs: dict[int, _Ring] = {}  # node_index -> key -> (row, tick, span)
        self.sinks: dict[str, _Ring] = {}  # sink label -> key -> (row, tick, diff, span)
        # parked (hot-path) logs, folded lazily on read
        self._edge_log: dict[int, _ParkedLog] = {}
        self._input_log: dict[int, _ParkedLog] = {}
        self._sink_log: dict[str, _ParkedLog] = {}
        self.recorded_pairs = 0

    # ------------------------------------------------------------ recording
    def record_edge(self, node, out_keys, in_keys) -> None:
        """One key-deriving emission: aligned arrays of output keys and the
        input keys they derive from. O(1): parks the array refs."""
        n = len(out_keys)
        if n == 0:
            return
        log = self._edge_log.get(node.node_index)
        if log is None:
            # miss path takes the lock: a reader folding under it iterates
            # these dicts, and dict insertion mid-iteration would blow up
            with self._lock:
                log = self._edge_log.setdefault(
                    node.node_index, _ParkedLog(self.cap * 2)
                )
        log.park((out_keys, in_keys), n)

    def record_input(self, node, batch, tick: int) -> None:
        """Park this tick's ingested block so the walk can report the actual
        contributing input values + originating span."""
        log = self._input_log.get(node.node_index)
        if log is None:
            with self._lock:  # see record_edge
                log = self._input_log.setdefault(
                    node.node_index, _ParkedLog(self.cap * 2)
                )
        log.park((batch, tick, self._tick_span()), len(batch))

    def record_sink(self, node, net, tick: int) -> None:
        label = f"{node.name}:{node.node_index}"
        log = self._sink_log.get(label)
        if log is None:
            with self._lock:  # see record_edge
                log = self._sink_log.setdefault(label, _ParkedLog(self.cap * 2))
        log.park((net, tick, self._tick_span()), len(net))

    @staticmethod
    def _tick_span() -> str | None:
        tracer = _obs.current()
        return tracer.tick_span_id if tracer is not None else None

    # -------------------------------------------------------------- folding
    def _fold_locked(self) -> None:
        """Fold every parked log into its ring (call under the lock; writers
        take the same lock to INSERT a log, so the snapshots are stable —
        parks into existing logs stay lock-free)."""
        for idx, log in list(self._edge_log.items()):
            recs = log.drain()
            if not recs:
                continue
            ring = self.edges.get(idx)
            if ring is None:
                ring = self.edges.setdefault(idx, _Ring(self.cap))
            for out_keys, in_keys in recs:
                ok = out_keys.tolist() if isinstance(out_keys, np.ndarray) else out_keys
                ik = in_keys.tolist() if isinstance(in_keys, np.ndarray) else in_keys
                for o, i in zip(ok, ik):
                    ring.add(int(o), int(i))
                self.recorded_pairs += len(ok)
        for idx, log in list(self._input_log.items()):
            recs = log.drain()
            if not recs:
                continue
            ring = self.inputs.get(idx)
            if ring is None:
                ring = self.inputs.setdefault(idx, _Ring(self.cap))
            for batch, tick, span in recs:
                ins = np.flatnonzero(batch.diffs > 0)
                if not len(ins):
                    continue
                keys = batch.keys[ins].tolist()
                cols = list(batch.data.keys())
                rows = (
                    zip(*(batch.data[c][ins].tolist() for c in cols))
                    if cols
                    else iter([()] * len(keys))
                )
                for k, row in zip(keys, rows):
                    ring.put(k, (dict(zip(cols, row)), tick, span))
        for label, log in list(self._sink_log.items()):
            recs = log.drain()
            if not recs:
                continue
            ring = self.sinks.get(label)
            if ring is None:
                ring = self.sinks.setdefault(label, _Ring(self.cap))
            for net, tick, span in recs:
                cols = list(net.data.keys())
                keys = net.keys.tolist()
                diffs = net.diffs.tolist()
                rows = (
                    zip(*(net.data[c].tolist() for c in cols))
                    if cols
                    else iter([()] * len(keys))
                )
                for k, d, row in zip(keys, diffs, rows):
                    ring.put(k, (dict(zip(cols, row)), tick, d, span))

    def fold(self) -> None:
        with self._lock:
            self._fold_locked()

    def sink_labels(self) -> list[str]:
        """Known sinks with lineage data (folds the parked logs first)."""
        with self._lock:
            self._fold_locked()
            return sorted(set(self.sinks) | set(self._sink_log))

    # ------------------------------------------------------------- explain
    def explain(self, scheduler, sink: str, key: int) -> dict[str, Any]:
        """Walk the operator graph backward from ``sink`` for ``key``."""
        from pathway_tpu_torch.observability.metrics import iter_graphs

        graphs = iter_graphs(scheduler)
        graph = graphs[0] if graphs else None
        if graph is None:
            return {"ok": False, "error": "no live engine graph"}
        sink_node = None
        for node in graph.nodes:
            if f"{node.name}:{node.node_index}" == sink or node.name == sink:
                sink_node = node
                break
        if sink_node is None:
            with self._lock:
                self._fold_locked()
                known = sorted(set(self.sinks) | set(self._sink_log))
            return {"ok": False, "error": f"unknown sink {sink!r}", "sinks": known}
        # reverse adjacency: consumer index -> producer indices
        producers: dict[int, list[int]] = {}
        for src, conns in graph.edges.items():
            for ci, _port in conns:
                producers.setdefault(ci, []).append(src)
        with self._lock:
            self._fold_locked()
            sink_entry = None
            ring = self.sinks.get(f"{sink_node.name}:{sink_node.node_index}")
            if ring is not None:
                hits = ring.data.get(int(key))
                if hits:
                    row, tick, diff, span = hits[-1]
                    sink_entry = {
                        "row": row,
                        "tick": tick,
                        "diff": diff,
                        "span_id": span,
                    }
            path: list[dict[str, Any]] = []
            inputs_out: list[dict[str, Any]] = []
            seen: set[int] = set()
            frontier: list[tuple[int, tuple[int, ...]]] = [
                (sink_node.node_index, (int(key),))
            ]
            while frontier:
                node_index, keys = frontier.pop()
                if node_index in seen:
                    continue
                seen.add(node_index)
                node = graph.nodes[node_index]
                ring = self.inputs.get(node_index)
                if ring is not None:  # an input connector: report its rows
                    for k in keys:
                        hits = ring.data.get(int(k))
                        if hits:
                            row, tick, span = hits[-1]
                            inputs_out.append(
                                {
                                    "input": f"{getattr(node, 'input_name', None) or node.name}:{node_index}",
                                    "key": int(k),
                                    "row": row,
                                    "tick": tick,
                                    "span_id": span,
                                }
                            )
                    continue
                # map keys through a key-deriving edge; preserve otherwise
                edge = self.edges.get(node_index)
                derived = False
                if edge is not None:
                    mapped: list[int] = []
                    for k in keys:
                        mapped.extend(edge.data.get(int(k), ()))
                    if mapped:
                        derived = True
                        keys_up = tuple(dict.fromkeys(mapped))[:_WALK_KEYS]
                    else:
                        keys_up = keys
                else:
                    keys_up = keys
                path.append(
                    {
                        "operator": node.name,
                        "id": node_index,
                        "keys": [int(k) for k in keys[:8]],
                        "derives_keys": derived,
                    }
                )
                for p in producers.get(node_index, ()):
                    frontier.append((p, keys_up))
        return {
            "ok": True,
            "sink": f"{sink_node.name}:{sink_node.node_index}",
            "key": int(key),
            "output": sink_entry,
            "path": path,
            "inputs": inputs_out,
            "t_unix": round(_time.time(), 3),
        }

    def status_summary(self) -> dict[str, Any]:
        with self._lock:
            self._fold_locked()
            return {
                "enabled": True,
                "cap": self.cap,
                "recorded_pairs": self.recorded_pairs,
                "edges": len(self.edges),
                "inputs": len(self.inputs),
                "sinks": sorted(self.sinks),
            }


# ------------------------------------------------------------ run lifecycle

_store: LineageStore | None = None


def current() -> LineageStore | None:
    """The installed lineage store, or None — one global read on hot paths."""
    return _store


def install(store: LineageStore | None) -> None:
    global _store
    _store = store


def install_from_env(cfg) -> LineageStore | None:
    global _store
    cap = cfg.lineage_keys
    _store = LineageStore(cap) if cap > 0 else None
    return _store
