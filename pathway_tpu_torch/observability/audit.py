"""Data-plane correctness observability: invariant monitors, operator
cardinality, shadow audits.

The span and metrics planes watch the host (spans, watermarks, latency) and
the device plane watches the card (builds, padding, FLOPs); this module
watches the **data**.
A differential-style engine carries ``(key, values, time, diff)`` updates
through every operator, and that algebra has invariants a healthy pipeline can
never break: per-key multiplicity never goes negative, consolidated batches
are canonical and net-free, an upsert session exposes at most one live row per
key, watermarks only advance, a sink never retracts more than it inserted. A
flipped diff sign, a dropped retraction or a divergent incremental state flows
to sinks *silently* unless something checks — this plane is that always-on
tripwire (``PATHWAY_AUDIT=off|on|full``, default ``on``, gated ≤5% overhead
like the device plane). Four pillars:

- **invariant monitors** at operator edges — per-key multiplicity folds at
  input edges (negative multiplicity, upsert-key uniqueness, watermark
  monotonicity) and sink edges (per-key multiplicity, insert/retract
  balance). Violations emit structured audit events into the trace, the
  ``/status`` ``audit`` section, and the flight recorder — the dump names
  (operator, key, tick) — plus one immediate flight dump per run so the
  post-mortem exists even if the run then limps on.
- **cardinality / selectivity gauges** per operator edge — rows in/out split
  by insert/retract, retraction fraction, and a distinct-key estimate from a
  KMV sketch over the engine's existing uint64 key fingerprints; exported as
  ``pathway_operator_rows_total{op,dir}`` / ``pathway_operator_selectivity``
  (merged cluster-wide over the heartbeat piggyback).
- **sampled shadow audits** — every sink keeps (a) an order-independent
  incremental digest accumulated from its RAW per-batch deltas and (b) a
  per-(key, row-digest) multiset folded from its NET consolidated tick
  batches; on deterministically tick-hash-sampled ticks (the span plane's
  sampler, so all cluster processes audit the same tick) the digest is recomputed
  statically from the multiset and compared. The two take different paths
  through the consolidation machinery, so a dropped/duplicated/flipped row
  anywhere between a sink's raw input and its net output diverges them at the
  next sampled tick (``pathway_audit_divergence_total`` + flight dump).
- **row lineage** — see :mod:`pathway_tpu_torch.observability.lineage`; the audit
  plane feeds it sink emissions so ``/explain?sink=&key=`` can answer "why is
  this row here".

Overhead discipline (the capture-sink lesson: per-row Python on the tick
path is the one unaffordable thing): hot-path hooks only PARK array
references — one ``diffs < 0`` reduction and a list append per batch — and
every fold is vectorized and deferred to the moment a check can actually
fire: a retraction arrives (the only event that can trip a multiplicity
monitor), a shadow-sampled tick, a bound overflow, or a ``/status`` read.
Off mode installs no plane at all: hot loops pay one global read + ``is
None`` test, the device-plane discipline.

Carried from ``pathway_tpu/observability/audit.py`` with imports rewritten;
``_mix_keys`` gives the reference's uint64 digest bit for bit (the same
``splitmix64`` over the same keys). An audited tick keeps a fused chain on
the host program (``engine/fusion.py``): the device tier's single lane mask
cannot attribute per-member edge counts. A cluster peer sends
:meth:`AuditPlane.heartbeat_summary` on its heartbeats and the coordinator
rolls them up with :func:`merge_heartbeat_summaries`.
"""

from __future__ import annotations

import threading
import time as _time
from collections import deque
from typing import Any

import numpy as np

from pathway_tpu_torch.observability import lineage as _lineage
from pathway_tpu_torch.observability.spans import tick_hash_sampled as _tick_sampled

#: KMV sketch size for the distinct-key estimate; 64 mins give ~12% relative
#: error, plenty for a "did this edge explode" gauge
_KMV_K = 64

_U64 = float(1 << 64)
_MASK64 = (1 << 64) - 1

#: parked-rows threshold that forces an amortized vectorized fold even with
#: no retraction in sight (bounds the memory the parked arrays pin)
_FOLD_ROWS = 65536

#: per-_EdgeStats parked batches before the counters/KMV fold runs
_EDGE_FOLD = 256

#: violation kinds (the closed vocabulary /status and the tests key on)
NEGATIVE_MULTIPLICITY = "negative_multiplicity"
UPSERT_DUPLICATE = "upsert_duplicate"
WATERMARK_REGRESSION = "watermark_regression"
RETRACT_EXCESS = "retract_excess"
NON_CANONICAL = "non_canonical_batch"
DIVERGENCE = "shadow_divergence"


def _mix_keys(keys: np.ndarray, diffs: np.ndarray) -> int:
    """Order-independent signed multiset digest of a delta window:
    ``sum(diff * h(key))`` mod 2^64. Key-granular on purpose: row keys in
    this engine are content-derived for auto-keyed tables (``row_keys`` over
    the columns), so the key digest carries value identity there, and the
    uint64 arithmetic keeps the shadow audit inside the ≤5% budget — per-row
    value hashing over object columns is the one cost that cannot fit it."""
    from pathway_tpu_torch.internals.keys import splitmix64

    with np.errstate(over="ignore"):
        h = splitmix64(keys)
        return int(
            (h.astype(np.int64, copy=False) * diffs.astype(np.int64, copy=False)).sum()
        ) & _MASK64


#: _KeyCounts switches from its python-dict small mode to the vectorized
#: sorted-array mode past this many live+parked rows — below it, a dict fold
#: beats numpy's fixed per-call overhead by ~10×
_DICT_MODE_MAX = 2048


class _KeyCounts:
    """Per-key net multiplicity with parked delta arrays: ``park`` is O(1);
    ``fold`` merges everything parked. Small states fold through a python
    dict (numpy fixed costs dwarf the work at tens of rows); large states
    switch to one vectorized unique+bincount pass over sorted arrays — the
    differential-arrangement discipline applied to the monitor itself."""

    __slots__ = ("d", "keys", "counts", "parked_keys", "parked_diffs", "parked_rows")

    def __init__(self) -> None:
        self.d: dict[int, int] | None = {}  # small mode; None = array mode
        self.keys = np.empty(0, dtype=np.uint64)
        self.counts = np.empty(0, dtype=np.int64)
        self.parked_keys: list[np.ndarray] = []
        self.parked_diffs: list[np.ndarray] = []
        self.parked_rows = 0

    def park(self, keys: np.ndarray, diffs: np.ndarray) -> None:
        self.parked_keys.append(keys)
        self.parked_diffs.append(diffs)
        self.parked_rows += len(keys)

    def fold(self) -> None:
        if not self.parked_rows:
            return
        pk, self.parked_keys = self.parked_keys, []
        pd, self.parked_diffs = self.parked_diffs, []
        n, self.parked_rows = self.parked_rows, 0
        d = self.d
        # dict fold only for SMALL windows (python beats numpy's fixed costs
        # there); a large amortized window graduates to the vectorized path
        # even when the live state is tiny
        if d is not None and n <= 256 and len(d) + n <= _DICT_MODE_MAX:
            for keys, diffs in zip(pk, pd):
                for k, df in zip(keys.tolist(), diffs.tolist()):
                    c = d.get(k, 0) + df
                    if c:
                        d[k] = c
                    else:
                        d.pop(k, None)
            return
        if d is not None:  # graduate to array mode
            ks = np.fromiter(d.keys(), dtype=np.uint64, count=len(d))
            order = np.argsort(ks)
            self.keys = ks[order]
            self.counts = np.fromiter(d.values(), dtype=np.int64, count=len(d))[
                order
            ]
            self.d = None
        # O(delta) fold: net the parked window at its OWN size, then
        # merge into the sorted live state touching only the keys the window
        # actually carries — the monitor used to re-unique its entire key
        # state every fold, an O(state log state) tick tax the incremental
        # bench paid 20x while the static run paid it once
        keys = np.concatenate(pk) if len(pk) > 1 else pk[0]
        diffs = np.concatenate(pd) if len(pd) > 1 else pd[0]
        du, inv = np.unique(keys, return_inverse=True)
        dsum = np.bincount(inv, weights=diffs, minlength=len(du)).astype(np.int64)
        live_k, live_c = self.keys, self.counts
        if not len(live_k):
            nz = dsum != 0
            self.keys = du[nz]
            self.counts = dsum[nz]
            return
        pos = np.searchsorted(live_k, du).clip(0, len(live_k) - 1)
        exists = live_k[pos] == du
        merged = np.where(exists, live_c[pos], 0) + dsum
        upd = exists & (merged != 0)
        if upd.any():
            live_c[pos[upd]] = merged[upd]
        removed = exists & (merged == 0)
        adds = ~exists & (dsum != 0)
        if removed.any() or adds.any():
            from pathway_tpu_torch.engine.blocks import interleave_positions

            keep = np.ones(len(live_k), dtype=bool)
            keep[pos[removed]] = False
            kept_k, kept_c = live_k[keep], live_c[keep]
            add_k, add_c = du[adds], merged[adds]
            ia, ib = interleave_positions(kept_k, add_k)
            total = len(kept_k) + len(add_k)
            out_k = np.empty(total, dtype=np.uint64)
            out_c = np.empty(total, dtype=np.int64)
            out_k[ia] = kept_k
            out_k[ib] = add_k
            out_c[ia] = kept_c
            out_c[ib] = add_c
            self.keys = out_k
            self.counts = out_c

    def size(self) -> int:
        base = len(self.d) if self.d is not None else len(self.keys)
        return base + self.parked_rows

    def offenders(self, predicate) -> list[int]:
        """Keys whose folded count satisfies ``predicate`` (call after
        fold()). ``predicate`` receives an int64 array and returns a mask."""
        if self.d is not None:
            if not self.d:
                return []
            arr = np.fromiter(self.d.values(), dtype=np.int64, count=len(self.d))
            mask = predicate(arr)
            if not mask.any():
                return []
            ks = list(self.d.keys())
            return [ks[i] for i in np.flatnonzero(mask)]
        return self.keys[predicate(self.counts)].tolist()

    def any_offender(self, predicate) -> bool:
        """Cheap existence probe (dict mode scans values lazily)."""
        if self.d is not None:
            if not self.d:
                return False
            arr = np.fromiter(self.d.values(), dtype=np.int64, count=len(self.d))
            return bool(predicate(arr).any())
        return bool(predicate(self.counts).any())

    def digest(self) -> int:
        """Key-granular multiset digest of the folded state (shadow audit's
        static side): ``sum(count * h(key))`` mod 2^64."""
        if self.d is not None:
            if not self.d:
                return 0
            keys = np.fromiter(self.d.keys(), dtype=np.uint64, count=len(self.d))
            counts = np.fromiter(self.d.values(), dtype=np.int64, count=len(self.d))
            return _mix_keys(keys, counts)
        return _mix_keys(self.keys, self.counts)


class _EdgeStats:
    """Per-node cardinality counters (one instance per node per worker graph;
    aggregated by node position at read time, like scheduler_stats). The
    exact rows-in/out totals come free from the engine's existing
    ``stats_rows_*`` counters; this records only what they lack — the
    insert/retract split and the distinct-key sketch — on tick-SAMPLED sweeps
    (lock-free parked array refs; a racing fold may drop a batch, which is
    fine for a sampled estimator)."""

    __slots__ = (
        "sampled_in", "sampled_in_retract", "sampled_out", "sampled_out_retract",
        "kmv", "_in_diffs", "_out_diffs", "_out_keys",
    )

    def __init__(self) -> None:
        self.sampled_in = 0
        self.sampled_in_retract = 0
        self.sampled_out = 0
        self.sampled_out_retract = 0
        # ascending array of the smallest output-key hashes seen (KMV)
        self.kmv = np.empty(0, dtype=np.uint64)
        self._in_diffs: list[np.ndarray] = []
        self._out_diffs: list[np.ndarray] = []
        self._out_keys: list[np.ndarray] = []

    def note(self, inputs: list, outputs: list) -> None:
        for b in inputs:
            if b is not None and len(b):
                self._in_diffs.append(b.diffs)
        for b in outputs:
            if b is not None and len(b):
                self._out_diffs.append(b.diffs)
                self._out_keys.append(b.keys)
        if len(self._out_keys) + len(self._in_diffs) >= _EDGE_FOLD:
            self.fold()

    def fold(self) -> None:
        parked, self._in_diffs = self._in_diffs, []
        if parked:
            d = np.concatenate(parked)
            r = int((d < 0).sum())
            self.sampled_in_retract += r
            self.sampled_in += len(d)
        parked, self._out_diffs = self._out_diffs, []
        if parked:
            d = np.concatenate(parked)
            r = int((d < 0).sum())
            self.sampled_out_retract += r
            self.sampled_out += len(d)
        parked, self._out_keys = self._out_keys, []
        if parked:
            keys = np.concatenate([self.kmv] + parked)
            self.kmv = np.unique(keys)[:_KMV_K]

    def distinct_estimate(self) -> int:
        k = len(self.kmv)
        if k == 0:
            return 0
        if k < _KMV_K:
            return k
        return int((_KMV_K - 1) * _U64 / float(self.kmv[-1]))


class _SinkAudit:
    """Per-sink shadow state: multiplicity arrangement + the raw delta log.
    The NET side of the shadow audit is the ``counts`` arrangement itself
    (folded from the tick's consolidated emissions); the RAW side is parked
    pre-netting delta blocks — two different paths through the consolidation
    machinery whose key-multiset digests must agree."""

    __slots__ = (
        "counts", "inserts", "retracts", "degraded", "violated",
        "pending_raw", "raw_digest", "net_digest", "excess_reported",
        "shadow_n",
    )

    def __init__(self) -> None:
        self.counts = _KeyCounts()  # per-key net multiplicity (net side)
        self.inserts = 0
        self.retracts = 0
        self.degraded = False
        self.violated: set[int] = set()  # keys already reported negative
        self.excess_reported = False
        self.pending_raw: list[Any] = []  # hashed only at sampled ticks
        self.raw_digest = 0
        # net-side digest maintained INCREMENTALLY at fold time (summing
        # diff*h(key) is a ring homomorphism, so the running sum equals the
        # digest of the folded arrangement); periodically cross-checked
        # against a from-scratch recompute to also audit the fold machinery
        self.net_digest = 0
        self.shadow_n = 0


class _InputAudit:
    """Per-input-edge monitor state."""

    __slots__ = (
        "counts", "last_watermark", "degraded", "violated", "upsert",
        "wm_violated",
    )

    def __init__(self, upsert: bool) -> None:
        self.counts = _KeyCounts()
        self.last_watermark: float | None = None
        self.degraded = False
        self.violated: set[int] = set()
        self.upsert = upsert
        self.wm_violated = False


class AuditPlane:
    """Per-run data-plane audit state (one instance per process per run)."""

    def __init__(self, mode: str, sample: float, max_keys: int):
        self.mode = mode  # "on" | "full"
        self.sample = sample if mode == "on" else 1.0
        #: edge-cardinality recording rate: the retract split and KMV sketch
        #: are estimators, so they stay on the base sample even in ``full``
        #: (whose 1.0 applies to the shadow/canonical CHECKS)
        self.edge_sample = sample
        self.max_keys = max_keys
        self._lock = threading.Lock()
        self.violations: deque = deque(maxlen=256)
        self.violation_counts: dict[str, int] = {}
        self.divergences = 0
        self.shadow_ticks = 0
        self._dumped = False  # one flight dump per run on first violation
        # per-tick cached sampling decision (begin_tick): sink folds, shadow
        # audits and edge-cardinality sweeps all key off the SAME deterministic
        # tick hash, so hot paths read one attribute instead of rehashing
        self._tick: int | None = None
        self.tick_sampled = False
        self.edge_sampled = False
        #: False after a persistence restart replayed only a log SUFFIX: the
        #: multiplicity/shadow monitors would see retractions of rows whose
        #: inserts predate the snapshot and fire false violations, so the
        #: history-dependent monitors stand down (watermark monotonicity,
        #: cardinality gauges and lineage keep running) — see
        #: ``note_history_truncated``
        self.history_complete = True

    def begin_tick(self, tick: int) -> None:
        """Called once per tick by every runtime's run_tick (next to the
        device plane's tick_hook): caches this tick's shadow/edge sampling
        decisions."""
        self._tick = tick
        t = int(tick)
        self.tick_sampled = _tick_sampled(t, self.sample)
        self.edge_sampled = (
            self.tick_sampled
            if self.edge_sample == self.sample
            else _tick_sampled(t, self.edge_sample)
        )

    def _sampled(self, tick) -> bool:
        if tick is None:
            return False
        if tick == self._tick:
            return self.tick_sampled
        return _tick_sampled(int(tick), self.sample)

    # ------------------------------------------------------------ violations
    def violation(
        self,
        kind: str,
        operator: str,
        *,
        key: Any = None,
        tick: Any = None,
        detail: str = "",
    ) -> None:
        """Record one invariant violation: bounded ring (served on
        ``/status``), trace event, flight-recorder note, and — once per
        run — an immediate flight dump so the post-mortem names (operator,
        key, tick) even if the run keeps going."""
        rec = {
            "kind": kind,
            "operator": operator,
            "key": None if key is None else int(key),
            "tick": tick,
            "detail": detail,
            "t_ns": _time.time_ns(),
        }
        with self._lock:
            self.violations.append(rec)
            self.violation_counts[kind] = self.violation_counts.get(kind, 0) + 1
        from pathway_tpu_torch import observability as _obs
        from pathway_tpu_torch.observability import device as _device

        _device.flight_note(
            "audit_violation",
            audit_kind=kind,
            operator=operator,
            key=rec["key"],
            tick=tick,
            detail=detail,
        )
        tracer = _obs.current()
        if tracer is not None:
            tracer.event(
                "audit/violation",
                {
                    "pathway.audit.kind": kind,
                    "pathway.operator": operator,
                    "pathway.key": str(rec["key"]),
                    "pathway.tick": -1 if tick is None else int(tick),
                    "pathway.detail": detail,
                },
            )
        dump = False
        with self._lock:
            if not self._dumped:
                self._dumped = dump = True
        if dump:
            _device.flight_dump("audit_violation", extra=rec)

    def _degrade(self, st, label: str) -> None:
        st.degraded = True
        from pathway_tpu_torch.observability.device import flight_note

        flight_note("audit_monitor_degraded", operator=label, bound=self.max_keys)

    # ---------------------------------------------------------- input edges
    def observe_input(self, node, batches: list, tick: int) -> None:
        """Post-poll monitor for one input node's tick output (runs AFTER any
        fault-plan corruption, so injected corruption is observed exactly as
        the engine will see it). Hot path: one ``diffs < 0`` reduction + a
        parked array ref per batch; folds run only when a retraction (the
        only event that can trip the monitor) actually arrives."""
        st = getattr(node, "_audit_input", None)
        if st is None:
            st = node._audit_input = _InputAudit(bool(getattr(node, "upsert", False)))
        # watermark monotonicity: both event-time and ingest-time watermarks
        # are maintained as maxima — a regression means the bookkeeping broke
        wm = getattr(node, "wm_event_time", None)
        if wm is None:
            ns = getattr(node, "wm_ingest_ns", None)
            wm = None if ns is None else ns / 1e9
        if wm is not None:
            if st.last_watermark is not None and wm < st.last_watermark:
                if not st.wm_violated:
                    # once per node: the regression is a structural
                    # bookkeeping bug, not a per-tick event — and the
                    # high-water base stays so a recovering (again
                    # monotonic) watermark below it is not re-reported
                    st.wm_violated = True
                    self.violation(
                        WATERMARK_REGRESSION,
                        self._label(node),
                        tick=tick,
                        detail=f"watermark {wm} < {st.last_watermark}",
                    )
            else:
                st.last_watermark = wm
        lin = _lineage.current()
        if lin is not None:
            for b in batches:
                if b is not None and len(b):
                    lin.record_input(node, b, tick)
        if st.degraded or not self.history_complete:
            return
        check = False
        for b in batches:
            if b is None or not len(b):
                continue
            st.counts.park(b.keys, b.diffs)
            if st.upsert or bool((b.diffs < 0).any()):
                check = True
        if check:
            self._check_input(st, node, tick)
        elif st.counts.parked_rows > min(_FOLD_ROWS, self.max_keys):
            st.counts.fold()  # amortized: bound the parked-array memory
            if st.counts.size() > self.max_keys:
                self._degrade(st, self._label(node))
                st.counts = _KeyCounts()

    def _check_input(self, st: _InputAudit, node, tick: int) -> None:
        st.counts.fold()
        label = self._label(node)
        neg = st.counts.offenders(lambda c: c < 0)
        for k in neg:
            if k not in st.violated:
                st.violated.add(k)
                self.violation(
                    NEGATIVE_MULTIPLICITY,
                    label,
                    key=k,
                    tick=tick,
                    detail="input-edge multiplicity below zero",
                )
        if st.upsert:
            dup = st.counts.offenders(lambda c: c > 1)
            for k in dup:
                if k not in st.violated:
                    st.violated.add(k)
                    self.violation(
                        UPSERT_DUPLICATE,
                        label,
                        key=k,
                        tick=tick,
                        detail="more than one live row for an upsert key",
                    )
        if st.counts.size() > self.max_keys:
            self._degrade(st, label)
            st.counts = _KeyCounts()

    # ----------------------------------------------------------- sink edges
    def on_sink_delta(self, node, batch) -> None:
        """Raw-side log: every delta block a sink buffers is parked BEFORE
        the tick's netting — the shadow audit's independent path through the
        consolidation machinery. Hashing is deferred to sampled ticks."""
        if batch is None or not len(batch):
            return
        st = getattr(node, "_audit_sink", None)
        if st is None:
            st = node._audit_sink = _SinkAudit()
        if not st.degraded and self.history_complete:
            st.pending_raw.append(batch)

    def on_sink_net(self, node, net, tick: int) -> None:
        """Net-side parking + the sampled fold/checks/shadow compare. Called
        once per tick with the sink's consolidated emission. The hot path is
        two list appends; folds, multiplicity checks and digest hashing all
        run on shadow-sampled ticks (or parked-rows overflow), so their cost
        is amortized by ``PATHWAY_AUDIT_SAMPLE``. (The within-one-tick
        corruption guarantee lives at the INPUT edges, which check eagerly
        whenever a retraction arrives.)"""
        st = getattr(node, "_audit_sink", None)
        if st is None:
            st = node._audit_sink = _SinkAudit()
        if st.degraded:
            return
        if net is not None and len(net):
            # lineage: remember this tick's sink rows for /explain — the
            # store parks the batch ref, one append
            lin = _lineage.current()
            if lin is not None:
                lin.record_sink(node, net, tick)
            if not self.history_complete:
                return  # suffix replay: multiplicity/shadow would see
                # retractions of pre-snapshot rows (see note_history_truncated)
            st.counts.park(net.keys, net.diffs)
        # a parked-rows overflow counts as a shadow point too: both pending
        # logs cover exactly the same ticks at any on_sink_net boundary, so
        # the digest comparison is valid there and the raw log stays bounded
        # even when the tick hash goes a long stretch without sampling
        if self._sampled(tick) or st.counts.parked_rows > _FOLD_ROWS:
            label = self._label(node)
            self._fold_sink_counts(st, label, tick)
            if not st.degraded:
                self._shadow_compare(st, node, label, tick)

    def _fold_sink_counts(self, st: _SinkAudit, label: str, tick) -> None:
        pending = st.counts.parked_diffs
        if pending:
            d = pending[0] if len(pending) == 1 else np.concatenate(pending)
            pk = st.counts.parked_keys
            k = pk[0] if len(pk) == 1 else np.concatenate(pk)
            add = int(d[d > 0].sum())
            st.inserts += add
            st.retracts += add - int(d.sum())
            st.net_digest = (st.net_digest + _mix_keys(k, d)) & _MASK64
        st.counts.fold()
        neg = st.counts.offenders(lambda c: c < 0)
        for k in neg:
            if k not in st.violated:
                st.violated.add(k)
                self.violation(
                    NEGATIVE_MULTIPLICITY,
                    label,
                    key=k,
                    tick=tick,
                    detail="sink multiplicity below zero",
                )
        if st.retracts > st.inserts and not st.excess_reported:
            st.excess_reported = True  # report the imbalance once, not per tick
            self.violation(
                RETRACT_EXCESS,
                label,
                tick=tick,
                detail=f"{st.retracts} retracts > {st.inserts} inserts",
            )
        if st.counts.size() > self.max_keys:
            self._degrade(st, label)
            st.counts = _KeyCounts()
            st.pending_raw = []

    def _shadow_compare(self, st: _SinkAudit, node, label: str, tick) -> None:
        """Fold the parked raw log into the incremental digest, recompute the
        static digest from the net-side multiplicity arrangement, and
        compare. Runs on sampled ticks only (every tick in ``full``), so the
        hashing is amortized by the sample."""
        self.shadow_ticks += 1
        if st.pending_raw:
            # one concatenated mix for the whole parked window — numpy fixed
            # costs are paid once per sampled tick, not once per raw batch
            if len(st.pending_raw) == 1:
                keys, diffs = st.pending_raw[0].keys, st.pending_raw[0].diffs
            else:
                keys = np.concatenate([b.keys for b in st.pending_raw])
                diffs = np.concatenate([b.diffs for b in st.pending_raw])
            st.pending_raw = []
            st.raw_digest = (st.raw_digest + _mix_keys(keys, diffs)) & _MASK64
        st.shadow_n += 1
        if st.shadow_n & 15 == 0:
            # every 16th shadow tick, recompute the net digest from scratch
            # off the arrangement — audits the fold machinery itself on top
            # of the raw-vs-net path comparison
            static = st.counts.digest()
            if static != st.net_digest:
                self.divergences += 1
                self.violation(
                    DIVERGENCE,
                    label,
                    tick=tick,
                    detail=(
                        f"arrangement digest {static:#x} != running net "
                        f"{st.net_digest:#x} over {st.counts.size()} live keys"
                    ),
                )
                st.net_digest = static
        if st.net_digest != st.raw_digest:
            self.divergences += 1
            self.violation(
                DIVERGENCE,
                label,
                tick=tick,
                detail=(
                    f"net digest {st.net_digest:#x} != incremental raw "
                    f"{st.raw_digest:#x} over {st.counts.size()} live keys"
                ),
            )
            st.raw_digest = st.net_digest  # re-sync: report once

    # ------------------------------------------------- canonical-batch check
    def check_canonical(self, batch, where: str = "consolidate") -> None:
        """``full`` mode only: a consolidated batch must be canonical — keys
        non-decreasing, no zero net diffs, and within an equal-key run the
        diffs ascending (retractions precede insertions — the order stateful
        consumers rely on to apply rows in batch order). Numpy-only: the
        digest-granular net-free property is covered by the shadow audit."""
        if self.mode != "full" or batch is None or len(batch) <= 1:
            return
        keys = batch.keys
        if bool((keys[1:] < keys[:-1]).any()):
            self.violation(
                NON_CANONICAL, where, tick=batch.time, detail="keys not sorted"
            )
            return
        diffs = batch.diffs
        if bool((diffs == 0).any()):
            self.violation(
                NON_CANONICAL, where, tick=batch.time, detail="zero net diff kept"
            )
            return
        dup = keys[1:] == keys[:-1]
        if bool((dup & (diffs[1:] < diffs[:-1])).any()):
            self.violation(
                NON_CANONICAL,
                where,
                tick=batch.time,
                detail="within-key diff order broken (retract-before-insert)",
            )

    # -------------------------------------------------------- edge counters
    def note_edge(self, node, inputs: list, outputs: list) -> None:
        st = getattr(node, "_audit_edge", None)
        if st is None:
            st = node._audit_edge = _EdgeStats()
        st.note(inputs, outputs)

    @staticmethod
    def _label(node) -> str:
        return f"{node.name}:{node.node_index}"

    # ------------------------------------------------------------ summaries
    def operator_rows(self, scheduler) -> list[dict[str, Any]]:
        """Per-operator cardinality rows, aggregated by node position across
        worker graphs (the scheduler_stats discipline). Exact rows-in/out come
        from the engine's free ``stats_rows_*`` counters; the retract split
        and the distinct-key KMV estimate come from the tick-SAMPLED edge
        recordings (fractions, not absolute counts, so sampling cancels)."""
        from pathway_tpu_torch.observability.metrics import iter_graphs

        agg: dict[int, dict[str, Any]] = {}
        sketches: dict[int, list[np.ndarray]] = {}
        for g in iter_graphs(scheduler):
            for node in g.nodes:
                st = getattr(node, "_audit_edge", None)
                if st is None and not (node.stats_rows_in or node.stats_rows_out):
                    continue
                o = agg.get(node.node_index)
                if o is None:
                    agg[node.node_index] = o = {
                        "id": node.node_index,
                        "operator": node.name,
                        "rows_in": 0,
                        "rows_out": 0,
                        "sampled_in": 0,
                        "sampled_in_retract": 0,
                        "sampled_out": 0,
                        "sampled_out_retract": 0,
                    }
                    sketches[node.node_index] = []
                o["rows_in"] += node.stats_rows_in
                o["rows_out"] += node.stats_rows_out
                if st is not None:
                    st.fold()
                    o["sampled_in"] += st.sampled_in
                    o["sampled_in_retract"] += st.sampled_in_retract
                    o["sampled_out"] += st.sampled_out
                    o["sampled_out_retract"] += st.sampled_out_retract
                    if len(st.kmv):
                        sketches[node.node_index].append(st.kmv)
        rows = []
        for i in sorted(agg):
            o = agg[i]
            parts = sketches[i]
            if parts:
                merged = np.unique(np.concatenate(parts))[:_KMV_K]
                if len(merged) < _KMV_K:
                    o["distinct_keys"] = int(len(merged))
                else:
                    o["distinct_keys"] = int((_KMV_K - 1) * _U64 / float(merged[-1]))
            else:
                o["distinct_keys"] = 0
            o["retract_fraction_out"] = (
                round(o["sampled_out_retract"] / o["sampled_out"], 4)
                if o["sampled_out"]
                else 0.0
            )
            o["retracts_out"] = o.pop("sampled_out_retract")
            o["retracts_in"] = o.pop("sampled_in_retract")
            del o["sampled_in"], o["sampled_out"]
            o["selectivity"] = (
                round(o["rows_out"] / o["rows_in"], 4) if o["rows_in"] else None
            )
            rows.append(o)
        return rows

    def status_summary(self, runtime) -> dict[str, Any]:
        with self._lock:
            violations = list(self.violations)
            counts = dict(self.violation_counts)
        out: dict[str, Any] = {
            "enabled": True,
            "mode": self.mode,
            "sample": self.sample,
            "violations_total": sum(counts.values()),
            "violations_by_kind": counts,
            "recent_violations": violations[-32:],
            "divergences": self.divergences,
            "shadow_ticks": self.shadow_ticks,
            "operators": self.operator_rows(getattr(runtime, "scheduler", None)),
        }
        from pathway_tpu_torch.observability import lineage as _lineage

        lin = _lineage.current()
        if lin is not None:
            out["lineage"] = lin.status_summary()
        return out

    def heartbeat_summary(self) -> dict[str, Any]:
        """Compact block riding cluster heartbeats (peer → coordinator)."""
        with self._lock:
            counts = dict(self.violation_counts)
            recent = list(self.violations)[-8:]
        return {
            "violations": sum(counts.values()),
            "by_kind": counts,
            "divergences": self.divergences,
            "shadow_ticks": self.shadow_ticks,
            "recent": recent,
        }

    # ------------------------------------------------------------- /metrics
    def prometheus_lines(self, runtime) -> list[str]:
        from pathway_tpu_torch.internals.monitoring import escape_label_value as esc

        lines: list[str] = []
        ops = self.operator_rows(getattr(runtime, "scheduler", None))
        if ops:
            lines.append(
                "# HELP pathway_operator_rows_total Rows crossing an operator edge, by direction"
            )
            lines.append("# TYPE pathway_operator_rows_total counter")
            for o in ops:
                lbl = f'op="{esc(o["operator"])}",id="{o["id"]}"'
                lines.append(
                    f'pathway_operator_rows_total{{{lbl},dir="in"}} {o["rows_in"]}'
                )
                lines.append(
                    f'pathway_operator_rows_total{{{lbl},dir="out"}} {o["rows_out"]}'
                )
            lines.append(
                "# HELP pathway_operator_selectivity Rows out per row in at an operator edge"
            )
            lines.append("# TYPE pathway_operator_selectivity gauge")
            for o in ops:
                if o["selectivity"] is None:
                    continue
                lines.append(
                    f'pathway_operator_selectivity{{op="{esc(o["operator"])}",id="{o["id"]}"}} {o["selectivity"]}'
                )
            lines.append(
                "# HELP pathway_operator_retract_fraction Fraction of an edge's output rows that are retractions"
            )
            lines.append("# TYPE pathway_operator_retract_fraction gauge")
            for o in ops:
                lines.append(
                    f'pathway_operator_retract_fraction{{op="{esc(o["operator"])}",id="{o["id"]}"}} {o["retract_fraction_out"]}'
                )
            lines.append(
                "# HELP pathway_operator_distinct_keys KMV estimate of distinct output keys at an operator edge"
            )
            lines.append("# TYPE pathway_operator_distinct_keys gauge")
            for o in ops:
                lines.append(
                    f'pathway_operator_distinct_keys{{op="{esc(o["operator"])}",id="{o["id"]}"}} {o["distinct_keys"]}'
                )
        with self._lock:
            counts = dict(self.violation_counts)
        lines.append(
            "# HELP pathway_audit_violations_total Data-plane invariant violations detected"
        )
        lines.append("# TYPE pathway_audit_violations_total counter")
        for kind in sorted(counts):
            lines.append(
                f'pathway_audit_violations_total{{kind="{esc(kind)}"}} {counts[kind]}'
            )
        lines.append(
            "# HELP pathway_audit_divergence_total Shadow-audit digest divergences per sink plane"
        )
        lines.append("# TYPE pathway_audit_divergence_total counter")
        lines.append(f"pathway_audit_divergence_total {self.divergences}")
        return lines


# ----------------------------------------------------------- run lifecycle

_plane: AuditPlane | None = None


def current() -> AuditPlane | None:
    """The installed audit plane, or None when ``PATHWAY_AUDIT=off`` — hot
    call sites guard on one global read + ``is None`` test."""
    return _plane


def install_from_env(runtime=None) -> AuditPlane | None:
    """Per-run (re)install, called from ``observability.install_from_env``
    next to the tracer/device installs."""
    global _plane
    from pathway_tpu_torch.internals.config import get_pathway_config
    from pathway_tpu_torch.observability import lineage as _lineage

    cfg = get_pathway_config()
    try:
        mode = cfg.audit
    except ValueError:
        mode = "on"
    if mode == "off":
        _plane = None
        _lineage.install(None)
        return None
    _plane = AuditPlane(mode, cfg.audit_sample, cfg.audit_keys)
    _lineage.install_from_env(cfg)
    return _plane


def shutdown() -> None:
    """Run teardown. The plane (and its violation ring / lineage store) stays
    readable after the run — post-mortems and tests inspect it, exactly like
    the device plane's stats — and the next run's install replaces it."""


def merge_heartbeat_summaries(blocks: list) -> dict[str, Any] | None:
    """Cluster rollup of peers' heartbeat audit blocks (coordinator
    ``/status``)."""
    blocks = [b for b in blocks if b]
    if not blocks:
        return None
    by_kind: dict[str, int] = {}
    recent: list = []
    for b in blocks:
        for k, v in (b.get("by_kind") or {}).items():
            by_kind[k] = by_kind.get(k, 0) + v
        recent.extend(b.get("recent") or [])
    recent.sort(key=lambda r: r.get("t_ns") or 0)
    return {
        "violations": sum(b.get("violations") or 0 for b in blocks),
        "by_kind": by_kind,
        "divergences": sum(b.get("divergences") or 0 for b in blocks),
        "shadow_ticks": sum(b.get("shadow_ticks") or 0 for b in blocks),
        "recent": recent[-32:],
    }


def note_history_truncated() -> None:
    """Called by the persistence layer when a restart replays only a log
    SUFFIX (operator snapshots + committed offsets): the stream's prefix is
    invisible to this run, so retractions of pre-snapshot rows are LEGAL and
    the history-dependent monitors (multiplicity folds, shadow digests)
    stand down for the run. Watermark monotonicity, cardinality gauges and
    lineage keep running."""
    plane = _plane
    if plane is not None and plane.history_complete:
        plane.history_complete = False
        from pathway_tpu_torch.observability.device import flight_note

        flight_note("audit_history_truncated")
