"""Live span pipeline: always-on sampled tracing of the running dataflow.

The shutdown-time OTLP export (``internals/telemetry.py``) describes a run
*after* it ends; this module is the Dapper-style live plane the ROADMAP's
serving workloads need: while the pipeline runs, every sampled tick produces

- one ``tick`` span per process (child of a shared, deterministic run root),
- child spans for each ``_sweep`` node execution, microbatch UDF launch,
  device dispatch, persistence epoch commit, and cluster barrier round,

appended incrementally to a bounded in-memory ring (served by the monitoring
server's ``/trace?since=`` endpoint) and, when configured, to a rotating
OTLP-JSON file sink — one ``ExportTraceServiceRequest`` JSON document per
line, the OTel collector file-exporter convention, loadable in Perfetto or
otel-desktop-viewer.

Overhead discipline (SnailTrail's "observe without perturbing"):

- ``PATHWAY_TRACE=off`` (default) installs **no tracer at all** — hot loops
  guard on a single ``is None`` check;
- head sampling (``PATHWAY_TRACE_SAMPLE``) decides per TICK with a
  deterministic hash of the tick number, so every process of a cluster
  samples the SAME ticks and their spans stitch under one trace id;
- recording a span costs one tuple + ring append: OTLP-JSON
  materialization (attribute boxing, span-id formatting, serialization)
  happens lazily on the READ side — ``/trace`` requests and the file sink's
  background writer thread — never in the engine loop.

Carried from ``pathway_tpu/observability/spans.py`` with the service and scope
named ``pathway_tpu_torch``.
"""

from __future__ import annotations

import hashlib
import itertools
import json
import os
import secrets
import threading
import time as _time
from collections import deque
from typing import Any

#: 64-bit splitmix constant for the deterministic tick-sampling hash
_MIX = 0x9E3779B97F4A7C15
_MASK = (1 << 64) - 1

#: background file-sink writer wake period, seconds — the live file trails
#: the engine by at most this much
_SINK_FLUSH_S = 0.25


def _attr(key: str, value: Any) -> dict:
    """OTLP attribute boxing (read-side only — never in the engine loop)."""
    if value is True or value is False:
        v: dict = {"boolValue": value}
    elif isinstance(value, int):
        v = {"intValue": str(value)}
    elif isinstance(value, float):
        v = {"doubleValue": value}
    else:
        v = {"stringValue": str(value)}
    return {"key": key, "value": v}


def derive_trace_id(run_id: str) -> str:
    """Deterministic 16-byte trace id from a run id — every process of a
    cluster run (sharing ``PATHWAY_RUN_ID`` via spawn) derives the SAME id,
    so per-process tick spans stitch into one trace."""
    return hashlib.sha256(("pathway-trace:" + run_id).encode()).hexdigest()[:32]


def derive_root_span_id(trace_id: str) -> str:
    """Deterministic root span id: peers parent their tick spans under the
    run root WITHOUT coordination; only process 0 emits the root span."""
    return hashlib.sha256(("pathway-root:" + trace_id).encode()).hexdigest()[:16]


def tick_hash_sampled(tick: int, rate: float) -> bool:
    """Deterministic head-sampling decision for a tick (identical on every
    process). ``rate`` ≥ 1 keeps everything, ≤ 0 nothing."""
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    h = (tick * _MIX) & _MASK
    h ^= h >> 31
    h = (h * _MIX) & _MASK
    h ^= h >> 29
    return (h >> 11) / float(1 << 53) < rate


class RotatingTraceSink:
    """Append OTLP/JSON trace documents to a file, rotating at a size cap.

    Each write is one ``ExportTraceServiceRequest`` line containing a batch of
    spans; rotation moves the file to ``<path>.1`` (one generation kept) so a
    long-lived streaming run cannot fill the disk."""

    def __init__(self, path: str, rotate_bytes: int = 64 * 1024 * 1024):
        self.path = path
        self.rotate_bytes = rotate_bytes
        self._fh = open(path, "a", encoding="utf-8")
        self._resource = None  # built lazily (service.name + pid attrs)

    def _doc(self, spans: list[dict]) -> dict:
        if self._resource is None:
            self._resource = {
                "attributes": [
                    _attr("service.name", "pathway_tpu_torch"),
                    _attr("process.pid", os.getpid()),
                ]
            }
        return {
            "resourceSpans": [
                {
                    "resource": self._resource,
                    "scopeSpans": [
                        {
                            "scope": {"name": "pathway_tpu_torch.live", "version": "1"},
                            "spans": spans,
                        }
                    ],
                }
            ]
        }

    def write(self, spans: list[dict]) -> None:
        if not spans or self._fh.closed:
            return
        self._fh.write(json.dumps(self._doc(spans)) + "\n")
        self._fh.flush()
        if self._fh.tell() > self.rotate_bytes:
            self._rotate()

    def write_line(self, line: str) -> None:
        """Append one pre-serialized ExportTraceServiceRequest line (the
        tracer's direct serializer — generic ``json.dumps`` over materialized
        span dicts costs ~75µs/span on slow hosts; the fixed span shape
        serializes in a few µs with plain string building)."""
        if self._fh.closed:
            return
        self._fh.write(line + "\n")
        self._fh.flush()
        if self._fh.tell() > self.rotate_bytes:
            self._rotate()

    def _rotate(self) -> None:
        self._fh.close()
        try:
            os.replace(self.path, self.path + ".1")
        except OSError:
            pass
        self._fh = open(self.path, "a", encoding="utf-8")

    def close(self) -> None:
        if not self._fh.closed:
            self._fh.close()


class SpanBuffer:
    """Thread-safe bounded ring of span records with monotonically increasing
    sequence numbers (the ``/trace?since=`` cursor).

    Appends are the engine-side hot path: one lock + one deque append of
    whatever record the tracer hands in. ``materialize`` (set by the owning
    tracer; identity by default) converts a ``(seq, record)`` pair to its
    OTLP span dict on the READ side — ``since()`` and the file sink's
    background writer thread, which drains new records every
    ``_SINK_FLUSH_S`` seconds."""

    def __init__(self, max_spans: int = 8192, sink: RotatingTraceSink | None = None):
        self.max_spans = max_spans
        self.sink = sink
        self.materialize = lambda seq, rec: rec
        # set by the owning tracer: (seq, record) batch -> one OTLP/JSON line;
        # None falls back to materialize + sink.write
        self.serialize_batch = None
        self._lock = threading.Lock()
        self._ring: deque[tuple[int, Any]] = deque(maxlen=max_spans)
        self._seq = 0
        self._pending_sink: list[tuple[int, Any]] = []
        self._stop = threading.Event()
        self._writer: threading.Thread | None = None
        if sink is not None:
            self._writer = threading.Thread(
                target=self._writer_loop, name="pathway-trace-sink", daemon=True
            )
            self._writer.start()

    def append(self, record: Any) -> None:
        with self._lock:
            self._seq += 1
            self._ring.append((self._seq, record))
            if self.sink is not None:
                self._pending_sink.append((self._seq, record))

    def since(self, seq: int, limit: int = 4096) -> tuple[list[dict], int]:
        """Spans recorded after cursor ``seq`` (oldest first) + the new
        cursor. When ``limit`` truncates, the cursor points at the last span
        actually RETURNED (not the ring head), so a slow poller drains the
        backlog over successive requests instead of silently skipping it."""
        with self._lock:
            out = [(q, r) for q, r in self._ring if q > seq]
            if len(out) > limit:
                out = out[:limit]
                next_seq = out[-1][0]
            else:
                next_seq = self._seq
        return [self.materialize(q, r) for q, r in out], next_seq

    # ------------------------------------------------------------- file sink
    def _writer_loop(self) -> None:
        while not self._stop.wait(_SINK_FLUSH_S):
            self.flush()

    def flush(self) -> None:
        if self.sink is None:
            return
        with self._lock:
            batch, self._pending_sink = self._pending_sink, []
        if not batch:
            return
        if self.serialize_batch is not None:
            self.sink.write_line(self.serialize_batch(batch))
        else:
            self.sink.write([self.materialize(q, r) for q, r in batch])

    def close(self) -> None:
        self._stop.set()
        if self._writer is not None:
            self._writer.join(timeout=5.0)
        self.flush()
        if self.sink is not None:
            self.sink.close()


class Tracer:
    """Per-run live tracer. Installed only when ``PATHWAY_TRACE`` is on —
    every hot-path call site guards on ``tracer is not None`` first, so the
    off mode costs one attribute read + ``is None`` test.

    Recording a span appends a compact ``(name, parent_id, start_ns, end_ns,
    attrs)`` record; span ids derive deterministically from the record's ring
    sequence number at materialization time, so the hot path never formats or
    draws ids (``os.urandom`` costs tens of µs on some kernels)."""

    def __init__(
        self,
        *,
        trace_id: str,
        process_id: int = 0,
        sample: float = 1.0,
        buffer: SpanBuffer | None = None,
    ):
        self.trace_id = trace_id
        self.root_span_id = derive_root_span_id(trace_id)
        self.process_id = process_id
        self.sample = sample
        self.buffer = buffer if buffer is not None else SpanBuffer()
        self.buffer.materialize = self._materialize
        self.buffer.serialize_batch = self._serialize_batch
        # static ExportTraceServiceRequest envelope around the span array
        self._doc_prefix = (
            '{"resourceSpans":[{"resource":{"attributes":['
            '{"key":"service.name","value":{"stringValue":"pathway_tpu_torch"}},'
            f'{{"key":"process.pid","value":{{"intValue":"{os.getpid()}"}}}}'
            ']},"scopeSpans":[{"scope":{"name":"pathway_tpu_torch.live","version":"1"},"spans":['
        )
        self._doc_suffix = "]}]}]}"
        # span names and attribute keys come from a tiny fixed set — cache
        # their JSON-escaped forms across flush batches
        self._dumps_cache: dict[str, str] = {}
        self.start_ns = _time.time_ns()
        # current sampled tick's span id, or None between/for unsampled ticks;
        # read by child-span emitters on worker threads (a benign race: a span
        # landing exactly at a tick boundary parents to the nearer tick)
        self.tick_span_id: str | None = None
        self.current_tick: int | None = None
        # (label, bucket) shapes already dispatched — first sight of a padded
        # shape is the process's XLA-compile proxy (fresh jit cache entry)
        self._seen_shapes: set = set()
        # ONE urandom draw; explicit ids (tick spans need theirs up front for
        # parenting) walk the 64-bit space from the random base, and implicit
        # ids derive from (base ^ seq) at materialization
        self._id_base = int.from_bytes(secrets.token_bytes(8), "big")
        self._id_counter = itertools.count(1)

    def _next_span_id(self) -> str:
        return f"{(self._id_base + next(self._id_counter)) & _MASK:016x}"

    def _seq_span_id(self, seq: int) -> str:
        # disjoint from _next_span_id's range for any realistic run: explicit
        # ids count up from base, seq-derived ids flip the top bit
        return f"{(self._id_base ^ (1 << 63) ^ seq) & _MASK:016x}"

    # records: (name, span_id | None, parent_id | None, start_ns, end_ns, attrs)
    # — optionally extended with a 7th element overriding the trace id (the
    # request plane's per-request trace ids stitch next to the run trace)
    def _materialize(self, seq: int, rec: tuple) -> dict:
        name, span_id, parent_id, start_ns, end_ns, attrs = rec[:6]
        span = {
            "traceId": rec[6] if len(rec) > 6 else self.trace_id,
            "spanId": span_id if span_id is not None else self._seq_span_id(seq),
            "name": name,
            "kind": 1,
            "startTimeUnixNano": str(start_ns),
            "endTimeUnixNano": str(end_ns),
            "attributes": [_attr(k, v) for k, v in attrs.items()] if attrs else [],
        }
        if parent_id is not None:
            span["parentSpanId"] = parent_id
        return span

    def _serialize_batch(self, batch: list[tuple[int, tuple]]) -> str:
        """One OTLP/JSON line for a flush batch, by direct string building —
        the file-sink writer thread shares the GIL with the engine, so
        serialization speed IS tracing overhead."""
        dumps = json.dumps
        cache = self._dumps_cache

        def cdumps(s: str) -> str:
            r = cache.get(s)
            if r is None:
                r = cache[s] = dumps(s)
            return r

        parts = []
        for seq, rec in batch:
            name, span_id, parent_id, start_ns, end_ns, attrs = rec[:6]
            trace_id = rec[6] if len(rec) > 6 else self.trace_id
            if span_id is None:
                span_id = self._seq_span_id(seq)
            a_parts = []
            if attrs:
                for k, v in attrs.items():
                    if v is True or v is False:
                        box = '{"boolValue":true}' if v else '{"boolValue":false}'
                    elif isinstance(v, int):
                        box = f'{{"intValue":"{v}"}}'
                    elif isinstance(v, float):
                        box = f'{{"doubleValue":{v!r}}}'
                    else:
                        box = f'{{"stringValue":{dumps(str(v))}}}'
                    a_parts.append(f'{{"key":{cdumps(k)},"value":{box}}}')
            parent = (
                f'"parentSpanId":"{parent_id}",' if parent_id is not None else ""
            )
            parts.append(
                f'{{"traceId":"{trace_id}","spanId":"{span_id}",{parent}'
                f'"name":{cdumps(name)},"kind":1,'
                f'"startTimeUnixNano":"{start_ns}","endTimeUnixNano":"{end_ns}",'
                f'"attributes":[{",".join(a_parts)}]}}'
            )
        return self._doc_prefix + ",".join(parts) + self._doc_suffix

    # -------------------------------------------------------------- sampling
    def tick_sampled(self, tick: int) -> bool:
        return tick_hash_sampled(tick, self.sample)

    # ------------------------------------------------------------------ ticks
    def begin_tick(self, tick: int) -> int | None:
        """Start-of-tick hook: returns a wall-clock token when the tick is
        sampled (pass it back to ``end_tick``), else None — and the None also
        suppresses every child span of the tick (head sampling)."""
        if not self.tick_sampled(tick):
            self.tick_span_id = None
            self.current_tick = None
            return None
        self.tick_span_id = self._next_span_id()
        self.current_tick = tick
        return _time.time_ns()

    def end_tick(self, tick: int, start_ns: int, **attrs: Any) -> None:
        span_id = self.tick_span_id
        if span_id is None:
            return
        self.tick_span_id = None
        self.current_tick = None
        attrs["pathway.tick"] = tick
        attrs["pathway.process_id"] = self.process_id
        self.buffer.append(
            ("tick", span_id, self.root_span_id, start_ns, _time.time_ns(), attrs)
        )

    # ----------------------------------------------------------- child spans
    def span(
        self, name: str, start_ns: int, end_ns: int, attrs: dict | None = None, **kw: Any
    ) -> None:
        """Record one finished span under the current tick (or the run root
        when none is active, e.g. a persistence commit between ticks). Pass
        ``attrs`` as a dict — hot call sites avoid **kwargs repacking."""
        if kw:
            attrs = {**attrs, **kw} if attrs else kw
        self.buffer.append(
            (name, None, self.tick_span_id or self.root_span_id, start_ns, end_ns, attrs)
        )

    def event(self, name: str, attrs: dict | None = None, **kw: Any) -> None:
        now = _time.time_ns()
        self.span(name, now, now, attrs, **kw)

    def first_shape(self, label: str, bucket: int) -> bool:
        """True exactly once per (udf label, padded bucket) — marks the
        device dispatch that triggers a fresh XLA compile on this process."""
        key = (label, bucket)
        if key in self._seen_shapes:
            return False
        self._seen_shapes.add(key)
        return True

    # ----------------------------------------------------------------- close
    def close(self, emit_root: bool = True) -> None:
        """Flush + close the sink; process 0 emits the shared run-root span
        every process's tick spans already parent to."""
        if emit_root and self.process_id == 0:
            self.buffer.append(
                (
                    "pathway.run",
                    self.root_span_id,
                    None,
                    self.start_ns,
                    _time.time_ns(),
                    {"pathway.process_id": self.process_id},
                )
            )
        self.buffer.close()
