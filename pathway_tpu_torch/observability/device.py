"""Device-side profiling & cost-attribution plane, on CUDA.

The observability plane's device side: which device functions ran, at which
shapes, with how much padding, how many device bytes each component holds,
and a profiler window on demand. Four pillars, on by default
(``PATHWAY_PROFILE=on``):

- **call and shape telemetry** — :func:`traced_jit` wraps every device entry
  point (encoder/reranker/knn/engine kernels/fused chains) and counts calls,
  cold-shape calls (first sight of an argument shape set on this process) and
  their wall time. The card compiles nothing per shape; what it does build is
  the port's own kernels — ``nvcc`` of ``csrc/attention_short.cu`` at first use
  and the host C tokenizer — and each build reports itself through
  :func:`note_build`, counted under ``compiles`` with its seconds and
  attributed to the callable dispatching at the time. A first-shape call's
  wall stays ``cold_s`` (cuBLAS heuristics and lazy module loading land
  there). A recompile-storm detector flags callables whose shape set keeps
  growing (``PATHWAY_PROFILE_SHAPE_WARN``).
- **padding & waste accounting** — the microbatch dispatcher and the
  encoder/reranker length buckets report real vs padded rows and tokens per
  UDF, plus a rough per-launch FLOP estimate (2 · params · tokens for
  transformer forwards, 2 · capacity · dim per KNN probe) feeding FLOP/s and,
  with ``PATHWAY_PROFILE_PEAK_TFLOPS``, MFU gauges.
- **memory + time attribution** — components (KNN index shards, encoder /
  reranker params, microbatch buffers) register weakly and are summed into
  ``pathway_device_bytes{component=...}``; the CUDA caching allocator's
  counters (``torch.cuda.memory_stats``) ride along as ``backend.*`` once the
  process has put tensors on the card. On trace-sampled ticks (or always
  under ``PATHWAY_PROFILE=full``) traced dispatches time the host dispatch and
  then the wait for the output's stream (a CUDA event recorded after the
  dispatch), giving each sweep-node span a host/device split.
- **flight recorder** — bounded rings of recent ticks and device events
  (builds, storms, faults), dumped as a post-mortem JSON to
  ``PATHWAY_FLIGHT_DIR`` on run errors. ``PATHWAY_PROFILE_DIR`` additionally
  captures a ``torch.profiler`` trace (CPU and CUDA activities, Chrome trace
  JSON) for the first ``PATHWAY_PROFILE_TICKS`` ticks; further windows are
  armed live via ``/profile?ticks=N``.

Carried from ``pathway_tpu/observability/device.py``; its JAX seams are
rebuilt on CUDA. The waits, the allocator reads and the profiler windows no-op
where the plane's tensors are on the CPU, as the reference's do off the TPU;
on the card a CUDA error in any of them propagates. A cluster peer's
heartbeats carry :func:`heartbeat_summary` to the coordinator, which rolls
them up with :func:`merge_heartbeat_summaries`.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time as _time
import weakref
from collections import deque
from typing import Any, Callable

from pathway_tpu_torch.internals.config import get_pathway_config

__all__ = [
    "DeviceStats",
    "flight_dump",
    "flight_note",
    "install_from_env",
    "note_build",
    "on_run_error",
    "register_memory",
    "request_profile",
    "stats",
    "status_summary",
    "tick_hook",
    "traced_jit",
]


# --------------------------------------------------------------------- labels
# Thread-local label stack: a kernel build (note_build) is attributed to
# whichever traced callable (or microbatch UDF scope) is dispatching on this
# thread.

_tls = threading.local()


def push_label(label: str) -> None:
    stack = getattr(_tls, "labels", None)
    if stack is None:
        stack = _tls.labels = []
    stack.append(label)


def pop_label() -> None:
    stack = getattr(_tls, "labels", None)
    if stack:
        stack.pop()


def current_label() -> str | None:
    stack = getattr(_tls, "labels", None)
    return stack[-1] if stack else None


def thread_device_wait_ns() -> int:
    """This thread's cumulative traced device-wait — sweep spans diff THIS
    (not the process-global counter) so concurrent worker threads cannot
    attribute each other's dispatches to their own spans."""
    return getattr(_tls, "dev_wait_ns", 0)


def thread_cold_s() -> float:
    """This thread's cumulative traced cold-call seconds — the microbatch
    dispatcher subtracts the delta across a launch so an inner traced jit's
    compile is not double-counted into the per-process compile-seconds."""
    return getattr(_tls, "cold_s", 0.0)


# --------------------------------------------------------------- CUDA helpers
# torch is imported by the callers that put tensors anywhere; this module only
# looks it up, so importing the package stays torch-free.


def _cuda_tensor(out: Any) -> Any:
    """The first CUDA tensor in a dispatch's output (a tensor, or a tuple,
    list or dict of them), or None when the output lives on the CPU."""
    torch = sys.modules.get("torch")
    if torch is None:
        return None
    if isinstance(out, torch.Tensor):
        return out if out.is_cuda else None
    if isinstance(out, (tuple, list)):
        for v in out:
            t = _cuda_tensor(v)
            if t is not None:
                return t
    elif isinstance(out, dict):
        return _cuda_tensor(list(out.values()))
    return None


def _block(out: Any) -> None:
    """Wait until the output's stream has finished the work queued so far: a
    CUDA event recorded after the dispatch, then waited on (not a device-wide
    synchronize). A no-op on CPU tensors."""
    t = _cuda_tensor(out)
    if t is None:
        return
    torch = sys.modules["torch"]
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(t.device))
    ev.synchronize()


def note_build(name: str, seconds: float) -> None:
    """One build of a hand-written kernel (``nvcc`` of a ``csrc`` source, the
    host C tokenizer): counted under ``compiles`` with its seconds, for the
    traced callable dispatching on this thread, else under ``build/<name>``.
    A build inside a traced cold call is already in that call's cold wall;
    one outside any call adds to the per-process compile-seconds."""
    st = _stats
    label = current_label()
    with st.lock:
        ent = st.compiles.setdefault(label or f"build/{name}", [0, 0.0])
        ent[0] += 1
        ent[1] += float(seconds)
        if label is None:
            st.process_compile_s += float(seconds)
    flight_note("compile", callable=label or f"build/{name}", build=name, seconds=round(seconds, 4))


# ----------------------------------------------------------------- core state


class DeviceStats:
    """Per-process device profiling state.

    Build/shape tracking is process-cumulative (the built kernels and the
    shapes already seen outlive a run); pad/FLOP/time-split accounting resets
    per run via
    :meth:`reset_run` so ``/metrics`` describes the current run.
    """

    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.mode = "on"
        self.enabled = True
        self.shape_warn = 12
        self.peak_tflops = 0.0
        # label -> [compiles, compile_seconds] from note_build
        # (process-cumulative): a cold call that built nothing compiled
        # nothing
        self.compiles: dict[str, list] = {}
        # microbatch-dispatcher scope: label -> [cold_calls, cold_s, {buckets}]
        self.dispatch: dict[str, list] = {}
        self._seen_shapes: set = set()
        #: per-process cumulative compile-seconds (cold-call wall time of
        #: dispatcher launches + traced calls)
        self.process_compile_s = 0.0
        self.reset_run()

    # -- run lifecycle -------------------------------------------------------
    def reconfigure(self, cfg) -> None:
        try:
            self.mode = cfg.profile
        except ValueError:
            self.mode = "on"
        self.enabled = self.mode != "off"
        self.shape_warn = cfg.profile_shape_warn
        self.peak_tflops = cfg.profile_peak_tflops

    def reset_run(self) -> None:
        with self.lock:
            self.started_ns = _time.time_ns()
            # label -> [real_rows, pad_rows, real_tokens, pad_tokens]
            self.pad: dict[str, list] = {}
            # name -> [host_ns, device_ns, samples]
            self.split: dict[str, list] = {}
            self.flops: dict[str, float] = {}
            self.device_wait_ns = 0

    # -- compile / shape telemetry -------------------------------------------
    def first_shape(self, label: str, bucket: Any) -> bool:
        """True exactly once per (label, shape) on this process — the first
        dispatch at that launch shape."""
        key = (label, bucket)
        if key in self._seen_shapes:
            return False
        self._seen_shapes.add(key)
        return True

    def note_cold(
        self, label: str, wall_s: float, bucket: Any = None, inner_s: float = 0.0
    ) -> None:
        """One cold (first-shape) dispatcher launch. ``inner_s`` is the cold
        wall time already booked by traced jits INSIDE the launch (the
        dispatcher's wall contains their compiles) — subtracted so the
        per-process compile-seconds counter counts each compile once."""
        own_s = max(0.0, wall_s - inner_s)
        with self.lock:
            ent = self.dispatch.setdefault(label, [0, 0.0, set()])
            ent[0] += 1
            ent[1] += wall_s
            if bucket is not None:
                ent[2].add(bucket)
            self.process_compile_s += own_s
        if bucket is not None and len(self.dispatch[label][2]) == self.shape_warn:
            flight_note("recompile_storm", callable=label, shapes=self.shape_warn)
            _storm_alert(label, self.shape_warn)

    # -- padding / flops ------------------------------------------------------
    def note_pad_rows(self, label: str, real: int, pad: int) -> None:
        with self.lock:
            ent = self.pad.setdefault(label, [0, 0, 0, 0])
            ent[0] += real
            ent[1] += pad

    def note_pad_tokens(self, label: str, real: int, pad: int) -> None:
        with self.lock:
            ent = self.pad.setdefault(label, [0, 0, 0, 0])
            ent[2] += real
            ent[3] += pad

    def note_flops(self, label: str, flops: float) -> None:
        with self.lock:
            self.flops[label] = self.flops.get(label, 0.0) + float(flops)

    # -- host/device time split ----------------------------------------------
    def want_split(self) -> bool:
        """Measure the dispatch-vs-device split on this call? ``full`` mode
        always; ``on`` mode only inside a trace-sampled tick (the spans that
        will carry the attribution exist exactly then)."""
        if self.mode == "full":
            return True
        tracer = _current_tracer()
        return tracer is not None and tracer.tick_span_id is not None

    def note_split(self, name: str, host_ns: int, device_ns: int) -> None:
        """Per-dispatch split (traced_jit): also advances the global and the
        per-thread device-wait counters (sweep spans diff the per-thread one)."""
        with self.lock:
            ent = self.split.setdefault(name, [0, 0, 0])
            ent[0] += host_ns
            ent[1] += device_ns
            ent[2] += 1
            self.device_wait_ns += device_ns
        _tls.dev_wait_ns = getattr(_tls, "dev_wait_ns", 0) + device_ns

    def note_span_split(self, name: str, host_ns: int, device_ns: int) -> None:
        """Per-sweep-span aggregation: the device part was already counted in
        ``device_wait_ns`` by the dispatches inside the span."""
        with self.lock:
            ent = self.split.setdefault(name, [0, 0, 0])
            ent[0] += host_ns
            ent[1] += device_ns
            ent[2] += 1


_stats = DeviceStats()


def stats() -> DeviceStats:
    return _stats


def _current_tracer():
    from pathway_tpu_torch import observability as _obs

    return _obs.current()


# ------------------------------------------------------------------ traced_jit


class _TracedJit:
    """Wrapper around a device entry point: shape-set / cold-call accounting
    on every call, host-vs-device timing on sampled calls. Off mode costs one
    attribute read + ``is``-test."""

    def __init__(self, label: str, fn: Callable):
        self.label = label
        self.fn = fn
        self.__name__ = getattr(fn, "__name__", label)
        self._seen: set = set()
        # guards the cold-shape decision only — the warm path stays lock-free
        # (set membership reads are safe under the GIL; the counters are
        # monitoring-grade and tolerate lost increments)
        self._cold_lock = threading.Lock()
        self.calls = 0
        self.cold_calls = 0
        self.cold_s = 0.0
        self.storm = False
        _wrappers.add(self)

    # shape signature: positional args' tensor shapes/dtypes, hashable
    # non-arrays verbatim, containers structurally. Params dicts contribute
    # their leaf count only and a parameter module its type — their leaf
    # shapes are fixed per model object and walking a full tree per call is
    # not negligible.
    @staticmethod
    def _sig(x: Any) -> Any:
        shape = getattr(x, "shape", None)
        if shape is not None:
            return (tuple(shape), str(getattr(x, "dtype", "")))
        if isinstance(x, dict):
            return ("dict", len(x))
        torch = sys.modules.get("torch")
        if torch is not None and isinstance(x, torch.nn.Module):
            return ("module", type(x).__name__)
        if isinstance(x, (list, tuple)):
            return tuple(_TracedJit._sig(v) for v in x)
        try:
            hash(x)
        except TypeError:
            return type(x).__name__
        return x

    def shape_key(self, args: tuple, kwargs: dict) -> tuple:
        key = tuple(self._sig(a) for a in args)
        if kwargs:
            key += tuple((k, self._sig(v)) for k, v in sorted(kwargs.items()))
        return key

    def __call__(self, *args: Any, **kwargs: Any):
        st = _stats
        if not st.enabled:
            return self.fn(*args, **kwargs)
        self.calls += 1
        key = self.shape_key(args, kwargs)
        cold = key not in self._seen
        if cold:
            # double-checked under the lock: two worker threads racing the
            # same fresh shape must measure (and count) the compile once
            with self._cold_lock:
                cold = key not in self._seen
                if cold:
                    self._seen.add(key)
        push_label(self.label)
        try:
            if cold:
                t0 = _time.perf_counter()
                out = self.fn(*args, **kwargs)
                _block(out)
                dt = _time.perf_counter() - t0
                self.cold_calls += 1
                self.cold_s += dt
                _tls.cold_s = getattr(_tls, "cold_s", 0.0) + dt
                with st.lock:
                    st.process_compile_s += dt
                if len(self._seen) >= st.shape_warn and not self.storm:
                    self.storm = True
                    flight_note(
                        "recompile_storm",
                        callable=self.label,
                        shapes=len(self._seen),
                    )
                    _storm_alert(self.label, len(self._seen))
                return out
            if st.want_split():
                t0 = _time.perf_counter_ns()
                out = self.fn(*args, **kwargs)
                t1 = _time.perf_counter_ns()
                _block(out)
                st.note_split(self.label, t1 - t0, _time.perf_counter_ns() - t1)
                return out
            return self.fn(*args, **kwargs)
        finally:
            pop_label()


_wrappers: "weakref.WeakSet[_TracedJit]" = weakref.WeakSet()


def traced_jit(label: str, fn: Callable) -> Callable:
    """Wrap an (already-jitted) callable with compile/shape telemetry."""
    return _TracedJit(label, fn)


# ------------------------------------------------------------- memory registry

# (component, weakref-to-owner, fn(owner) -> bytes); dead owners pruned on read
_memory_providers: list[tuple[str, "weakref.ref", Callable]] = []
_memory_lock = threading.Lock()


def register_memory(obj: Any, component: str, fn: Callable[[Any], int]) -> None:
    """Attribute ``obj``'s live device bytes to ``component`` while it lives
    (``pathway_device_bytes{component=...}``). Weakly referenced — no
    lifetime coupling, and unregistration is implicit."""
    try:
        ref = weakref.ref(obj)
    except TypeError:
        return
    with _memory_lock:
        if len(_memory_providers) > 4096:
            _memory_providers[:] = [
                (c, r, f) for c, r, f in _memory_providers if r() is not None
            ]
        _memory_providers.append((component, ref, fn))


def index_tier_stats() -> dict | None:
    """Aggregate tiered-index stats, or None when no tiered backend lives (or
    the indexing stack can't import on this image). The ONE guarded accessor
    behind both the /metrics lines here and the /status block in
    ``internals.monitoring`` — keep the two surfaces from diverging."""
    try:
        from pathway_tpu_torch.stdlib.indexing.tiered import tier_stats
    except ImportError:
        return None  # indexing stack absent on this image
    return tier_stats()


def memory_components() -> dict[str, int]:
    """component -> summed live bytes across registered owners."""
    out: dict[str, int] = {}
    with _memory_lock:
        providers = list(_memory_providers)
    live: list[tuple[str, "weakref.ref", Callable]] = []
    for component, ref, fn in providers:
        obj = ref()
        if obj is None:
            continue
        live.append((component, ref, fn))
        try:
            out[component] = out.get(component, 0) + int(fn(obj))
        except Exception:
            continue
    if len(live) != len(providers):
        with _memory_lock:
            _memory_providers[:] = live
    return out


def backend_memory() -> dict[str, int] | None:
    """The CUDA caching allocator's counters on this process's card: bytes
    allocated now and at peak (``torch.cuda.memory_stats``) and the card's
    total memory (``torch.cuda.mem_get_info``); None while the plane's tensors
    are on the CPU (no card, or CUDA never initialized in this process)."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return None
    dev = torch.cuda.current_device()
    ms = torch.cuda.memory_stats(dev)
    return {
        "bytes_in_use": int(ms.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(ms.get("allocated_bytes.all.peak", 0)),
        "bytes_limit": int(torch.cuda.mem_get_info(dev)[1]),
    }


# ------------------------------------------------------------- flight recorder


class FlightRecorder:
    """Bounded rings of recent ticks and device events for post-mortems."""

    def __init__(self, max_events: int = 1024):
        self._lock = threading.Lock()
        self.events: deque = deque(maxlen=max_events)
        self.ticks: deque = deque(maxlen=max(64, max_events // 4))

    def note(self, kind: str, **attrs: Any) -> None:
        rec = {"t_ns": _time.time_ns(), "kind": kind}
        if attrs:
            rec.update(attrs)
        with self._lock:
            self.events.append(rec)

    def note_tick(self, tick: int) -> None:
        with self._lock:
            self.ticks.append((tick, _time.time_ns()))

    def snapshot(self) -> dict[str, list]:
        with self._lock:
            return {
                "events": list(self.events),
                "ticks": [{"tick": t, "t_ns": ns} for t, ns in self.ticks],
            }


_recorder = FlightRecorder()


def flight_note(kind: str, **attrs: Any) -> None:
    rec = _recorder
    if rec is not None and _stats.enabled:
        rec.note(kind, **attrs)


def flight_snapshot() -> dict[str, list]:
    """The flight-recorder rings (recent device events + ticks) — read by the
    health plane's incident bundles and ``flight_dump``."""
    return _recorder.snapshot()


def _storm_alert(label: str, shapes: int) -> None:
    """The recompile-storm tripwire unified into the alert registry: the
    same condition that flags ``/status`` now fires through ``/alerts``,
    Prometheus and the notification sinks like every other detector. No-op
    when the health plane is off."""
    from pathway_tpu_torch.observability import alerts as _alerts

    registry = _alerts.current()
    if registry is not None:
        registry.fire(
            "recompile_storm",
            fingerprint=label,
            severity="warn",
            summary=(
                f"callable {label!r} compiled {shapes} distinct shapes — "
                "bucketing is not closing the shape set"
            ),
            auto=False,
        )


def flight_dump(
    reason: str, error: BaseException | None = None, extra: dict | None = None
) -> str | None:
    """Write the post-mortem JSON to ``PATHWAY_FLIGHT_DIR`` (no-op when the
    knob is unset). Returns the file path, or None. Never raises."""
    try:
        cfg = get_pathway_config()
        out_dir = cfg.flight_dir
        if not out_dir:
            return None
        os.makedirs(out_dir, exist_ok=True)
        doc: dict[str, Any] = {
            "reason": reason,
            "process_id": cfg.process_id,
            "time_unix": round(_time.time(), 3),
            "extra": extra,
            "device": status_summary(None),
        }
        # request-trace plane: which user queries were mid-flight (and how
        # far each got) when this process died — the post-mortem names them
        try:
            from pathway_tpu_torch.observability import requests as _requests

            rp = _requests.current()
            if rp is not None:
                doc["requests"] = rp.inflight_table()
        except Exception:
            pass
        if error is not None:
            doc["error"] = {
                "type": type(error).__name__,
                "message": str(error),
                # OtherWorkerError carries the failed peer + its last tick
                "process_id": getattr(error, "process_id", None),
                "tick": getattr(error, "tick", None),
                "peer_reason": getattr(error, "reason", None),
            }
        doc.update(_recorder.snapshot())
        path = os.path.join(
            out_dir, f"flight_p{cfg.process_id}_{_time.time_ns()}.json"
        )
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(doc, fh, default=str)
        return path
    except Exception:
        return None


def on_run_error(error: BaseException, runtime: Any = None) -> None:
    """Run-loop failure hook (``terminate_on_error`` aborts, dead-peer
    ``OtherWorkerError``): record the failure and write the post-mortem."""
    try:
        from pathway_tpu_torch.internals.errors import OtherWorkerError

        is_peer = isinstance(error, OtherWorkerError)
    except Exception:
        is_peer = False
    flight_note(
        "run_error",
        error=type(error).__name__,
        message=str(error)[:500],
        peer=getattr(error, "process_id", None),
        tick=getattr(error, "tick", None),
    )
    flight_dump("other_worker_error" if is_peer else "run_error", error=error)


# --------------------------------------------------- torch.profiler windows


class _ProfileWindow:
    __slots__ = ("path", "remaining", "active", "prof")

    def __init__(self, path: str, ticks: int):
        self.path = path
        self.remaining = max(1, int(ticks))
        self.active = False
        self.prof: Any = None


_profile_window: _ProfileWindow | None = None
_profile_lock = threading.Lock()
#: the Chrome trace the last closed window wrote (:func:`last_trace`)
_last_trace: str | None = None


def request_profile(ticks: int | None = None, path: str | None = None) -> dict:
    """Arm a ``torch.profiler`` capture window for the next N ticks (served
    by ``/profile?ticks=N``); the trace lands in ``path`` (default
    ``PATHWAY_PROFILE_DIR``) as Chrome trace JSON when the window closes."""
    global _profile_window
    cfg = get_pathway_config()
    path = path or cfg.profile_dir
    if not path:
        return {
            "ok": False,
            "error": "no capture directory (set PATHWAY_PROFILE_DIR or pass dir=)",
        }
    with _profile_lock:
        if _profile_window is not None:
            return {"ok": False, "error": "a capture window is already active"}
        _profile_window = _ProfileWindow(path, ticks or cfg.profile_ticks)
        return {"ok": True, "dir": path, "ticks": _profile_window.remaining}


def _profile_state() -> dict | None:
    w = _profile_window
    if w is None:
        return None
    return {"dir": w.path, "ticks_remaining": w.remaining, "active": w.active}


def last_trace() -> str | None:
    """The Chrome trace file the last closed profiler window wrote."""
    return _last_trace


def _activities() -> list:
    import torch.profiler

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _step_profile(tick: int) -> None:
    global _profile_window
    with _profile_lock:
        w = _profile_window
        if w is None:
            return
        if not w.active:
            import torch.profiler

            os.makedirs(w.path, exist_ok=True)
            w.prof = torch.profiler.profile(activities=_activities())
            w.prof.start()
            w.active = True
            flight_note("profile_start", dir=w.path, tick=tick, ticks=w.remaining)
        w.remaining -= 1
        if w.remaining <= 0:
            _stop_profile_locked(tick)


def _stop_profile_locked(tick: int | None = None) -> None:
    global _profile_window, _last_trace
    w = _profile_window
    _profile_window = None
    if w is None or not w.active:
        return
    w.prof.stop()
    cfg = get_pathway_config()
    path = os.path.join(
        w.path, f"pathway_profile_p{cfg.process_id}_{_time.time_ns()}.json"
    )
    w.prof.export_chrome_trace(path)
    _last_trace = path
    flight_note("profile_stop", dir=w.path, tick=tick, trace=path)


def tick_hook(tick: int) -> None:
    """Once per engine tick from the run loop: steps an armed profiler window
    and stamps the flight recorder's tick ring. Off mode is two global
    reads."""
    if _profile_window is not None:
        _step_profile(tick)
    st = _stats
    if st.enabled:
        _recorder.note_tick(tick)


# ------------------------------------------------------------- run lifecycle


def install_from_env(runtime: Any = None) -> None:
    """Per-run (re)initialization, called from ``observability.
    install_from_env`` next to the tracer/fault installs."""
    global _recorder
    cfg = get_pathway_config()
    _stats.reconfigure(cfg)
    _stats.reset_run()
    _recorder = FlightRecorder(cfg.flight_events)
    if not _stats.enabled:
        return
    if cfg.profile_dir:
        request_profile(cfg.profile_ticks, cfg.profile_dir)


def shutdown() -> None:
    """Run teardown: close any live profiler capture (its trace is written).
    A CUDA error while closing it propagates."""
    with _profile_lock:
        _stop_profile_locked()


def heartbeat_summary() -> dict[str, Any] | None:
    """The compact device block (reference ``heartbeat_summary``): builds,
    shapes, pad rows, registered bytes and the host/device split, read from
    counters the plane already keeps — it waits on no CUDA event and calls
    nothing of CUDA, so the timeline's recorder thread may read it. The
    timeline plane samples it, and a cluster peer's heartbeats carry it to
    the coordinator (``observability/aggregate.py``)."""
    st = _stats
    if not st.enabled:
        return None
    callables = _callables_view()
    with st.lock:
        pad = [sum(v[0] for v in st.pad.values()), sum(v[1] for v in st.pad.values())]
        split_host = sum(v[0] for v in st.split.values())
        split_dev = sum(v[1] for v in st.split.values())
        compile_s = st.process_compile_s
    return {
        "compiles": sum(c["compiles"] for c in callables.values()),
        "compile_s": round(sum(c["compile_s"] for c in callables.values()), 4),
        "process_compile_s": round(compile_s, 4),
        "shapes_max": max((c["shapes"] for c in callables.values()), default=0),
        "storm": any(c["storm"] for c in callables.values()),
        "pad_rows": pad,
        "device_bytes": sum(memory_components().values()),
        "host_ms": round(split_host / 1e6, 3),
        "device_ms": round(split_dev / 1e6, 3),
    }


# ------------------------------------------------------------------ summaries


def _callables_view() -> dict[str, dict]:
    st = _stats
    # label -> [calls, cold_calls, cold_s, shapes] — SUMMED across wrappers
    # sharing a label (e.g. the grouped kernel of two reducer sets): each
    # wrapper owns its own shape set, so shape-set sizes add, and summing
    # keeps the exported counters monotonic regardless of WeakSet iteration
    # order
    acc: dict[str, list] = {}
    for w in list(_wrappers):
        if not w.calls and not w.cold_calls:
            continue  # registered but never dispatched — noise on /status
        ent = acc.setdefault(w.label, [0, 0, 0.0, 0, False])
        ent[0] += w.calls
        ent[1] += w.cold_calls
        ent[2] += w.cold_s
        ent[3] += len(w._seen)
        ent[4] = ent[4] or w.storm
    with st.lock:
        compiles = {k: list(v) for k, v in st.compiles.items()}
        dispatch = {k: (v[0], v[1], len(v[2])) for k, v in st.dispatch.items()}
    out: dict[str, dict] = {}

    def _compiled(label: str, cold: int, cold_s: float) -> tuple[int, float]:
        # only a kernel build is a compile on the card: a cold call that
        # built nothing compiled nothing (its wall stays cold_s)
        c = compiles.get(label)
        return (c[0], c[1]) if c else (0, 0.0)

    for label, (calls, cold, cold_s, shapes, storm) in acc.items():
        n, s = _compiled(label, cold, cold_s)
        out[label] = {
            "calls": calls,
            "cold_calls": cold,
            "cold_s": round(cold_s, 4),
            "compiles": n,
            "compile_s": round(s, 4),
            "shapes": shapes,
            "storm": storm or shapes >= st.shape_warn,
        }
    for label, (cold, cold_s, shapes) in dispatch.items():
        n, s = _compiled(label, cold, cold_s)
        out[label] = {
            "calls": None,
            "cold_calls": cold,
            "cold_s": round(cold_s, 4),
            "compiles": n,
            "compile_s": round(s, 4),
            "shapes": shapes,
            "storm": shapes >= st.shape_warn,
        }
    for label, (n, s) in compiles.items():
        # a build outside any traced call (``build/<name>``)
        out.setdefault(
            label,
            {
                "calls": None,
                "cold_calls": 0,
                "cold_s": 0.0,
                "compiles": n,
                "compile_s": round(s, 4),
                "shapes": 0,
                "storm": False,
            },
        )
    return dict(sorted(out.items()))


def _pad_view() -> dict[str, dict]:
    st = _stats
    out: dict[str, dict] = {}
    with st.lock:
        items = [(k, list(v)) for k, v in st.pad.items()]
    for label, (rr, pr, rt, pt) in sorted(items):
        row = {"real_rows": rr, "pad_rows": pr}
        if rr + pr:
            row["row_waste_ratio"] = round(pr / (rr + pr), 4)
        if rt + pt:
            row["real_tokens"] = rt
            row["pad_tokens"] = pt
            row["token_waste_ratio"] = round(pt / (rt + pt), 4)
        out[label] = row
    return out


def _microbatch_buffer_bytes(runtime: Any) -> int:
    """Rough live bytes held in cross-tick microbatch buffers (status-time
    walk; array cells report nbytes, scalars a nominal 8)."""
    if runtime is None:
        return 0
    from pathway_tpu_torch.observability.metrics import iter_graphs

    total = 0
    try:
        for g in iter_graphs(getattr(runtime, "scheduler", None)):
            for node in g.nodes:
                if node.name != "microbatch_select":
                    continue
                for entry in list(getattr(node, "waiting", {}).values()):
                    for cell in entry[3]:
                        if cell[0] != "args":
                            continue
                        for v in cell[1]:
                            total += getattr(v, "nbytes", 8)
    except Exception:
        return total
    return total


def status_summary(runtime: Any = None) -> dict[str, Any]:
    """The ``/status`` ``device`` section (also embedded in flight dumps)."""
    st = _stats
    if not st.enabled:
        return {"enabled": False, "mode": "off"}
    callables = _callables_view()
    with st.lock:
        flops = dict(st.flops)
        split = {k: list(v) for k, v in st.split.items()}
        started_ns = st.started_ns
        compile_s = st.process_compile_s
    elapsed_s = max(1e-9, (_time.time_ns() - started_ns) / 1e9)
    mem = memory_components()
    mb = _microbatch_buffer_bytes(runtime)
    if mb:
        mem["microbatch_buffers"] = mem.get("microbatch_buffers", 0) + mb
    flops_total = sum(flops.values())
    out: dict[str, Any] = {
        "enabled": True,
        "mode": st.mode,
        "process_compile_s": round(compile_s, 4),
        "callables": callables,
        "pad": _pad_view(),
        "memory": {"components": mem, "backend": backend_memory()},
        "time_split": {
            name: {
                "host_ms": round(h / 1e6, 3),
                "device_ms": round(d / 1e6, 3),
                "samples": n,
            }
            for name, (h, d, n) in sorted(split.items())
        },
        "flops": {
            "by_label": {k: round(v, 1) for k, v in sorted(flops.items())},
            "total": round(flops_total, 1),
            "per_s": round(flops_total / elapsed_s, 1),
        },
        "profiler": _profile_state(),
        "flight": {
            "events": len(_recorder.events),
            "dir": get_pathway_config().flight_dir,
        },
    }
    if st.peak_tflops > 0:
        out["flops"]["mfu"] = round(
            flops_total / elapsed_s / (st.peak_tflops * 1e12), 6
        )
    storms = [label for label, c in callables.items() if c["storm"]]
    if storms:
        out["warnings"] = [
            f"recompile storm: {label} has {callables[label]['shapes']} compiled "
            f"shapes (>= PATHWAY_PROFILE_SHAPE_WARN={st.shape_warn}) — "
            "unbucketed input shapes defeat the compile cache"
            for label in storms
        ]
    return out


def merge_heartbeat_summaries(blocks: list[dict]) -> dict[str, Any] | None:
    """Cluster rollup of peers' heartbeat device blocks (coordinator
    ``/status``)."""
    blocks = [b for b in blocks if b]
    if not blocks:
        return None
    return {
        "compiles": sum(b.get("compiles") or 0 for b in blocks),
        "compile_s": round(sum(b.get("compile_s") or 0.0 for b in blocks), 4),
        "shapes_max": max(b.get("shapes_max") or 0 for b in blocks),
        "storm": any(b.get("storm") for b in blocks),
        "pad_rows": [
            sum((b.get("pad_rows") or [0, 0])[0] for b in blocks),
            sum((b.get("pad_rows") or [0, 0])[1] for b in blocks),
        ],
        "device_bytes": sum(b.get("device_bytes") or 0 for b in blocks),
        "host_ms": round(sum(b.get("host_ms") or 0.0 for b in blocks), 3),
        "device_ms": round(sum(b.get("device_ms") or 0.0 for b in blocks), 3),
    }


# ------------------------------------------------------------------ /metrics


def prometheus_lines(runtime: Any = None) -> list[str]:
    """Device-plane Prometheus exposition lines (appended by
    ``internals.monitoring.prometheus_text``)."""
    st = _stats
    if not st.enabled:
        return []
    from pathway_tpu_torch.internals.monitoring import escape_label_value as esc

    lines: list[str] = []
    callables = _callables_view()
    if callables:
        lines.append("# HELP pathway_jit_compiles_total Kernel builds per traced callable")
        lines.append("# TYPE pathway_jit_compiles_total counter")
        for label, c in callables.items():
            lines.append(
                f'pathway_jit_compiles_total{{callable="{esc(label)}"}} {c["compiles"]}'
            )
        lines.append("# HELP pathway_jit_compile_seconds_total Compile seconds per traced callable")
        lines.append("# TYPE pathway_jit_compile_seconds_total counter")
        for label, c in callables.items():
            lines.append(
                f'pathway_jit_compile_seconds_total{{callable="{esc(label)}"}} {c["compile_s"]}'
            )
        lines.append("# HELP pathway_jit_shape_set_size Compile-cache shape-set cardinality per traced callable")
        lines.append("# TYPE pathway_jit_shape_set_size gauge")
        for label, c in callables.items():
            lines.append(
                f'pathway_jit_shape_set_size{{callable="{esc(label)}"}} {c["shapes"]}'
            )
    pad = _pad_view()
    if pad:
        lines.append("# HELP pathway_pad_rows_total Real vs padding rows launched per UDF")
        lines.append("# TYPE pathway_pad_rows_total counter")
        for label, row in pad.items():
            lines.append(
                f'pathway_pad_rows_total{{udf="{esc(label)}",kind="real"}} {row["real_rows"]}'
            )
            lines.append(
                f'pathway_pad_rows_total{{udf="{esc(label)}",kind="pad"}} {row["pad_rows"]}'
            )
        tok = {k: v for k, v in pad.items() if "real_tokens" in v}
        if tok:
            lines.append("# HELP pathway_pad_tokens_total Real vs padding tokens launched per UDF")
            lines.append("# TYPE pathway_pad_tokens_total counter")
            for label, row in tok.items():
                lines.append(
                    f'pathway_pad_tokens_total{{udf="{esc(label)}",kind="real"}} {row["real_tokens"]}'
                )
                lines.append(
                    f'pathway_pad_tokens_total{{udf="{esc(label)}",kind="pad"}} {row["pad_tokens"]}'
                )
        lines.append("# HELP pathway_pad_waste_ratio Fraction of launched rows that were padding")
        lines.append("# TYPE pathway_pad_waste_ratio gauge")
        for label, row in pad.items():
            ratio = row.get("row_waste_ratio")
            if ratio is not None:
                lines.append(
                    f'pathway_pad_waste_ratio{{udf="{esc(label)}"}} {ratio}'
                )
    mem = memory_components()
    mb = _microbatch_buffer_bytes(runtime)
    if mb:
        mem["microbatch_buffers"] = mem.get("microbatch_buffers", 0) + mb
    backend = backend_memory()
    if backend:
        for k, v in backend.items():
            mem[f"backend.{k}"] = v
    # family header always present (a scrape with no live components is a
    # valid empty family, not a missing metric)
    lines.append("# HELP pathway_device_bytes Live device bytes attributed per component")
    lines.append("# TYPE pathway_device_bytes gauge")
    for component, n in sorted(mem.items()):
        lines.append(
            f'pathway_device_bytes{{component="{esc(component)}"}} {n}'
        )
    with st.lock:
        flops_total = sum(st.flops.values())
        started_ns = st.started_ns
    if flops_total:
        elapsed_s = max(1e-9, (_time.time_ns() - started_ns) / 1e9)
        lines.append("# HELP pathway_device_flops_total Estimated device FLOPs launched this run")
        lines.append("# TYPE pathway_device_flops_total counter")
        lines.append(f"pathway_device_flops_total {round(flops_total, 1)}")
        lines.append("# HELP pathway_device_flops_per_s Estimated achieved device FLOP/s this run")
        lines.append("# TYPE pathway_device_flops_per_s gauge")
        lines.append(
            f"pathway_device_flops_per_s {round(flops_total / elapsed_s, 1)}"
        )
        if st.peak_tflops > 0:
            lines.append("# HELP pathway_mfu Model FLOPs utilization vs PATHWAY_PROFILE_PEAK_TFLOPS")
            lines.append("# TYPE pathway_mfu gauge")
            lines.append(
                f"pathway_mfu {round(flops_total / elapsed_s / (st.peak_tflops * 1e12), 6)}"
            )
    # ---- tiered-index plane (hot HBM shard over host IVF cold tier) ---------
    # hot/cold device bytes already ride pathway_device_bytes via the
    # knn_hot/knn_cold memory components; these add serving-quality gauges
    ts = index_tier_stats()
    if ts is not None:
        lines.append("# HELP pathway_index_hot_hit_ratio Fraction of emitted KNN hits served from the HBM hot shard")
        lines.append("# TYPE pathway_index_hot_hit_ratio gauge")
        lines.append(f"pathway_index_hot_hit_ratio {ts['hot_hit_ratio'] or 0.0}")
        lines.append("# HELP pathway_index_promotions_total Rows promoted cold->hot by the tiered-index maintenance pass")
        lines.append("# TYPE pathway_index_promotions_total counter")
        lines.append(f"pathway_index_promotions_total {ts['promotions_total']}")
        lines.append("# HELP pathway_index_demotions_total Rows demoted hot->cold by the tiered-index maintenance pass")
        lines.append("# TYPE pathway_index_demotions_total counter")
        lines.append(f"pathway_index_demotions_total {ts['demotions_total']}")
        lines.append("# HELP pathway_index_tier_rows Resident rows per tier of the tiered KNN index")
        lines.append("# TYPE pathway_index_tier_rows gauge")
        lines.append(f'pathway_index_tier_rows{{tier="hot"}} {ts["hot_rows"]}')
        lines.append(f'pathway_index_tier_rows{{tier="cold"}} {ts["cold_rows"]}')
    return lines
