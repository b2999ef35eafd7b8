"""Pod timeline plane — tick-granularity telemetry history with crash-safe
segment spill and heartbeat-merged pod rollups.

Every other observability surface (/metrics, /status, heartbeat rollups, the
incident bundles) is a point-in-time snapshot. This plane answers "what
happened over the last ten minutes": a recorder thread samples every
registered probe on a fixed cadence (``PATHWAY_TIMELINE_STEP_MS``) — serving
counters, per-route and per-stage latency histogram positional deltas, engine
phase timers, the device split, health canaries — derives per-step *rates and window quantiles*
from consecutive raw samples, and keeps them in a bounded in-memory ring
(``PATHWAY_TIMELINE_WINDOW_S``). Each derived point is also appended as one
OTLP-metrics-JSON line to a rotating segment file under
``PATHWAY_TIMELINE_DIR`` (the file-sink discipline: flush per line, rename
to ``.1`` at the size cap) so the history survives a crash alongside the
flight recorder.

``/timeline?metric=&since=&step=&proc=`` serves the series (``proc=pod``:
the rollup on step buckets).

Off (``PATHWAY_TIMELINE=off``) constructs no plane: call sites pay one
``is None`` test and the recorder thread never exists.

Carried from ``pathway_tpu/observability/timeline.py`` with imports
rewritten. The device split is read from the port's device plane
(``device.heartbeat_summary``: counters the planes already keep), so the
recorder thread never waits on a CUDA event and never initialises CUDA.
The flow plane's pressure is read from ``flow.heartbeat_summary`` when the
plane is on. Left out, with the planes they read: the delivery ledger's
depth (``delivery.heartbeat_summary``, ROADMAP Queue 1 item 3), and the
cluster's peer merge and heartbeat piggyback (``_merge_peers``,
``heartbeat_summary``, item 4):
the port runs one process, so the pod series is this process's, as in a
single-process reference run.
"""

from __future__ import annotations

import json
import os
import threading
import time as _time
from collections import deque
from typing import Any

from pathway_tpu_torch.observability import metrics as _metrics
from pathway_tpu_torch.observability.spans import _attr

_plane: "TimelinePlane | None" = None


def current() -> "TimelinePlane | None":
    return _plane


# --------------------------------------------------------------------- probes


def _raw_sample(runtime) -> dict[str, Any]:
    """One raw counter snapshot of every live plane. Read-side only: walks
    state the planes already maintain; tolerates torn counters the same way
    /status does."""
    scheduler = getattr(runtime, "scheduler", None)
    rows_in = rows_out = backlog = 0
    for g in _metrics.iter_graphs(scheduler):
        for node in g.nodes:
            if hasattr(node, "wm_rows"):
                rows_in += node.wm_rows
                backlog += len(getattr(node, "_pending", ()))
            elif node.name == "microbatch_select":
                backlog += len(getattr(node, "waiting", ()))
            if node.name in ("subscribe", "capture", "output"):
                rows_out += node.stats_rows_in
    lags = [
        w["lag_s"]
        for w in _metrics.input_watermarks(scheduler)
        if w.get("lag_s") is not None
    ]
    raw: dict[str, Any] = {
        "t": _time.time(),
        "tick": getattr(scheduler, "current_time", None),
        "rows_in": rows_in,
        "rows_out": rows_out,
        "backlog": backlog,
        "wm_lag_s": max(lags) if lags else None,
        "sinks": _metrics.run_metrics().sink_snapshots(),
    }
    from pathway_tpu_torch.io.http import _server as _rest_serve

    routes: dict[str, dict] = {}
    for rs in list(_rest_serve._ROUTES):
        if rs.runtime is not runtime:
            continue
        routes[rs.route] = {
            "requests": rs.requests_total,
            "responses": rs.responses_total,
            "shed": rs.shed_total,
            "errors": rs.errors_total,
            "timeouts": rs.timeouts_total,
            "forwarded_out": rs.forwarded_out_total,
            "latency": rs.latency.snapshot(),
        }
    raw["serving"] = routes
    from pathway_tpu_torch.observability import requests as _requests

    rplane = _requests.current()
    if rplane is not None:
        raw["stages"] = {
            stage: h.snapshot() for stage, h in list(rplane.stage_hist.items())
        }
    from pathway_tpu_torch.observability import engine_phases as _phases

    ph = _phases.snapshot()
    if ph:
        raw["phases"] = {k: v["ms"] for k, v in ph.items()}
    from pathway_tpu_torch.observability import device as _device

    raw["device"] = _device.heartbeat_summary()
    from pathway_tpu_torch import flow as _flow

    fplane = _flow.current()
    if fplane is not None:
        raw["flow"] = fplane.heartbeat_summary()
    from pathway_tpu_torch.observability import health as _health

    raw["health"] = _health.heartbeat_summary()
    return raw


def _hist_delta(new: dict | None, old: dict | None) -> dict | None:
    """Positional histogram delta (the health plane's window discipline):
    what landed in each bucket BETWEEN two snapshots."""
    if not new:
        return None
    if not old:
        return new
    nc, oc = new.get("counts") or [], old.get("counts") or []
    counts = [n - (oc[i] if i < len(oc) else 0) for i, n in enumerate(nc)]
    return {
        "counts": counts,
        "sum_s": new.get("sum_s", 0.0) - old.get("sum_s", 0.0),
        "count": max(0, new.get("count", 0) - old.get("count", 0)),
    }


def _q99(delta: dict | None) -> float | None:
    if not delta or delta.get("count", 0) <= 0:
        return None
    v = _metrics.Histogram.quantile(delta, 0.99)
    return None if v is None or v == float("inf") else v


def derive_point(new: dict, old: dict) -> dict[str, Any]:
    """One timeline point: per-step rates and windowed quantiles between two
    consecutive raw samples. Flat ``{metric: number}`` plus ``t``/``tick`` —
    the shape the rings, segments, heartbeats and /timeline all share."""
    dt = max(1e-6, new["t"] - old["t"])
    p: dict[str, Any] = {"t": round(new["t"], 3)}
    if new.get("tick") is not None:
        p["tick"] = new["tick"]
        if old.get("tick") is not None:
            p["tick_rate"] = round(max(0, new["tick"] - old["tick"]) / dt, 4)
    for key, metric in (("rows_in", "rows_in_per_s"), ("rows_out", "rows_out_per_s")):
        p[metric] = round(max(0, (new.get(key) or 0) - (old.get(key) or 0)) / dt, 4)
    p["backlog_rows"] = new.get("backlog") or 0
    if new.get("wm_lag_s") is not None:
        p["watermark_lag_s"] = round(new["wm_lag_s"], 4)
    # serving: per-route qps/p99 + pod-comparable totals
    sv_new, sv_old = new.get("serving") or {}, old.get("serving") or {}
    tot = {"requests": 0, "responses": 0, "shed": 0, "errors": 0, "timeouts": 0,
           "forwarded_out": 0}
    for route, c in sv_new.items():
        o = sv_old.get(route) or {}
        for k in tot:
            tot[k] += max(0, (c.get(k) or 0) - (o.get(k) or 0))
        resp = max(0, (c.get("responses") or 0) - (o.get("responses") or 0))
        p[f"route_qps:{route}"] = round(resp / dt, 4)
        q = _q99(_hist_delta(c.get("latency"), o.get("latency")))
        if q is not None:
            p[f"route_p99_s:{route}"] = round(q, 6)
    if sv_new:
        p["serve_qps"] = round(tot["responses"] / dt, 4)
        p["serve_shed_per_s"] = round(tot["shed"] / dt, 4)
        p["serve_errors_per_s"] = round(tot["errors"] / dt, 4)
        p["serve_timeouts_per_s"] = round(tot["timeouts"] / dt, 4)
        p["serve_forward_share"] = round(
            tot["forwarded_out"] / max(1, tot["requests"]), 4
        )
    # request stage decomposition: windowed p99 + busy-time share
    st_new, st_old = new.get("stages") or {}, old.get("stages") or {}
    shares: dict[str, float] = {}
    for stage, snap in st_new.items():
        d = _hist_delta(snap, st_old.get(stage))
        q = _q99(d)
        if q is not None:
            p[f"stage_p99_s:{stage}"] = round(q, 6)
        if d and d.get("sum_s", 0.0) > 0:
            shares[stage] = d["sum_s"]
    total_share = sum(shares.values())
    for stage, s in shares.items():
        p[f"stage_share:{stage}"] = round(s / total_share, 4)
    for label, snap in (new.get("sinks") or {}).items():
        q = _q99(_hist_delta(snap, (old.get("sinks") or {}).get(label)))
        if q is not None:
            p[f"sink_p99_s:{label}"] = round(q, 6)
    # engine phase split: exclusive wall ms spent per phase this step
    ph_new, ph_old = new.get("phases") or {}, old.get("phases") or {}
    for phase, ms in ph_new.items():
        d = ms - (ph_old.get(phase) or 0.0)
        if d > 0:
            p[f"phase_ms:{phase}"] = round(d, 3)
    dev_new, dev_old = new.get("device") or {}, old.get("device") or {}
    if dev_new:
        p["device_compiles_per_s"] = round(
            max(0, (dev_new.get("compiles") or 0) - (dev_old.get("compiles") or 0))
            / dt, 4,
        )
        pn, po = dev_new.get("pad_rows") or [0, 0], dev_old.get("pad_rows") or [0, 0]
        useful, padded = max(0, pn[0] - po[0]), max(0, pn[1] - po[1])
        if useful + padded:
            p["device_pad_waste"] = round(padded / (useful + padded), 4)
        for k in ("host_ms", "device_ms"):
            d = (dev_new.get(k) or 0.0) - (dev_old.get(k) or 0.0)
            if d > 0:
                p[f"device_{k}"] = round(d, 3)
    fl = new.get("flow")
    if fl:
        p["flow_pressure"] = round(fl.get("pressure") or 0.0, 4)
        p["flow_occupied"] = fl.get("occupied") or 0
        shed = (fl.get("shed_rows") or 0) - ((old.get("flow") or {}).get("shed_rows") or 0)
        p["flow_shed_per_s"] = round(max(0, shed) / dt, 4)
    dlv = new.get("delivery")
    if dlv:
        p["delivery_depth"] = dlv.get("depth") or 0
        fails = (dlv.get("failures") or 0) - ((old.get("delivery") or {}).get("failures") or 0)
        p["delivery_failures_per_s"] = round(max(0, fails) / dt, 4)
        oldest = dlv.get("oldest_unpublished_unix")
        if oldest is not None:
            p["delivery_oldest_age_s"] = round(max(0.0, new["t"] - oldest), 3)
    hb = new.get("health")
    if hb:
        failed = (hb.get("canary_failed") or 0) - ((old.get("health") or {}).get("canary_failed") or 0)
        p["canary_failed_per_s"] = round(max(0, failed) / dt, 4)
        p["alerts_active"] = len(hb.get("active") or ())
    return p


# ------------------------------------------------------------- segment spill


class TimelineSegmentSink:
    """Rotating OTLP-metrics-JSON segment file (the trace file-sink
    discipline applied to metrics): each timeline point is one flushed
    ``ExportMetricsServiceRequest`` line of gauge data points; rotation
    renames the live segment to ``<path>.1`` (one generation kept)."""

    def __init__(self, path: str, process_id: int, rotate_bytes: int):
        self.path = path
        self.rotate_bytes = max(4096, int(rotate_bytes))
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._fh = open(path, "a", encoding="utf-8")
        self._resource = {
            "attributes": [
                _attr("service.name", "pathway_tpu_torch"),
                _attr("process.pid", os.getpid()),
                _attr("pathway.process_id", process_id),
            ]
        }

    def write(self, point: dict[str, Any]) -> None:
        if self._fh.closed:
            return
        ts = str(int(round((point.get("t") or _time.time()) * 1e9)))
        gauges = [
            {
                "name": name,
                "gauge": {
                    "dataPoints": [{"timeUnixNano": ts, "asDouble": float(v)}]
                },
            }
            for name, v in sorted(point.items())
            if name != "t" and isinstance(v, (int, float))
        ]
        doc = {
            "resourceMetrics": [
                {
                    "resource": self._resource,
                    "scopeMetrics": [
                        {
                            "scope": {
                                "name": "pathway_tpu_torch.timeline",
                                "version": "1",
                            },
                            "metrics": gauges,
                        }
                    ],
                }
            ]
        }
        self._fh.write(json.dumps(doc) + "\n")
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
        try:
            self._fh.close()
        except Exception:
            pass


def _points_of_line(line: str) -> dict[str, Any] | None:
    """Rebuild one flat timeline point from a segment line (inverse of
    :meth:`TimelineSegmentSink.write`); None for torn/foreign lines."""
    try:
        doc = json.loads(line)
        rm = doc["resourceMetrics"][0]
        metrics = rm["scopeMetrics"][0]["metrics"]
    except (ValueError, KeyError, IndexError, TypeError):
        return None
    point: dict[str, Any] = {}
    t = None
    for m in metrics:
        dps = (m.get("gauge") or {}).get("dataPoints") or ()
        if not dps:
            continue
        point[m.get("name")] = dps[0].get("asDouble")
        if t is None and dps[0].get("timeUnixNano"):
            t = int(dps[0]["timeUnixNano"]) / 1e9
    if not point:
        return None
    point["t"] = round(t, 3) if t is not None else None
    return point


def read_segments(directory: str) -> list[dict[str, Any]]:
    """Every timeline point spilled under ``directory`` (rotated ``.1``
    generations first, then live segments), oldest-first per process. Torn
    final lines — the crash case — are skipped, everything before survives."""
    points: list[dict[str, Any]] = []
    try:
        names = sorted(os.listdir(directory))
    except OSError:
        return points
    live = [n for n in names if n.startswith("timeline-") and n.endswith(".jsonl")]
    rotated = [n for n in names if n.startswith("timeline-") and n.endswith(".jsonl.1")]
    for name in rotated + live:
        try:
            with open(os.path.join(directory, name), encoding="utf-8") as fh:
                for line in fh:
                    p = _points_of_line(line)
                    if p is not None:
                        points.append(p)
        except OSError:
            continue
    points.sort(key=lambda p: (p.get("t") is not None, p.get("t") or 0.0))
    return points


def diff_summary(
    points_a: list[dict],
    points_b: list[dict],
    prefixes: tuple[str, ...] = ("phase_ms:", "stage_p99_s:"),
) -> list[dict[str, Any]]:
    """Cross-run comparison: mean of each time-cost series present in both
    runs, worst regression (B slower than A) first — the bench gate message
    names ``[0]["metric"]`` instead of just 'the number moved'."""

    def _means(points: list[dict]) -> dict[str, float]:
        sums: dict[str, list] = {}
        for p in points:
            for k, v in p.items():
                if isinstance(v, (int, float)) and any(
                    k.startswith(pre) for pre in prefixes
                ):
                    acc = sums.setdefault(k, [0.0, 0])
                    acc[0] += v
                    acc[1] += 1
        return {k: s / n for k, (s, n) in sums.items() if n}

    ma, mb = _means(points_a), _means(points_b)
    rows = []
    for metric in sorted(set(ma) & set(mb)):
        a, b = ma[metric], mb[metric]
        pct = ((b - a) / a * 100.0) if a > 0 else (100.0 if b > 0 else 0.0)
        rows.append(
            {"metric": metric, "a": round(a, 6), "b": round(b, 6),
             "regression_pct": round(pct, 2)}
        )
    rows.sort(key=lambda r: -r["regression_pct"])
    return rows


# ---------------------------------------------------------------------- plane


class TimelinePlane:
    """Recorder + rings for one process. ``sample_now()`` is the
    whole step (the thread calls it; tests call it synchronously)."""

    def __init__(self, cfg, runtime) -> None:
        self.cfg = cfg
        self.runtime = runtime
        self.pid = cfg.process_id
        self.step_s = cfg.timeline_step_ms / 1000.0
        self.window_s = cfg.timeline_window_s
        n = max(8, int(self.window_s / self.step_s) + 1)
        self._raws: deque = deque(maxlen=n)
        self.points: deque = deque(maxlen=n)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.samples_total = 0
        self.sink: TimelineSegmentSink | None = None
        if cfg.timeline_dir:
            try:
                self.sink = TimelineSegmentSink(
                    os.path.join(cfg.timeline_dir, f"timeline-p{self.pid}.jsonl"),
                    self.pid,
                    int(cfg.timeline_rotate_mb * 1024 * 1024),
                )
            except OSError:
                self.sink = None
        #: latest bottleneck attribution (ranked verdicts) — /status and the
        #: incident bundle writer read this
        self.bottleneck: dict[str, Any] | None = None
        self._last_top: str | None = None

    # ----------------------------------------------------------------- stepping
    def start(self) -> None:
        # baseline raw up front: the first thread wake-up then yields a real
        # delta point, and runs shorter than one step still produce a point
        # via the final close() sample
        try:
            self.sample_now()
        except Exception:
            pass
        self._thread = threading.Thread(
            target=self._loop, name="pathway-timeline", daemon=True
        )
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.step_s):
            try:
                self.sample_now()
            except Exception:
                # the recorder must never take the pipeline down
                pass

    def sample_now(self) -> dict[str, Any] | None:
        """One recorder step: raw-sample every probe, derive a point, spill
        it, re-attribute the bottleneck."""
        raw = _raw_sample(self.runtime)
        with self._lock:
            prev = self._raws[-1] if self._raws else None
            self._raws.append(raw)
            self.samples_total += 1
        point = None
        if prev is not None:
            point = derive_point(raw, prev)
            with self._lock:
                self.points.append(point)
            if self.sink is not None:
                try:
                    self.sink.write(point)
                except Exception:
                    pass
        from pathway_tpu_torch.observability import bottleneck as _bottleneck

        self.bottleneck = _bottleneck.attribute(self)
        self._publish_top_change()
        return point

    def _publish_top_change(self) -> None:
        """Trace event only when the ranked top cause CHANGES — a stable
        verdict must not flood the span buffer at the step cadence."""
        verdict = self.bottleneck
        top = (verdict or {}).get("top") or {}
        cause = top.get("cause")
        if cause == self._last_top:
            return
        self._last_top = cause
        if cause is None:
            return
        from pathway_tpu_torch import observability as _obs

        tracer = _obs.current()
        if tracer is not None:
            tracer.event(
                "bottleneck/top",
                {
                    "pathway.cause": cause,
                    "pathway.verdict": top.get("verdict") or "",
                    "pathway.knob": top.get("knob") or "",
                    "pathway.score": float(top.get("score") or 0.0),
                },
            )

    # ---------------------------------------------------------------- queries
    def window_edges(
        self, window_s: float | None = None
    ) -> tuple[dict | None, dict | None]:
        """(newest raw, oldest raw inside the window) — the bottleneck
        attributor's delta base."""
        with self._lock:
            raws = list(self._raws)
        if len(raws) < 2:
            return (raws[-1] if raws else None), None
        newest = raws[-1]
        horizon = newest["t"] - (window_s if window_s is not None else 60.0)
        oldest = raws[0]
        for r in raws[:-1]:
            if r["t"] >= horizon:
                oldest = r
                break
        if oldest is newest:
            oldest = raws[-2]
        return newest, oldest

    def recent_points(self, window_s: float = 120.0) -> list[dict[str, Any]]:
        """The local lead-up window (incident bundles attach this)."""
        with self._lock:
            pts = list(self.points)
        if not pts:
            return []
        horizon = pts[-1]["t"] - window_s
        return [p for p in pts if p["t"] >= horizon]

    def procs(self) -> list[str]:
        return [str(self.pid)]

    def pod_points(self, since: float | None = None) -> list[dict[str, Any]]:
        """The pod series: per-metric rollup of the points aligned on step
        buckets — rates/backlogs sum, quantiles/lags take the worst point,
        ``tick`` takes the slowest (the pod frontier). The reference folds
        its peers' rings in too; a single process's series is its own."""
        with self._lock:
            series: dict[int, list] = {self.pid: list(self.points)}
        step = max(self.step_s, 1e-3)
        buckets: dict[float, dict[str, Any]] = {}
        contributors: dict[float, set] = {}
        for pid, pts in series.items():
            for p in pts:
                t = p.get("t")
                if t is None or (since is not None and t <= since):
                    continue
                bt = round(round(t / step) * step, 3)
                b = buckets.setdefault(bt, {"t": bt})
                contributors.setdefault(bt, set()).add(pid)
                for k, v in p.items():
                    if k == "t" or not isinstance(v, (int, float)):
                        continue
                    if k not in b:
                        b[k] = v
                    elif _merge_rule(k) == "sum":
                        b[k] = round(b[k] + v, 6)
                    elif _merge_rule(k) == "min":
                        b[k] = min(b[k], v)
                    else:
                        b[k] = max(b[k], v)
        out = []
        for bt in sorted(buckets):
            b = buckets[bt]
            b["procs"] = len(contributors[bt])
            out.append(b)
        return out

    def local_points(
        self, proc: str | None = None, since: float | None = None
    ) -> list[dict[str, Any]]:
        with self._lock:
            pts = list(self.points) if proc is None or proc == str(self.pid) else []
        if since is not None:
            pts = [p for p in pts if (p.get("t") or 0) > since]
        return pts

    def payload(self, query: dict[str, list[str]]) -> dict[str, Any]:
        """The ``/timeline`` response: cursor on ``since`` (strictly newer
        points + ``next`` to resume from), optional single-``metric``
        projection, ``step`` downsampling, ``proc`` selection (``pod`` =
        merged rollup, a pid = that process, default = this process)."""

        def _one(name, cast=str, default=None):
            vals = query.get(name) or []
            if not vals:
                return default
            try:
                return cast(vals[0])
            except (TypeError, ValueError):
                return default

        since = _one("since", float)
        metric = _one("metric")
        step = _one("step", float)
        proc = _one("proc")
        if proc == "pod":
            pts = self.pod_points(since=since)
        else:
            pts = self.local_points(proc=proc, since=since)
        if step and step > 0:
            sampled, last_bucket = [], None
            for p in pts:
                b = int((p.get("t") or 0) / step)
                if b != last_bucket:
                    sampled.append(p)
                    last_bucket = b
            pts = sampled
        names: set[str] = set()
        for p in pts:
            names.update(k for k, v in p.items() if isinstance(v, (int, float)))
        names.discard("t")
        if metric:
            pts = [
                {"t": p.get("t"), "v": p.get(metric)}
                for p in pts
                if p.get(metric) is not None
            ]
        return {
            "enabled": True,
            "proc": proc or str(self.pid),
            "procs": self.procs(),
            "points": pts,
            "metrics": sorted(names),
            "next": pts[-1]["t"] if pts else since,
        }

    def status_summary(self) -> dict[str, Any]:
        with self._lock:
            n_local = len(self.points)
        return {
            "points": n_local,
            "samples": self.samples_total,
            "step_ms": int(self.step_s * 1000),
            "window_s": self.window_s,
            "dir": self.cfg.timeline_dir,
            "peers": {},
        }

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None and self._thread.is_alive():
            self._thread.join(timeout=2.0)
        # final flush sample: sub-step runs still leave one point behind
        try:
            if self._raws:
                self.sample_now()
        except Exception:
            pass
        if self.sink is not None:
            self.sink.close()


#: per-metric pod merge rule: additive rates/counts sum across processes,
#: latency quantiles / lags / pressure report the worst process, the pod tick
#: frontier is the slowest process
_SUM_EXACT = {
    "serve_qps", "serve_shed_per_s", "serve_errors_per_s", "serve_timeouts_per_s",
    "rows_in_per_s", "rows_out_per_s", "backlog_rows", "flow_occupied",
    "flow_shed_per_s", "delivery_depth", "delivery_failures_per_s",
    "canary_failed_per_s", "alerts_active", "device_compiles_per_s",
    "device_host_ms", "device_device_ms", "tick_rate",
}
_SUM_PREFIX = ("phase_ms:", "route_qps:")
_MIN_EXACT = {"tick"}


def _merge_rule(name: str) -> str:
    if name in _SUM_EXACT or any(name.startswith(p) for p in _SUM_PREFIX):
        return "sum"
    if name in _MIN_EXACT:
        return "min"
    return "max"


# ------------------------------------------------------------------ lifecycle


def install_from_env(runtime=None) -> TimelinePlane | None:
    """Build + start the recorder when ``PATHWAY_TIMELINE=on`` (the default).
    Idempotent per run; ``off`` leaves ``current()`` None so every call site
    pays one ``is None`` test."""
    global _plane
    from pathway_tpu_torch.internals.config import get_pathway_config

    shutdown()
    cfg = get_pathway_config()
    if cfg.timeline != "on":
        return None
    _plane = TimelinePlane(cfg, runtime)
    _plane.start()
    return _plane


def shutdown() -> None:
    global _plane
    if _plane is None:
        return
    try:
        _plane.close()
    except Exception:
        pass
    _plane = None
