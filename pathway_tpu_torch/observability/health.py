"""Pod health & SLO plane: readiness doors, burn-rate alerts, canary probes.

Without it nothing tells a load balancer *which door is safe to send
traffic to right now* (elastic rescales, fabric doors, bounded-staleness
replicas), and nothing watches the pod's own SLOs. This plane
(``PATHWAY_HEALTH=on``, the default) adds four pillars:

- **truthful readiness** — every door (the owner's webserver, each fabric peer
  door, the monitoring server) serves ``/healthz`` (liveness) and ``/readyz``
  (readiness) from one explicit per-door state machine::

      starting → syncing → ready → draining → stopped

  wired into the REAL transitions: a replica gap→resync marks the door
  ``syncing`` (fabric/routing tokens), a ``/scale`` rescale marks the pod
  ``draining`` *before* the quiesce pause, a Supervisor relaunch re-enters
  ``starting``, and shutdown answers ``503`` + ``Retry-After``;
- **declared SLOs + burn-rate alerts** — availability and per-route p99
  objectives (``PATHWAY_SLO_*`` env or :func:`set_slo`) evaluated with the SRE
  Workbook's fast/slow multi-window burn-rate rule over the serving
  histograms the doors already keep, plus rule-based detectors over signals
  every prior plane exports (watermark stall, replica-lag breach, heartbeat
  flap, autoscaler thrash, error-rate spike, backlog growth);
- **synthetic canary probes** — each door self-probes its registered routes
  with an ``X-Pathway-Canary`` request every ``PATHWAY_CANARY_INTERVAL_MS``;
  canaries short-circuit at the door (never a query row, never a user-facing
  counter) and feed the availability SLO even at zero organic traffic;
- **incident bundles** — see :mod:`pathway_tpu_torch.observability.alerts`.

``PATHWAY_HEALTH=off`` installs nothing: the serving path is byte-identical
to the plane never existing, and the door endpoints degrade to
unconditional 200s.

Carried from ``pathway_tpu/observability/health.py`` with imports rewritten,
with the fabric's link canaries, the replica-lag detector and the
autoscaler-thrash detector (membership versions churning inside the slow
window, read from the elasticity plane). The sink-commit-stall detector
reads the delivery plane, as in the reference.
"""

from __future__ import annotations

import threading
import time as _time
from collections import deque
from typing import Any

from pathway_tpu_torch.internals.telemetry import record_event

#: door phases in lifecycle order (syncing is an overlay on ready: any live
#: resync token demotes a ready door until the token set drains)
PHASES = ("starting", "syncing", "ready", "draining", "stopped")

#: samples retained beyond the slow window (ring pruned each eval tick)
_SAMPLES_MAX = 4096


# -------------------------------------------------------------- declared SLOs

#: programmatic SLO declarations (``pw.set_slo``) — merged over the env knobs
#: at every evaluation so tests and notebooks can declare objectives live
_declared_lock = threading.Lock()
_declared: dict[str, Any] = {"availability": None, "p99_ms": {}}


def set_slo(
    route: str | None = None,
    *,
    p99_ms: float | None = None,
    availability: float | None = None,
) -> None:
    """Declare a serving objective: ``availability`` (pod-wide success-rate
    target, e.g. ``0.999``) and/or a per-route latency objective ``p99_ms``
    (99% of requests under this many milliseconds; ``route=None`` applies to
    every route). Overrides ``PATHWAY_SLO_AVAILABILITY``/``PATHWAY_SLO_P99_MS``."""
    with _declared_lock:
        if availability is not None:
            _declared["availability"] = float(availability)
        if p99_ms is not None:
            _declared["p99_ms"][route] = float(p99_ms)


def reset_slos() -> None:
    """Drop programmatic declarations (test isolation)."""
    with _declared_lock:
        _declared["availability"] = None
        _declared["p99_ms"] = {}


# -------------------------------------------------------------------- plane


class HealthPlane:
    """One per-process door state machine + the canary/SLO evaluator thread."""

    def __init__(self, cfg, runtime: Any = None):
        self.cfg = cfg
        self.runtime = runtime
        self._lock = threading.Lock()
        self._phase = "starting"
        self._drain_reason: str | None = None
        #: live resync tokens (fabric replica/table resyncs in flight) — any
        #: token present demotes a ready door to ``syncing``
        self._syncing: set = set()
        self.started_unix = round(_time.time(), 3)
        self.transitions: list[tuple[str, float]] = [("starting", self.started_unix)]
        # canary state (per route)
        self.canary_interval_s = max(0.0, cfg.canary_interval_ms / 1000.0)
        self.canary_timeout_s = max(0.05, cfg.canary_timeout_ms / 1000.0)
        self.canary_total: dict[str, int] = {}
        self.canary_failed: dict[str, int] = {}
        self.canary_last_s: dict[str, float] = {}
        # SLO evaluator state
        self.eval_interval_s = max(0.05, cfg.health_eval_ms / 1000.0)
        self._samples: deque = deque(maxlen=_SAMPLES_MAX)
        self.burn: dict[str, dict[str, float]] = {}  # slo key -> window -> burn
        self.budget_remaining: dict[str, float] = {}
        self.evals_total = 0
        self._membership_versions: deque = deque(maxlen=64)
        self.registry = None  # set by install_from_env (alerts.AlertRegistry)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------- state machine
    def door_state(self) -> str:
        with self._lock:
            if self._phase in ("draining", "stopped", "starting"):
                return self._phase
            return "syncing" if self._syncing else "ready"

    def mark_ready(self) -> None:
        """starting → ready (connectors started, fabric installed). A door
        already draining or stopped never re-enters ready."""
        self._transition("ready", allowed_from=("starting",))

    def mark_draining(self, reason: str) -> None:
        """Traffic must drain NOW (rescale quiesce, shutdown): sticky — a
        draining door only ever advances to stopped."""
        with self._lock:
            if self._phase in ("draining", "stopped"):
                return
            self._phase = "draining"
            self._drain_reason = reason
            self.transitions.append(("draining", round(_time.time(), 3)))
        record_event("health.door_state", state="draining", reason=reason)
        self._trace_state("draining", reason)

    def mark_stopped(self) -> None:
        with self._lock:
            if self._phase == "stopped":
                return
            self._phase = "stopped"
            self.transitions.append(("stopped", round(_time.time(), 3)))
        record_event("health.door_state", state="stopped")

    def _transition(self, to: str, allowed_from: tuple[str, ...]) -> None:
        with self._lock:
            if self._phase not in allowed_from:
                return
            self._phase = to
            self.transitions.append((to, round(_time.time(), 3)))
        record_event("health.door_state", state=to)
        self._trace_state(to, None)

    def _trace_state(self, state: str, reason: str | None) -> None:
        from pathway_tpu_torch import observability as _obs

        tracer = _obs.current()
        if tracer is not None:
            attrs = {"pathway.state": state}
            if reason:
                attrs["pathway.reason"] = reason
            tracer.event("health/door_state", attrs)

    def door_syncing(self, token: Any) -> None:
        """A replica/table resync started (fabric routing): demote the door
        until every live token drains."""
        with self._lock:
            fresh = not self._syncing
            self._syncing.add(token)
        if fresh:
            record_event("health.door_state", state="syncing")
            self._trace_state("syncing", str(token))

    def door_synced(self, token: Any) -> None:
        with self._lock:
            self._syncing.discard(token)
            drained = not self._syncing
        if drained and self.door_state() == "ready":
            record_event("health.door_state", state="ready")

    def quiescing(self) -> bool:
        """True while the pod drains to a rescale epoch or shutdown — the
        monitoring server answers /status and /metrics 503 in this window."""
        with self._lock:
            return self._phase in ("draining", "stopped")

    def drain_reason(self) -> str | None:
        with self._lock:
            return self._drain_reason

    def syncing_tokens(self) -> list[str]:
        with self._lock:
            return sorted(str(t) for t in self._syncing)

    # ------------------------------------------------------------ lifecycle
    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="pathway-health"
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
        self.mark_stopped()

    def _loop(self) -> None:
        now = _time.monotonic()
        next_canary = now + self.canary_interval_s if self.canary_interval_s else None
        next_eval = now + self.eval_interval_s
        while not self._stop.is_set():
            deadlines = [d for d in (next_canary, next_eval) if d is not None]
            wait = max(0.01, min(deadlines) - _time.monotonic())
            if self._stop.wait(wait):
                return
            now = _time.monotonic()
            if next_canary is not None and now >= next_canary:
                next_canary = now + self.canary_interval_s
                try:
                    self._probe_once()
                except Exception:
                    pass  # canaries must never kill the plane
            if now >= next_eval:
                next_eval = now + self.eval_interval_s
                try:
                    self.evaluate()
                except Exception:
                    pass

    # -------------------------------------------------------------- canary
    def _probe_targets(self) -> list[tuple[str, int, str, str]]:
        """(host, port, route, method) for every live door route this runtime
        serves."""
        from pathway_tpu_torch.io.http import _server as _srv

        targets = []
        for ws in list(_srv._WEBSERVERS):
            if ws._thread is None:
                continue
            host = ws.host if ws.host not in ("0.0.0.0", "::", "") else "127.0.0.1"
            for route, methods, _h, meta in ws._routes:
                st = (meta or {}).get("serving")
                if st is None or st.closed:
                    continue
                if self.runtime is not None and st.runtime is not self.runtime:
                    continue
                targets.append((host, ws.port, route, (methods or ["GET"])[0]))
        return targets

    def _probe_once(self) -> None:
        for host, port, route, method in self._probe_targets():
            self.probe_route(host, port, route, method)
        self._probe_fabric_links()

    def _probe_fabric_links(self) -> None:
        """Synthetic self-probe per fabric peer link on the canary cadence:
        a tiny ``canary`` request over the SAME transport real
        forwards use, recorded under the pseudo-route ``fabric:p<peer>`` so
        internal transport rot feeds the availability SLO and the
        heartbeat-flap detector instead of staying invisible until a real
        forward fails."""
        from pathway_tpu_torch import fabric as _fabric

        plane = _fabric.current()
        if plane is None or getattr(plane, "node", None) is None:
            return
        if self.runtime is not None and plane.runtime is not self.runtime:
            return
        for peer in range(plane.n_proc):
            if peer == plane.pid:
                continue
            route = f"fabric:p{peer}"
            t0 = _time.monotonic()
            ok = False
            try:
                reply = plane.node.call(
                    peer, "canary", {"from": plane.pid},
                    timeout=self.canary_timeout_s,
                )
                ok = bool(reply) and reply.get("ok") is True
            except Exception:
                ok = False
            took = _time.monotonic() - t0
            with self._lock:
                self.canary_total[route] = self.canary_total.get(route, 0) + 1
                if not ok:
                    self.canary_failed[route] = (
                        self.canary_failed.get(route, 0) + 1
                    )
                self.canary_last_s[route] = round(took, 6)

    def probe_route(self, host: str, port: int, route: str, method: str) -> bool:
        """One synthetic canary request against a local door. Canaries carry
        ``X-Pathway-Canary`` and short-circuit at the door handler — they
        never become query rows and never count in user-facing counters."""
        import urllib.error
        import urllib.request

        url = f"http://{host}:{port}{route}"
        data = None if method.upper() == "GET" else b"{}"
        req = urllib.request.Request(
            url,
            data=data,
            method=method.upper(),
            headers={
                "X-Pathway-Canary": "1",
                "Content-Type": "application/json",
            },
        )
        t0 = _time.monotonic()
        ok = False
        try:
            with urllib.request.urlopen(req, timeout=self.canary_timeout_s) as resp:
                ok = 200 <= resp.status < 300
        except urllib.error.HTTPError:
            ok = False  # 503 while syncing/draining: an honest failed canary
        except Exception:
            ok = False
        took = _time.monotonic() - t0
        with self._lock:
            self.canary_total[route] = self.canary_total.get(route, 0) + 1
            if not ok:
                self.canary_failed[route] = self.canary_failed.get(route, 0) + 1
            self.canary_last_s[route] = round(took, 6)
        return ok

    def canary_response(self, route: str) -> tuple[int, dict]:
        """The door-side answer to a tagged canary: door state, no engine
        work. 200 only when this door is truly ready."""
        st = self.door_state()
        return (200 if st == "ready" else 503), {
            "canary": True,
            "state": st,
            "route": route,
        }

    # ----------------------------------------------------------- SLO eval
    def _objectives(self) -> tuple[float | None, dict]:
        with _declared_lock:
            avail = _declared["availability"]
            p99 = dict(_declared["p99_ms"])
        if avail is None:
            avail = self.cfg.slo_availability
        if not p99 and self.cfg.slo_p99_ms > 0:
            p99 = {None: self.cfg.slo_p99_ms}
        return avail, p99

    def _sample(self) -> dict:
        from pathway_tpu_torch.io.http import _server as _srv
        from pathway_tpu_torch.internals.telemetry import resilience_summary

        routes: dict[str, dict] = {}
        for rs in list(_srv._ROUTES):
            if self.runtime is not None and rs.runtime is not self.runtime:
                continue
            routes[rs.route] = {
                "requests": rs.requests_total,
                "responses": rs.responses_total,
                "errors": rs.errors_total,
                "timeouts": rs.timeouts_total,
                "latency": rs.latency.snapshot(),
            }
        with self._lock:
            canary = {
                route: (
                    self.canary_total.get(route, 0),
                    self.canary_failed.get(route, 0),
                )
                for route in self.canary_total
            }
        return {
            "t": _time.monotonic(),
            "routes": routes,
            "canary": canary,
            "hb_misses": resilience_summary().get("heartbeat_misses", 0),
        }

    @staticmethod
    def _delta(new: dict, old: dict) -> dict:
        """Per-route counter/latency deltas between two samples, canaries
        folded in."""
        out: dict[str, dict] = {}
        for route, nc in new["routes"].items():
            oc = (old["routes"].get(route)) or {}
            o_lat = oc.get("latency") or {}
            n_lat = nc["latency"]
            o_counts = o_lat.get("counts") or [0] * len(n_lat["counts"])
            d = {
                k: nc[k] - (oc.get(k) or 0)
                for k in ("requests", "responses", "errors", "timeouts")
            }
            d["lat_counts"] = [
                n - o for n, o in zip(n_lat["counts"], o_counts)
            ]
            out[route] = d
        for route, (total, failed) in new["canary"].items():
            o_total, o_failed = old["canary"].get(route, (0, 0))
            d = out.setdefault(
                route,
                {
                    "requests": 0,
                    "responses": 0,
                    "errors": 0,
                    "timeouts": 0,
                    "lat_counts": [],
                },
            )
            d["canary"] = total - o_total
            d["canary_failed"] = failed - o_failed
        return out

    def _window_base(self, window_s: float, now: float) -> dict | None:
        """The newest sample at least ``window_s`` old (else the oldest one —
        early in a run the window is the run's age)."""
        base = None
        for s in self._samples:
            if s["t"] <= now - window_s:
                base = s
            else:
                break
        if base is None and self._samples:
            base = self._samples[0]
        return base

    def _window_burns(self, window_s: float) -> dict[str, float]:
        """slo key → burn rate over one window. Keys: ``availability`` and
        ``latency:<route>``."""
        if not self._samples:
            return {}
        newest = self._samples[-1]
        base = self._window_base(window_s, newest["t"])
        if base is None or base is newest:
            return {}
        deltas = self._delta(newest, base)
        avail_target, p99_targets = self._objectives()
        burns: dict[str, float] = {}
        # availability: successes (responses + canary ok) vs failures
        # (5xx-class errors, timeouts, failed canaries)
        ok = bad = 0
        for d in deltas.values():
            ok += d["responses"] + max(
                0, d.get("canary", 0) - d.get("canary_failed", 0)
            )
            bad += d["timeouts"] + d.get("canary_failed", 0)
        total = ok + bad
        if avail_target is not None and avail_target < 1.0 and total > 0:
            burns["availability"] = (bad / total) / (1.0 - avail_target)
        # latency: fraction of requests over the route's p99 objective vs the
        # 1% the objective allows
        from pathway_tpu_torch.observability.metrics import BUCKET_BOUNDS_S

        for route, d in deltas.items():
            target_ms = p99_targets.get(route, p99_targets.get(None))
            if not target_ms:
                continue
            counts = d["lat_counts"]
            total_lat = sum(counts)
            if total_lat <= 0:
                continue
            threshold_s = target_ms / 1000.0
            under = sum(
                c
                for bound, c in zip(BUCKET_BOUNDS_S, counts)
                if bound <= threshold_s
            )
            slow = total_lat - under
            burns[f"latency:{route}"] = (slow / total_lat) / 0.01
        return burns

    def evaluate(self) -> list[dict]:
        """One evaluator sweep: sample the planes, compute fast/slow burn
        rates, run the rule-based detectors, and sync the alert registry.
        Returns the breach list (tests call this directly)."""
        self._samples.append(self._sample())
        now = self._samples[-1]["t"]
        slow_w = max(self.cfg.slo_slow_window_s, self.cfg.slo_fast_window_s)
        while (
            len(self._samples) > 2 and self._samples[1]["t"] < now - slow_w - 1.0
        ):
            self._samples.popleft()
        fast = self._window_burns(self.cfg.slo_fast_window_s)
        slow = self._window_burns(slow_w)
        self.burn = {
            key: {"fast": round(fast.get(key, 0.0), 3), "slow": round(slow.get(key, 0.0), 3)}
            for key in set(fast) | set(slow)
        }
        avail_target, _p99 = self._objectives()
        for key, b in self.burn.items():
            # budget remaining after the slow window at the observed rate
            self.budget_remaining[key] = round(max(0.0, 1.0 - b["slow"]), 3)
        breaches: list[dict] = []
        for key, b in self.burn.items():
            # multi-window burn-rate LADDER: the page rung is the
            # SRE-workbook pair; the ticket rung catches a slower sustained
            # burn worth a work item, not a wake-up. Both need BOTH windows.
            page = (
                b["fast"] >= self.cfg.slo_burn_fast
                and b["slow"] >= self.cfg.slo_burn_slow
            )
            ticket = (
                b["fast"] >= self.cfg.slo_burn_ticket_fast
                and b["slow"] >= self.cfg.slo_burn_ticket_slow
            )
            if page or ticket:
                severity = "page" if page else "ticket"
                thresholds = (
                    f"{self.cfg.slo_burn_fast}/{self.cfg.slo_burn_slow}"
                    if page
                    else f"{self.cfg.slo_burn_ticket_fast}/{self.cfg.slo_burn_ticket_slow}"
                )
                slo, _, route = key.partition(":")
                breaches.append(
                    {
                        "alert": f"slo_{slo}_burn",
                        "fingerprint": route,
                        "severity": severity,
                        "summary": (
                            f"{key} burn rate fast={b['fast']} slow={b['slow']} "
                            f"({severity} thresholds {thresholds})"
                        ),
                        "labels": {"window_fast_s": self.cfg.slo_fast_window_s},
                        "probable_stage": self._probable_stage(),
                    }
                )
        breaches.extend(self._detectors())
        self.evals_total += 1
        if self.registry is not None:
            self.registry.sync(breaches, self.runtime)
            # coordinator-side pod bundles: fold per-process fragments
            # (riding the heartbeat health rollup) into ONE bundle per pod
            # per activation, pod timeline window attached
            if self.cfg.process_id == 0:
                from pathway_tpu_torch.observability import alerts as _alerts

                try:
                    _alerts.merge_pod_bundles(self.runtime, self.registry)
                except Exception:
                    pass
        return breaches

    def _probable_stage(self) -> str | None:
        """The stage with the worst p99 in the request plane's decomposition
        — the incident bundle's probable cause."""
        from pathway_tpu_torch.observability import requests as _req

        rp = _req.current() or _req.last()
        if rp is None:
            return None
        ranked = [
            (s, v.get("p99_s") or 0.0)
            for s, v in rp.stage_snapshot().items()
            if v.get("count")
        ]
        return max(ranked, key=lambda kv: kv[1])[0] if ranked else None

    # ----------------------------------------------------------- detectors
    def _detectors(self) -> list[dict]:
        breaches: list[dict] = []
        cfg = self.cfg
        scheduler = getattr(self.runtime, "scheduler", None)
        from pathway_tpu_torch.observability import metrics as _metrics

        # watermark stall: an input that ingested rows but whose watermark
        # stopped advancing
        try:
            for row in _metrics.input_watermarks(scheduler):
                lag = row.get("lag_s")
                if (
                    lag is not None
                    and lag > cfg.alert_watermark_stall_s
                    and row.get("rows_ingested")
                ):
                    breaches.append(
                        {
                            "alert": "watermark_stall",
                            "fingerprint": row["input"],
                            "summary": f"watermark {lag:.1f}s behind on {row['input']}",
                        }
                    )
        except Exception:
            pass
        # backlog growth: queued rows over the bound and rising across the
        # last three samples
        try:
            backlog = sum(
                g["rows"] for g in _metrics.backlog_gauges(scheduler)
            )
            recent = [s for s in list(self._samples)[-3:]]
            prev = recent[0].get("backlog") if recent else None
            if self._samples:
                self._samples[-1]["backlog"] = backlog
            if (
                backlog > cfg.alert_backlog_rows
                and prev is not None
                and backlog > prev
            ):
                breaches.append(
                    {
                        "alert": "backlog_growth",
                        "summary": f"{backlog} rows queued and growing",
                    }
                )
        except Exception:
            pass
        # error-rate spike: 4xx/timeouts vs requests over the fast window
        try:
            newest = self._samples[-1]
            base = self._window_base(cfg.slo_fast_window_s, newest["t"])
            if base is not None and base is not newest:
                for route, d in self._delta(newest, base).items():
                    reqs = d["requests"]
                    bad = d["errors"] + d["timeouts"]
                    if reqs >= 5 and bad / reqs > cfg.alert_error_rate:
                        breaches.append(
                            {
                                "alert": "error_rate_spike",
                                "fingerprint": route,
                                "summary": (
                                    f"{bad}/{reqs} requests failing on {route}"
                                ),
                            }
                        )
                # heartbeat flap: misses accumulating inside the window —
                # failed fabric link canaries count too: a peer whose
                # transport is rotting flaps the same way one whose
                # heartbeats are lost does
                flaps = newest["hb_misses"] - base.get("hb_misses", 0)
                link_failed = 0
                for route, (_total, failed) in newest.get("canary", {}).items():
                    if route.startswith("fabric:"):
                        _bt, bf = base.get("canary", {}).get(route, (0, 0))
                        link_failed += max(0, failed - bf)
                if flaps + link_failed >= cfg.alert_heartbeat_flaps:
                    breaches.append(
                        {
                            "alert": "heartbeat_flap",
                            "summary": (
                                f"{flaps} heartbeat misses"
                                + (
                                    f" + {link_failed} fabric link canary failures"
                                    if link_failed
                                    else ""
                                )
                                + " in the fast window"
                            ),
                        }
                    )
        except Exception:
            pass
        # replica-lag breach: a door serving beyond the staleness bound
        try:
            from pathway_tpu_torch.fabric import index_replica as _ir

            ri = _ir.heartbeat_summary(self.runtime, None) or {}
            bound_s = cfg.replica_max_staleness_ms / 1000.0
            for route, ent in ri.items():
                lag = ent.get("lag_s")
                if lag is not None and lag > bound_s:
                    breaches.append(
                        {
                            "alert": "replica_lag",
                            "fingerprint": route,
                            "summary": (
                                f"replica {lag:.3f}s behind on {route} "
                                f"(bound {bound_s:.3f}s)"
                            ),
                        }
                    )
        except Exception:
            pass
        # autoscaler thrash: membership version churning inside the slow window
        try:
            from pathway_tpu_torch import elastic as _elastic

            eplane = _elastic.current()
            if eplane is not None and eplane.membership is not None:
                now = _time.monotonic()
                v = eplane.membership.version
                if (
                    not self._membership_versions
                    or self._membership_versions[-1][1] != v
                ):
                    self._membership_versions.append((now, v))
                window = now - self.cfg.slo_slow_window_s
                changes = sum(
                    1 for t, _v in self._membership_versions if t >= window
                ) - 1
                if changes >= cfg.alert_thrash_decisions:
                    breaches.append(
                        {
                            "alert": "autoscaler_thrash",
                            "summary": (
                                f"{changes} membership changes in "
                                f"{self.cfg.slo_slow_window_s:.0f}s"
                            ),
                        }
                    )
        except Exception:
            pass
        # sink commit stall: a staged-but-unpublished delivery epoch whose age
        # exceeds the bound — the sink's transport keeps failing and exactly-
        # once output is piling up in the ledger
        try:
            from pathway_tpu_torch import delivery as _delivery

            plane = _delivery.plane_of(self.runtime)
            if plane is not None:
                now_unix = _time.time()
                for w in plane.writers:
                    oldest = w.oldest_unpublished_unix()
                    if oldest is None:
                        continue
                    age = now_unix - oldest
                    if age > cfg.alert_sink_stall_s:
                        breaches.append(
                            {
                                "alert": "sink_commit_stall",
                                "fingerprint": w.sink_id,
                                "summary": (
                                    f"sink {w.sink_id} has unpublished output "
                                    f"staged {age:.0f}s ago ({w.depth()} "
                                    f"epochs deep; last error: "
                                    f"{w.last_publish_error})"
                                ),
                            }
                        )
        except Exception:
            pass
        return breaches

    # ------------------------------------------------------------- readers
    def canary_snapshot(self) -> dict[str, dict]:
        with self._lock:
            return {
                route: {
                    "requests": self.canary_total.get(route, 0),
                    "failed": self.canary_failed.get(route, 0),
                    "last_s": self.canary_last_s.get(route),
                }
                for route in sorted(self.canary_total)
            }

    def slo_snapshot(self) -> dict[str, Any]:
        avail, p99 = self._objectives()
        return {
            "availability_target": avail,
            "p99_ms_targets": {str(k): v for k, v in p99.items()},
            "burn": dict(self.burn),
            "budget_remaining": dict(self.budget_remaining),
            "windows_s": {
                "fast": self.cfg.slo_fast_window_s,
                "slow": self.cfg.slo_slow_window_s,
            },
            "evals": self.evals_total,
        }

    def status(self) -> dict[str, Any]:
        out = {
            "state": self.door_state(),
            "since_unix": self.transitions[-1][1],
            "transitions": [
                {"state": s, "t_unix": t} for s, t in self.transitions[-8:]
            ],
            "syncing": self.syncing_tokens(),
            "drain_reason": self.drain_reason(),
            "canary": self.canary_snapshot(),
            "slo": self.slo_snapshot(),
        }
        if self.registry is not None:
            out["alerts"] = self.registry.status_summary()
        return out

    def heartbeat_summary(self) -> dict[str, Any]:
        with self._lock:
            canary_total = sum(self.canary_total.values())
            canary_failed = sum(self.canary_failed.values())
        out: dict[str, Any] = {
            "state": self.door_state(),
            "canary": canary_total,
            "canary_failed": canary_failed,
        }
        if self.registry is not None:
            out.update(self.registry.heartbeat_summary())
        return out

    def prometheus_lines(self) -> list[str]:
        from pathway_tpu_torch.internals.monitoring import escape_label_value

        lines = [
            "# HELP pathway_door_ready Door readiness (1 ready, 0 otherwise)",
            "# TYPE pathway_door_ready gauge",
            f"pathway_door_ready {1 if self.door_state() == 'ready' else 0}",
            f'# HELP pathway_door_state Door lifecycle phase (1 on the current phase)',
            "# TYPE pathway_door_state gauge",
        ]
        st = self.door_state()
        for phase in PHASES:
            lines.append(
                f'pathway_door_state{{state="{phase}"}} {1 if phase == st else 0}'
            )
        avail, p99 = self._objectives()
        lines.append("# HELP pathway_slo_target Declared service-level objective")
        lines.append("# TYPE pathway_slo_target gauge")
        if avail is not None:
            lines.append(f'pathway_slo_target{{slo="availability"}} {avail}')
        for route, ms in sorted(
            p99.items(), key=lambda kv: str(kv[0])
        ):
            label = f'slo="latency",route="{escape_label_value(str(route))}"'
            lines.append(f"pathway_slo_target{{{label}}} {ms / 1000.0}")
        lines.append(
            "# HELP pathway_slo_burn_rate Error-budget burn rate per objective and window"
        )
        lines.append("# TYPE pathway_slo_burn_rate gauge")
        for key, b in sorted(self.burn.items()):
            slo, _, route = key.partition(":")
            label = f'slo="{escape_label_value(slo)}"'
            if route:
                label += f',route="{escape_label_value(route)}"'
            for window in ("fast", "slow"):
                lines.append(
                    f'pathway_slo_burn_rate{{{label},window="{window}"}} {b[window]}'
                )
        lines.append(
            "# HELP pathway_slo_error_budget_remaining Error budget left over the slow window"
        )
        lines.append("# TYPE pathway_slo_error_budget_remaining gauge")
        for key, rem in sorted(self.budget_remaining.items()):
            slo, _, route = key.partition(":")
            label = f'slo="{escape_label_value(slo)}"'
            if route:
                label += f',route="{escape_label_value(route)}"'
            lines.append(f"pathway_slo_error_budget_remaining{{{label}}} {rem}")
        canary = self.canary_snapshot()
        lines.append(
            "# HELP pathway_canary_requests_total Synthetic canary probes sent per route"
        )
        lines.append("# TYPE pathway_canary_requests_total counter")
        for route, ent in canary.items():
            label = f'route="{escape_label_value(route)}"'
            lines.append(f"pathway_canary_requests_total{{{label}}} {ent['requests']}")
        lines.append(
            "# HELP pathway_canary_failures_total Failed canary probes per route"
        )
        lines.append("# TYPE pathway_canary_failures_total counter")
        for route, ent in canary.items():
            label = f'route="{escape_label_value(route)}"'
            lines.append(f"pathway_canary_failures_total{{{label}}} {ent['failed']}")
        lines.append(
            "# HELP pathway_canary_latency_seconds Latency of the last canary probe per route"
        )
        lines.append("# TYPE pathway_canary_latency_seconds gauge")
        for route, ent in canary.items():
            if ent["last_s"] is None:
                continue
            label = f'route="{escape_label_value(route)}"'
            lines.append(f"pathway_canary_latency_seconds{{{label}}} {ent['last_s']}")
        if self.registry is not None:
            lines.extend(self.registry.prometheus_lines())
        return lines


# ----------------------------------------------------------- door endpoints


def healthz_payload() -> tuple[int, dict]:
    """Liveness: 200 whenever the process can answer at all (including while
    syncing or draining — the door is alive, just not ready)."""
    plane = _plane
    if plane is None:
        return 200, {"alive": True, "health": "off"}
    st = plane.door_state()
    if st == "stopped":
        return 503, {"alive": False, "state": st}
    return 200, {"alive": True, "state": st}


def readyz_payload() -> tuple[int, dict, dict[str, str]]:
    """Readiness: 200 only when the door should receive traffic. Syncing and
    starting doors answer 503 with a short Retry-After (they will recover);
    draining/stopped doors advertise a longer one (this door is going away)."""
    plane = _plane
    if plane is None:
        return 200, {"ready": True, "health": "off"}, {}
    st = plane.door_state()
    if st == "ready":
        return 200, {"ready": True, "state": st}, {}
    doc: dict[str, Any] = {"ready": False, "state": st}
    if st == "syncing":
        doc["syncing"] = plane.syncing_tokens()
    reason = plane.drain_reason()
    if reason:
        doc["reason"] = reason
    retry = "5" if st in ("draining", "stopped") else "1"
    return 503, doc, {"Retry-After": retry}


# ------------------------------------------------------- module-level hooks
# Cheap no-ops when the plane is off: every call site pays one global read.

_plane: HealthPlane | None = None


def current() -> HealthPlane | None:
    return _plane


def mark_ready() -> None:
    if _plane is not None:
        _plane.mark_ready()


def mark_draining(reason: str) -> None:
    if _plane is not None:
        _plane.mark_draining(reason)


def mark_stopped() -> None:
    if _plane is not None:
        _plane.mark_stopped()


def door_syncing(token: Any) -> None:
    if _plane is not None:
        _plane.door_syncing(token)


def door_synced(token: Any) -> None:
    if _plane is not None:
        _plane.door_synced(token)


def quiescing() -> bool:
    return _plane is not None and _plane.quiescing()


def status(runtime: Any) -> dict | None:
    if _plane is None or (runtime is not None and _plane.runtime is not runtime):
        return None
    return _plane.status()


def prometheus_lines(runtime: Any) -> list[str]:
    if _plane is None or (runtime is not None and _plane.runtime is not runtime):
        return []
    return _plane.prometheus_lines()


def heartbeat_summary() -> dict | None:
    return _plane.heartbeat_summary() if _plane is not None else None


def install_from_env(runtime: Any = None) -> HealthPlane | None:
    """Install the health plane (``PATHWAY_HEALTH=on``, the default) — called
    from ``observability.install_from_env`` next to the other planes. The
    previous run's plane is stopped first."""
    global _plane
    from pathway_tpu_torch.internals.config import get_pathway_config
    from pathway_tpu_torch.observability import alerts as _alerts

    cfg = get_pathway_config()
    if _plane is not None:
        try:
            _plane.stop()
        except Exception:
            pass
        _plane = None
    if cfg.health != "on":
        _alerts.shutdown()
        return None
    registry = _alerts.install_from_env(runtime)
    _plane = HealthPlane(cfg, runtime)
    _plane.registry = registry
    _plane.start()
    return _plane


def shutdown() -> None:
    """Stop the evaluator thread and mark the door stopped. Never raises."""
    global _plane
    from pathway_tpu_torch.observability import alerts as _alerts

    plane = _plane
    _plane = None
    if plane is not None:
        try:
            plane.stop()
        except Exception:
            pass
    _alerts.shutdown()
