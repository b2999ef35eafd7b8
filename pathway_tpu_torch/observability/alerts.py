"""Alert registry, notification sinks, incident bundles.

The health plane's detectors (``observability/health.py``) and the
recompile-storm tripwire (``observability/device.py``) all converge here: one
process-wide :class:`AlertRegistry` that deduplicates on
``(alert, fingerprint)``, exposes the active set on ``/alerts`` and as
``pathway_alert_active{alert=…}`` gauges, emits ``alert/fired`` /
``alert/resolved`` trace events, pushes every NEW activation through the
configured notification sinks (Slack, generic webhook — bounded retry +
backoff, deduped), and captures ONE correlated incident bundle per activation
to ``PATHWAY_INCIDENT_DIR``.

Installed only when ``PATHWAY_HEALTH=on`` (the health plane installs it first
so detectors can fire into it); ``current()`` is None otherwise and every call
site pays one ``is None`` test.

Carried from ``pathway_tpu/observability/alerts.py`` with imports rewritten.
The Slack sink needs ``io.slack``, which the port has not carried: asking for
it (``PATHWAY_ALERT_SLACK_CHANNEL`` and ``_TOKEN``) raises ``later_slice``.
Bundles leave out the shard map, membership, replica and timeline sections,
whose planes the port does not have yet.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time as _time
from collections import deque
from typing import Any, Callable

from pathway_tpu_torch.internals.telemetry import record_event

#: activations remembered after resolution (the /alerts history section)
_HISTORY_MAX = 256


def _sanitize(s: str) -> str:
    return re.sub(r"[^A-Za-z0-9._-]+", "_", s)[:80] or "none"


#: burn-rate ladder order: a refresh may escalate severity, never demote it
_SEVERITY_RANK = {"info": 0, "warn": 1, "ticket": 2, "page": 3}


# ------------------------------------------------------------------- sinks


class NotificationSink:
    """Base notification sink: dedupe on ``(alert, fingerprint)`` + bounded
    retry with doubling backoff. Subclasses implement :meth:`_post`; tests
    inject ``transport`` (a callable receiving the payload dict) and stub
    ``_sleep`` to prove dedupe/backoff without network."""

    name = "sink"

    def __init__(
        self,
        *,
        max_retries: int = 3,
        backoff_s: float = 0.2,
        transport: Callable[[dict], Any] | None = None,
    ):
        self.max_retries = max_retries
        self.backoff_s = backoff_s
        self.transport = transport
        self._sleep = _time.sleep
        self._sent_keys: set[tuple[str, str]] = set()
        self.sent_total = 0
        self.deduped_total = 0
        self.retries_total = 0
        self.failed_total = 0

    def _post(self, payload: dict) -> None:  # pragma: no cover - overridden
        raise NotImplementedError

    def notify(self, alert: dict) -> bool:
        """Deliver one fired alert. Returns True when the payload reached the
        transport (possibly after retries); a duplicate ``(alert,
        fingerprint)`` is dropped without touching the network."""
        key = (alert.get("alert", ""), alert.get("fingerprint", ""))
        if key in self._sent_keys:
            self.deduped_total += 1
            return False
        payload = dict(alert)
        delay = self.backoff_s
        for attempt in range(1 + self.max_retries):
            try:
                if self.transport is not None:
                    self.transport(payload)
                else:
                    self._post(payload)
                self._sent_keys.add(key)
                self.sent_total += 1
                return True
            except Exception:
                if attempt == self.max_retries:
                    self.failed_total += 1
                    record_event(
                        "health.sink_delivery_failed",
                        sink=self.name,
                        alert=str(key[0]),
                        attempts=attempt + 1,
                    )
                    return False
                self.retries_total += 1
                self._sleep(delay)
                delay *= 2.0

    def counters(self) -> dict[str, int]:
        return {
            "sent": self.sent_total,
            "deduped": self.deduped_total,
            "retries": self.retries_total,
            "failed": self.failed_total,
        }


class WebhookSink(NotificationSink):
    """Generic JSON webhook target (``PATHWAY_ALERT_WEBHOOK``)."""

    name = "webhook"

    def __init__(self, url: str, **kw: Any):
        super().__init__(**kw)
        self.url = url

    def _post(self, payload: dict) -> None:
        import urllib.request

        req = urllib.request.Request(
            self.url,
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        urllib.request.urlopen(req, timeout=5).close()


class SlackSink(NotificationSink):
    """Posts fired alerts to a Slack channel through the same
    ``chat.postMessage`` helper ``pw.io.slack.send_alerts`` uses."""

    name = "slack"

    def __init__(self, channel: str, token: str, **kw: Any):
        from pathway_tpu_torch.internals.later_slice import later_slice

        raise later_slice("io.slack")


# ---------------------------------------------------------------- registry


class AlertRegistry:
    """Process-wide alert state: active set keyed on ``(alert, fingerprint)``,
    per-alert fired counters, notification fan-out and one incident bundle per
    activation. Detector-managed (``auto=True``) alerts are resolved by
    :meth:`sync` when their condition clears; externally-fired alerts (e.g.
    the recompile-storm tripwire) stay active for the run."""

    def __init__(self, cfg):
        self.cfg = cfg
        self._lock = threading.Lock()
        self.active: dict[tuple[str, str], dict] = {}
        self.history: deque = deque(maxlen=_HISTORY_MAX)
        self.fired_total: dict[str, int] = {}
        self.bundles_written = 0
        self.bundle_paths: list[str] = []
        self.sinks: list[NotificationSink] = []
        #: recent activations as compact fragments — ride the heartbeat so
        #: the coordinator can merge one POD bundle per activation
        self.fragments: deque = deque(maxlen=32)

    # ------------------------------------------------------------ lifecycle
    @staticmethod
    def sinks_from_env(cfg) -> list[NotificationSink]:
        sinks: list[NotificationSink] = []
        if cfg.alert_webhook:
            sinks.append(WebhookSink(cfg.alert_webhook))
        if cfg.alert_slack_channel and cfg.alert_slack_token:
            sinks.append(SlackSink(cfg.alert_slack_channel, cfg.alert_slack_token))
        return sinks

    # ----------------------------------------------------------------- fire
    def fire(
        self,
        name: str,
        *,
        fingerprint: str = "",
        severity: str = "warn",
        summary: str = "",
        labels: dict | None = None,
        probable_stage: str | None = None,
        auto: bool = True,
        runtime: Any = None,
    ) -> dict:
        """Raise (or refresh) one alert. The inactive→active transition emits
        the trace event, notifies sinks and captures the incident bundle; a
        refresh only bumps ``last_seen``/``count``."""
        key = (name, fingerprint)
        now = _time.time()
        with self._lock:
            ent = self.active.get(key)
            if ent is not None:
                ent["count"] += 1
                ent["last_seen_unix"] = round(now, 3)
                if probable_stage and not ent.get("probable_stage"):
                    ent["probable_stage"] = probable_stage
                # ladder escalation: a ticket-severity burn crossing the page
                # thresholds upgrades in place (never downgrades — the page
                # stays a page until the breach resolves)
                if _SEVERITY_RANK.get(severity, 0) > _SEVERITY_RANK.get(
                    ent.get("severity", "warn"), 0
                ):
                    ent["severity"] = severity
                return ent
            ent = {
                "alert": name,
                "fingerprint": fingerprint,
                "severity": severity,
                "summary": summary,
                "labels": labels or {},
                "probable_stage": probable_stage,
                "fired_unix": round(now, 3),
                "last_seen_unix": round(now, 3),
                "count": 1,
                "auto": auto,
            }
            self.active[key] = ent
            self.fired_total[name] = self.fired_total.get(name, 0) + 1
        record_event(
            "health.alert_fired",
            alert=name,
            fingerprint=fingerprint,
            severity=severity,
        )
        from pathway_tpu_torch import observability as _obs

        tracer = _obs.current()
        if tracer is not None:
            tracer.event(
                "alert/fired",
                {
                    "pathway.alert": name,
                    "pathway.fingerprint": fingerprint,
                    "pathway.severity": severity,
                    "pathway.summary": summary,
                },
            )
        for sink in self.sinks:
            try:
                sink.notify(ent)
            except Exception:
                pass  # delivery failures are counted, never propagate
        self._capture_bundle(ent, runtime)
        with self._lock:
            self.fragments.append(
                {
                    "alert": name,
                    "fingerprint": fingerprint,
                    "severity": ent.get("severity", severity),
                    "summary": summary,
                    "fired_unix": ent["fired_unix"],
                    "bundle": ent.get("bundle"),
                    "process_id": self.cfg.process_id,
                }
            )
        return ent

    def resolve(self, name: str, fingerprint: str = "") -> bool:
        with self._lock:
            ent = self.active.pop((name, fingerprint), None)
            if ent is None:
                return False
            ent["resolved_unix"] = round(_time.time(), 3)
            self.history.append(ent)
        from pathway_tpu_torch import observability as _obs

        tracer = _obs.current()
        if tracer is not None:
            tracer.event(
                "alert/resolved",
                {"pathway.alert": name, "pathway.fingerprint": fingerprint},
            )
        return True

    def sync(self, breaches: list[dict], runtime: Any = None) -> None:
        """One detector sweep: ``breaches`` is the currently-true condition
        set. New entries fire, existing refresh, and detector-managed active
        alerts whose condition cleared resolve."""
        seen = set()
        for b in breaches:
            key = (b["alert"], b.get("fingerprint", ""))
            seen.add(key)
            self.fire(
                b["alert"],
                fingerprint=b.get("fingerprint", ""),
                severity=b.get("severity", "warn"),
                summary=b.get("summary", ""),
                labels=b.get("labels"),
                probable_stage=b.get("probable_stage"),
                runtime=runtime,
            )
        with self._lock:
            stale = [
                k
                for k, ent in self.active.items()
                if ent.get("auto") and k not in seen
            ]
        for name, fp in stale:
            self.resolve(name, fp)

    # ------------------------------------------------------------- readers
    def active_alerts(self) -> list[dict]:
        with self._lock:
            return sorted(
                (dict(e) for e in self.active.values()),
                key=lambda e: (e["alert"], e["fingerprint"]),
            )

    def status_summary(self) -> dict[str, Any]:
        with self._lock:
            history = list(self.history)[-16:]
            fired = dict(self.fired_total)
        return {
            "active": self.active_alerts(),
            "recent_resolved": history,
            "fired_total": fired,
            "bundles_written": self.bundles_written,
            "sinks": {s.name: s.counters() for s in self.sinks},
        }

    def heartbeat_summary(self) -> dict[str, Any]:
        with self._lock:
            active = sorted(
                f"{n}:{fp}" if fp else n for (n, fp) in self.active
            )
            fired = sum(self.fired_total.values())
            fragments = list(self.fragments)
        return {"active": active, "fired": fired, "fragments": fragments}

    def prometheus_lines(self) -> list[str]:
        from pathway_tpu_torch.internals.monitoring import escape_label_value

        lines = [
            "# HELP pathway_alert_active Alert currently firing (1 per active alert)",
            "# TYPE pathway_alert_active gauge",
        ]
        for ent in self.active_alerts():
            label = (
                f'alert="{escape_label_value(ent["alert"])}"'
                f',fingerprint="{escape_label_value(ent["fingerprint"])}"'
            )
            lines.append(f"pathway_alert_active{{{label}}} 1")
        lines.append(
            "# HELP pathway_alerts_fired_total Alert activations since run start"
        )
        lines.append("# TYPE pathway_alerts_fired_total counter")
        with self._lock:
            fired = sorted(self.fired_total.items())
        for name, n in fired:
            lines.append(
                f'pathway_alerts_fired_total{{alert="{escape_label_value(name)}"}} {n}'
            )
        return lines

    # ------------------------------------------------------------- bundles
    def _capture_bundle(self, ent: dict, runtime: Any) -> None:
        out_dir = self.cfg.incident_dir
        if not out_dir:
            return
        try:
            path = write_incident_bundle(ent, runtime, out_dir)
        except Exception:
            return  # a failed capture must never break the eval loop
        if path is not None:
            with self._lock:
                self.bundles_written += 1
                self.bundle_paths.append(path)
            ent["bundle"] = path
            record_event(
                "health.incident_bundle", alert=ent["alert"], path=path
            )


def write_incident_bundle(alert: dict, runtime: Any, out_dir: str) -> str | None:
    """One correlated post-mortem JSON: the alert, the probable-cause stage,
    the per-stage p99 decomposition, the slowest kept request traces, the
    device flight-recorder rings and the serving counters — everything the
    on-call needs in one file."""
    from pathway_tpu_torch.internals.config import get_pathway_config
    from pathway_tpu_torch.observability import device as _device
    from pathway_tpu_torch.observability import requests as _req

    cfg = get_pathway_config()
    os.makedirs(out_dir, exist_ok=True)
    doc: dict[str, Any] = {
        "kind": "pathway_incident_bundle",
        "captured_unix": round(_time.time(), 3),
        "process_id": cfg.process_id,
        "alert": {k: v for k, v in alert.items() if k != "auto"},
    }
    rp = _req.current() or _req.last()
    probable = alert.get("probable_stage")
    if rp is not None:
        stages = rp.stage_snapshot()
        doc["stage_p99_s"] = stages
        if probable is None and stages:
            ranked = [
                (s, v.get("p99_s") or 0.0)
                for s, v in stages.items()
                if v.get("count")
            ]
            if ranked:
                probable = max(ranked, key=lambda kv: kv[1])[0]
        doc["slowest_requests"] = rp.slowest_exemplars()[:8]
        doc["request_traces"] = [
            rp.get_trace(rid) for rid in rp.kept_ids()[-4:]
        ]
        doc["requests"] = rp.status_summary()
    doc["probable_cause_stage"] = probable
    alert["probable_stage"] = probable
    doc["flight"] = _device.flight_snapshot()
    try:
        from pathway_tpu_torch.io.http import _server as _srv

        doc["serving"] = _srv.serving_status(runtime)
    except Exception:
        pass
    path = os.path.join(
        out_dir,
        f"incident-{_sanitize(alert['alert'])}-"
        f"{_sanitize(alert.get('fingerprint') or 'pod')}-"
        f"{_sanitize(alert.get('severity') or 'warn')}-"
        f"p{cfg.process_id}-{_time.time_ns()}.json",
    )
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, default=str)
    return path


# ------------------------------------------------------- pod bundle merging

#: (alert, fingerprint, activation-second) keys already merged into a pod
#: bundle — one bundle per pod per activation however many evals see it
_pod_bundled: set[tuple] = set()


def merge_pod_bundles(runtime, registry: AlertRegistry | None) -> list[str]:
    """Coordinator-side satellite: fold per-process bundle FRAGMENTS (riding
    the heartbeat health rollup) into one pod-level incident bundle per
    activation. Dedupes across evaluator sweeps; returns the paths written
    this call."""
    if registry is None:
        return []
    out_dir = registry.cfg.incident_dir
    if not out_dir:
        return []
    fragments: list[dict] = []
    with registry._lock:
        fragments.extend(dict(f) for f in registry.fragments)
    monitor = getattr(runtime, "hb_monitor", None)
    if monitor is not None and hasattr(monitor, "peer_summaries"):
        for pid, summary in monitor.peer_summaries().items():
            h = (summary or {}).get("health") or {}
            for f in h.get("fragments") or ():
                if isinstance(f, dict):
                    fragments.append(dict(f))
    if not fragments:
        return []
    # one activation = one (alert, fingerprint) burst; processes fire within
    # an eval cadence of each other, so second granularity separates bursts
    groups: dict[tuple, list[dict]] = {}
    for f in fragments:
        key = (f.get("alert") or "", f.get("fingerprint") or "")
        groups.setdefault(key, []).append(f)
    written: list[str] = []
    for (name, fp), frs in sorted(groups.items()):
        first = min(f.get("fired_unix") or 0 for f in frs)
        dedupe = (name, fp, int(first))
        if dedupe in _pod_bundled:
            continue
        _pod_bundled.add(dedupe)
        severity = max(
            (f.get("severity") or "warn" for f in frs),
            key=lambda s: _SEVERITY_RANK.get(s, 0),
        )
        doc: dict[str, Any] = {
            "kind": "pathway_pod_incident_bundle",
            "captured_unix": round(_time.time(), 3),
            "alert": name,
            "fingerprint": fp,
            "severity": severity,
            "first_fired_unix": round(first, 3),
            "processes": sorted({f.get("process_id") for f in frs}),
            "fragments": sorted(
                frs, key=lambda f: (f.get("process_id") or 0, f.get("fired_unix") or 0)
            ),
        }
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(
            out_dir,
            f"pod-incident-{_sanitize(name)}-{_sanitize(fp or 'pod')}-"
            f"{_sanitize(severity)}-{_time.time_ns()}.json",
        )
        try:
            with open(path, "w", encoding="utf-8") as fh:
                json.dump(doc, fh, default=str)
        except OSError:
            continue
        written.append(path)
        record_event("health.pod_incident_bundle", alert=name, path=path)
    return written


# ----------------------------------------------------------- run lifecycle

_registry: AlertRegistry | None = None


def current() -> AlertRegistry | None:
    """The installed alert registry, or None when the health plane is off."""
    return _registry


def install_from_env(runtime: Any = None) -> AlertRegistry | None:
    global _registry
    from pathway_tpu_torch.internals.config import get_pathway_config

    cfg = get_pathway_config()
    _pod_bundled.clear()
    if cfg.health != "on":
        _registry = None
        return None
    _registry = AlertRegistry(cfg)
    _registry.sinks = AlertRegistry.sinks_from_env(cfg)
    return _registry


def shutdown() -> None:
    global _registry
    _registry = None
