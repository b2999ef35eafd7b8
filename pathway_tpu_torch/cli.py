"""``pathway_tpu_torch`` command line: spawn, spawn-from-env, supervise,
scale, profile, explain, trace, top, timeline diff and replay.

Port of ``pathway_tpu/cli.py`` (reference role: ``python/pathway/cli.py``):
``spawn`` forks N processes of a user program with the ``PATHWAY_THREADS /
PATHWAY_PROCESSES / PATHWAY_PROCESS_ID / PATHWAY_FIRST_PORT`` env contract
consumed by ``parallel/cluster.py``; ``supervise`` runs it under the
resilience Supervisor (restarts, and relaunches at a new shape after an
elastic rescale); ``scale --to N`` requests that rescale; ``replay`` re-runs
a program against a recorded persistence log. Built on ``argparse`` with the
reference's commands, flags and exit codes (a usage error exits 2, a failed
request 1). Usage::

    python -m pathway_tpu_torch spawn --threads 2 --processes 2 python script.py
    python -m pathway_tpu_torch supervise -n 2 python script.py
    python -m pathway_tpu_torch scale --to 3 --storage ./state
    python -m pathway_tpu_torch replay --record-path ./rec --mode speedrun python script.py
"""

from __future__ import annotations

import argparse
import json as _json
import os
import signal
import subprocess
import sys
import urllib.parse
import urllib.request

from pathway_tpu_torch.internals.config import get_pathway_config

_PROG = "pathway_tpu_torch"


class UsageError(Exception):
    """A malformed command line: exit status 2, as ``click.UsageError``."""


class CommandError(Exception):
    """A command that could not do its work: exit status 1, as
    ``click.ClickException``."""


def _spawn_processes(env_base: dict[str, str], processes: int, args: list[str]) -> int:
    """Fork one subprocess per process id; forward SIGINT/SIGTERM; return the
    first non-zero exit code (killing the rest), else 0."""
    if not args:
        raise UsageError("no program given (e.g. `spawn -t 2 python script.py`)")
    procs: list[subprocess.Popen] = []
    for pid in range(processes):
        env = dict(env_base, PATHWAY_PROCESS_ID=str(pid))
        procs.append(subprocess.Popen(list(args), env=env))

    def forward(signum, frame):
        for p in procs:
            if p.poll() is None:
                p.send_signal(signum)

    old_int = signal.signal(signal.SIGINT, forward)
    old_term = signal.signal(signal.SIGTERM, forward)
    try:
        code = 0
        for p in procs:
            rc = p.wait()
            if rc != 0 and code == 0:
                code = rc
                for q in procs:
                    if q.poll() is None:
                        q.terminate()
        return code
    finally:
        signal.signal(signal.SIGINT, old_int)
        signal.signal(signal.SIGTERM, old_term)


def _monitoring_port(port: int | None) -> int:
    return port if port is not None else int(os.environ.get("PATHWAY_MONITORING_HTTP_PORT", "20000"))


def _fetch_json(host: str, port: int, path: str) -> dict:
    url = f"http://{host}:{port}{path}"
    try:
        body = urllib.request.urlopen(url, timeout=5).read().decode()
    except OSError as e:
        raise CommandError(
            f"cannot reach monitoring server at {host}:{port}: {e} "
            "(is the pipeline running with with_http_server=True?)"
        ) from e
    return _json.loads(body)


def _print_endpoint(host: str, port: int | None, path: str, qs: dict, what: str) -> None:
    """GET a monitoring endpoint, print its JSON, fail on ``ok: false``."""
    doc = _fetch_json(host, _monitoring_port(port), path + ("?" + urllib.parse.urlencode(qs) if qs else ""))
    print(_json.dumps(doc, indent=2))
    if doc.get("ok") is False:
        raise CommandError(doc.get("error", f"{what} request failed"))


# ------------------------------------------------------------------ commands
def cmd_spawn(a) -> int:
    """Run PROGRAM across THREADS x PROCESSES workers on this host."""
    import uuid

    env = dict(os.environ)
    env["PATHWAY_THREADS"] = str(a.threads)
    env["PATHWAY_PROCESSES"] = str(a.processes)
    env["PATHWAY_FIRST_PORT"] = str(a.first_port if a.first_port is not None else get_pathway_config().first_port)
    # one run id per launch: every process derives the SAME trace id from it,
    # so per-process tick spans (live + offline exports) stitch into one trace
    env.setdefault("PATHWAY_RUN_ID", uuid.uuid4().hex)
    if a.trace is not None:
        env["PATHWAY_TRACE"] = a.trace
    if a.trace_sample is not None:
        env["PATHWAY_TRACE_SAMPLE"] = str(a.trace_sample)
    if a.trace_file is not None:
        env["PATHWAY_TRACE_LIVE_FILE"] = a.trace_file
    if a.record:
        env["PATHWAY_PERSISTENT_STORAGE"] = a.record_path
        env["PATHWAY_RECORD"] = "1"
    return _spawn_processes(env, a.processes, a.program)


def cmd_spawn_from_env(a) -> int:
    """Like spawn, but topology comes from the current PATHWAY_* environment."""
    import uuid

    cfg = get_pathway_config()
    env = cfg.spawn_env(0)
    env.setdefault("PATHWAY_RUN_ID", uuid.uuid4().hex)  # shared trace id
    return _spawn_processes(env, cfg.processes, a.program)


def cmd_supervise(a) -> int:
    """Run PROGRAM under the resilience Supervisor: spawn the cluster, detect
    a failed process, relaunch from the last committed checkpoint epoch with
    bounded exponential backoff, and at the new shape after an elastic
    rescale (``resilience.Supervisor``)."""
    from pathway_tpu_torch.resilience import Supervisor, SupervisorGaveUp

    if not a.program:
        raise UsageError("no program given (e.g. `supervise -n 2 python script.py`)")
    try:
        result = Supervisor(
            list(a.program),
            threads=a.threads,
            processes=a.processes,
            first_port=a.first_port,
            max_restarts=a.max_restarts,
            backoff_s=a.backoff,
            log_dir=a.log_dir,
        ).run()
    except SupervisorGaveUp as e:
        raise CommandError(str(e)) from e
    if result.restarts:
        print(f"{_PROG} supervise: recovered after {result.restarts} restart(s)")
    return 0


def cmd_scale(a) -> int:
    """Request a live rescale of a running elastic cluster to TARGET
    processes (``PATHWAY_ELASTIC=manual`` or ``auto``). Default transport is
    the persistence backend: the request lands in ``elastic/scale_request``
    and the coordinator adopts it on its next tick-continuation barrier; the
    pod then quiesces to one final committed checkpoint epoch and its
    Supervisor relaunches it at the new shape, state resharded by key range.
    With ``--host``, the request goes to the coordinator's monitoring server
    ``/scale`` endpoint instead (no filesystem access needed)."""
    if a.target < 1:
        raise UsageError(f"--to must be >= 1, got {a.target}")
    if a.host is not None:
        _print_endpoint(a.host, a.port, "/scale", {"to": str(a.target)}, "scale")
        return 0
    storage = a.storage or get_pathway_config().persistent_storage
    if not storage:
        raise UsageError(
            "no persistence root: pass --storage or set PATHWAY_PERSISTENT_STORAGE "
            "(or use --host to reach a running coordinator)"
        )
    from pathway_tpu_torch.elastic import write_scale_request
    from pathway_tpu_torch.persistence.backends import FileBackend

    req = write_scale_request(FileBackend(storage), a.target, source="cli")
    print(
        f"scale request to {a.target} process(es) recorded at {storage!r} "
        f"(requested_unix {req['requested_unix']:.3f}); the coordinator "
        "adopts it within a tick"
    )
    return 0


def cmd_profile(a) -> int:
    """Arm a live ``torch.profiler`` capture window on a RUNNING pipeline via
    its monitoring server's ``/profile`` endpoint (a Chrome trace)."""
    qs = {}
    if not a.status:
        qs["ticks"] = str(a.ticks if a.ticks is not None else get_pathway_config().profile_ticks)
        if a.out_dir:
            qs["dir"] = a.out_dir
    _print_endpoint(a.host, a.port, "/profile", qs, "profile")
    return 0


def cmd_explain(a) -> int:
    """Ask a RUNNING pipeline why a sink row exists: walk the operator graph
    backward through the lineage rings (``/explain`` endpoint) and print the
    contributing input rows, operator path, and originating trace span ids.
    Requires ``PATHWAY_AUDIT`` on (the default) and ``with_http_server=True``."""
    qs = {}
    if a.sink:
        qs["sink"] = a.sink
    if a.key is not None:
        qs["key"] = a.key
    _print_endpoint(a.host, a.port, "/explain", qs, "explain")
    return 0


def cmd_trace(a) -> int:
    """Print one request's end-to-end flight path: per-stage latency
    decomposition + OTLP spans, from the request-trace plane's kept ring
    (``/request`` endpoint). Omit REQUEST_ID to list kept trace ids and the
    in-flight request table."""
    _print_endpoint(a.host, a.port, "/request", {"id": a.request_id} if a.request_id else {}, "trace")
    return 0


def _spark(values: list, width: int = 24) -> str:
    """One-line unicode sparkline of a numeric series (newest right)."""
    blocks = "▁▂▃▄▅▆▇█"
    vals = [v for v in values if isinstance(v, (int, float))][-width:]
    if not vals:
        return "-" * 4
    lo, hi = min(vals), max(vals)
    span = (hi - lo) or 1.0
    return "".join(blocks[int((v - lo) / span * (len(blocks) - 1))] for v in vals)


def render_top(status: dict, tl: dict) -> str:
    """One ``pathway_tpu_torch top`` frame from a /status + /timeline pair (pure —
    the live loop and the tests share it)."""

    def series(metric: str) -> list:
        return [p.get(metric) for p in tl.get("points") or () if p.get(metric) is not None]

    def last(metric: str, default=0):
        s = series(metric)
        return s[-1] if s else default

    lines = []
    procs = tl.get("procs") or []
    lines.append(
        f"pathway_tpu_torch top — proc {tl.get('proc')} of {len(procs) or 1} "
        f"reporting ({', '.join(procs)})"
    )
    lines.append(
        f"  qps {last('serve_qps'):>8.1f} {_spark(series('serve_qps'))}   "
        f"tick_rate {last('tick_rate'):>7.1f} {_spark(series('tick_rate'))}"
    )
    lines.append(
        f"  backlog {last('backlog_rows'):>6} {_spark(series('backlog_rows'))}   "
        f"wm_lag_s {last('watermark_lag_s', 0.0):>7.2f} "
        f"{_spark(series('watermark_lag_s'))}"
    )
    lines.append(
        f"  pressure {last('flow_pressure', 0.0):>5.2f} "
        f"{_spark(series('flow_pressure'))}   "
        f"shed/s {last('serve_shed_per_s', 0.0):>6.1f}   "
        f"timeouts/s {last('serve_timeouts_per_s', 0.0):>5.1f}"
    )
    metrics = tl.get("metrics") or []
    stages = sorted(m for m in metrics if m.startswith("stage_p99_s:"))
    if stages:
        lines.append("  p99 by stage:")
        for m in stages[:8]:
            lines.append(
                f"    {m.split(':', 1)[1]:<28} {last(m, 0.0) * 1e3:>8.1f} ms "
                f"{_spark(series(m))}"
            )
    phases = sorted(m for m in metrics if m.startswith("phase_ms:"))
    if phases:
        split = ", ".join(
            f"{m.split(':', 1)[1]}={last(m, 0.0):.0f}ms" for m in phases[:8]
        )
        lines.append(f"  tick split: {split}")
    health = status.get("health") or {}
    doors = (health.get("doors") or {}) if isinstance(health, dict) else {}
    alerts = health.get("alerts") if isinstance(health, dict) else None
    active = (alerts or {}).get("active") if isinstance(alerts, dict) else None
    state = health.get("door") or health.get("state")
    lines.append(
        f"  doors: {doors or state or 'n/a'}   "
        f"alerts: {[a.get('alert') for a in active] if active else 'none'}"
    )
    top = (status.get("bottleneck") or {}).get("top")
    if top:
        lines.append(
            f"  bound by: {top.get('cause')} (score {top.get('score')}) — "
            f"{top.get('verdict')}"
        )
        lines.append(f"  knob: {top.get('knob')}")
    else:
        lines.append("  bound by: (no bottleneck — idle or warming up)")
    return "\n".join(lines)


def cmd_top(a) -> int:
    """Live terminal view of a RUNNING pipeline: qps, p99 by stage, watermark
    lag, backlog, pod pressure, per-phase tick split, doors/alerts and the
    current bottleneck verdict — read purely from the monitoring server's
    ``/timeline`` + ``/status`` endpoints."""
    import time as _t

    port = _monitoring_port(a.port)
    qs = f"?proc={a.proc}" if a.proc else ""
    prev_lines = 0
    while True:
        status = _fetch_json(a.host, port, "/status")
        tl = _fetch_json(a.host, port, f"/timeline{qs}")
        if not tl.get("enabled", False):
            raise CommandError("timeline plane is off on the target (PATHWAY_TIMELINE=off)")
        frame = render_top(status, tl)
        if a.once:
            print(frame)
            return 0
        if prev_lines:
            # redraw in place: cursor up + clear to end (LiveDashboard idiom)
            sys.stdout.write(f"\x1b[{prev_lines}F\x1b[J")
        sys.stdout.write(frame + "\n")
        sys.stdout.flush()
        prev_lines = frame.count("\n") + 1
        _t.sleep(max(0.1, a.refresh))


def cmd_timeline_diff(a) -> int:
    """Cross-run comparison of two timeline segment directories: per-phase /
    per-stage mean cost in run A vs run B, worst regression first — names the
    PHASE that regressed, not just the number. Exits non-zero when B has no
    comparable series."""
    from pathway_tpu_torch.observability.timeline import diff_summary, read_segments

    for d in (a.dir_a, a.dir_b):
        if not os.path.isdir(d):
            raise UsageError(f"directory {d!r} does not exist")
    prefixes = tuple(a.prefixes or ("phase_ms:", "stage_p99_s:"))
    points_a = read_segments(a.dir_a)
    points_b = read_segments(a.dir_b)
    rows = diff_summary(points_a, points_b, prefixes=prefixes)
    if not rows:
        raise CommandError(
            f"no comparable series under {prefixes} in both directories "
            f"({len(points_a)} vs {len(points_b)} points read)"
        )
    print(f"{'metric':<40} {'A':>12} {'B':>12} {'Δ%':>8}")
    for r in rows[: max(1, a.limit)]:
        print(f"{r['metric']:<40} {r['a']:>12.4f} {r['b']:>12.4f} {r['regression_pct']:>+8.1f}")
    worst = rows[0]
    print(f"worst regression: {worst['metric']} ({worst['regression_pct']:+.1f}% vs run A)")
    return 0


def cmd_replay(a) -> int:
    """Re-run PROGRAM against inputs recorded by `spawn --record`."""
    env = dict(os.environ)
    env["PATHWAY_THREADS"] = str(a.threads)
    env["PATHWAY_PROCESSES"] = str(a.processes)
    env["PATHWAY_REPLAY_STORAGE"] = a.record_path
    env["PATHWAY_PERSISTENT_STORAGE"] = a.record_path
    env["PATHWAY_REPLAY_MODE"] = a.mode
    env["PATHWAY_CONTINUE_AFTER_REPLAY"] = "1" if a.continue_after_replay else "0"
    return _spawn_processes(env, a.processes, a.program)


# -------------------------------------------------------------------- parser
def _monitoring_args(p: argparse.ArgumentParser, host_default: str | None = "127.0.0.1") -> None:
    p.add_argument("--host", type=str, default=host_default, help="monitoring server host")
    p.add_argument("--port", type=int, default=None,
                   help="monitoring server port (default PATHWAY_MONITORING_HTTP_PORT, 20000)")


def _program(p: argparse.ArgumentParser) -> None:
    # everything after the options is the user program, its own flags included
    p.add_argument("program", nargs=argparse.REMAINDER, help="the program and its arguments")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog=_PROG, description="pathway_tpu_torch — streaming dataflow on the H100.")
    sub = parser.add_subparsers(dest="command", metavar="COMMAND")
    sub.required = True

    p = sub.add_parser("spawn", help=cmd_spawn.__doc__.splitlines()[0])
    p.add_argument("-t", "--threads", type=int, default=1, help="workers per process")
    p.add_argument("-n", "--processes", type=int, default=1, help="number of processes")
    p.add_argument("--first-port", type=int, default=None, help="base TCP port for the cluster plane")
    p.add_argument("--record", action="store_true", help="record inputs for later replay")
    p.add_argument("--record-path", type=str, default="./record", help="where recorded inputs live")
    p.add_argument("--trace", choices=["off", "on"], default=None, help="live span pipeline (PATHWAY_TRACE)")
    p.add_argument("--trace-sample", type=float, default=None, help="tick head-sampling rate (0, 1]")
    p.add_argument("--trace-file", type=str, default=None,
                   help="rotating OTLP-JSON live sink (per-process .pN suffix)")
    _program(p)
    p.set_defaults(fn=cmd_spawn)

    p = sub.add_parser("spawn-from-env", help=cmd_spawn_from_env.__doc__.splitlines()[0])
    _program(p)
    p.set_defaults(fn=cmd_spawn_from_env)

    p = sub.add_parser("supervise", help="Run PROGRAM under the resilience Supervisor.")
    p.add_argument("-t", "--threads", type=int, default=None, help="workers per process")
    p.add_argument("-n", "--processes", type=int, default=None, help="number of processes")
    p.add_argument("--first-port", type=int, default=None, help="base TCP port for the cluster plane")
    p.add_argument("--max-restarts", type=int, default=None, help="restart budget on failure")
    p.add_argument("--backoff", type=float, default=None, help="base restart backoff seconds")
    p.add_argument("--log-dir", type=str, default=None, help="capture child output per attempt")
    _program(p)
    p.set_defaults(fn=cmd_supervise)

    p = sub.add_parser("scale", help="Request a live rescale of a running elastic cluster.")
    p.add_argument("--to", dest="target", type=int, required=True, help="target process count")
    p.add_argument("--storage", type=str, default=None,
                   help="persistence root holding the cluster's membership table "
                        "(default PATHWAY_PERSISTENT_STORAGE)")
    _monitoring_args(p, host_default=None)
    p.set_defaults(fn=cmd_scale)

    p = sub.add_parser("profile", help="Arm a live profiler capture window on a running pipeline.")
    _monitoring_args(p)
    p.add_argument("--ticks", type=int, default=None, help="capture window length in ticks")
    p.add_argument("--dir", dest="out_dir", type=str, default=None,
                   help="capture output directory (default PATHWAY_PROFILE_DIR of the target run)")
    p.add_argument("--status", action="store_true", help="report the current window instead of arming one")
    p.set_defaults(fn=cmd_profile)

    p = sub.add_parser("explain", help="Ask a running pipeline why a sink row exists.")
    _monitoring_args(p)
    p.add_argument("--sink", type=str, default=None, help="sink label, e.g. subscribe:7 (omit to list sinks)")
    p.add_argument("--key", type=str, default=None, help="output row key (decimal or 0x-hex)")
    p.set_defaults(fn=cmd_explain)

    p = sub.add_parser("trace", help="Print one request's end-to-end flight path.")
    p.add_argument("request_id", nargs="?", default=None)
    _monitoring_args(p)
    p.set_defaults(fn=cmd_trace)

    p = sub.add_parser("top", help="Live terminal view of a running pipeline.")
    _monitoring_args(p)
    p.add_argument("--proc", type=str, default=None, help="process id, or 'pod' for the merged rollup")
    p.add_argument("--refresh", type=float, default=1.0, help="seconds between frames")
    p.add_argument("--once", action="store_true", help="print one frame and exit (no ANSI redraw)")
    p.set_defaults(fn=cmd_top)

    p = sub.add_parser("timeline", help="Inspect spilled timeline segment directories.")
    tsub = p.add_subparsers(dest="timeline_command", metavar="COMMAND")
    tsub.required = True
    d = tsub.add_parser("diff", help="Compare two timeline segment directories.")
    d.add_argument("dir_a")
    d.add_argument("dir_b")
    d.add_argument("--prefix", dest="prefixes", action="append", default=None,
                   help="metric prefixes to compare (repeatable; default phase_ms: and stage_p99_s:)")
    d.add_argument("--limit", type=int, default=12, help="rows to print")
    d.set_defaults(fn=cmd_timeline_diff)

    p = sub.add_parser("replay", help=cmd_replay.__doc__.splitlines()[0])
    p.add_argument("--record-path", type=str, default="./record", help="recorded persistence root")
    p.add_argument("--mode", choices=["batch", "speedrun", "realtime"], default="speedrun",
                   help="replay pacing: batch/speedrun = as fast as possible, realtime = original pacing")
    p.add_argument("-t", "--threads", type=int, default=1)
    p.add_argument("-n", "--processes", type=int, default=1)
    p.add_argument("--continue-after-replay", dest="continue_after_replay", action="store_true", default=False,
                   help="after replaying the recording, keep consuming live sources")
    p.add_argument("--no-continue-after-replay", dest="continue_after_replay", action="store_false")
    _program(p)
    p.set_defaults(fn=cmd_replay)
    return parser


def main(argv: list[str] | None = None) -> int:
    """Run one command; returns its exit status (``python -m
    pathway_tpu_torch`` exits with it)."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if getattr(args, "program", None) and args.program[0] == "--":
        args.program = args.program[1:]  # ``supervise -n 2 -- python x.py``
    try:
        return int(args.fn(args) or 0)
    except UsageError as e:
        parser.print_usage(sys.stderr)
        print(f"{_PROG}: error: {e}", file=sys.stderr)
        return 2
    except CommandError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
