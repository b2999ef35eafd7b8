"""Multi-process cluster helpers for the ``tests/test_torch_*`` files.

The pipelines a cluster test runs are written once as functions of the
package (``PIPELINES``): the test runs the port's in a ``PATHWAY_PROCESSES``
cluster of subprocesses (``python tests/torch_cluster_helpers.py <pipeline>
<out>``) and either package's in-process for a single-process baseline.

Ports cannot collide under ``pytest -n 6 --dist loadfile``:

- each xdist worker takes its own range of ``_RANGE`` ports, at
  ``21000 + _RANGE * (worker index mod 6)`` (``PYTEST_XDIST_WORKER``): below
  the kernel's ephemeral ports (32768 and up), above the fixed monitoring
  ports the reference's tests use (20xxx) and below the bases the reference's
  cluster tests probe upward from (23000 and up);
- a launch takes the next base in its range and first checks that every port
  the cluster binds is free: the coordinator ``first_port``, each process's
  block link ``first_port + 1 + pid`` and the heartbeat monitor
  ``first_port + processes + 1``;
- a launch whose process reports ``EADDRINUSE`` is relaunched once, on the
  next base;
- every subprocess wait has its own timeout, after which the whole cluster
  is killed and the captured output raised.
"""

from __future__ import annotations

import itertools
import os
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.dirname(os.path.abspath(__file__))

_RANGE = 300
#: ports a launch may use past its base (coordinator, links, heartbeat)
_STRIDE = 12
_next = itertools.count()


def _worker_index() -> int:
    name = os.environ.get("PYTEST_XDIST_WORKER", "gw0")
    digits = "".join(ch for ch in name if ch.isdigit())
    return int(digits or 0) % 6


def cluster_ports(processes: int) -> list[int]:
    """Every port a ``processes``-wide cluster at base ``first_port`` binds."""
    return [0, *(1 + p for p in range(processes)), processes + 1]


def _free(ports: list[int]) -> bool:
    socks = []
    try:
        for p in ports:
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            # the cluster's servers bind with SO_REUSEADDR: a port in
            # TIME_WAIT is usable, a listening one is not
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind(("127.0.0.1", p))
            socks.append(s)
        return True
    except OSError:
        return False
    finally:
        for s in socks:
            s.close()


def first_port(processes: int, span: int = 0) -> int:
    """A base in this worker's range whose cluster ports are all free now
    (and, with ``span``, every port of ``[base, base + span)``)."""
    start = 21000 + _RANGE * _worker_index()
    slots = _RANGE // _STRIDE
    for _ in range(slots):
        base = start + _STRIDE * (next(_next) % slots)
        offsets = set(cluster_ports(processes)) | set(range(span))
        if _free([base + off for off in sorted(offsets)]):
            return base
    raise RuntimeError(f"no free cluster ports in [{start}, {start + _RANGE})")


def _env(processes: int, threads: int, extra: dict | None) -> dict:
    env = dict(os.environ)
    env.update(
        PATHWAY_PROCESSES=str(processes),
        PATHWAY_THREADS=str(threads),
        PATHWAY_BARRIER_TIMEOUT="45",
        PYTHONPATH=os.pathsep.join([REPO, TESTS]),
    )
    env.pop("PYTEST_XDIST_WORKER", None)
    env.update(extra or {})
    return env


def _addr_in_use(text: str) -> bool:
    return "Address already in use" in text or "EADDRINUSE" in text


def launch(argv_of, processes: int, threads: int = 1, env: dict | None = None, timeout: float = 120):
    """Run ``argv_of(pid)`` as a ``processes``-wide cluster; returns each
    process's (return code, output). Relaunches once on ``EADDRINUSE``."""
    for attempt in range(2):
        base_env = _env(processes, threads, env)
        if processes > 1:
            base_env["PATHWAY_FIRST_PORT"] = str(first_port(processes))
        procs = [
            subprocess.Popen(
                argv_of(pid),
                env=dict(base_env, PATHWAY_PROCESS_ID=str(pid)),
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
            )
            for pid in range(processes)
        ]
        results = []
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                out, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
                results.append((p.returncode, out))
        except subprocess.TimeoutExpired:
            texts = []
            for q in procs:
                q.kill()
                out, _ = q.communicate(timeout=30)
                texts.append(out or "")
            raise AssertionError("cluster process hung; captured output:\n" + "\n---\n".join(texts))
        if attempt == 0 and any(rc != 0 and _addr_in_use(out) for rc, out in results):
            continue
        return results
    return results


def run_cluster(pipeline: str, out: str, *, processes: int, threads: int = 1,
                env: dict | None = None, timeout: float = 120) -> list[str]:
    """Run the port's ``PIPELINES[pipeline]`` on a cluster; every process
    must exit 0. Returns each process's output."""
    results = launch(
        lambda pid: [sys.executable, os.path.abspath(__file__), pipeline, out],
        processes, threads, env, timeout,
    )
    for rc, text in results:
        assert rc == 0, f"process exited {rc}:\n{text}"
    return [text for _rc, text in results]


def run_in_process(pw, pipeline: str, out: str) -> None:
    """Run ``PIPELINES[pipeline]`` on ``pw`` in this process (one worker)."""
    pw.G.clear()
    try:
        PIPELINES[pipeline](pw, out)
    finally:
        pw.G.clear()


def read(path: str) -> str:
    with open(path) as fh:
        return fh.read()


def net(path: str) -> dict:
    """Net multiplicity per row of a csv sink (the columns other than
    ``time`` and ``diff``, alphabetically)."""
    import csv

    state: dict = {}
    with open(path) as fh:
        for rec in csv.DictReader(fh):
            key = tuple(v for k, v in sorted(rec.items()) if k not in ("time", "diff"))
            state[key] = state.get(key, 0) + int(rec["diff"])
    return {k: v for k, v in state.items() if v != 0}


# ------------------------------------------------------------------ pipelines


def _device_kw(pw) -> dict:
    return {"device": "cpu"} if pw.__name__ == "pathway_tpu_torch" else {}


def groupby_window(pw, out):
    """``tests/test_cluster.py``'s join → groupby and join → window."""
    t = pw.debug.table_from_markdown(
        """
        k | v | s | __time__ | __diff__
        1 | 3  | 10 | 2 | 1
        2 | 4  | 20 | 2 | 1
        3 | 7  | 30 | 2 | 1
        1 | 5  | 40 | 4 | 1
        2 | 9  | 15 | 4 | 1
        1 | 3  | 10 | 6 | -1
        4 | 11 | 25 | 6 | 1
        2 | 4  | 20 | 8 | -1
        """
    )
    d = pw.debug.table_from_rows(
        pw.schema_from_types(k=int, name=str), [(i, f"g{i % 2}") for i in range(1, 5)]
    )
    j = t.join(d, t.k == d.k).select(name=d.name, v=t.v, s=t.s)
    g = j.groupby(j.name).reduce(
        j.name, total=pw.reducers.sum(j.v), c=pw.reducers.count(), mx=pw.reducers.max(j.s)
    )
    w = j.windowby(j.s, window=pw.temporal.tumbling(duration=15), instance=j.name).reduce(
        name=pw.this._pw_instance, start=pw.this._pw_window_start, tot=pw.reducers.sum(pw.this.v)
    )
    pw.io.fs.write(g, out + ".groupby.csv", format="csv")
    pw.io.fs.write(w, out + ".window.csv", format="csv")
    pw.run(monitoring_level="none")


def sharded_index(pw, out):
    """Docs shard across workers, queries broadcast; ties at the k boundary."""
    import numpy as np

    rng = np.random.default_rng(11)
    vecs = rng.normal(size=(48, 8)).astype(np.float32)
    vecs[10:30] = vecs[10]
    docs = pw.debug.table_from_rows(pw.schema_from_types(emb=np.ndarray), [(v,) for v in vecs])
    qs = rng.normal(size=(6, 8)).astype(np.float32)
    qs[0] = vecs[10]
    queries = pw.debug.table_from_rows(pw.schema_from_types(emb=np.ndarray), [(q,) for q in qs])
    index = pw.stdlib.indexing.BruteForceKnnFactory(
        dimensions=8, reserved_space=128, **_device_kw(pw)
    ).build_index(docs.emb, docs)
    reply = index.inner_index.query(queries.emb, number_of_matches=5)
    flat = reply.select(
        r=pw.apply(lambda t: ";".join(f"{int(k)}:{float(s).hex()}" for (k, s) in t), reply._pw_index_reply)
    )
    pw.io.fs.write(flat, out + ".reply.csv", format="csv")
    pw.run(monitoring_level="none")


def temporal_watermark(pw, out):
    """Behaviors (buffer/forget/freeze) and session windows sharded by row
    key, with the cross-process watermark gossip."""
    t = pw.debug.table_from_markdown(
        """
        k | v | s | __time__ | __diff__
        1 | 3  | 10 | 2 | 1
        2 | 4  | 21 | 2 | 1
        3 | 7  | 33 | 2 | 1
        4 | 5  | 41 | 4 | 1
        5 | 9  | 15 | 4 | 1
        6 | 2  | 55 | 6 | 1
        7 | 11 | 26 | 6 | 1
        8 | 6  | 62 | 8 | 1
        """
    )
    w = t.windowby(
        t.s,
        window=pw.temporal.tumbling(duration=20),
        instance=t.k % 2,
        behavior=pw.temporal.common_behavior(delay=5, cutoff=100),
    ).reduce(inst=pw.this._pw_instance, start=pw.this._pw_window_start, tot=pw.reducers.sum(pw.this.v))
    sess = t.windowby(t.s, window=pw.temporal.session(max_gap=8), instance=t.k % 2).reduce(
        inst=pw.this._pw_instance, start=pw.this._pw_window_start, c=pw.reducers.count()
    )
    pw.io.fs.write(w, out + ".behavior.csv", format="csv")
    pw.io.fs.write(sess, out + ".session.csv", format="csv")
    pw.run(monitoring_level="none")


def sweep_cutoff(pw, out):
    """``tests/test_temporal_sweep.py``'s cutoff-tie pipeline."""
    t = pw.debug.table_from_markdown(
        """
            | t  | __time__
        1   | 2  | 2
        2   | 15 | 2
        3   | 9  | 4
        4   | 14 | 6
        5   | 3  | 6
        """
    )
    w = t.windowby(
        t.t, window=pw.temporal.tumbling(duration=10), behavior=pw.temporal.common_behavior(cutoff=5)
    ).reduce(start=pw.this._pw_window_start, cnt=pw.reducers.count(), mx=pw.reducers.max(pw.this.t))
    pw.io.fs.write(w, out + ".window.csv", format="csv")
    b = t._buffer(pw.this.t + 5, pw.this.t)
    pw.io.fs.write(b, out + ".buffer.csv", format="csv")
    pw.run(monitoring_level="none")


def session_sort(pw, out):
    """``tests/test_temporal_sweep.py``'s session-merge and prev/next churn."""
    t = pw.debug.table_from_markdown(
        """
            | t  | __time__ | __diff__
        1   | 0  | 2        | 1
        2   | 10 | 2        | 1
        3   | 5  | 4        | 1
        4   | 20 | 4        | 1
        3   | 5  | 6        | -1
        5   | 12 | 6        | 1
        """
    )
    sess = t.windowby(t.t, window=pw.temporal.session(max_gap=6)).reduce(
        start=pw.this._pw_window_start, end=pw.this._pw_window_end, cnt=pw.reducers.count()
    )
    pw.io.fs.write(sess, out + ".session.csv", format="csv")
    s = t.sort(t.t)
    joined = t.with_columns(prev=s.prev, next=s.next)
    prv = t.ix(joined.prev, optional=True)
    nxt = t.ix(joined.next, optional=True)
    chain = t.select(pw.this.t, pt=prv.t, nt=nxt.t)
    pw.io.fs.write(chain, out + ".chain.csv", format="csv")
    pw.run(monitoring_level="none")


def plane_groupby(pw, out):
    """A numeric groupby for the on-device exchange plane; prints the rows
    the plane moved."""
    import numpy as np

    rng = np.random.default_rng(5)
    n = 2000
    t = pw.debug.table_from_rows(
        pw.schema_from_types(k=int, v=int),
        list(zip(rng.integers(0, 40, n).tolist(), rng.integers(0, 500, n).tolist())),
    )
    g = t.groupby(t.k).reduce(t.k, s=pw.reducers.sum(t.v), c=pw.reducers.count())
    pw.io.fs.write(g, out + ".csv", format="csv")
    pw.run(monitoring_level="none")
    plane = getattr(pw.internals.run.current_runtime(), "device_plane", None)
    if plane is not None:
        print("PLANE_ROWS", plane.rows_exchanged, flush=True)


def kafka_ingest(pw, out):
    """Partition-per-worker Kafka ingest (``tests/test_distributed_io.py``);
    prints how many of this process's subjects ingested a partition."""
    broker = pw.io.kafka.MockKafkaBroker(path=os.environ["BROKER_PATH"])
    t = pw.io.kafka.read(broker, "t", schema=pw.schema_from_types(w=str, v=int), mode="static")
    g = t.groupby(t.w).reduce(t.w, c=pw.reducers.count(), s=pw.reducers.sum(t.v))
    pw.io.fs.write(g, out + ".csv", format="csv")
    pw.run(monitoring_level="none")
    drivers = getattr(pw.internals.run.current_runtime(), "connectors", [])
    ingested = sum(1 for d in drivers if getattr(getattr(d, "subject", None), "_offsets", None))
    print("INGESTED_SUBJECTS", ingested, flush=True)


def persist_words(pw, out):
    """Kafka word count under operator persistence; stops once the total
    reaches ``EXPECTED_WORDS`` (``tests/test_cluster.py``,
    ``tests/test_resilience.py``)."""
    broker = pw.io.kafka.MockKafkaBroker(path=os.environ["BROKER_PATH"])
    expected = int(os.environ["EXPECTED_WORDS"])
    words = pw.io.kafka.read(broker, "words", format="plaintext", mode="streaming", name="words")
    counts = words.groupby(words.data).reduce(words.data, c=pw.reducers.count())
    pw.io.fs.write(counts, out + ".csv", format="csv")
    total = counts.reduce(s=pw.reducers.sum(pw.this.c))

    def on_total(key, row, time, is_addition):
        if is_addition and row["s"] >= expected:
            rt = pw.internals.run.current_runtime()
            if rt is not None:
                rt.request_stop()

    pw.io.subscribe(total, on_change=on_total)
    interval = os.environ.get("SNAPSHOT_INTERVAL_MS")
    extra = {"snapshot_interval_ms": int(interval)} if interval else {}
    pw.run(
        monitoring_level="none",
        persistence_config=pw.persistence.Config(
            backend=pw.persistence.Backend.filesystem(os.environ["PSTORE"]),
            persistence_mode="operator_persisting",
            **extra,
        ),
    )


def sharded_identity(pw, out):
    """Kafka rows through a sharded csv sink under operator persistence;
    stops once ``EXPECTED_ROWS`` rows are out (``tests/test_persistence.py``)."""
    broker = pw.io.kafka.MockKafkaBroker(path=os.environ["BROKER_PATH"])
    expected = int(os.environ["EXPECTED_ROWS"])
    rows = pw.io.kafka.read(broker, "rows", format="plaintext", mode="streaming", name="rows")
    sel = rows.select(data=rows.data)
    pw.io.fs.write(sel, out, format="csv", sharded=True)
    total = sel.reduce(c=pw.reducers.count())

    def on_total(key, row, time, is_addition):
        if is_addition and row["c"] >= expected:
            rt = pw.internals.run.current_runtime()
            if rt is not None:
                rt.request_stop()

    pw.io.subscribe(total, on_change=on_total)
    pw.run(
        monitoring_level="none",
        persistence_config=pw.persistence.Config(
            backend=pw.persistence.Backend.filesystem(os.environ["PSTORE"]),
            persistence_mode="operator_persisting",
            snapshot_interval_ms=100,
        ),
    )


def flow_groupby(pw, out):
    """``tests/test_flow.py``'s cluster pipeline: a bulk-class connector
    into a groupby; process 0 writes the final groups to ``out.json``."""
    import json

    class Subj(pw.io.python.ConnectorSubject):
        def run(self):
            for i in range(60):
                self.next(k=i, x=i * 3)

    t = pw.io.python.read(Subj(), schema=pw.schema_from_types(k=int, x=int), service_class="bulk", name="feed")
    t = t.with_columns(m=t.x % 4)
    g = t.groupby(t.m).reduce(t.m, s=pw.reducers.sum(t.x), c=pw.reducers.count())
    state = {}

    def on_change(key, row, time, is_addition):
        if is_addition:
            state[key] = row
        else:
            state.pop(key, None)

    pw.io.subscribe(g, on_change=on_change)
    pw.run(monitoring_level="none")
    if os.environ.get("PATHWAY_PROCESS_ID", "0") == "0":
        with open(out + ".json", "w") as fh:
            json.dump(sorted((r["m"], r["s"], r["c"]) for r in state.values()), fh)


def streaming_sum(pw, out):
    """An unbounded source summed forever (a peer is killed mid-run)."""

    class Subj(pw.io.python.ConnectorSubject):
        def __init__(self):
            super().__init__()
            self._stop = False

        def run(self):
            i = 0
            while not self._stop:
                self.next(x=i)
                i += 1
                time.sleep(0.02)

        def on_stop(self):
            self._stop = True

    t = pw.io.python.read(Subj(), schema=pw.schema_from_types(x=int), name="src")
    agg = t.reduce(s=pw.reducers.sum(pw.this.x))
    pw.io.subscribe(agg, on_change=lambda **kw: None)
    pw.run(monitoring_level="none")


def monitored_feed(pw, out):
    """A live source into a groupby, served by the monitoring server
    (``tests/test_observability.py``'s cluster pipeline). The feed sends at
    least 40 rows and then stays live until the test writes ``<out>.stop``
    (read its ``/status``, ``/metrics`` and ``/trace``), at most 90 s: a
    fixed 2.4 s feed could end, under load, before the coordinator's
    ``/status`` showed both processes reporting."""
    stop = f"{out}.stop"

    class Subj(pw.io.python.ConnectorSubject):
        def run(self):
            deadline = time.time() + 90
            i = 0
            while i < 40 or not (os.path.exists(stop) or time.time() > deadline):
                self.next(x=i)
                i += 1
                time.sleep(0.06)

    t = pw.io.python.read(Subj(), schema=pw.schema_from_types(x=int), name="feed")
    t = t.with_columns(m=t.x % 3)
    g = t.groupby(t.m).reduce(s=pw.reducers.sum(t.x))
    pw.io.subscribe(g, on_change=lambda **k: None)
    pw.run(with_http_server=True, monitoring_level="none")


def audit_flip(pw, out):
    """A timed groupby under a ``flip_diff`` fault; each process writes its
    audit plane's violations and ``/status`` kinds to ``out.p<pid>.json``."""
    import json

    t = pw.debug.table_from_rows(
        pw.schema_from_types(x=int), [(i, i // 8, 1) for i in range(64)], is_stream=True
    )
    t = t.with_columns(m=t.x % 5)
    g = t.groupby(t.m).reduce(s=pw.reducers.sum(t.x))
    pw.io.subscribe(g, on_change=lambda **k: None)
    pw.run(monitoring_level="none")
    plane = pw.observability.audit.current()
    rt = pw.internals.run.current_runtime()
    from importlib import import_module

    status = import_module(pw.__name__ + ".internals.monitoring").run_stats(rt)["audit"]
    doc = {
        "violations": dict(plane.violation_counts),
        "status_kinds": status["violations_by_kind"],
        "recent": [{k: v for k, v in r.items() if k != "t_ns"} for r in status["recent_violations"]],
    }
    pid = os.environ.get("PATHWAY_PROCESS_ID", "0")
    with open(f"{out}.p{pid}.json", "w") as fh:
        json.dump(doc, fh)


PIPELINES = {
    f.__name__: f
    for f in (
        groupby_window,
        sharded_index,
        temporal_watermark,
        sweep_cutoff,
        session_sort,
        plane_groupby,
        kafka_ingest,
        persist_words,
        sharded_identity,
        flow_groupby,
        streaming_sum,
        monitored_feed,
        audit_flip,
    )
}


if __name__ == "__main__":
    import pathway_tpu_torch

    PIPELINES[sys.argv[1]](pathway_tpu_torch, sys.argv[2])
