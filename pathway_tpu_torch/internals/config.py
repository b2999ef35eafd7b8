"""Central runtime configuration from ``PATHWAY_*`` environment variables.

Role of the reference's ``PathwayConfig`` (``python/pathway/internals/config.py``,
176 LoC) and the Rust ``Config::from_env`` (``src/engine/dataflow/config.rs:88-127``):
one object owning every env knob, so subsystems stop reading ``os.environ`` ad hoc.
Properties read the environment live — cheap, and subprocess tests that mutate env
see fresh values without cache invalidation.
"""

from __future__ import annotations

import os
from typing import Any


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        raise ValueError(f"{name} must be an integer, got {os.environ[name]!r}") from None


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        raise ValueError(f"{name} must be a number, got {os.environ[name]!r}") from None


def _env_bool(name: str, default: bool) -> bool:
    raw = os.environ.get(name)
    if raw is None:
        return default
    return raw.strip().lower() not in ("", "0", "false", "no", "off")


class PathwayConfig:
    """Live view of the ``PATHWAY_*`` environment."""

    # ---- worker topology ----------------------------------------------------
    @property
    def threads(self) -> int:
        return max(1, _env_int("PATHWAY_THREADS", 1))

    @property
    def processes(self) -> int:
        return max(1, _env_int("PATHWAY_PROCESSES", 1))

    @property
    def process_id(self) -> int:
        return _env_int("PATHWAY_PROCESS_ID", 0)

    @property
    def first_port(self) -> int:
        return _env_int("PATHWAY_FIRST_PORT", 21000)

    @property
    def barrier_timeout(self) -> float:
        return _env_float("PATHWAY_BARRIER_TIMEOUT", 120.0)

    # ---- resilience ---------------------------------------------------------
    @property
    def heartbeat_interval(self) -> float:
        """Seconds between peer→coordinator heartbeats on the cluster control
        plane; <=0 disables failure detection (barriers then fall back to the
        bare ``barrier_timeout``)."""
        return _env_float("PATHWAY_HEARTBEAT_INTERVAL", 0.5)

    @property
    def heartbeat_timeout(self) -> float:
        """Seconds of heartbeat silence before a connected-but-quiet peer is
        declared dead (a peer whose process exits is detected immediately via
        connection EOF). Clamped so detection always lands within
        ``barrier_timeout``."""
        return min(
            _env_float("PATHWAY_HEARTBEAT_TIMEOUT", 10.0), self.barrier_timeout
        )

    @property
    def fault_plan(self) -> str | None:
        """Fault-injection plan (``resilience.FaultPlan`` syntax), e.g.
        ``kill:proc=1,tick=40;drop_poll:proc=0,tick=3,count=2``."""
        return os.environ.get("PATHWAY_FAULT_PLAN") or None

    @property
    def supervisor_max_restarts(self) -> int:
        return _env_int("PATHWAY_SUPERVISOR_MAX_RESTARTS", 3)

    @property
    def supervisor_backoff_s(self) -> float:
        return _env_float("PATHWAY_SUPERVISOR_BACKOFF", 0.5)

    # ---- elasticity (live scale-out / scale-in) -----------------------------
    @property
    def elastic(self) -> str:
        """Elasticity plane master switch: ``off`` (default — the pre-r17
        fixed-worker behavior, byte for byte), ``manual`` (the coordinator
        honors ``pathway_tpu_torch scale --to N`` requests: the pod quiesces to the
        next committed checkpoint epoch, commits a new membership version and
        exits with the rescale status so a Supervisor relaunches it at the new
        shape, state resharding by key range from the committed epoch), or
        ``auto`` (additionally the pressure-driven autoscaler decides joins
        and drains from the r9 pod-pressure signal + sink p99 vs SLO)."""
        raw = os.environ.get("PATHWAY_ELASTIC", "off").strip().lower()
        if raw in ("", "0", "false", "no", "off"):
            return "off"
        if raw not in ("manual", "auto"):
            raise ValueError(
                f"PATHWAY_ELASTIC must be off/manual/auto, got {raw!r}"
            )
        return raw

    @property
    def elastic_min_processes(self) -> int:
        """Autoscaler lower bound: drains never shrink the pod below this."""
        return max(1, _env_int("PATHWAY_ELASTIC_MIN_PROCESSES", 1))

    @property
    def elastic_max_processes(self) -> int:
        """Autoscaler upper bound: joins never grow the pod past this."""
        return max(1, _env_int("PATHWAY_ELASTIC_MAX_PROCESSES", 8))

    @property
    def elastic_high_pressure(self) -> float:
        """Pod-pressure level treated as saturation: sustained readings at or
        above it (see ``PATHWAY_ELASTIC_SUSTAIN_TICKS``) trigger a join."""
        v = _env_float("PATHWAY_ELASTIC_HIGH_PRESSURE", 0.75)
        if not 0.0 < v <= 1.0:
            raise ValueError(
                f"PATHWAY_ELASTIC_HIGH_PRESSURE must be in (0, 1], got {v}"
            )
        return v

    @property
    def elastic_low_pressure(self) -> float:
        """Pod-pressure level treated as idle: sustained readings at or below
        it trigger a drain. Must sit below the high threshold (hysteresis —
        the band between them is the no-decision zone)."""
        v = _env_float("PATHWAY_ELASTIC_LOW_PRESSURE", 0.05)
        if not 0.0 <= v < 1.0:
            raise ValueError(
                f"PATHWAY_ELASTIC_LOW_PRESSURE must be in [0, 1), got {v}"
            )
        return v

    @property
    def elastic_sustain_ticks(self) -> int:
        """Consecutive ticks a pressure reading must hold beyond a threshold
        before the autoscaler acts — one flooded tick is noise, a sustained
        run is a trend."""
        return max(1, _env_int("PATHWAY_ELASTIC_SUSTAIN_TICKS", 50))

    @property
    def elastic_cooldown_s(self) -> float:
        """Seconds after any scale decision during which no further decision
        fires — the relaunched pod needs time to warm before its pressure
        readings mean anything."""
        return max(0.0, _env_float("PATHWAY_ELASTIC_COOLDOWN", 30.0))

    # ---- persistence / replay ----------------------------------------------
    @property
    def persistent_storage(self) -> str | None:
        return os.environ.get("PATHWAY_PERSISTENT_STORAGE")

    @property
    def replay_storage(self) -> str | None:
        return os.environ.get("PATHWAY_REPLAY_STORAGE")

    @property
    def replay_mode(self) -> str:
        return os.environ.get("PATHWAY_REPLAY_MODE", "speedrun")

    @property
    def continue_after_replay(self) -> bool:
        return _env_bool("PATHWAY_CONTINUE_AFTER_REPLAY", True)

    # ---- behavior flags -----------------------------------------------------
    @property
    def terminate_on_error(self) -> bool:
        return _env_bool("PATHWAY_TERMINATE_ON_ERROR", True)

    @property
    def runtime_typechecking(self) -> bool:
        return _env_bool("PATHWAY_RUNTIME_TYPECHECKING", False)

    @property
    def ignore_asserts(self) -> bool:
        return _env_bool("PATHWAY_IGNORE_ASSERTS", False)

    @property
    def device_exchange(self) -> str:
        """On-device all_to_all exchange plane for sharded runtimes:
        ``off`` | ``auto`` (blocks ≥ min_rows ride the mesh) | ``on`` (every
        eligible batch; byte-identity suites run this)."""
        mode = os.environ.get("PATHWAY_DEVICE_EXCHANGE", "auto").strip().lower()
        if mode not in ("off", "auto", "on"):
            raise ValueError(
                f"PATHWAY_DEVICE_EXCHANGE must be off/auto/on, got {mode!r}"
            )
        return mode

    @property
    def device_exchange_min_rows(self) -> int:
        return _env_int("PATHWAY_DEVICE_EXCHANGE_MIN_ROWS", 4096)

    @property
    def device_exchange_fused(self) -> str:
        """Fused consolidate+exchange launch for the device plane: ``off`` =
        consolidate on host, then exchange; ``auto``/``on`` = keyed delta
        blocks are digest-netted (diffs segment-summed, net-zero rows
        invalidated) INSIDE the same shard_map launch that re-shards them —
        one kernel, one interconnect round, no intermediate host block."""
        mode = os.environ.get("PATHWAY_DEVICE_EXCHANGE_FUSED", "auto").strip().lower()
        if mode not in ("off", "auto", "on"):
            raise ValueError(
                f"PATHWAY_DEVICE_EXCHANGE_FUSED must be off/auto/on, got {mode!r}"
            )
        return mode

    @property
    def engine_phases(self) -> bool:
        """Host-side per-phase tick attribution (consolidate / rehash / probe /
        groupby / join / realloc / kernel / exchange / capture wall time):
        read by ``benchmarks/engine_bench.py`` for the BENCH per-phase tick
        breakdown. Off by default — instrumented sites pay one global read."""
        return _env_bool("PATHWAY_ENGINE_PHASES", False)

    @property
    def fuse(self) -> str:
        """Chain fusion (``engine/fusion.py``): lower maximal
        single-consumer operator chains into one sweep step per chain —
        batches hand off member to member in-process instead of paying the
        per-node drain/route/accept dispatch, and runs of expression members
        collapse into one composed block program. ``off`` restores the
        one-node-per-step r14 sweep byte-for-byte. Default ``on``
        (the small-tick dispatch win)."""
        mode = os.environ.get("PATHWAY_FUSE", "on").strip().lower()
        if mode in ("on", "1", "true"):
            return "on"
        if mode in ("off", "0", "false"):
            return "off"
        raise ValueError(f"PATHWAY_FUSE must be off/on, got {mode!r}")

    @property
    def fuse_jax(self) -> str:
        """Jitted fused-chain kernels: lower a composed expression segment
        (whitelisted numeric filter/map chain) into ONE buffer-donating XLA
        launch per tick, inputs padded to the shared power-of-two buckets so
        the jit shape set stays closed under row-count churn. ``auto``
        routes only blocks of at least ``PATHWAY_FUSE_JAX_MIN_ROWS`` rows
        (below that, XLA dispatch overhead loses to the composed numpy
        program on CPU — the jax_kernels adoption discipline); ``on``
        forces every eligible block through the kernel; ``off`` keeps chains
        on the composed numpy path. Values are bit-identical either way
        (the whitelist admits only ops with no numpy/XLA divergence)."""
        mode = os.environ.get("PATHWAY_FUSE_JAX", "auto").strip().lower()
        if mode not in ("off", "auto", "on"):
            raise ValueError(f"PATHWAY_FUSE_JAX must be off/auto/on, got {mode!r}")
        return mode

    @property
    def fuse_jax_min_rows(self) -> int:
        """Row threshold for ``PATHWAY_FUSE_JAX=auto`` (default 65536 —
        the measured crossover scale of the other engine kernels on CPU)."""
        return max(1, _env_int("PATHWAY_FUSE_JAX_MIN_ROWS", 65536))

    @property
    def arrange_device_cache(self) -> bool:
        """Persistent device-resident arrangements for the jitted probe
        kernel: sorted state segments are transferred once per compaction
        generation and re-probed from device memory across ticks, instead of
        re-uploading the arrangement every tick. On by default; ``0`` forces
        the per-call transfer (debugging / memory-pressure escape hatch)."""
        return _env_bool("PATHWAY_ARRANGE_CACHE", True)

    @property
    def arrange_donate(self) -> str:
        """Buffer donation on the tick-loop jit entry points (probe queries,
        grouped segment-sum inputs, exchange staging): ``auto`` = donate on
        tpu/gpu backends where XLA reuses the buffer for outputs and skips a
        copy, never on cpu (donation is ignored there and warns); ``on`` /
        ``off`` force it."""
        mode = os.environ.get("PATHWAY_ARRANGE_DONATE", "auto").strip().lower()
        if mode not in ("off", "auto", "on"):
            raise ValueError(
                f"PATHWAY_ARRANGE_DONATE must be off/auto/on, got {mode!r}"
            )
        return mode

    @property
    def microbatch(self) -> str:
        """Cross-tick accumulate-then-launch dispatch for ``is_batched`` UDFs
        (embedders/rerankers): ``off`` = one call per delta block (the r5
        behavior), ``auto``/``on`` = buffer rows across ticks per (UDF, bucket)
        and launch padded power-of-two batches, holding rows until their batch
        completes (flushed on the autocommit deadline, so added latency is
        bounded by ``autocommit_duration_ms``), ``pending`` = same batching but
        rows appear immediately with ``PENDING`` in the UDF columns and settle
        via a retract/insert correction on the completing tick (the
        ``await_futures`` discipline, ``internals/table.py``). Measured default:
        ``auto`` — streaming 64-row ticks reach batch-512 device
        throughput instead of a fraction of it."""
        mode = os.environ.get("PATHWAY_MICROBATCH", "auto").strip().lower()
        if mode not in ("off", "auto", "on", "pending"):
            raise ValueError(
                f"PATHWAY_MICROBATCH must be off/auto/on/pending, got {mode!r}"
            )
        return mode

    @property
    def microbatch_max_batch(self) -> int:
        """Device launch chunk for cross-tick microbatching; 512 is the measured
        best batch on the reference's TPU (v5e)."""
        n = _env_int("PATHWAY_MICROBATCH_MAX_BATCH", 512)
        if n < 1:
            raise ValueError(
                f"PATHWAY_MICROBATCH_MAX_BATCH must be >= 1, got {n}"
            )
        return n

    @property
    def microbatch_flush_ms(self) -> float | None:
        """Override the buffer-age flush deadline (defaults to the runtime's
        ``autocommit_duration_ms``)."""
        raw = os.environ.get("PATHWAY_MICROBATCH_FLUSH_MS")
        return None if raw in (None, "") else float(raw)

    # ---- flow control (adaptive admission plane) ----------------------------
    @property
    def flow(self) -> str:
        """Adaptive flow-control plane master switch: ``off`` (default — no
        gates installed, ingest queues unbounded, byte-for-byte the pre-r9
        behavior) or ``on`` (bounded credit queues on every connector input,
        priority admission for interactive vs bulk service classes, and the
        AIMD microbatch controller)."""
        raw = os.environ.get("PATHWAY_FLOW", "off").strip().lower()
        if raw in ("", "0", "false", "no", "off"):
            return "off"
        if raw in ("1", "true", "yes", "on"):
            return "on"
        raise ValueError(f"PATHWAY_FLOW must be off/on, got {raw!r}")

    @property
    def input_queue_rows(self) -> int:
        """Per-connector ingest queue bound (rows) when the flow plane is on.
        Credits are consumed by connector pushes and replenished when the tick
        that drained the rows completes downstream."""
        n = _env_int("PATHWAY_INPUT_QUEUE_ROWS", 65536)
        if n < 1:
            raise ValueError(f"PATHWAY_INPUT_QUEUE_ROWS must be >= 1, got {n}")
        return n

    @property
    def flow_policy(self) -> str:
        """Overflow policy of a full ingest queue: ``block`` (default — the
        producer thread waits for credit, classic backpressure) or ``shed``
        (overflow rows are dropped and counted — explicit, telemetry-visible
        load shedding instead of silent memory growth)."""
        raw = os.environ.get("PATHWAY_FLOW_POLICY", "block").strip().lower()
        if raw not in ("block", "shed"):
            raise ValueError(f"PATHWAY_FLOW_POLICY must be block/shed, got {raw!r}")
        return raw

    @property
    def latency_slo_ms(self) -> float:
        """Interactive sink end-to-end latency objective (ms). The AIMD
        controller halves the microbatch target bucket when the recent sink
        p99 exceeds this, and the admission scheduler throttles bulk-class
        inputs as the observed latency approaches it."""
        v = _env_float("PATHWAY_LATENCY_SLO_MS", 250.0)
        if v <= 0:
            raise ValueError(f"PATHWAY_LATENCY_SLO_MS must be > 0, got {v}")
        return v

    @property
    def flow_bulk_min_rows(self) -> int:
        """Guaranteed bulk-class admission per tick under full pressure —
        backfill keeps progressing (never starved) while interactive traffic
        overtakes it."""
        return max(1, _env_int("PATHWAY_FLOW_BULK_MIN_ROWS", 64))

    @property
    def flow_bulk_max_rows(self) -> int:
        """Standing per-tick bulk drain ceiling, applied even at zero
        pressure (0 = unlimited, the r9 behavior). The pressure signal is
        reactive — it engages only after interactive latency degrades — so
        serving tiers whose bulk rows carry real device cost (doc-ingest
        embeds) set this to bound the stall a fresh flood can inflict before
        the controller responds."""
        return max(0, _env_int("PATHWAY_FLOW_BULK_MAX_ROWS", 0))

    # ---- REST serving plane (io/http rest_connector) ------------------------
    @property
    def serve_max_inflight(self) -> int:
        """Bounded in-flight request budget per REST route: requests admitted
        but not yet answered. Past it the route sheds with a fast 429 +
        ``Retry-After`` instead of growing an unbounded futures dict — the
        serving-side mirror of the ingest credit gate."""
        n = _env_int("PATHWAY_SERVE_MAX_INFLIGHT", 1024)
        if n < 1:
            raise ValueError(f"PATHWAY_SERVE_MAX_INFLIGHT must be >= 1, got {n}")
        return n

    @property
    def serve_coalesce_ms(self) -> float:
        """How long a query arrival may wait for concurrent requests to
        coalesce into the same engine tick before a tick is forced. The
        arrival-driven scheduler wakes the tick loop after this delay (or
        immediately once ``PATHWAY_SERVE_COALESCE_ROWS`` requests are
        waiting), so single-request latency is ~this bound plus the tick,
        instead of the autocommit poll interval."""
        v = _env_float("PATHWAY_SERVE_COALESCE_MS", 2.0)
        if v < 0:
            raise ValueError(f"PATHWAY_SERVE_COALESCE_MS must be >= 0, got {v}")
        return v

    @property
    def serve_coalesce_rows(self) -> int:
        """In-flight request count that triggers an IMMEDIATE tick wakeup —
        a full coalesce bucket shouldn't wait out the coalesce window."""
        return max(1, _env_int("PATHWAY_SERVE_COALESCE_ROWS", 64))

    @property
    def serve_rate(self) -> float:
        """Per-route token-bucket refill rate (requests/second) applied at
        EVERY front door — the coordinator's and, with the fabric on, each
        peer's. 0 (default) disables rate limiting. Requests past the bucket
        shed with ``429`` + an exact ``Retry-After`` derived from the refill
        rate, counted per route per process and merged pod-wide over the
        heartbeat telemetry."""
        v = _env_float("PATHWAY_SERVE_RATE", 0.0)
        if v < 0:
            raise ValueError(f"PATHWAY_SERVE_RATE must be >= 0, got {v}")
        return v

    @property
    def serve_burst(self) -> int:
        """Token-bucket capacity (burst) for ``PATHWAY_SERVE_RATE``. 0
        (default) sizes the bucket at ``max(1, ceil(rate))`` — one second of
        refill."""
        n = _env_int("PATHWAY_SERVE_BURST", 0)
        if n < 0:
            raise ValueError(f"PATHWAY_SERVE_BURST must be >= 0, got {n}")
        return n

    @property
    def serve_api_keys(self) -> tuple[str, ...]:
        """Comma-separated API keys accepted at every front door (presented
        as ``X-API-Key`` or ``Authorization: Bearer``). Empty (default)
        disables auth. With keys set, a request without a key answers ``401``
        and a wrong key ``403`` — both shed at the door, before admission,
        with exact per-route counters."""
        raw = os.environ.get("PATHWAY_SERVE_API_KEYS", "")
        return tuple(k.strip() for k in raw.split(",") if k.strip())

    @property
    def serve_tick(self) -> str:
        """REST query tick scheduling: ``arrival`` (default — query arrival
        wakes the tick loop through the coalesce window above) or ``poll``
        (pre-r14 behavior: requests wait for the fixed autocommit poll; the
        serving bench's baseline mode)."""
        raw = os.environ.get("PATHWAY_SERVE_TICK", "arrival").strip().lower()
        if raw not in ("arrival", "poll"):
            raise ValueError(
                f"PATHWAY_SERVE_TICK must be arrival/poll, got {raw!r}"
            )
        return raw

    # ---- distributed serving fabric (pathway_tpu_torch/fabric) --------------------
    @property
    def fabric(self) -> str:
        """Distributed serving fabric master switch: ``off`` (default — REST
        routes live on the coordinator only, the pre-r18 behavior byte for
        byte) or ``on`` (every cluster process starts a front door for every
        registered route; a request landing on a non-owner process is
        forwarded over the fabric transport to the owning process and the
        answer relayed back byte-identical, replica-served table routes
        answer locally from the changelog feed, and ``/_schema`` is served
        from every door). No-op on single-process runs."""
        raw = os.environ.get("PATHWAY_FABRIC", "off").strip().lower()
        if raw in ("", "0", "false", "no", "off"):
            return "off"
        if raw in ("1", "true", "yes", "on"):
            return "on"
        raise ValueError(f"PATHWAY_FABRIC must be off/on, got {raw!r}")

    @property
    def fabric_port_stride(self) -> int:
        """Front-door port offset per process: process ``i``'s door binds the
        route's port + ``i * stride``. The default 1 keeps single-host pods
        (tests, laptops) collision-free; multi-host pods set 0 so every host
        serves the SAME port behind one load balancer."""
        n = _env_int("PATHWAY_FABRIC_PORT_STRIDE", 1)
        if n < 0:
            raise ValueError(f"PATHWAY_FABRIC_PORT_STRIDE must be >= 0, got {n}")
        return n

    @property
    def fabric_max_staleness_ms(self) -> float:
        """Replica freshness bound: a replica-served table route answers
        locally only while its changelog lag is at most this; a staler
        replica falls back to forwarding the lookup to the owner (counted,
        never silently stale past the bound)."""
        v = _env_float("PATHWAY_FABRIC_MAX_STALENESS_MS", 2000.0)
        if v <= 0:
            raise ValueError(
                f"PATHWAY_FABRIC_MAX_STALENESS_MS must be > 0, got {v}"
            )
        return v

    @property
    def fabric_timeout(self) -> float:
        """Seconds an ingress front door waits for a forwarded request's
        answer from the owning process before answering 503."""
        v = _env_float("PATHWAY_FABRIC_TIMEOUT", 30.0)
        if v <= 0:
            raise ValueError(f"PATHWAY_FABRIC_TIMEOUT must be > 0, got {v}")
        return v

    # ---- replica-served retrieval (pathway_tpu_torch/fabric/index_replica) --------
    @property
    def replica(self) -> str:
        """Replica-served retrieval master switch: ``on`` (default — with the
        fabric live on a cluster run, every process replays the index
        changelog into a local replica index and its front door answers
        ``/v1/retrieve`` locally within ``PATHWAY_REPLICA_MAX_STALENESS_MS``,
        falling back to owner-forwarding when stale or resyncing) or ``off``
        (every retrieval pays the r18 owner hop; the pre-r20 behavior byte
        for byte). No-op without ``PATHWAY_FABRIC=on`` or on single-process
        runs."""
        raw = os.environ.get("PATHWAY_REPLICA", "on").strip().lower()
        if raw in ("1", "true", "yes", "on", ""):
            return "on"
        if raw in ("0", "false", "no", "off"):
            return "off"
        raise ValueError(f"PATHWAY_REPLICA must be on/off, got {raw!r}")

    @property
    def replica_max_staleness_ms(self) -> float:
        """Replica-index freshness bound: a door answers ``/v1/retrieve``
        from its local replica index only while every peer slice's changelog
        lag is at most this; a staler (or never-synced, or resyncing) replica
        forwards to the owner instead — counted, never silently stale past
        the bound."""
        v = _env_float("PATHWAY_REPLICA_MAX_STALENESS_MS", 2000.0)
        if v <= 0:
            raise ValueError(
                f"PATHWAY_REPLICA_MAX_STALENESS_MS must be > 0, got {v}"
            )
        return v

    @property
    def replica_memo_share(self) -> str:
        """Pod-wide query-embedding memo sharing: ``on`` (default — each
        process piggybacks its freshly-encoded memo entries on the replica
        cast so a pod-wide hot query set embeds once; peers insert them into
        their own embedder memos) or ``off`` (the r14 memo stays strictly
        per-process). No-op without a fabric or with unmemoized embedders."""
        raw = os.environ.get("PATHWAY_REPLICA_MEMO_SHARE", "on").strip().lower()
        if raw in ("1", "true", "yes", "on", ""):
            return "on"
        if raw in ("0", "false", "no", "off"):
            return "off"
        raise ValueError(
            f"PATHWAY_REPLICA_MEMO_SHARE must be on/off, got {raw!r}"
        )

    # ---- shard-map plane (internals/shardmap) ------------------------------
    @property
    def shardmap(self) -> str:
        """Versioned shard-map plane master switch: ``off`` (default — key
        ownership stays the derived ``(key & SHARD_MASK) % n_workers`` modulo
        rule, pre-r19 behavior byte for byte) or ``on`` (cluster placement,
        fabric door routing, and elastic rescale all consult one committed
        ``internals/shardmap.ShardMap`` of contiguous residue ranges: fabric
        doors route requests directly to the key's owning process instead of
        worker 0, and a rescale moves only the re-mapped ranges)."""
        raw = os.environ.get("PATHWAY_SHARDMAP", "off").strip().lower()
        if raw in ("", "0", "false", "no", "off"):
            return "off"
        if raw in ("1", "true", "yes", "on"):
            return "on"
        raise ValueError(f"PATHWAY_SHARDMAP must be off/on, got {raw!r}")

    @property
    def shardmap_migration(self) -> str:
        """Live state migration under the shard-map plane: ``on`` (default —
        a rescale diffs shard map V→V+1 and MOVES only the re-mapped key
        ranges' operator shards, restoring everything else positionally, and
        input-log trim stays enabled) or ``off`` (fall back to the r17
        wipe-positional-shards + replay-full-input-logs path; trim stays
        suspended). Ignored while ``PATHWAY_SHARDMAP`` is off."""
        raw = os.environ.get("PATHWAY_SHARDMAP_MIGRATION", "on").strip().lower()
        if raw in ("1", "true", "yes", "on", ""):
            return "on"
        if raw in ("0", "false", "no", "off"):
            return "off"
        raise ValueError(
            f"PATHWAY_SHARDMAP_MIGRATION must be on/off, got {raw!r}"
        )

    @property
    def monitoring_server(self) -> str | None:
        return os.environ.get("PATHWAY_MONITORING_SERVER")

    @property
    def monitoring_http_host(self) -> str:
        """Bind host for the monitoring HTTP server. Default stays loopback;
        multi-host TPU-VM pods set ``0.0.0.0`` (or the NIC address) so peers'
        ``/metrics`` are scrapable across the pod."""
        return os.environ.get("PATHWAY_MONITORING_HTTP_HOST", "127.0.0.1")

    # ---- live tracing (observability plane) ---------------------------------
    @property
    def trace_mode(self) -> str:
        """Live span pipeline master switch: ``off`` (default — no tracer is
        installed, hot loops pay one ``is None`` test) or ``on``."""
        raw = os.environ.get("PATHWAY_TRACE", "off").strip().lower()
        if raw in ("", "0", "false", "no", "off"):
            return "off"
        if raw in ("1", "true", "yes", "on", "full", "live"):
            return "on"
        raise ValueError(f"PATHWAY_TRACE must be off/on, got {raw!r}")

    @property
    def trace_sample(self) -> float:
        """Head-sampling rate in (0, 1]: the fraction of TICKS traced (a
        sampled tick records all its child spans; an unsampled one records
        none). The tick hash is deterministic, so every cluster process
        samples the same ticks."""
        rate = _env_float("PATHWAY_TRACE_SAMPLE", 1.0)
        if not 0.0 < rate <= 1.0:
            raise ValueError(
                f"PATHWAY_TRACE_SAMPLE must be in (0, 1], got {rate}"
            )
        return rate

    @property
    def trace_live_file(self) -> str | None:
        """Rotating OTLP-JSON live sink (one ExportTraceServiceRequest per
        line); cluster processes suffix ``.p<id>``. Unset = ring buffer only
        (served by ``/trace?since=``)."""
        return os.environ.get("PATHWAY_TRACE_LIVE_FILE") or None

    @property
    def trace_buffer_spans(self) -> int:
        return max(64, _env_int("PATHWAY_TRACE_BUFFER", 8192))

    @property
    def trace_rotate_mb(self) -> int:
        return max(1, _env_int("PATHWAY_TRACE_ROTATE_MB", 64))

    @property
    def run_id(self) -> str:
        return os.environ.get("PATHWAY_RUN_ID", "")

    # ---- request-scoped tracing (observability plane, serving side) ---------
    @property
    def request_trace(self) -> str:
        """Request-scoped tracing plane (``observability/requests.py``):
        ``on`` (default) mints a ``request_id`` per admitted REST request,
        buffers its per-stage flight path in a bounded ring and keeps the
        trace **tail-based** — on completion, iff it was slow
        (``PATHWAY_REQUEST_TRACE_SLOW_MS``), errored/timed out, or falls in
        the deterministic always-keep hash slice
        (``PATHWAY_REQUEST_TRACE_KEEP``). ``off`` installs no plane at all —
        engine hot loops pay one ``is None`` test and zero rings exist."""
        raw = os.environ.get("PATHWAY_REQUEST_TRACE", "on").strip().lower()
        if raw in ("", "1", "true", "yes", "on"):
            return "on"
        if raw in ("0", "false", "no", "off"):
            return "off"
        raise ValueError(f"PATHWAY_REQUEST_TRACE must be off/on, got {raw!r}")

    @property
    def request_trace_slow_ms(self) -> float:
        """Tail-sampling latency threshold: a completed request whose
        arrival-to-response latency is at least this keeps its trace (0 keeps
        every trace — investigation mode)."""
        v = _env_float("PATHWAY_REQUEST_TRACE_SLOW_MS", 250.0)
        if v < 0:
            raise ValueError(
                f"PATHWAY_REQUEST_TRACE_SLOW_MS must be >= 0, got {v}"
            )
        return v

    @property
    def request_trace_keep(self) -> float:
        """Deterministic always-keep slice in [0, 1]: the fraction of
        request ids (by hash) whose traces are kept even when fast and
        successful — the healthy-baseline exemplars slow traces are compared
        against."""
        v = _env_float("PATHWAY_REQUEST_TRACE_KEEP", 0.01)
        if not 0.0 <= v <= 1.0:
            raise ValueError(
                f"PATHWAY_REQUEST_TRACE_KEEP must be in [0, 1], got {v}"
            )
        return v

    @property
    def request_trace_kept(self) -> int:
        """Bounded ring of kept traces queryable via ``/request?id=`` and the
        ``pathway_tpu_torch trace`` CLI (oldest evicted first)."""
        return max(8, _env_int("PATHWAY_REQUEST_TRACE_KEPT", 256))

    # ---- device profiling (observability plane, device side) ----------------
    @property
    def profile(self) -> str:
        """Device profiling plane: ``on`` (default — compile/shape counters,
        padding-waste accounting, device-memory gauges and the flight-recorder
        ring, all at negligible cost), ``full`` (additionally measures the
        host/device time split by blocking on every traced dispatch — use for
        investigation, not steady state), or ``off``."""
        raw = os.environ.get("PATHWAY_PROFILE", "on").strip().lower()
        if raw in ("", "1", "true", "yes", "on"):
            return "on"
        if raw in ("0", "false", "no", "off"):
            return "off"
        if raw == "full":
            return "full"
        raise ValueError(f"PATHWAY_PROFILE must be off/on/full, got {raw!r}")

    @property
    def profile_dir(self) -> str | None:
        """When set, capture a ``jax.profiler`` trace of the run's first
        ``PATHWAY_PROFILE_TICKS`` ticks into this directory (viewable in
        TensorBoard/XProf). Further windows can be triggered live via the
        monitoring server's ``/profile?ticks=N`` endpoint or the
        ``pathway_tpu_torch profile`` CLI."""
        return os.environ.get("PATHWAY_PROFILE_DIR") or None

    @property
    def profile_ticks(self) -> int:
        """Length (ticks) of a ``jax.profiler`` capture window."""
        return max(1, _env_int("PATHWAY_PROFILE_TICKS", 16))

    @property
    def profile_shape_warn(self) -> int:
        """Per-callable compile-cache shape-set size past which the
        recompile-storm detector flags the callable on ``/status`` — a
        healthy bucketed pipeline keeps a small closed shape set."""
        return max(2, _env_int("PATHWAY_PROFILE_SHAPE_WARN", 12))

    @property
    def profile_peak_tflops(self) -> float:
        """Per-chip peak TFLOP/s used to turn the rough per-launch FLOP
        estimates into a live MFU gauge (e.g. 197 for v5e bf16). 0 (default)
        reports achieved FLOP/s without an MFU ratio."""
        return max(0.0, _env_float("PATHWAY_PROFILE_PEAK_TFLOPS", 0.0))

    # ---- index plane (serving-scale KNN) ------------------------------------
    @property
    def index_snapshot(self) -> str:
        """Operator-snapshot discipline for external-index nodes: ``delta``
        (default — persist an add/remove delta log per snapshot tick plus a
        periodic compacted base, so a live 1M×384 index pays O(churn) per
        interval instead of re-pickling ~1.5 GB) or ``whole`` (the pre-r13
        whole-backend pickle, kept as an escape hatch)."""
        raw = os.environ.get("PATHWAY_INDEX_SNAPSHOT", "delta").strip().lower()
        if raw not in ("delta", "whole"):
            raise ValueError(
                f"PATHWAY_INDEX_SNAPSHOT must be delta/whole, got {raw!r}"
            )
        return raw

    @property
    def index_compact_frac(self) -> float:
        """Delta-log compaction threshold: when the accumulated delta chunks
        exceed this fraction of the base pickle's bytes, the next snapshot
        tick writes a fresh compacted base and the covered delta chunks are
        deleted after the manifest commit (the input-log trim discipline)."""
        v = _env_float("PATHWAY_INDEX_COMPACT_FRAC", 0.5)
        if v <= 0:
            raise ValueError(f"PATHWAY_INDEX_COMPACT_FRAC must be > 0, got {v}")
        return v

    @property
    def index_hot_rows(self) -> int:
        """HBM-resident row bound of the tiered KNN index's hot shard
        (``TieredKnnBackend``). The hot brute-force matrix is allocated at
        this bound and never grows past it — fixed HBM regardless of corpus
        size; everything else lives in the host IVF cold tier."""
        n = _env_int("PATHWAY_INDEX_HOT_ROWS", 65536)
        if n < 1:
            raise ValueError(f"PATHWAY_INDEX_HOT_ROWS must be >= 1, got {n}")
        return n

    @property
    def index_promote_hits(self) -> int:
        """Cold-tier hit count (within one maintenance window) at which a row
        becomes a promotion candidate for the hot shard."""
        return max(1, _env_int("PATHWAY_INDEX_PROMOTE_HITS", 2))

    @property
    def index_maintain_batch(self) -> int:
        """Max promotions (and matching LRU demotions) applied per between-tick
        maintenance pass — bounds the off-query-path scatter work per tick."""
        return max(1, _env_int("PATHWAY_INDEX_MAINTAIN_BATCH", 4096))

    # ---- data-plane audit (observability plane, correctness side) -----------
    @property
    def audit(self) -> str:
        """Data-plane correctness observability: ``on`` (default — invariant
        monitors at operator edges, per-edge cardinality/selectivity gauges,
        sampled shadow audits and the row-lineage rings, gated ≤5% overhead
        like the device plane), ``full`` (additionally verifies every
        consolidated batch is canonical/net-free and shadow-audits every
        tick — investigation mode, ≤10%), or ``off``."""
        raw = os.environ.get("PATHWAY_AUDIT", "on").strip().lower()
        if raw in ("", "1", "true", "yes", "on"):
            return "on"
        if raw in ("0", "false", "no", "off"):
            return "off"
        if raw == "full":
            return "full"
        raise ValueError(f"PATHWAY_AUDIT must be off/on/full, got {raw!r}")

    @property
    def audit_sample(self) -> float:
        """Fraction of TICKS shadow-audited in ``on`` mode (``full`` audits
        every tick). Deterministic tick-hash sampling — the same hash the r8
        trace sampler uses — so every cluster process audits the SAME ticks
        and a divergence is attributable pod-wide."""
        rate = _env_float("PATHWAY_AUDIT_SAMPLE", 0.0625)
        if not 0.0 < rate <= 1.0:
            raise ValueError(
                f"PATHWAY_AUDIT_SAMPLE must be in (0, 1], got {rate}"
            )
        return rate

    @property
    def audit_keys(self) -> int:
        """Per-edge key-multiplicity map bound for the invariant monitors.
        A monitor whose map outgrows this stops folding (one structural
        ``monitor_degraded`` event, never a crash) — the tripwire plane must
        not become the memory leak it guards against."""
        return max(1024, _env_int("PATHWAY_AUDIT_KEYS", 262144))

    @property
    def lineage_keys(self) -> int:
        """Row-lineage provenance ring capacity per operator edge (output
        keys remembered for ``/explain``; each keeps at most 8 contributing
        input keys). 0 disables lineage recording while the audit monitors
        stay live."""
        return max(0, _env_int("PATHWAY_LINEAGE_KEYS", 4096))

    @property
    def flight_dir(self) -> str | None:
        """Post-mortem flight-recorder dump directory: on
        ``terminate_on_error`` aborts, ``OtherWorkerError`` and supervised
        restarts, the bounded ring of recent ticks/device events is written
        there as one JSON file per failure. Unset = no dumps (the ring still
        records)."""
        return os.environ.get("PATHWAY_FLIGHT_DIR") or None

    @property
    def flight_events(self) -> int:
        """Flight-recorder ring capacity (device events; ticks keep a
        quarter-sized ring of their own)."""
        return max(64, _env_int("PATHWAY_FLIGHT_EVENTS", 1024))

    # ---- pod health & SLO plane (observability) -----------------------------
    @property
    def health(self) -> str:
        """Pod health & SLO plane (``observability/health.py``): ``on``
        (default) runs the per-door readiness state machine
        (``/healthz``/``/readyz`` on every door), synthetic canary probes,
        declared-SLO burn-rate evaluation, rule-based detectors and the alert
        registry with incident bundles. ``off`` installs nothing — the
        serving path is byte-identical to the plane never existing."""
        raw = os.environ.get("PATHWAY_HEALTH", "on").strip().lower()
        if raw in ("", "1", "true", "yes", "on"):
            return "on"
        if raw in ("0", "false", "no", "off"):
            return "off"
        raise ValueError(f"PATHWAY_HEALTH must be off/on, got {raw!r}")

    @property
    def health_eval_ms(self) -> int:
        """Interval between SLO/detector evaluator sweeps (burn-rate windows,
        watermark-stall/replica-lag/error-rate/backlog/thrash rules)."""
        return max(50, _env_int("PATHWAY_HEALTH_EVAL_MS", 500))

    @property
    def slo_availability(self) -> float:
        """Pod-wide availability objective in (0, 1): the success-rate target
        the burn-rate rule guards (successes = served responses + passing
        canaries; failures = timeouts + failing canaries). Overridable live
        via ``pw.set_slo(availability=…)``."""
        v = _env_float("PATHWAY_SLO_AVAILABILITY", 0.999)
        if not 0.0 < v < 1.0:
            raise ValueError(
                f"PATHWAY_SLO_AVAILABILITY must be in (0, 1), got {v}"
            )
        return v

    @property
    def slo_p99_ms(self) -> float:
        """Default per-route latency objective: 99% of requests under this
        many milliseconds. 0 (default) declares no latency SLO unless
        ``pw.set_slo(route=…, p99_ms=…)`` does."""
        v = _env_float("PATHWAY_SLO_P99_MS", 0.0)
        if v < 0:
            raise ValueError(f"PATHWAY_SLO_P99_MS must be >= 0, got {v}")
        return v

    @property
    def slo_fast_window_s(self) -> float:
        """Fast burn-rate window (seconds) — catches sudden total breaches."""
        return max(1.0, _env_float("PATHWAY_SLO_FAST_WINDOW_S", 60.0))

    @property
    def slo_slow_window_s(self) -> float:
        """Slow burn-rate window (seconds) — confirms the breach is sustained
        (multi-window rule: an alert needs BOTH windows burning)."""
        return max(1.0, _env_float("PATHWAY_SLO_SLOW_WINDOW_S", 600.0))

    @property
    def slo_burn_fast(self) -> float:
        """Burn-rate threshold for the fast window (1.0 = exactly spending
        the error budget; 14 ≈ the SRE Workbook's page-severity rate)."""
        return max(0.0, _env_float("PATHWAY_SLO_BURN_FAST", 14.0))

    @property
    def slo_burn_slow(self) -> float:
        """Burn-rate threshold for the slow window."""
        return max(0.0, _env_float("PATHWAY_SLO_BURN_SLOW", 2.0))

    @property
    def slo_burn_ticket_fast(self) -> float:
        """Ticket-severity rung of the burn-rate ladder (fast window): a
        breach burning past this but under ``PATHWAY_SLO_BURN_FAST`` files a
        ``ticket`` alert instead of a ``page`` (SRE-workbook multi-window
        multi-burn ladder; 6 ≈ budget gone in ~5 days)."""
        return max(0.0, _env_float("PATHWAY_SLO_BURN_TICKET_FAST", 6.0))

    @property
    def slo_burn_ticket_slow(self) -> float:
        """Ticket-severity rung of the burn-rate ladder (slow window)."""
        return max(0.0, _env_float("PATHWAY_SLO_BURN_TICKET_SLOW", 1.0))

    @property
    def canary_interval_ms(self) -> int:
        """Synthetic canary probe interval per door route (0 disables
        canaries; readiness and detectors stay live)."""
        return max(0, _env_int("PATHWAY_CANARY_INTERVAL_MS", 1000))

    @property
    def canary_timeout_ms(self) -> int:
        """Timeout for one canary probe; a slower door counts as a failed
        canary in the availability SLO."""
        return max(50, _env_int("PATHWAY_CANARY_TIMEOUT_MS", 2000))

    @property
    def incident_dir(self) -> str | None:
        """Incident-bundle directory: each alert activation captures one
        correlated post-mortem JSON (alert, probable-cause stage, per-stage
        p99 decomposition, slowest kept request traces, flight-recorder
        rings, shard-map/membership versions, replica health). Unset = no
        bundles (alerts still fire)."""
        return os.environ.get("PATHWAY_INCIDENT_DIR") or None

    @property
    def alert_webhook(self) -> str | None:
        """Generic webhook notification target: fired alerts POST one JSON
        document each, deduped on (alert, fingerprint) with bounded
        retry/backoff."""
        return os.environ.get("PATHWAY_ALERT_WEBHOOK") or None

    @property
    def alert_slack_channel(self) -> str | None:
        """Slack channel id for alert notifications (needs
        ``PATHWAY_ALERT_SLACK_TOKEN``); same delivery discipline as the
        webhook sink, posting through ``pw.io.slack``'s chat.postMessage."""
        return os.environ.get("PATHWAY_ALERT_SLACK_CHANNEL") or None

    @property
    def alert_slack_token(self) -> str | None:
        """Slack bot token for the alert notification sink."""
        return os.environ.get("PATHWAY_ALERT_SLACK_TOKEN") or None

    @property
    def alert_watermark_stall_s(self) -> float:
        """Watermark-stall detector: an input whose watermark lags this many
        seconds (after ingesting rows) raises ``watermark_stall``."""
        return max(1.0, _env_float("PATHWAY_ALERT_WATERMARK_STALL_S", 120.0))

    @property
    def alert_error_rate(self) -> float:
        """Error-rate-spike detector: fraction of a route's requests failing
        (4xx/timeouts) over the fast window that raises
        ``error_rate_spike``."""
        v = _env_float("PATHWAY_ALERT_ERROR_RATE", 0.10)
        if not 0.0 < v <= 1.0:
            raise ValueError(
                f"PATHWAY_ALERT_ERROR_RATE must be in (0, 1], got {v}"
            )
        return v

    @property
    def alert_backlog_rows(self) -> int:
        """Backlog-growth detector: queued rows past this bound AND rising
        raise ``backlog_growth``."""
        return max(1, _env_int("PATHWAY_ALERT_BACKLOG_ROWS", 100000))

    @property
    def alert_thrash_decisions(self) -> int:
        """Autoscaler-thrash detector: membership version changes within the
        slow window that raise ``autoscaler_thrash``."""
        return max(1, _env_int("PATHWAY_ALERT_THRASH_DECISIONS", 3))

    @property
    def alert_heartbeat_flaps(self) -> int:
        """Heartbeat-flap detector: heartbeat misses accumulating within the
        fast window that raise ``heartbeat_flap``."""
        return max(1, _env_int("PATHWAY_ALERT_HEARTBEAT_FLAPS", 3))

    @property
    def alert_sink_stall_s(self) -> float:
        """Sink-commit-stall detector: a staged-but-unpublished delivery epoch
        older than this many seconds raises ``sink_commit_stall`` (the sink's
        transport keeps failing and output is piling up in the ledger)."""
        return max(1.0, _env_float("PATHWAY_ALERT_SINK_STALL_S", 120.0))

    # ---- pod timeline & bottleneck plane (observability) --------------------
    @property
    def timeline(self) -> str:
        """Pod timeline plane (``observability/timeline.py``): ``on``
        (default) samples every registered gauge/counter delta and histogram
        positional delta on a fixed cadence into bounded in-memory rings,
        piggybacks compressed series summaries on heartbeats so the
        coordinator holds a merged pod timeline, and feeds the bottleneck
        attributor. ``off`` constructs no plane — one flag read on the hot
        path, history and /timeline simply absent."""
        raw = os.environ.get("PATHWAY_TIMELINE", "on").strip().lower()
        if raw in ("", "1", "true", "yes", "on"):
            return "on"
        if raw in ("0", "false", "no", "off"):
            return "off"
        raise ValueError(f"PATHWAY_TIMELINE must be off/on, got {raw!r}")

    @property
    def timeline_window_s(self) -> float:
        """In-memory timeline history retained per process (seconds); older
        points fall off the ring (spilled segment files keep going until
        rotation)."""
        return max(10.0, _env_float("PATHWAY_TIMELINE_WINDOW_S", 600.0))

    @property
    def timeline_step_ms(self) -> int:
        """Timeline sampling cadence (milliseconds between ticks of the
        recorder — each tick captures one delta sample of every probe)."""
        return max(100, _env_int("PATHWAY_TIMELINE_STEP_MS", 1000))

    @property
    def timeline_dir(self) -> str | None:
        """Timeline segment spill directory: each process appends its sampled
        points as rotating OTLP-metrics-JSON lines (r8 file-sink discipline)
        so the history survives a crash alongside the flight recorder. Unset
        = in-memory rings only."""
        return os.environ.get("PATHWAY_TIMELINE_DIR") or None

    @property
    def timeline_rotate_mb(self) -> float:
        """Timeline segment rotation bound (MiB): past this size the live
        segment is renamed to ``.1`` (one rotation generation kept, matching
        the trace file sink)."""
        return max(0.05, _env_float("PATHWAY_TIMELINE_ROTATE_MB", 32.0))

    # ---- exactly-once delivery (r22) ----------------------------------------
    @property
    def delivery(self) -> str:
        """Default delivery mode for sink writers that don't pass an explicit
        ``delivery=``: ``off`` (direct at-least-once writes) or
        ``exactly_once`` (epoch-transactional through the delivery ledger)."""
        v = os.environ.get("PATHWAY_DELIVERY", "off")
        if v not in ("off", "exactly_once"):
            raise ValueError(
                f"PATHWAY_DELIVERY must be 'off' or 'exactly_once', got {v!r}"
            )
        return v

    @property
    def delivery_stage_rows(self) -> int:
        """Rows per staged ledger chunk (the r13 chunk-store discipline:
        bounded put sizes however large one epoch's output gets)."""
        return max(1, _env_int("PATHWAY_DELIVERY_STAGE_ROWS", 65536))

    @property
    def delivery_max_staged_epochs(self) -> int:
        """Backpressure bound on staged-but-unpublished epochs per sink: past
        this depth the run fails rather than staging unbounded output against
        a sink that never accepts it."""
        return max(1, _env_int("PATHWAY_DELIVERY_MAX_STAGED_EPOCHS", 512))

    # ---- helpers ------------------------------------------------------------
    @property
    def total_workers(self) -> int:
        return self.threads * self.processes

    def spawn_env(self, process_id: int) -> dict[str, str]:
        """Env block for a child process of ``pathway_tpu_torch spawn``."""
        env = dict(os.environ)
        env["PATHWAY_THREADS"] = str(self.threads)
        env["PATHWAY_PROCESSES"] = str(self.processes)
        env["PATHWAY_PROCESS_ID"] = str(process_id)
        env["PATHWAY_FIRST_PORT"] = str(self.first_port)
        return env

    def to_dict(self) -> dict[str, Any]:
        return {
            name: getattr(self, name)
            for name in (
                "threads",
                "processes",
                "process_id",
                "first_port",
                "barrier_timeout",
                "heartbeat_interval",
                "heartbeat_timeout",
                "fault_plan",
                "elastic",
                "elastic_min_processes",
                "elastic_max_processes",
                "elastic_high_pressure",
                "elastic_low_pressure",
                "elastic_sustain_ticks",
                "elastic_cooldown_s",
                "persistent_storage",
                "replay_storage",
                "replay_mode",
                "continue_after_replay",
                "terminate_on_error",
                "runtime_typechecking",
                "flow",
                "flow_policy",
                "flow_bulk_min_rows",
                "flow_bulk_max_rows",
                "input_queue_rows",
                "latency_slo_ms",
                "serve_max_inflight",
                "serve_coalesce_ms",
                "serve_coalesce_rows",
                "serve_tick",
                "serve_rate",
                "serve_burst",
                "serve_api_keys",
                "fabric",
                "fabric_port_stride",
                "fabric_max_staleness_ms",
                "fabric_timeout",
                "replica",
                "replica_max_staleness_ms",
                "replica_memo_share",
                "shardmap",
                "shardmap_migration",
                "monitoring_server",
                "profile",
                "index_snapshot",
                "index_hot_rows",
                "audit",
                "audit_sample",
                "lineage_keys",
                "request_trace",
                "request_trace_slow_ms",
                "request_trace_keep",
                "request_trace_kept",
                "flight_dir",
                "health",
                "health_eval_ms",
                "slo_availability",
                "slo_p99_ms",
                "slo_fast_window_s",
                "slo_slow_window_s",
                "slo_burn_fast",
                "slo_burn_slow",
                "slo_burn_ticket_fast",
                "slo_burn_ticket_slow",
                "canary_interval_ms",
                "canary_timeout_ms",
                "incident_dir",
                "alert_webhook",
                "alert_slack_channel",
                "alert_slack_token",
                "alert_watermark_stall_s",
                "alert_error_rate",
                "alert_backlog_rows",
                "alert_thrash_decisions",
                "alert_heartbeat_flaps",
                "alert_sink_stall_s",
                "timeline",
                "timeline_window_s",
                "timeline_step_ms",
                "timeline_dir",
                "timeline_rotate_mb",
                "delivery",
                "delivery_stage_rows",
                "delivery_max_staged_epochs",
                "run_id",
                "engine_phases",
                "device_exchange_fused",
                "arrange_device_cache",
                "arrange_donate",
                "fuse",
                "fuse_jax",
                "fuse_jax_min_rows",
            )
        }


pathway_config = PathwayConfig()


def get_pathway_config() -> PathwayConfig:
    return pathway_config


def set_license_key(key: str | None) -> None:
    """Reference API parity (``pw.set_license_key``) — licensing is not
    replicated (BUSL gating has no TPU-build equivalent); accepted and ignored."""
