"""Production on-device exchange plane for the sharded runtimes.

Carried from ``pathway_tpu/parallel/device_plane.py``. The reference's
production exchange is timely's channel fabric — shared memory between
threads, TCP between processes
(``external/timely-dataflow/communication/src/networking.rs``, configured at
``src/engine/dataflow/config.rs:63-120``). This module makes the on-device
key exchange (``device_exchange.exchange_by_key``) an engine exchange path:

- ``ShardedRuntime._route`` stages eligible key-exchange batches here instead
  of splitting them on host; at the end of every sweep round the runtime
  flushes — all staged rows ride ONE exchange per (consumer, dtype-layout)
  group and land in the destination workers' input buffers.
- Eligibility = every column is fixed-width (numeric / bool / datetime);
  object columns (strings, Json) fall back to the host plane per batch.
  8-byte values (int64/float64/datetime64/uint64 keys) are transported as
  (hi, lo) uint32 pairs, so float bits survive exactly.
- ``mode="auto"`` engages under the reference's conditions: a card for every
  worker and blocks of at least ``PATHWAY_DEVICE_EXCHANGE_MIN_ROWS`` rows (on
  one card with several workers it keeps the host plane, as the reference
  does on one chip); ``"on"`` forces every eligible batch through the device
  plane, the workers' shards sharing the device when there are fewer cards
  than workers (the byte-identity suites run this way); ``"off"`` disables
  it. Under ``"on"`` a failure to build the shard grid, stage or exchange
  raises: nothing falls back to the host plane without saying so.

The exchange is issued by the tick-coordinating thread. Cross-process rows
take the cluster's TCP links (:class:`ClusterDevicePlane`), as in the
reference, whose device exchange stays within one process's mesh.
"""

from __future__ import annotations

import threading
from typing import Any

import numpy as np

from pathway_tpu_torch.engine.blocks import DeltaBatch

#: numpy dtype kinds transportable as dense device tensors
_FIXED_KINDS = frozenset("iufbMm")


def _encode_col(arr: np.ndarray) -> tuple[list[np.ndarray], tuple]:
    """Column → device-safe parts. 8-byte dtypes become (hi, lo) uint32 pairs
    (bit-exact under disabled x64); narrower dtypes pass through."""
    if arr.dtype.itemsize == 8:
        u = np.ascontiguousarray(arr).view(np.uint64)
        return (
            [(u >> np.uint64(32)).astype(np.uint32), (u & np.uint64(0xFFFFFFFF)).astype(np.uint32)],
            ("u64", arr.dtype),
        )
    return [arr], ("raw", arr.dtype)


def _decode_col(parts: list[np.ndarray], meta: tuple) -> np.ndarray:
    tag, dtype = meta
    if tag == "u64":
        hi, lo = parts
        u = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
        return u.view(dtype)
    return parts[0].astype(dtype, copy=False)


class DeviceExchangePlane:
    """Stages key-exchange batches and flushes them through one exchange
    per group at sweep-round boundaries."""

    def __init__(self, n_workers: int, force: bool = False, min_rows: int = 4096):
        self.n_workers = n_workers
        self.force = force
        self.min_rows = min_rows
        self.axis = "data"
        self.mesh = None
        self._unavailable = False
        self._lock = threading.Lock()
        # (consumer_index, port) -> [(src_worker, route_keys u64, batch)]
        self._staged: dict[tuple[int, int], list[tuple[int, np.ndarray, DeltaBatch]]] = {}
        # bench counters
        self.rows_exchanged = 0
        self.collectives = 0
        self.rows_netted = 0  # rows removed by fused on-device consolidation

    # ------------------------------------------------------------ eligibility
    def available(self) -> bool:
        if self._unavailable:
            return False
        if self.mesh is None:
            with self._lock:
                if self.mesh is not None:
                    return True
                if self._unavailable:
                    return False
                import torch

                from pathway_tpu_torch.parallel.mesh import device_mesh

                cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
                if not self.force:
                    # auto: a card for every worker, as the reference asks a
                    # device for every worker
                    if cards < self.n_workers:
                        self._unavailable = True
                        return False
                # forced: shards share the card(s), or the CPU without one;
                # a failure here raises (no silent host fall-back under "on")
                self.mesh = device_mesh(n_shards=self.n_workers)
        return True

    def _on_accelerator(self) -> bool:
        return self.mesh is not None and self.mesh.devices.flat[0].type != "cpu"

    @staticmethod
    def eligible(batch: DeltaBatch) -> bool:
        return all(c.dtype.kind in _FIXED_KINDS for c in batch.data.values())

    def _fused_active(self) -> bool:
        """Fused consolidate+exchange (PATHWAY_DEVICE_EXCHANGE_FUSED): keyed
        deltas are digest-netted in the same launch that re-shards them.
        ``auto`` engages on real accelerator meshes only (on the CPU mesh the
        extra device sort is a measured negative, like the exchange itself);
        ``on`` forces it for byte-identity suites."""
        from pathway_tpu_torch.internals.config import get_pathway_config

        mode = get_pathway_config().device_exchange_fused
        if mode == "off":
            return False
        if mode == "on":
            return True
        return self._on_accelerator()

    def should_stage(self, batch: DeltaBatch) -> bool:
        if not self.available() or not self.eligible(batch):
            return False
        if self.force:
            return True
        # auto engages only on accelerator shards: on the CPU the exchange
        # loses to the host plane's zero-copy hand-off
        if not self._on_accelerator():
            return False
        return len(batch) >= self.min_rows

    # ---------------------------------------------------------------- staging
    def stage(
        self, consumer: int, port: int, src_worker: int, route_keys: np.ndarray, batch: DeltaBatch
    ) -> None:
        with self._lock:
            self._staged.setdefault((consumer, port), []).append(
                (src_worker, route_keys, batch)
            )

    # ----------------------------------------------------------------- flush
    def flush(self, deliver, time: int) -> bool:
        """Exchange every staged group; ``deliver(worker, consumer, port,
        batch)`` lands each output block. Returns True if any rows moved."""
        with self._lock:
            staged, self._staged = self._staged, {}
        if not staged:
            return False
        moved = False
        for (ci, port) in sorted(staged):
            entries = [(w, rk, b, None) for (w, rk, b) in staged[(ci, port)]]
            if self._exchange_groups(ci, port, entries, time, deliver):
                moved = True
        return moved

    def _exchange_groups(self, ci: int, port: int, entries: list, time: int, deliver) -> bool:
        """Split by column layout (one collective per identical signature —
        int vs float layouts can differ between producers) and exchange."""
        groups: dict[tuple, list] = {}
        for e in entries:
            sig = tuple((n, c.dtype.str) for n, c in e[2].data.items())
            groups.setdefault(sig, []).append(e)
        moved = False
        for sig in sorted(groups):
            if self._exchange_group(ci, port, groups[sig], time, deliver):
                moved = True
        return moved

    def _exchange_group(self, ci: int, port: int, entries: list, time: int, deliver) -> bool:
        from pathway_tpu_torch.observability import engine_phases as _phases

        tok = _phases.start()
        try:
            return self._exchange_group_impl(ci, port, entries, time, deliver)
        finally:
            _phases.stop(tok, "exchange")

    def _exchange_group_impl(self, ci: int, port: int, entries: list, time: int, deliver) -> bool:
        """One collective. ``entries`` = (mesh_slot, route_keys, batch,
        dest|None); dest (int32 local device indices) overrides key-shard
        routing — the cluster plane maps global shards to local slots."""
        from pathway_tpu_torch.parallel.device_exchange import exchange_by_key_shards

        n = self.n_workers
        per_worker: list[list[tuple[np.ndarray, DeltaBatch, Any]]] = [[] for _ in range(n)]
        with_dest = False
        for w, rk, b, dest in entries:
            per_worker[w].append((rk, b, dest))
            with_dest = with_dest or dest is not None
        counts = [sum(len(b) for _, b, _ in lst) for lst in per_worker]
        total = sum(counts)
        if total == 0:
            return False
        # pow2 capacity buckets keep the jit cache small
        cap = max(8, 1 << (max(counts) - 1).bit_length())

        template = entries[0][2]
        col_names = list(template.data.keys())
        col_meta: list[tuple] = []
        # global staging arrays: worker w's rows occupy [w*cap, w*cap+counts[w]).
        # Only `valid` needs zeroing — invalid slots of the others are masked
        # out at decode, so np.empty skips ~MBs of memset per flush
        fused = self._fused_active()
        route = np.empty(n * cap, dtype=np.uint64)
        diffs = np.empty(n * cap, dtype=np.int32)
        valid = np.zeros(n * cap, dtype=bool)
        keys = np.empty(n * cap, dtype=np.uint64)
        dig = np.empty(n * cap, dtype=np.uint64) if fused else None
        dest_buf = np.empty(n * cap, dtype=np.int32) if with_dest else None
        col_bufs: list[np.ndarray] = []
        for name in col_names:
            dtype = template.data[name].dtype
            parts, meta = _encode_col(np.zeros(0, dtype=dtype))
            col_meta.append(meta)
            for p in parts:
                col_bufs.append(np.empty(n * cap, dtype=p.dtype))
        for w, lst in enumerate(per_worker):
            ofs = w * cap
            for rk, b, dest in lst:
                m = len(b)
                route[ofs : ofs + m] = rk
                diffs[ofs : ofs + m] = b.diffs
                keys[ofs : ofs + m] = b.keys
                valid[ofs : ofs + m] = True
                if fused:
                    dig[ofs : ofs + m] = b.row_digest()
                if with_dest:
                    dest_buf[ofs : ofs + m] = dest
                bi = 0
                for name in col_names:
                    parts, _meta = _encode_col(b.data[name])
                    for p in parts:
                        col_bufs[bi][ofs : ofs + m] = p
                        bi += 1
                ofs += m

        from pathway_tpu_torch.parallel.device_exchange import split_keys_u64

        key_parts, _ = _encode_col(keys)
        payload = key_parts + col_bufs
        per_shard = exchange_by_key_shards(
            self.mesh, self.axis, split_keys_u64(route), diffs, payload, valid,
            dest=dest_buf,
            dig=split_keys_u64(dig) if fused else None,
        )
        self.collectives += 1
        self.rows_exchanged += total

        moved = False
        kept = 0
        for d, (_keys, out_diffs, out_valid, out_cols) in enumerate(per_shard):
            mask = out_valid.cpu().numpy()
            if not mask.any():
                continue
            kept += int(mask.sum())
            cols = [c.cpu().numpy()[mask] for c in out_cols]
            dk = _decode_col([cols[0], cols[1]], ("u64", np.dtype(np.uint64)))
            data: dict[str, np.ndarray] = {}
            bi = 2
            for name, meta in zip(col_names, col_meta):
                n_parts = 2 if meta[0] == "u64" else 1
                parts = cols[bi : bi + n_parts]
                bi += n_parts
                data[name] = _decode_col(parts, meta)
            batch = DeltaBatch(dk, out_diffs.cpu().numpy()[mask].astype(np.int64), data, time)
            deliver(d, ci, port, batch)
            moved = True
        if fused:
            self.rows_netted += total - kept
        return moved


class ClusterDevicePlane(DeviceExchangePlane):
    """Cluster variant — the ICI/DCN split of SURVEY §5.8: rows whose key
    shard lives on THIS process ride the process-local mesh (one collective
    with explicit destinations), rows owned by other processes take the
    host TCP links. The shard grid spans the process's local workers;
    cross-process device exchange is out of scope, as in the reference."""

    def __init__(
        self,
        n_workers_global: int,
        threads: int,
        pid: int,
        force: bool = False,
        min_rows: int = 4096,
    ):
        super().__init__(threads, force=force, min_rows=min_rows)
        self.n_global = n_workers_global
        self.threads = threads
        self.pid = pid
        # versioned shard map (PATHWAY_SHARDMAP): set by ClusterRuntime.run();
        # None keeps the modulo rule. Destinations are always computed
        # host-side here and passed explicitly, so the in-kernel modulo never
        # re-derives ownership on this path.
        self.shard_map = None

    def flush(self, deliver, time: int) -> bool:
        """``deliver(global_worker, consumer, port, batch)`` — the cluster's
        ``_deliver``, which lands locally or sends over the peer link."""
        from pathway_tpu_torch.parallel.mesh import shard_of_keys

        with self._lock:
            staged, self._staged = self._staged, {}
        if not staged:
            return False
        moved = False
        lo = self.pid * self.threads
        hi = lo + self.threads
        for (ci, port) in sorted(staged):
            local_entries = []
            for (w_global, rk, b) in staged[(ci, port)]:
                shards = shard_of_keys(rk, self.n_global, shard_map=self.shard_map)
                remote = (shards < lo) | (shards >= hi)
                if remote.any():
                    for dest_w in np.unique(shards[remote]):
                        idx = np.flatnonzero(shards == dest_w)
                        deliver(int(dest_w), ci, port, b.take(idx))
                        moved = True
                keep = np.flatnonzero(~remote)
                if len(keep):
                    local_entries.append(
                        (
                            w_global - lo,
                            rk[keep],
                            b.take(keep),
                            (shards[keep] - lo).astype(np.int32),
                        )
                    )
            if local_entries:

                def deliver_local(slot, ci_, port_, batch, _lo=lo):
                    deliver(_lo + slot, ci_, port_, batch)

                if self._exchange_groups(ci, port, local_entries, time, deliver_local):
                    moved = True
        return moved


def make_device_plane(n_workers: int) -> DeviceExchangePlane | None:
    """Flag-gated factory (``PATHWAY_DEVICE_EXCHANGE`` = off | auto | on)."""
    from pathway_tpu_torch.internals.config import get_pathway_config

    cfg = get_pathway_config()
    mode = cfg.device_exchange
    if mode == "off" or n_workers < 2:
        return None
    return DeviceExchangePlane(
        n_workers, force=(mode == "on"), min_rows=cfg.device_exchange_min_rows
    )


def make_cluster_device_plane(
    n_workers_global: int, threads: int, pid: int
) -> ClusterDevicePlane | None:
    from pathway_tpu_torch.internals.config import get_pathway_config

    cfg = get_pathway_config()
    mode = cfg.device_exchange
    if mode == "off" or threads < 2:
        return None
    return ClusterDevicePlane(
        n_workers_global,
        threads,
        pid,
        force=(mode == "on"),
        min_rows=cfg.device_exchange_min_rows,
    )
