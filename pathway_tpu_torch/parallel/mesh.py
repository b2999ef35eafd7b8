"""Logical shard grids and distributed initialization.

Carried from ``pathway_tpu/parallel/mesh.py``. The reference replaces the
process wiring (``PATHWAY_PROCESSES``/``PATHWAY_PROCESS_ID``/
``PATHWAY_FIRST_PORT`` → timely ``CommunicationConfig::Cluster`` over TCP,
``src/engine/dataflow/config.rs:63-120``) with ``jax.distributed`` and a
``jax.sharding.Mesh`` over the visible device pool. The port's counterparts:

- :func:`distributed_initialize` sets up ``torch.distributed`` from the same
  env (NCCL when every rank has a card of its own, gloo otherwise);
- :func:`device_mesh` returns a :class:`DeviceMesh`, a named grid of
  *logical* shards, each placed on a ``torch.device``. Shards may share a
  device: one card (or the CPU) then holds every shard, which is the port's
  counterpart of the reference's virtual 8-device CPU pool.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from pathway_tpu_torch.internals.keys import SHARD_MASK  # noqa: F401  (re-export)
from pathway_tpu_torch.internals.keys import shard_of_keys as _shard_of_keys


def shard_of_keys(keys: np.ndarray, n_shards: int, shard_map=None) -> np.ndarray:
    """Worker assignment for row keys — delegates to the single authority in
    ``internals/keys.shard_of_keys`` (low shard bits modulo the worker count,
    reference ``shard.rs:15-20``; or the versioned shard map's segment table
    when one is active)."""
    return _shard_of_keys(keys, n_shards, shard_map=shard_map)


def distributed_initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Initialize ``torch.distributed`` from args or PATHWAY_* env (no-op for
    a single process, as in the reference).

    Env: ``PATHWAY_PROCESSES`` (world size), ``PATHWAY_PROCESS_ID`` (rank),
    ``PATHWAY_COORDINATOR`` (host:port; default 127.0.0.1:FIRST_PORT). The
    backend is NCCL when every rank has a card of its own and gloo otherwise
    (several ranks sharing one card, or the CPU)."""
    import torch.distributed as dist

    from pathway_tpu_torch.internals.config import get_pathway_config

    cfg = get_pathway_config()
    num_processes = num_processes or cfg.processes
    if num_processes <= 1:
        return
    process_id = process_id if process_id is not None else cfg.process_id
    coordinator_address = coordinator_address or os.environ.get(
        "PATHWAY_COORDINATOR", f"127.0.0.1:{cfg.first_port}"
    )
    own_card = torch.cuda.is_available() and torch.cuda.device_count() >= num_processes
    backend = "nccl" if own_card else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(
        backend,
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes,
        rank=process_id,
    )


class DeviceMesh:
    """A named grid of logical shards, each placed on a ``torch.device``
    (``devices`` is an object array of that grid's shape). The reference's
    ``Mesh`` is a grid of physical devices; here several shards may share one
    device."""

    def __init__(self, devices, axis_names: tuple[str, ...]):
        grid = np.empty(np.shape(devices), dtype=object)
        flat = grid.reshape(-1)
        for i, d in enumerate(np.asarray(devices, dtype=object).reshape(-1)):
            flat[i] = torch.device(d)
        if grid.ndim != len(axis_names):
            raise ValueError(f"mesh of rank {grid.ndim} needs {grid.ndim} axis names, got {axis_names}")
        self.devices = grid
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def shard_devices(self, axis: str) -> list[torch.device]:
        """The device of each shard along ``axis`` (a 1-D mesh's shards)."""
        if self.devices.ndim != 1 or self.axis_names != (axis,):
            raise ValueError(f"need a 1-D mesh over {axis!r}, have {self.shape}")
        return list(self.devices)

    def __repr__(self) -> str:
        return f"DeviceMesh({self.shape}, devices={sorted({str(d) for d in self.devices.flat})})"


def device_mesh(
    axis_shapes: dict[str, int] | None = None, devices=None, n_shards: int | None = None
) -> DeviceMesh:
    """Build a named :class:`DeviceMesh` of logical shards.

    ``devices`` lists one device per shard (repeats allowed); without it the
    shards are spread round-robin over the visible cards, or all placed on the
    CPU where there is none. Default: a 1-D ``("data",)`` mesh over
    ``n_shards`` shards (default: one per visible card, or 8 on the CPU, as
    the reference's tests see 8 virtual devices). Pass e.g.
    ``{"data": 4, "model": 2}`` for a 2-D dp×tp layout."""
    if axis_shapes:
        n = int(np.prod(tuple(axis_shapes.values())))
    elif devices is not None:
        n = len(devices)
    else:
        n = n_shards or (torch.cuda.device_count() if torch.cuda.is_available() else 8)
    if devices is None:
        if torch.cuda.is_available():
            cards = torch.cuda.device_count()
            devices = [torch.device("cuda", i % cards) for i in range(n)]
        else:
            devices = [torch.device("cpu")] * n
    devices = list(devices)
    if not axis_shapes:
        return DeviceMesh(np.array(devices, dtype=object), ("data",))
    names = tuple(axis_shapes.keys())
    shape = tuple(axis_shapes.values())
    if n != len(devices):
        raise ValueError(f"mesh shape {shape} needs {n} shards, have {len(devices)}")
    return DeviceMesh(np.array(devices, dtype=object).reshape(shape), names)
