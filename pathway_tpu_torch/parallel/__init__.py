"""Distribution: logical shard grids, multi-worker sharded execution, the
multi-process cluster.

Carried from ``pathway_tpu/parallel``. The reference distributes by running
the identical dataflow on every worker and exchanging records by key shard
(``src/engine/dataflow/shard.rs``; timely's communication crate over shared
memory/TCP, SURVEY §5.8). Here:

- :mod:`pathway_tpu_torch.parallel.mesh` — a named grid of logical shards,
  each placed on a ``torch.device``, and ``torch.distributed`` initialization
  from ``PATHWAY_PROCESSES/PROCESS_ID/COORDINATOR`` env.
- :mod:`pathway_tpu_torch.parallel.sharded` — the thread-sharded runtime:
  every worker builds the identical engine graph; each node declares its
  partitioning contract (``Node.exchange_key``); blocks are split by key shard
  and routed to the owning worker at exchange edges; ticks advance in
  lockstep (the global frontier).
- :mod:`pathway_tpu_torch.parallel.cluster` — the same contract across
  processes over TCP, with a barrier coordinator on process 0.
- :mod:`pathway_tpu_torch.parallel.device_exchange` /
  :mod:`~pathway_tpu_torch.parallel.device_plane` — the on-device key
  exchange of numeric blocks (``PATHWAY_DEVICE_EXCHANGE``).
"""

from pathway_tpu_torch.parallel.mesh import (
    DeviceMesh,
    device_mesh,
    distributed_initialize,
    shard_of_keys,
)
from pathway_tpu_torch.parallel.sharded import ShardedRuntime

__all__ = [
    "DeviceMesh",
    "ShardedRuntime",
    "device_mesh",
    "distributed_initialize",
    "shard_of_keys",
]
