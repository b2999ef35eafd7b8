"""The serving fabric's front-door protection (reference ``pathway_tpu/fabric``).

Only ``limits`` is carried: the per-route token bucket and API-key guard that
every REST door runs before admission, which work without a cluster. The rest
of the fabric (routing, replicas, index replicas, transport, the shard-map
doors) is ROADMAP Queue 1 item 7; a call that needs it raises
``later_slice("fabric...")``.
"""

from __future__ import annotations

from pathway_tpu_torch.fabric import limits
from pathway_tpu_torch.fabric.limits import ApiKeyGuard, TokenBucket

__all__ = ["ApiKeyGuard", "TokenBucket", "limits"]
