"""Standard library (reference ``python/pathway/stdlib/``): graphs, indexing,
ml, temporal, ordered, stateful, statistical and utils. ``viz`` is a later
slice.
"""

from pathway_tpu_torch.stdlib import (
    graphs,
    indexing,
    ml,
    ordered,
    stateful,
    statistical,
    temporal,
    utils,
)

__all__ = [
    "graphs",
    "indexing",
    "ml",
    "ordered",
    "stateful",
    "statistical",
    "temporal",
    "utils",
]
