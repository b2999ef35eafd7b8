"""Standard library (reference ``python/pathway/stdlib/``): graphs, indexing,
ml, temporal, ordered, stateful, statistical, utils and viz.
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
    viz,
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
    "viz",
]
