"""Standard library (reference ``python/pathway/stdlib/``): indexing, the LSH
bucketers of ``ml``, temporal, ordered, stateful, statistical and utils.
Graphs, the rest of ml and viz are a later slice.
"""

from pathway_tpu_torch.stdlib import (
    indexing,
    ml,
    ordered,
    stateful,
    statistical,
    temporal,
    utils,
)

__all__ = ["indexing", "ml", "ordered", "stateful", "statistical", "temporal", "utils"]
