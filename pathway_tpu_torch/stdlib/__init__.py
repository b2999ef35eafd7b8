"""Standard library (reference ``python/pathway/stdlib/``): the indexing
package and the LSH bucketers of ``ml``. Temporal, the rest of ml, graphs,
stateful, ordered, statistical, utils and viz are a later slice.
"""

from pathway_tpu_torch.stdlib import indexing, ml

__all__ = ["indexing", "ml"]
