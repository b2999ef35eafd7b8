"""Standard library (reference ``python/pathway/stdlib/``): the indexing
package. Temporal, ml, graphs, stateful, ordered, statistical, utils and viz
are a later slice.
"""

from pathway_tpu_torch.stdlib import indexing

__all__ = ["indexing"]
