from .impl import (
    exact_modularity,
    louvain_communities,
    louvain_level,
)

__all__ = ["exact_modularity", "louvain_communities", "louvain_level"]
