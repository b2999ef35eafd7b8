from .impl import Dist, DistFromSource, Vertex, bellman_ford

__all__ = ["Dist", "DistFromSource", "Vertex", "bellman_ford"]
