from .impl import Result, pagerank

__all__ = ["Result", "pagerank"]
