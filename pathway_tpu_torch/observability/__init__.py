"""Observability: the per-phase attribution of the engine's tick
(``engine_phases``). The reference's other planes (live tracing, metrics,
audit, lineage, requests, device profiling, health) are a later slice.
"""
