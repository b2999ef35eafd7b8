"""Observability: the per-phase attribution of the engine's tick
(``engine_phases``) and the latency histogram of the REST serving plane
(``metrics``). The reference's other planes (live tracing, audit, lineage,
requests, device profiling, health) are a later slice.
"""
