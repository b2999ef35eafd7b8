"""Shared dependency-gate helper for connectors whose client libraries are
optional (carried from ``pathway_tpu/io/_gated.py``; deltalake and iceberg are
implemented against their open formats, gdrive against an injectable
transport). Each gated module keeps the reference's call signature and
raises a clear NotImplementedError."""

from __future__ import annotations


def gate(connector: str, requirement: str):
    def _raise(*args, **kwargs):
        raise NotImplementedError(
            f"pw.io.{connector} requires {requirement}, which is not available in "
            "this environment"
        )

    return _raise
