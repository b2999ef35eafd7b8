"""Shared xpack helpers."""

from __future__ import annotations

import importlib


def require(module: str, cls: str):
    """Import-gate for optional client libraries (handles dotted names)."""
    try:
        return importlib.import_module(module)
    except ImportError as e:
        raise ImportError(
            f"{cls} requires the `{module}` package, which is not available in "
            f"this environment"
        ) from e
