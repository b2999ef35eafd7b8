"""Deterministic value fingerprints (reference: ``internals/fingerprints.py``).

Used wherever a stable pseudo-random priority is needed (e.g. louvain's
independent-set move selection). Not a cryptographic hash; stable across runs and
workers so multi-worker executions agree.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from pathway_tpu_torch.internals.keys import ref_scalar


def fingerprint(obj: Any, format: str = "u64", seed: int = 0) -> int:  # noqa: A002
    """Deterministic 64-bit fingerprint of a (possibly nested) value."""
    flat = _flatten(obj)
    h = int(ref_scalar(*flat, salt=seed & 0xFFFFFFFF))
    if format == "i64":
        return h - (1 << 64) if h >= (1 << 63) else h
    if format == "u64":
        return h
    raise ValueError(f"unknown fingerprint format {format!r}")


def _flatten(obj: Any) -> list:
    if isinstance(obj, (tuple, list)):
        out: list = []
        for o in obj:
            out.extend(_flatten(o))
            out.append("\x00sep")
        return out
    if isinstance(obj, np.generic):
        return [obj.item()]
    return [obj]
