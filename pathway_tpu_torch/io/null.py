"""Null sink (reference: ``python/pathway/io/null`` / Rust NullWriter) — forces
materialization without writing anywhere."""

from __future__ import annotations

from pathway_tpu_torch.engine import operators as ops
from pathway_tpu_torch.internals.logical import LogicalNode


def write(table) -> None:
    cols = table.column_names()
    LogicalNode(
        lambda: ops.CallbackOutputNode(cols, lambda batch, columns: None),
        [table._node],
        name="null_write",
    )._register_as_output()
