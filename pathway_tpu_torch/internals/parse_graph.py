"""Global declarative graph registry.

Mirrors the reference's ``internals/parse_graph.py`` (global mutable ``ParseGraph G``
with node-id sequence, scope stack for ``iterate``, error-log stack and statistics).
Nodes here are the logical operators created by Table methods; ``pw.run()`` walks
from requested outputs and instantiates the engine dataflow.
"""

from __future__ import annotations

import itertools
from collections import Counter
from typing import TYPE_CHECKING, Any

if TYPE_CHECKING:
    from pathway_tpu_torch.internals.logical import LogicalNode


#: monotone graph generation, bumped by every ``G.clear()`` — registries
#: that outlive the graph (REST route states, served-table stores) stamp it
#: at definition time so a later run can tell current entries from leftovers
_GENERATION = itertools.count()


class ParseGraph:
    def __init__(self) -> None:
        self.generation = next(_GENERATION)
        self.node_seq = itertools.count()
        self.nodes: list["LogicalNode"] = []
        self.outputs: list[Any] = []  # output/subscribe logical nodes
        self.error_log_tables: list[Any] = []
        self.cache: dict[Any, Any] = {}

    def register(self, node: "LogicalNode") -> "LogicalNode":
        node.node_id = next(self.node_seq)
        self.nodes.append(node)
        return node

    def register_output(self, node: "LogicalNode") -> "LogicalNode":
        self.register(node)
        self.outputs.append(node)
        return node

    def clear(self) -> None:
        self.__init__()
        # the error log is scoped to the graph (reference: per-graph log
        # streams, parse_graph.py:183-238)
        from pathway_tpu_torch.internals import error_log

        error_log.clear()

    def statistics(self) -> dict[str, int]:
        return dict(Counter(type(n).__name__ for n in self.nodes))


G = ParseGraph()
