"""Logical operator nodes + lowering to the engine graph.

Role of the reference's ``internals/operator.py`` + ``internals/graph_runner/``:
Table methods create ``LogicalNode``s (declarative, lazy — nothing computes until
``pw.run``/``compute_and_print``); lowering walks from requested outputs, instantiates
fresh engine nodes per run (tree-shaking unused operators like
``graph_runner/__init__.py:127,246``), and wires connector drivers into the runtime.
"""

from __future__ import annotations

from typing import Any, Callable

from pathway_tpu_torch.engine.graph import EngineGraph, Node
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.trace import user_frame as _user_frame


class LogicalNode:
    """A lazy operator: ``factory()`` builds a fresh engine node each run."""

    def __init__(
        self,
        factory: Callable[[], Node],
        inputs: list["LogicalNode"],
        name: str = "op",
        runtime_hook: Callable[[Node, Any], None] | None = None,
    ):
        self.factory = factory
        self.inputs = inputs
        self.name = name
        self.runtime_hook = runtime_hook
        self.node_id: int = -1
        # user code provenance for error annotation (reference trace_user_frame)
        self.user_trace = _user_frame()
        G.register(self)

    def __repr__(self) -> str:
        return f"LogicalNode({self.name}#{self.node_id})"

    def _register_as_output(self) -> "LogicalNode":
        G.outputs.append(self)
        return self


#: the BuildContext currently resolving (factories may inspect worker identity
#: for partitioned sources / sharded sinks); builds are single-threaded per
#: runtime so a module global suffices
_CURRENT_BUILD: "BuildContext | None" = None


def current_build() -> "BuildContext | None":
    return _CURRENT_BUILD


class BuildContext:
    def __init__(
        self,
        runtime: Any = None,
        worker_index: int = 0,
        n_workers: int = 1,
        register: Any = None,
        shared_runtime: Any = None,
    ):
        self.graph = EngineGraph()
        self.built: dict[int, Node] = {}
        self.build_order: list[tuple[LogicalNode, Node]] = []
        self.runtime = runtime
        #: the runtime every worker's build may INSPECT (tick cadence /
        #: streaming-vs-static, e.g. microbatch flush deadlines) — distinct
        #: from ``runtime``, which is set only on the primary build because
        #: runtime_hooks (connector registration) must fire once
        self.shared_runtime = shared_runtime if shared_runtime is not None else runtime
        #: which worker this graph copy belongs to / total worker count —
        #: partitioned sources read disjoint partition sets per worker
        #: (reference: partition-per-worker Kafka, worker-architecture.md:36-47)
        self.worker_index = worker_index
        self.n_workers = n_workers
        #: connector registration available to EVERY worker's build (the
        #: runtime hook fires only on the primary build); sharded runtimes
        #: pass their register_connector so per-worker subjects get drivers
        self.register = register
        self.hooks: list[tuple[LogicalNode, Node]] = []

    def resolve(self, lnode: LogicalNode) -> Node:
        global _CURRENT_BUILD
        node = self.built.get(id(lnode))
        if node is not None:
            return node
        engine_inputs = [self.resolve(i) for i in lnode.inputs]
        prev, _CURRENT_BUILD = _CURRENT_BUILD, self
        try:
            node = lnode.factory()
        finally:
            _CURRENT_BUILD = prev
        node.user_trace = lnode.user_trace
        node.name = lnode.name
        self.graph.add_node(node, engine_inputs)
        self.built[id(lnode)] = node
        self.build_order.append((lnode, node))
        if lnode.runtime_hook is not None:
            self.hooks.append((lnode, node))
        return node

    def finish(self) -> None:
        for lnode, node in self.hooks:
            lnode.runtime_hook(node, self.runtime)


def build_engine_graph(outputs: list[LogicalNode], runtime: Any = None) -> BuildContext:
    ctx = BuildContext(
        runtime, register=None if runtime is None else runtime.register_connector
    )
    for out in outputs:
        ctx.resolve(out)
    ctx.finish()
    return ctx
