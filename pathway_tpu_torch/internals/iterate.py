"""``pw.iterate`` — fixed-point iteration of a dataflow subgraph.

Reference behavior matched: the ``iterate`` API (``internals/common.py:39``), the
argument plumbing of ``IterateOperator`` (``internals/operator.py:316-430`` —
iterated vs. iterated-with-universe vs. extra tables, result-shape preservation),
and the engine fixed-point scope (``src/engine/dataflow.rs:4275-4710``).

Block-engine design (not a translation of differential's ``Variable``): the loop body
is captured once as a *logical* subgraph fed by placeholder feed nodes. The outer
``IterateRunnerNode`` accumulates full input state; whenever it changes at a tick
boundary, a **fresh incremental engine subgraph** is instantiated from the logical
body and driven to quiescence by repeatedly diffing body output against fed input
and pushing only the delta back in — so *within* a tick each fixed-point round
costs O(changed rows). Across outer ticks the fixed point restarts from full input
state (O(state) per changed tick): the conservative-correct choice for
non-monotone input changes (e.g. edge deletions), where an incremental iterate
would need differential's 2-D timestamps to re-derive the interior anyway. Only
the net output-vs-previous delta crosses back into the outer dataflow, so
downstream sees clean retraction semantics no matter how many inner rounds ran.

Carried from ``pathway_tpu/internals/iterate.py``. It is ``pw.iterate`` /
``pw.iterate_universe``, and runs the fixed points of ``stdlib.graphs`` and
``Table.interpolate`` (``stdlib/statistical/_interpolate.py``).
"""

from __future__ import annotations

from typing import Any, Callable, Mapping

import numpy as np

from pathway_tpu_torch.engine import operators as ops
from pathway_tpu_torch.engine.blocks import DeltaBatch, apply_diffs_to_state
from pathway_tpu_torch.engine.graph import SOLO, Node, Scheduler
from pathway_tpu_torch.internals.logical import BuildContext, LogicalNode


class iterate_universe:  # noqa: N801 — matches the reference's lowercase API
    """Marks an iterate argument whose key set may change between iterations
    (reference ``internals/operator.py:359``)."""

    def __init__(self, table: Any):
        self.table = table


class _PortBatch(DeltaBatch):
    """A delta batch tagged with the iterate output it belongs to (the engine
    routes every emission to every consumer; demux nodes filter by tag)."""

    __slots__ = ("port",)


class IterateFeedNode(Node):
    """Placeholder source inside the body subgraph; the runner pushes full-state
    and feedback-delta batches into it between inner rounds."""

    name = "iterate_feed"

    def exchange_key(self, port: int):
        return SOLO

    def __init__(self, columns: list[str], np_dtypes: dict | None = None):
        super().__init__(n_inputs=0)
        self.columns = columns
        self.np_dtypes = np_dtypes or {}
        self._pending: list[DeltaBatch] = []

    def feed(self, batch: DeltaBatch) -> None:
        self._pending.append(batch)

    def poll(self, time: int) -> list[DeltaBatch]:
        pending, self._pending = self._pending, []
        return pending


def _state_delta(
    old: Mapping[int, tuple],
    new: Mapping[int, tuple],
    columns: list[str],
    np_dtypes: dict,
    time: int,
) -> DeltaBatch | None:
    """Retract rows of ``old`` not present (or changed) in ``new``; insert the
    new/changed rows. Returns None when states are identical."""
    keys: list[int] = []
    diffs: list[int] = []
    rows: list[tuple] = []
    for k, row in old.items():
        nrow = new.get(k)
        if nrow is None or _row_differs(row, nrow):
            keys.append(k)
            diffs.append(-1)
            rows.append(row)
    for k, row in new.items():
        orow = old.get(k)
        if orow is None or _row_differs(orow, row):
            keys.append(k)
            diffs.append(1)
            rows.append(row)
    if not keys:
        return None
    return DeltaBatch.from_rows(keys, rows, columns, time, diffs=diffs, np_dtypes=np_dtypes)


def _row_differs(a: tuple, b: tuple) -> bool:
    if len(a) != len(b):
        return True
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            if not np.array_equal(x, y):
                return True
        elif x != y:
            return True
    return False


class IterateRunnerNode(Node):
    """Outer engine node driving the fixed point.

    Inputs arrive as deltas on the outer dataflow; the runner folds them into full
    per-table state, and at frontier time reruns the body to quiescence, emitting
    tagged per-output delta batches consumed by :class:`IterateOutputNode`.
    """

    name = "iterate"

    snapshot_attrs = ("input_state", "emitted")

    def exchange_key(self, port: int):
        return SOLO  # the fixed-point driver is a serial operator

    def __init__(
        self,
        in_names: list[str],
        in_columns: dict[str, list[str]],
        in_np_dtypes: dict[str, dict],
        feed_lnodes: dict[str, LogicalNode],
        output_lnodes: dict[str, LogicalNode],
        out_columns: dict[str, list[str]],
        iteration_limit: int | None,
    ):
        super().__init__(n_inputs=len(in_names))
        self.in_names = in_names
        self.in_columns = in_columns
        self.in_np_dtypes = in_np_dtypes
        self.feed_lnodes = feed_lnodes
        self.output_lnodes = output_lnodes
        self.out_columns = out_columns
        self.iteration_limit = iteration_limit
        self.input_state: dict[str, dict[int, tuple]] = {n: {} for n in in_names}
        self.emitted: dict[str, dict[int, tuple]] = {n: {} for n in output_lnodes}
        self._dirty = False

    def process(self, inputs, time):
        for port, batch in enumerate(inputs):
            if batch is None or batch.is_empty:
                continue
            name = self.in_names[port]
            apply_diffs_to_state(
                self.input_state[name], batch.select_columns(self.in_columns[name])
            )
            self._dirty = True
        return []

    def on_frontier(self, time):
        if not self._dirty:
            return []
        self._dirty = False
        final = self._run_fixed_point()
        out: list[DeltaBatch] = []
        for name, new_state in final.items():
            delta = _state_delta(
                self.emitted[name],
                new_state,
                self.out_columns[name],
                self.in_np_dtypes.get(name, {}),
                time,
            )
            self.emitted[name] = new_state
            if delta is not None:
                tagged = _PortBatch(delta.keys, delta.diffs, delta.data, delta.time)
                tagged.port = name
                out.append(tagged)
        return out

    def _run_fixed_point(self) -> dict[str, dict[int, tuple]]:
        ctx = BuildContext()
        feeds = {n: ctx.resolve(ln) for n, ln in self.feed_lnodes.items()}
        caps: dict[str, ops.CaptureNode] = {}
        for name, lnode in self.output_lnodes.items():
            body_out = ctx.resolve(lnode)
            # normalize column order to the input table's order so captured row
            # tuples align with the feedback/emission column lists
            reorder = ops.SelectColumnsNode(self.out_columns[name])
            ctx.graph.add_node(reorder, [body_out])
            cap = ops.CaptureNode(self.out_columns[name])
            ctx.graph.add_node(cap, [reorder])
            caps[name] = cap
        ctx.finish()
        # transient: this inner graph is rebuilt per fixed-point run, so the
        # fused segments stay off the device tier
        sched = Scheduler(ctx.graph, transient=True)

        fed = {n: dict(self.input_state[n]) for n in self.in_names}
        for n in self.in_names:
            if fed[n]:
                batch = DeltaBatch.from_rows(
                    list(fed[n].keys()),
                    list(fed[n].values()),
                    self.in_columns[n],
                    0,
                    np_dtypes=self.in_np_dtypes.get(n, {}),
                )
                feeds[n].feed(batch)

        round_no = 0
        while True:
            sched.run_tick(round_no)
            round_no += 1  # body has now been applied round_no times
            deltas: dict[str, DeltaBatch] = {}
            for name in self.output_lnodes:
                new_state = dict(caps[name].current)
                delta = _state_delta(
                    fed[name], new_state, self.in_columns[name],
                    self.in_np_dtypes.get(name, {}), round_no,
                )
                if delta is not None:
                    deltas[name] = delta
                    fed[name] = new_state
            if not deltas:
                break  # fixed point
            if self.iteration_limit is not None and round_no >= self.iteration_limit:
                break  # limit reached: do not feed back further
            for name, delta in deltas.items():
                feeds[name].feed(delta)
        return {name: dict(caps[name].current) for name in self.output_lnodes}


class IterateOutputNode(Node):
    """Demux: forwards only the runner's batches tagged with this output name."""

    name = "iterate_out"

    def exchange_key(self, port: int):
        return None

    def __init__(self, port_name: str):
        super().__init__(n_inputs=1)
        self.port_name = port_name

    def accept(self, port: int, batch: DeltaBatch) -> None:
        if getattr(batch, "port", None) == self.port_name:
            super().accept(port, batch)

    def process(self, inputs, time):
        batch = inputs[0]
        if batch is None:
            return []
        return [DeltaBatch(batch.keys, batch.diffs, batch.data, batch.time)]


def iterate(body: Callable, iteration_limit: int | None = None, **tables: Any):
    """Iterate ``body`` to fixed point. ``body`` takes Tables (one per kwarg) and
    returns a single Table, a tuple of Tables, or a dict of Tables; returned tables
    are matched to same-named (or positionally first) kwargs and fed back; kwargs
    absent from the result are loop constants. Returns the same shape as ``body``'s
    result, holding the converged tables."""
    from pathway_tpu_torch.internals.table import Table

    if iteration_limit is not None and iteration_limit < 1:
        raise ValueError("wrong iteration limit")
    if not tables:
        raise ValueError("iterate needs at least one table argument")

    in_tables: dict[str, Table] = {}
    for name, arg in tables.items():
        t = arg.table if isinstance(arg, iterate_universe) else arg
        if not isinstance(t, Table):
            raise TypeError(f"iterate argument {name!r} must be a Table, got {type(t)}")
        in_tables[name] = t

    in_names = list(in_tables)
    in_columns = {n: t.column_names() for n, t in in_tables.items()}
    in_np_dtypes = {n: t.schema.np_dtypes() for n, t in in_tables.items()}

    feed_lnodes: dict[str, LogicalNode] = {}
    body_args: dict[str, Table] = {}
    for name, t in in_tables.items():
        cols = in_columns[name]
        npd = in_np_dtypes[name]
        lnode = LogicalNode(
            lambda cols=cols, npd=npd: IterateFeedNode(cols, npd),
            [],
            name=f"iterate_feed[{name}]",
        )
        feed_lnodes[name] = lnode
        body_args[name] = Table(lnode, in_tables[name].schema)

    raw_result = body(**body_args)

    shape: str
    if isinstance(raw_result, Table):
        shape = "single"
        result_dict = {in_names[0]: raw_result}
    elif isinstance(raw_result, tuple):
        shape = "tuple"
        if len(raw_result) > len(in_names):
            raise ValueError(
                f"iterate body returned {len(raw_result)} tables for "
                f"{len(in_names)} input(s); tuple results match inputs positionally"
            )
        result_dict = {in_names[i]: t for i, t in enumerate(raw_result)}
    elif isinstance(raw_result, dict):
        shape = "dict"
        result_dict = dict(raw_result)
    else:
        raise TypeError(f"iterate body must return Table/tuple/dict, got {type(raw_result)}")

    for name, t in result_dict.items():
        if name not in in_tables:
            raise ValueError(f"iterate body returned unknown table {name!r}")
        if set(t.column_names()) != set(in_columns[name]):
            raise ValueError(
                f"iterate output {name!r} columns {t.column_names()} do not match "
                f"input columns {in_columns[name]}"
            )

    out_columns = {n: in_columns[n] for n in result_dict}
    output_lnodes = {n: t._node for n, t in result_dict.items()}

    runner_lnode = LogicalNode(
        lambda: IterateRunnerNode(
            in_names,
            in_columns,
            in_np_dtypes,
            feed_lnodes,
            output_lnodes,
            out_columns,
            iteration_limit,
        ),
        [in_tables[n]._node for n in in_names],
        name="iterate",
    )

    out_tables: dict[str, Table] = {}
    for name, rt in result_dict.items():
        out_lnode = LogicalNode(
            lambda name=name: IterateOutputNode(name),
            [runner_lnode],
            name=f"iterate_out[{name}]",
        )
        # output columns follow the *input* table order (reference's
        # ``_sort_columns_by_other``); schema comes from the input table
        out_tables[name] = Table(out_lnode, in_tables[name].schema)

    if shape == "single":
        return out_tables[in_names[0]]
    if shape == "tuple":
        return tuple(out_tables[n] for n in result_dict)
    return IterateResult(out_tables)


class IterateResult(dict):
    """Dict of converged tables with attribute access (``result.clustering``),
    matching the reference's ArgTuple result shape."""

    def __getattr__(self, name: str):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None
