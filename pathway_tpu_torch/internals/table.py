"""``pw.Table`` — the central user object.

Mirrors the reference's ``python/pathway/internals/table.py`` (~70 methods:
select/filter/groupby/reduce/join*/concat/update_rows/update_cells/with_id_from/
flatten/difference/intersect/restrict/with_universe_of/ix/sort/windowby/...). Methods
are declarative: they create LogicalNodes; nothing computes until ``pw.run`` /
``pw.debug.compute_and_print``. Lowering targets block-oriented engine operators
instead of the reference's per-row differential operators.

Carried from ``pathway_tpu/internals/table.py``. Methods that lower into planes
the port has not carried yet (temporal, sorting, time_ops, statistical,
ordered, deduplicate, gradual broadcast) raise
``NotImplementedError("later slice: <plane>")``.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable

import numpy as np

from pathway_tpu_torch.engine import operators as ops
from pathway_tpu_torch.engine.blocks import DeltaBatch
from pathway_tpu_torch.engine.expression_vm import EvalContext, eval_expr
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import expression as expr_mod
from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals import thisclass
from pathway_tpu_torch.internals.expression import (
    ColumnExpression,
    ColumnReference,
    ReducerExpression,
    TYPE_ENV,
)
from pathway_tpu_torch.internals.keys import row_keys, sequential_keys
from pathway_tpu_torch.internals.later_slice import later_slice
from pathway_tpu_torch.internals.logical import LogicalNode
from pathway_tpu_torch.internals.universe import Universe, solver

_RESERVED = {"id"}


class Table:
    """A (possibly live) keyed table of rows; all operations are lazy."""

    def __init__(
        self,
        node: LogicalNode,
        schema: schema_mod.SchemaMetaclass,
        universe: Universe | None = None,
    ):
        object.__setattr__(self, "_node", node)
        object.__setattr__(self, "_schema", schema)
        object.__setattr__(self, "_universe", universe or Universe())

    # ------------------------------------------------------------- properties

    @property
    def schema(self) -> schema_mod.SchemaMetaclass:
        return self._schema

    @property
    def id(self) -> ColumnReference:
        return ColumnReference(self, "id")

    @property
    def C(self) -> "Table":
        return self

    def column_names(self) -> list[str]:
        return self._schema.column_names()

    def keys(self) -> list[str]:
        return self.column_names()

    def typehints(self) -> dict[str, Any]:
        return self._schema.typehints()

    def __getattr__(self, name: str) -> ColumnReference:
        # allow temporal marker columns (_pw_window etc.) through; other
        # underscore names are internal attributes
        if name.startswith("_") and not name.startswith("_pw_"):
            raise AttributeError(name)
        if name not in self._schema.column_names():
            raise AttributeError(
                f"no column {name!r} in table (has: {self._schema.column_names()})"
            )
        return ColumnReference(self, name)

    def __getitem__(self, name) -> ColumnReference:
        if isinstance(name, ColumnReference):
            name = name.name
        if isinstance(name, list):
            return self.select(*[self[n] for n in name])
        if name == "id":
            return self.id
        if name not in self._schema.column_names():
            raise KeyError(name)
        return ColumnReference(self, name)

    def __iter__(self):
        return iter(self.column_names())

    def __repr__(self) -> str:
        cols = ", ".join(f"{n}" for n in self.column_names())
        return f"<pw.Table ({cols})>"

    # ------------------------------------------------------------- helpers

    def _bind(self, e: Any) -> ColumnExpression:
        return thisclass.bind_expression(expr_mod.wrap(e), self)

    def _named_exprs(self, args: Iterable[Any], kwargs: dict[str, Any]) -> dict[str, ColumnExpression]:
        out: dict[str, ColumnExpression] = {}
        for a in thisclass.expand_args(args, self):
            bound = self._bind(a)
            name = expr_mod.smart_name(bound)
            if name is None:
                raise ValueError(f"positional select args must be column refs, got {a!r}")
            out[name] = bound
        for name, e in kwargs.items():
            if name in _RESERVED:
                raise ValueError(f"column name {name!r} is reserved")
            out[name] = self._bind(e)
        return out

    def _infer_schema(self, exprs: dict[str, ColumnExpression]) -> schema_mod.SchemaMetaclass:
        return schema_mod.schema_from_dtypes({n: e._dtype(TYPE_ENV) for n, e in exprs.items()})

    def pointer_from(self, *args: Any, optional: bool = False, instance: Any = None):
        # args stay unbound: they resolve in the context where the expression is
        # used (``other.select(p=target.pointer_from(pw.this.x))``)
        return expr_mod.PointerExpression(
            self, *[expr_mod.wrap(a) for a in args], optional=optional, instance=instance
        )

    # ------------------------------------------------------------- select family

    def select(self, *args: Any, **kwargs: Any) -> "Table":
        exprs = self._named_exprs(args, kwargs)
        tables = _referenced_tables(exprs.values())
        tables.pop(self, None)
        if not tables:
            schema = self._infer_schema(exprs)
            micro = _microbatch_factory(exprs, self, schema)
            if micro is not None:
                node = LogicalNode(micro, [self._node], name="select_microbatch")
                return Table(node, schema, self._universe)
            program = _compile_program(exprs, self)
            expensive = any(_has_apply(e) for e in exprs.values())
            node = LogicalNode(
                lambda: ops.RowwiseNode(program, expensive=expensive, exprs=exprs),
                [self._node],
                name="select",
            )
            return Table(node, schema, self._universe)
        return _multi_table_select(self, list(tables), exprs, self._infer_schema(exprs))

    def with_columns(self, *args: Any, **kwargs: Any) -> "Table":
        keep = {n: ColumnReference(self, n) for n in self.column_names()}
        new = self._named_exprs(args, kwargs)
        keep.update(new)
        return self.select(**keep)

    def without(self, *columns: Any) -> "Table":
        names = {c.name if isinstance(c, ColumnReference) else c for c in columns}
        remaining = [n for n in self.column_names() if n not in names]
        return self.select(*[ColumnReference(self, n) for n in remaining])

    def rename(self, names_mapping: dict | None = None, **kwargs: Any) -> "Table":
        mapping: dict[str, str] = {}
        if names_mapping:
            for old, new in names_mapping.items():
                old_n = old.name if isinstance(old, ColumnReference) else old
                new_n = new.name if isinstance(new, ColumnReference) else new
                mapping[old_n] = new_n
        for new_n, old in kwargs.items():
            mapping[old.name if isinstance(old, ColumnReference) else old] = new_n
        exprs = {}
        for n in self.column_names():
            exprs[mapping.get(n, n)] = ColumnReference(self, n)
        return self.select(**exprs)

    rename_columns = rename
    rename_by_dict = rename

    def cast_to_types(self, **types: Any) -> "Table":
        exprs: dict[str, ColumnExpression] = {}
        for n in self.column_names():
            if n in types:
                exprs[n] = expr_mod.cast(types[n], ColumnReference(self, n))
            else:
                exprs[n] = ColumnReference(self, n)
        return self.select(**exprs)

    def update_types(self, **types: Any) -> "Table":
        node = LogicalNode(lambda: ops.SelectColumnsNode(self.column_names()), [self._node], name="update_types")
        return Table(node, self._schema.update_types(**types), self._universe)

    def copy(self) -> "Table":
        node = LogicalNode(lambda: ops.SelectColumnsNode(self.column_names()), [self._node], name="copy")
        return Table(node, self._schema, self._universe)

    # ------------------------------------------------------------- filter family

    def filter(self, filter_expression: Any) -> "Table":
        bound = self._bind(filter_expression)
        predicate = _compile_single(bound, self)
        node = LogicalNode(
            lambda: ops.FilterNode(predicate, expr=bound), [self._node], name="filter"
        )
        return Table(node, self._schema, self._universe.subset())

    def split(self, split_expression: Any) -> tuple["Table", "Table"]:
        pos = self.filter(split_expression)
        neg = self.filter(~expr_mod.wrap(split_expression))
        return pos, neg

    # ------------------------------------------------------------- groupby / reduce

    def groupby(
        self,
        *args: Any,
        id: Any = None,  # noqa: A002
        sort_by: Any = None,
        instance: Any = None,
        **kwargs: Any,
    ):
        from pathway_tpu_torch.internals.groupbys import GroupedTable

        grouping = [self._bind(a) for a in args]
        for g in grouping:
            if not isinstance(g, ColumnReference):
                raise ValueError("groupby arguments must be column references")
        return GroupedTable(
            self,
            grouping,
            set_id=self._bind(id) if id is not None else None,
            sort_by=self._bind(sort_by) if sort_by is not None else None,
            instance=self._bind(instance) if instance is not None else None,
        )

    def reduce(self, *args: Any, **kwargs: Any) -> "Table":
        return self.groupby().reduce(*args, **kwargs)

    def deduplicate(
        self,
        *,
        value: Any = None,
        instance: Any = None,
        acceptor: Callable | None = None,
        name: str | None = None,
    ) -> "Table":
        raise later_slice("deduplicate")

    # ------------------------------------------------------------- joins

    def join(self, other: "Table", *on: Any, id: Any = None, how: Any = None, **kw) -> Any:  # noqa: A002
        from pathway_tpu_torch.internals.joins import JoinResult

        mode = how if isinstance(how, str) else (how.value if how is not None else "inner")
        return JoinResult(self, other, on, how=mode or "inner", id_expr=id, **kw)

    def join_inner(self, other: "Table", *on: Any, id: Any = None, **kw) -> Any:  # noqa: A002
        return self.join(other, *on, id=id, how="inner", **kw)

    def join_left(self, other: "Table", *on: Any, id: Any = None, **kw) -> Any:  # noqa: A002
        return self.join(other, *on, id=id, how="left", **kw)

    def join_right(self, other: "Table", *on: Any, id: Any = None, **kw) -> Any:  # noqa: A002
        return self.join(other, *on, id=id, how="right", **kw)

    def join_outer(self, other: "Table", *on: Any, id: Any = None, **kw) -> Any:  # noqa: A002
        return self.join(other, *on, id=id, how="outer", **kw)

    def asof_join(self, other: "Table", t_left: Any, t_right: Any, *on: Any, **kw):
        raise later_slice("temporal")

    def asof_now_join(self, other: "Table", *on: Any, **kw):
        raise later_slice("temporal")

    def ix(self, expression: Any, *, optional: bool = False, context: Any = None) -> "Table":
        """Foreign-key lookup: rows of ``self`` re-pointed through a pointer
        expression into this table (reference ``internals/table.py`` ``ix``)."""
        source = context if context is not None else _table_of(expression)
        if source is None:
            raise ValueError("ix needs a context table (expression has no table)")
        return _ix_impl(self, source, source._bind(expression), optional)

    def ix_ref(self, *args: Any, optional: bool = False, context: Any = None, instance: Any = None) -> "Table":
        source = context
        if source is None:
            raise ValueError("ix_ref requires context=")
        ptr = source.pointer_from(*args, optional=optional, instance=instance)
        return _ix_impl(self, source, ptr, optional)

    def having(self, *indexers: ColumnReference) -> "Table":
        """Filter to rows whose id appears as a value of the given pointer columns
        (reference ``internals/table.py`` having)."""
        out = self
        for indexer in indexers:
            source = _table_of(indexer)
            sel = source.select(ptr=indexer)
            keyset = sel.with_id(sel["ptr"])
            out = out.restrict(keyset, strict=False)
        return out

    # ------------------------------------------------------------- set / universe ops

    def concat(self, *others: "Table") -> "Table":
        return _concat_impl(self, others, reindex=False)

    def concat_reindex(self, *others: "Table") -> "Table":
        return _concat_impl(self, others, reindex=True)

    def update_rows(self, other: "Table") -> "Table":
        if set(other.column_names()) != set(self.column_names()):
            raise ValueError("update_rows requires identical columns")
        cols = self.column_names()
        uni = self._universe.superset()
        solver().register_subset(other._universe, uni)
        return _combine_tables(
            [self, other],
            [ops.SideSpec(required=False), ops.SideSpec(required=False)],
            "update_rows",
            cols,
            {n: self._schema.np_dtypes()[n] for n in cols},
            schema_mod.schema_from_dtypes(
                {n: dt.types_lca(self._schema.dtypes()[n], other._schema.dtypes()[n]) for n in cols}
            ),
            uni,
            name="update_rows",
        )

    def update_cells(self, other: "Table") -> "Table":
        extra = set(other.column_names()) - set(self.column_names())
        if extra:
            raise ValueError(f"update_cells: unknown columns {extra}")
        cols = self.column_names()
        other_cols = other.column_names()
        positions = {n: i for i, n in enumerate(cols)}
        override_positions = [(j, positions[n]) for j, n in enumerate(other_cols)]
        return _combine_tables(
            [self, other],
            [ops.SideSpec(required=True), ops.SideSpec(required=False)],
            "update_cells",
            cols,
            self._schema.np_dtypes(),
            schema_mod.schema_from_dtypes(
                {
                    n: dt.types_lca(self._schema.dtypes()[n], other._schema.dtypes()[n])
                    if n in other_cols
                    else self._schema.dtypes()[n]
                    for n in cols
                }
            ),
            self._universe,
            name="update_cells",
            override_positions=override_positions,
        )

    def restrict(self, other: "Table", strict: bool = True) -> "Table":
        # query_is_subset is reflexive over equal representatives, so the
        # equality case is already covered
        if strict and not solver().query_is_subset(other._universe, self._universe):
            raise ValueError(
                "restrict: the argument's universe is not a known subset of "
                "this table's; use promise_universe_is_subset_of first"
            )
        cols = self.column_names()
        return _combine_tables(
            [self, other],
            [ops.SideSpec(required=True), ops.SideSpec(required=True)],
            "side0",
            cols,
            self._schema.np_dtypes(),
            self._schema,
            other._universe if strict else self._universe.subset(),
            name="restrict",
        )

    def intersect(self, *tables: "Table") -> "Table":
        cols = self.column_names()
        return _combine_tables(
            [self, *tables],
            [ops.SideSpec(required=True)] * (1 + len(tables)),
            "side0",
            cols,
            self._schema.np_dtypes(),
            self._schema,
            self._universe.subset(),
            name="intersect",
        )

    def difference(self, other: "Table") -> "Table":
        cols = self.column_names()
        return _combine_tables(
            [self, other],
            [ops.SideSpec(required=True), ops.SideSpec(required=True, negated=True)],
            "side0",
            cols,
            self._schema.np_dtypes(),
            self._schema,
            self._universe.subset(),
            name="difference",
        )

    def with_universe_of(self, other: "Table") -> "Table":
        solver().register_equal(self._universe, other._universe)
        node = LogicalNode(
            lambda: ops.SelectColumnsNode(self.column_names()), [self._node], name="with_universe_of"
        )
        return Table(node, self._schema, other._universe)

    def promise_universes_are_equal(self, other: "Table") -> "Table":
        solver().register_equal(self._universe, other._universe)
        return self

    def promise_universe_is_subset_of(self, other: "Table") -> "Table":
        solver().register_subset(self._universe, other._universe)
        return self

    def promise_universe_is_equal_to(self, other: "Table") -> "Table":
        solver().register_equal(self._universe, other._universe)
        return self

    def is_subset_of(self, other: "Table") -> bool:
        return solver().query_is_subset(self._universe, other._universe)

    # ------------------------------------------------------------- reindex / flatten

    def with_id_from(self, *args: Any, instance: Any = None) -> "Table":
        exprs = [self._bind(a) for a in args]
        salt = 0 if instance is None else hash(instance) & 0xFFFFFFFF
        key_prog = _compile_key_program(exprs, self, salt)
        node = LogicalNode(lambda: ops.ReindexNode(key_prog), [self._node], name="with_id_from")
        return Table(node, self._schema, Universe())

    def with_id(self, new_id: ColumnReference) -> "Table":
        bound = self._bind(new_id)
        key_prog = _compile_key_program_raw(bound, self)
        node = LogicalNode(lambda: ops.ReindexNode(key_prog), [self._node], name="with_id")
        return Table(node, self._schema, Universe())

    def flatten(self, to_flatten: ColumnReference, *, origin_id: str | None = None) -> "Table":
        bound = self._bind(to_flatten)
        assert isinstance(bound, ColumnReference)
        col = bound.name
        others = [n for n in self.column_names() if n != col]
        if origin_id is not None:
            others = others + ["__origin_id__"]
            base = self.with_columns(**{"__origin_id__": self.id})
        else:
            base = self
        node = LogicalNode(
            lambda: ops.FlattenNode(col, [n for n in others]),
            [base._node],
            name="flatten",
        )
        inner = self._schema.dtypes()[col]
        if isinstance(inner, dt.List):
            flat_dt = inner.wrapped_
        elif isinstance(inner, dt.Tuple) and inner.args:
            flat_dt = inner.args[0]
            for a in inner.args[1:]:
                flat_dt = dt.types_lca(flat_dt, a)
        elif inner == dt.STR:
            flat_dt = dt.STR
        else:
            flat_dt = dt.ANY
        dtypes = {col: flat_dt}
        for n in others:
            dtypes[n] = dt.POINTER if n == "__origin_id__" else self._schema.dtypes()[n]
        out = Table(node, schema_mod.schema_from_dtypes(dtypes), Universe())
        if origin_id is not None:
            out = out.rename(**{origin_id: ColumnReference(out, "__origin_id__")})
        return out

    # ------------------------------------------------------------- sort / temporal

    def sort(self, key: Any, instance: Any = None) -> "Table":
        raise later_slice("sorting")

    def interpolate(self, timestamp: Any, *values: Any, mode: Any = None) -> "Table":
        raise later_slice("statistical")

    def _gradual_broadcast(self, threshold_table, lower_column, value_column, upper_column) -> "Table":
        raise later_slice("gradual_broadcast")

    def diff(self, timestamp: Any, *values: Any, instance: Any = None) -> "Table":
        raise later_slice("ordered")

    def windowby(self, time_expr: Any, *, window: Any, instance: Any = None, behavior: Any = None, **kwargs):
        raise later_slice("temporal")

    def interval_join(self, other, self_time, other_time, interval, *on, how: str = "inner", **kw):
        raise later_slice("temporal")

    def _buffer(self, threshold_column: Any, current_time_column: Any) -> "Table":
        raise later_slice("time_ops")

    def _forget(self, threshold_column: Any, current_time_column: Any, mark_forgetting_records: bool = False) -> "Table":
        raise later_slice("time_ops")

    def _freeze(self, threshold_column: Any, current_time_column: Any) -> "Table":
        raise later_slice("time_ops")

    def _forget_immediately(self) -> "Table":
        raise later_slice("time_ops")

    # ------------------------------------------------------------- error handling

    def remove_errors(self) -> "Table":
        from pathway_tpu_torch.internals.errors import ERROR

        def no_errors(batch: DeltaBatch) -> np.ndarray:
            mask = np.ones(len(batch), dtype=bool)
            for col in batch.data.values():
                if col.dtype == object:
                    mask &= np.fromiter(
                        (v is not ERROR for v in col), dtype=bool, count=len(col)
                    )
            return mask

        node = LogicalNode(lambda: ops.FilterNode(no_errors), [self._node], name="remove_errors")
        return Table(node, self._schema, self._universe.subset())

    def await_futures(self) -> "Table":
        from pathway_tpu_torch.internals.errors import PENDING

        def no_pending(batch: DeltaBatch) -> np.ndarray:
            mask = np.ones(len(batch), dtype=bool)
            for col in batch.data.values():
                if col.dtype == object:
                    mask &= np.fromiter(
                        (v is not PENDING for v in col), dtype=bool, count=len(col)
                    )
            return mask

        node = LogicalNode(lambda: ops.FilterNode(no_pending), [self._node], name="await_futures")
        dtypes = {
            n: (d.wrapped_ if isinstance(d, dt.Future) else d)
            for n, d in self._schema.dtypes().items()
        }
        return Table(node, schema_mod.schema_from_dtypes(dtypes), self._universe.subset())

    # ------------------------------------------------------------- ingress/egress helpers

    def to(self, sink: Any) -> None:
        sink(self)

    def debug(self, name: str) -> "Table":
        from pathway_tpu_torch import debug as debug_mod

        def printer(batch: DeltaBatch, columns: list[str]) -> None:
            for key, diff, row in batch.rows():
                print(f"[{name}] @{batch.time} {'+' if diff > 0 else '-'} {dict(zip(columns, row))}")

        cols = self.column_names()
        LogicalNode(
            lambda: ops.CallbackOutputNode(cols, printer),
            [self._node],
            name=f"debug:{name}",
        )._register_as_output()
        return self

    def _subscribe_node(
        self,
        on_change: Callable | None = None,
        on_time_end: Callable | None = None,
        on_end: Callable | None = None,
        route_by: Callable | None = None,
    ) -> LogicalNode:
        cols = self.column_names()

        def factory() -> ops.SubscribeNode:
            return ops.SubscribeNode(
                cols, on_change, on_time_end, on_end, route_by=route_by
            )

        node = LogicalNode(factory, [self._node], name="subscribe")
        return node

    # static constructors ------------------------------------------------------

    @staticmethod
    def empty(**kwargs: Any) -> "Table":
        schema = schema_mod.schema_from_types(**kwargs)
        return table_from_static_data([], [], schema)

    @staticmethod
    def from_columns(*args: Any, **kwargs: Any) -> "Table":
        """Build a table from column references sharing one universe
        (reference ``internals/table.py`` from_columns)."""
        exprs: dict[str, Any] = {}
        for a in args:
            if not isinstance(a, ColumnReference):
                raise ValueError("from_columns positional args must be column refs")
            exprs[a.name] = a
        exprs.update(kwargs)
        source = None
        for e in exprs.values():
            t = _table_of(expr_mod.wrap(e))
            if t is not None:
                source = t
                break
        if source is None:
            raise ValueError("from_columns needs at least one column reference")
        return source.select(**exprs)


def _table_of(e: Any) -> Table | None:
    if isinstance(e, ColumnReference) and isinstance(e.table, Table):
        return e.table
    if isinstance(e, expr_mod.PointerExpression) and isinstance(e.table, Table):
        return e.table
    for a in e._args() if isinstance(e, ColumnExpression) else ():
        t = _table_of(a)
        if t is not None:
            return t
    return None


# ---------------------------------------------------------------------------- lowering helpers


def _referenced_tables(exprs: Iterable[ColumnExpression]) -> dict[Table, None]:
    """Tables referenced by ``exprs``, in FIRST-REFERENCE order (an ordered
    dict used as an ordered set). Order is load-bearing: the multi-table
    select lowers into a combine whose input PORTS follow this order, and a
    cluster exchanges blocks by (node_index, port) — a ``set`` here ordered
    sides by object address, so two processes of one cluster could build the
    same logical combine with different port assignments and deliver a side's
    rows to the wrong port (observed as a KeyError — or silent column mixups
    when the schemas happen to agree)."""
    out: dict[Table, None] = {}

    def walk(e: ColumnExpression) -> None:
        if isinstance(e, ColumnReference) and isinstance(e.table, Table):
            out.setdefault(e.table)
        if isinstance(e, expr_mod.PointerExpression) and isinstance(e.table, Table):
            pass  # pointer hashing doesn't need the table's data
        for a in e._args():
            walk(a)

    for e in exprs:
        walk(e)
    return out


def _compile_program(
    exprs: dict[str, ColumnExpression], source: Table
) -> Callable[[DeltaBatch], dict[str, np.ndarray]]:
    items = list(exprs.items())

    def program(batch: DeltaBatch) -> dict[str, np.ndarray]:
        def lookup(ref: ColumnReference) -> np.ndarray:
            if ref.name == "id":
                return batch.keys
            return batch.data[ref.name]

        ctx = EvalContext(lookup, len(batch))
        return {name: np.asarray(eval_expr(e, ctx)) for name, e in items}

    return program


def _has_apply(e) -> bool:
    """Does the expression tree contain a python UDF (ApplyExpression family)?"""
    if isinstance(e, expr_mod.ApplyExpression):
        return True
    return any(_has_apply(a) for a in e._args())


def _microbatch_factory(
    exprs: dict[str, ColumnExpression], source: Table, schema: schema_mod.SchemaMetaclass
) -> Callable | None:
    """Engine-node factory for a select whose top-level columns include
    ``is_batched`` UDF calls (``BatchApplyExpression``) — the device UDF path.

    Routed through :class:`~pathway_tpu_torch.engine.operators.MicrobatchApplyNode`
    so rows accumulate ACROSS ticks per UDF and launch as padded power-of-two
    batches (``PATHWAY_MICROBATCH``; ``off`` restores one call per delta
    block). Returns ``None`` — keep the inline RowwiseNode path — when the
    flag is off or no column is a top-level batch apply.
    """
    from pathway_tpu_torch.internals.config import get_pathway_config

    cfg = get_pathway_config()
    mode = cfg.microbatch
    if mode == "off":
        return None
    udf_items = [
        (n, e)
        for n, e in exprs.items()
        if type(e) is expr_mod.BatchApplyExpression and len(e._args())
    ]
    if not udf_items:
        return None
    udf_names = {n for n, _ in udf_items}
    pass_names = [n for n in exprs if n not in udf_names]
    pre_program = _compile_program({n: exprs[n] for n in pass_names}, source)

    def make_args_program(e: expr_mod.BatchApplyExpression):
        arg_exprs = list(e.args_)
        kw_exprs = list(e.kwargs_.values())

        def args_program(batch: DeltaBatch):
            def lookup(ref: ColumnReference) -> np.ndarray:
                if ref.name == "id":
                    return batch.keys
                return batch.data[ref.name]

            ctx = EvalContext(lookup, len(batch))
            return (
                [np.asarray(eval_expr(a, ctx)) for a in arg_exprs],
                [np.asarray(eval_expr(a, ctx)) for a in kw_exprs],
            )

        return args_program

    specs_cfg = []
    for n, e in udf_items:
        udf = getattr(e, "udf", None)
        specs_cfg.append(
            dict(
                name=n,
                args_program=make_args_program(e),
                fn=e.fn,
                kw_names=list(e.kwargs_.keys()),
                propagate_none=e.propagate_none,
                min_bucket=int(getattr(udf, "microbatch_min_bucket", 8)),
                deterministic=bool(e.deterministic),
            )
        )
    max_batch = max(1, min(
        [cfg.microbatch_max_batch]
        + [
            int(getattr(e, "udf").microbatch_max_batch)
            for _, e in udf_items
            if getattr(getattr(e, "udf", None), "microbatch_max_batch", None)
        ]
    ))
    out_columns = list(exprs.keys())
    np_dtypes = schema.np_dtypes()
    node_mode = "pending" if mode == "pending" else "hold"
    flush_ms = cfg.microbatch_flush_ms

    def factory() -> ops.MicrobatchApplyNode:
        from pathway_tpu_torch.internals.logical import current_build

        build = current_build()
        runtime = build.shared_runtime if build is not None else None
        return ops.MicrobatchApplyNode(
            out_columns,
            pass_names,
            pre_program,
            [ops.MicrobatchUdfSpec(**sc) for sc in specs_cfg],
            np_dtypes=np_dtypes,
            mode=node_mode,
            max_batch=max_batch,
            flush_ms=flush_ms,
            runtime=runtime,
        )

    return factory


def _compile_single(e: ColumnExpression, source: Table) -> Callable[[DeltaBatch], np.ndarray]:
    def single(batch: DeltaBatch) -> np.ndarray:
        def lookup(ref: ColumnReference) -> np.ndarray:
            if ref.name == "id":
                return batch.keys
            return batch.data[ref.name]

        return np.asarray(eval_expr(e, EvalContext(lookup, len(batch))))

    return single


def _compile_key_program(
    exprs: list[ColumnExpression], source: Table, salt: int
) -> Callable[[DeltaBatch], np.ndarray]:
    def key_program(batch: DeltaBatch) -> np.ndarray:
        def lookup(ref: ColumnReference) -> np.ndarray:
            if ref.name == "id":
                return batch.keys
            return batch.data[ref.name]

        ctx = EvalContext(lookup, len(batch))
        cols = [np.asarray(eval_expr(e, ctx)) for e in exprs]
        return row_keys(cols, n=len(batch), salt=salt)

    return key_program


def _compile_key_program_raw(e: ColumnExpression, source: Table) -> Callable[[DeltaBatch], np.ndarray]:
    prog = _compile_single(e, source)

    def key_program(batch: DeltaBatch) -> np.ndarray:
        return prog(batch).astype(np.uint64)

    return key_program


def _combine_tables(
    tables: list[Table],
    sides: list[ops.SideSpec],
    mode: str,
    out_columns: list[str],
    np_dtypes: dict,
    schema: schema_mod.SchemaMetaclass,
    universe: Universe,
    name: str,
    override_positions: list[tuple[int, int]] | None = None,
) -> Table:
    side_columns = [t.column_names() for t in tables]
    node = LogicalNode(
        lambda: ops.CombineNode(
            sides, side_columns, mode, out_columns, np_dtypes,
            override_positions=override_positions,
        ),
        [t._node for t in tables],
        name=name,
    )
    return Table(node, schema, universe)


def _multi_table_select(
    base: Table,
    others: list[Table],
    exprs: dict[str, ColumnExpression],
    schema: schema_mod.SchemaMetaclass,
) -> Table:
    """select referencing same-universe sibling tables: align by key, then map."""
    tables = [base, *others]
    for o in others:
        if not (
            solver().query_are_equal(base._universe, o._universe)
            or solver().query_is_subset(base._universe, o._universe)
        ):
            raise ValueError(
                "select references a table with a different universe; use "
                "with_universe_of / restrict first"
            )
    prefixed: list[str] = []
    for i, t in enumerate(tables):
        prefixed.extend(f"__s{i}__{n}" for n in t.column_names())

    aligned = _combine_tables(
        tables,
        [ops.SideSpec(required=True)] * len(tables),
        "concat",
        prefixed,
        {},
        schema_mod.schema_from_dtypes({p: dt.ANY for p in prefixed}),
        base._universe,
        name="align",
    )
    table_index = {id(t): i for i, t in enumerate(tables)}
    items = list(exprs.items())

    def program(batch: DeltaBatch) -> dict[str, np.ndarray]:
        def lookup(ref: ColumnReference) -> np.ndarray:
            if ref.name == "id":
                return batch.keys
            i = table_index.get(id(ref.table), 0)
            return batch.data[f"__s{i}__{ref.name}"]

        ctx = EvalContext(lookup, len(batch))
        return {name: np.asarray(eval_expr(e, ctx)) for name, e in items}

    expensive = any(_has_apply(e) for e in exprs.values())
    node = LogicalNode(
        lambda: ops.RowwiseNode(program, expensive=expensive),
        [aligned._node],
        name="select_multi",
    )
    return Table(node, schema, base._universe)


def _concat_impl(first: Table, others: tuple[Table, ...], reindex: bool) -> Table:
    tables = [first, *others]
    cols = first.column_names()
    for t in others:
        if set(t.column_names()) != set(cols):
            raise ValueError("concat requires identical column sets")
    dtypes: dict[str, dt.DType] = {}
    for n in cols:
        d = first._schema.dtypes()[n]
        for t in others:
            d = dt.types_lca(d, t._schema.dtypes()[n])
        dtypes[n] = d
    salts = list(range(1, len(tables) + 1)) if reindex else None
    node = LogicalNode(
        lambda: ops.ConcatNode(len(tables), cols, salts),
        [t._node for t in tables],
        name="concat",
    )
    return Table(node, schema_mod.schema_from_dtypes(dtypes), Universe())


def _ix_impl(target: Table, source: Table, ptr_expr: ColumnExpression, optional: bool) -> Table:
    """rows of ``source`` keyed as-is, columns fetched from ``target`` by pointer."""
    from pathway_tpu_torch.internals.joins import join_on_key_cols

    return join_on_key_cols(
        left=source,
        right=target,
        left_key_expr=ptr_expr,
        how="left",
        left_id_only=True,
        take_right_only=True,
        universe=source._universe,
    )


def table_from_static_data(
    keys: list[int],
    rows: list[tuple],
    schema: schema_mod.SchemaMetaclass,
) -> Table:
    cols = schema.column_names()
    np_dtypes = schema.np_dtypes()

    def batch_factory(time: int) -> DeltaBatch:
        return DeltaBatch.from_rows(keys, rows, cols, time, np_dtypes=np_dtypes)

    node = LogicalNode(lambda: ops.StaticInputNode(batch_factory), [], name="static_input")
    return Table(node, schema, Universe())


def table_rows_to_static(
    dicts: list[dict[str, Any]],
    schema: schema_mod.SchemaMetaclass,
    explicit_keys: list[int] | None = None,
) -> Table:
    cols = schema.column_names()
    rows = [tuple(d.get(c) for c in cols) for d in dicts]
    pks = schema.primary_key_columns()
    if explicit_keys is not None:
        keys = list(explicit_keys)
    elif pks:
        key_cols = [np.asarray([r[cols.index(pk)] for r in rows], dtype=object) for pk in pks]
        keys = list(row_keys(key_cols, n=len(rows)))
    else:
        keys = list(sequential_keys(0, len(rows)))
    return table_from_static_data([int(k) for k in keys], rows, schema)
