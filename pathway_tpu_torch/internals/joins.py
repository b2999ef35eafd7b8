"""Declarative joins.

Mirrors the reference's ``internals/joins.py`` (join desugaring incl. outer-join
universe logic at ``internals/joins.py:135,1105``): equality conditions between
``pw.left``/``pw.right`` expressions become a shared join-key hash materialized on
both sides; the engine JoinNode does the incremental symmetric hash join; ``select``
over the result rewrites left/right references onto the joined block's prefixed
columns. Join row ids derive from both side ids (``id=pw.left.id`` keeps left ids,
used by asof_now/ix-style lookups).
"""

from __future__ import annotations

from typing import Any


from pathway_tpu_torch.engine import operators as ops
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import expression as expr_mod
from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals import thisclass
from pathway_tpu_torch.internals.expression import (
    TYPE_ENV,
    BinOpExpression,
    ColumnExpression,
    ColumnReference,
)
from pathway_tpu_torch.internals.logical import LogicalNode
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.internals.universe import Universe


class JoinResult:
    """Lazy join; call ``.select``/``.reduce`` to materialize columns."""

    def __init__(
        self,
        left: Table,
        right: Table,
        on: tuple,
        how: str = "inner",
        id_expr: Any = None,
        left_instance: Any = None,
        right_instance: Any = None,
        exact_match: bool = False,
    ):
        self.left = left
        self.right = right
        self.how = how
        self.id_expr = id_expr
        self.left_on: list[ColumnExpression] = []
        self.right_on: list[ColumnExpression] = []
        for cond in on:
            l_e, r_e = split_join_condition(cond, left, right)
            self.left_on.append(l_e)
            self.right_on.append(r_e)
        if left_instance is not None:
            self.left_on.append(thisclass.bind_expression(expr_mod.wrap(left_instance), left))
            self.right_on.append(thisclass.bind_expression(expr_mod.wrap(right_instance), right))
        self._joined: Table | None = None

    # -------------------------------------------------------------- lowering

    def _materialize(self) -> Table:
        if self._joined is not None:
            return self._joined
        left, right = self.left, self.right
        left_id_only = False
        if self.id_expr is not None:
            bound = thisclass.bind_expression(
                expr_mod.wrap(self.id_expr), left, left, right
            )
            if isinstance(bound, ColumnReference) and bound.name == "id" and bound.table is left:
                left_id_only = True

        l_cols = left.column_names()
        r_cols = right.column_names()
        # empty `on` = cross join (reference: statistics-style joins against a
        # 1-row aggregate); PointerExpression with no args would key per row
        l_jk = expr_mod.PointerExpression(left, *self.left_on) if self.left_on else 0
        r_jk = expr_mod.PointerExpression(right, *self.right_on) if self.right_on else 0
        pre_l = left.select(
            **{f"__v_{n}": left[n] for n in l_cols},
            __jk__=l_jk,
        )
        pre_r = right.select(
            **{f"__v_{n}": right[n] for n in r_cols},
            __jk__=r_jk,
        )
        out_columns = (
            ["__left_id__", "__right_id__"]
            + [f"__l__{n}" for n in l_cols]
            + [f"__r__{n}" for n in r_cols]
        )
        how = self.how
        l_opt = how in ("right", "outer")
        r_opt = how in ("left", "outer")
        dtypes: dict[str, dt.DType] = {
            "__left_id__": dt.Optional(dt.POINTER) if l_opt else dt.POINTER,
            "__right_id__": dt.Optional(dt.POINTER) if r_opt else dt.POINTER,
        }
        for n in l_cols:
            d = left._schema.dtypes()[n]
            dtypes[f"__l__{n}"] = dt.Optional(d) if l_opt else d
        for n in r_cols:
            d = right._schema.dtypes()[n]
            dtypes[f"__r__{n}"] = dt.Optional(d) if r_opt else d
        node = LogicalNode(
            lambda: ops.JoinNode(
                left_cols=[f"__v_{n}" for n in l_cols],
                right_cols=[f"__v_{n}" for n in r_cols],
                left_on="__jk__",
                right_on="__jk__",
                how=how,
                out_columns=out_columns,
                left_id_only=left_id_only,
            ),
            [pre_l._node, pre_r._node],
            name=f"join_{how}",
        )
        uni = left._universe.subset() if left_id_only else Universe()
        self._joined = Table(node, schema_mod.schema_from_dtypes(dtypes), uni)
        return self._joined

    def _rewrite(self, e: ColumnExpression, joined: Table) -> ColumnExpression:
        if isinstance(e, ColumnReference):
            if e.table is self.left:
                return joined["__left_id__"] if e.name == "id" else joined[f"__l__{e.name}"]
            if e.table is self.right:
                return joined["__right_id__"] if e.name == "id" else joined[f"__r__{e.name}"]
            if e.table is None or not isinstance(e.table, Table):
                raise ValueError("unbound reference in join select")
            return e
        args = e._args()
        if not args:
            return e
        return e._with_args(tuple(self._rewrite(a, joined) for a in args))

    def _bind_joinside(self, e: Any) -> ColumnExpression:
        """Bind pw.this to left-then-right column resolution."""
        e = expr_mod.wrap(e)

        def bind(x: ColumnExpression) -> ColumnExpression:
            if isinstance(x, ColumnReference) and x.table is None:
                side = getattr(x, "_placeholder_side", "this")
                if side == "left":
                    return self.left[x.name] if x.name != "id" else self.left.id
                if side == "right":
                    return self.right[x.name] if x.name != "id" else self.right.id
                # pw.this: resolve by name, left first
                if x.name in self.left.column_names():
                    return self.left[x.name]
                if x.name in self.right.column_names():
                    return self.right[x.name]
                raise KeyError(f"column {x.name!r} in neither join side")
            args = x._args()
            if not args:
                return x
            return x._with_args(tuple(bind(a) for a in args))

        return bind(e)

    # -------------------------------------------------------------- API

    def select(self, *args: Any, **kwargs: Any) -> Table:
        joined = self._materialize()
        exprs: dict[str, ColumnExpression] = {}
        expanded: list[Any] = []
        for a in args:
            if isinstance(a, thisclass.LeftPlaceholder):
                expanded.extend(self.left[n] for n in self.left.column_names())
            elif isinstance(a, thisclass.RightPlaceholder):
                expanded.extend(self.right[n] for n in self.right.column_names())
            elif isinstance(a, thisclass.ThisPlaceholder):
                expanded.extend(self.left[n] for n in self.left.column_names())
                expanded.extend(
                    self.right[n]
                    for n in self.right.column_names()
                    if n not in self.left.column_names()
                )
            else:
                expanded.append(a)
        for a in expanded:
            bound = self._bind_joinside(a)
            name = expr_mod.smart_name(bound)
            if name is None:
                raise ValueError("positional join select args must be column refs")
            exprs[name] = bound
        for name, e in kwargs.items():
            exprs[name] = self._bind_joinside(e)
        final = {n: self._rewrite(e, joined) for n, e in exprs.items()}
        return joined.select(**final)

    def _rebind(self, e: Any, joined: Table) -> ColumnExpression:
        return self._rewrite(self._bind_joinside(e), joined)

    def reduce(self, *args: Any, **kwargs: Any) -> Table:
        return self.groupby().reduce(*args, **kwargs)

    def groupby(self, *args: Any, **kwargs: Any):
        joined = self._materialize()
        grouping = [self._rebind(a, joined) for a in args]
        inner = joined.groupby(*grouping, **kwargs)
        return _JoinGroupedTable(self, joined, inner)

    def filter(self, expression: Any) -> "JoinResult":
        joined = self._materialize()
        bound = self._rewrite(self._bind_joinside(expression), joined)
        new = JoinResult.__new__(JoinResult)
        new.left = self.left
        new.right = self.right
        new.how = self.how
        new.id_expr = self.id_expr
        new.left_on = self.left_on
        new.right_on = self.right_on
        new._joined = joined.filter(bound)
        return new


class _JoinGroupedTable:
    """GroupedTable over a join result: rewrites pw.left/pw.right refs in reduce
    expressions onto the joined block before delegating."""

    def __init__(self, join_result: JoinResult, joined: Table, inner: Any):
        self._jr = join_result
        self._joined = joined
        self._inner = inner

    def reduce(self, *args: Any, **kwargs: Any) -> Table:
        rw_args = [self._jr._rebind(a, self._joined) for a in args]
        rw_kwargs = {k: self._jr._rebind(v, self._joined) for k, v in kwargs.items()}
        return self._inner.reduce(*rw_args, **rw_kwargs)


def split_join_condition(
    cond: Any, left: Table, right: Table
) -> tuple[ColumnExpression, ColumnExpression]:
    if isinstance(cond, ColumnReference):
        # shorthand: single ref means same-named column on both sides
        name = cond.name
        return left[name], right[name]
    if not (isinstance(cond, BinOpExpression) and cond.op == "=="):
        raise ValueError("join conditions must be equalities (left expr == right expr)")
    l_e = thisclass.bind_expression(cond.left, left, left, right)
    r_e = thisclass.bind_expression(cond.right, left, left, right)
    if _belongs_to(l_e, right) and _belongs_to(r_e, left):
        l_e, r_e = r_e, l_e
    return l_e, r_e


def _belongs_to(e: ColumnExpression, table: Table) -> bool:
    if isinstance(e, ColumnReference):
        return e.table is table
    return any(_belongs_to(a, table) for a in e._args())


def join_on_key_cols(
    left: Table,
    right: Table,
    left_key_expr: ColumnExpression,
    how: str,
    left_id_only: bool,
    take_right_only: bool,
    universe: Universe,
) -> Table:
    """ix-style lookup: match ``left_key_expr`` (a pointer) against right ids."""
    l_cols = left.column_names()
    r_cols = right.column_names()
    pre_l = left.select(
        **{f"__v_{n}": left[n] for n in l_cols},
        __jk__=left_key_expr,
    )
    pre_r = right.select(
        **{f"__v_{n}": right[n] for n in r_cols},
        __jk__=ColumnReference(right, "id"),
    )
    out_columns = (
        ["__left_id__", "__right_id__"]
        + [f"__l__{n}" for n in l_cols]
        + [f"__r__{n}" for n in r_cols]
    )
    node = LogicalNode(
        lambda: ops.JoinNode(
            left_cols=[f"__v_{n}" for n in l_cols],
            right_cols=[f"__v_{n}" for n in r_cols],
            left_on="__jk__",
            right_on="__jk__",
            how=how,
            out_columns=out_columns,
            left_id_only=left_id_only,
        ),
        [pre_l._node, pre_r._node],
        name="ix",
    )
    dtypes: dict[str, dt.DType] = {
        "__left_id__": dt.POINTER,
        "__right_id__": dt.Optional(dt.POINTER),
    }
    for n in l_cols:
        dtypes[f"__l__{n}"] = left._schema.dtypes()[n]
    for n in r_cols:
        dtypes[f"__r__{n}"] = dt.Optional(right._schema.dtypes()[n])
    joined = Table(node, schema_mod.schema_from_dtypes(dtypes), universe)
    if take_right_only:
        return joined.select(
            **{n: joined[f"__r__{n}"] for n in r_cols}
        )
    return joined
