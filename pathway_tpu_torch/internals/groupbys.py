"""GroupedTable & reduce desugaring.

Mirrors the reference's ``internals/groupbys.py`` (GroupedTable.reduce): reducer
expressions inside ``reduce(...)`` are split out into engine reducer slots, the
grouping columns and reducer arguments are materialized by a pre-select, the engine
GroupByNode aggregates incrementally, and a post-select rebuilds the user's output
expressions over the aggregate slots.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from pathway_tpu_torch.engine import operators as ops
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import expression as expr_mod
from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals import thisclass
from pathway_tpu_torch.internals.expression import (
    TYPE_ENV,
    ColumnExpression,
    ColumnReference,
    ReducerExpression,
)
from pathway_tpu_torch.internals.logical import LogicalNode
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.internals.universe import Universe


class GroupedTable:
    def __init__(
        self,
        source: Table,
        grouping: list[ColumnReference],
        set_id: ColumnExpression | None = None,
        sort_by: ColumnExpression | None = None,
        instance: ColumnExpression | None = None,
    ):
        self.source = source
        self.grouping = grouping
        self.set_id = set_id
        self.sort_by = sort_by
        self.instance = instance
        if instance is not None:
            self.grouping = [*grouping]  # instance joins the grouping key
        self._window_args: dict[str, Any] | None = None  # used by temporal windowby

    def reduce(self, *args: Any, **kwargs: Any) -> Table:
        source = self.source
        out_exprs: dict[str, ColumnExpression] = {}
        for a in thisclass.expand_args(args, source):
            bound = thisclass.bind_expression(expr_mod.wrap(a), source)
            name = expr_mod.smart_name(bound)
            if name is None:
                raise ValueError("positional reduce args must be column references")
            out_exprs[name] = bound
        for name, e in kwargs.items():
            out_exprs[name] = thisclass.bind_expression(expr_mod.wrap(e), source)

        # --- collect reducers and grouping slots ------------------------------
        grouping_exprs = list(self.grouping)
        if self.instance is not None:
            grouping_exprs.append(self.instance)  # type: ignore[arg-type]
        group_slot_of: dict[tuple[int, str], int] = {}
        for i, g in enumerate(grouping_exprs):
            group_slot_of[(id(g.table), g.name)] = i

        reducer_slots: list[ReducerExpression] = []

        def collect(e: ColumnExpression) -> None:
            if isinstance(e, ReducerExpression):
                reducer_slots.append(e)
                return  # don't descend into reducer args (they're row-level)
            for a in e._args():
                collect(a)

        for e in out_exprs.values():
            collect(e)

        # --- pre-select materializes grouping cols + reducer args -------------
        pre_cols: dict[str, ColumnExpression] = {}
        for i, g in enumerate(grouping_exprs):
            pre_cols[f"__g{i}"] = g
        sort_key_expr = self.sort_by if self.sort_by is not None else ColumnReference(source, "id")
        arg_names_per_slot: list[list[str]] = []
        for j, r in enumerate(reducer_slots):
            names: list[str] = []
            for k, a in enumerate(r.args):
                nm = f"__a{j}_{k}"
                pre_cols[nm] = a
                names.append(nm)
            if r.reducer.append_id:
                nm = f"__a{j}_id"
                pre_cols[nm] = ColumnReference(source, "id")
                names.append(nm)
            if r.reducer.append_sort_key:
                nm = f"__a{j}_sk"
                pre_cols[nm] = sort_key_expr
                names.append(nm)
            arg_names_per_slot.append(names)
        if self.set_id is not None:
            pre_cols["__setid"] = self.set_id

        pre = source.select(**pre_cols)

        # --- engine groupby ----------------------------------------------------
        group_col_names = [f"__g{i}" for i in range(len(grouping_exprs))]
        specs = []
        inter_dtypes: dict[str, dt.DType] = {}
        for i, g in enumerate(grouping_exprs):
            inter_dtypes[f"__g{i}"] = g._dtype(TYPE_ENV)
        for j, r in enumerate(reducer_slots):
            arg_dtypes = [a._dtype(TYPE_ENV) for a in r.args]
            impl = r.reducer.make_impl(arg_dtypes)
            specs.append((f"__r{j}", impl, arg_names_per_slot[j]))
            inter_dtypes[f"__r{j}"] = r.reducer.result_dtype(arg_dtypes)

        key_col = "__setid" if self.set_id is not None else None
        node = LogicalNode(
            lambda: ops.GroupByNode(
                group_col_names,
                specs,
                key_col=key_col,
                out_group_cols=group_col_names,
            ),
            [pre._node],
            name="groupby",
        )
        inter = Table(node, schema_mod.schema_from_dtypes(inter_dtypes), Universe())

        # --- post-select rebuilds user expressions over slots ------------------
        slot_index = {id(r): j for j, r in enumerate(reducer_slots)}

        def rewrite(e: ColumnExpression) -> ColumnExpression:
            if isinstance(e, ReducerExpression):
                return inter[f"__r{slot_index[id(e)]}"]
            if isinstance(e, ColumnReference):
                if e.name == "id" and isinstance(e.table, Table):
                    # pw.this.id inside reduce = the group's id
                    return ColumnReference(inter, "id")
                slot = group_slot_of.get((id(e.table), e.name))
                if slot is None:
                    raise ValueError(
                        f"column {e.name!r} used in reduce() outside a reducer and "
                        "not in groupby()"
                    )
                return inter[f"__g{slot}"]
            args = e._args()
            if not args:
                return e
            return e._with_args(tuple(rewrite(a) for a in args))

        final_exprs = {name: rewrite(e) for name, e in out_exprs.items()}
        return inter.select(**final_exprs)

    def windowby_reduce_context(self) -> Table:
        raise NotImplementedError
