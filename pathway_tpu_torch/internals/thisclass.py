"""``pw.this`` / ``pw.left`` / ``pw.right`` placeholders and desugaring.

Mirrors the reference's ``internals/thisclass.py`` + ``internals/desugaring.py``:
placeholders build unbound ``ColumnReference``s that table operations rebind to the
operation's target table (or join sides) before type inference and lowering.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any, Iterable

from pathway_tpu_torch.internals import expression as expr_mod
from pathway_tpu_torch.internals.expression import ColumnExpression, ColumnReference

if TYPE_CHECKING:
    from pathway_tpu_torch.internals.table import Table


class ThisPlaceholder:
    """Placeholder standing for "the table this expression is applied to"."""

    _side = "this"

    def __getattr__(self, name: str) -> ColumnReference:
        if name.startswith("__") or name == "_side":
            raise AttributeError(name)
        ref = ColumnReference(None, name)
        ref._placeholder_side = self._side  # type: ignore[attr-defined]
        return ref

    def __getitem__(self, name: str) -> ColumnReference:
        if isinstance(name, ColumnReference):
            name = name.name
        # explicit bracket access allows any column name, including dunder
        # internals that attribute access rejects
        ref = ColumnReference(None, name)
        ref._placeholder_side = self._side  # type: ignore[attr-defined]
        return ref

    @property
    def id(self) -> ColumnReference:
        return self.__getattr__("id")

    def pointer_from(self, *args: Any, optional: bool = False, instance: Any = None):
        p = expr_mod.PointerExpression(None, *args, optional=optional, instance=instance)
        p._placeholder_side = self._side  # type: ignore[attr-defined]
        return p

    def __iter__(self):
        # ``select(*pw.this)``: unpacking yields the placeholder itself; table
        # operations expand it to all columns during desugaring
        return iter([self])

    def __repr__(self) -> str:
        return f"pw.{self._side}"


class LeftPlaceholder(ThisPlaceholder):
    _side = "left"


class RightPlaceholder(ThisPlaceholder):
    _side = "right"


this = ThisPlaceholder()
left = LeftPlaceholder()
right = RightPlaceholder()


def _side_of(e: ColumnExpression) -> str:
    return getattr(e, "_placeholder_side", "this")


def bind_expression(
    e: ColumnExpression,
    this_table: "Table",
    left_table: "Table | None" = None,
    right_table: "Table | None" = None,
) -> ColumnExpression:
    """Rebind placeholder refs to concrete tables, recursively."""

    def resolve(side: str) -> "Table":
        if side == "left":
            if left_table is None:
                raise ValueError("pw.left used outside of a join")
            return left_table
        if side == "right":
            if right_table is None:
                raise ValueError("pw.right used outside of a join")
            return right_table
        return this_table

    if isinstance(e, ColumnReference):
        if e.table is None:
            table = resolve(_side_of(e))
            if e.name != "id" and e.name not in table.schema.column_names():
                raise KeyError(
                    f"column {e.name!r} not in table (has: {table.schema.column_names()})"
                )
            return table[e.name] if e.name != "id" else ColumnReference(table, "id")
        return e
    if isinstance(e, expr_mod.PointerExpression) and e.table is None:
        table = resolve(_side_of(e))
        args = tuple(bind_expression(a, this_table, left_table, right_table) for a in e.args)
        return expr_mod.PointerExpression(table, *args, optional=e.optional, instance=e.instance)
    args = e._args()
    if not args:
        return e
    new_args = tuple(bind_expression(a, this_table, left_table, right_table) for a in args)
    return e._with_args(new_args)


def expand_args(
    args: Iterable[Any], this_table: "Table"
) -> list[ColumnExpression]:
    """Expand ``*pw.this`` / ``*table`` into all-column references."""
    out: list[ColumnExpression] = []
    for a in args:
        if isinstance(a, ThisPlaceholder):
            for name in this_table.schema.column_names():
                out.append(this_table[name])
        elif hasattr(a, "schema") and hasattr(a, "__getitem__"):  # a Table
            for name in a.schema.column_names():
                out.append(a[name])
        else:
            out.append(a)
    return out
