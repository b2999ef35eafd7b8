"""User-facing reducer registry (``pw.reducers``).

Mirrors the reference's ``internals/reducers.py`` + ``custom_reducers.py``
(sum/min/max/argmin/argmax/count/tuple/sorted_tuple/unique/any/earliest/latest/avg/
ndarray/stateful_single/stateful_many, udf_reducer via BaseCustomAccumulator). Each
descriptor knows how to build its engine accumulator for the argument dtypes and the
result dtype; ``avg`` desugars to sum/count like the reference's Python layer.
"""

from __future__ import annotations

from typing import Any, Callable

from pathway_tpu_torch.engine import reducers_impl as impl
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import expression as expr_mod
from pathway_tpu_torch.internals.expression import ColumnExpression, ReducerExpression


class Reducer:
    def __init__(
        self,
        name: str,
        make_impl: Callable[[list[dt.DType]], impl.ReducerImpl],
        result_dtype_fn: Callable[[list[dt.DType]], dt.DType],
        append_id: bool = False,
        append_sort_key: bool = False,
    ):
        self.name = name
        self._make_impl = make_impl
        self._result_dtype_fn = result_dtype_fn
        self.append_id = append_id  # engine needs (value, id) pairs (argmin/argmax)
        self.append_sort_key = append_sort_key

    def make_impl(self, arg_dtypes: list[dt.DType]) -> impl.ReducerImpl:
        return self._make_impl(arg_dtypes)

    def result_dtype(self, arg_dtypes: list[dt.DType]) -> dt.DType:
        return self._result_dtype_fn(arg_dtypes)

    def __repr__(self) -> str:
        return f"reducers.{self.name}"


def _first(dts: list[dt.DType]) -> dt.DType:
    return dts[0] if dts else dt.ANY


def _sum_impl(dts: list[dt.DType]) -> impl.ReducerImpl:
    d = dt.unoptionalize(_first(dts))
    if isinstance(d, dt.Array):
        return impl.ArraySumReducer()
    return impl.SumReducer("float" if d == dt.FLOAT else "int")


_count_reducer = Reducer("count", lambda dts: impl.CountReducer(), lambda dts: dt.INT)
_sum_reducer = Reducer("sum", _sum_impl, _first)
_min_reducer = Reducer("min", lambda dts: impl.MinReducer(), _first)
_max_reducer = Reducer("max", lambda dts: impl.MaxReducer(), _first)
_argmin_reducer = Reducer(
    "argmin", lambda dts: impl.ArgMinReducer(), lambda dts: dt.POINTER, append_id=True
)
_argmax_reducer = Reducer(
    "argmax", lambda dts: impl.ArgMaxReducer(), lambda dts: dt.POINTER, append_id=True
)
_unique_reducer = Reducer("unique", lambda dts: impl.UniqueReducer(), _first)
_any_reducer = Reducer("any", lambda dts: impl.AnyReducer(), _first)
_earliest_reducer = Reducer("earliest", lambda dts: impl.EarliestReducer(), _first)
_latest_reducer = Reducer("latest", lambda dts: impl.LatestReducer(), _first)


def count(*args: Any) -> ReducerExpression:
    return ReducerExpression(_count_reducer)


def sum(expr: ColumnExpression) -> ReducerExpression:  # noqa: A001
    return ReducerExpression(_sum_reducer, expr)


def min(expr: ColumnExpression) -> ReducerExpression:  # noqa: A001
    return ReducerExpression(_min_reducer, expr)


def max(expr: ColumnExpression) -> ReducerExpression:  # noqa: A001
    return ReducerExpression(_max_reducer, expr)


def argmin(expr: ColumnExpression) -> ReducerExpression:
    return ReducerExpression(_argmin_reducer, expr)


def argmax(expr: ColumnExpression) -> ReducerExpression:
    return ReducerExpression(_argmax_reducer, expr)


def unique(expr: ColumnExpression) -> ReducerExpression:
    return ReducerExpression(_unique_reducer, expr)


def any(expr: ColumnExpression) -> ReducerExpression:  # noqa: A001
    return ReducerExpression(_any_reducer, expr)


def earliest(expr: ColumnExpression) -> ReducerExpression:
    return ReducerExpression(_earliest_reducer, expr)


def latest(expr: ColumnExpression) -> ReducerExpression:
    return ReducerExpression(_latest_reducer, expr)


def avg(expr: ColumnExpression) -> ColumnExpression:
    """Desugars to sum/count (matching the reference's Python-level avg)."""
    return expr_mod.BinOpExpression(
        "/", ReducerExpression(_sum_reducer, expr), ReducerExpression(_count_reducer)
    )


def tuple(expr: ColumnExpression, *, skip_nones: bool = False) -> ReducerExpression:  # noqa: A001
    r = Reducer(
        "tuple",
        lambda dts: impl.TupleReducer(skip_nones=skip_nones, with_sort_key=True),
        lambda dts: dt.List(_first(dts)),
        append_sort_key=True,  # honors groupby(sort_by=...); defaults to row id
    )
    return ReducerExpression(r, expr)


def sorted_tuple(expr: ColumnExpression, *, skip_nones: bool = False) -> ReducerExpression:
    r = Reducer(
        "sorted_tuple",
        lambda dts: impl.SortedTupleReducer(skip_nones=skip_nones),
        lambda dts: dt.List(_first(dts)),
    )
    return ReducerExpression(r, expr)


def ndarray(expr: ColumnExpression, *, skip_nones: bool = False) -> ReducerExpression:
    r = Reducer(
        "ndarray",
        lambda dts: impl.NdarrayReducer(),
        lambda dts: dt.ANY_ARRAY,
        append_sort_key=True,
    )
    return ReducerExpression(r, expr)


def stateful_single(combine_fn: Callable) -> Callable[..., ReducerExpression]:
    def make(*exprs: ColumnExpression) -> ReducerExpression:
        r = Reducer(
            "stateful_single",
            lambda dts: impl.StatefulReducer(combine_fn, many=False),
            lambda dts: dt.ANY,
        )
        return ReducerExpression(r, *exprs)

    return make


def stateful_many(combine_fn: Callable) -> Callable[..., ReducerExpression]:
    def make(*exprs: ColumnExpression) -> ReducerExpression:
        r = Reducer(
            "stateful_many",
            lambda dts: impl.StatefulReducer(combine_fn, many=True),
            lambda dts: dt.ANY,
        )
        return ReducerExpression(r, *exprs)

    return make


class BaseCustomAccumulator:
    """Base for ``udf_reducer`` accumulators (reference:
    ``internals/custom_reducers.py`` BaseCustomAccumulator: from_row/update/
    retract/compute_result)."""

    @classmethod
    def from_row(cls, row: list):
        raise NotImplementedError

    def update(self, other) -> None:
        raise NotImplementedError

    def compute_result(self):
        raise NotImplementedError


def udf_reducer(acc_cls: type[BaseCustomAccumulator]) -> Callable[..., ReducerExpression]:
    def make(*exprs: ColumnExpression) -> ReducerExpression:
        r = Reducer(
            "udf_reducer",
            lambda dts: impl.CustomAccumulatorReducer(acc_cls),
            lambda dts: dt.ANY,
        )
        return ReducerExpression(r, *exprs)

    return make
