"""Static dtype lattice for the declarative layer.

Plays the role of the reference's dtype system (``python/pathway/internals/dtype.py``:
INT/FLOAT/BOOL/STR/BYTES/NONE/ANY/Array/Pointer/Optional/Tuple/List/Json/Callable/
Duration/DateTimeNaive/DateTimeUtc/Future/PyObjectWrapper with ``is_subtype``-driven
unification), re-targeted at a columnar engine: every dtype maps onto a numpy storage
class so delta blocks stay vectorizable and, where numeric, JAX-ingestible.
"""

from __future__ import annotations

import datetime
import typing
from abc import ABC
from typing import Any, Callable, Iterable

import numpy as np


class DType(ABC):
    """Base of the static type lattice."""

    _name: str = "DType"

    def __repr__(self) -> str:
        return self._name

    @property
    def typehint(self) -> Any:
        return Any

    # numpy storage dtype for engine columns
    @property
    def np_dtype(self) -> np.dtype:
        return np.dtype(object)

    def is_optional(self) -> bool:
        return False

    @property
    def wrapped(self) -> DType:
        return self

    def __eq__(self, other: object) -> bool:
        return type(self) is type(other) and self._key() == other._key()  # type: ignore[attr-defined]

    def __hash__(self) -> int:
        return hash((type(self).__name__, self._key()))

    def _key(self) -> tuple:
        return ()

    def equivalent_to(self, other: DType) -> bool:
        return dtype_equivalence(self, other)


class _SimpleDType(DType):
    def __init__(self, name: str, np_dtype: np.dtype, typehint: Any):
        self._name = name
        self._np = np_dtype
        self._hint = typehint

    def _key(self) -> tuple:
        return (self._name,)

    @property
    def np_dtype(self) -> np.dtype:
        return self._np

    @property
    def typehint(self) -> Any:
        return self._hint


INT = _SimpleDType("INT", np.dtype(np.int64), int)
FLOAT = _SimpleDType("FLOAT", np.dtype(np.float64), float)
BOOL = _SimpleDType("BOOL", np.dtype(np.bool_), bool)
STR = _SimpleDType("STR", np.dtype(object), str)
BYTES = _SimpleDType("BYTES", np.dtype(object), bytes)
NONE = _SimpleDType("NONE", np.dtype(object), type(None))
ANY = _SimpleDType("ANY", np.dtype(object), Any)
DURATION = _SimpleDType("DURATION", np.dtype("timedelta64[ns]"), datetime.timedelta)
DATE_TIME_NAIVE = _SimpleDType("DATE_TIME_NAIVE", np.dtype("datetime64[ns]"), datetime.datetime)
DATE_TIME_UTC = _SimpleDType("DATE_TIME_UTC", np.dtype("datetime64[ns]"), datetime.datetime)
JSON = _SimpleDType("JSON", np.dtype(object), Any)
PY_OBJECT_WRAPPER = _SimpleDType("PY_OBJECT_WRAPPER", np.dtype(object), Any)


class Pointer(DType):
    """Row-reference dtype; stored as uint64 key columns (engine keys are 64-bit
    splitmix/blake2 hashes — the TPU-side analogue of the reference's
    ``Key(u128)`` at ``src/engine/value.rs:41``)."""

    def __init__(self, *args: Any):
        self.args = args
        self._name = "Pointer"

    def __repr__(self) -> str:
        return "Pointer"

    def _key(self) -> tuple:
        return ()  # all pointers unify

    @property
    def np_dtype(self) -> np.dtype:
        return np.dtype(np.uint64)

    @property
    def typehint(self) -> Any:
        return Pointer


POINTER = Pointer()


class Optional(DType):
    def __new__(cls, wrapped: DType):
        wrapped = wrap(wrapped)
        if isinstance(wrapped, Optional) or wrapped in (NONE, ANY):
            return wrapped
        self = object.__new__(cls)
        self._wrapped = wrapped
        return self

    def __repr__(self) -> str:
        return f"Optional({self._wrapped!r})"

    def _key(self) -> tuple:
        return (self._wrapped,)

    def is_optional(self) -> bool:
        return True

    @property
    def wrapped(self) -> DType:
        return self._wrapped

    @property
    def np_dtype(self) -> np.dtype:
        # optionality forces object storage for value types that can't hold NaN/NaT
        if self._wrapped in (FLOAT, DATE_TIME_NAIVE, DATE_TIME_UTC, DURATION):
            return self._wrapped.np_dtype
        return np.dtype(object)

    @property
    def typehint(self) -> Any:
        return typing.Optional[self._wrapped.typehint]


class Tuple(DType):
    """Fixed-arity heterogeneous tuple."""

    def __init__(self, *args: Any):
        self.args = tuple(wrap(a) for a in args)
        self._name = f"Tuple{self.args}"

    def _key(self) -> tuple:
        return self.args

    def __repr__(self) -> str:
        return f"Tuple[{', '.join(map(repr, self.args))}]"


ANY_TUPLE = Tuple()  # sentinel for unknown-arity tuples


class List(DType):
    def __init__(self, arg: Any):
        self.wrapped_ = wrap(arg)

    def _key(self) -> tuple:
        return (self.wrapped_,)

    def __repr__(self) -> str:
        return f"List[{self.wrapped_!r}]"


class Array(DType):
    """N-dim numeric array dtype (ndarray columns; the TPU-native payload)."""

    def __init__(self, n_dim: int | None = None, wrapped: DType = ANY):
        self.n_dim = n_dim
        self.wrapped_ = wrapped if isinstance(wrapped, DType) else wrap(wrapped)

    def _key(self) -> tuple:
        return (self.n_dim, self.wrapped_)

    def __repr__(self) -> str:
        return f"Array({self.n_dim}, {self.wrapped_!r})"


ANY_ARRAY = Array()


class Callable_(DType):
    _name = "Callable"


CALLABLE = Callable_()


class Future(DType):
    """Value may still be Pending — result of fully-async UDFs (reference:
    ``internals/dtype.py`` Future + ``table.await_futures``)."""

    def __init__(self, wrapped: DType):
        self.wrapped_ = wrap(wrapped)

    def _key(self) -> tuple:
        return (self.wrapped_,)

    def __repr__(self) -> str:
        return f"Future({self.wrapped_!r})"


class DateTimeNaive(datetime.datetime):
    """Annotation alias (reference exposes ``pw.DateTimeNaive`` the same way)."""


class DateTimeUtc(datetime.datetime):
    pass


class Duration(datetime.timedelta):
    pass


_SIMPLE_FROM_HINT: dict[Any, DType] = {
    DateTimeNaive: DATE_TIME_NAIVE,
    DateTimeUtc: DATE_TIME_UTC,
    Duration: DURATION,
    int: INT,
    float: FLOAT,
    bool: BOOL,
    str: STR,
    bytes: BYTES,
    type(None): NONE,
    Any: ANY,
    datetime.timedelta: DURATION,
    datetime.datetime: DATE_TIME_NAIVE,
    np.int64: INT,
    np.int32: INT,
    np.float64: FLOAT,
    np.float32: FLOAT,
    np.bool_: BOOL,
    np.ndarray: ANY_ARRAY,
    dict: JSON,
}


def wrap(hint: Any) -> DType:
    """Coerce a python typehint / DType into a DType."""
    if isinstance(hint, DType):
        return hint
    if hint is None:
        return NONE
    from pathway_tpu_torch.internals import json as pw_json

    if hint is pw_json.Json:
        return JSON
    if hint in _SIMPLE_FROM_HINT:
        return _SIMPLE_FROM_HINT[hint]
    if hint is Pointer:
        return POINTER
    origin = typing.get_origin(hint)
    if origin is not None:
        targs = typing.get_args(hint)
        import types as _types

        if origin is typing.Union or origin is _types.UnionType:
            non_none = [a for a in targs if a is not type(None)]
            if len(non_none) < len(targs):
                if len(non_none) == 1:
                    return Optional(wrap(non_none[0]))
                return ANY
            return ANY
        if origin in (tuple,):
            if len(targs) == 2 and targs[1] is Ellipsis:
                return List(wrap(targs[0]))
            return Tuple(*[wrap(a) for a in targs])
        if origin in (list,):
            return List(wrap(targs[0])) if targs else List(ANY)
        if origin is np.ndarray:
            return ANY_ARRAY
        if origin is Callable:
            return CALLABLE
        if origin is dict:
            return JSON
    if isinstance(hint, type) and issubclass(hint, np.ndarray):
        return ANY_ARRAY
    if callable(hint) and not isinstance(hint, type):
        return CALLABLE
    return ANY


def dtype_of_value(value: Any) -> DType:
    from pathway_tpu_torch.internals import json as pw_json

    if value is None:
        return NONE
    if isinstance(value, bool) or isinstance(value, np.bool_):
        return BOOL
    if isinstance(value, (int, np.integer)):
        return INT
    if isinstance(value, (float, np.floating)):
        return FLOAT
    if isinstance(value, str):
        return STR
    if isinstance(value, bytes):
        return BYTES
    if isinstance(value, datetime.timedelta) or isinstance(value, np.timedelta64):
        return DURATION
    if isinstance(value, np.datetime64):
        return DATE_TIME_NAIVE
    if isinstance(value, datetime.datetime):
        return DATE_TIME_UTC if value.tzinfo is not None else DATE_TIME_NAIVE
    if isinstance(value, np.ndarray):
        return Array(value.ndim, wrap(value.dtype.type) if value.dtype.kind in "ifb" else ANY)
    if isinstance(value, pw_json.Json):
        return JSON
    if isinstance(value, tuple):
        return Tuple(*[dtype_of_value(v) for v in value])
    if isinstance(value, list):
        return List(ANY)
    if isinstance(value, dict):
        return JSON
    return ANY


def is_subtype(sub: DType, sup: DType) -> bool:
    """Subtype check driving schema compatibility (mirrors the reference's
    ``dtype.is_subtype`` role in unification)."""
    if sup == ANY or sub == sup:
        return True
    if sub == ANY:
        return False
    if isinstance(sup, Optional):
        if sub == NONE:
            return True
        return is_subtype(sub.wrapped if isinstance(sub, Optional) else sub, sup.wrapped)
    if isinstance(sub, Optional):
        return False
    if sub == INT and sup == FLOAT:
        return True
    if isinstance(sub, Pointer) and isinstance(sup, Pointer):
        return True
    if isinstance(sub, Tuple) and sup == ANY_TUPLE:
        return True
    if isinstance(sub, Tuple) and isinstance(sup, Tuple):
        return len(sub.args) == len(sup.args) and all(
            is_subtype(a, b) for a, b in zip(sub.args, sup.args)
        )
    if isinstance(sub, List) and isinstance(sup, List):
        return is_subtype(sub.wrapped_, sup.wrapped_)
    if isinstance(sub, Tuple) and isinstance(sup, List):
        return all(is_subtype(a, sup.wrapped_) for a in sub.args)
    if isinstance(sub, Array) and isinstance(sup, Array):
        if sup.n_dim is not None and sub.n_dim != sup.n_dim:
            return False
        return is_subtype(sub.wrapped_, sup.wrapped_) or sup.wrapped_ == ANY
    return False


def types_lca(a: DType, b: DType, raising: bool = False) -> DType:
    """Least common ancestor — unification for if_else/coalesce/concat."""
    if a == b:
        return a
    if is_subtype(a, b):
        return b
    if is_subtype(b, a):
        return a
    if a == NONE:
        return Optional(b)
    if b == NONE:
        return Optional(a)
    if isinstance(a, Optional) or isinstance(b, Optional):
        inner = types_lca(a.wrapped, b.wrapped, raising=False)
        return Optional(inner)
    if {a, b} == {INT, FLOAT}:
        return FLOAT
    if isinstance(a, Tuple) and isinstance(b, Tuple):
        if len(a.args) == len(b.args):
            return Tuple(*[types_lca(x, y) for x, y in zip(a.args, b.args)])
        return ANY_TUPLE
    if isinstance(a, Array) and isinstance(b, Array):
        return Array(a.n_dim if a.n_dim == b.n_dim else None, types_lca(a.wrapped_, b.wrapped_))
    if raising:
        raise TypeError(f"cannot unify dtypes {a!r} and {b!r}")
    return ANY


def unoptionalize(d: DType) -> DType:
    return d.wrapped if isinstance(d, Optional) else d


def normalize_pointers(dtypes: Iterable[DType]) -> list[DType]:
    return [POINTER if isinstance(d, Pointer) else d for d in dtypes]


def coerce_scalar_to(value: Any, d: DType) -> Any:
    """Best-effort scalar coercion used when building columns of a known dtype."""
    if value is None:
        return None
    if d == INT:
        return int(value)
    if d == FLOAT:
        return float(value)
    if d == BOOL:
        return bool(value)
    if d == STR:
        return str(value) if not isinstance(value, str) else value
    return value
