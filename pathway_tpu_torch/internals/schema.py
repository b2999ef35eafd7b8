"""Schema metaclass & column definitions.

Mirrors the reference's ``python/pathway/internals/schema.py`` (``pw.Schema``
metaclass with column defs, primary keys, ``schema_from_types/dict``, schema algebra)
— schemas here additionally know their numpy storage layout so the engine can allocate
columnar delta blocks without inspection at runtime.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Mapping

import numpy as np

from pathway_tpu_torch.internals import dtype as dt


@dataclass(frozen=True)
class ColumnDefinition:
    dtype: dt.DType = dt.ANY
    primary_key: bool = False
    default_value: Any = None
    has_default: bool = False
    name: str | None = None
    append_only: bool | None = None


_MISSING = object()


def column_definition(
    *,
    primary_key: bool = False,
    default_value: Any = _MISSING,
    dtype: Any = None,
    name: str | None = None,
    append_only: bool | None = None,
) -> Any:
    has_default = default_value is not _MISSING
    return ColumnDefinition(
        dtype=dt.wrap(dtype) if dtype is not None else dt.ANY,
        primary_key=primary_key,
        default_value=None if not has_default else default_value,
        has_default=has_default,
        name=name,
        append_only=append_only,
    )


class SchemaMetaclass(type):
    __columns__: dict[str, ColumnDefinition]
    __append_only__: bool

    def __new__(mcls, name, bases, namespace, append_only: bool = False, **kwargs):
        cls = super().__new__(mcls, name, bases, namespace)
        columns: dict[str, ColumnDefinition] = {}
        for base in reversed(bases):
            columns.update(getattr(base, "__columns__", {}))
        annotations = namespace.get("__annotations__", {})
        for col_name, hint in annotations.items():
            if col_name in ("__module__", "__qualname__", "__doc__", "__slots__"):
                continue
            if isinstance(hint, str):
                hint = _resolve_string_annotation(hint, namespace.get("__module__"))
            given = namespace.get(col_name)
            cdef = given if isinstance(given, ColumnDefinition) else ColumnDefinition()
            cdtype = cdef.dtype if cdef.dtype != dt.ANY or hint is Any else dt.wrap(hint)
            if cdef.dtype == dt.ANY and hint is not Any:
                cdtype = dt.wrap(hint)
            columns[cdef.name or col_name] = ColumnDefinition(
                dtype=cdtype,
                primary_key=cdef.primary_key,
                default_value=cdef.default_value,
                has_default=cdef.has_default,
                name=cdef.name or col_name,
                append_only=cdef.append_only,
            )
        cls.__columns__ = columns
        cls.__append_only__ = append_only or any(getattr(b, "__append_only__", False) for b in bases)
        return cls

    def columns(cls) -> dict[str, ColumnDefinition]:
        return dict(cls.__columns__)

    def column_names(cls) -> list[str]:
        return list(cls.__columns__)

    def keys(cls) -> list[str]:
        return list(cls.__columns__)

    def __getitem__(cls, name: str) -> ColumnDefinition:
        return cls.__columns__[name]

    def typehints(cls) -> dict[str, Any]:
        return {n: c.dtype.typehint for n, c in cls.__columns__.items()}

    def dtypes(cls) -> dict[str, dt.DType]:
        return {n: c.dtype for n, c in cls.__columns__.items()}

    def primary_key_columns(cls) -> list[str] | None:
        pks = [n for n, c in cls.__columns__.items() if c.primary_key]
        return pks or None

    def default_values(cls) -> dict[str, Any]:
        return {n: c.default_value for n, c in cls.__columns__.items() if c.has_default}

    def np_dtypes(cls) -> dict[str, np.dtype]:
        return {n: c.dtype.np_dtype for n, c in cls.__columns__.items()}

    def __or__(cls, other: "SchemaMetaclass") -> "SchemaMetaclass":
        dtypes = cls.dtypes()
        for n, d in other.dtypes().items():
            if n in dtypes and dtypes[n] != d:
                raise ValueError(f"schema union conflict on column {n!r}")
            dtypes[n] = d
        return schema_from_dtypes(dtypes, name=f"{cls.__name__}|{other.__name__}")

    def without(cls, *names: str) -> "SchemaMetaclass":
        dtypes = {n: d for n, d in cls.dtypes().items() if n not in names}
        return schema_from_dtypes(dtypes, name=f"{cls.__name__}.without")

    def update_types(cls, **new_types: Any) -> "SchemaMetaclass":
        dtypes = cls.dtypes()
        for n, h in new_types.items():
            if n not in dtypes:
                raise ValueError(f"unknown column {n!r}")
            dtypes[n] = dt.wrap(h)
        return schema_from_dtypes(dtypes, name=f"{cls.__name__}.updated")

    with_types = update_types

    def update_properties(cls, **kwargs: Any) -> "SchemaMetaclass":
        return cls

    def __repr__(cls) -> str:
        cols = ", ".join(f"{n}: {d!r}" for n, d in cls.dtypes().items())
        return f"<Schema {cls.__name__}({cols})>"


def _resolve_string_annotation(hint: str, module_name: str | None) -> Any:
    """Resolve ``from __future__ import annotations``-style string hints."""
    import sys
    import typing

    ns: dict[str, Any] = {"Any": Any, "Optional": typing.Optional, "Union": typing.Union}
    ns.update(
        {
            "int": int,
            "float": float,
            "bool": bool,
            "str": str,
            "bytes": bytes,
            "tuple": tuple,
            "list": list,
            "dict": dict,
            "np": np,
        }
    )
    if module_name and module_name in sys.modules:
        ns.update(vars(sys.modules[module_name]))
    try:
        return eval(hint, ns)  # noqa: S307 — controlled schema annotation context
    except Exception:
        return Any


class Schema(metaclass=SchemaMetaclass):
    """User-facing schema base class: subclass with annotations.

    >>> class InputSchema(pw.Schema):
    ...     name: str
    ...     age: int = pw.column_definition(primary_key=True)
    """


def schema_from_dtypes(
    dtypes: Mapping[str, dt.DType],
    name: str = "AnonymousSchema",
    primary_keys: list[str] | None = None,
    defaults: Mapping[str, Any] | None = None,
) -> SchemaMetaclass:
    namespace: dict[str, Any] = {"__annotations__": {}}
    defaults = defaults or {}
    for n, d in dtypes.items():
        namespace["__annotations__"][n] = Any
        namespace[n] = ColumnDefinition(
            dtype=d,
            primary_key=bool(primary_keys and n in primary_keys),
            default_value=defaults.get(n),
            has_default=n in defaults,
            name=n,
        )
    return SchemaMetaclass(name, (Schema,), namespace)


def schema_from_types(_name: str = "AnonymousSchema", **types: Any) -> SchemaMetaclass:
    return schema_from_dtypes({n: dt.wrap(h) for n, h in types.items()}, name=_name)


def schema_from_dict(
    columns: Mapping[str, Any], name: str = "AnonymousSchema"
) -> SchemaMetaclass:
    dtypes: dict[str, dt.DType] = {}
    pks: list[str] = []
    defaults: dict[str, Any] = {}
    for n, spec in columns.items():
        if isinstance(spec, dict):
            dtypes[n] = dt.wrap(spec.get("dtype", Any))
            if spec.get("primary_key"):
                pks.append(n)
            if "default_value" in spec:
                defaults[n] = spec["default_value"]
        elif isinstance(spec, ColumnDefinition):
            dtypes[n] = spec.dtype
            if spec.primary_key:
                pks.append(n)
            if spec.has_default:
                defaults[n] = spec.default_value
        else:
            dtypes[n] = dt.wrap(spec)
    return schema_from_dtypes(dtypes, name=name, primary_keys=pks or None, defaults=defaults)


def schema_from_pandas(
    df, name: str = "PandasSchema", id_from: list[str] | None = None
) -> SchemaMetaclass:
    import pandas as pd  # noqa: F401

    mapping = {"i": dt.INT, "f": dt.FLOAT, "b": dt.BOOL, "M": dt.DATE_TIME_NAIVE, "m": dt.DURATION}
    dtypes: dict[str, dt.DType] = {}
    for col in df.columns:
        kind = df[col].dtype.kind
        if kind in mapping:
            dtypes[str(col)] = mapping[kind]
        elif df[col].map(lambda v: isinstance(v, str) or v is None).all():
            dtypes[str(col)] = dt.STR
        else:
            dtypes[str(col)] = dt.ANY
    return schema_from_dtypes(dtypes, name=name, primary_keys=id_from)


def schema_from_csv(path: str, name: str = "CsvSchema", **kwargs: Any) -> SchemaMetaclass:
    import pandas as pd

    df = pd.read_csv(path, nrows=100, **kwargs)
    return schema_from_pandas(df, name=name)


def is_subschema(sub: SchemaMetaclass, sup: SchemaMetaclass) -> bool:
    sup_d = sup.dtypes()
    return all(n in sup_d and dt.is_subtype(d, sup_d[n]) for n, d in sub.dtypes().items())
