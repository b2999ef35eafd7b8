"""``pw.Json`` wrapper (reference: ``python/pathway/internals/json.py``) — an
immutable-ish view over parsed JSON values with convenience accessors."""

from __future__ import annotations

import json as _json
from typing import Any


class Json:
    __slots__ = ("_value",)

    def __init__(self, value: Any = None):
        if isinstance(value, Json):
            value = value._value
        self._value = value

    @property
    def value(self) -> Any:
        return self._value

    @classmethod
    def parse(cls, s: str | bytes) -> "Json":
        return cls(_json.loads(s))

    @classmethod
    def dumps(cls, obj: Any) -> str:
        if isinstance(obj, Json):
            obj = obj._value
        return _json.dumps(obj, separators=(",", ":"), sort_keys=True, default=_default)

    def __getitem__(self, item: Any) -> "Json":
        return Json(self._value[item])

    def get(self, key: Any, default: Any = None) -> Any:
        if isinstance(self._value, dict):
            v = self._value.get(key, default)
            return Json(v) if isinstance(v, (dict, list)) else v
        return default

    def as_int(self) -> int:
        return int(self._value)

    def as_float(self) -> float:
        return float(self._value)

    def as_str(self) -> str:
        return str(self._value) if not isinstance(self._value, str) else self._value

    def as_bool(self) -> bool:
        return bool(self._value)

    def as_list(self) -> list:
        return list(self._value)

    def as_dict(self) -> dict:
        return dict(self._value)

    def __len__(self) -> int:
        return len(self._value)

    def __iter__(self):
        return iter(self._value)

    def __eq__(self, other: object) -> bool:
        if isinstance(other, Json):
            return self._value == other._value
        return self._value == other

    def __hash__(self) -> int:
        return hash(Json.dumps(self._value))

    def __repr__(self) -> str:
        return f"pw.Json({self._value!r})"

    def __str__(self) -> str:
        return Json.dumps(self._value)

    NULL: "Json"


def _default(o: Any) -> Any:
    if isinstance(o, Json):
        return o._value
    raise TypeError(f"not JSON serializable: {type(o)}")


Json.NULL = Json(None)
