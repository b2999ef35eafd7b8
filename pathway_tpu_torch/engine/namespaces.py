"""Vectorized implementations of the ``.dt`` / ``.str`` / ``.num`` expression
namespaces.

Covers the engine surface of the reference's datetime/duration/string expression
variants (``src/engine/expression.rs``, listed in ``python/pathway/engine.pyi:226-440``)
with columnar kernels: datetime math via numpy datetime64/pandas, string ops via
vectorized object-array ufuncs.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from pathway_tpu_torch.internals import dtype as dt

_REGISTRY: dict[tuple[str, str], Callable] = {}


def register(ns: str, name: str):
    def deco(fn):
        _REGISTRY[(ns, name)] = fn
        return fn

    return deco


def call_method(ns: str, name: str, args: list[np.ndarray]) -> np.ndarray:
    fn = _REGISTRY.get((ns, name))
    if fn is None:
        raise NotImplementedError(f"method {ns}.{name} not implemented")
    return fn(*args)


def method_result_dtype(ns: str, name: str, arg_dtypes: list[dt.DType]) -> dt.DType:
    if ns == "num":
        return arg_dtypes[0]
    if ns == "dt" and name in ("round", "floor"):
        return arg_dtypes[0]
    if ns == "gen" and name == "to_string":
        return dt.STR
    return dt.ANY


def _scalar(arr):
    """Extract the scalar of a broadcast const column."""
    return arr[0] if len(arr) else None


# ---------------------------------------------------------------- dt namespace

_DT_FIELDS = {
    "nanosecond": lambda s: s.dt.nanosecond + s.dt.microsecond * 1000,
    "microsecond": lambda s: s.dt.microsecond,
    "millisecond": lambda s: s.dt.microsecond // 1000,
    "second": lambda s: s.dt.second,
    "minute": lambda s: s.dt.minute,
    "hour": lambda s: s.dt.hour,
    "day": lambda s: s.dt.day,
    "month": lambda s: s.dt.month,
    "year": lambda s: s.dt.year,
    "day_of_week": lambda s: s.dt.dayofweek,
}

for _name, _fn in _DT_FIELDS.items():

    def _make(fn):
        def impl(arr):
            import pandas as pd  # only the datetime methods need it
            s = pd.Series(arr.astype("datetime64[ns]"))
            return fn(s).to_numpy(dtype=np.int64)

        return impl

    register("dt", _name)(_make(_fn))


@register("dt", "timestamp")
def _dt_timestamp(arr, unit_arr):
    unit = _scalar(unit_arr) or "ns"
    ns = arr.astype("datetime64[ns]").astype(np.int64)
    div = {"ns": 1, "us": 1_000, "ms": 1_000_000, "s": 1_000_000_000}[unit]
    if div == 1:
        return ns
    return ns / div


@register("dt", "strftime")
def _dt_strftime(arr, fmt_arr):
    import pandas as pd  # only the datetime methods need it
    fmt = _scalar(fmt_arr)
    s = pd.Series(arr.astype("datetime64[ns]"))
    return s.dt.strftime(fmt).to_numpy(dtype=object)


@register("dt", "strptime")
def _dt_strptime(arr, fmt_arr):
    import pandas as pd  # only the datetime methods need it
    fmt = _scalar(fmt_arr)
    s = pd.to_datetime(pd.Series(arr, dtype=object), format=fmt, utc=False)
    try:
        s = s.dt.tz_convert(None)
    except TypeError:
        pass
    return s.to_numpy(dtype="datetime64[ns]")


@register("dt", "to_utc")
def _dt_to_utc(arr, tz_arr):
    import pandas as pd  # only the datetime methods need it
    tz = _scalar(tz_arr)
    s = pd.Series(arr.astype("datetime64[ns]")).dt.tz_localize(tz, ambiguous="NaT")
    return s.dt.tz_convert("UTC").dt.tz_localize(None).to_numpy(dtype="datetime64[ns]")


@register("dt", "to_naive_in_timezone")
def _dt_to_naive(arr, tz_arr):
    import pandas as pd  # only the datetime methods need it
    tz = _scalar(tz_arr)
    s = pd.Series(arr.astype("datetime64[ns]")).dt.tz_localize("UTC").dt.tz_convert(tz)
    return s.dt.tz_localize(None).to_numpy(dtype="datetime64[ns]")


def _dur_ns(arr) -> np.ndarray:
    return arr.astype("timedelta64[ns]").astype(np.int64)


@register("dt", "round")
def _dt_round(arr, dur_arr):
    dur = _scalar(dur_arr)
    dur_ns = int(np.timedelta64(dur).astype("timedelta64[ns]").astype(np.int64))
    if arr.dtype.kind == "M":
        ns = arr.astype("datetime64[ns]").astype(np.int64)
        out = ((ns + dur_ns // 2) // dur_ns) * dur_ns
        return out.astype("datetime64[ns]")
    ns = _dur_ns(arr)
    return (((ns + dur_ns // 2) // dur_ns) * dur_ns).astype("timedelta64[ns]")


@register("dt", "floor")
def _dt_floor(arr, dur_arr):
    dur = _scalar(dur_arr)
    dur_ns = int(np.timedelta64(dur).astype("timedelta64[ns]").astype(np.int64))
    if arr.dtype.kind == "M":
        ns = arr.astype("datetime64[ns]").astype(np.int64)
        return ((ns // dur_ns) * dur_ns).astype("datetime64[ns]")
    ns = _dur_ns(arr)
    return ((ns // dur_ns) * dur_ns).astype("timedelta64[ns]")


_DUR_DIVS = {
    "nanoseconds": 1,
    "microseconds": 1_000,
    "milliseconds": 1_000_000,
    "seconds": 1_000_000_000,
    "minutes": 60 * 1_000_000_000,
    "hours": 3600 * 1_000_000_000,
    "days": 86400 * 1_000_000_000,
    "weeks": 7 * 86400 * 1_000_000_000,
}

for _name, _div in _DUR_DIVS.items():

    def _make_dur(div):
        def impl(arr):
            return _dur_ns(arr) // div

        return impl

    register("dt", _name)(_make_dur(_div))


@register("dt", "from_timestamp")
def _dt_from_timestamp(arr, unit_arr):
    unit = _scalar(unit_arr)
    mul = {"ns": 1, "us": 1_000, "ms": 1_000_000, "s": 1_000_000_000}[unit]
    vals = np.asarray(arr, dtype=np.float64) * mul
    return vals.astype(np.int64).astype("datetime64[ns]")


register("dt", "utc_from_timestamp")(_REGISTRY[("dt", "from_timestamp")])


# --------------------------------------------------------------- str namespace


def _obj_map(fn, *arrays):
    out = np.empty(len(arrays[0]), dtype=object)
    for i, row in enumerate(zip(*arrays)):
        out[i] = fn(*row)
    return out


def _str_method(name: str):
    def impl(arr, *extras):
        def fn(v, *ex):
            if v is None:
                return None
            return getattr(v, name)(*ex)

        return _obj_map(fn, arr, *extras)

    return impl


def _str_strip_method(name: str):
    def impl(arr, chars):
        def fn(v, c):
            if v is None:
                return None
            return getattr(v, name)(c)  # chars=None strips whitespace

        return _obj_map(fn, arr, chars)

    return impl


register("str", "lower")(_str_method("lower"))
register("str", "upper")(_str_method("upper"))
register("str", "title")(_str_method("title"))
register("str", "swapcase")(_str_method("swapcase"))
register("str", "strip")(_str_strip_method("strip"))
register("str", "lstrip")(_str_strip_method("lstrip"))
register("str", "rstrip")(_str_strip_method("rstrip"))


@register("str", "len")
def _str_len(arr):
    return np.fromiter((len(v) if v is not None else -1 for v in arr), dtype=np.int64, count=len(arr))


@register("str", "reversed")
def _str_reversed(arr):
    return _obj_map(lambda v: v[::-1] if v is not None else None, arr)


@register("str", "startswith")
def _str_startswith(arr, pre):
    return _obj_map(lambda v, p: v.startswith(p), arr, pre).astype(bool)


@register("str", "endswith")
def _str_endswith(arr, suf):
    return _obj_map(lambda v, s: v.endswith(s), arr, suf).astype(bool)


@register("str", "count")
def _str_count(arr, sub):
    return _obj_map(lambda v, s: v.count(s), arr, sub).astype(np.int64)


@register("str", "find")
def _str_find(arr, sub):
    return _obj_map(lambda v, s: v.find(s), arr, sub).astype(np.int64)


@register("str", "rfind")
def _str_rfind(arr, sub):
    return _obj_map(lambda v, s: v.rfind(s), arr, sub).astype(np.int64)


@register("str", "replace")
def _str_replace(arr, old, new):
    return _obj_map(lambda v, o, n: v.replace(o, n), arr, old, new)


@register("str", "split")
def _str_split(arr, sep, maxsplit):
    return _obj_map(lambda v, s, m: tuple(v.split(s, m)), arr, sep, maxsplit)


@register("str", "slice")
def _str_slice(arr, start, end):
    return _obj_map(lambda v, s, e: v[s:e], arr, start, end)


def _parse_impl(conv, np_dtype):
    def impl(arr, optional_arr):
        optional = bool(_scalar(optional_arr))
        from pathway_tpu_torch.internals.errors import ERROR

        def fn(v):
            try:
                return conv(v)
            except (ValueError, TypeError):
                return None if optional else ERROR

        out = _obj_map(fn, arr)
        if not optional and not any(o is ERROR or o is None for o in out):
            return out.astype(np_dtype)
        return out

    return impl


def _parse_bool_scalar(v: str) -> bool:
    lv = v.strip().lower()
    if lv in ("true", "yes", "1", "on", "t", "y"):
        return True
    if lv in ("false", "no", "0", "off", "f", "n"):
        return False
    raise ValueError(f"cannot parse {v!r} as bool")


register("str", "parse_int")(_parse_impl(int, np.int64))
register("str", "parse_float")(_parse_impl(float, np.float64))
register("str", "parse_bool")(_parse_impl(_parse_bool_scalar, np.bool_))


# --------------------------------------------------------------- num namespace


@register("num", "abs")
def _num_abs(arr):
    return np.abs(arr)


@register("num", "round")
def _num_round(arr, dec):
    d = _scalar(dec)
    return np.round(arr, int(d) if d is not None else 0)


@register("num", "fill_na")
def _num_fill_na(arr, default):
    d = _scalar(default)
    if arr.dtype.kind == "f":
        return np.where(np.isnan(arr), d, arr)
    if arr.dtype == object:
        return _obj_map(lambda v: d if v is None or (isinstance(v, float) and np.isnan(v)) else v, arr)
    return arr


# --------------------------------------------------------------- gen namespace


@register("gen", "to_string")
def _gen_to_string(arr):
    from pathway_tpu_torch.internals.json import Json

    def fn(v):
        if v is None:
            return "None"
        if isinstance(v, Json):
            return str(v)
        if isinstance(v, (np.bool_, bool)):
            return "True" if v else "False"
        return str(v)

    return _obj_map(fn, arr)
