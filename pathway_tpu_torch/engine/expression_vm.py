"""Columnar expression evaluator.

The engine counterpart of the reference's interpreted per-row expression VM
(``src/engine/expression.rs``: typed enum variants evaluated row by row). Here every
AST node evaluates over a **whole delta block** at once: numpy ufuncs for numeric
columns, per-row python fallbacks only for object columns and ``pw.apply`` UDFs.
Async applies run batched through an event loop — the microbatch replacement for the
reference's one-boxed-future-per-row dispatch (``src/engine/dataflow.rs:1924-1962``).

Carried from ``pathway_tpu/engine/expression_vm.py`` without ``trace_fused``,
the traceable mirror that feeds the fused device tier (a later slice).
"""

from __future__ import annotations

import operator as _op
from typing import Any, Callable

import numpy as np

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import expression as expr_mod
from pathway_tpu_torch.internals.errors import ERROR, report_error
from pathway_tpu_torch.internals.expression import (
    ApplyExpression,
    AsyncApplyExpression,
    BatchApplyExpression,
    BinOpExpression,
    CastExpression,
    CoalesceExpression,
    ColumnExpression,
    ColumnReference,
    ConstExpression,
    ConvertExpression,
    DeclareTypeExpression,
    FillErrorExpression,
    GetExpression,
    IfElseExpression,
    IsNoneExpression,
    IsNotNoneExpression,
    MakeTupleExpression,
    MethodCallExpression,
    PointerExpression,
    ReducerExpression,
    RequireExpression,
    UnOpExpression,
    UnwrapExpression,
)
from pathway_tpu_torch.internals.json import Json
from pathway_tpu_torch.internals.keys import row_keys


class EvalContext:
    """Resolves column references to arrays for one block."""

    def __init__(
        self,
        lookup: Callable[[ColumnReference], np.ndarray],
        n: int,
    ):
        self.lookup = lookup
        self.n = n


def _is_missing(v: Any) -> bool:
    if v is None:
        return True
    if isinstance(v, float) and np.isnan(v):
        return True
    return False


def _none_mask(arr: np.ndarray) -> np.ndarray:
    kind = arr.dtype.kind
    if kind == "f":
        return np.isnan(arr)
    if kind in ("M", "m"):
        return np.isnat(arr)
    if kind == "O":
        return np.fromiter((_is_missing(v) for v in arr), dtype=bool, count=len(arr))
    return np.zeros(len(arr), dtype=bool)


_BINOPS_NUM = {
    "+": _op.add,
    "-": _op.sub,
    "*": _op.mul,
    "/": np.true_divide,
    "//": np.floor_divide,
    "%": np.mod,
    "**": np.power,
    "@": np.matmul,
    "==": _op.eq,
    "!=": _op.ne,
    "<": _op.lt,
    "<=": _op.le,
    ">": _op.gt,
    ">=": _op.ge,
    "&": _op.and_,
    "|": _op.or_,
    "^": _op.xor,
}

_BINOPS_PY = dict(_BINOPS_NUM)
_BINOPS_PY.update({"/": _op.truediv, "//": _op.floordiv, "%": _op.mod, "**": _op.pow})


def _obj_binop(op: str, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    fn = _BINOPS_PY[op]
    out = np.empty(len(a), dtype=object)
    for i in range(len(a)):
        x, y = a[i], b[i]
        if x is ERROR or y is ERROR:
            out[i] = ERROR
        elif op in ("==", "!="):
            out[i] = fn(x, y)
        elif _is_missing(x) or _is_missing(y):
            out[i] = None
        else:
            try:
                out[i] = fn(x, y)
            except Exception as e:
                out[i] = report_error(f"{op}: {e!r}")
    return out


def eval_expr(expr: ColumnExpression, ctx: EvalContext) -> np.ndarray:
    """Evaluate an expression over a block; returns an array of length ctx.n."""
    n = ctx.n

    if isinstance(expr, ColumnReference):
        return ctx.lookup(expr)

    if isinstance(expr, ConstExpression):
        v = expr.value
        d = dt.dtype_of_value(v)
        npd = d.np_dtype
        if npd == np.dtype(object):
            arr = np.empty(n, dtype=object)
            arr[:] = [v] * n
            return arr
        return np.full(n, v, dtype=npd)

    if isinstance(expr, BinOpExpression):
        a = eval_expr(expr.left, ctx)
        b = eval_expr(expr.right, ctx)
        return _eval_binop(expr.op, a, b)

    if isinstance(expr, UnOpExpression):
        a = eval_expr(expr.operand, ctx)
        if a.dtype == object:
            fn = _op.neg if expr.op == "-" else _op.invert
            return np.array(
                [ERROR if v is ERROR else (None if v is None else fn(v)) for v in a],
                dtype=object,
            )
        if expr.op == "-":
            return -a
        if a.dtype.kind == "b":
            return ~a
        return np.invert(a)

    if isinstance(expr, IsNotNoneExpression):
        return ~_none_mask(eval_expr(expr.operand, ctx))

    if isinstance(expr, IsNoneExpression):
        return _none_mask(eval_expr(expr.operand, ctx))

    if isinstance(expr, IfElseExpression):
        c = eval_expr(expr.if_, ctx)
        t = eval_expr(expr.then, ctx)
        e = eval_expr(expr.else_, ctx)
        if c.dtype == object:
            c = np.array([bool(v) if v is not None and v is not ERROR else False for v in c])
        if t.dtype != e.dtype:
            t = t.astype(object) if t.dtype == object or e.dtype == object else t.astype(np.result_type(t, e))
            e = e.astype(t.dtype)
        return np.where(c, t, e)

    if isinstance(expr, CoalesceExpression):
        out = eval_expr(expr.args[0], ctx)
        mask = _none_mask(out)
        i = 1
        while mask.any() and i < len(expr.args):
            nxt = eval_expr(expr.args[i], ctx)
            if out.dtype != nxt.dtype:
                out = out.astype(object)
                nxt = nxt.astype(object)
            out = np.where(mask, nxt, out)
            mask = _none_mask(out)
            i += 1
        # tighten dtype if fully filled
        if out.dtype == object and not mask.any():
            try:
                tight = np.asarray(list(out))
                if tight.dtype.kind in "ifb":
                    return tight
            except Exception:
                pass
        return out

    if isinstance(expr, RequireExpression):
        val = eval_expr(expr.val, ctx)
        bad = np.zeros(n, dtype=bool)
        for c in expr.conds:
            bad |= _none_mask(eval_expr(c, ctx))
        if bad.any():
            out = val.astype(object)
            out[bad] = None
            return out
        return val

    if isinstance(expr, AsyncApplyExpression):
        return _eval_async_apply(expr, ctx)

    if isinstance(expr, BatchApplyExpression):
        return _eval_batch_apply(expr, ctx)

    if isinstance(expr, ApplyExpression):
        return _eval_apply(expr, ctx)

    if isinstance(expr, CastExpression):
        a = eval_expr(expr.expr, ctx)
        return _cast_array(a, expr.target)

    if isinstance(expr, ConvertExpression):
        a = eval_expr(expr.expr, ctx)
        return _convert_array(a, expr.target, unwrap=expr.unwrap_)

    if isinstance(expr, DeclareTypeExpression):
        return eval_expr(expr.expr, ctx)

    if isinstance(expr, UnwrapExpression):
        a = eval_expr(expr.expr, ctx)
        mask = _none_mask(a)
        if mask.any():
            if a.dtype != object:
                a = a.astype(object)
            a[mask] = ERROR
        return a

    if isinstance(expr, FillErrorExpression):
        a = eval_expr(expr.expr, ctx)
        if a.dtype == object:
            repl = eval_expr(expr.replacement, ctx)
            bad = np.fromiter((v is ERROR for v in a), dtype=bool, count=len(a))
            if bad.any():
                out = a.copy()
                out[bad] = repl[bad]
                return out
        return a

    if isinstance(expr, MakeTupleExpression):
        arrays = [eval_expr(a, ctx) for a in expr.args]
        out = np.empty(n, dtype=object)
        for i in range(n):
            out[i] = tuple(arr[i] for arr in arrays)
        return out

    if isinstance(expr, GetExpression):
        return _eval_get(expr, ctx)

    if isinstance(expr, MethodCallExpression):
        from pathway_tpu_torch.engine.namespaces import call_method

        args = [eval_expr(a, ctx) for a in expr.args]
        return call_method(expr.namespace, expr.name, args)

    if isinstance(expr, PointerExpression):
        if not expr.args:
            # zero-arg pointer = the global-reduce singleton row
            # (``total.ix_ref(context=t)`` after ``t.reduce(...)``)
            from pathway_tpu_torch.engine.operators import GroupByNode

            return np.full(n, GroupByNode.GLOBAL_KEY, dtype=np.uint64)
        cols = [np.asarray(eval_expr(a, ctx)) for a in expr.args]
        salt = 0 if expr.instance is None else hash(expr.instance) & 0xFFFF
        return row_keys(cols, n=n, salt=salt)

    if isinstance(expr, ReducerExpression):
        raise RuntimeError(
            "reducer used outside groupby().reduce(...) — reducers are not row-wise"
        )

    raise NotImplementedError(f"cannot evaluate {type(expr).__name__}")


def _eval_binop(op: str, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    if a.dtype == object or b.dtype == object:
        if a.dtype != object:
            a = a.astype(object)
        if b.dtype != object:
            b = b.astype(object)
        return _obj_binop(op, a, b)
    # uint64 pointers: numpy handles ==/!= fine; arithmetic not meaningful
    if op in ("//", "%", "/") and b.dtype.kind in ("i", "u"):
        if (b == 0).any():
            return _obj_binop(op, a.astype(object), b.astype(object))
    if op == "/" and a.dtype.kind in ("i", "u") and b.dtype.kind in ("i", "u"):
        return np.true_divide(a, b)
    if op in ("&", "|", "^") and (a.dtype.kind == "b") != (b.dtype.kind == "b"):
        a = a.astype(np.int64) if a.dtype.kind == "b" else a
        b = b.astype(np.int64) if b.dtype.kind == "b" else b
    try:
        with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
            return _BINOPS_NUM[op](a, b)
    except TypeError:
        return _obj_binop(op, a.astype(object), b.astype(object))


def _eval_apply(expr: ApplyExpression, ctx: EvalContext) -> np.ndarray:
    arrays = [eval_expr(a, ctx) for a in expr.args_]
    kw_names = list(expr.kwargs_.keys())
    kw_arrays = [eval_expr(expr.kwargs_[k], ctx) for k in kw_names]
    out = np.empty(ctx.n, dtype=object)
    fn = expr.fn
    for i in range(ctx.n):
        args = [arr[i] for arr in arrays]
        kwargs = {k: arr[i] for k, arr in zip(kw_names, kw_arrays)}
        if any(v is ERROR for v in args) or any(v is ERROR for v in kwargs.values()):
            out[i] = ERROR
            continue
        if expr.propagate_none and (any(v is None for v in args) or any(v is None for v in kwargs.values())):
            out[i] = None
            continue
        try:
            out[i] = fn(*args, **kwargs)
        except Exception as e:
            out[i] = report_error(f"apply {getattr(fn, '__name__', fn)!s}: {e!r}")
    return _tighten(out, expr.return_type)


def _eval_batch_apply(expr: "BatchApplyExpression", ctx: EvalContext) -> np.ndarray:
    """One call over the whole block: fn(col0_list, col1_list, ...) -> list."""
    arrays = [eval_expr(a, ctx) for a in expr.args_]
    kw_names = list(expr.kwargs_.keys())
    kw_arrays = [eval_expr(expr.kwargs_[k], ctx) for k in kw_names]
    all_arrays = list(arrays) + kw_arrays
    out = np.empty(ctx.n, dtype=object)
    run: list[int] = []
    for i in range(ctx.n):
        if any(a[i] is ERROR for a in all_arrays):
            out[i] = ERROR
        elif expr.propagate_none and any(a[i] is None for a in all_arrays):
            out[i] = None
        else:
            run.append(i)
    idx = np.asarray(run, dtype=np.int64)
    if len(idx):
        args = [[arr[i] for i in idx] for arr in arrays]
        kwargs = {k: [arr[i] for i in idx] for k, arr in zip(kw_names, kw_arrays)}
        try:
            results = expr.fn(*args, **kwargs)
            if len(results) != len(idx):
                raise ValueError(
                    f"batch UDF returned {len(results)} results for {len(idx)} rows"
                )
            for j, i in enumerate(idx):
                out[i] = results[j]
        except Exception:
            # row isolation: retry each row alone so one bad input doesn't error
            # the whole block (matches per-row ApplyExpression semantics; the
            # batch is already on the failing path so the cost is irrelevant)
            for i in idx:
                try:
                    r = expr.fn(
                        *[[arr[i]] for arr in arrays],
                        **{k: [arr[i]] for k, arr in zip(kw_names, kw_arrays)},
                    )
                    out[i] = r[0]
                except Exception as e:
                    out[i] = report_error(
                        f"apply {getattr(expr.fn, '__name__', expr.fn)!s}: {e!r}"
                    )
    return _tighten(out, expr.return_type)


def _eval_async_apply(expr: AsyncApplyExpression, ctx: EvalContext) -> np.ndarray:
    """Batched dispatch of async UDFs: one gather per block."""
    import asyncio

    arrays = [eval_expr(a, ctx) for a in expr.args_]
    kw_names = list(expr.kwargs_.keys())
    kw_arrays = [eval_expr(expr.kwargs_[k], ctx) for k in kw_names]
    fn = expr.fn

    async def run_all():
        async def one(i):
            try:
                return await fn(
                    *[arr[i] for arr in arrays],
                    **{k: arr[i] for k, arr in zip(kw_names, kw_arrays)},
                )
            except Exception as e:
                return report_error(
                    f"async apply {getattr(fn, '__name__', fn)!s}: {e!r}"
                )

        return await asyncio.gather(*[one(i) for i in range(ctx.n)])

    results = _run_coro(run_all())
    out = np.empty(ctx.n, dtype=object)
    out[:] = results
    return _tighten(out, expr.return_type)


def _run_coro(coro):
    import asyncio

    try:
        asyncio.get_running_loop()
    except RuntimeError:
        return asyncio.run(coro)
    # already inside a loop (rest_connector handlers) — run in a helper thread
    import concurrent.futures

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        return pool.submit(asyncio.run, coro).result()


def _tighten(out: np.ndarray, return_type: dt.DType) -> np.ndarray:
    npd = return_type.np_dtype
    if npd != np.dtype(object):
        try:
            if not any(v is ERROR or v is None for v in out):
                return out.astype(npd)
        except Exception:
            pass
    return out


def _cast_array(a: np.ndarray, target: dt.DType) -> np.ndarray:
    npd = target.np_dtype
    if a.dtype == object:
        conv = {dt.INT: int, dt.FLOAT: float, dt.BOOL: bool, dt.STR: str}.get(
            dt.unoptionalize(target)
        )
        if conv is None:
            return a
        out = np.empty(len(a), dtype=object)
        for i, v in enumerate(a):
            if v is None or v is ERROR:
                out[i] = v
            else:
                try:
                    out[i] = conv(v)
                except (ValueError, TypeError) as e:
                    out[i] = report_error(f"cast to {target}: {e!r}")
        return _tighten(out, target)
    if npd == np.dtype(object):
        if dt.unoptionalize(target) == dt.STR:
            return np.array([str(v) for v in a], dtype=object)
        return a.astype(object)
    if a.dtype.kind == "f" and npd.kind == "i":
        return np.trunc(a).astype(npd)  # cast float→int truncates toward zero
    return a.astype(npd)


def _convert_array(a: np.ndarray, target: dt.DType, unwrap: bool) -> np.ndarray:
    """Json/Any → typed conversion (``as_int``/``as_float``/…)."""
    t = dt.unoptionalize(target)
    conv = {dt.INT: int, dt.FLOAT: float, dt.BOOL: bool, dt.STR: str}.get(t)
    out = np.empty(len(a), dtype=object)
    for i, v in enumerate(a):
        if isinstance(v, Json):
            v = v.value
        if v is None or v is ERROR:
            out[i] = ERROR if (unwrap and v is None) else v
            continue
        try:
            if conv is str and not isinstance(v, str):
                out[i] = ERROR  # json as_str only converts strings
            else:
                out[i] = conv(v) if conv else v
        except (ValueError, TypeError):
            out[i] = ERROR
    return _tighten(out, target)


def _eval_get(expr: GetExpression, ctx: EvalContext) -> np.ndarray:
    obj = eval_expr(expr.obj, ctx)
    idx = eval_expr(expr.index, ctx)
    default = eval_expr(expr.default, ctx) if expr.default is not None else None
    out = np.empty(ctx.n, dtype=object)
    for i in range(ctx.n):
        o, j = obj[i], idx[i]
        if o is ERROR or j is ERROR:
            out[i] = ERROR
            continue
        try:
            if isinstance(o, Json):
                v = o.value[j]
                out[i] = Json(v) if isinstance(v, (dict, list)) else v
            else:
                out[i] = o[j]
        except (KeyError, IndexError, TypeError):
            if expr.check_if_exists:
                out[i] = default[i] if default is not None else None
            else:
                out[i] = ERROR
    return out


# ---------------------------------------------------------------- fused tracing
#
# The chain-fusion pass (``engine/fusion.py``) lowers runs of filter/map
# expressions into ONE jitted tick kernel. Only a whitelisted subset lowers:
# every op must be bit-identical between the numpy path above and XLA
# (elementwise IEEE float ops, exact integer ops, comparisons) and must have
# NO value-dependent fallback (integer division routes to the object path on
# a zero divisor, so it can never fuse). ``infer_fused_dtype`` is the static
# eligibility check — it mirrors the dtype flow of ``eval_expr`` and returns
# None the moment an expression leaves the whitelist. The port runs the
# whitelisted subset as ``compile_fast``'s flat host program; the device
# lowering is a later slice.

#: binops that lower: elementwise, value-independent, bit-identical on XLA
_FUSE_CMP = {"==", "!=", "<", "<=", ">", ">="}
_FUSE_ARITH = {"+", "-", "*"}
_FUSE_BITS = {"&", "|", "^"}


def infer_fused_dtype(
    expr: ColumnExpression, dtypes: dict[str, np.dtype]
) -> np.dtype | None:
    """The numpy dtype ``expr`` evaluates to under the fused-kernel
    whitelist given input column dtypes, or None when it cannot lower."""
    if isinstance(expr, ColumnReference):
        if expr.name == "id":
            return np.dtype(np.uint64)
        d = dtypes.get(expr.name)
        return d if d is not None and d.kind in "iufb" else None

    if isinstance(expr, ConstExpression):
        d = dt.dtype_of_value(expr.value).np_dtype
        return d if d.kind in "ifb" else None

    if isinstance(expr, DeclareTypeExpression):
        return infer_fused_dtype(expr.expr, dtypes)

    if isinstance(expr, BinOpExpression):
        a = infer_fused_dtype(expr.left, dtypes)
        b = infer_fused_dtype(expr.right, dtypes)
        if a is None or b is None:
            return None
        op = expr.op
        if op in _FUSE_CMP:
            if a.kind == "b" or b.kind == "b":
                # bool comparisons only against bool, and only for equality
                ok = a.kind == "b" and b.kind == "b" and op in ("==", "!=")
                return np.dtype(bool) if ok else None
            if {"u", "i"} <= {a.kind, b.kind}:
                return None  # numpy promotes u64 vs i64 through float64
            return np.dtype(bool)
        if op in _FUSE_ARITH:
            if a.kind not in "if" or b.kind not in "if":
                return None  # uints / bools take numpy-specific promotions
            return np.result_type(a, b)
        if op in _FUSE_BITS:
            # eval_expr casts a lone bool operand to int64 before the op
            if a.kind == "b" and b.kind == "b":
                return np.dtype(bool)
            aa = np.dtype(np.int64) if a.kind == "b" else a
            bb = np.dtype(np.int64) if b.kind == "b" else b
            if aa.kind not in "iu" or bb.kind not in "iu" or aa.kind != bb.kind:
                return None
            return np.result_type(aa, bb)
        return None

    if isinstance(expr, UnOpExpression):
        a = infer_fused_dtype(expr.operand, dtypes)
        if a is None:
            return None
        if expr.op == "-":
            return a if a.kind in "if" else None
        return a if a.kind in "bi" else None  # ~

    if isinstance(expr, (IsNoneExpression, IsNotNoneExpression)):
        a = infer_fused_dtype(expr.operand, dtypes)
        return np.dtype(bool) if a is not None else None

    if isinstance(expr, IfElseExpression):
        c = infer_fused_dtype(expr.if_, dtypes)
        t = infer_fused_dtype(expr.then, dtypes)
        e = infer_fused_dtype(expr.else_, dtypes)
        if c is None or c.kind != "b" or t is None or t != e:
            return None
        return t

    return None


def compile_fast(
    expr: ColumnExpression, dtypes: dict[str, np.dtype], slots: dict[str, int]
) -> Callable:
    """Compile a whitelisted expression into a flat numpy closure
    ``fn(regs, keys) -> array | numpy scalar`` over a REGISTER list
    (``slots`` maps visible column names to register indices) — the
    byte-identical fast lane of the composed-segment numpy path. Call only
    after :func:`infer_fused_dtype` accepted the expression under
    ``dtypes``.

    Values are identical to :func:`eval_expr`: constants become TYPED numpy
    scalars (numpy treats a typed scalar operand exactly like the full
    const array ``eval_expr`` materializes), ops are the same ufuncs, the
    bool→int64 cast of a mixed bitwise op is baked in at compile time. The
    closure skips the recursion, isinstance dispatch and per-op errstate of
    the generic VM — callers wrap one ``np.errstate`` around the whole
    segment instead."""
    if isinstance(expr, ColumnReference):
        if expr.name == "id":
            return lambda regs, keys: keys
        i = slots[expr.name]
        return lambda regs, keys: regs[i]

    if isinstance(expr, ConstExpression):
        npd = dt.dtype_of_value(expr.value).np_dtype
        const = npd.type(expr.value)
        return lambda regs, keys: const

    if isinstance(expr, DeclareTypeExpression):
        return compile_fast(expr.expr, dtypes, slots)

    if isinstance(expr, BinOpExpression):
        fa = compile_fast(expr.left, dtypes, slots)
        fb = compile_fast(expr.right, dtypes, slots)
        op = expr.op
        if op in _FUSE_BITS:
            da = infer_fused_dtype(expr.left, dtypes)
            db = infer_fused_dtype(expr.right, dtypes)
            if (da.kind == "b") != (db.kind == "b"):
                # eval_expr casts a lone bool operand to int64 first
                if da.kind == "b":
                    fa = _fast_to_i64(fa)
                else:
                    fb = _fast_to_i64(fb)
        fn = _FAST_UFUNCS[op]
        return lambda regs, keys: fn(fa(regs, keys), fb(regs, keys))

    if isinstance(expr, UnOpExpression):
        fa = compile_fast(expr.operand, dtypes, slots)
        fn = np.negative if expr.op == "-" else np.invert
        return lambda regs, keys: fn(fa(regs, keys))

    if isinstance(expr, IsNotNoneExpression):
        fa = compile_fast(expr.operand, dtypes, slots)
        if infer_fused_dtype(expr.operand, dtypes).kind == "f":
            return lambda regs, keys: ~np.isnan(fa(regs, keys))
        return lambda regs, keys: np.ones(len(keys), dtype=bool)

    if isinstance(expr, IsNoneExpression):
        fa = compile_fast(expr.operand, dtypes, slots)
        if infer_fused_dtype(expr.operand, dtypes).kind == "f":
            return lambda regs, keys: np.isnan(fa(regs, keys))
        return lambda regs, keys: np.zeros(len(keys), dtype=bool)

    if isinstance(expr, IfElseExpression):
        fc = compile_fast(expr.if_, dtypes, slots)
        ft = compile_fast(expr.then, dtypes, slots)
        fe = compile_fast(expr.else_, dtypes, slots)
        return lambda regs, keys: np.where(
            fc(regs, keys), ft(regs, keys), fe(regs, keys)
        )

    raise NotImplementedError(
        f"compile_fast: {type(expr).__name__} is outside the fused whitelist"
    )


def _fast_to_i64(f: Callable) -> Callable:
    def g(env, keys):
        v = f(env, keys)
        return v.astype(np.int64) if isinstance(v, np.ndarray) else np.int64(v)

    return g


#: the ufuncs behind _BINOPS_NUM's operators, called directly (operator.gt
#: on arrays dispatches to the same ufunc; naming them skips a bounce)
_FAST_UFUNCS = {
    "+": np.add,
    "-": np.subtract,
    "*": np.multiply,
    "==": np.equal,
    "!=": np.not_equal,
    "<": np.less,
    "<=": np.less_equal,
    ">": np.greater,
    ">=": np.greater_equal,
    "&": np.bitwise_and,
    "|": np.bitwise_or,
    "^": np.bitwise_xor,
}


def compile_rowwise(
    exprs: dict[str, ColumnExpression],
    lookup_factory: Callable[["Any"], Callable[[ColumnReference], np.ndarray]],
) -> Callable:
    """Compile a dict of named expressions into a block program.

    ``lookup_factory(batch)`` must return a resolver for column references.
    """

    def program(batch) -> dict[str, np.ndarray]:
        ctx = EvalContext(lookup_factory(batch), len(batch))
        return {name: np.asarray(eval_expr(e, ctx)) for name, e in exprs.items()}

    return program
