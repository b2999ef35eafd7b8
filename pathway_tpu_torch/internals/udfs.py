"""``pw.UDF`` / ``@pw.udf`` and executors.

Mirrors the reference's ``internals/udfs/`` (``UDF``/``udf`` at
``__init__.py:67,273``; executors ``executors.py:95-226`` — Sync, Async with
capacity/timeout/retry, FullyAsync; caches ``caches.py:23-121``; retries
``retries.py``). Async UDFs are batched per delta block and dispatched through one
event-loop gather — the microbatch replacement for the reference's per-row boxed
futures (``src/engine/dataflow.rs:1924``).
"""

from __future__ import annotations

import asyncio
import functools
import hashlib
import os
import pickle
import random
import time as _time
from typing import Any, Callable

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import expression as expr_mod


# --------------------------------------------------------------------- retries


class RetryStrategy:
    def sleep_durations(self) -> list[float]:
        return []


class NoRetryStrategy(RetryStrategy):
    pass


class ExponentialBackoffRetryStrategy(RetryStrategy):
    def __init__(
        self,
        max_retries: int = 3,
        initial_delay: int = 1000,
        backoff_factor: float = 2.0,
        jitter_ms: int = 300,
    ):
        self.max_retries = max_retries
        self.initial_delay = initial_delay / 1000.0
        self.backoff_factor = backoff_factor
        self.jitter = jitter_ms / 1000.0

    def sleep_durations(self) -> list[float]:
        out = []
        d = self.initial_delay
        for _ in range(self.max_retries):
            out.append(d + random.random() * self.jitter)
            d *= self.backoff_factor
        return out


class FixedDelayRetryStrategy(RetryStrategy):
    def __init__(self, max_retries: int = 3, delay_ms: int = 1000):
        self.max_retries = max_retries
        self.delay = delay_ms / 1000.0

    def sleep_durations(self) -> list[float]:
        return [self.delay] * self.max_retries


# ---------------------------------------------------------------------- caches


class CacheStrategy:
    def get(self, key: str) -> tuple[bool, Any]:
        return False, None

    def put(self, key: str, value: Any) -> None:
        pass


class InMemoryCache(CacheStrategy):
    def __init__(self) -> None:
        self._data: dict[str, Any] = {}

    def get(self, key: str) -> tuple[bool, Any]:
        if key in self._data:
            return True, self._data[key]
        return False, None

    def put(self, key: str, value: Any) -> None:
        self._data[key] = value


class DiskCache(CacheStrategy):
    def __init__(self, directory: str | None = None):
        from pathway_tpu_torch.internals.config import get_pathway_config

        self.directory = directory or os.path.join(
            get_pathway_config().persistent_storage or ".pathway_cache", "udf_cache"
        )
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.directory, key)

    def get(self, key: str) -> tuple[bool, Any]:
        p = self._path(key)
        if os.path.exists(p):
            with open(p, "rb") as f:
                return True, pickle.load(f)
        return False, None

    def put(self, key: str, value: Any) -> None:
        with open(self._path(key), "wb") as f:
            pickle.dump(value, f)


DefaultCache = DiskCache


def _cache_key(fn_name: str, args: tuple, kwargs: dict) -> str:
    from pathway_tpu_torch.internals.keys import _canonical_bytes

    payload = _canonical_bytes((fn_name, tuple(args), tuple(sorted(kwargs.items()))))
    return hashlib.blake2b(payload, digest_size=16).hexdigest()


# ------------------------------------------------------------------- executors


class Executor:
    def wrap(self, fn: Callable) -> Callable:
        return fn

    is_async = False


class SyncExecutor(Executor):
    pass


class AsyncExecutor(Executor):
    """Capacity / timeout / retry wrapper around an async fn
    (reference ``executors.py:135``)."""

    is_async = True

    def __init__(
        self,
        capacity: int | None = None,
        timeout: float | None = None,
        retry_strategy: RetryStrategy | None = None,
    ):
        self.capacity = capacity
        self.timeout = timeout
        self.retry_strategy = retry_strategy

    def wrap(self, fn: Callable) -> Callable:
        sem: asyncio.Semaphore | None = None
        strategy = self.retry_strategy

        @functools.wraps(fn)
        async def wrapped(*args: Any, **kwargs: Any) -> Any:
            nonlocal sem
            if self.capacity is not None and sem is None:
                sem = asyncio.Semaphore(self.capacity)

            async def attempt() -> Any:
                coro = fn(*args, **kwargs)
                if self.timeout is not None:
                    return await asyncio.wait_for(coro, timeout=self.timeout)
                return await coro

            async def with_retries() -> Any:
                delays = strategy.sleep_durations() if strategy else []
                for d in delays:
                    try:
                        return await attempt()
                    except Exception:
                        await asyncio.sleep(d)
                return await attempt()

            if sem is not None:
                async with sem:
                    return await with_retries()
            return await with_retries()

        return wrapped


class FullyAsyncExecutor(AsyncExecutor):
    """Emits Pending immediately; the real value arrives as a later update
    (reference ``executors.py:226``, ``Future`` dtype)."""


def async_executor(
    *,
    capacity: int | None = None,
    timeout: float | None = None,
    retry_strategy: RetryStrategy | None = None,
) -> AsyncExecutor:
    return AsyncExecutor(capacity=capacity, timeout=timeout, retry_strategy=retry_strategy)


def fully_async_executor(**kwargs: Any) -> FullyAsyncExecutor:
    return FullyAsyncExecutor(**kwargs)


# ------------------------------------------------------------------------- UDF


class UDF:
    """Base class for user-defined functions; subclass with ``__wrapped__`` or use
    the ``@pw.udf`` decorator (reference ``internals/udfs/__init__.py:67``)."""

    #: microbatch knobs honored for ``is_batched`` subclasses (see
    #: ``engine.operators.MicrobatchApplyNode``): device launch chunk
    #: (``None`` = the PATHWAY_MICROBATCH_MAX_BATCH default) and the smallest
    #: padded bucket the jitted callee should ever see
    microbatch_max_batch: int | None = None
    microbatch_min_bucket: int = 8

    def __init__(
        self,
        *,
        return_type: Any = None,
        deterministic: bool = False,
        propagate_none: bool = False,
        executor: Executor | None = None,
        cache_strategy: CacheStrategy | None = None,
        _fn: Callable | None = None,
    ):
        if _fn is not None:
            self._fn = _fn
        elif hasattr(self, "__wrapped__"):
            self._fn = self.__wrapped__  # type: ignore[attr-defined]
        else:
            self._fn = None  # subclass overrides __wrapped__ later
        self._return_type = return_type
        self.deterministic = deterministic
        self.propagate_none = propagate_none
        self.executor = executor or (
            AsyncExecutor()
            if self._fn is not None and asyncio.iscoroutinefunction(self._fn)
            else SyncExecutor()
        )
        self.cache_strategy = cache_strategy
        self._wrapped_cache: Callable | None = None

    # subclasses may define __wrapped__ as a method
    def _resolve_fn(self) -> Callable:
        if self._fn is not None:
            return self._fn
        if hasattr(self, "__wrapped__"):
            return self.__wrapped__  # type: ignore[attr-defined]
        raise TypeError("UDF subclass must define __wrapped__")

    def _callable(self) -> Callable:
        if self._wrapped_cache is not None:
            return self._wrapped_cache
        fn = self._resolve_fn()
        fn = self.executor.wrap(fn)
        if self.cache_strategy is not None:
            fn = _with_cache(fn, self.cache_strategy, asyncio.iscoroutinefunction(fn))
        self._wrapped_cache = fn
        return fn

    @property
    def func(self) -> Callable:
        return self._resolve_fn()

    def _return_dtype(self) -> Any:
        if self._return_type is not None:
            return self._return_type
        return expr_mod._infer_return_type(self._resolve_fn())

    def __call__(self, *args: Any, **kwargs: Any):
        fn = self._callable()
        rt = self._return_dtype()
        if isinstance(self.executor, FullyAsyncExecutor):
            return expr_mod.FullyAsyncApplyExpression(
                fn, rt, args=args, kwargs=kwargs,
                propagate_none=self.propagate_none,
                deterministic=self.deterministic,
            )
        if asyncio.iscoroutinefunction(self._resolve_fn()):
            return expr_mod.AsyncApplyExpression(
                fn, rt, args=args, kwargs=kwargs,
                propagate_none=self.propagate_none,
                deterministic=self.deterministic,
            )
        if getattr(self, "is_batched", False):
            # fn receives whole columns (lists) — TPU model UDFs; dispatched via
            # the cross-tick microbatcher (engine MicrobatchApplyNode) when the
            # call is a top-level select column and PATHWAY_MICROBATCH allows,
            # one jitted call per delta block otherwise; caching/retry wrappers
            # don't apply per row
            e = expr_mod.BatchApplyExpression(
                self._resolve_fn(), rt, args=args, kwargs=kwargs,
                propagate_none=self.propagate_none,
                deterministic=self.deterministic,
            )
            # the microbatch planner reads per-UDF knobs off the expression
            # (microbatch_max_batch / microbatch_min_bucket class attrs)
            e.udf = self
            return e
        return expr_mod.ApplyExpression(
            fn, rt, args=args, kwargs=kwargs,
            propagate_none=self.propagate_none,
            deterministic=self.deterministic,
        )


def _with_cache(fn: Callable, cache: CacheStrategy, is_async: bool) -> Callable:
    name = getattr(fn, "__name__", "udf")
    if is_async:

        @functools.wraps(fn)
        async def cached_async(*args: Any, **kwargs: Any) -> Any:
            key = _cache_key(name, args, kwargs)
            hit, value = cache.get(key)
            if hit:
                return value
            value = await fn(*args, **kwargs)
            cache.put(key, value)
            return value

        return cached_async

    @functools.wraps(fn)
    def cached(*args: Any, **kwargs: Any) -> Any:
        key = _cache_key(name, args, kwargs)
        hit, value = cache.get(key)
        if hit:
            return value
        value = fn(*args, **kwargs)
        cache.put(key, value)
        return value

    return cached


def udf(
    fn: Callable | None = None,
    /,
    *,
    return_type: Any = None,
    deterministic: bool = False,
    propagate_none: bool = False,
    executor: Executor | None = None,
    cache_strategy: CacheStrategy | None = None,
) -> Any:
    """Decorator: ``@pw.udf`` (reference ``internals/udfs/__init__.py:273``)."""

    def make(f: Callable) -> UDF:
        u = UDF(
            return_type=return_type,
            deterministic=deterministic,
            propagate_none=propagate_none,
            executor=executor,
            cache_strategy=cache_strategy,
            _fn=f,
        )
        functools.update_wrapper(u, f, updated=[])
        return u

    if fn is not None:
        return make(fn)
    return make
