"""Per-route front-door protection: token-bucket rate limits + API-key auth.

Every front door — the coordinator's REST server and, with the fabric on,
each peer's — runs the SAME two checks before admission:

- :class:`TokenBucket`: a classic refill bucket (``PATHWAY_SERVE_RATE``
  requests/second, ``PATHWAY_SERVE_BURST`` capacity). An empty bucket sheds
  with ``429`` and an exact ``Retry-After`` computed from the refill rate —
  the client is told precisely when a token will exist, not a constant.
- :class:`ApiKeyGuard`: static API keys (``PATHWAY_SERVE_API_KEYS``,
  or per-route ``api_keys=``) presented as ``X-API-Key`` or
  ``Authorization: Bearer``. A missing key answers ``401``, a wrong key
  ``403`` — the two failure modes are distinguishable in the counters, so
  "clients without credentials" and "clients with revoked credentials" are
  separate signals.

Both shed BEFORE admission (in-flight budget, ingest credit) and before the
request body is read: an unauthorized or rate-limited flood costs one header
inspection per request, never an engine row. Counters live on the route's
serving state and merge pod-wide over the heartbeat telemetry block
(``observability/aggregate.py``), so ``/status`` on the coordinator reports
exact cluster-wide shed/auth-failure totals.

Carried from ``pathway_tpu/fabric/limits.py`` unchanged. In the port only the
single process's own REST door runs these checks: the fabric's peer doors and
the heartbeat roll-up are a later slice (``fabric/__init__.py``).
"""

from __future__ import annotations

import math
import threading
import time as _time


class TokenBucket:
    """Thread-safe token bucket. ``rate`` tokens/second refill up to
    ``burst`` capacity; the bucket starts full. ``clock`` is injectable for
    deterministic tests (must be monotone seconds)."""

    def __init__(self, rate: float, burst: int | None = None, clock=None):
        if rate <= 0:
            raise ValueError(f"TokenBucket rate must be > 0, got {rate}")
        self.rate = float(rate)
        self.burst = float(burst if burst else max(1, math.ceil(rate)))
        self._clock = clock or _time.monotonic
        self._tokens = self.burst
        self._stamp = self._clock()
        self._lock = threading.Lock()

    def try_take(self, n: int = 1) -> float:
        """Take ``n`` tokens. Returns 0.0 on success, else the seconds until
        ``n`` tokens will exist (the exact ``Retry-After``)."""
        now = self._clock()
        with self._lock:
            self._tokens = min(
                self.burst, self._tokens + (now - self._stamp) * self.rate
            )
            self._stamp = now
            if self._tokens >= n:
                self._tokens -= n
                return 0.0
            return (n - self._tokens) / self.rate

    def available(self) -> float:
        now = self._clock()
        with self._lock:
            return min(self.burst, self._tokens + (now - self._stamp) * self.rate)


#: auth outcomes (``None`` = pass)
UNAUTHORIZED = "unauthorized"  # no key presented -> 401
FORBIDDEN = "forbidden"  # a key presented, but not an accepted one -> 403


class ApiKeyGuard:
    """Static API-key check for one route."""

    def __init__(self, keys):
        self.keys = frozenset(keys)

    def check(self, presented: str | None) -> str | None:
        if not self.keys:
            return None
        if presented is None or presented == "":
            return UNAUTHORIZED
        if presented not in self.keys:
            return FORBIDDEN
        return None


def extract_api_key(headers) -> str | None:
    """The presented key from request headers: ``X-API-Key`` wins, else a
    ``Bearer`` authorization. ``headers`` is any case-insensitive mapping
    (aiohttp's ``CIMultiDict``) or a plain dict with canonical names."""
    key = headers.get("X-API-Key")
    if key:
        return key
    auth = headers.get("Authorization")
    if auth and auth.startswith("Bearer "):
        return auth[len("Bearer ") :].strip() or None
    return None


def retry_after_header(seconds: float) -> str:
    """``Retry-After`` is integer seconds per RFC 9110 — round UP so the
    client never retries before a token exists."""
    return str(max(1, math.ceil(seconds)))
