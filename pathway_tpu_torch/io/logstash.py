"""Logstash writer (reference ``python/pathway/io/logstash``): POST every
diff row as a flat JSON object — with ``time``/``diff`` fields — to Logstash's
HTTP input plugin. Pure stdlib (urllib), so no dependency gate."""

from __future__ import annotations

import time as _time
import urllib.request
from typing import Any

from pathway_tpu_torch.engine import operators as ops
from pathway_tpu_torch.internals.logical import LogicalNode
from pathway_tpu_torch.internals.table import Table


class RetryPolicy:
    """Fixed/backoff retry delays (reference ``io/http`` RetryPolicy shape)."""

    def __init__(self, first_delay_ms: int = 200, backoff_factor: float = 2.0):
        self.first_delay_ms = first_delay_ms
        self.backoff_factor = backoff_factor

    @classmethod
    def default(cls) -> "RetryPolicy":
        return cls()


def write(
    table: Table,
    endpoint: str,
    n_retries: int = 0,
    retry_policy: RetryPolicy | None = None,
    connect_timeout_ms: int | None = None,
    request_timeout_ms: int | None = None,
    *,
    name: str | None = None,
    **kwargs: Any,
) -> None:
    from pathway_tpu_torch.io._format import formatter_for

    policy = retry_policy or RetryPolicy.default()
    timeout = (request_timeout_ms or connect_timeout_ms or 10_000) / 1000.0
    cols = table.column_names()
    fmt = formatter_for("json", cols)

    def post(payload: bytes) -> None:
        delay = policy.first_delay_ms / 1000.0
        for attempt in range(n_retries + 1):
            try:
                req = urllib.request.Request(
                    endpoint,
                    data=payload,
                    headers={"Content-Type": "application/json"},
                    method="POST",
                )
                urllib.request.urlopen(req, timeout=timeout).read()
                return
            except Exception:
                if attempt == n_retries:
                    raise
                _time.sleep(delay)
                delay *= policy.backoff_factor

    def on_batch(batch, columns) -> None:
        for key, diff, row in batch.rows():
            payload = fmt.format(int(key), row, batch.time, diff)
            post(payload if isinstance(payload, bytes) else payload.encode())

    LogicalNode(
        lambda: ops.CallbackOutputNode(cols, on_batch),
        [table._node],
        name=name or f"logstash_write:{endpoint}",
    )._register_as_output()
