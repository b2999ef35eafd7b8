"""Slack writer (reference: ``python/pathway/io/slack``): posts one message per
positive output diff to a channel via chat.postMessage. The shared
:func:`post_message` helper is also the delivery path of the health plane's
Slack notification sink (``observability/alerts.SlackSink``).

Carried from ``pathway_tpu/io/slack.py``. Without an injected transport the
reference posts with ``requests``; the port sends the same request (URL,
bearer token, JSON body) with ``urllib``, as its other HTTP clients do, so
it needs no HTTP client package."""

from __future__ import annotations

import json
import urllib.request
from typing import Any, Callable

from pathway_tpu_torch.engine import operators as ops
from pathway_tpu_torch.internals.logical import LogicalNode
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io._format import SingleColumnFormatter


def post_message(
    channel: str,
    token: str,
    text: str,
    transport: Callable[[str, dict, dict], Any] | None = None,
) -> None:
    """One ``chat.postMessage`` call. ``transport(url, headers, json_body)``
    is injectable so tests (and the alert sink's fake-transport test) never
    touch the network."""
    url = "https://slack.com/api/chat.postMessage"
    headers = {"Authorization": f"Bearer {token}"}
    body = {"channel": channel, "text": text}
    if transport is not None:
        transport(url, headers, body)
        return
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(), headers={**headers, "Content-Type": "application/json"},
        method="POST",
    )
    urllib.request.urlopen(req, timeout=10).close()


def send_alerts(alerts: Table, slack_channel_id: str, slack_token: str, **kwargs: Any) -> None:
    cols = alerts.column_names()
    fmt = SingleColumnFormatter(cols, cols[0])
    transport = kwargs.get("_transport")

    def on_batch(batch, columns) -> None:
        for key, diff, row in batch.rows():
            if diff <= 0:
                continue
            post_message(
                slack_channel_id,
                slack_token,
                fmt.format(int(key), row, batch.time, diff).decode(),
                transport=transport,
            )

    LogicalNode(
        lambda: ops.CallbackOutputNode(cols, on_batch),
        [alerts._node],
        name=f"slack:{slack_channel_id}",
    )._register_as_output()
