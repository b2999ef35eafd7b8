"""HTTP connector & REST request/response server.

Reference: ``pathway_tpu/io/http`` (``python/pathway/io/http``) —
``rest_connector`` (``_server.py``) is the request/response bridge that makes
streaming RAG servers possible. The port serves it on its own HTTP/1.1 layer
over the standard library (``_wire.py``), and ``read`` / ``write`` poll and
post with ``urllib.request`` where the reference uses ``requests``: neither
``aiohttp`` nor ``requests`` is needed. ``serve_table`` (replica-served table
routes) belongs to the fabric, a later slice.
"""

from __future__ import annotations

import urllib.error
import urllib.parse
import urllib.request

from pathway_tpu_torch.internals.later_slice import later_slice
from pathway_tpu_torch.io.http._server import (
    EndpointDocumentation,
    PathwayWebserver,
    openapi_spec,
    rest_connector,
    response_writer,
)

#: the ``request_kwargs`` of the reference's ``requests`` calls that
#: ``urllib.request`` carries
_REQUEST_KWARGS = ("headers", "params", "timeout")


def _fetch(method: str, url: str, data: bytes | None, request_kwargs: dict | None) -> bytes:
    """One HTTP exchange; the response body whatever the status, as
    ``requests`` returns it (it raises on no status)."""
    kw = dict(request_kwargs or {})
    unknown = set(kw) - set(_REQUEST_KWARGS)
    if unknown:
        raise TypeError(f"io.http: request_kwargs {sorted(unknown)} are not supported (only {_REQUEST_KWARGS})")
    if kw.get("params"):
        url += ("&" if urllib.parse.urlsplit(url).query else "?") + urllib.parse.urlencode(kw["params"])
    req = urllib.request.Request(url, data=data, headers=dict(kw.get("headers") or {}), method=method)
    try:
        with urllib.request.urlopen(req, timeout=kw.get("timeout")) as resp:
            return resp.read()
    except urllib.error.HTTPError as e:
        with e:
            return e.read()


def read(
    url: str,
    *,
    schema=None,
    format: str = "json",  # noqa: A002
    mode: str = "streaming",
    poll_interval: float = 1.0,
    request_kwargs: dict | None = None,
    name: str | None = None,
    **kwargs,
):
    """Poll ``url`` and parse each response body through the format's Parser
    (reference: ``python/pathway/io/http`` read side)."""
    import time as _time

    from pathway_tpu_torch.internals import schema as schema_mod
    from pathway_tpu_torch.io._format import RawMessage, parser_for
    from pathway_tpu_torch.io.python import ConnectorSubject, read as py_read

    if schema is None:
        schema = schema_mod.schema_from_types(data=str)
    parser = parser_for(format, schema)

    class _HttpSubject(ConnectorSubject):
        def __init__(self) -> None:
            super().__init__()
            self._stop = False

        def run(self) -> None:
            while not self._stop:
                body = _fetch("GET", url, None, request_kwargs)
                for ev in parser.parse(RawMessage(value=body)):
                    self._push(ev.values, diff=ev.diff)
                if mode == "static":
                    return
                _time.sleep(poll_interval)

        def on_stop(self) -> None:
            self._stop = True

    return py_read(_HttpSubject(), schema=schema, name=name or f"http:{url}")


def write(
    table,
    url: str,
    *,
    method: str = "POST",
    format: str = "json",  # noqa: A002
    request_kwargs: dict | None = None,
    **kwargs,
) -> None:
    """Send every output diff to ``url`` (reference: io/http write side)."""
    from pathway_tpu_torch.engine import operators as ops
    from pathway_tpu_torch.internals.logical import LogicalNode
    from pathway_tpu_torch.io._format import formatter_for

    cols = table.column_names()
    fmt = formatter_for(format, cols, **kwargs)

    def on_batch(batch, columns) -> None:
        for key, diff, row in batch.rows():
            _fetch(method, url, fmt.format(int(key), row, batch.time, diff), request_kwargs)

    LogicalNode(
        lambda: ops.CallbackOutputNode(cols, on_batch),
        [table._node],
        name=f"http_write:{url}",
    )._register_as_output()


def serve_table(*args, **kwargs):
    """Replica-served read-only table routes (reference
    ``fabric/replica.py::serve_table``): the fabric is a later slice."""
    raise later_slice("fabric.replica")


__all__ = [
    "EndpointDocumentation",
    "PathwayWebserver",
    "openapi_spec",
    "read",
    "response_writer",
    "rest_connector",
    "serve_table",
    "write",
]
