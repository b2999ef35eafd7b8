"""Port and readiness helpers for the tests that serve HTTP in-process.

Used by the ``tests/test_torch_*`` files whose servers (the port's, and the
reference's in the parity tests) bind a free port and run ``pw.run`` in a
thread while the test talks to them. Under ``pytest -n 6 --dist loadfile``
other workers bind ports and open client connections at the same time, so:

- :func:`free_port` keeps the port it returns reserved until the server is
  up: the reservation socket is bound with ``SO_REUSEADDR`` and never
  listens, so the server (which binds with ``SO_REUSEADDR``) can bind beside
  it, while a plain ``bind`` or an outgoing connection elsewhere skips the
  port;
- :func:`wait_ready` returns only once the run that owns the port is ready:
  ``/readyz`` answers 200 (with the health plane on, after every connector
  of the run has started) and every route this run serves on the port has
  been configured. A bare TCP connect is not enough: a server with several
  routes accepts connections once the first route's connector has started
  it, while a later route still answers 503.
"""

from __future__ import annotations

import socket
import time
import urllib.error
import urllib.request

#: port -> its reservation socket, closed by wait_ready
_HELD: dict[int, socket.socket] = {}


def free_port() -> int:
    """A free loopback port, reserved until :func:`wait_ready` sees the
    server on it."""
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    _HELD[port] = s
    return port


def release_port(port: int) -> None:
    s = _HELD.pop(port, None)
    if s is not None:
        s.close()


def _readyz(port: int) -> bool:
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/readyz", timeout=1.0) as resp:
            return resp.status == 200
    except urllib.error.HTTPError as e:
        e.close()
        return False
    except OSError:
        return False


def _routes_open(port: int, pw) -> bool:
    """Every route this run serves on ``port`` has been configured (its
    connector started), and there is at least one."""
    import importlib

    server = importlib.import_module(f"{pw.__name__}.io.http._server")
    rt = pw.internals.run.current_runtime()
    states = [
        meta["serving"]
        for ws in list(server._WEBSERVERS)
        if ws.port == port
        for _r, _m, _h, meta in list(ws._routes)
        if meta is not None and meta.get("serving") is not None
    ]
    states = [st for st in states if st.runtime is rt]
    return bool(states) and all(not st.closed for st in states)


def wait_ready(port: int, pw=None, timeout: float = 15.0) -> None:
    """Block until the run serving ``port`` is ready (``pw``: the package
    that serves it, default the port), then release the port's
    reservation."""
    if pw is None:
        import pathway_tpu_torch as pw
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if _readyz(port) and _routes_open(port, pw):
            release_port(port)
            return
        time.sleep(0.02)
    release_port(port)
    raise AssertionError(f"server on port {port} never came up")
