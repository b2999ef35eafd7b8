"""Fabric control/data transport: one RPC + broadcast plane per process.

The cluster already owns three port bands off ``PATHWAY_FIRST_PORT``: the
barrier coordinator (``first_port``), the peer block links
(``first_port + 1 + pid``) and the heartbeat monitor
(``first_port + processes + 1``). The fabric claims the next band —
``first_port + processes + 2 + pid`` — one listener per process, carrying:

- **requests** (``call``): length-prefixed pickle ``("req", corr, kind,
  payload)`` answered by ``("res", corr, result)`` / ``("err", corr, msg)``
  on the same socket. Handlers are registered per ``kind`` and receive a
  ``reply`` callable — they may answer immediately (table lookups) or hand
  the reply off to another thread/event loop and return (forwarded REST
  requests resolve when the engine answers);
- **casts** (``cast``): fire-and-forget ``("cast", kind, payload)`` — the
  replica changelog feed and frontier stamps.

Connections are lazy and directional: the initiator's receive loop handles
only responses; the acceptor's loop handles requests and casts. Framing is
the cluster plane's length-prefixed pickle, kept local (no import coupling
with the runtime the fabric rides on). A dead peer surfaces as
:class:`FabricUnavailable` on ``call`` — the front door maps it to a 503,
never a hang: every wait is bounded by the caller's timeout.

Carried from ``pathway_tpu/fabric/transport.py``.
"""

from __future__ import annotations

import itertools
import pickle
import socket
import struct
import threading
import time as _time
from typing import Any, Callable


class FabricUnavailable(RuntimeError):
    """The target process's fabric endpoint is gone or did not answer in
    time — the ingress door answers 503 with this as the reason."""


def fabric_port(first_port: int, processes: int, pid: int) -> int:
    """The fabric listener port of process ``pid`` (the band directly above
    the heartbeat port)."""
    return first_port + processes + 2 + pid


def _send(sock: socket.socket, obj: Any) -> None:
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(struct.pack("<Q", len(payload)) + payload)


def _recv(sock: socket.socket) -> Any:
    buf = b""
    while len(buf) < 8:
        chunk = sock.recv(8 - len(buf))
        if not chunk:
            return None
        buf += chunk
    (n,) = struct.unpack("<Q", buf)
    payload = b""
    while len(payload) < n:
        chunk = sock.recv(n - len(payload))
        if not chunk:
            return None
        payload += chunk
    return pickle.loads(payload)


class _OutLink:
    """One outgoing connection: sends requests/casts, receives responses."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.send_lock = threading.Lock()
        #: corr -> (event, result-slot list) of in-flight calls
        self.pending: dict[int, tuple[threading.Event, list]] = {}
        self.pending_lock = threading.Lock()
        self.dead = False


class FabricNode:
    """This process's fabric endpoint: a listener plus lazy outgoing links."""

    def __init__(
        self, pid: int, n_proc: int, first_port: int, host: str = "127.0.0.1"
    ):
        self.pid = pid
        self.n_proc = n_proc
        self.first_port = first_port
        self.host = host
        #: kind -> fn(payload, reply); ``reply(result)`` may be called from
        #: any thread, exactly once. A handler raise answers an error frame.
        self.req_handlers: dict[str, Callable[[Any, Callable[[Any], None]], None]] = {}
        #: kind -> fn(payload)
        self.cast_handlers: dict[str, Callable[[Any], None]] = {}
        self._corr = itertools.count(1)
        self._out: dict[int, _OutLink] = {}
        self._out_lock = threading.Lock()
        self._closed = False
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, fabric_port(first_port, n_proc, pid)))
        self._listener.listen(max(4, n_proc * 2))
        self.port = self._listener.getsockname()[1]
        self._accepted: list[socket.socket] = []
        threading.Thread(
            target=self._accept_loop, name=f"fabric-accept-p{pid}", daemon=True
        ).start()

    # ------------------------------------------------------------ server side
    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._accepted.append(conn)
            threading.Thread(
                target=self._serve_loop, args=(conn,), daemon=True
            ).start()

    def _serve_loop(self, conn: socket.socket) -> None:
        send_lock = threading.Lock()

        def conn_send(obj: Any) -> None:
            try:
                with send_lock:
                    _send(conn, obj)
            except OSError:
                pass  # requester gone; its timeout owns the failure

        try:
            while not self._closed:
                msg = _recv(conn)
                if msg is None:
                    return
                tag = msg[0]
                if tag == "req":
                    _tag, corr, kind, payload = msg
                    fn = self.req_handlers.get(kind)
                    if fn is None:
                        conn_send(("err", corr, f"no fabric handler for {kind!r}"))
                        continue

                    def reply(result: Any, _corr=corr) -> None:
                        conn_send(("res", _corr, result))

                    try:
                        fn(payload, reply)
                    except Exception as e:  # handler bug -> error frame
                        conn_send(("err", corr, f"{type(e).__name__}: {e}"))
                elif tag == "cast":
                    _tag, kind, payload = msg
                    fn = self.cast_handlers.get(kind)
                    if fn is not None:
                        try:
                            fn(payload)
                        except Exception:
                            pass  # a cast must never kill the transport
                else:
                    return  # protocol violation: drop the connection
        except Exception:
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    # ------------------------------------------------------------ client side
    def _link_to(self, peer: int, connect_timeout: float) -> _OutLink:
        with self._out_lock:
            link = self._out.get(peer)
            if link is not None and not link.dead:
                return link
        deadline = _time.monotonic() + connect_timeout
        while True:
            try:
                sock = socket.create_connection(
                    (self.host, fabric_port(self.first_port, self.n_proc, peer)),
                    timeout=min(5.0, connect_timeout),
                )
                break
            except OSError:
                if _time.monotonic() > deadline:
                    raise FabricUnavailable(
                        f"fabric endpoint of process {peer} unreachable"
                    ) from None
                _time.sleep(0.05)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        link = _OutLink(sock)
        with self._out_lock:
            cur = self._out.get(peer)
            if cur is not None and not cur.dead:  # lost the race
                try:
                    sock.close()
                except OSError:
                    pass
                return cur
            self._out[peer] = link
        threading.Thread(
            target=self._response_loop, args=(peer, link), daemon=True
        ).start()
        return link

    def _response_loop(self, peer: int, link: _OutLink) -> None:
        try:
            while not self._closed:
                msg = _recv(link.sock)
                if msg is None:
                    break
                tag, corr, body = msg
                with link.pending_lock:
                    ent = link.pending.pop(corr, None)
                if ent is not None:
                    event, slot = ent
                    slot.append((tag, body))
                    event.set()
        except Exception:
            pass
        finally:
            link.dead = True
            # wake every in-flight caller with the failure
            with link.pending_lock:
                pending, link.pending = dict(link.pending), {}
            for event, slot in pending.values():
                slot.append(("err", f"fabric link to process {peer} lost"))
                event.set()
            try:
                link.sock.close()
            except OSError:
                pass

    def call(self, peer: int, kind: str, payload: Any, timeout: float = 30.0) -> Any:
        """Blocking RPC to ``peer``; raises :class:`FabricUnavailable` on a
        dead link or timeout."""
        link = self._link_to(peer, timeout)
        corr = next(self._corr)
        event = threading.Event()
        slot: list = []
        with link.pending_lock:
            link.pending[corr] = (event, slot)
        try:
            with link.send_lock:
                _send(link.sock, ("req", corr, kind, payload))
        except OSError:
            link.dead = True
            with link.pending_lock:
                link.pending.pop(corr, None)
            raise FabricUnavailable(
                f"fabric link to process {peer} lost on send"
            ) from None
        if not event.wait(timeout):
            with link.pending_lock:
                link.pending.pop(corr, None)
            raise FabricUnavailable(
                f"fabric call {kind!r} to process {peer} timed out after {timeout}s"
            )
        tag, body = slot[0]
        if tag == "err":
            raise FabricUnavailable(str(body))
        return body

    def cast(self, peer: int, kind: str, payload: Any, connect_timeout: float = 5.0) -> bool:
        """Best-effort fire-and-forget to ``peer``; returns delivery-attempt
        success (the peer applying it is not acknowledged)."""
        try:
            link = self._link_to(peer, connect_timeout)
            with link.send_lock:
                _send(link.sock, ("cast", kind, payload))
            return True
        except (FabricUnavailable, OSError):
            return False

    def close(self) -> None:
        self._closed = True
        try:
            self._listener.close()
        except OSError:
            pass
        with self._out_lock:
            links = list(self._out.values())
            self._out.clear()
        for link in links:
            link.dead = True
            try:
                link.sock.close()
            except OSError:
                pass
        for conn in self._accepted:
            try:
                conn.close()
            except OSError:
                pass
