"""Threaded RPC server on the EDL1 wire (the port of the JAX package's
``rpc/server.py:RpcServer``).

Request envelope:  ``{"m": method, "a": {kwargs}}``
Response envelope: ``{"s": null|{"type","detail"}, "r": {result}}``

A framework error a handler raises crosses the wire by its class name and
is raised again by the client (``utils/exceptions.py``); any other error
crosses as ``EdlInternalError`` with its traceback.  One thread per
connection, each serving its requests in order, so a client may pipeline.
The JAX package's clients (``RpcClient``, ``RpcChannelPool``,
``TeacherClient``) talk to this server unchanged.

**Streamed replies**: a handler that returns :class:`Streaming` answers one
request with ordered frames ``{"s": null, "r": item, "q": seq}`` (a
bytes-like item goes raw: ``{"s": null, "q": seq, "nb": n}`` and then its
``n`` bytes), then a terminator ``{"s": null, "r": null, "q": n, "eof":
true}``, whose ``"s"`` carries the error if the iterator failed part way.
The data service's batch caches stream a consumer's batch group this way.

Not ported: the JAX server's metrics, trace context and fault injection
hooks (ROADMAP.md Queue 1 item 8).
"""

from __future__ import annotations

import logging
import socket
import socketserver
import threading

from edl_tpu_torch.rpc import framing
from edl_tpu_torch.utils import exceptions

logger = logging.getLogger(__name__)


class Streaming:
    """Return-type marker: each item of the wrapped iterator goes out as one
    ordered response frame."""

    __slots__ = ("it",)

    def __init__(self, it):
        self.it = it


def _quiet(e: Exception) -> bool:
    """Errors that are protocol, not faults: retryable states and the end of
    a reader's data."""
    return isinstance(e, (exceptions.EdlRetryableError, exceptions.EdlStopIteration))


class _Handler(socketserver.BaseRequestHandler):
    def handle(self):
        self.request.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        while True:
            try:
                msg = framing.recv_frame(self.request)
            except (framing.FramingError, OSError):
                return
            try:
                fn = self.server.methods[msg["m"]]  # type: ignore[attr-defined]
            except KeyError:
                resp = {"s": {"type": "EdlInternalError",
                              "detail": f"no such method {msg.get('m')!r}"}, "r": None}
            else:
                try:
                    result = fn(**(msg.get("a") or {}))
                    resp = (self._stream(msg["m"], result) if isinstance(result, Streaming)
                            else {"s": None, "r": result})
                except Exception as e:  # noqa: BLE001 — serialize everything
                    if not _quiet(e):
                        logger.warning("handler %s raised", msg["m"], exc_info=True)
                    resp = {"s": exceptions.serialize(e), "r": None}
            if resp is None:
                return  # the client went away mid-stream
            try:
                framing.send_frame(self.request, resp)
            except OSError:
                return

    def _stream(self, method: str, result: Streaming) -> dict | None:
        """Send ``result``'s items as ``q``-numbered frames; returns the
        terminator for the loop to send, or None when the client is gone."""
        q = 0
        try:
            for item in result.it:
                try:
                    if isinstance(item, (bytes, bytearray, memoryview)):
                        framing.send_frame(self.request,
                                           {"s": None, "q": q, "nb": memoryview(item).nbytes})
                        framing.send_raw(self.request, item)
                    else:
                        framing.send_frame(self.request, {"s": None, "r": item, "q": q})
                except OSError:
                    return None
                q += 1
        except Exception as e:  # noqa: BLE001 — the iterator failed part way
            logger.warning("streaming handler %s failed at frame %d", method, q, exc_info=True)
            return {"s": exceptions.serialize(e), "r": None, "q": q, "eof": True}
        return {"s": None, "r": None, "q": q, "eof": True}


class _TcpServer(socketserver.ThreadingTCPServer):
    daemon_threads = True
    allow_reuse_address = True

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._active_lock = threading.Lock()
        self._active: set[socket.socket] = set()

    def process_request(self, request, client_address):
        with self._active_lock:
            self._active.add(request)
        super().process_request(request, client_address)

    def shutdown_request(self, request):
        with self._active_lock:
            self._active.discard(request)
        super().shutdown_request(request)

    def close_active(self) -> None:
        """Sever every established connection: a stopped server must look
        dead to its peers (so they fail over), not keep answering on old
        sockets while refusing new ones."""
        with self._active_lock:
            socks = list(self._active)
        for sock in socks:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass  # already closed by its peer
            sock.close()


class RpcServer:
    """Register methods, then ``start()``; ``port`` is the bound port."""

    def __init__(self, host: str = "0.0.0.0", port: int = 0):
        self._server = _TcpServer((host, port), _Handler)
        self._server.methods = {}  # type: ignore[attr-defined]
        self._thread: threading.Thread | None = None

    def register(self, method: str, fn) -> None:
        self._server.methods[method] = fn  # type: ignore[attr-defined]

    def register_instance(self, obj) -> None:
        """Expose every public method of ``obj``."""
        for name in dir(obj):
            if not name.startswith("_") and callable(getattr(obj, name)):
                self.register(name, getattr(obj, name))

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    @property
    def endpoint(self) -> str:
        """``host:port`` to advertise: the bound host, or for a wildcard bind
        ``utils/network.py:local_ip()``."""
        from edl_tpu_torch.utils.network import local_ip
        host = self._server.server_address[0]
        if host in ("0.0.0.0", ""):
            host = local_ip()
        return f"{host}:{self.port}"

    def start(self) -> "RpcServer":
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True,
                                        name=f"rpc:{self.port}")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._server.close_active()
