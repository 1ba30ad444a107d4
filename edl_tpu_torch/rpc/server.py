"""Threaded RPC server on the EDL1 wire (the port of the JAX package's
``rpc/server.py:RpcServer``).

Request envelope:  ``{"m": method, "a": {kwargs}}``
Response envelope: ``{"s": null|{"type","detail"}, "r": {result}}``

A framework error a handler raises crosses the wire by its class name and
is raised again by the client (``utils/exceptions.py``); any other error
crosses as ``EdlInternalError`` with its traceback.  One thread per
connection, each serving its requests in order, so a client may pipeline.
The JAX package's clients (``RpcClient``, ``TeacherClient``) talk to this
server unchanged.

Not ported: streaming responses (bulk checkpoint transfers, ROADMAP.md
Queue 1 item 4e), and the JAX server's metrics, trace context and fault
injection hooks (item 8).
"""

from __future__ import annotations

import logging
import socket
import socketserver
import threading

from edl_tpu_torch.rpc import framing
from edl_tpu_torch.utils import exceptions

logger = logging.getLogger(__name__)


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
                    resp = {"s": None, "r": fn(**(msg.get("a") or {}))}
                except Exception as e:  # noqa: BLE001 — serialize everything
                    if not isinstance(e, exceptions.EdlRetryableError):
                        logger.warning("handler %s raised", msg["m"], exc_info=True)
                    resp = {"s": exceptions.serialize(e), "r": None}
            try:
                framing.send_frame(self.request, resp)
            except OSError:
                return


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

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def start(self) -> "RpcServer":
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True,
                                        name=f"rpc:{self.port}")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._server.close_active()
