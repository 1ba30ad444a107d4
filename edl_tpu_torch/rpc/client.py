"""The one-connection RPC client (a copy of the JAX package's
``rpc/client.py:RpcClient``).

Transport failures surface as :class:`EdlCoordError` (retryable), so
callers can wrap calls in ``retry_until_timeout``.  Connecting never
happens under the lock: a socket is checked out of a small free list
under it, connected outside it and checked back in, so a dead endpoint
costs each caller one connect timeout instead of queueing every thread
behind the first.

Not ported: the multi-connection ``RpcChannelPool`` (bulk checkpoint
transfers, ROADMAP.md Queue 1 item 4e), and the JAX client's hooks into
its metrics, trace context and fault injection (item 8).
"""

from __future__ import annotations

import socket
import threading

from edl_tpu_torch.rpc import framing
from edl_tpu_torch.utils import exceptions
from edl_tpu_torch.utils.network import split_endpoint


def _connect(endpoint: str, timeout: float) -> socket.socket:
    host, port = split_endpoint(endpoint)
    sock = socket.create_connection((host or "127.0.0.1", port), timeout=timeout)
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    return sock


class RpcClient:
    # idle connections kept per client, so overlapping callers each keep
    # a persistent connection instead of paying a handshake per call
    MAX_IDLE = 4

    def __init__(self, endpoint: str, timeout: float = 30.0):
        self.endpoint = endpoint
        self._timeout = timeout
        self._idle: list[socket.socket] = []
        self._lock = threading.Lock()
        self._closed = False

    def call(self, method: str, _timeout: float | None = None, **kwargs):
        """Invoke ``method`` remotely; returns the result payload.

        Retries the transport once on a broken pooled connection (the
        retry always dials fresh), then raises EdlCoordError.  A typed
        error the server raised is raised here with its type."""
        req = {"m": method, "a": kwargs}
        timeout = self._timeout if _timeout is None else _timeout
        for attempt in (0, 1):
            sock = None
            if attempt == 0:
                with self._lock:
                    if self._idle:
                        sock = self._idle.pop()
            try:
                if sock is None:
                    sock = _connect(self.endpoint, timeout)
                sock.settimeout(timeout)
                framing.send_frame(sock, req)
                resp = framing.recv_frame(sock)
            except (OSError, framing.FramingError) as e:
                _close_quietly(sock)
                if attempt == 1:
                    raise exceptions.EdlCoordError(
                        f"rpc {method} to {self.endpoint} failed: {e}") from e
                continue
            self._checkin(sock)
            exceptions.deserialize(resp["s"])
            return resp["r"]

    def _checkin(self, sock: socket.socket) -> None:
        with self._lock:
            if not self._closed and len(self._idle) < self.MAX_IDLE:
                self._idle.append(sock)
                return
        _close_quietly(sock)

    def close(self):
        with self._lock:
            self._closed = True
            socks, self._idle = self._idle, []
        for sock in socks:
            _close_quietly(sock)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _close_quietly(sock: socket.socket | None) -> None:
    if sock is not None:
        try:
            sock.close()
        except OSError:
            pass
