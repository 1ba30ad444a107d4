"""RPC clients: the one-connection :class:`RpcClient` and the
multi-connection :class:`RpcChannelPool` (copies of the JAX package's
``rpc/client.py``).

Transport failures surface as :class:`EdlCoordError` (retryable), so
callers can wrap calls in ``retry_until_timeout``.  Connecting never
happens under a lock another caller can be waiting on: ``RpcClient``
checks a socket out of a small free list under its lock, connects outside
it and checks it back in, and ``RpcChannelPool`` holds one lock per
connection, so a dead endpoint costs each caller one connect timeout
instead of queueing every thread behind the first.

The pool's paths:

- ``call``: one round trip on any free channel;
- ``iter_call_pipelined``: a window of requests in flight on one channel
  (the server answers a connection's requests in order, so replies match
  requests by position);
- ``call_streaming``: one request answered by ordered frames (a server
  handler returning ``Streaming``), with a strict ``q`` sequence check: a
  gap or a duplicate raises :class:`EdlStreamError` and tears the channel
  down.  The data service's consumers fetch a producer's batches this way.

Not ported: the JAX client's hooks into its metrics, trace context and
fault injection (ROADMAP.md Queue 1 item 8).
"""

from __future__ import annotations

import itertools
import socket
import threading
from collections import deque
from typing import Iterable

from edl_tpu_torch.rpc import framing
from edl_tpu_torch.utils import constants, exceptions
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


class _Channel:
    """One pooled connection with its own lock: a slow connect or a long
    transfer on this channel never blocks callers that can use a sibling."""

    __slots__ = ("endpoint", "timeout", "lock", "sock")

    def __init__(self, endpoint: str, timeout: float):
        self.endpoint = endpoint
        self.timeout = timeout
        self.lock = threading.Lock()
        self.sock: socket.socket | None = None

    # the caller holds self.lock for every method below
    def ensure(self, timeout: float | None = None) -> socket.socket:
        if self.sock is None:
            self.sock = _connect(self.endpoint, self.timeout)
        self.sock.settimeout(self.timeout if timeout is None else timeout)
        return self.sock

    def fail(self) -> None:
        _close_quietly(self.sock)
        self.sock = None


class RpcChannelPool:
    """N connections to one endpoint and the windowed paths.  ``size``
    defaults to ``EDL_TPU_TRANSFER_CONNS``; a plain ``call`` takes any free
    channel, blocking on one round-robin slot only when all are busy."""

    def __init__(self, endpoint: str, size: int | None = None, timeout: float = 30.0):
        self.endpoint = endpoint
        self._timeout = timeout
        n = max(1, int(size or constants.transfer_conns()))
        self._channels = [_Channel(endpoint, timeout) for _ in range(n)]
        self._rr = itertools.count()
        self._closed = False

    def __len__(self) -> int:
        return len(self._channels)

    def _acquire(self) -> _Channel:
        n = len(self._channels)
        start = next(self._rr)
        ch = None
        for i in range(n):
            c = self._channels[(start + i) % n]
            if c.lock.acquire(blocking=False):
                ch = c
                break
        if ch is None:
            ch = self._channels[start % n]
            ch.lock.acquire()
        # checked under the channel lock: close() flags before it takes the
        # locks, so either we see it here or close() fails our socket after us
        if self._closed:
            ch.lock.release()
            raise exceptions.EdlCoordError(f"rpc pool to {self.endpoint} is closed")
        return ch

    def call(self, method: str, _timeout: float | None = None, **kwargs):
        """One round trip on any free channel (``RpcClient.call``'s
        semantics, the single transport retry included)."""
        req = {"m": method, "a": kwargs}
        for attempt in (0, 1):
            ch = self._acquire()
            try:
                sock = ch.ensure(_timeout)
                framing.send_frame(sock, req)
                resp = framing.recv_frame(sock)
            except (OSError, framing.FramingError) as e:
                ch.fail()
                if attempt == 1:
                    raise exceptions.EdlCoordError(
                        f"rpc {method} to {self.endpoint} failed: {e}") from e
                continue
            finally:
                ch.lock.release()
            exceptions.deserialize(resp["s"])
            return resp["r"]

    def iter_call_pipelined(self, method: str, requests: Iterable[dict],
                            window: int | None = None, _timeout: float | None = None):
        """Yield the results of ``requests`` in order, keeping up to
        ``window`` (``EDL_TPU_TRANSFER_WINDOW``) in flight on one channel.
        The first typed error stops further sends, drains the frames in
        flight (the connection stays usable) and raises; a transport failure
        raises EdlCoordError.  Abandoning the generator part way tears the
        channel down (unread frames would poison its next call)."""
        requests = list(requests)
        if not requests:
            return
        window = max(1, int(window or constants.transfer_window()))
        ch = self._acquire()
        done = False
        pending: deque[int] = deque()
        try:
            try:
                sock = ch.ensure(_timeout)
                i = 0
                error = None
                while i < len(requests) or pending:
                    while error is None and i < len(requests) and len(pending) < window:
                        framing.send_frame(sock, {"m": method, "a": requests[i]})
                        pending.append(i)
                        i += 1
                    if not pending:
                        break
                    resp = framing.recv_frame(sock)
                    pending.popleft()
                    if error is None:
                        if resp["s"]:
                            error = resp["s"]  # drain, then raise below
                        else:
                            done = not pending and i == len(requests)
                            yield resp["r"]
                            done = False
            except (OSError, framing.FramingError) as e:
                ch.fail()
                raise exceptions.EdlCoordError(
                    f"pipelined rpc {method} to {self.endpoint} failed: {e}") from e
            done = True
            if error is not None:
                exceptions.deserialize(error)
        finally:
            if not done:
                ch.fail()
            ch.lock.release()

    def call_streaming(self, method: str, _timeout: float | None = None, **kwargs):
        """One request, many ordered response frames: yields each frame's
        payload (bytes for a raw frame).  A gap, a duplicate or a plain
        answer raises :class:`EdlStreamError`; a gap or a duplicate also
        tears the channel down.  A plain answer carrying an error raises
        that error (an old peer answers "no such method" this way)."""
        ch = self._acquire()
        done = False
        try:
            try:
                sock = ch.ensure(_timeout)
                framing.send_frame(sock, {"m": method, "a": kwargs})
                expect = 0
                while True:
                    resp = framing.recv_frame(sock)
                    if "q" not in resp:
                        # the whole plain response was read: still in sync
                        done = True
                        exceptions.deserialize(resp["s"])
                        raise exceptions.EdlStreamError(
                            f"{method} to {self.endpoint}: expected a streamed "
                            f"response, got a single frame")
                    q = int(resp["q"])
                    if q != expect:
                        kind = "duplicate" if q < expect else "gap"
                        raise exceptions.EdlStreamError(
                            f"{method} to {self.endpoint}: sequence {kind} "
                            f"(frame {q}, expected {expect})")
                    if resp.get("eof"):
                        # the terminator was read whole: the channel is healthy
                        done = True
                        exceptions.deserialize(resp["s"])
                        return
                    exceptions.deserialize(resp["s"])
                    expect += 1
                    if "nb" in resp:
                        yield framing.recv_raw(sock, int(resp["nb"]))
                    else:
                        yield resp["r"]
            except (OSError, framing.FramingError) as e:
                raise exceptions.EdlCoordError(
                    f"streaming rpc {method} to {self.endpoint} failed: {e}") from e
        finally:
            if not done:
                ch.fail()
            ch.lock.release()

    def close(self) -> None:
        # flag first: a caller acquiring a channel after this sees the pool
        # closed and aborts instead of reconnecting a socket nobody closes
        self._closed = True
        for ch in self._channels:
            with ch.lock:
                ch.fail()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
