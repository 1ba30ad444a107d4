"""Lite discovery: the zero-framework transport variant (a copy of the JAX
package's ``distill/lite_discovery.py``, on the same ``EDLJ`` wire).

Reference: python/edl/distill/redis/* (~973 LoC) — the same discovery
function with none of the gRPC stack: a raw epoll TCP server speaking
length-prefixed JSON (balance_server.py:38-215, ``!4si`` magic+len
frames), an fd-keyed client table, and a socket client
(redis/client.py).  This is the proof that the discovery interfaces are
genuinely pluggable: the greedy rebalance is the SAME
:class:`~edl_tpu_torch.distill.balance.Service` used by the RPC discovery
server, behind a completely different wire —

    frame  = b"EDLJ" | u32_be length | utf-8 JSON
    client -> {"m": "register", "service": s, "client": id, "require": n}
           -> {"m": "heartbeat", "service": s, "client": id, "version": v}
    server -> {"code": "OK"|"NO_READY"|"UNREGISTERED",
               "version": v, "servers": [...] | null}

One select() thread serves every connection (the control plane is tiny;
the reference sized its epoll loop the same way).  Students plug the
:class:`LiteDiscoveryClient` into ``DistillReader.set_servers_fn``.
"""

from __future__ import annotations

import json
import logging
import selectors
import socket
import struct
import threading
import time

from edl_tpu_torch.distill.balance import Service
from edl_tpu_torch.utils.exceptions import EdlRetryableError
from edl_tpu_torch.utils.network import local_ip

logger = logging.getLogger(__name__)

MAGIC = b"EDLJ"
_HEADER = struct.Struct(">4sI")
MAX_FRAME = 1 << 20  # discovery messages are tiny


def pack(obj) -> bytes:
    body = json.dumps(obj).encode()
    return _HEADER.pack(MAGIC, len(body)) + body


class _Conn:
    __slots__ = ("sock", "buf", "client_ids")

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.buf = b""
        self.client_ids: set[tuple[str, str]] = set()  # (service, client)

    def frames(self):
        """Parse complete frames out of the receive buffer."""
        while len(self.buf) >= _HEADER.size:
            magic, length = _HEADER.unpack_from(self.buf)
            if magic != MAGIC or length > MAX_FRAME:
                raise ConnectionError(f"bad frame header {magic!r}/{length}")
            if len(self.buf) < _HEADER.size + length:
                return
            body = self.buf[_HEADER.size:_HEADER.size + length]
            self.buf = self.buf[_HEADER.size + length:]
            yield json.loads(body.decode())


class LiteBalanceServer:
    """select()-loop balance server over the JSON wire."""

    def __init__(self, store, host: str | None = None, port: int = 0,
                 poll_period: float = 1.0):
        self._store = store
        self._services: dict[str, Service] = {}
        self._lock = threading.Lock()
        self._sel = selectors.DefaultSelector()
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind(("0.0.0.0", port))
        self._listener.listen(128)
        self._listener.setblocking(False)
        self._sel.register(self._listener, selectors.EVENT_READ, None)
        self._period = poll_period
        self._halt = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="lite-balance")
        self._thread.start()
        self.endpoint = f"{host or local_ip()}:{self._listener.getsockname()[1]}"
        logger.info("lite balance server on %s", self.endpoint)

    # -- event loop ----------------------------------------------------------
    def _loop(self) -> None:
        last_gc = time.monotonic()
        while not self._halt.is_set():
            for key, _ev in self._sel.select(timeout=self._period / 2):
                if key.data is None:
                    self._accept()
                else:
                    self._read(key.data)
            if time.monotonic() - last_gc >= self._period:
                last_gc = time.monotonic()
                # snapshot, then sweep outside the table lock (each
                # Service has its own lock; holding ours across the
                # sweep serializes the select loop against handlers)
                with self._lock:
                    services = list(self._services.values())
                for svc in services:
                    svc.gc_expired()

    def _accept(self) -> None:
        try:
            sock, _addr = self._listener.accept()
        except OSError:
            return
        sock.setblocking(False)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sel.register(sock, selectors.EVENT_READ, _Conn(sock))

    def _drop(self, conn: _Conn) -> None:
        try:
            self._sel.unregister(conn.sock)
        except (KeyError, ValueError):
            pass
        try:
            conn.sock.close()
        except OSError:
            pass
        # a vanished student releases its teacher assignments
        for service, client in conn.client_ids:
            svc = self._services.get(service)
            if svc is not None:
                svc.remove_client(client)

    def _read(self, conn: _Conn) -> None:
        try:
            chunk = conn.sock.recv(1 << 16)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self._drop(conn)
            return
        if not chunk:
            self._drop(conn)
            return
        conn.buf += chunk
        try:
            for msg in conn.frames():
                try:
                    resp = self._handle(conn, msg)
                except EdlRetryableError as e:
                    # a coord blip behind the ResilientCoordClient's
                    # retry budget (e.g. Service bootstrap get_prefix):
                    # the request is fine, the store is not — answer
                    # NO_READY so the student's heartbeat retries
                    # instead of treating its own message as malformed
                    logger.warning("lite request deferred on store "
                                   "error: %s", e)
                    resp = {"code": "NO_READY", "version": -1,
                            "servers": None}
                except Exception as e:  # noqa: BLE001 — bad payload must
                    # never kill the single select loop for everyone
                    logger.warning("lite request failed: %s", e)
                    resp = {"code": "BAD_REQUEST", "version": -1,
                            "servers": None}
                conn.sock.sendall(pack(resp))
        except (ConnectionError, OSError, json.JSONDecodeError) as e:
            logger.warning("lite conn dropped: %s", e)
            self._drop(conn)

    # -- protocol ------------------------------------------------------------
    def _service(self, name: str) -> Service:
        with self._lock:
            svc = self._services.get(name)
        if svc is not None:
            return svc
        # the same contract as BalanceTable.service(): Service.__init__
        # does store I/O (a watch and a get_prefix), so it must not run
        # under the table lock, or the single select loop would stall
        # behind a slow store.  Double-checked insert; a losing racer
        # closes its copy.
        fresh = Service(name, self._store)
        with self._lock:
            svc = self._services.setdefault(name, fresh)
        if svc is not fresh:
            fresh.close()
        return svc

    def _handle(self, conn: _Conn, msg: dict) -> dict:
        m = msg.get("m")
        service = msg.get("service", "")
        client = msg.get("client", "")
        if m == "register":
            svc = self._service(service)
            svc.add_client(client, int(msg.get("require", 1)))
            conn.client_ids.add((service, client))
            version, servers = svc.get_servers(client, -1)
            code = "OK" if servers else "NO_READY"
            return {"code": code, "version": version, "servers": servers}
        if m == "heartbeat":
            svc = self._services.get(service)
            if svc is None or not svc.is_registered(client):
                return {"code": "UNREGISTERED", "version": -1, "servers": None}
            try:
                version, servers = svc.get_servers(
                    client, int(msg.get("version", -1)))
            except KeyError:
                return {"code": "UNREGISTERED", "version": -1, "servers": None}
            code = "OK" if (servers or version > 0) else "NO_READY"
            return {"code": code, "version": version, "servers": servers}
        return {"code": "BAD_REQUEST", "version": -1, "servers": None}

    def stop(self) -> None:
        self._halt.set()
        self._thread.join(timeout=5.0)
        # close() stops store watchers (joins their threads): snapshot
        # under the lock, close outside it — BalanceTable.close() parity
        with self._lock:
            services = list(self._services.values())
            self._services = {}
        for svc in services:
            svc.close()
        try:
            self._sel.close()
        except OSError:
            pass
        self._listener.close()


class LiteDiscoveryClient:
    """Student-side socket client: register, heartbeat on a thread,
    expose the current teacher set via :meth:`servers` — plug into
    ``DistillReader.set_servers_fn``."""

    def __init__(self, endpoint: str, service: str, require_num: int = 4,
                 period: float = 1.0):
        self._endpoint = endpoint
        self._service = service
        self._require = require_num
        self._period = period
        self._client_id = f"{local_ip()}-{id(self):x}-{time.monotonic_ns()}"
        self._lock = threading.Lock()
        self._servers: list[str] = []
        self._version = -1
        self._halt = threading.Event()
        self._sock: socket.socket | None = None
        self._thread: threading.Thread | None = None

    # -- wire ----------------------------------------------------------------
    def _call(self, msg: dict) -> dict:
        if self._sock is None:
            host, _, port = self._endpoint.rpartition(":")
            self._sock = socket.create_connection((host or "127.0.0.1",
                                                   int(port)), timeout=10.0)
        self._sock.sendall(pack(msg))
        header = self._recv_exact(_HEADER.size)
        magic, length = _HEADER.unpack(header)
        if magic != MAGIC or length > MAX_FRAME:
            raise ConnectionError("bad frame from lite balance server")
        return json.loads(self._recv_exact(length).decode())

    def _recv_exact(self, n: int) -> bytes:
        assert self._sock is not None
        buf = b""
        while len(buf) < n:
            chunk = self._sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("lite balance server closed")
            buf += chunk
        return buf

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "LiteDiscoveryClient":
        resp = self._call({"m": "register", "service": self._service,
                           "client": self._client_id,
                           "require": self._require})
        self._apply(resp)
        self._thread = threading.Thread(target=self._heartbeat, daemon=True,
                                        name="lite-discovery")
        self._thread.start()
        return self

    def _apply(self, resp: dict) -> None:
        with self._lock:
            if resp.get("servers") is not None:
                self._servers = list(resp["servers"])
                self._version = int(resp.get("version", self._version))

    def _heartbeat(self) -> None:
        while not self._halt.wait(self._period):
            try:
                resp = self._call({"m": "heartbeat",
                                   "service": self._service,
                                   "client": self._client_id,
                                   "version": self._version})
                if resp.get("code") == "UNREGISTERED":
                    resp = self._call({"m": "register",
                                       "service": self._service,
                                       "client": self._client_id,
                                       "require": self._require})
                self._apply(resp)
            except (OSError, ConnectionError) as e:
                logger.warning("lite discovery heartbeat failed: %s", e)
                try:
                    if self._sock is not None:
                        self._sock.close()
                finally:
                    self._sock = None

    def servers(self) -> list[str]:
        with self._lock:
            return list(self._servers)

    def stop(self) -> None:
        self._halt.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
