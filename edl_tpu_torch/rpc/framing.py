"""Wire format: ``b"EDL1" | u32_be length | msgpack payload``.

A copy of the JAX package's ``rpc/framing.py`` (the frames its server and
the C++ daemon speak): one frame out, one frame back, and the streamed
reply's raw payloads, whose length the envelope frame before them carries.
This module is the port's only importer of ``msgpack``: the store client,
the servers and the data plane import it, and a trainer imports them only
when the launcher's environment names a store.
"""

from __future__ import annotations

import socket
import struct

import msgpack

MAGIC = b"EDL1"
MAX_FRAME = 1 << 30
_HEADER = struct.Struct(">4sI")


class FramingError(ConnectionError):
    pass


def pack(obj) -> bytes:
    body = msgpack.packb(obj, use_bin_type=True)
    if len(body) > MAX_FRAME:
        raise FramingError(f"frame too large: {len(body)}")
    return _HEADER.pack(MAGIC, len(body)) + body


def send_frame(sock: socket.socket, obj) -> None:
    """Write one frame; header and body go out in one ``sendall`` so
    TCP_NODELAY cannot split the header into a packet of its own."""
    sock.sendall(pack(obj))


def unpack(body):
    """Decode one msgpack body (a raw stream frame that carries a packed
    record)."""
    return msgpack.unpackb(body, raw=False, strict_map_key=False)


def send_raw(sock: socket.socket, payload) -> None:
    """Write a bytes-like payload verbatim (no msgpack, no length prefix:
    the envelope frame before it carried the length)."""
    sock.sendall(payload)


def recv_raw(sock: socket.socket, n: int) -> bytearray:
    """Counterpart of :func:`send_raw`: read exactly ``n`` payload bytes."""
    if n > MAX_FRAME:
        raise FramingError(f"raw payload too large: {n}")
    return _recv_exact(sock, n)


def _recv_exact(sock: socket.socket, n: int) -> bytearray:
    """Read exactly ``n`` bytes into one preallocated buffer."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:])
        if not r:
            raise FramingError("connection closed mid-frame" if got
                               else "connection closed")
        got += r
    return buf


def recv_frame(sock: socket.socket):
    magic, length = _HEADER.unpack(bytes(_recv_exact(sock, _HEADER.size)))
    if magic != MAGIC:
        raise FramingError(f"bad magic {magic!r}")
    if length > MAX_FRAME:
        raise FramingError(f"frame too large: {length}")
    return unpack(_recv_exact(sock, length))
