"""Chunked byte-blob transfer over the EDL1 RPC envelope (a copy of the JAX
package's ``rpc/chunks.py``).

A blob too large for one comfortable frame streams as bounded chunks:

- **push**: ``call(seq=i, data=<chunk>, eof=bool)`` per chunk, in order on
  one connection; the receiver appends and validates ``seq``, so a dropped
  or duplicated frame is a typed error, not silent corruption;
- **fetch**: ``call(offset=o, length=n) -> bytes`` per chunk; the caller
  knows the total size and reassembles.

Both take a ``call`` callable (typically ``functools.partial(RpcClient.
call, "method", **identity)``).  The throughput paths keep a window of
chunk requests in flight on one pooled channel
(:func:`push_bytes_pipelined`, :func:`fetch_bytes_pipelined`), or read a
server-push stream (:func:`iter_fetch_streaming`).  Chunks go out as
``memoryview`` slices, so a push copies no chunk before packing it.
"""

from __future__ import annotations

from typing import Callable, Iterator

from edl_tpu_torch.utils import constants
from edl_tpu_torch.utils.exceptions import EdlStreamError


def _chunk_count(nbytes: int, chunk_bytes: int) -> int:
    return max(1, -(-nbytes // chunk_bytes))  # ceil; >=1 for empty data


def _check_chunk_bytes(chunk_bytes: int) -> int:
    chunk_bytes = chunk_bytes or constants.chunk_bytes()
    if chunk_bytes <= 0:
        raise ValueError(f"chunk_bytes must be positive, got {chunk_bytes}")
    return chunk_bytes


def _describe(got) -> str:
    """A diagnosis-safe description of a bad chunk result: never calls
    ``len`` on something that may not have one."""
    if isinstance(got, (bytes, bytearray, memoryview)):
        return f"{len(bytes(got))} bytes"
    return f"a {type(got).__name__}"


def push_bytes(call: Callable[..., object], data,
               chunk_bytes: int = 0) -> int:
    """Send ``data`` as an ordered chunk sequence; returns chunk count.

    ``call`` receives ``seq`` (0-based), ``data`` (the chunk) and
    ``eof`` (True on the final chunk).  Empty payloads still send one
    empty eof chunk so the receiver always observes a complete stream.
    """
    chunk_bytes = _check_chunk_bytes(chunk_bytes)
    mv = memoryview(data)
    n = _chunk_count(len(mv), chunk_bytes)
    for seq in range(n):
        off = seq * chunk_bytes
        call(seq=seq, data=mv[off:off + chunk_bytes], eof=seq == n - 1)
    return n


def push_bytes_pipelined(pool, method: str, data, chunk_bytes: int = 0,
                         window: int = 0, **identity) -> int:
    """:func:`push_bytes` with up to ``window`` chunks in flight on one
    of ``pool``'s channels.  Safe for seq-validated receivers: one
    channel's requests arrive in order.  Returns the chunk count."""
    chunk_bytes = _check_chunk_bytes(chunk_bytes)
    mv = memoryview(data)
    n = _chunk_count(len(mv), chunk_bytes)
    reqs = [dict(identity, seq=seq,
                 data=mv[seq * chunk_bytes:(seq + 1) * chunk_bytes],
                 eof=seq == n - 1)
            for seq in range(n)]
    for _ in pool.iter_call_pipelined(method, reqs, window=window or None):
        pass
    return n


def fetch_bytes(call: Callable[..., bytes], nbytes: int,
                chunk_bytes: int = 0, label: str = "") -> bytes:
    """Fetch ``nbytes`` as bounded chunks; ``call(offset=, length=)``
    must return exactly the requested slice (short reads are protocol
    errors — the size came from the same manifest as the data).
    ``label`` names the method/endpoint in diagnostics."""
    chunk_bytes = _check_chunk_bytes(chunk_bytes)
    out = bytearray()
    while len(out) < nbytes:
        want = min(chunk_bytes, nbytes - len(out))
        got = call(offset=len(out), length=want)
        if not isinstance(got, (bytes, bytearray, memoryview)) \
                or len(bytes(got)) != want:
            raise ConnectionError(
                f"chunk fetch{' of ' + label if label else ''} at offset "
                f"{len(out)} returned {_describe(got)}, wanted {want} bytes")
        out.extend(got)
    return bytes(out)


def fetch_bytes_pipelined(pool, method: str, nbytes: int,
                          chunk_bytes: int = 0, window: int = 0,
                          offset: int = 0, label: str = "",
                          **identity) -> bytes:
    """:func:`fetch_bytes` with a window of chunk requests in flight on
    one pooled channel.  Works against old one-chunk-per-call servers —
    the pipelining is entirely client-side."""
    return b"".join(iter_fetch_pipelined(pool, method, nbytes, chunk_bytes,
                                         window, offset, label, **identity))


def iter_fetch_pipelined(pool, method: str, nbytes: int,
                         chunk_bytes: int = 0, window: int = 0,
                         offset: int = 0, label: str = "",
                         **identity) -> Iterator[bytes]:
    """Ordered chunk iterator over the pipelined fetch path —
    incremental (``iter_call_pipelined``), so resident memory is one
    window of chunks, not the whole range."""
    chunk_bytes = _check_chunk_bytes(chunk_bytes)
    reqs, sizes = [], []
    pos = offset
    end = offset + nbytes
    while pos < end:
        want = min(chunk_bytes, end - pos)
        reqs.append(dict(identity, offset=pos, length=want))
        sizes.append(want)
        pos += want
    results = pool.iter_call_pipelined(method, reqs, window=window or None)
    for req, want, got in zip(reqs, sizes, results):
        if not isinstance(got, (bytes, bytearray, memoryview)) \
                or len(bytes(got)) != want:
            raise ConnectionError(
                f"pipelined chunk fetch{' of ' + label if label else ''} "
                f"at offset {req['offset']} returned {_describe(got)}, "
                f"wanted {want} bytes")
        yield bytes(got)


def iter_fetch_streaming(pool, method: str, nbytes: int,
                         chunk_bytes: int = 0, offset: int = 0,
                         label: str = "", **identity) -> Iterator[bytes]:
    """Ordered chunk iterator over a server-push stream (one request,
    many frames); validates total length — sequence validity is the
    transport's job (``call_streaming``)."""
    chunk_bytes = _check_chunk_bytes(chunk_bytes)
    got = 0
    for chunk in pool.call_streaming(method, offset=offset, length=nbytes,
                                     chunk_bytes=chunk_bytes, **identity):
        if not isinstance(chunk, (bytes, bytearray, memoryview)):
            raise EdlStreamError(
                f"streamed fetch{' of ' + label if label else ''} frame "
                f"carried {_describe(chunk)}, wanted bytes")
        got += len(chunk)
        if got > nbytes:
            raise EdlStreamError(
                f"streamed fetch{' of ' + label if label else ''} overran: "
                f"{got} of {nbytes} bytes")
        yield chunk
    if got != nbytes:
        raise EdlStreamError(
            f"streamed fetch{' of ' + label if label else ''} ended "
            f"{nbytes - got} bytes short (dropped frame?)")
