"""Striped multi-holder bulk transfer (a copy of the JAX package's
``rpc/transfer.py`` without its metrics and trace events).

A blob that several peers hold (a shard's owner and its ring replica) is
split into contiguous chunk-aligned ranges, one per holder, fetched
concurrently.  A holder that dies mid-range is demoted: its unfetched
remainder is re-assigned to the survivors, and only when every holder is
dead does the fetch raise.  Each range keeps a running ``zlib.crc32`` as
its chunks land, and the per-range CRCs fold into the whole-blob CRC with
:func:`crc32_combine` (zlib's GF(2) matrix method, which the ``zlib``
module does not export), so verification adds no latency after the last
byte arrives.
"""

from __future__ import annotations

import logging
import threading
import zlib
from typing import Callable, Iterable, Iterator, Sequence

logger = logging.getLogger(__name__)


def _gf2_times(mat: Sequence[int], vec: int) -> int:
    s = 0
    i = 0
    while vec:
        if vec & 1:
            s ^= mat[i]
        vec >>= 1
        i += 1
    return s


def _gf2_square(mat: Sequence[int]) -> list[int]:
    return [_gf2_times(mat, mat[n]) for n in range(32)]


def crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """CRC32 of ``A + B`` from ``crc32(A)``, ``crc32(B)`` and ``len(B)``."""
    if len2 <= 0:
        return crc1
    odd = [0xEDB88320] + [1 << (n - 1) for n in range(1, 32)]
    even = _gf2_square(odd)
    odd = _gf2_square(even)
    while True:
        even = _gf2_square(odd)
        if len2 & 1:
            crc1 = _gf2_times(even, crc1)
        len2 >>= 1
        if not len2:
            break
        odd = _gf2_square(even)
        if len2 & 1:
            crc1 = _gf2_times(odd, crc1)
        len2 >>= 1
        if not len2:
            break
    return crc1 ^ crc2


class _Segment:
    """One contiguous fetched run: start, length and the CRC of its bytes."""

    __slots__ = ("start", "length", "crc")

    def __init__(self, start: int):
        self.start = start
        self.length = 0
        self.crc = 0

    def feed(self, chunk) -> None:
        self.crc = zlib.crc32(chunk, self.crc)
        self.length += len(chunk)


def _split_ranges(nbytes: int, n: int, chunk_bytes: int) -> list[tuple[int, int]]:
    """``n`` contiguous chunk-aligned (offset, length) ranges covering
    [0, nbytes); never an empty range."""
    n_chunks = max(1, -(-nbytes // chunk_bytes))
    n = max(1, min(n, n_chunks))
    out = []
    per, extra = divmod(n_chunks, n)
    off = 0
    for i in range(n):
        length = min((per + (1 if i < extra else 0)) * chunk_bytes, nbytes - off)
        if length > 0:
            out.append((off, length))
            off += length
    return out


def fetch_striped(nbytes: int, holders: Sequence[str],
                  make_iter: Callable[[str, int, int], Iterator],
                  chunk_bytes: int) -> tuple[bytearray, int]:
    """Fetch ``nbytes`` striped across ``holders``: ``(buffer, crc32)``.

    ``make_iter(holder, offset, length)`` yields that range's bytes in
    order.  A holder whose iterator raises is demoted and its remainder
    re-runs on a surviving holder; the last holder error is raised when
    nobody can serve a range."""
    buf = bytearray(nbytes)
    view = memoryview(buf)
    segments: list[_Segment] = []
    dead: set[str] = set()
    lock = threading.Lock()
    errors: list[BaseException] = []
    remaining: list[tuple[int, int]] = []

    def fetch_range(holder: str, offset: int, length: int) -> None:
        seg = _Segment(offset)
        try:
            pos, end = offset, offset + length
            for chunk in make_iter(holder, pos, length):
                if pos + len(chunk) > end:
                    raise ValueError(f"holder {holder} overran its range by "
                                     f"{pos + len(chunk) - end} bytes")
                view[pos:pos + len(chunk)] = chunk
                seg.feed(chunk)
                pos += len(chunk)
            if pos != end:
                raise ConnectionError(f"holder {holder} stream ended {end - pos} bytes "
                                      f"short of its range")
        except Exception as e:  # noqa: BLE001 — demote, the survivors finish
            with lock:
                if seg.length:
                    segments.append(seg)  # the prefix it did deliver
                dead.add(holder)
                errors.append(e)
                remaining.append((offset + seg.length, length - seg.length))
            logger.warning("striped fetch: holder %s failed %d bytes into range [%d, %d): %s",
                           holder, seg.length, offset, offset + length, e)
        else:
            with lock:
                segments.append(seg)

    assignments = [(h, off, ln) for h, (off, ln)
                   in zip(holders, _split_ranges(nbytes, len(holders), chunk_bytes))]
    while assignments:
        if len(assignments) == 1:
            fetch_range(*assignments[0])
        else:
            threads = [threading.Thread(target=fetch_range, args=a, daemon=True,
                                        name=f"stripe:{a[0][:8]}") for a in assignments]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        with lock:
            todo, remaining[:] = list(remaining), []
            live = [h for h in holders if h not in dead]
        if not todo:
            break
        if not live:
            raise errors[-1] if errors else ConnectionError(
                "striped fetch: every holder failed")
        assignments = [(live[i % len(live)], off, ln)
                       for i, (off, ln) in enumerate(todo) if ln > 0]

    segments.sort(key=lambda s: s.start)
    crc = covered = 0
    for seg in segments:
        if seg.start != covered:
            raise ConnectionError(f"striped fetch left a hole at byte {covered}")
        crc = crc32_combine(crc, seg.crc, seg.length) if covered else seg.crc
        covered += seg.length
    if covered != nbytes:
        raise ConnectionError(f"striped fetch covered {covered} of {nbytes} bytes")
    return buf, crc


def fetch_sequential(nbytes: int, it: Iterable, label: str = "") -> tuple[bytearray, int]:
    """One holder: drain ``it`` into a buffer with the CRC computed as the
    chunks arrive."""
    buf = bytearray(nbytes)
    view = memoryview(buf)
    pos = crc = 0
    where = f" of {label}" if label else ""
    for chunk in it:
        if pos + len(chunk) > nbytes:
            raise ConnectionError(f"fetch{where} overran {nbytes} bytes")
        view[pos:pos + len(chunk)] = chunk
        crc = zlib.crc32(chunk, crc)
        pos += len(chunk)
    if pos != nbytes:
        raise ConnectionError(f"fetch{where} ended {nbytes - pos} bytes short")
    return buf, crc
