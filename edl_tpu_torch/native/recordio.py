"""Record IO: CRC-checked record files and a shuffle reader (the port of
the JAX package's ``native/recordio.py``).

The C++ reader and writer are ``csrc/recordio.cc``; the Python classes here
write and read the same on-disk format (``zlib.crc32`` is the C++ IEEE
CRC-32), so files pass between the two and between the packages.
``use_native=None`` picks the library when it builds.
"""

from __future__ import annotations

import ctypes
import random
import struct
import zlib
from collections import deque
from typing import Iterator

from edl_tpu_torch.native.build import ensure_built

MAGIC = b"EDLR"
VERSION = 1
_HDR = struct.Struct("<II")  # len, crc


def _want_native(use_native: bool | None) -> ctypes.CDLL | None:
    if use_native is False:
        return None
    lib = ensure_built()
    if lib is None and use_native is True:
        raise RuntimeError("native recordio requested but unavailable")
    return lib


class RecordWriter:
    def __init__(self, path: str, use_native: bool | None = None):
        self._lib = _want_native(use_native)
        if self._lib is not None:
            self._h = self._lib.edl_recordio_writer_open(path.encode())
            if not self._h:
                raise OSError(f"cannot open {path}")
            self._f = None
        else:
            self._f = open(path, "wb")
            self._f.write(MAGIC + struct.pack("<I", VERSION))

    def write(self, payload: bytes) -> None:
        if self._f is None:
            buf = (ctypes.c_uint8 * len(payload)).from_buffer_copy(payload)
            if self._lib.edl_recordio_write(self._h, buf, len(payload)) != 0:
                raise OSError("native record write failed")
        else:
            self._f.write(_HDR.pack(len(payload), zlib.crc32(payload)))
            self._f.write(payload)

    def close(self) -> None:
        if self._f is None:
            self._lib.edl_recordio_writer_close(self._h)
        else:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class RecordReader:
    def __init__(self, path: str, use_native: bool | None = None):
        self._lib = _want_native(use_native)
        self._path = path
        if self._lib is not None:
            self._h = self._lib.edl_recordio_reader_open(path.encode())
            if not self._h:
                raise OSError(f"cannot open/parse {path}")
            self._f = None
        else:
            self._f = open(path, "rb")
            if self._f.read(8)[:4] != MAGIC:
                self._f.close()
                raise OSError(f"bad magic in {path}")

    def __iter__(self) -> Iterator[bytes]:
        if self._f is None:
            out = ctypes.POINTER(ctypes.c_uint8)()
            while True:
                n = self._lib.edl_recordio_read(self._h, ctypes.byref(out))
                if n == -1:
                    return
                if n < 0:
                    raise OSError(f"corrupt record file {self._path}")
                yield ctypes.string_at(out, n)
        else:
            while True:
                hdr = self._f.read(_HDR.size)
                if not hdr:
                    return
                length, crc = _HDR.unpack(hdr)
                payload = self._f.read(length)
                if len(payload) != length or zlib.crc32(payload) != crc:
                    raise OSError(f"corrupt record file {self._path}")
                yield payload

    def close(self) -> None:
        if self._f is None:
            self._lib.edl_recordio_reader_close(self._h)
        else:
            self._f.close()


class ShuffleReader:
    """Uniform sampling from a bounded look-ahead window over many record
    files; the native reader reads and CRC-checks on a C++ thread.  Both
    orders are a function of (files, seed) only, but not the same one."""

    def __init__(self, paths: list[str], buffer_size: int = 1024, seed: int = 0,
                 use_native: bool | None = None):
        self._lib = _want_native(use_native)
        self._paths = list(paths)
        self._buffer_size = buffer_size
        self._seed = seed
        self._h = None
        if self._lib is not None:
            self._names = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
            self._h = self._lib.edl_shuffle_reader_open(self._names, len(paths), buffer_size,
                                                        seed)
            self._cap = 1 << 16
            self._buf = ctypes.create_string_buffer(self._cap)

    def __iter__(self) -> Iterator[bytes]:
        if self._lib is not None:
            yield from self._iter_native()
        else:
            yield from self._iter_python()

    def _iter_native(self) -> Iterator[bytes]:
        while True:
            n = self._lib.edl_shuffle_reader_next(
                self._h, ctypes.cast(self._buf, ctypes.POINTER(ctypes.c_uint8)), self._cap)
            if n == -3:  # grow to the largest buffered record
                need = self._lib.edl_shuffle_reader_peek_len(self._h)
                self._cap = max(self._cap * 2, int(need) + 1)
                self._buf = ctypes.create_string_buffer(self._cap)
                continue
            if n == -1:
                return
            if n == -2:
                err = self._lib.edl_shuffle_reader_error(self._h).decode()
                raise OSError(f"shuffle reader failed: {err}")
            yield ctypes.string_at(self._buf, n)

    def _iter_python(self) -> Iterator[bytes]:
        rng = random.Random(self._seed)
        window: deque[bytes] = deque()
        for path in self._paths:
            reader = RecordReader(path, use_native=False)
            try:
                for rec in reader:
                    window.append(rec)
                    if len(window) >= self._buffer_size:
                        idx = rng.randrange(len(window))
                        window[idx], window[-1] = window[-1], window[idx]
                        yield window.pop()
            finally:
                reader.close()
        while window:
            idx = rng.randrange(len(window))
            window[idx], window[-1] = window[-1], window[idx]
            yield window.pop()

    def close(self) -> None:
        if self._lib is not None and self._h:
            self._lib.edl_shuffle_reader_close(self._h)
            self._h = None
