"""On-demand ``g++`` build of the record-IO and image-decode library (the
port of the JAX package's ``native/build.py``).

The first use compiles ``csrc/recordio.cc`` and ``csrc/imagedec.cc`` (the
repo's sources, shared with the JAX package) into
``build/edl_tpu_torch/libedl_native.so`` and loads it with ``ctypes``,
declaring every entry point's argument and result types.  ``imagedec``
links ``-ljpeg``; without libjpeg the library is built without it (the
image pipeline then decodes with ``cv2``).  A library that is up to date
but does not load (built on another machine, against libraries this one
lacks) is built again once.  A failed build leaves the pure-Python record
IO in place; :func:`ensure_built` returns None.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from pathlib import Path

logger = logging.getLogger(__name__)

_ROOT = Path(__file__).resolve().parents[2]
SOURCES = (_ROOT / "csrc" / "recordio.cc", _ROOT / "csrc" / "imagedec.cc")
OUT = _ROOT / "build" / "edl_tpu_torch" / "libedl_native.so"
_OPTIONAL = {"imagedec.cc": ["-ljpeg"]}   # dropped, with its flags, when it fails

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_failed = False

_P, _I, _I64, _U64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_uint64
_U8P = ctypes.POINTER(ctypes.c_uint8)
# entry point -> (restype, argtypes), as csrc declares them
SIGNATURES = {
    "edl_recordio_writer_open": (_P, [ctypes.c_char_p]),
    "edl_recordio_write": (_I, [_P, _U8P, ctypes.c_uint32]),
    "edl_recordio_writer_close": (_I, [_P]),
    "edl_recordio_reader_open": (_P, [ctypes.c_char_p]),
    "edl_recordio_read": (_I64, [_P, ctypes.POINTER(_U8P)]),
    "edl_recordio_reader_close": (None, [_P]),
    "edl_shuffle_reader_open": (_P, [ctypes.POINTER(ctypes.c_char_p), _I, _U64, _U64]),
    "edl_shuffle_reader_next": (_I64, [_P, _U8P, _U64]),
    "edl_shuffle_reader_peek_len": (_U64, [_P]),
    "edl_shuffle_reader_error": (ctypes.c_char_p, [_P]),
    "edl_shuffle_reader_close": (None, [_P]),
    "edl_imgdec_batch": (_I, [ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(_I64), _I, _I,
                              _U64, _I, _I, _U8P, ctypes.POINTER(ctypes.c_int32)]),
}


def _compile(sources, flags: list[str]) -> None:
    """g++ to a process-unique temporary, then an atomic rename: concurrent
    builds (a world's ranks) never tear the output."""
    OUT.parent.mkdir(parents=True, exist_ok=True)
    tmp = OUT.with_name(f"{OUT.name}.tmp.{os.getpid()}")
    cmd = ["g++", "-std=c++17", "-pthread", "-O3", "-shared", "-fPIC",
           *map(str, sources), *flags, "-o", str(tmp)]
    logger.info("building native: %s", " ".join(cmd))
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
        os.replace(tmp, OUT)
    finally:
        tmp.unlink(missing_ok=True)


def _stale() -> bool:
    return not OUT.exists() or any(s.stat().st_mtime > OUT.stat().st_mtime for s in SOURCES)


def _build() -> None:
    extra = [f for s in SOURCES for f in _OPTIONAL.get(s.name, [])]
    try:
        _compile(SOURCES, extra)
    except subprocess.CalledProcessError as e:
        core = [s for s in SOURCES if s.name not in _OPTIONAL]
        logger.warning("optional native sources dropped (%s): %s",
                       ", ".join(sorted(_OPTIONAL)), (e.stderr or str(e)).strip()[:300])
        _compile(core, [])


def ensure_built() -> ctypes.CDLL | None:
    """Compile (if stale) and load the library; None when it cannot be
    built (no ``g++``, no sources)."""
    global _lib, _failed
    with _lock:   # one build at a time is this lock's purpose
        if _lib is not None or _failed:
            return _lib
        try:
            built = _stale()
            if built:
                _build()
            try:
                lib = ctypes.CDLL(str(OUT))
            except OSError as e:
                if built:
                    raise
                logger.warning("the native library does not load (%s); building it again", e)
                _build()
                lib = ctypes.CDLL(str(OUT))
            for name, (restype, argtypes) in SIGNATURES.items():
                if hasattr(lib, name):
                    fn = getattr(lib, name)
                    fn.restype, fn.argtypes = restype, argtypes
            _lib = lib
        except (subprocess.CalledProcessError, OSError) as e:
            logger.warning("native build unavailable (%s); using the Python fallbacks",
                           (getattr(e, "stderr", "") or str(e)).strip()[:500])
            _failed = True
        return _lib
