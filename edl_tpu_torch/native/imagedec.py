"""Native JPEG decode and augment of a whole batch (``csrc/imagedec.cc``;
the port of the JAX package's ``native/imagedec.py``).

One call decodes a batch of record payloads on a C++ thread pool (libjpeg
with DCT-domain downscaling), with no Python per record.  The output is the
``cv2`` path's format (``data/images.py``): uint8 BGR ``[n, size, size, 3]``
and int32 labels.
"""

from __future__ import annotations

import ctypes

import numpy as np

from edl_tpu_torch.native.build import ensure_built


def available() -> bool:
    """True when the library built with libjpeg."""
    lib = ensure_built()
    return lib is not None and hasattr(lib, "edl_imgdec_batch")


def decode_batch(records: list[bytes], size: int, *, seed: int = 0, train: bool = True,
                 threads: int = 8) -> tuple[np.ndarray, np.ndarray, int]:
    """Decode and augment ``records`` -> (images u8 BGR [n, size, size, 3],
    labels i32 [n], failed count).  A failed record's image is zero and its
    label -1.  Raises RuntimeError when the decoder is unavailable."""
    lib = ensure_built()
    if lib is None or not hasattr(lib, "edl_imgdec_batch"):
        raise RuntimeError("native imagedec unavailable (no libjpeg?)")
    n = len(records)
    imgs = np.empty((n, size, size, 3), np.uint8)
    labels = np.empty((n,), np.int32)
    if n == 0:
        return imgs, labels, 0
    bufs = (ctypes.c_char_p * n)(*records)   # kept alive until the call returns
    lens = np.asarray([len(r) for r in records], np.int64)
    failed = lib.edl_imgdec_batch(
        bufs, lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n, size,
        seed & (2**64 - 1), 1 if train else 0, threads,
        imgs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return imgs, labels, int(failed)
