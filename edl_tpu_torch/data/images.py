"""Image input pipeline: recordio-backed decode + augment on the host (a
copy of the JAX package's ``data/images.py``, on the port's own record IO
and decoder bindings, ``edl_tpu_torch/native``).

JPEG samples live in CRC-checked recordio files (``csrc/recordio.cc``),
the C++ shuffle window randomises them, and a batch is decoded either by
the native decoder (``csrc/imagedec.cc``, libjpeg) or by a ``cv2`` thread
pool (``cv2`` releases the GIL).  Batches come out NHWC float32
(normalised), which the port's ResNet takes as they are (its NCHW
``channels_last`` view is the same bytes), or uint8 BGR for
:func:`device_normalize` on the card.  ``cv2`` is imported only inside the
functions that use it: a machine without it runs the native decoder or
none.

Augmentations match the reference training recipe (reader_cv2.py
random_crop/flip/normalize, dali.py RandomResizedCrop 0.08-1.0):
train = random-resized-crop + horizontal flip + per-channel normalize;
eval = resize-shorter-side + center crop + normalize.
"""

from __future__ import annotations

import functools
import os
import queue
import struct
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np
import torch

from edl_tpu_torch.native.recordio import RecordReader, RecordWriter, ShuffleReader

# Per-channel stats in 0-255 scale (reader_cv2.py img_mean/img_std).
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32) * 255.0
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32) * 255.0

_LABEL = struct.Struct("<i")


# -- sample codec ------------------------------------------------------------
def encode_sample(image_bytes: bytes, label: int) -> bytes:
    """One record = little-endian int32 label + encoded image bytes."""
    return _LABEL.pack(label) + image_bytes


def decode_sample(record: bytes) -> tuple[bytes, int]:
    (label,) = _LABEL.unpack_from(record)
    return record[_LABEL.size:], label


# -- decode + augment --------------------------------------------------------
def _imdecode_bgr(image_bytes: bytes) -> np.ndarray:
    import cv2
    arr = np.frombuffer(image_bytes, np.uint8)
    img = cv2.imdecode(arr, cv2.IMREAD_COLOR)  # BGR HWC uint8
    if img is None:
        raise ValueError("undecodable image record")
    return img


def _imdecode(image_bytes: bytes) -> np.ndarray:
    return _imdecode_bgr(image_bytes)[:, :, ::-1]  # RGB


def _normalize(img: np.ndarray) -> np.ndarray:
    return (img.astype(np.float32) - IMAGENET_MEAN) / IMAGENET_STD


def random_resized_crop(img: np.ndarray, size: int, rng: np.random.Generator,
                        scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3)) -> np.ndarray:
    """DALI RandomResizedCrop / reader_cv2 random_crop equivalent."""
    import cv2
    h, w = img.shape[:2]
    area = h * w
    for _ in range(10):
        target = area * rng.uniform(*scale)
        aspect = np.exp(rng.uniform(np.log(ratio[0]), np.log(ratio[1])))
        cw = int(round(np.sqrt(target * aspect)))
        ch = int(round(np.sqrt(target / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            y = rng.integers(0, h - ch + 1)
            x = rng.integers(0, w - cw + 1)
            crop = img[y:y + ch, x:x + cw]
            return cv2.resize(crop, (size, size), interpolation=cv2.INTER_LINEAR)
    # fallback: center crop of the shorter side
    side = min(h, w)
    y, x = (h - side) // 2, (w - side) // 2
    return cv2.resize(img[y:y + side, x:x + side], (size, size),
                      interpolation=cv2.INTER_LINEAR)


def center_crop_resize(img: np.ndarray, size: int,
                       resize_short: int | None = None) -> np.ndarray:
    """Eval transform (reader_cv2 resize_short + crop_image)."""
    import cv2
    h, w = img.shape[:2]
    short = resize_short or int(size * 256 / 224)
    s = short / min(h, w)
    img = cv2.resize(img, (max(size, int(round(w * s))),
                           max(size, int(round(h * s)))),
                     interpolation=cv2.INTER_LINEAR)
    h, w = img.shape[:2]
    y, x = (h - size) // 2, (w - size) // 2
    return img[y:y + size, x:x + size]


def decode_train(record: bytes, size: int, rng: np.random.Generator,
                 normalize: bool = True) -> tuple[np.ndarray, int]:
    """``normalize=False`` keeps uint8 BGR (no host float math, 4x fewer
    host->device bytes); pair with :func:`device_normalize` in the step:
    on a host with few cores the decode path is the input bottleneck and
    normalization is its single largest cost."""
    image_bytes, label = decode_sample(record)
    raw = _imdecode_bgr(image_bytes) if not normalize else _imdecode(image_bytes)
    img = random_resized_crop(raw, size, rng)
    if rng.random() < 0.5:
        img = img[:, ::-1]
    return (_normalize(img) if normalize else np.ascontiguousarray(img)), label


def decode_eval(record: bytes, size: int,
                normalize: bool = True) -> tuple[np.ndarray, int]:
    image_bytes, label = decode_sample(record)
    if normalize:
        return _normalize(center_crop_resize(_imdecode(image_bytes), size)), label
    img = center_crop_resize(_imdecode_bgr(image_bytes), size)
    return np.ascontiguousarray(img), label


@functools.lru_cache(maxsize=None)
def _device_stats(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """IMAGENET_MEAN and IMAGENET_STD on ``device``, built once."""
    return (torch.from_numpy(IMAGENET_MEAN).to(device), torch.from_numpy(IMAGENET_STD).to(device))


def device_normalize(images_u8: torch.Tensor, bgr: bool = True) -> torch.Tensor:
    """The device half of ``normalize=False``: on a uint8 NHWC tensor, the
    BGR to RGB flip, then the per-channel normalisation, in f32."""
    mean, std = _device_stats(images_u8.device)
    x = images_u8.flip(-1) if bgr else images_u8
    return (x.float() - mean) / std


# -- the batch pipeline ------------------------------------------------------
class ImageBatches:
    """Iterate ``{"image": (B,S,S,3) f32, "label": (B,) i32}`` batches.

    A reader thread streams records (shuffled through the native window
    for training); decode+augment runs through the native C++ batch
    decoder when available (csrc/imagedec.cc — libjpeg with DCT-domain
    downscaling, real threads, zero Python per record) and falls back
    to a cv2 thread pool (cv2 drops the GIL, so the pool still scales).
    Up to ``prefetch`` assembled batches wait in a queue — the
    host-side double-buffering the reference got from DALI's pipelined
    stages.

    ``use_native``: None = auto (native when built), False = cv2 path,
    True = require native.  Augmentation rngs differ between the two
    (identical distributions, different draws).
    """

    def __init__(self, paths: list[str], batch_size: int,
                 image_size: int = 224, train: bool = True, seed: int = 0,
                 num_workers: int = 8, prefetch: int = 4,
                 shuffle_buffer: int = 4096, drop_remainder: bool = True,
                 normalize: bool = True, use_native: bool | None = None):
        self._paths = list(paths)
        self._bs = batch_size
        self._size = image_size
        self._train = train
        self._seed = seed
        self._workers = num_workers
        self._prefetch = prefetch
        self._buffer = shuffle_buffer
        self._drop = drop_remainder
        # normalize=False emits uint8 BGR batches for device_normalize
        self._normalize = normalize
        from edl_tpu_torch.native import imagedec
        if use_native is None:
            self._native = imagedec.available()
        else:
            if use_native and not imagedec.available():
                raise RuntimeError("use_native=True but the native image "
                                   "decoder is unavailable (no libjpeg?)")
            self._native = use_native

    def _records(self) -> Iterator[bytes]:
        if self._train:
            reader = ShuffleReader(self._paths, buffer_size=self._buffer,
                                   seed=self._seed)
            try:
                yield from reader
            finally:
                reader.close()
        else:
            for p in self._paths:
                reader = RecordReader(p)
                try:
                    yield from reader
                finally:
                    reader.close()

    def __iter__(self):
        out: queue.Queue = queue.Queue(maxsize=self._prefetch)
        stop = threading.Event()

        def produce():
            rngs = [np.random.default_rng((self._seed, i))
                    for i in range(self._bs)]
            batch_no = 0

            def decode_native(records: list[bytes]) -> dict:
                from edl_tpu_torch.native import imagedec
                imgs, labels, failed = imagedec.decode_batch(
                    records, self._size,
                    seed=self._seed * 1_000_003 + batch_no,
                    train=self._train, threads=self._workers)
                if failed:
                    raise ValueError(f"{failed} undecodable image records")
                if self._normalize:
                    # native emits uint8 BGR; match the cv2 path's
                    # normalized RGB float32 (vectorized, not per-record)
                    imgs = (imgs[..., ::-1].astype(np.float32)
                            - IMAGENET_MEAN) / IMAGENET_STD
                return {"image": imgs, "label": labels}

            def decode_batch(pool, records: list[bytes]) -> dict:
                # contiguous chunks per worker, decoded straight into
                # preallocated output arrays: one Python-level task per
                # WORKER, no per-record futures, no np.stack copy —
                # matters on few-core hosts where scheduling overhead
                # competes with the decode itself
                n = len(records)
                dtype = np.float32 if self._normalize else np.uint8
                imgs = np.empty((n, self._size, self._size, 3), dtype)
                labels = np.empty((n,), np.int32)
                workers = max(1, min(self._workers, n))
                spans = [(w * n // workers, (w + 1) * n // workers)
                         for w in range(workers)]

                def work(span):
                    for i in range(span[0], span[1]):
                        if self._train:
                            img, lab = decode_train(
                                records[i], self._size, rngs[i % self._bs],
                                normalize=self._normalize)
                        else:
                            img, lab = decode_eval(
                                records[i], self._size,
                                normalize=self._normalize)
                        imgs[i] = img
                        labels[i] = lab

                list(pool.map(work, spans))
                return {"image": imgs, "label": labels}

            try:
                with ThreadPoolExecutor(self._workers) as pool:
                    chunk: list[bytes] = []
                    for rec in self._records():
                        if stop.is_set():
                            return
                        chunk.append(rec)
                        if len(chunk) == self._bs:
                            out.put(decode_native(chunk) if self._native
                                    else decode_batch(pool, chunk))
                            batch_no += 1
                            chunk = []
                    if chunk and not self._drop:
                        out.put(decode_native(chunk) if self._native
                                else decode_batch(pool, chunk))
            except Exception as e:  # noqa: BLE001 — surface in consumer
                out.put(e)
                return
            out.put(None)

        t = threading.Thread(target=produce, daemon=True, name="img-pipeline")
        t.start()
        try:
            while True:
                item = out.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            # unblock a producer stuck on a full queue
            while not out.empty():
                try:
                    out.get_nowait()
                except queue.Empty:
                    break


# -- synthetic dataset (tests / bench without ImageNet) ----------------------
def write_synthetic_imagenet(directory: str, n_files: int = 4,
                             per_file: int = 128, size: int = 96,
                             classes: int = 10, seed: int = 0,
                             prefix: str = "train") -> list[str]:
    """Write JPEG recordio shards of a learnable toy task: each class has
    a distinct mean color + structured stripe pattern, with noise.  Lets
    CI train a real conv net end-to-end and verify accuracy rises."""
    import cv2
    os.makedirs(directory, exist_ok=True)
    rng = np.random.default_rng(seed)
    paths = []
    for fi in range(n_files):
        path = os.path.join(directory, f"{prefix}-{fi:03d}.rec")
        with RecordWriter(path) as w:
            for _ in range(per_file):
                label = int(rng.integers(classes))
                hue = np.zeros((size, size, 3), np.float32)
                hue[..., label % 3] = 120 + 100 * (label / max(1, classes - 1))
                stripes = ((np.arange(size) // max(2, size // (2 + label)))
                           % 2 * 60.0)
                hue[..., (label + 1) % 3] += stripes[None, :, None].squeeze(-1)
                img = hue + rng.normal(0, 25, hue.shape)
                img = np.clip(img, 0, 255).astype(np.uint8)
                ok, enc = cv2.imencode(".jpg", img[:, :, ::-1],
                                       [cv2.IMWRITE_JPEG_QUALITY, 90])
                assert ok
                w.write(encode_sample(enc.tobytes(), label))
        paths.append(path)
    return paths


def shard_files(paths: list[str], shard: int, num_shards: int) -> list[str]:
    """Deterministic round-robin file slice for one host (the reference
    round-robined the file list across pods, data_server.py:118-133)."""
    if num_shards <= 1:
        return list(paths)
    picked = sorted(paths)[shard::num_shards]
    # every shard must see >=1 file or its trainer contributes nothing
    return picked if picked else [sorted(paths)[shard % len(paths)]]
