"""The port's image input path against the JAX package's: the record files
either package writes, the sample codec, the cv2 and native decoders, the
batch pipeline, ``device_normalize`` and the file shards (the cases of
``tests/test_image_pipeline.py`` and ``tests/test_native_imagedec.py``)."""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edl_tpu.data import images as jimages
from edl_tpu.native import imagedec as jimagedec
from edl_tpu.native import recordio as jrecordio
from edl_tpu_torch.data import images
from edl_tpu_torch.native import build, imagedec, recordio


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """Two files of 24 JPEG records at 40², 3 classes, and one of 10."""
    d = tmp_path_factory.mktemp("synth")
    train = images.write_synthetic_imagenet(str(d), n_files=2, per_file=24, size=40, classes=3)
    val = images.write_synthetic_imagenet(str(d), n_files=1, per_file=10, size=40, classes=2,
                                          seed=99, prefix="val")
    return train, val


def _read(path, reader=recordio.RecordReader, **kw):
    r = reader(path, **kw)
    try:
        return list(r)
    finally:
        r.close()


@pytest.mark.parametrize("native", [True, False])
def test_record_files_pass_between_the_packages(tmp_path, native):
    """The port reads what the JAX writer wrote, and the JAX reader what the
    port's writer wrote, native and Python readers alike."""
    recs = [np.random.default_rng(i).bytes(i * 7 + 1) for i in range(50)]
    ours, theirs = str(tmp_path / "ours.rec"), str(tmp_path / "theirs.rec")
    with recordio.RecordWriter(ours, use_native=native) as w:
        for r in recs:
            w.write(r)
    jrecordio.write_records(theirs, recs, use_native=native)
    for path in (ours, theirs):
        assert _read(path, use_native=native) == recs
        assert _read(path, jrecordio.RecordReader, use_native=not native) == recs
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()


def test_shuffle_reader_orders_as_the_jax_reader(tmp_path):
    paths = []
    for f in range(2):
        p = str(tmp_path / f"f{f}.rec")
        jrecordio.write_records(p, [bytes([f, i]) for i in range(40)])
        paths.append(p)
    for native in (True, False):
        ours = recordio.ShuffleReader(paths, buffer_size=16, seed=3, use_native=native)
        theirs = jrecordio.ShuffleReader(paths, buffer_size=16, seed=3, use_native=native)
        got, want = list(ours), list(theirs)
        ours.close()
        theirs.close()
        assert got == want and sorted(got) == sorted(bytes([f, i]) for f in range(2)
                                                     for i in range(40))


def test_sample_codec_matches_jax():
    payload = b"\xff\xd8jpegish"
    rec = images.encode_sample(payload, 123)
    assert rec == jimages.encode_sample(payload, 123)
    assert images.decode_sample(rec) == (payload, 123)


def test_decode_eval_and_train_equal_jax(synth):
    """The cv2 decode of the same records gives the JAX package's arrays,
    normalised or uint8 BGR, eval and train (same rng draws)."""
    recs = _read(synth[0][0])[:6]
    for rec in recs:
        for normalize in (True, False):
            got, lab = images.decode_eval(rec, 32, normalize=normalize)
            want, jlab = jimages.decode_eval(rec, 32, normalize=normalize)
            np.testing.assert_array_equal(got, want)
            assert lab == jlab
            got, _ = images.decode_train(rec, 32, np.random.default_rng(1), normalize=normalize)
            want, _ = jimages.decode_train(rec, 32, np.random.default_rng(1), normalize=normalize)
            np.testing.assert_array_equal(got, want)


def test_native_decode_batch_equals_jax(synth):
    if not (imagedec.available() and jimagedec.available()):
        pytest.skip("the native image decoder is not built here (no libjpeg)")
    recs = _read(synth[0][0])
    for train in (True, False):
        got = imagedec.decode_batch(recs, 32, seed=3, train=train, threads=2)
        want = jimagedec.decode_batch(recs, 32, seed=3, train=train, threads=2)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2] == 0
    assert str(build.OUT).endswith("build/edl_tpu_torch/libedl_native.so")


@pytest.mark.parametrize("use_native", [True, False])
def test_batches_equal_the_jax_pipeline(synth, use_native):
    """The whole train stream (shuffle window, decoder, augment draws) and
    the eval stream equal the JAX package's on the same files and seed."""
    if use_native and not imagedec.available():
        pytest.skip("the native image decoder is not built here (no libjpeg)")
    kw = dict(image_size=32, seed=5, num_workers=2, shuffle_buffer=16, use_native=use_native)
    got = list(images.ImageBatches(synth[0], 8, train=True, **kw))
    want = list(jimages.ImageBatches(synth[0], 8, train=True, **kw))
    assert len(got) == len(want) == 6
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a["image"], b["image"])
        np.testing.assert_array_equal(a["label"], b["label"])
    got = list(images.ImageBatches(synth[1], 4, train=False, drop_remainder=False, **kw))
    want = list(jimages.ImageBatches(synth[1], 4, train=False, drop_remainder=False, **kw))
    assert [len(b["label"]) for b in got] == [4, 4, 2]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a["image"], b["image"])


def test_use_native_raises_without_the_decoder(monkeypatch, synth):
    monkeypatch.setattr(imagedec, "available", lambda: False)
    with pytest.raises(RuntimeError, match="unavailable"):
        images.ImageBatches(synth[0], 8, use_native=True)
    # auto falls back to cv2
    batch = next(iter(images.ImageBatches(synth[0], 8, image_size=32, num_workers=2)))
    assert batch["image"].shape == (8, 32, 32, 3)


def test_device_normalize_matches_jax():
    u8 = np.random.default_rng(0).integers(0, 256, (3, 5, 7, 3)).astype(np.uint8)
    for bgr in (True, False):
        got = images.device_normalize(torch.from_numpy(u8), bgr=bgr)
        want = np.asarray(jimages.device_normalize(jnp.asarray(u8), bgr=bgr))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_synthetic_batches_and_shapes(synth):
    batches = list(images.ImageBatches(synth[0], 8, image_size=32, train=True, seed=0,
                                       num_workers=2))
    assert len(batches) == 6  # 48 samples / 8
    for b in batches:
        assert b["image"].shape == (8, 32, 32, 3)
        assert b["image"].dtype == np.float32
        assert b["label"].dtype == np.int32
        assert set(np.unique(b["label"])) <= {0, 1, 2}
    u8 = next(iter(images.ImageBatches(synth[0], 8, image_size=32, normalize=False)))
    assert u8["image"].dtype == np.uint8


def test_eval_pipeline_keeps_remainder_and_repeats(synth):
    batches = list(images.ImageBatches(synth[1], 4, image_size=32, train=False,
                                       drop_remainder=False))
    assert [len(b["label"]) for b in batches] == [4, 4, 2]
    again = list(images.ImageBatches(synth[1], 4, image_size=32, train=False,
                                     drop_remainder=False))
    np.testing.assert_array_equal(batches[0]["image"], again[0]["image"])


def test_train_shuffle_differs_by_seed(synth):
    a = next(iter(images.ImageBatches(synth[0], 16, image_size=32, seed=1)))
    b = next(iter(images.ImageBatches(synth[0], 16, image_size=32, seed=2)))
    assert not np.array_equal(a["label"], b["label"]) or \
        not np.array_equal(a["image"], b["image"])


def test_augment_geometry():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, (60, 80, 3), np.uint8)
    assert images.random_resized_crop(img, 32, rng).shape == (32, 32, 3)
    assert images.center_crop_resize(img, 32).shape == (32, 32, 3)


def test_corrupt_record_surfaces_in_consumer(tmp_path):
    p = str(tmp_path / "bad.rec")
    with recordio.RecordWriter(p) as w:
        w.write(images.encode_sample(b"notajpeg", 0))
    with pytest.raises(Exception):
        list(images.ImageBatches([p], 1, image_size=32, train=False, drop_remainder=False))


def test_shard_files_match_jax_and_never_empty():
    paths = [f"f{i}" for i in range(5)]
    shards = [images.shard_files(paths, r, 3) for r in range(3)]
    assert sorted(sum(shards, [])) == sorted(paths)
    for n in (1, 3, 8):
        for r in range(n):
            assert images.shard_files(paths, r, n) == jimages.shard_files(paths, r, n)
            assert images.shard_files(paths, r, n)


def test_shuffled_stream_is_deterministic(synth):
    digests = []
    for _ in range(3):
        h = hashlib.sha1()
        for b in images.ImageBatches(synth[0], 8, image_size=24, train=True, seed=5,
                                     num_workers=4, shuffle_buffer=16):
            h.update(b["image"].tobytes())
            h.update(b["label"].tobytes())
        digests.append(h.hexdigest())
    assert len(set(digests)) == 1, digests


def test_a_library_that_does_not_load_is_built_again(tmp_path, monkeypatch):
    """A library newer than its sources that does not load (as one built on
    another machine against libraries this one lacks) is built again once,
    not taken as the sign that the native build is unavailable."""
    out = tmp_path / "libedl_native.so"
    out.write_bytes(b"not a shared object")
    monkeypatch.setattr(build, "OUT", out)
    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(build, "_failed", False)
    assert not build._stale()
    lib = build.ensure_built()
    assert lib is not None and hasattr(lib, "edl_recordio_reader_open")
    assert out.read_bytes()[:4] == b"\x7fELF"
