"""The port's striped transfer (``edl_tpu_torch/rpc/transfer.py``) against
the JAX package's (``tests/test_transfer.py``'s twin): ``crc32_combine``
equals the JAX package's and ``zlib``'s, the ranges split alike, a striped
fetch reassembles and verifies a blob, a holder dying mid-range demotes to
the survivors, and a restore completes when one holder of a large shard
dies mid-stripe."""

import zlib

import numpy as np
import pytest

from edl_tpu.rpc import transfer as jax_transfer
from edl_tpu_torch.rpc import transfer

_RNG = np.random.default_rng(7)
_DATA = _RNG.bytes(1 << 18)


@pytest.mark.parametrize("cut", [0, 1, 100, 1 << 17, len(_DATA) - 1, len(_DATA)])
def test_crc32_combine_equals_zlib_and_jax(cut):
    a, b = _DATA[:cut], _DATA[cut:]
    got = transfer.crc32_combine(zlib.crc32(a), zlib.crc32(b), len(b))
    assert got == zlib.crc32(_DATA)
    assert got == jax_transfer.crc32_combine(zlib.crc32(a), zlib.crc32(b), len(b))


@pytest.mark.parametrize("nbytes,n,cb", [(100, 3, 7), (1, 4, 64), (1 << 20, 2, 1 << 16),
                                         (5, 8, 2), (0, 3, 16)])
def test_split_ranges_equal_jax_and_cover(nbytes, n, cb):
    ranges = transfer._split_ranges(nbytes, n, cb)
    assert ranges == jax_transfer._split_ranges(nbytes, n, cb)
    pos = 0
    for off, ln in ranges:
        assert off == pos and ln > 0 and off % cb == 0
        pos += ln
    assert pos == nbytes


def _mem_iter(data, cb=1 << 16):
    def make(holder, off, ln):
        return (data[p:min(off + ln, p + cb)] for p in range(off, off + ln, cb))
    return make


def test_striped_fetch_roundtrip():
    data = _RNG.bytes((1 << 21) + 999)
    buf, crc = transfer.fetch_striped(len(data), ["h1", "h2", "h3"], _mem_iter(data),
                                      chunk_bytes=1 << 16)
    assert bytes(buf) == data and crc == zlib.crc32(data)


def test_striped_holder_death_demotes_to_survivor():
    data = _RNG.bytes(1 << 21)
    served = []

    def make(holder, off, ln):
        def gen():
            if holder == "bad":
                yield data[off:off + 1024]
                raise ConnectionError("holder killed mid-stripe")
            served.append((off, ln))
            yield from _mem_iter(data)(holder, off, ln)
        return gen()

    buf, crc = transfer.fetch_striped(len(data), ["bad", "good"], make, chunk_bytes=1 << 16)
    assert bytes(buf) == data and crc == zlib.crc32(data)
    assert len(served) >= 2       # its own range and the dead holder's remainder


def test_striped_every_holder_dead_raises():
    def make(holder, off, ln):
        raise ConnectionError(f"{holder} down")
    with pytest.raises(ConnectionError):
        transfer.fetch_striped(1 << 20, ["a", "b"], make, chunk_bytes=1 << 16)


@pytest.mark.parametrize("chunks,match", [([b"abc", b"de"], "short"),
                                          ([b"abc", b"defgh"], "overran")])
def test_fetch_sequential_checks_the_length(chunks, match):
    with pytest.raises(ConnectionError, match=match):
        transfer.fetch_sequential(6, iter(chunks), label="k")
    buf, crc = transfer.fetch_sequential(5, iter([b"abc", b"de"]))
    assert bytes(buf) == b"abcde" and crc == zlib.crc32(b"abcde")


def test_restore_survives_holder_killed_mid_stripe(memkv, tmp_path, monkeypatch):
    """A shard above the stripe threshold held by two pods; one holder's
    stream dies mid-range: the restore still completes, bit-identical."""
    from edl_tpu_torch.cluster.state import State
    from edl_tpu_torch.memstate import advert
    from edl_tpu_torch.memstate import restore as ms_restore
    from edl_tpu_torch.memstate.tee import StateCacheTee
    from edl_tpu_torch.train.checkpoint import CheckpointManager
    from tests.helpers.torch_cache import (JOB, fresh_target, serve_pods, teardown, tiny_state,
                                           wait_for)

    monkeypatch.setenv("EDL_TPU_STRIPE_MIN_BYTES", "64")
    monkeypatch.setenv("EDL_TPU_MEMSTATE_CHUNK_BYTES", "32")
    pods = serve_pods(memkv, ["pod-a", "pod-b"])
    try:
        state = tiny_state()
        ck = CheckpointManager(str(tmp_path / "ck"), tee=StateCacheTee(memkv, JOB, "pod-a"))
        assert ck.save(7, state, State())
        ck.wait()
        wait_for(lambda: advert.read_committed_step(memkv, JOB) == 7, "never sealed")
        wait_for(lambda: "pod-a" in pods["pod-b"][0].cache_manifest(), "no replica")
        svc_b, srv_b, _reg = pods["pod-b"]
        cut = []

        def dying(owner, key, offset=0, length=-1, chunk_bytes=0):
            out = svc_b.cache_fetch_stream(owner, key, offset, length, chunk_bytes)
            if key.startswith("model/w@"):
                cut.append(key)

                def die(it=out.it):
                    yield next(it)
                    raise ConnectionError("holder killed mid-stripe")
                out.it = die()
            return out

        srv_b.register("cache_fetch_stream", dying)
        got, _meta, info = ms_restore.try_restore(memkv, JOB, fresh_target(), expect_step=7)
        assert cut and info["step"] == 7
        ms_restore.assert_bit_identical(got, state)
        ck.close()
    finally:
        teardown(pods)
