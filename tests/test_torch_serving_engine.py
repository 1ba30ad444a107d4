"""The port's continuous-batching engine (``edl_tpu_torch/serving/engine.py``)
on the CPU in f32: greedy tokens equal to the JAX package's
``ContinuousBatcher`` from the same weights, and equal to the port's own
``generate`` of each request alone (slot independence, as
``tests/test_serving_engine.py`` asserts it for the JAX engine); then the
engine's scheduling, chunked prefill and lifecycle, mirroring
``tests/test_serving_engine.py`` and ``tests/test_serving_fastpath.py``
without mesh, MoE, paging or speculative decoding."""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edl_tpu.models import transformer as jtf
from edl_tpu.serving import ContinuousBatcher as JaxBatcher
from edl_tpu_torch.models import transformer as ttf
from edl_tpu_torch.models.convert import params_from_jax
from edl_tpu_torch.models.generate import generate
from edl_tpu_torch.serving import ContinuousBatcher

SMALL = dict(vocab_size=97, num_layers=2, embed_dim=64, num_heads=4, mlp_dim=128, max_len=64)


def _pair(seed=0, **kw):
    jc = jtf.TransformerConfig(dtype=jnp.float32, remat=False, **{**SMALL, **kw})
    tc = ttf.TransformerConfig(dtype=torch.float32, remat=False, **{**SMALL, **kw})
    params = jax.jit(jtf.TransformerLM(jc).init)(jax.random.key(seed),
                                                jnp.zeros((1, 4), jnp.int32))["params"]
    tm = ttf.TransformerLM(tc)
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), tc))
    return jc, params, tm


@pytest.fixture(scope="module")
def small():
    return ttf.TransformerLM(ttf.TransformerConfig(dtype=torch.float32, remat=False, **SMALL))


def _engine(model, **kw):
    kw.setdefault("slots", 3)
    kw.setdefault("prefill_buckets", (8, 16))
    kw.setdefault("temperature", 0.0)
    kw.setdefault("steps_per_sync", 4)
    return ContinuousBatcher(model, **kw)


def _want(model, p, n):
    return generate(model, torch.from_numpy(p[None]), n, temperature=0).numpy()[0]


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, SMALL["vocab_size"], (n,)).astype(np.int32) for n in lens]


@pytest.mark.parametrize("kv_heads", [0, 2], ids=["mha", "gqa2"])
def test_greedy_tokens_equal_jax_engine_and_generate(kv_heads):
    jc, params, tm = _pair(num_kv_heads=kv_heads)
    prompts = _prompts(0, (3, 7, 12, 5, 9, 16, 2, 30))
    news = [6, 3, 9, 12, 1, 5, 8, 6]
    eng = _engine(tm, prefill_chunk=8)
    jeng = JaxBatcher(jc, params, slots=3, prefill_buckets=(8, 16), temperature=0.0,
                      steps_per_sync=4, prefill_chunk=8)
    try:
        got = [f.result(timeout=120) for f in [eng.submit(p, n) for p, n in zip(prompts, news)]]
        want = [f.result(timeout=120)
                for f in [jeng.submit(p, n) for p, n in zip(prompts, news)]]
        stats = eng.stats()
    finally:
        eng.stop()
        jeng.stop()
    for p, n, a, b in zip(prompts, news, got, want):
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, _want(tm, p, n))
    # 12, 9, 16 and 30 tokens exceed the chunk: 2 + 2 + 2 + 4 chunks
    assert stats["chunked_admissions"] == 4 and stats["prefill_chunks"] == 10


def test_queue_deeper_than_slots(small):
    rng = np.random.default_rng(1)
    eng = _engine(small, slots=2)
    try:
        futs = [eng.submit(rng.integers(1, 97, (4,)).astype(np.int32), 5) for _ in range(9)]
        outs = [f.result(timeout=120) for f in futs]
        stats = eng.stats()
    finally:
        eng.stop()
    assert all(len(o) == 5 for o in outs)
    assert stats["requests_done"] == 9 and stats["tokens_emitted"] == 45
    assert stats["queue_depth"] == 0
    assert 0.0 < stats["slot_utilization"] <= 1.0


def test_eos_truncates(small):
    p = np.asarray([5, 9, 2], np.int32)
    ref = _want(small, p, 8)
    eos = int(ref[1])
    eng = _engine(small, eos_id=eos)
    try:
        out = eng.generate(p, 8, timeout=120)
    finally:
        eng.stop()
    assert list(out) == list(ref[:list(ref).index(eos) + 1])


def test_submit_validation(small):
    eng = _engine(small)
    try:
        with pytest.raises(ValueError, match="empty"):
            eng.submit(np.zeros((0,), np.int32), 4)
        with pytest.raises(ValueError, match="room"):
            eng.submit(np.zeros((64,), np.int32), 1)
        with pytest.raises(ValueError, match="max_len"):
            eng.submit(np.zeros((16,), np.int32), 60)
        with pytest.raises(ValueError, match="max_new_tokens"):
            eng.submit(np.zeros((4,), np.int32), 0)
    finally:
        eng.stop()


@pytest.mark.parametrize("kw,match", [({"mesh": object()}, "mesh"),
                                      ({"kv_block": 16}, "paged"),
                                      ({"spec_k": 2}, "speculative")],
                         ids=["mesh", "paging", "spec"])
def test_unported_options_raise(small, kw, match):
    with pytest.raises(NotImplementedError, match=match):
        ContinuousBatcher(small, **kw)


def test_spec_from_the_environment_raises(small, monkeypatch):
    monkeypatch.setenv("EDL_TPU_SPEC_K", "2")
    with pytest.raises(NotImplementedError, match="speculative"):
        ContinuousBatcher(small)


def test_prompt_longer_than_configured_buckets(small):
    """The prompt cap is the cache, not the bucket list: buckets extend
    by doubling to the cache length."""
    p = _prompts(9, (17,))[0]
    eng = _engine(small, prefill_chunk=0)
    try:
        assert eng.stats()["max_prompt_len"] == 63
        assert eng._buckets == (8, 16, 32, 64)
        out = eng.generate(p, 5, timeout=120)
    finally:
        eng.stop()
    np.testing.assert_array_equal(out, _want(small, p, 5))


def test_600_token_prompt_1024_cache():
    """A 1024-cache engine with the default buckets (max 512) and the
    default chunk size accepts a 600-token prompt."""
    tm = ttf.TransformerLM(ttf.TransformerConfig(
        vocab_size=61, num_layers=1, embed_dim=32, num_heads=2, mlp_dim=64, max_len=1024,
        remat=False, dtype=torch.float32))
    p = np.random.default_rng(4).integers(1, 61, (600,)).astype(np.int32)
    eng = ContinuousBatcher(tm, slots=2, temperature=0.0, steps_per_sync=4)
    try:
        out = eng.generate(p, 6, timeout=120)
        stats = eng.stats()
    finally:
        eng.stop()
    np.testing.assert_array_equal(out, _want(tm, p, 6))
    assert stats["prefill_chunk"] == 512 and stats["chunked_admissions"] == 1


def test_mixed_load_decode_not_starved(small):
    """Two long generations finish while a queue of short arrivals churns
    through the remaining slot; the scheduler's own accounting shows the
    churn, and the wall-clock ratio is a wide backstop only."""
    LONG, SHORT = 40, 4

    def run(churn):
        eng = _engine(small, slots=3)
        try:
            t0 = time.monotonic()
            longs = [eng.submit(np.asarray([7, 11, 13], np.int32), LONG) for _ in range(2)]
            shorts = [eng.submit(np.asarray([5, 9], np.int32), SHORT) for _ in range(churn)]
            for f in longs:
                assert len(f.result(timeout=120)) == LONG
            dt = time.monotonic() - t0
            for f in shorts:
                f.result(timeout=120)
            stats = eng.stats()
        finally:
            eng.stop()
        if churn:
            assert stats["prefill_stall_s"] > 0.0
            assert stats["requests_done"] == 2 + churn
        return dt

    quiet = run(0)
    busy = run(12)
    assert busy <= max(4.0 * quiet, quiet + 8.0), (quiet, busy)


def test_warm_then_serve(small):
    eng = _engine(small, slots=3, prefill_chunk=8)
    try:
        assert eng.PREFILL_KS == (2, 1)   # ladder filtered by slots
        eng.warm(7)
        eng.warm(20)                      # the chunk pair too
        p = _prompts(21, (7,))[0]
        out = eng.generate(p, 5, timeout=120)
        assert eng.stats()["requests_done"] == 1
    finally:
        eng.stop()
    np.testing.assert_array_equal(out, _want(small, p, 5))


def test_warm_mid_traffic_fails_loudly(small):
    eng = _engine(small, slots=2)
    try:
        fut = eng.submit(np.asarray([3, 1, 4], np.int32), 40)
        deadline = time.monotonic() + 60
        while not eng.stats()["active_slots"]:
            assert time.monotonic() < deadline, "request never admitted"
            time.sleep(0.005)
        with pytest.raises(RuntimeError, match="in flight"):
            eng.warm(7)
        fut.result(timeout=120)
        eng.warm(7)                       # legal again once traffic is gone
    finally:
        eng.stop()


def test_stop_fails_pending(small):
    eng = _engine(small, slots=1)
    futs = [eng.submit(np.asarray([3, 4], np.int32), 30) for _ in range(4)]
    eng.stop()
    assert all(f.done() for f in futs)
    assert any(f.exception() is not None for f in futs)
    with pytest.raises(RuntimeError, match="stopping"):
        eng.submit(np.asarray([3], np.int32), 2)


def test_drain_completes_queued_and_inflight(small):
    eng = _engine(small, slots=1)
    futs = [eng.submit(np.asarray([3, 4], np.int32), 8) for _ in range(5)]
    drained = []
    t = threading.Thread(target=lambda: drained.append(eng.drain()))
    t.start()
    deadline = time.monotonic() + 60
    while not eng.stats()["draining"]:
        assert time.monotonic() < deadline, "drain flag never observed"
        time.sleep(0.005)
    with pytest.raises(RuntimeError, match="draining|stopping"):
        eng.submit(np.asarray([5], np.int32), 4)
    t.join(timeout=120)
    assert drained == [True]
    for f in futs:
        assert len(f.result(timeout=1)) == 8


def test_drain_timeout_falls_back_to_hard_stop(small):
    eng = _engine(small, slots=1)
    futs = [eng.submit(np.asarray([3, 4], np.int32), 40) for _ in range(3)]
    assert eng.drain(timeout=0.0) is False
    assert all(f.done() for f in futs)
    assert sum(1 for f in futs if f.exception() is not None) >= 1


def test_run_on_engine_runs_on_the_engine_thread(small):
    eng = _engine(small)
    try:
        name = eng.run_on_engine(lambda: (threading.current_thread().name,
                                          torch.is_inference_mode_enabled()))
    finally:
        eng.stop()
    assert name == ("continuous-batcher", True)


def test_chunked_prefill_bit_exact_and_counted(small):
    """Prompts past ``prefill_chunk`` split into chunks; tokens equal to
    the unchunked engine's and to generate(), and the counters show the
    split."""
    prompts = _prompts(6, (40, 23, 6))      # 5 + 3 + 0 chunk dispatches
    outs = {}
    for chunk in (8, 0):
        eng = _engine(small, prefill_chunk=chunk, prefill_buckets=(8,))
        try:
            outs[chunk] = [eng.generate(p, 5, timeout=120) for p in prompts]
            st = eng.stats()
        finally:
            eng.stop()
        if chunk:
            assert st["chunked_admissions"] == 2 and st["prefill_chunks"] == 8, st
        else:
            assert st["chunked_admissions"] == 0 and st["prefill_chunks"] == 0, st
    for p, a, b in zip(prompts, outs[8], outs[0]):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, _want(small, p, 5))


def test_chunked_prefill_does_not_starve_decode(small):
    """A live decode keeps ticking while a long admission prefills: the
    short request finishes while the long one is still in flight."""
    short, long = _prompts(8, (6, 40))
    eng = _engine(small, prefill_chunk=8, steps_per_sync=1)
    try:
        f_short = eng.submit(short, 8)
        deadline = time.monotonic() + 60
        while not eng.stats()["active_slots"]:
            assert time.monotonic() < deadline
            time.sleep(0.002)
        f_long = eng.submit(long, 24)
        out_short = f_short.result(120)
        long_done_at_short_finish = f_long.done()
        out_long = f_long.result(120)
        stats = eng.stats()
    finally:
        eng.stop()
    np.testing.assert_array_equal(out_short, _want(small, short, 8))
    np.testing.assert_array_equal(out_long, _want(small, long, 24))
    assert not long_done_at_short_finish
    assert stats["prefill_chunks"] >= 4, stats
