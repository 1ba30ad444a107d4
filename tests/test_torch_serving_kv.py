"""The port's paged KV pool and prefix reuse (``edl_tpu_torch/serving/
kv_cache.py`` and the paged half of ``serving/engine.py``) on the CPU in
f32, mirroring the non-mesh cases of ``tests/test_serving_kv.py``: each
workload runs through the port's paged engine and the JAX package's from
the same weights, and the tokens, the prefix hits and misses, the skipped
prefill tokens, the evictions and the commit skips must be equal; every
token also equals the port's own ``generate`` of the request alone.
Then a session's chain migrates between the two packages' pools in both
directions, at 12 layers so the blob's layer order (``layer_0, layer_1,
layer_10, ...``) is exercised."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edl_tpu.models import transformer as jtf
from edl_tpu.serving import ContinuousBatcher as JaxBatcher
from edl_tpu.serving.kv_cache import PagedKVCache as JaxPagedKVCache
from edl_tpu_torch.models import transformer as ttf
from edl_tpu_torch.models.convert import params_from_jax
from edl_tpu_torch.models.generate import generate
from edl_tpu_torch.serving import ContinuousBatcher
from edl_tpu_torch.serving.kv_cache import PagedKVCache, layer_names

SMALL = dict(vocab_size=97, num_layers=2, embed_dim=32, num_heads=4, mlp_dim=64, max_len=64)
DEEP = dict(vocab_size=53, num_layers=12, embed_dim=16, num_heads=2, mlp_dim=32, max_len=64)
KV_KEYS = ("kv_prefix_hits", "kv_prefix_misses", "kv_prefill_tokens",
           "kv_prefill_tokens_skipped", "kv_evictions", "kv_commit_skips", "kv_sessions",
           "kv_blocks_used", "kv_blocks_free")


def _pair(widths, seed=0):
    jc = jtf.TransformerConfig(dtype=jnp.float32, remat=False, **widths)
    tc = ttf.TransformerConfig(dtype=torch.float32, remat=False, **widths)
    params = jax.jit(jtf.TransformerLM(jc).init)(jax.random.key(seed),
                                                jnp.zeros((1, 4), jnp.int32))["params"]
    tm = ttf.TransformerLM(tc)
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), tc))
    return jc, params, tm


@pytest.fixture(scope="module")
def small():
    return _pair(SMALL)


def _kw(**kw):
    kw.setdefault("slots", 3)
    kw.setdefault("prefill_buckets", (8, 16))
    kw.setdefault("temperature", 0.0)
    kw.setdefault("steps_per_sync", 4)
    kw.setdefault("kv_block", 4)
    kw.setdefault("kv_pool_blocks", 64)
    return kw


def _want(model, p, n):
    return generate(model, torch.from_numpy(p[None]), n, temperature=0).numpy()[0]


def _serial(engine, turns):
    """``turns``: ``(prompt, max_new, session)``; a prompt may be a callable
    of the outputs so far (a conversation's next turn)."""
    outs = []
    for prompt, n, session in turns:
        p = prompt(outs) if callable(prompt) else prompt
        outs.append((p, engine.submit(p, n, session=session).result(timeout=120)))
    return outs


def _both(pair, turns, **kw):
    """The workload through the port's and the JAX package's paged engines:
    equal tokens and equal pool counters; returns the port's outputs and
    stats."""
    jc, params, tm = pair
    eng, jeng = ContinuousBatcher(tm, **_kw(**kw)), JaxBatcher(jc, params, **_kw(**kw))
    try:
        got, want = _serial(eng, turns), _serial(jeng, turns)
        stats, jstats = eng.stats(), jeng.stats()
    finally:
        eng.stop()
        jeng.stop()
    for (p, a), (q, b) in zip(got, want):
        np.testing.assert_array_equal(p, q)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, _want(tm, p, len(a)))
    if "kv_block" in stats:
        assert {k: stats[k] for k in KV_KEYS} == {k: jstats[k] for k in KV_KEYS}
    return got, stats


def test_paged_engine_greedy_parity_and_prefix_hits(small):
    rng = np.random.default_rng(0)
    prefix = rng.integers(1, 97, (12,)).astype(np.int32)
    prompts = [np.concatenate([prefix, rng.integers(1, 97, (n,)).astype(np.int32)])
               for n in (3, 7, 2, 5)]
    _, stats = _both(small, [(p, 6, None) for p in prompts])
    assert stats["kv_prefix_hits"] >= len(prompts) - 1, stats
    assert stats["kv_prefill_tokens_skipped"] >= (len(prompts) - 1) * 12, stats
    assert stats["kv_blocks_used"] > 0


def test_paged_matches_unpaged_engine(small):
    """One workload (hits, misses, a burst) through a paged and an unpaged
    port engine: equal outputs."""
    tm = small[2]
    rng = np.random.default_rng(1)
    prefix = rng.integers(1, 97, (9,)).astype(np.int32)
    prompts = [np.concatenate([prefix, rng.integers(1, 97, (n,)).astype(np.int32)])
               for n in (2, 6, 3)] + [rng.integers(1, 97, (5,)).astype(np.int32)]
    news = [5, 7, 4, 6]

    def run(**kw):
        eng = ContinuousBatcher(tm, **_kw(**kw))
        try:
            serial = [eng.generate(p, n, timeout=120) for p, n in zip(prompts, news)]
            burst = [f.result(timeout=120) for f in [eng.submit(p, n)
                                                     for p, n in zip(prompts, news)]]
            return serial + burst
        finally:
            eng.stop()

    for a, b in zip(run(), run(kv_block=0)):
        np.testing.assert_array_equal(a, b)


def test_cow_divergence_never_corrupts_sibling_chain(small):
    rng = np.random.default_rng(2)
    shared = rng.integers(1, 97, (10,)).astype(np.int32)
    p_a = np.concatenate([shared, np.asarray([3, 1, 4], np.int32)])
    p_b = np.concatenate([shared, np.asarray([2, 7], np.int32)])
    turns = [(p_a, 8, "a"), (p_b, 8, "b"),
             (lambda o: np.concatenate([o[0][0], o[0][1], np.asarray([5], np.int32)]), 6, "a"),
             (lambda o: np.concatenate([o[1][0], o[1][1], np.asarray([9, 6], np.int32)]), 6,
              "b")]
    _, stats = _both(small, turns)
    assert stats["kv_sessions"] == 2
    assert stats["kv_prefix_hits"] >= 2


def test_near_max_len_reuse_shortens_chain_not_cache(small):
    """52 shared tokens + a suffix whose bucket (16) overhangs the 64 cache:
    the chain shortens to 48 (the slab write clamps its start, which would
    slide the suffix back over the gathered prefix); a later sibling that
    fits exactly reuses the same chain uncorrupted."""
    rng = np.random.default_rng(4)
    p_a = rng.integers(1, 97, (60,)).astype(np.int32)
    p_b = np.concatenate([p_a[:52], rng.integers(1, 97, (9,)).astype(np.int32)])
    p_c = np.concatenate([p_a[:56], rng.integers(1, 97, (2,)).astype(np.int32)])
    _, stats = _both(small, [(p_a, 4, None), (p_b, 3, None), (p_c, 3, None)])
    assert stats["kv_prefix_hits"] >= 2, stats


def test_eviction_under_pressure_keeps_parity(small):
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 97, (int(rng.integers(6, 14)),)).astype(np.int32)
               for _ in range(10)]
    _, stats = _both(small, [(p, 5, None) for p in prompts], slots=2, kv_pool_blocks=9)
    assert stats["kv_evictions"] > 0 or stats["kv_commit_skips"] > 0, stats
    assert stats["kv_blocks_free"] >= 0


def test_reuse_off_still_commits_for_migration(small):
    p = np.asarray([5, 9, 2, 7, 1], np.int32)
    turns = [(p, 6, "s"), (np.concatenate([p, np.asarray([3], np.int32)]), 4, None)]
    _, stats = _both(small, turns, prefix_reuse=False)
    assert stats["kv_prefix_hits"] == 0
    assert stats["kv_sessions"] == 1
    assert stats["kv_blocks_used"] > 0


def test_import_refused_without_paging(small):
    eng = ContinuousBatcher(small[2], **_kw(kv_block=0))
    try:
        with pytest.raises(RuntimeError, match="disabled"):
            eng.import_session("s", [1, 2, 3, 4], {"block": 4, "n": 1, "layers": [],
                                                   "layout": {}}, b"")
    finally:
        eng.stop()


def test_mesh_pool_is_refused(small):
    """A pool over a tp group is driven through the group's command channel
    (tests/test_torch_serving_tp.py): without one it is refused; over a mesh
    whose tp dim is 1 it is the plain pool."""
    from tests.helpers.torch_world_of_one import mesh_of_one

    class _TpOf2:                 # the two calls TP.of makes of a DeviceMesh
        def __getitem__(self, axis):
            return self

        def size(self):
            return 2

        def get_group(self, axis):
            return None

        def get_local_rank(self, axis):
            return 0

    cfg = small[2].cfg
    with pytest.raises(ValueError, match="channel"):
        PagedKVCache(cfg, 64, 4, 8, 4, mesh=_TpOf2())
    with mesh_of_one() as mesh:
        pool = PagedKVCache(cfg, 64, 4, 8, 4, mesh=mesh)
    assert pool.k[0].shape == (8, cfg.kv_heads, cfg.head_dim, 4)


def _turn1(engine, p1):
    out1 = engine.submit(p1, 8, session="s").result(timeout=120)
    assert engine.drain(timeout=30)
    exported = engine.export_sessions()
    assert [e[0] for e in exported] == ["s"]
    return out1, exported[0][1:]


def _resume(engine, tokens, meta, blob, p2):
    try:
        assert engine.import_session("s", tokens, meta, blob) > 0
        assert engine.stats()["kv_sessions"] == 1
        out2 = engine.generate(p2, 6, timeout=120)
        return out2, engine.stats()
    finally:
        engine.stop()


def test_export_import_roundtrip_resumes_warm(small):
    """The migration primitive on the port alone: a pinned chain exported
    after drain() imports into a second engine, whose next turn skips the
    prefix."""
    tm = small[2]
    p1 = np.asarray([7, 11, 13, 5, 9, 2, 8], np.int32)
    eng = ContinuousBatcher(tm, **_kw())
    out1, (tokens, meta, blob) = _turn1(eng, p1)
    np.testing.assert_array_equal(out1, _want(tm, p1, 8))
    conv = np.concatenate([p1, out1])
    assert tokens == list(map(int, conv[:len(tokens)]))
    assert meta["layers"] == ["layer_0", "layer_1"] and meta["layout"]["layer_0"] == [
        4, 8, "float32"]
    p2 = np.concatenate([conv, np.asarray([4, 1], np.int32)])
    out2, stats = _resume(ContinuousBatcher(tm, **_kw()), tokens, meta, blob, p2)
    np.testing.assert_array_equal(out2, _want(tm, p2, 6))
    assert stats["kv_prefix_hits"] == 1 and stats["kv_prefill_tokens_skipped"] == len(tokens)


@pytest.fixture(scope="module")
def deep():
    return _pair(DEEP, seed=3)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_cross_package_migration(deep, direction):
    """A chain exported by one package's pool imports into the other's: the
    same tokens and meta either way, and a blob of the same layout whose
    f32 values agree to rounding (XLA's and torch's products differ in the
    last bits); the session's next turn there skips its prefix and gives
    the tokens of ``generate``."""
    jc, params, tm = deep
    rng = np.random.default_rng(5)
    p1 = rng.integers(1, 53, (13,)).astype(np.int32)
    port_src, jax_src = ContinuousBatcher(tm, **_kw()), JaxBatcher(jc, params, **_kw())
    out1, (tokens, meta, blob) = _turn1(port_src, p1)
    jout1, (jtokens, jmeta, jblob) = _turn1(jax_src, p1)
    np.testing.assert_array_equal(out1, jout1)
    assert tokens == jtokens and meta == jmeta and len(blob) == len(jblob)
    np.testing.assert_allclose(np.frombuffer(blob, np.float32), np.frombuffer(jblob, np.float32),
                               rtol=1e-5, atol=1e-5)
    assert meta["layers"] == layer_names(12) and meta["layers"][2] == "layer_10"
    p2 = np.concatenate([p1, out1, rng.integers(1, 53, (3,)).astype(np.int32)])
    if direction == "jax_to_port":
        dest = ContinuousBatcher(tm, **_kw())
        tokens, meta, blob = jtokens, jmeta, jblob
    else:
        dest = JaxBatcher(jc, params, **_kw())
    out2, stats = _resume(dest, tokens, meta, blob, p2)
    np.testing.assert_array_equal(out2, _want(tm, p2, 6))
    assert stats["kv_prefix_hits"] == 1 and stats["kv_prefill_tokens_skipped"] == len(tokens)


def _bf16_pools(n_blocks=16, block=4, max_len=64):
    """The two packages' pools over the DEEP widths in bf16 (the format a
    card migrates), holding the same seeded values: the port's as torch
    bf16, the JAX package's as the same 16-bit words."""
    tc = ttf.TransformerConfig(dtype=torch.bfloat16, **DEEP)
    hk, d = tc.kv_heads, tc.head_dim
    port = PagedKVCache(tc, max_len, block, n_blocks, 4)
    slab = {"cached_key": jax.ShapeDtypeStruct((2, hk, d, max_len), jnp.bfloat16),
            "cached_value": jax.ShapeDtypeStruct((2, hk, max_len, d), jnp.bfloat16),
            "cache_index": jax.ShapeDtypeStruct((2,), jnp.int32)}
    jpool = JaxPagedKVCache({name: slab for name in layer_names(DEEP["num_layers"])},
                            block, n_blocks, 4)
    rng = np.random.default_rng(7)
    for t in port.k + port.v:
        t.copy_(torch.from_numpy(rng.standard_normal(t.shape, np.float32)).to(torch.bfloat16))
    jpool.pool = {f"layer_{i}": {"k": jnp.asarray(_words(k).view(jnp.bfloat16)),
                                 "v": jnp.asarray(_words(v).view(jnp.bfloat16))}
                  for i, (k, v) in enumerate(zip(port.k, port.v))}
    return port, jpool


def _words(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy()


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_cross_package_migration_bf16(direction):
    """The bf16 blob (layer order ``layer_0, layer_1, layer_10, ...``, the
    ``"bfloat16"`` name, 16-bit words) is byte for byte the JAX package's:
    the same chain exported by both pools gives equal meta and equal
    bytes, and the other package's pool imports it bit for bit."""
    src, jsrc = _bf16_pools()
    toks = list(range(1, 14))                     # 3 full blocks of 4
    for pool in (src, jsrc):
        _, ids, tail = pool.commit(toks)
        pool.pin_session("s", tail)
        assert [nd.block_id for nd in pool.chain_of("s")] == ids == [1, 2, 3]
    meta, blob = src.export_chain(src.chain_of("s"))
    jmeta, jblob = jsrc.export_chain(jsrc.chain_of("s"))
    assert meta == jmeta and meta["layout"]["layer_10"] == [2, 8, "bfloat16"]
    assert blob == jblob
    dst, jdst = _bf16_pools()
    if direction == "jax_to_port":
        assert dst.import_chain("s", toks, jmeta, jblob) == 3
        got = [nd.block_id for nd in dst.chain_of("s")]
        for a, b in zip(src.k + src.v, dst.k + dst.v):
            np.testing.assert_array_equal(_words(a[ids]), _words(b[got]))
    else:
        assert jdst.import_chain("s", toks, meta, blob) == 3
        got = [nd.block_id for nd in jdst.chain_of("s")]
        for i, (k, v) in enumerate(zip(src.k, src.v)):
            for a, ax in ((k, "k"), (v, "v")):
                np.testing.assert_array_equal(
                    _words(a[ids]), np.asarray(jdst.pool[f"layer_{i}"][ax])[got].view(np.int16))


def test_bf16_blob_round_trips_as_16_bit_words():
    """A bf16 pool exports its blocks as raw 16-bit words named
    ``"bfloat16"`` (numpy has no bf16), and imports them back bit for bit."""
    cfg = ttf.TransformerConfig(dtype=torch.bfloat16, **SMALL)
    src = PagedKVCache(cfg, 64, 4, 8, 4)
    g = torch.Generator().manual_seed(0)
    for t in src.k + src.v:
        t.copy_(torch.randn(t.shape, generator=g).to(torch.bfloat16))
    toks = list(range(1, 10))
    _, ids, tail = src.commit(toks)
    src.pin_session("s", tail)
    meta, blob = src.export_chain(src.chain_of("s"))
    assert meta["layout"]["layer_0"] == [4, 8, "bfloat16"]
    assert len(blob) == 2 * 2 * len(ids) * 4 * 8 * 4 * 2
    dst = PagedKVCache(cfg, 64, 4, 8, 4)
    assert dst.import_chain("s", toks, meta, blob) == len(ids)
    got = [nd.block_id for nd in dst.chain_of("s")]
    for a, b in zip(src.k + src.v, dst.k + dst.v):
        assert torch.equal(a[ids], b[got])
