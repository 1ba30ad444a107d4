"""The port's speculative decoding (``edl_tpu_torch/serving/engine.py``,
``spec_k``) on the CPU in f32, mirroring the spec cases of
``tests/test_serving_fastpath.py``: a self-draft and an adversarial draft
give the non-speculative tokens (the port's ``generate``) and the JAX
engine's tokens and ``spec_*`` counters from the same weights; k = 1, EOS
inside an accepted draft, and the argument checks.  Then the verify
model's ``decode_scatter`` write against the JAX verify model's cache, with
a lane whose kept row lands on the cache's last column beside rows past the
end, and lanes past the end."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edl_tpu.models import transformer as jtf
from edl_tpu.models.generate import _split_layer_params
from edl_tpu.serving import ContinuousBatcher as JaxBatcher
from edl_tpu_torch.models import transformer as ttf
from edl_tpu_torch.models.convert import params_from_jax
from edl_tpu_torch.models.generate import generate
from edl_tpu_torch.models.transformer import KVCache, decode_model
from edl_tpu_torch.serving import ContinuousBatcher

SMALL = dict(vocab_size=97, num_layers=2, embed_dim=32, num_heads=4, mlp_dim=64, max_len=64)
SPEC_KEYS = ("spec_k", "spec_proposed", "spec_accepted", "spec_accept_rate", "spec_rounds")


def _pair(seed):
    jc = jtf.TransformerConfig(dtype=jnp.float32, remat=False, **SMALL)
    tc = ttf.TransformerConfig(dtype=torch.float32, remat=False, **SMALL)
    params = jax.jit(jtf.TransformerLM(jc).init)(jax.random.key(seed),
                                                jnp.zeros((1, 4), jnp.int32))["params"]
    tm = ttf.TransformerLM(tc)
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), tc))
    return jc, params, tm


@pytest.fixture(scope="module")
def small():
    return _pair(0)


@pytest.fixture(scope="module")
def bad_draft():
    return _pair(99)


def _kw(**kw):
    kw.setdefault("slots", 3)
    kw.setdefault("prefill_buckets", (8, 16))
    kw.setdefault("temperature", 0.0)
    kw.setdefault("steps_per_sync", 2)
    kw.setdefault("kv_block", 4)
    kw.setdefault("kv_pool_blocks", 64)
    return kw


def _want(model, p, n):
    return generate(model, torch.from_numpy(p[None]), n, temperature=0).numpy()[0]


def _prompts(seed, lo, hi, n):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 97, (int(m),)).astype(np.int32) for m in rng.integers(lo, hi, (n,))]


def _spec_both(target, draft, prompts, new, k, **kw):
    """Serial requests through the port's and the JAX package's speculative
    engines: equal tokens, each equal to plain greedy decode, and equal
    ``spec_*`` counters; returns the port's stats."""
    jc, params, tm = target
    eng = ContinuousBatcher(tm, **_kw(spec_k=k, draft_model=draft[2], **kw))
    jeng = JaxBatcher(jc, params, **_kw(spec_k=k, draft_cfg=draft[0], draft_params=draft[1],
                                        **kw))
    try:
        got = [eng.generate(p, new, timeout=120) for p in prompts]
        want = [jeng.generate(p, new, timeout=120) for p in prompts]
        stats, jstats = eng.stats(), jeng.stats()
    finally:
        eng.stop()
        jeng.stop()
    for p, a, b in zip(prompts, got, want):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, _want(tm, p, new))
    assert {k_: stats[k_] for k_ in SPEC_KEYS} == {k_: jstats[k_] for k_ in SPEC_KEYS}
    return stats


def test_spec_self_draft_parity_and_accept_rate(small):
    stats = _spec_both(small, small, _prompts(9, 3, 14, 6), 7, 3, prefill_buckets=(16,))
    assert stats["spec_k"] == 3 and stats["spec_proposed"] > 0
    assert stats["spec_accept_rate"] > 0.9, stats


def test_spec_adversarial_draft_still_exact(small, bad_draft):
    stats = _spec_both(small, bad_draft, _prompts(10, 3, 12, 6), 8, 3)
    assert stats["spec_proposed"] > 0
    assert stats["spec_accept_rate"] < 0.9, stats


def test_spec_k1_parity(small):
    _spec_both(small, small, _prompts(12, 3, 10, 4), 7, 1)


def test_spec_with_prefix_reuse_and_chunked_prompts(small):
    """Admissions that never fed the draft (prefix hits, chunked prompts)
    rebuild its cache from the whole prompt; tokens stay exact."""
    rng = np.random.default_rng(13)
    prefix = rng.integers(1, 97, (12,)).astype(np.int32)
    prompts = [np.concatenate([prefix, rng.integers(1, 97, (n,)).astype(np.int32)])
               for n in (3, 6)] + [rng.integers(1, 97, (40,)).astype(np.int32)]
    stats = _spec_both(small, small, prompts, 8, 2, prefill_chunk=16)
    assert stats["spec_accept_rate"] > 0.9, stats


def test_spec_eos_mid_draft_truncates(small):
    tm = small[2]
    p = np.asarray([5, 9, 2], np.int32)
    ref = _want(tm, p, 8)
    eos = int(ref[1])     # greedy's 2nd token: dies mid-burst at k=3
    eng = ContinuousBatcher(tm, **_kw(spec_k=3, draft_model=tm, eos_id=eos,
                                      prefill_buckets=(8,)))
    try:
        out = eng.generate(p, 8, timeout=120)
    finally:
        eng.stop()
    assert list(out) == list(ref[:2])


def test_spec_validation(small):
    tm = small[2]
    with pytest.raises(ValueError, match="draft"):
        ContinuousBatcher(tm, **_kw(spec_k=2))
    with pytest.raises(ValueError, match="greedy"):
        ContinuousBatcher(tm, **_kw(spec_k=2, draft_model=tm, temperature=0.7))
    other = ttf.TransformerLM(ttf.TransformerConfig(dtype=torch.float32, remat=False,
                                                    **{**SMALL, "vocab_size": 50}))
    with pytest.raises(ValueError, match="vocab"):
        ContinuousBatcher(tm, **_kw(spec_k=2, draft_model=other))


def test_decode_scatter_drops_rows_past_the_end_like_jax(small):
    """One verify call of L = 3 tokens on a 16-long cache from lanes at 2
    (inside), 14 (rows at 14 and 15 kept, 16 dropped), 15 (15 kept, two
    dropped), 16 and 37 (all dropped, the latter more than a cache length
    past its end): the cache after it equals the JAX verify
    model's (written rows to rounding; every other position bit for bit)
    and so do the logits, with no host read on the way."""
    jc, params, tm = small
    M, L = 16, 3
    idx = np.asarray([2, M - 2, M - 1, M, 2 * M + 5], np.int32)
    B = len(idx)
    rng = np.random.default_rng(7)
    ids = rng.integers(1, 97, (B, L)).astype(np.int32)
    pos = idx[:, None] + np.arange(L)
    vcfg = dataclasses.replace(jc, decode=True, decode_scatter=True, attention_impl="dense",
                               max_len=M)
    jmodel = jtf.TransformerLM(vcfg)
    jparams = _split_layer_params(params, jc.num_layers)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.key(0), jnp.zeros((B, 1), jnp.int32),
                                                positions=jnp.zeros((B, 1), jnp.int32)))["cache"]
    init = {name: {"cached_key": rng.normal(size=node["cached_key"].shape).astype(np.float32),
                   "cached_value": rng.normal(size=node["cached_value"].shape).astype(np.float32),
                   "cache_index": idx}
            for name, node in shapes.items()}
    jlogits, mut = jax.jit(lambda c: jmodel.apply({"params": jparams, "cache": c}, ids,
                                                  positions=pos, mutable=["cache"]))(init)
    vm = decode_model(tm, decode_scatter=True)
    assert vm.cfg.decode_scatter and decode_model(vm, decode_scatter=True) is vm
    cache = KVCache([torch.from_numpy(init[f"layer_{i}"]["cached_key"].copy())
                     for i in range(jc.num_layers)],
                    [torch.from_numpy(init[f"layer_{i}"]["cached_value"].copy())
                     for i in range(jc.num_layers)], torch.from_numpy(idx.copy()))
    with torch.inference_mode():
        logits = vm(torch.from_numpy(ids), positions=torch.from_numpy(pos), cache=cache)
    written = (pos < M)
    for i in range(jc.num_layers):
        jk = np.asarray(mut["cache"][f"layer_{i}"]["cached_key"])
        jv = np.asarray(mut["cache"][f"layer_{i}"]["cached_value"])
        tk, tv = cache.keys[i].numpy(), cache.values[i].numpy()
        np.testing.assert_allclose(tk, jk, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-5)
        for b in range(B):
            keep = np.ones(M, bool)
            keep[pos[b][written[b]]] = False
            np.testing.assert_array_equal(tk[b][..., keep], init[f"layer_{i}"]["cached_key"][b][
                ..., keep])
            np.testing.assert_array_equal(tv[b][:, keep], init[f"layer_{i}"]["cached_value"][b][
                :, keep])
    # the last kept row of lanes 1 and 2 landed at M-1 beside dropped rows
    assert not np.array_equal(cache.keys[0][1, ..., M - 1].numpy(),
                              init["layer_0"]["cached_key"][1][..., M - 1])
    np.testing.assert_array_equal(cache.index.numpy(), idx + L)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=1e-4, atol=1e-4)
