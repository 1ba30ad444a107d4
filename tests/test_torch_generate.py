"""The port's decode mode and generation (``edl_tpu_torch.models``) against
the JAX package's, from the same weights (``models/convert.py``), in f32
on the CPU: decode-mode prefill and teacher-forced decode-step logits
(atol 1e-4, rtol 1e-3), greedy tokens (equal), and the top-k / top-p
surviving set (equal); then the port's own guarantees, as
``tests/test_generate.py`` states them for the JAX package."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edl_tpu.models import transformer as jtf
from edl_tpu.models.generate import _split_layer_params
from edl_tpu.models.generate import generate as jgenerate
from edl_tpu.models.generate import sample_logits as jsample_logits
from edl_tpu_torch.models import transformer as ttf
from edl_tpu_torch.models.convert import params_from_jax
from edl_tpu_torch.models.generate import cache_length, generate, sample_logits

SMALL = dict(vocab_size=256, num_layers=2, embed_dim=64, num_heads=4, mlp_dim=128, max_len=64)
ATOL, RTOL = 1e-4, 1e-3          # f32 logits, port against JAX


def _pair(seed=0, **kw):
    """(JAX config, its params, the port's model) from one JAX init."""
    jc = jtf.TransformerConfig(dtype=jnp.float32, remat=False, attention_impl="dense",
                               **{**SMALL, **kw})
    tc = ttf.TransformerConfig(dtype=torch.float32, remat=False, **{**SMALL, **kw})
    params = jax.jit(jtf.TransformerLM(jc).init)(jax.random.key(seed),
                                                jnp.zeros((1, 4), jnp.int32))["params"]
    tm = ttf.TransformerLM(tc)
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), tc))
    return jc, params, tm


def _prompt(B, P, seed=1, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (B, P)).astype(np.int32)


def _jax_decode_logits(jc, params, ids, extra, cache_len):
    """JAX's decode-mode model: prefill ``ids``, then one step per column
    of ``extra`` (teacher-forced); every call's logits."""
    dcfg = dataclasses.replace(jc, decode=True, max_len=cache_len)
    model = jtf.TransformerLM(dcfg)
    split = _split_layer_params(params, jc.num_layers)
    B, P = ids.shape

    @jax.jit
    def run(p, ids, extra):
        shapes = jax.eval_shape(lambda: model.init(
            jax.random.key(0), ids[:, :1], positions=jnp.zeros((B, 1), jnp.int32)))
        cache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes["cache"])
        logits, mut = model.apply({"params": p, "cache": cache}, ids,
                                  positions=jnp.broadcast_to(jnp.arange(P), (B, P)),
                                  mutable=["cache"])
        steps = []
        cache = mut["cache"]
        for t in range(extra.shape[1]):
            lg, mut = model.apply({"params": p, "cache": cache}, extra[:, t:t + 1],
                                  positions=jnp.full((B, 1), P + t, jnp.int32),
                                  mutable=["cache"])
            cache = mut["cache"]
            steps.append(lg[:, 0])
        return logits, jnp.stack(steps, 1)

    return [np.asarray(a) for a in run(split, jnp.asarray(ids), jnp.asarray(extra))]


@pytest.mark.parametrize("kv_heads", [0, 1, 2], ids=["mha", "mqa", "gqa2"])
def test_decode_logits_match_jax(kv_heads):
    jc, params, tm = _pair(num_kv_heads=kv_heads)
    ids, extra = _prompt(3, 11), _prompt(3, 5, seed=2)
    want_pre, want_steps = _jax_decode_logits(jc, params, ids, extra, 64)
    dm = ttf.decode_model(tm)
    cache = ttf.KVCache.zeros(dm.cfg, 3, 64)
    with torch.inference_mode():
        pre = dm(torch.from_numpy(ids), cache=cache)
        steps = [dm(torch.from_numpy(extra[:, t:t + 1]), positions=cache.index[:, None],
                    cache=cache)[:, 0] for t in range(extra.shape[1])]
    np.testing.assert_allclose(pre.numpy(), want_pre, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(), want_steps, atol=ATOL, rtol=RTOL)
    assert cache.index.tolist() == [16, 16, 16]


@pytest.mark.parametrize("kv_heads", [0, 1, 2], ids=["mha", "mqa", "gqa2"])
def test_greedy_generate_matches_jax(kv_heads):
    jc, params, tm = _pair(seed=3, num_kv_heads=kv_heads)
    prompt = _prompt(3, 9, seed=4)
    want = np.asarray(jax.jit(lambda p, x: jgenerate(jc, p, x, 12, temperature=0))(
        params, jnp.asarray(prompt)))
    got = generate(tm, torch.from_numpy(prompt), 12, temperature=0)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _jax_survivors(logits, temperature, top_k, top_p):
    """The tokens JAX's recipe (``sample_logits``, ``models/generate.py``)
    leaves finite before its categorical draw, by the same operations."""
    scaled = jnp.asarray(logits) / temperature
    if top_k:
        kth = jax.lax.approx_max_k(scaled, top_k, recall_target=0.95)[0][..., -1:]
        scaled = jnp.where(scaled < kth, -jnp.inf, scaled)
    if top_p and top_p < 1.0:
        sorted_ = jnp.sort(scaled, axis=-1)[..., ::-1]
        probs = jax.nn.softmax(sorted_, axis=-1)
        csum = jnp.cumsum(probs, axis=-1) - probs
        cutoff = jnp.min(jnp.where(csum < top_p, sorted_, jnp.inf), axis=-1, keepdims=True)
        scaled = jnp.where(scaled < cutoff, -jnp.inf, scaled)
    return np.isfinite(np.asarray(scaled))


@pytest.mark.parametrize("top_k,top_p", [(5, 0.0), (0, 0.6), (7, 0.8), (1, 0.0), (0, 1e-9)])
def test_top_k_top_p_keep_the_set_jax_keeps(top_k, top_p):
    logits = np.random.default_rng(5).normal(size=(4, 64)).astype(np.float32) * 2
    logits[1, 10:14] = logits[1].max() + 1.0       # a four-way tie at the top
    logits[2, [3, 9, 20]] = np.sort(logits[2])[-6]  # ties at the 6th place
    want = _jax_survivors(logits, 0.8, top_k, top_p)
    got = np.zeros_like(want)
    gen = torch.Generator().manual_seed(0)
    t = torch.from_numpy(logits)
    for _ in range(400):          # every survivor is drawn, no other token is
        toks = sample_logits(t, gen, temperature=0.8, top_k=top_k, top_p=top_p)
        got[np.arange(4), toks.numpy()] = True
    np.testing.assert_array_equal(got, want)
    # JAX's own draws stay inside the same set
    for i in range(20):
        jt = np.asarray(jsample_logits(jnp.asarray(logits), jax.random.key(i), temperature=0.8,
                                       top_k=top_k, top_p=top_p))
        assert want[np.arange(4), jt].all()


def _greedy_full_recompute(tm, prompt, n):
    """Reference path: re-run the whole prefix for every token."""
    ids = torch.from_numpy(prompt).long()
    out = []
    with torch.no_grad():
        for _ in range(n):
            nxt = tm(ids)[:, -1].argmax(-1)
            out.append(nxt)
            ids = torch.cat([ids, nxt[:, None]], dim=1)
    return torch.stack(out, 1).numpy()


@pytest.mark.parametrize("kv_heads", [0, 1, 2], ids=["mha", "mqa", "gqa2"])
def test_cached_greedy_matches_full_recompute(kv_heads):
    _, _, tm = _pair(seed=6, num_kv_heads=kv_heads)
    prompt = _prompt(2, 5, seed=7)
    got = generate(tm, torch.from_numpy(prompt), 8, temperature=0)
    np.testing.assert_array_equal(got.numpy(), _greedy_full_recompute(tm, prompt, 8))


def test_cached_greedy_matches_full_recompute_bf16():
    """The precision recipe (input-dtype products, f32 softmax) keeps the
    bf16 decode token-identical to the full-prefix bf16 forward."""
    tc = ttf.TransformerConfig(dtype=torch.bfloat16, remat=False, attention_impl="dense",
                               **SMALL)
    tm = ttf.TransformerLM(tc, torch.Generator().manual_seed(2))
    prompt = _prompt(2, 6, seed=8)
    got = generate(tm, torch.from_numpy(prompt), 6, temperature=0)
    np.testing.assert_array_equal(got.numpy(), _greedy_full_recompute(tm, prompt, 6))


def test_gqa_cache_is_smaller():
    tc = ttf.TransformerConfig(dtype=torch.float32, num_kv_heads=1, decode=True, **SMALL)
    cache = ttf.KVCache.zeros(tc, 2, tc.max_len)
    assert cache.keys[0].shape == (2, 1, tc.head_dim, tc.max_len)
    assert cache.values[0].shape == (2, 1, tc.max_len, tc.head_dim)
    full = ttf.KVCache.zeros(dataclasses.replace(tc, num_kv_heads=0), 2, tc.max_len)
    assert full.nbytes() == 4 * cache.nbytes()       # 4 heads, one kv head


def test_generate_single_token():
    _, _, tm = _pair()
    prompt = np.asarray([[1, 2, 3]], np.int32)
    got = generate(tm, torch.from_numpy(prompt), 1, temperature=0)
    assert got.shape == (1, 1)
    with torch.no_grad():
        assert int(got[0, 0]) == int(tm(torch.from_numpy(prompt))[0, -1].argmax())


def test_sampling_deterministic_under_generator():
    _, _, tm = _pair()
    prompt = torch.tensor([[4, 5]], dtype=torch.int32)

    def run(seed):
        return generate(tm, prompt, 6, generator=torch.Generator().manual_seed(seed),
                        temperature=0.8, top_k=10).numpy()

    a, b, c = run(3), run(3), run(4)
    np.testing.assert_array_equal(a, b)
    assert a.shape == (1, 6) and (a != c).any()
    assert a.max() < SMALL["vocab_size"] and a.min() >= 0


def test_top_p_tiny_is_greedy_and_one_keeps_all():
    _, _, tm = _pair()
    prompt = torch.tensor([[4, 5, 6]], dtype=torch.int32)
    greedy = generate(tm, prompt, 6, temperature=0)
    nucleus = generate(tm, prompt, 6, generator=torch.Generator().manual_seed(0),
                       temperature=0.7, top_p=1e-9)
    np.testing.assert_array_equal(nucleus.numpy(), greedy.numpy())
    full = [generate(tm, prompt, 6, generator=torch.Generator().manual_seed(1),
                     temperature=0.9, top_p=1.0).numpy() for _ in range(2)]
    np.testing.assert_array_equal(*full)


def test_overflow_and_bad_args_rejected():
    _, _, tm = _pair()
    with pytest.raises(ValueError, match="max_len"):
        generate(tm, torch.zeros((1, 60), dtype=torch.int32), 10)
    with pytest.raises(ValueError, match="max_new_tokens"):
        generate(tm, torch.zeros((1, 4), dtype=torch.int32), 0)
    with pytest.raises(ValueError, match="top_p"):
        generate(tm, torch.zeros((1, 4), dtype=torch.int32), 2, top_p=1.5)
    with pytest.raises(ValueError, match=r"\[B, P\]"):
        generate(tm, torch.zeros(4, dtype=torch.int32), 2)


def test_cache_is_sized_to_the_request():
    assert cache_length(1024, 5, 8) == 128
    assert cache_length(1024, 200, 64) == 384
    assert cache_length(300, 200, 64) == 300


def test_decode_model_casts_weights_once_and_needs_a_cache():
    tc = ttf.TransformerConfig(dtype=torch.bfloat16, remat=False, **SMALL)
    tm = ttf.TransformerLM(tc)
    dm = ttf.decode_model(tm)
    assert dm.cfg.decode and dm.cfg.attention_impl == "dense"
    assert dm.layers[0].attn_qkv.weight.dtype == torch.bfloat16
    assert dm.tok_embed.weight.dtype == torch.bfloat16
    # the norm scales are f32 and shared, the casts equal the per-use ones
    assert dm.final_norm.scale.data_ptr() == tm.final_norm.scale.data_ptr()
    torch.testing.assert_close(dm.lm_head.weight, tm.lm_head.weight.to(torch.bfloat16),
                               atol=0, rtol=0)
    assert ttf.decode_model(dm) is dm
    ids = torch.zeros((1, 3), dtype=torch.int64)
    with pytest.raises(ValueError, match="KVCache"):
        dm(ids)
    with pytest.raises(ValueError, match="KVCache"):
        tm(ids, cache=ttf.KVCache.zeros(tc, 1, 8))


def test_single_token_write_drops_past_the_end():
    """A lane at or past the cache's end writes nothing (the JAX scatter
    drops it); the other lanes write at their own index."""
    tc = ttf.TransformerConfig(dtype=torch.float32, num_kv_heads=2, decode=True, **SMALL)
    B, M, Hk, Dh = 3, 8, 2, tc.head_dim
    ck, cv = torch.zeros(B, Hk, Dh, M), torch.zeros(B, Hk, M, Dh)
    k, v = torch.randn(B, 1, Hk, Dh), torch.randn(B, 1, Hk, Dh)
    ttf._write_cache(tc, ck, cv, k, v, torch.tensor([2, 8, 11], dtype=torch.int32))
    torch.testing.assert_close(ck[0, :, :, 2], k[0, 0])
    torch.testing.assert_close(cv[0, :, 2], v[0, 0])
    assert ck[0].count_nonzero() == Hk * Dh and not ck[1:].any() and not cv[1:].any()


def test_scatter_write_matches_slab_and_drops_past_the_end():
    """``decode_scatter`` writes each example's rows at its own index: at a
    uniform index it equals the contiguous slab, and rows past the end
    are dropped."""
    tc = ttf.TransformerConfig(dtype=torch.float32, decode=True, **SMALL)
    sc = dataclasses.replace(tc, decode_scatter=True)
    B, L, M, Hk, Dh = 2, 4, 10, tc.kv_heads, tc.head_dim
    k, v = torch.randn(B, L, Hk, Dh), torch.randn(B, L, Hk, Dh)
    bufs = [(torch.zeros(B, Hk, Dh, M), torch.zeros(B, Hk, M, Dh)) for _ in range(2)]
    idx = torch.tensor([3, 3], dtype=torch.int32)
    ttf._write_cache(tc, *bufs[0], k, v, idx)
    ttf._write_cache(sc, *bufs[1], k, v, idx)
    for a, b in zip(*bufs):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    ck, cv = torch.zeros(B, Hk, Dh, M), torch.zeros(B, Hk, M, Dh)
    ttf._write_cache(sc, ck, cv, k, v, torch.tensor([0, 8], dtype=torch.int32))
    torch.testing.assert_close(cv[1, :, 8:], v[1, :2].transpose(0, 1))
    torch.testing.assert_close(ck[0, :, :, :4], k[0].permute(1, 2, 0))
    assert not cv[1, :, :8].any() and not ck[0, :, :, 4:].any()
