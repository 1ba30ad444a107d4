"""The port's attention against the JAX package's, on the CPU.

The plain versions are held against ``edl_tpu``'s ``dense_attention`` and
against the real splash Pallas kernel run in interpret mode (built as
``edl_tpu/ops/attention.py`` builds it, with q pre-scaled as ``_splash``
does).  The CUDA kernels themselves are checked on the card by
``chip_smoke.py``; here a wrapper given CPU tensors computes its plain
version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edl_tpu.ops import attention as jattn
from edl_tpu_torch.ops import attention as tattn


def _qkv(shape_q, shape_kv, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=shape_q).astype(np.float32)
    k = rng.normal(size=shape_kv).astype(np.float32)
    v = rng.normal(size=shape_kv).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("case", ["causal", "noncausal", "gqa_causal", "mask", "cross_len_causal"])
def test_dense_matches_jax(case):
    B, L, H, D = 2, 24, 4, 16
    Lk, Hk, mask = L, H, None
    causal = case in ("causal", "gqa_causal", "cross_len_causal")
    if case == "gqa_causal":
        Hk = 2
    if case == "cross_len_causal":
        Lk = 40
    if case == "mask":
        mask = np.random.default_rng(9).random((B, 1, L, Lk)) < 0.7
        mask[..., 0] = True  # no fully masked row
    q, k, v = _qkv((B, L, H, D), (B, Lk, Hk, D), seed=len(case))
    want = jattn.dense_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 causal=causal, mask=None if mask is None else jnp.asarray(mask))
    got = tattn.dense_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                causal=causal,
                                mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def _splash_interpret(L, H, blk, save_residuals=False):
    """The splash kernel exactly as edl_tpu/ops/attention.py:_splash_kernel
    builds it, but in Pallas interpret mode (``save_residuals``: also
    returning its f32 logsumexp)."""
    from jax.experimental.pallas.ops.tpu.splash_attention import (
        splash_attention_kernel as sk, splash_attention_mask as sm,
    )
    mask = sm.MultiHeadMask(masks=[sm.CausalMask(shape=(L, L)) for _ in range(H)])
    sizes = sk.BlockSizes(
        block_q=blk, block_kv=blk, block_kv_compute=blk,
        block_q_dkv=blk, block_kv_dkv=blk, block_kv_dkv_compute=blk,
        block_q_dq=blk, block_kv_dq=blk)
    return sk.make_splash_mha(mask=mask, head_shards=1, q_seq_shards=1,
                              block_sizes=sizes, interpret=True, save_residuals=save_residuals)


def test_plain_matches_splash_interpret():
    _check_plain_against_splash_interpret(D=64)


def test_plain_matches_splash_interpret_at_256():
    """D = 256, a head dim whose Hopper dK/dV splits dK and dV between its
    consumer warpgroups."""
    _check_plain_against_splash_interpret(D=256)


def test_plain_matches_splash_interpret_above_256():
    """D = 320, a head dim the splash kernel tiles in 128-lane repeats and
    the port's wide kernels take."""
    _check_plain_against_splash_interpret(D=320)


def test_plain_matches_splash_interpret_at_384():
    """D = 384, the d384 workload's head dim, whose forward is the Hopper
    kernel with the output columns split across its consumers."""
    _check_plain_against_splash_interpret(D=384)


@pytest.mark.parametrize("D", [640, 768])
def test_plain_matches_splash_interpret_above_512(D):
    """Head dims above 512, whose forward is the Hopper kernel on chunks of
    the output columns (D = 640: two chunks of 320; 768: two of 384), and
    whose dQ and dK/dV run on thread block clusters that split D (three
    blocks at both): forward, logsumexp and all three gradients against the
    splash kernel in interpret mode, as at the head dims above."""
    _check_plain_against_splash_interpret(D)


def _check_plain_against_splash_interpret(D):
    B, L, H, blk = 1, 256, 2, 128
    scale = D ** -0.5
    q, k, v = _qkv((B, L, H, D), (B, L, H, D), seed=3)
    do = np.random.default_rng(4).normal(size=(B, L, H, D)).astype(np.float32)
    kernel = _splash_interpret(L, H, blk)

    def splash(q, k, v):
        # as _splash: [B, L, H, D] -> per-example [H, L, D], q pre-scaled
        qt, kt, vt = (x.swapaxes(1, 2) for x in (q, k, v))
        return jax.vmap(kernel)((qt * scale).astype(q.dtype), kt, vt).swapaxes(1, 2)

    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    want, vjp = jax.vjp(splash, jq, jk, jv)
    want_grads = vjp(jdo)

    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    got = tattn.SplashAttention.apply(tq, tk, tv, scale)
    got_grads = torch.autograd.grad(got, (tq, tk, tv), torch.from_numpy(do))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=0)
    for g, w in zip(got_grads, want_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=0)

    # the plain versions alone: the forward, its logsumexp, and the
    # backward's dQ (with delta), then dK/dV from that delta
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = tattn.attention_fwd_plain(tq, tk, tv, scale)
    np.testing.assert_allclose(o.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    dq, delta = tattn.attention_bwd_dq_plain(tq, tk, tv, o, tdo, lse, scale)
    dk, dv = tattn.attention_bwd_dkdv_plain(tq, tk, tv, tdo, lse, delta, scale)
    for g, w in zip((dq, dk, dv), want_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=0)
    s = np.einsum("bqhd,bkhd->bhqk", q, k).astype(np.float64) * scale
    s = np.where(np.tril(np.ones((L, L), bool)), s, -np.inf)
    lse_ref = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) + s.max(-1)
    np.testing.assert_allclose(lse.numpy(), lse_ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("D", [128, 192])
def test_bf16_splash_scales_q_as_jax(D):
    """bf16 splash against the splash kernel in interpret mode, q pre-scaled
    as ``_splash`` scales it: in bf16, by the scale rounded to bf16 (at D =
    128, 0.08837891 for 0.08838835).  The f32 logsumexp (the kernel's
    ``save_residuals`` output) within 1e-5: both sum the same exact bf16
    products in f32; scaling the f32 scores instead of q misses by more
    than 1e-4.
    The bf16 output within 2^-7 and the gradients within 2^-6, absolute
    and relative: a bf16 ulp or two, from rounding P and the products in
    another order; dq is the pre-scaled q's gradient times the bf16 scale,
    rounded to bf16, as the VJP of the JAX multiply."""
    B, L, H, blk = 1, 256, 2, 128
    scale = D ** -0.5
    q, k, v = _qkv((B, L, H, D), (B, L, H, D), seed=21)
    do = np.random.default_rng(22).normal(size=(B, L, H, D)).astype(np.float32)
    jq, jk, jv, jdo = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, do))
    with_lse = _splash_interpret(L, H, blk, save_residuals=True)
    kernel = _splash_interpret(L, H, blk)

    def prescaled(q):   # as _splash: [B, L, H, D] -> [B, H, L, D], then q * scale
        return (q.swapaxes(1, 2) * scale).astype(q.dtype)

    _, (want_lse,) = jax.jit(lambda q, k, v: jax.vmap(with_lse)(
        prescaled(q), k.swapaxes(1, 2), v.swapaxes(1, 2)))(jq, jk, jv)
    want, vjp = jax.vjp(lambda q, k, v: jax.vmap(kernel)(
        prescaled(q), k.swapaxes(1, 2), v.swapaxes(1, 2)).swapaxes(1, 2), jq, jk, jv)
    want_grads = vjp(jdo)

    def f32(x):
        return np.asarray(jnp.asarray(x, jnp.float32))

    tq, tk, tv, tdo = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v, do))
    _, lse, q_s, s_b = tattn.splash_fwd(tq, tk, tv, scale)
    assert s_b == float(jnp.asarray(scale, jnp.bfloat16)) and q_s.dtype == torch.bfloat16
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=1e-5, rtol=0)
    _, lse_scores_scaled = tattn.attention_fwd_plain(tq, tk, tv, scale)
    assert np.abs(lse_scores_scaled.numpy() - np.asarray(want_lse)).max() > 1e-4
    aq, ak, av = (t.clone().requires_grad_() for t in (tq, tk, tv))
    got = tattn.SplashAttention.apply(aq, ak, av, scale)
    got_grads = torch.autograd.grad(got, (aq, ak, av), tdo)
    np.testing.assert_allclose(got.detach().float().numpy(), f32(want), atol=2**-7, rtol=2**-7)
    for g, w in zip(got_grads, want_grads):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(), f32(w), atol=2**-6, rtol=2**-6)


@pytest.mark.parametrize("shape", [(2, 37, 3, 64), (1, 70, 2, 128)])
def test_kernel_parts_compose_to_dense_grads(shape):
    """The plain forward and the plain backward parts (the kernels'
    reference functions: dQ with delta, then dK/dV) give dense attention's
    autograd gradients, at ragged lengths; dQ's delta is rowsum(dO * O)."""
    rng = np.random.default_rng(sum(shape))
    q, k, v, do = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
                   for _ in range(4))
    scale = shape[-1] ** -0.5
    o, lse = tattn.attention_fwd(q, k, v, scale)
    dq, delta = tattn.attention_bwd_dq(q, k, v, o, do, lse, scale)
    torch.testing.assert_close(delta, tattn.attention_bwd_delta_plain(o, do), atol=0, rtol=0)
    dk, dv = tattn.attention_bwd_dkdv(q, k, v, do, lse, delta, scale)
    qa, ka, va = (t.clone().requires_grad_() for t in (q, k, v))
    ref = tattn.dense_attention(qa, ka, va, causal=True)
    rq, rk, rv = torch.autograd.grad(ref, (qa, ka, va), do)
    torch.testing.assert_close(o, ref.detach(), atol=1e-5, rtol=0)
    for got, want in ((dq, rq), (dk, rk), (dv, rv)):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


def test_auto_on_cpu_is_dense_and_launches_nothing():
    q, k, v = (torch.from_numpy(x) for x in _qkv((2, 128, 2, 64), (2, 128, 2, 64), seed=5))
    tattn.reset_launch_counts()
    got = tattn.dot_product_attention(q, k, v, causal=True)
    torch.testing.assert_close(got, tattn.dense_attention(q, k, v, causal=True),
                               atol=0, rtol=0)
    assert set(tattn.launch_counts().values()) == {0}


def test_splash_impl_on_cpu_runs_the_plain_versions():
    """impl='splash' on CPU tensors goes through the kernel wrappers, which
    compute their plain versions (no launch), with GQA expanded first."""
    q, k, v = (torch.from_numpy(x) for x in _qkv((2, 64, 4, 64), (2, 64, 2, 64), seed=6))
    tattn.reset_launch_counts()
    got = tattn.dot_product_attention(q, k, v, causal=True, impl="splash")
    want = tattn.dense_attention(q, k, v, causal=True)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    assert set(tattn.launch_counts().values()) == {0}


def test_impl_names_rejected_like_jax():
    q = torch.zeros(1, 128, 2, 64)
    with pytest.raises(ValueError, match="unknown attention impl"):
        tattn.dot_product_attention(q, q, q, impl="bogus")
    with pytest.raises(ValueError, match="unknown attention impl"):
        jattn.dot_product_attention(jnp.zeros((1, 128, 2, 64)), jnp.zeros((1, 128, 2, 64)),
                                    jnp.zeros((1, 128, 2, 64)), impl="bogus")
    with pytest.raises(ValueError, match="causal-only"):
        tattn.dot_product_attention(q, q, q, causal=False, impl="splash")
    # flash runs (its plain versions on CPU tensors), as the JAX package's does
    flash = tattn.dot_product_attention(q, q, q, impl="flash")
    torch.testing.assert_close(flash, tattn.dense_attention(q, q, q), atol=1e-6, rtol=0)
    # ring runs (ops/ring.py); with no sp group it is a ring of one rank,
    # the JAX ring over an sp axis of 1
    ring = tattn.dot_product_attention(q, q, q, causal=True, impl="ring")
    torch.testing.assert_close(ring, tattn.dense_attention(q, q, q, causal=True),
                               atol=1e-6, rtol=0)


def test_kernel_gate():
    """The shapes and types the CUDA kernels take (checked without a card)."""
    bf = torch.bfloat16
    ok = torch.zeros(1, 200, 2, 64, dtype=bf)
    assert tattn._splash_ok(ok, ok, causal=True)          # ragged L is fine
    assert not tattn._splash_ok(ok, ok, causal=False)
    assert not tattn._splash_ok(ok.float(), ok.float(), causal=True)
    d32 = torch.zeros(1, 128, 2, 32, dtype=bf)
    assert not tattn._splash_ok(d32, d32, causal=True)
    assert not tattn._splash_ok(ok, torch.zeros(1, 100, 2, 64, dtype=bf), causal=True)


@pytest.mark.parametrize("path", ["splash", "flash"])
def test_backward_runs_dq_then_dkdv_with_dqs_delta(path, monkeypatch):
    """The autograd backward launches two kernels: dQ, which computes
    delta, then dK/dV, which receives that same delta; no other wrapper is
    called.  Recorded through the wrappers, on CPU tensors.
    The splash path's kernels ran on the pre-scaled q with scale 1, and its
    dq is theirs times the scale (0.125, exact in f32)."""
    calls = []
    names = (("attention_bwd_dq", "attention_bwd_dkdv") if path == "splash"
             else ("flash_bwd_dq", "flash_bwd_dkdv"))

    def recording(name):
        inner = getattr(tattn, name)

        def wrapper(*args):
            out = inner(*args)
            calls.append((name, args, out))
            return out
        return wrapper

    for name in (w.__name__ for w in tattn.KERNEL_WRAPPERS):
        monkeypatch.setattr(tattn, name, recording(name))
    q, k, v = (torch.from_numpy(x).requires_grad_()
               for x in _qkv((1, 40, 2, 64), (1, 40, 2, 64), seed=12))
    do = torch.from_numpy(np.random.default_rng(13).normal(size=(1, 40, 2, 64)).astype(np.float32))
    if path == "splash":
        y = tattn.SplashAttention.apply(q, k, v, 0.125)
    else:
        y = tattn.FlashAttention.apply(q, k, v, 0.125, True)
    calls.clear()   # the forward's
    grads = torch.autograd.grad(y, (q, k, v), do)
    assert [c[0] for c in calls] == list(names)
    (_, dq_args, (dq, delta)), (_, dkdv_args, (dk, dv)) = calls
    assert dkdv_args[5] is delta
    for got, want in zip(grads[1:], (dk, dv)):
        assert got is want
    if path == "flash":
        assert grads[0] is dq
    else:
        assert dq_args[-1] == 1.0 and dkdv_args[-1] == 1.0
        torch.testing.assert_close(dq_args[0], q.detach() * 0.125, atol=0, rtol=0)
        torch.testing.assert_close(grads[0], dq * 0.125, atol=0, rtol=0)
