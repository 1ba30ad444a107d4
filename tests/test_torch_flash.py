"""The port's flash path against the JAX package's, on the CPU.

The reference is the real Pallas flash kernel, reached through
``edl_tpu/ops/attention.py`` unchanged (``_flash`` and
``dot_product_attention(impl="flash")``) and run in Pallas's TPU interpret
mode.  Held against it: the plain versions of the three flash kernels
(their wrappers compute them for CPU tensors), the ``impl="flash"``
dispatch with grouped-query attention, and the whole LM with
``attention_impl="flash"``.  The kernel masks causal attention top-left
(key j is visible to query i iff j <= i), which for ``Lq != Lk`` is another
function than dense's bottom-right mask; the routing test checks that
``impl="auto"`` on CUDA picks the same function as the JAX package on its
accelerator.  The CUDA kernels themselves are checked on the card by
``chip_smoke.py``.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from edl_tpu.models import transformer as jtf
from edl_tpu.ops import attention as jattn
from edl_tpu_torch.models import transformer as ttf
from edl_tpu_torch.models.convert import params_from_jax, params_to_jax
from edl_tpu_torch.ops import attention as tattn

ATOL = 1e-4   # f32 throughout; the kernel sums in another order than the plain version


def _arrays(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def _pallas_flash_vjp(fn, args, cotangent):
    """``fn(*args)`` and its vjp at ``cotangent``, in Pallas interpret mode."""
    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(fn, *map(jnp.asarray, args))
        grads = vjp(jnp.asarray(cotangent))
        return np.asarray(out), [np.asarray(g) for g in grads]


# (causal, Lq, Lk, D): the two causal cross-length cases pin top-left
# alignment, and Lq < Lk shows that keys no query sees get zero gradients;
# D = 192 and 256 are the head dims of the Hopper dK/dV whose consumers
# split dK and dV, D = 320 one above 256 (the wide kernels' range); D = 192
# and 320 at Lk = 128, where the Pallas kernel takes a D that is not a
# multiple of 128; D = 384 cross-length pins the function of the Hopper
# dK/dV whose blocks split the output columns (keys no query sees too)
PALLAS_CASES = [(False, 128, 128, 64), (False, 128, 256, 128),
                (True, 128, 256, 64), (True, 256, 128, 64),
                (True, 128, 256, 128), (True, 256, 128, 128),
                (True, 128, 256, 256), (False, 256, 128, 256),
                (False, 128, 128, 192), (True, 256, 128, 192),
                (False, 128, 128, 320), (True, 128, 128, 320),
                (True, 128, 256, 384), (True, 128, 256, 768)]


@pytest.mark.parametrize("causal,lq,lk,d", PALLAS_CASES,
                         ids=[f"{'causal' if c else 'noncausal'}-{a}x{b}-d{d}"
                              for c, a, b, d in PALLAS_CASES])
def test_plain_matches_pallas_flash_interpret(causal, lq, lk, d):
    B, H = 1, 2
    scale = d ** -0.5
    q, k, v, do = _arrays([(B, lq, H, d), (B, lk, H, d), (B, lk, H, d), (B, lq, H, d)],
                          seed=lq + lk + d + causal)
    want, (wq, wk, wv) = _pallas_flash_vjp(
        lambda q, k, v: jattn._flash(q, k, v, causal, scale), (q, k, v), do)

    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = tattn.flash_fwd_plain(tq, tk, tv, scale, causal)
    dq, delta = tattn.flash_bwd_dq_plain(tq, tk, tv, o, tdo, lse, scale, causal)
    dk, dv = tattn.flash_bwd_dkdv_plain(tq, tk, tv, tdo, lse, delta, scale, causal)
    np.testing.assert_allclose(o.numpy(), want, atol=ATOL, rtol=0)
    for got, ref in ((dq, wq), (dk, wk), (dv, wv)):
        np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)

    # the logsumexp against a float64 top-left reference
    s = np.einsum("bqhd,bkhd->bhqk", q, k).astype(np.float64) * scale
    if causal:
        s = np.where(np.tril(np.ones((lq, lk), bool)), s, -np.inf)
    lse_ref = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) + s.max(-1)
    np.testing.assert_allclose(lse.numpy(), lse_ref, atol=1e-5, rtol=0)

    # the autograd function (CPU tensors: the wrappers' plain versions)
    aq, ak, av = (t.clone().requires_grad_() for t in (tq, tk, tv))
    tattn.reset_launch_counts()
    y = tattn.FlashAttention.apply(aq, ak, av, scale, causal)
    grads = torch.autograd.grad(y, (aq, ak, av), tdo)
    assert set(tattn.launch_counts().values()) == {0}
    np.testing.assert_allclose(y.detach().numpy(), want, atol=ATOL, rtol=0)
    for got, ref in zip(grads, (wq, wk, wv)):
        np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)

    if causal and lk > lq:
        # keys j >= Lq are seen by no query: exactly zero in both packages
        for t in (wk, wv, dk.numpy(), dv.numpy()):
            assert not np.any(t[:, lq:])
    if causal and lq != lk:
        # and the function is not dense's bottom-right causal attention
        # (whose first Lq - Lk rows, for Lq > Lk, see no key at all)
        dense = tattn.dense_attention(tq, tk, tv, causal=True)
        assert not torch.allclose(dense, o, atol=0.1)


def test_flash_dispatch_with_gqa_matches_jax():
    """``impl="flash"`` with 2 K/V heads for 4 query heads: both packages
    expand the groups and run the flash kernel (causal, Lq < Lk)."""
    B, Lq, Lk, H, Hk, D = 1, 128, 256, 4, 2, 64
    q, k, v, do = _arrays([(B, Lq, H, D), (B, Lk, Hk, D), (B, Lk, Hk, D), (B, Lq, H, D)],
                          seed=11)
    want, wgrads = _pallas_flash_vjp(
        lambda q, k, v: jattn.dot_product_attention(q, k, v, causal=True, impl="flash"),
        (q, k, v), do)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    got = tattn.dot_product_attention(tq, tk, tv, causal=True, impl="flash")
    grads = torch.autograd.grad(got, (tq, tk, tv), torch.from_numpy(do))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL, rtol=0)
    for g, w in zip(grads, wgrads):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL, rtol=0)
    with pytest.raises(ValueError, match="takes no mask"):
        tattn.dot_product_attention(tq, tk, tv, impl="flash",
                                    mask=torch.ones(Lq, Lk, dtype=torch.bool))


def test_lm_with_flash_attention_matches_jax():
    """The 2-layer LM with ``attention_impl="flash"`` in both packages, from
    the same weights: logits, loss and every parameter gradient (f32).  The
    JAX model runs unscanned and without remat: under interpret mode,
    ``nn.scan`` with remat cannot partial-evaluate the kernel's effects."""
    small = dict(vocab_size=257, num_layers=2, embed_dim=128, num_heads=2, mlp_dim=256,
                 max_len=128)
    jc = jtf.TransformerConfig(dtype=jnp.float32, remat=False, scan_layers=False,
                               attention_impl="flash", **small)
    tc = ttf.TransformerConfig(dtype=torch.float32, remat=False, attention_impl="flash",
                               **small)
    ids = np.random.default_rng(3).integers(0, 257, (2, 129)).astype(np.int32)
    x, y = jnp.asarray(ids[:, :-1]), jnp.asarray(ids[:, 1:])
    jm = jtf.TransformerLM(jc)
    with pltpu.force_tpu_interpret_mode():
        params = jax.jit(jm.init)(jax.random.key(0), x)["params"]
        jlogits = np.asarray(jax.jit(lambda p: jm.apply({"params": p}, x))(params))
        jloss, jgrads = jax.jit(jax.value_and_grad(
            lambda p: jtf.lm_loss(jm.apply({"params": p}, x), y)))(params)

    tm = ttf.TransformerLM(tc)
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), tc))
    tattn.reset_launch_counts()
    logits = tm(torch.from_numpy(ids[:, :-1]))
    loss = ttf.lm_loss(logits, torch.from_numpy(ids[:, 1:]))
    loss.backward()
    assert set(tattn.launch_counts().values()) == {0}   # CPU: the plain versions
    np.testing.assert_allclose(logits.detach().numpy(), jlogits, atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(loss.item(), float(jloss), atol=1e-5, rtol=1e-5)
    tgrads = params_to_jax({n: p.grad for n, p in tm.named_parameters()}, tc)
    jax.tree.map(lambda g_t, g_j: np.testing.assert_allclose(
        np.asarray(g_t, np.float32), np.asarray(g_j), atol=1e-4, rtol=1e-3), tgrads, jgrads)


@pytest.mark.parametrize("shape_q,lk", [((2, 37, 3, 64), 70), ((1, 70, 2, 128), 37)])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_parts_compose_to_dense_grads(shape_q, lk, causal):
    """The plain flash forward and backward parts (the kernels' reference
    functions) give the gradients of dense attention under the top-left
    mask, at ragged lengths."""
    B, Lq, H, D = shape_q
    q, k, v, do = (torch.from_numpy(a) for a in _arrays(
        [shape_q, (B, lk, H, D), (B, lk, H, D), shape_q], seed=Lq + lk))
    scale = D ** -0.5
    o, lse = tattn.flash_fwd(q, k, v, scale, causal)
    dq, delta = tattn.flash_bwd_dq(q, k, v, o, do, lse, scale, causal)
    torch.testing.assert_close(delta, tattn.attention_bwd_delta_plain(o, do), atol=0, rtol=0)
    dk, dv = tattn.flash_bwd_dkdv(q, k, v, do, lse, delta, scale, causal)
    qa, ka, va = (t.clone().requires_grad_() for t in (q, k, v))
    keep = torch.ones(Lq, lk, dtype=torch.bool).tril() if causal else None
    ref = tattn.dense_attention(qa, ka, va, mask=keep)
    rq, rk, rv = torch.autograd.grad(ref, (qa, ka, va), do)
    torch.testing.assert_close(o, ref.detach(), atol=1e-5, rtol=0)
    for got, want in ((dq, rq), (dk, rk), (dv, rv)):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


# -- routing -------------------------------------------------------------------

def _visible(route, causal, lq, lk):
    """The [Lq, Lk] key visibility of the function a route computes (a
    user mask is applied by dense alone, the same in both packages)."""
    ones = np.ones((lq, lk), bool)
    if not causal:
        return ones
    if route in ("splash", "flash"):
        return np.tril(ones)              # top-left: j <= i
    return np.tril(ones, lk - lq)         # dense: bottom-right


def _jax_tpu_route(lq, lk, d, causal, has_mask):
    """The JAX package's ``impl="auto"`` choice on its accelerator, from its
    own gates (``edl_tpu/ops/attention.py``)."""
    q = jax.ShapeDtypeStruct((1, lq, 2, d), jnp.float32)
    k = jax.ShapeDtypeStruct((1, lk, 2, d), jnp.float32)
    if not has_mask and jattn._splash_ok(q, k, causal):
        return "splash"
    if not has_mask and jattn._flash_ok(q, k):
        return "flash"
    return "dense"


@pytest.mark.parametrize("d", [32, 64, 128, 192, 256, 320, 384, 512, 640, 768])
def test_auto_route_on_cuda_computes_what_jax_computes(d):
    """Over causal/non-causal, Lq/Lk in {100, 128, 256}, bf16/f32 and
    mask/no mask: the route the port picks for CUDA tensors computes the
    function the JAX package's TPU route computes.  Causal ``Lq != Lk`` in
    f32, which the JAX package hands to its flash kernel, routes to flash,
    whose function on tensors the kernels do not take is dense with the
    top-left mask (``dense_topleft_attention``, held against the Pallas
    kernel by ``test_f32_causal_cross_length_route_matches_pallas_flash``).
    Every head dim the JAX gates take has a kernel, above 256 too (D = 320,
    384, 512, 640, 768 route to splash or flash as the JAX package does).  (At D %
    128 != 0 with Lk > 128 the Pallas flash kernel itself refuses the head
    dim; the port computes the function its gate routes there.)  A bf16
    call that the JAX package hands to a kernel goes to a kernel in the
    port too, never to dense."""
    for causal, lq, lk, dtype, has_mask in itertools.product(
            (False, True), (100, 128, 256), (100, 128, 256),
            (torch.bfloat16, torch.float32), (False, True)):
        case = (causal, lq, lk, d, dtype, has_mask)
        theirs = _jax_tpu_route(lq, lk, d, causal, has_mask)
        assert tattn.choose_impl(lq, lk, d, dtype, causal, has_mask, "cpu") == "dense"
        ours = tattn.choose_impl(lq, lk, d, dtype, causal, has_mask, "cuda")
        assert ours in ("splash", "flash", "dense"), case
        if ours != "dense":
            assert not has_mask and tattn.kernel_takes_head_dim(d), case
        if ours != "dense" and dtype != torch.bfloat16:
            # the one kernel route off bf16: f32 causal Lq != Lk, the top-left
            # function, which dense alone would mask bottom-right
            assert (ours, theirs, causal, dtype) == ("flash", "flash", True, torch.float32), case
            assert lq != lk, case
            assert not np.array_equal(_visible(ours, causal, lq, lk),
                                      _visible("dense", causal, lq, lk)), case
        np.testing.assert_array_equal(_visible(ours, causal, lq, lk),
                                      _visible(theirs, causal, lq, lk), err_msg=str(case))
        if theirs != "dense" and dtype == torch.bfloat16:
            assert ours != "dense", case


@pytest.mark.parametrize("lq,lk", [(128, 256), (256, 128)])
def test_f32_causal_cross_length_route_matches_pallas_flash(lq, lk):
    """f32 causal ``Lq != Lk``: the function ``dot_product_attention`` runs
    for CUDA tensors the kernels do not take (``dense_topleft_attention``)
    is the Pallas flash kernel's, top-left masked, held against that kernel
    in interpret mode: the output within 1e-5 (f32 throughout; one
    softmax, summed in another order) and the gradients within ATOL; and
    it is not dense's bottom-right function."""
    B, H, D = 1, 2, 64
    scale = D ** -0.5
    q, k, v, do = _arrays([(B, lq, H, D), (B, lk, H, D), (B, lk, H, D), (B, lq, H, D)],
                          seed=lq + 2 * lk)
    want, wgrads = _pallas_flash_vjp(
        lambda q, k, v: jattn._flash(q, k, v, True, scale), (q, k, v), do)
    assert tattn.choose_impl(lq, lk, D, torch.float32, True, False, "cuda") == "flash"
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    got = tattn.dense_topleft_attention(tq, tk, tv, causal=True, sm_scale=scale)
    grads = torch.autograd.grad(got, (tq, tk, tv), torch.from_numpy(do))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5, rtol=0)
    for g, w in zip(grads, wgrads):
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL, rtol=0)
    bottom_right = tattn.dense_attention(tq, tk, tv, causal=True, sm_scale=scale)
    assert not torch.allclose(bottom_right, got, atol=0.1)


def test_operands_take_any_batch_times_heads():
    """B * H above 65,535 (here 16,384 x 5 at L = 128, which both JAX gates
    take) is a kernel shape: ``_operands`` passes it on, routing picks a
    kernel, and nothing is copied.  Meta tensors: nothing is allocated."""
    shape = (16384, 128, 5, 64)
    q = torch.empty(shape, dtype=torch.bfloat16, device="meta")
    sds = jax.ShapeDtypeStruct(shape, jnp.bfloat16)
    assert jattn._splash_ok(sds, sds, True) and jattn._flash_ok(sds, sds)
    dims, ts = tattn._operands(q, q, q, q)
    assert dims == (16384, 5, 128, 128, 64)
    assert all(t is q for t in ts)
    assert tattn.choose_impl(128, 128, 64, torch.bfloat16, True, False, "cuda") == "splash"
    assert tattn.choose_impl(128, 128, 64, torch.bfloat16, False, False, "cuda") == "flash"


def test_operand_copies_only_what_the_tile_loads_cannot_read():
    """A split of a fused q|k|v projection and a [B, H, L, D] tensor
    transposed to [B, L, H, D] are read in place (the tile loads take any
    stride order); one whose rows are not 16-byte aligned is copied to an
    aligned, packed tensor with the same values."""
    B, L, H, D = 2, 16, 3, 64
    fused = torch.zeros(B, L, 3 * H * D, dtype=torch.bfloat16)
    q = fused[..., :H * D].reshape(B, L, H, D)
    assert tattn._operand(q, "q", q.shape) is q
    t = torch.zeros(B, H, L, D, dtype=torch.bfloat16).transpose(1, 2)
    assert tattn._operand(t, "t", t.shape) is t
    odd = torch.randn(B * L * H * D + 1).to(torch.bfloat16)[1:].view(B, L, H, D)
    got = tattn._operand(odd, "odd", odd.shape)
    assert got.data_ptr() % 16 == 0 and got.is_contiguous() and torch.equal(got, odd)
