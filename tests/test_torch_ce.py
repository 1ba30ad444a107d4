"""The port's blockwise fused cross-entropy against the JAX package's
(value and gradients in hidden and weight), and against dense CE."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edl_tpu.ops.ce import blockwise_cross_entropy as jax_ce
from edl_tpu_torch.ops.ce import NEG_INF, blockwise_cross_entropy


def _data(N, D, V, seed):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(N, D)).astype(np.float32)
    w = rng.normal(size=(D, V)).astype(np.float32)
    t = rng.integers(0, V, (N,)).astype(np.int32)
    g = rng.normal(size=(N,)).astype(np.float32)
    return h, w, t, g


@pytest.mark.parametrize("V,block", [(1000, 256), (512, 512), (300, 1024), (257, 64), (700, 128)])
def test_forward_and_grads_match_jax(V, block):
    h, w, t, g = _data(17, 32, V, seed=V)

    def jloss(h, w):
        return (jax_ce(h, w, jnp.asarray(t), block_size=block) * g).sum()

    jnll = jax_ce(jnp.asarray(h), jnp.asarray(w), jnp.asarray(t), block_size=block)
    jgh, jgw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))

    th, tw = torch.from_numpy(h).requires_grad_(), torch.from_numpy(w).requires_grad_()
    nll = blockwise_cross_entropy(th, tw, torch.from_numpy(t), block_size=block)
    (nll * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(nll.detach().numpy(), np.asarray(jnll), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jgh), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jgw), rtol=1e-5, atol=1e-5)


def test_matches_dense_ce_with_leading_dims():
    rng = np.random.default_rng(2)
    h = torch.from_numpy(rng.normal(size=(2, 5, 8)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(8, 96)).astype(np.float32))
    t = torch.from_numpy(rng.integers(0, 96, (2, 5)))
    got = blockwise_cross_entropy(h, w, t, block_size=32)
    want = torch.nn.functional.cross_entropy((h @ w).reshape(-1, 96), t.reshape(-1),
                                             reduction="none").reshape(2, 5)
    assert got.shape == (2, 5) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_bf16_hidden_matches_jax_dtypes():
    h, w, t, _ = _data(9, 64, 256, seed=3)
    jh = jnp.asarray(h).astype(jnp.bfloat16)
    jw = jnp.asarray(w).astype(jnp.bfloat16)
    jnll = jax_ce(jh, jw, jnp.asarray(t), block_size=64)
    jg = jax.grad(lambda h: jax_ce(h, jw, jnp.asarray(t), block_size=64).mean())(jh)
    th = torch.from_numpy(h).to(torch.bfloat16).requires_grad_()
    tw = torch.from_numpy(w).to(torch.bfloat16)
    nll = blockwise_cross_entropy(th, tw, torch.from_numpy(t), block_size=64)
    nll.mean().backward()
    assert nll.dtype == torch.float32 and th.grad.dtype == torch.bfloat16
    # both widen the same bf16 values and accumulate in f32
    np.testing.assert_allclose(nll.detach().numpy(), np.asarray(jnll), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(th.grad.float().numpy(), np.asarray(jg, np.float32),
                               rtol=2e-2, atol=1e-3)


def test_out_of_range_target_gives_huge_nll_like_jax():
    h, w, _, _ = _data(3, 8, 100, seed=4)
    t = np.array([5, 110, -1], np.int32)  # 110 lands in the padded block
    jnll = np.asarray(jax_ce(jnp.asarray(h), jnp.asarray(w), jnp.asarray(t), block_size=64))
    nll = blockwise_cross_entropy(torch.from_numpy(h), torch.from_numpy(w),
                                  torch.from_numpy(t), block_size=64).numpy()
    assert np.isfinite(nll[0]) and abs(nll[0] - jnll[0]) < 1e-4
    assert (nll[1:] > -NEG_INF / 10).all() and (jnll[1:] > -NEG_INF / 10).all()


def test_bad_inputs_raise():
    h, w = torch.zeros(4, 8), torch.zeros(8, 32)
    with pytest.raises(ValueError):
        blockwise_cross_entropy(h, w, torch.zeros(5, dtype=torch.int64))
    with pytest.raises(TypeError):
        blockwise_cross_entropy(h, w, torch.zeros(4))
