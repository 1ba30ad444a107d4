"""The port's VGG16 against the JAX package's flax model on the same weights
at 64² (``tests/test_models.py:53``'s 7 classes, where the NHWC flatten
before ``fc0`` has 2 x 2 positions): train-mode logits, the updated
``batch_stats`` and every parameter's gradient, and eval-mode logits, in f32
and in the default bf16; the converter both ways.

The gradients below a max pool are bounded by the pool itself: a 2 x 2
window whose top two inputs lie within the dtype's rounding of each other
sends its gradient to another pixel in either package.  At these weights
flax's own f32 gradients of stages 0-3 lie 8e-4 from float64 in relative
norm and the port's 7e-3 (in float64 the two agree to 1e-7), so f32
gradients are held in relative norm to ``F32_POOL_TOL``.  In bf16 both lie
30-90% from the f32 ones, so the port's bf16 values are held no farther from
flax's f32 ones than flax's bf16 ones lie (``tests/helpers/flax_trees.py:
no_worse_than_flax``)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from edl_tpu.models.vgg import VGG16 as JVGG16
from edl_tpu_torch.models.convert import vgg_from_jax, vgg_to_jax
from edl_tpu_torch.models.vgg import VGG16
from tests.helpers.flax_trees import (assert_bit_equal_trees, close, close_trees,
                                      no_worse_than_flax, norm_err, random_tree)

N, B, CLASSES = 64, 1, 7
F32_TOL = 1e-4        # f32 logits and batch stats, of each tensor's largest
                      # magnitude: 16 layers of f32 rounding (ResNet's 1e-4)
F32_POOL_TOL = 2e-2   # f32 gradients, relative norm (the max pools: see above)
BF16_TOL = 2e-2       # bf16 eval-mode logits against flax's bf16, relative norm


def _data():
    x = np.random.default_rng(0).normal(size=(B, N, N, 3)).astype(np.float32)
    return x, np.array([5])


@functools.cache
def _variables():
    shapes = jax.eval_shape(lambda: JVGG16(num_classes=CLASSES).init(
        jax.random.key(0), jnp.zeros((1, N, N, 3)), train=False))
    return random_tree(shapes["params"]), random_tree(shapes["batch_stats"])


@functools.cache
def _flax(dtype):
    """``(train logits, new batch_stats, grads, eval logits)`` of flax's VGG16
    in ``dtype``, as float64 numpy (one compile each)."""
    params, stats = _variables()
    x, y = _data()
    model = JVGG16(num_classes=CLASSES, dtype=getattr(jnp, dtype))

    @jax.jit
    def run(p, s):
        def loss(p):
            logits, mut = model.apply({"params": p, "batch_stats": s}, x, train=True,
                                      mutable=["batch_stats"])
            return optax.softmax_cross_entropy_with_integer_labels(logits, y).mean(), \
                (logits, mut["batch_stats"])
        (_, (logits, new_stats)), grads = jax.value_and_grad(loss, has_aux=True)(p)
        return logits, new_stats, grads, model.apply({"params": p, "batch_stats": s}, x,
                                                     train=False)

    return jax.tree.map(lambda a: np.asarray(a, np.float64), run(params, stats))


def _port(dtype):
    """``(train logits, new batch_stats, grads, eval logits, model)`` of the
    port's VGG16 in ``dtype`` on the converted variables."""
    params, stats = _variables()
    x, y = _data()
    with torch.device("meta"):     # the weights are loaded next: no init
        model = VGG16(num_classes=CLASSES, image_size=N, dtype=getattr(torch, dtype))
    model = model.to_empty(device="cpu")
    model.load_state_dict(vgg_from_jax(params, stats))
    out = model.train()(torch.from_numpy(x))
    torch.nn.functional.cross_entropy(out, torch.from_numpy(y)).backward()
    new_stats = vgg_to_jax(dict(model.named_buffers()))[1]
    grads = vgg_to_jax({k: p.grad for k, p in model.named_parameters()})[0]
    model.load_state_dict(vgg_from_jax(params, stats))
    with torch.no_grad():
        evals = model.eval()(torch.from_numpy(x))
    assert out.dtype == evals.dtype == torch.float32
    return out.detach().numpy(), new_stats, grads, evals.numpy(), model


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vgg16_matches_flax(dtype):
    logits, stats, grads, evals = _flax("float32")
    got_logits, got_stats, got_grads, got_evals, model = _port(dtype)
    if dtype == "float32":
        close(got_logits, logits, F32_TOL, "train logits")
        close_trees(got_stats, stats, F32_TOL, "batch_stats")
        close(got_evals, evals, F32_TOL, "eval logits")
        close_trees(got_grads, grads, F32_POOL_TOL, "grad", norm_err)
        # the converter both ways, to the bit
        assert_bit_equal_trees(vgg_to_jax(model.state_dict()), _variables())
        return
    f_logits, f_stats, f_grads, f_evals = _flax(dtype)
    no_worse_than_flax(got_logits, f_logits, logits, "train logits")
    no_worse_than_flax(got_stats, f_stats, stats, "batch_stats")
    no_worse_than_flax(got_grads, f_grads, grads, "grad")
    close(got_evals, f_evals, BF16_TOL, "eval logits", norm_err)
