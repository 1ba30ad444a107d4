"""Random flax parameter trees and the comparisons the small-model parity
tests share (``tests/test_torch_{linear,wide_deep,mnist,text,vgg}.py``)."""

import importlib.util
import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[2]


def random_tree(shapes, seed: int = 2):
    """numpy f32 leaves of the shapes in ``shapes`` (an ``eval_shape`` tree):
    kernels He-scaled (variance 2 / fan_in), norm scales near 1, running
    variances in [1, 1.2), embeddings of variance 1 / features, biases and
    means N(0, 0.1²)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name, shape = path[-1].key, s.shape
        if name == "kernel":
            # an attention's q/k/v DenseGeneral kernel [D, H, Dh] reads D
            qkv = path[-2].key in ("query", "key", "value")
            fan_in = shape[0] if qkv else math.prod(shape[:-1])
            return (rng.normal(size=shape) * math.sqrt(2.0 / fan_in)).astype(np.float32)
        if name == "scale":
            return (1 + 0.1 * rng.normal(size=shape)).astype(np.float32)
        if name == "var":
            return (1 + 0.2 * rng.random(shape)).astype(np.float32)
        if name == "embedding":
            return rng.normal(size=shape).astype(np.float32) / math.sqrt(shape[-1])
        return (0.1 * rng.normal(size=shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


# A gradient that is zero in exact arithmetic (an attention's key bias: a
# shift of a row's logits; a conv bias before train-mode batch norm), or a
# sum whose terms nearly cancel (the 2-class head's bias: ±4e-4 where each
# row's term is ~0.5), is rounding noise in either package: each leaf's
# error is taken relative to its own largest magnitude, or to this fraction
# of the tree's largest leaf when that is more
ZERO_FLOOR = 0.1


def max_err(got, want, floor: float = 1e-30) -> float:
    """``max |got - want| / max(max |want|, floor)``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), floor))


def norm_err(got, want, floor: float = 1e-30) -> float:
    """``||got - want|| / max(||want||, floor)`` (L2 over every element)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), floor))


def _floor(tree, err) -> float:
    size = (lambda a: np.abs(a).max()) if err is max_err else np.linalg.norm
    return ZERO_FLOOR * max(float(size(np.asarray(a, np.float64))) for a in jax.tree.leaves(tree))


def close(got, want, tol: float, what: str = "", err=max_err, floor: float = 1e-30) -> None:
    e = err(got, want, floor)
    assert e <= tol, f"{what}: {e} > {tol}"


def close_trees(got, want, tol: float, what: str = "", err=max_err) -> None:
    """Every leaf of ``got`` (a tree of the same structure) within ``tol``
    of ``want``'s, leaf by leaf, by ``err`` (see ``ZERO_FLOOR``)."""
    assert jax.tree.structure(got) == jax.tree.structure(want), what
    floor = _floor(want, err)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want), jax.tree.leaves(got)):
        close(g, w, tol, f"{what} {jax.tree_util.keystr(path)}", err, floor)


def err_of(dtype: str):
    """The error measure of a parity test in ``dtype``: f32 the largest
    element's (of the largest magnitude), bf16 the relative norm (a bf16
    sum of many terms rounds each element by up to a few ulps of 2^-8, in
    either package's order)."""
    return norm_err if dtype == "bfloat16" else max_err


def assert_bit_equal_trees(got, want) -> None:
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def example(relpath: str, name: str):
    """The JAX example module at ``examples/<relpath>``, imported by path."""
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / relpath)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# bf16 gradients are rounding-bound: a sum of many bf16 terms (a bias over
# batch and positions) rounds in either package's order, and a max pool's
# window whose top two inputs round within one ulp sends its gradient to
# another pixel, so flax's own bf16 gradients lie 1-15% (MNIST) and 30-90%
# (VGG16) from the exact ones in relative norm.  So the port's bf16
# gradients are held to the exact ones (flax in float64) no farther than
# flax's bf16 ones lie, with this margin
BF16_FACTOR, BF16_FLOOR = 1.5, 1e-2


def no_worse_than_flax(got, flax_bf16, exact, what: str = "") -> None:
    """Each leaf of ``got`` (the port's bf16 tree) within ``BF16_FACTOR``
    times flax's bf16 distance from ``exact``, plus ``BF16_FLOOR``, in
    relative norm."""
    assert jax.tree.structure(got) == jax.tree.structure(exact), what
    floor = _floor(exact, norm_err)
    for (path, want), theirs, ours in zip(jax.tree_util.tree_leaves_with_path(exact),
                                          jax.tree.leaves(flax_bf16), jax.tree.leaves(got)):
        limit = BF16_FACTOR * norm_err(theirs, want, floor) + BF16_FLOOR
        close(ours, want, limit, f"{what} {jax.tree_util.keystr(path)}", norm_err, floor)


def flax_value_and_grad(loss_fn, params, exact: bool = False, grads: bool = True):
    """``((loss, aux), grads)`` of ``loss_fn(params) -> (loss, aux)``, jitted,
    as float64 numpy (``grads=False``: the forward alone, grads None);
    ``exact``: with x64 on and the parameters cast to float64 (``loss_fn``
    then builds its model in float64)."""
    with jax.enable_x64(exact):
        def f(p):
            if exact:
                p = jax.tree.map(lambda a: a.astype(jnp.float64), p)
            return loss_fn(p)

        if not grads:
            return jax.tree.map(lambda a: np.asarray(a, np.float64), jax.jit(f)(params)), None
        out = jax.jit(jax.value_and_grad(f, has_aux=True))(params)
        return jax.tree.map(lambda a: np.asarray(a, np.float64), out)


def check_grads(got, flax_grads, dtype: str, exact_grads, tol: float, what: str = "grad"):
    """The port's gradients ``got`` against flax's exact ones
    (``exact_grads()``, flax in float64): f32 within ``tol`` leaf by leaf (a
    bias summed over rows whose terms nearly cancel, the 2-class head's,
    rounds in f32 far above its size, in flax's f32 as in the port's, so the
    reference is exact, as ``tests/test_torch_resnet.py``'s); bf16
    :func:`no_worse_than_flax` (``flax_grads``: flax's bf16 ones)."""
    if dtype == "bfloat16":
        no_worse_than_flax(got, flax_grads, exact_grads(), what)
    else:
        close_trees(got, exact_grads(), tol, what)
