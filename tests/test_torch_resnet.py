"""The port's ResNet against the JAX package's flax model: train-mode
logits, the updated ``batch_stats``, eval-mode logits and the gradient of
the label-smoothed cross-entropy for every parameter, from the same
weights; XLA's SAME padding at stride 2; the weight converter; the
analytic FLOP count; SGD against optax."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from flax import linen as fnn

from edl_tpu.models import resnet as jresnet
from edl_tpu_torch.models import resnet
from edl_tpu_torch.models.convert import resnet_from_jax, resnet_to_jax
from edl_tpu_torch.obs.flops import analytic_resnet_flops_per_image
from edl_tpu_torch.train.lr import cosine_warmup
from edl_tpu_torch.train.state import sgd

CLASSES, WIDTH, BATCH, SMOOTHING = 10, 8, 4, 0.1
# |port - flax| <= TOL * max |flax|, per tensor, by the port's dtype (both
# models return f32 logits, so a float64 run is held to f32's rounding)
TOL = {"float32": 1e-4, "float64": 1e-6}


def _close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"{what}: {err} > {tol}"


def _variables(model, n, seed=2):
    """Random flax ``(params, batch_stats)`` of ``model`` at input size
    ``n`` (shapes from ``eval_shape``, so no init is compiled): kernels of
    variance 1 / fan_in; BN scales near 1, and near 0.2 for the last BN of
    each residual branch (flax starts those at 0, which would leave every
    branch's gradient zero); small biases; running stats away from (0, 1)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: model.init(jax.random.key(0), jnp.zeros((1, n, n, 3)),
                                               train=False))

    def leaf(path, shape):
        keys = [p.key for p in path]
        shape = shape.shape
        if keys[-1] == "kernel":
            return (rng.normal(size=shape) / math.sqrt(math.prod(shape[:-1]))).astype(np.float32)
        if keys[-1] == "scale":
            last = keys[-2] == "bn3" or (keys[-2] == "bn2" and "conv3" not in
                                         shapes["params"][keys[-3]])
            return ((0.2 if last else 1.0) * (1 + 0.1 * rng.normal(size=shape))).astype(np.float32)
        if keys[-1] == "var":
            return (1 + 0.2 * rng.random(shape)).astype(np.float32)
        return (0.1 * rng.normal(size=shape)).astype(np.float32)     # bias, mean

    return (jax.tree_util.tree_map_with_path(leaf, shapes["params"]),
            jax.tree_util.tree_map_with_path(leaf, shapes["batch_stats"]))


def _data(n):
    x = np.random.default_rng(0).normal(size=(BATCH, n, n, 3)).astype(np.float32)
    y = np.random.default_rng(1).integers(0, CLASSES, (BATCH,)).astype(np.int32)
    return x, y


def _flax(name, n):
    """(params, batch_stats, train logits, new batch_stats, eval logits,
    grads) of the flax model computed in float64, as numpy."""
    with jax.enable_x64(True):
        model = getattr(jresnet, name)(num_classes=CLASSES, width=WIDTH, dtype=jnp.float64)
        x, y = _data(n)
        params, stats = _variables(model, n)

        @jax.jit
        def run(params, stats, x):
            params = jax.tree.map(lambda a: a.astype(jnp.float64), params)
            stats = jax.tree.map(lambda a: a.astype(jnp.float64), stats)

            def loss(p):
                logits, mut = model.apply({"params": p, "batch_stats": stats}, x, train=True,
                                          mutable=["batch_stats"])
                labels = optax.smooth_labels(jax.nn.one_hot(y, CLASSES), SMOOTHING)
                return optax.softmax_cross_entropy(logits, labels).mean(), (
                    logits, mut["batch_stats"])

            (_, (logits, new_stats)), grads = jax.value_and_grad(loss, has_aux=True)(params)
            evals = model.apply({"params": params, "batch_stats": stats}, x, train=False)
            return logits, new_stats, evals, grads

        out = jax.tree.map(np.asarray, run(params, stats, jnp.asarray(x, jnp.float64)))
    return (params, stats, *out)


# The reference is the flax model evaluated in float64.  flax's own f32
# gradients are up to 1.8e-4 of the largest off those (its one-pass variance,
# E[x²] - E[x]², cancels), so f32 against f32 would measure flax's rounding.
# At 32² a bottleneck net's last stage normalises 4 values (batch 4, 1x1),
# where any f32 gradient is ~1e-3 off (the port's 9e-4, flax's 6e-4 to
# 2.6e-3): that case runs the port in float64.  A vd net takes only sizes
# whose every stride-2 stage sees an even size (at 33² flax and the port both
# reject the residual add), so its case is at 64², where, as at 32², every
# stride-2 layer pads (0, 1).
@pytest.mark.parametrize("name,n,dtype", [
    ("ResNet18", 32, "float32"), ("ResNet18", 33, "float32"), ("ResNet50", 33, "float32"),
    ("ResNet50", 32, "float64"), ("ResNet50vd", 64, "float32")])
def test_resnet_matches_flax(name, n, dtype):
    params, stats, logits, new_stats, evals, grads = _flax(name, n)
    tol, tdt = TOL[dtype], getattr(torch, dtype)
    x, y = _data(n)
    model = getattr(resnet, name)(num_classes=CLASSES, width=WIDTH, dtype=tdt)
    sd = resnet_from_jax(params, stats)
    model.load_state_dict(sd)
    model.to(tdt)
    model.train()
    out = model(torch.from_numpy(x))
    assert out.dtype == torch.float32
    _close(out.detach().numpy(), logits, tol, "train logits")
    F.cross_entropy(out, torch.from_numpy(y).long(), label_smoothing=SMOOTHING).backward()
    got_stats = resnet_to_jax(dict(model.named_buffers()))[1]
    for (path, want), got in zip(jax.tree_util.tree_leaves_with_path(new_stats),
                                 jax.tree.leaves(got_stats)):
        _close(got, want, tol, f"batch_stats {jax.tree_util.keystr(path)}")
    got_grads = resnet_to_jax({k: p.grad for k, p in model.named_parameters()})[0]
    assert jax.tree.structure(got_grads) == jax.tree.structure(grads)
    for (path, want), got in zip(jax.tree_util.tree_leaves_with_path(grads),
                                 jax.tree.leaves(got_grads)):
        _close(got, want, tol, f"grad {jax.tree_util.keystr(path)}")
    model.load_state_dict(sd)
    model.eval()
    with torch.no_grad():
        _close(model(torch.from_numpy(x)).numpy(), evals, tol, "eval logits")


def _err(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_resnet_bf16_forward_matches_flax():
    """bf16 compute over f32 weights (the card's default), train mode.
    bf16 keeps 8 bits through 50 layers and the two round at other points,
    so the tolerance is flax's own: the port's logits are no further from
    flax's f32 forward than 1.5x flax's bf16 logits are (measured: 0.022
    against 0.027 of the largest), and no further from flax's bf16 logits
    than twice that (measured 0.031)."""
    x, _ = _data(33)
    ref = {}
    for dtype in (jnp.float32, jnp.bfloat16):
        flax_model = jresnet.ResNet50(num_classes=CLASSES, width=WIDTH, dtype=dtype)
        params, stats = _variables(flax_model, 33)
        ref[dtype] = np.asarray(jax.jit(lambda p, s, x: flax_model.apply(
            {"params": p, "batch_stats": s}, x, train=True, mutable=["batch_stats"])[0])(
                params, stats, x))
    model = resnet.ResNet50(num_classes=CLASSES, width=WIDTH)
    model.load_state_dict(resnet_from_jax(params, stats))
    model.train()
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    assert out.dtype == torch.float32
    flax_gap = _err(ref[jnp.bfloat16], ref[jnp.float32])
    assert _err(out.numpy(), ref[jnp.float32]) <= 1.5 * flax_gap
    assert _err(out.numpy(), ref[jnp.bfloat16]) <= 2 * flax_gap


def test_vd_rejects_odd_sizes_as_flax_does():
    model = resnet.ResNet50vd(num_classes=CLASSES, width=WIDTH, dtype=torch.float32)
    with pytest.raises(RuntimeError):
        model(torch.zeros(1, 33, 33, 3))
    flax_model = jresnet.ResNet50vd(num_classes=CLASSES, width=WIDTH, dtype=jnp.float32)
    with pytest.raises(TypeError):
        jax.eval_shape(lambda: flax_model.init(jax.random.key(0), jnp.zeros((1, 33, 33, 3)),
                                               train=False))


@pytest.mark.parametrize("n", [7, 8, 9, 16, 224])
@pytest.mark.parametrize("k", [3, 7])
def test_same_padding_matches_flax_at_stride_2(n, k):
    """XLA's split of SAME padding (the odd pixel at the end) for a conv and
    for the -inf-padded max pool, on even and odd sizes."""
    rng = np.random.default_rng(n * 10 + k)
    x = rng.normal(size=(2, n, n, 3)).astype(np.float32)
    conv = fnn.Conv(4, (k, k), strides=(2, 2), use_bias=False)
    kernel = rng.normal(size=(k, k, 3, 4)).astype(np.float32)
    want = conv.apply({"params": {"kernel": kernel}}, x)
    port = resnet.Conv(3, 4, k, 2, torch.Generator().manual_seed(0))
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1)))
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    _close(got.numpy(), want, 1e-5, "conv")
    want = fnn.max_pool(x, (k, k), strides=(2, 2), padding="SAME")
    got = resnet.max_pool_same(torch.from_numpy(x).permute(0, 3, 1, 2), k, 2)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
    # the stem's 7x7/2 on 224, a 3x3/2 on even and odd sizes
    assert (resnet.same_padding(224, 7, 2), resnet.same_padding(8, 3, 2),
            resnet.same_padding(9, 3, 2)) == ((2, 3), (0, 1), (1, 1))


def test_convert_round_trip_is_bit_identical():
    flax_model = jresnet.ResNet50vd(num_classes=CLASSES, width=WIDTH)
    params, stats = _variables(flax_model, 32)
    sd = resnet_from_jax(params, stats)
    model = resnet.ResNet50vd(num_classes=CLASSES, width=WIDTH)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd)
    p2, s2 = resnet_to_jax(model.state_dict())
    for a, b in zip(jax.tree.leaves((params, stats)), jax.tree.leaves((p2, s2))):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert jax.tree.structure((params, stats)) == jax.tree.structure((p2, s2))
    for k, v in resnet_from_jax(p2, s2).items():
        assert torch.equal(v, sd[k]), k


def test_init_follows_flax():
    """lecun_normal kernels (variance 1 / fan_in, truncated at 2 sigma), zero
    head bias, BN scales 1 but the branches' last (0)."""
    model = resnet.ResNet50(num_classes=1000, width=64)
    w = model.stage2_block0.conv2.weight
    fan_in = w.shape[1] * 9
    assert abs(float(w.detach().var()) * fan_in - 1.0) < 0.02
    assert float(w.detach().abs().max()) <= 2 / 0.87962566103423978 / math.sqrt(fan_in) + 1e-6
    assert not model.head.bias.any() and abs(float(model.head.weight.detach().var()) * 2048 - 1) < 0.05
    assert not model.stage0_block0.bn3.weight.any() and bool((model.stem_bn.weight == 1).all())
    assert not resnet.ResNet18(num_classes=10, width=8).stage0_block0.bn2.weight.any()
    flax_model = jresnet.ResNet50(num_classes=1000, width=64)
    shapes = jax.eval_shape(lambda: flax_model.init(jax.random.key(0), jnp.zeros((1, 64, 64, 3)),
                                                    train=False))
    assert {k: tuple(v.shape) for k, v in resnet_from_jax(
        jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes["params"]),
        jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes["batch_stats"])).items()
    } == {k: tuple(v.shape) for k, v in model.state_dict().items()}


def _counted_flops(model, n):
    """Forward FLOPs counted from the layers' output shapes, by hooks."""
    total = []

    def hook(layer, inputs, out):
        if isinstance(layer, resnet.Conv):
            cout, cin, k, _ = layer.weight.shape
            total.append(2 * out.shape[2] * out.shape[3] * cin * cout * k * k)
        else:
            total.append(2 * layer.weight.numel())

    for layer in model.modules():
        if isinstance(layer, (resnet.Conv, resnet.Dense)):
            layer.register_forward_hook(hook)
    with torch.no_grad():
        model.eval()(torch.zeros(1, n, n, 3))
    return sum(total)


@pytest.mark.parametrize("name,n", [("ResNet18", 33), ("ResNet50", 32), ("ResNet50vd", 64),
                                    ("ResNet34", 40)])
def test_analytic_flops_count_every_layer(name, n):
    model = getattr(resnet, name)(num_classes=CLASSES, width=WIDTH, dtype=torch.float32)
    assert analytic_resnet_flops_per_image(model, n) == 3 * _counted_flops(model, n)


def test_resnet50_flops_at_224():
    model = resnet.ResNet50(num_classes=1000, width=64)
    assert analytic_resnet_flops_per_image(model, 224) == 3 * 2 * 4_089_184_256


def test_sgd_matches_optax_chain():
    """Five steps of the port's SGD (Nesterov, coupled weight decay, a
    cosine-warmup schedule) against optax.chain(add_decayed_weights,
    sgd(nesterov=True)); and label-smoothed CE against optax's."""
    rng = np.random.default_rng(0)
    w0 = rng.normal(size=(6, 5)).astype(np.float32)
    grads = [rng.normal(size=(6, 5)).astype(np.float32) for _ in range(5)]
    schedule = cosine_warmup(0.4, total_steps=5, warmup_steps=2)
    jsched = optax.join_schedules([optax.linear_schedule(0.0, 0.4, 2),
                                   optax.cosine_decay_schedule(0.4, 3, 0.0)], [2])
    tx = optax.chain(optax.add_decayed_weights(1e-2), optax.sgd(jsched, 0.9, nesterov=True))
    p, st = jnp.asarray(w0), None
    st = tx.init(p)
    param = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt = sgd(schedule, momentum=0.9, nesterov=True, weight_decay=1e-2)([param])
    for g in grads:
        updates, st = tx.update(jnp.asarray(g), st, p)
        p = optax.apply_updates(p, updates)
        param.grad = torch.from_numpy(g.copy())
        opt.step()
        _close(param.detach().numpy(), p, 1e-6, "sgd step")
    assert opt.param_groups[0]["count"] == 5
    # the count rides the optimizer's state dict
    fresh = sgd(schedule, weight_decay=1e-2)([torch.nn.Parameter(torch.zeros(6, 5))])
    fresh.load_state_dict(opt.state_dict())
    assert fresh.param_groups[0]["count"] == 5

    logits = rng.normal(size=(8, CLASSES)).astype(np.float32)
    labels = rng.integers(0, CLASSES, (8,))
    want = optax.softmax_cross_entropy(
        logits, optax.smooth_labels(jax.nn.one_hot(labels, CLASSES), SMOOTHING)).mean()
    got = F.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                          label_smoothing=SMOOTHING)
    _close(got.numpy(), want, 1e-6, "label-smoothed CE")
