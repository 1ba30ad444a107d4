"""The port's MNIST CNN and its distillation trainer against the JAX
package: ``MnistCNN`` against flax on the same weights (forward and
gradients at 28² in the default bf16 and at the example's 16² in f32:
``fc`` reads the NHWC flatten), the converter both ways, the example's
digits and batches to the bit, the student's distill loss and gradient
against the example's loss body, the teacher's checkpoint, the local role
at toy size, the entry point's device default; and, ``slow``, the twin of
``tests/test_distill_e2e.py``'s distilled-student case."""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from edl_tpu.models.mnist import MnistCNN as JMnist
from edl_tpu_torch import train_mnist_distill as tmd
from edl_tpu_torch.models.convert import mnist_from_jax, mnist_to_jax
from edl_tpu_torch.models.mnist import MnistCNN
from edl_tpu_torch.utils.device import NoCardError
from tests.helpers.flax_trees import (assert_bit_equal_trees, check_grads, close, close_trees,
                                      err_of, example, flax_value_and_grad, random_tree)

# f32: of each tensor's largest magnitude (rounding); bf16: in relative
# norm (the 8-bit mantissa through two convs and the head; tests/helpers/
# flax_trees.py:err_of)
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
CPU = torch.device("cpu")


def _example():
    return example("distill/train_mnist_distill.py", "jax_train_mnist_distill")


def _case(size):
    x = np.random.default_rng(0).normal(size=(2, size, size, 1)).astype(np.float32)
    params = random_tree(jax.eval_shape(lambda: JMnist().init(jax.random.key(0), x))["params"])
    return x, np.array([3, 7]), params


def _flax_run(dtype, size, exact=False):
    """``(loss, logits, grads)`` of flax's ``MnistCNN`` in ``dtype`` at
    ``size`` (float64 when ``exact``; grads None in f32, whose gradients
    are held to the exact ones), as numpy."""
    x, y, params = _case(size)
    fmodel = JMnist(num_classes=10, dtype=jnp.float64 if exact else getattr(jnp, dtype))

    def loss(p):
        logits = fmodel.apply({"params": p}, x)
        return optax.softmax_cross_entropy_with_integer_labels(logits, y).mean(), logits
    (value, logits), grads = flax_value_and_grad(loss, params, exact,
                                                 grads=exact or dtype == "bfloat16")
    return value, logits, grads


_exact_grads = functools.cache(lambda size: _flax_run("float64", size, exact=True)[2])


@pytest.mark.parametrize("size,dtype", [(28, "bfloat16"), (16, "float32")])
def test_mnist_cnn_matches_flax(size, dtype):
    """``tests/test_models.py:30``'s [2, 28, 28, 1] in the default bf16, and
    the example's 16² in f32 (bf16 gradients: ``flax_trees.check_grads``)."""
    x, y, params = _case(size)
    loss, logits, grads = _flax_run(dtype, size)
    model = MnistCNN(num_classes=10, image_size=size, dtype=getattr(torch, dtype))
    model.load_state_dict(mnist_from_jax(params))
    out = model(torch.from_numpy(x))
    assert out.dtype == torch.float32
    close(out.detach().numpy(), logits, TOL[dtype], "logits", err_of(dtype))
    tloss = torch.nn.functional.cross_entropy(out, torch.from_numpy(y))
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(loss), rtol=TOL[dtype])
    check_grads(mnist_to_jax({k: p.grad for k, p in model.named_parameters()}), grads, dtype,
                lambda: _exact_grads(size), TOL[dtype])
    assert_bit_equal_trees(mnist_to_jax(model.state_dict()), params)


def test_digits_and_batches_are_the_examples():
    jex = _example()
    for seed, noise in ((0, 0.0), (1, 0.7)):
        ours = tmd.make_digits(64, 6, 16, seed, noise)
        theirs = jex.make_digits(64, 6, 16, seed, noise)
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a, b)
    x, y, _ = ours
    extra = np.arange(64 * 6, dtype=np.float32).reshape(64, 6)
    for a, b in zip(tmd.batches(x, y, 16, 100, extra), jex.batches(x, y, 16, 100, extra)):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("with_teacher", [True, False])
def test_student_loss_and_gradient_are_the_examples(with_teacher):
    """The example's student loss body (optax) on converted weights, f32:
    the loss and every parameter's gradient."""
    args = tmd.parse_args(["--device", "cpu"])
    fmodel = JMnist(num_classes=args.classes, dtype=jnp.float32)
    rng = np.random.default_rng(3)
    batch = {"image": rng.normal(size=(8, 16, 16, 1)).astype(np.float32),
             "label": rng.integers(0, args.classes, 8).astype(np.int32)}
    if with_teacher:
        batch["teacher_logits"] = (3 * rng.normal(size=(8, args.classes))).astype(np.float32)
    params = random_tree(jax.eval_shape(lambda: fmodel.init(jax.random.key(0),
                                                            batch["image"]))["params"])
    T = args.temperature

    @jax.jit
    def jloss(params, batch):       # the example's loss_fn, line for line
        logits = fmodel.apply({"params": params}, batch["image"])
        hard = optax.softmax_cross_entropy_with_integer_labels(logits, batch["label"]).mean()
        if "teacher_logits" in batch:
            soft = optax.softmax_cross_entropy(
                logits / T, jax.nn.softmax(batch["teacher_logits"] / T)).mean() * (T * T)
            return args.alpha * hard + (1 - args.alpha) * soft
        return hard

    want, grads = jax.value_and_grad(jloss)(params, batch)
    model = tmd.make_model(args, CPU)
    model.load_state_dict(mnist_from_jax(params))
    got = tmd.make_student_loss_fn(args)(model, None, {k: torch.from_numpy(v)
                                                       for k, v in batch.items()}, None)[0]
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    close_trees(mnist_to_jax({k: p.grad for k, p in model.named_parameters()}),
                jax.tree.map(np.asarray, grads), 1e-5, "grad")


def test_teacher_checkpoint_round_trip(tmp_path):
    args = tmd.parse_args(["--device", "cpu", "--teacher_dir", str(tmp_path / "t"),
                           "--teacher_epochs", "1", "--train_n", "64"])
    x, y, _ = tmd.make_digits(args.train_n, args.classes, args.image_size, seed=0)
    with pytest.raises(FileNotFoundError, match="no teacher checkpoint"):
        tmd.load_teacher(args, CPU)
    state = tmd.train_teacher(args, x, y, CPU)
    assert state.step == 2
    tmd.save_teacher(args, state)
    loaded = tmd.load_teacher(args, CPU)
    for (n, a), (m, b) in zip(state.model.state_dict().items(), loaded.state_dict().items()):
        assert n == m and torch.equal(a, b), n


def test_local_role_at_toy_size(tmp_path):
    """The whole flow in one process: the teacher, a server behind a
    discovery server, the distilled student and the baseline."""
    out = tmp_path / "summary.json"
    summary = tmd.main(["--device", "cpu", "--train_n", "64", "--test_n", "64",
                        "--teacher_epochs", "2", "--student_epochs", "1",
                        "--out", str(out)])
    assert set(summary) == {"teacher_acc", "distill_acc", "baseline_acc", "gain"}
    assert json.loads(out.read_text()) == summary


def test_entry_point_runs_on_the_card_unless_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(NoCardError):
        tmd.main(["--teacher_dir", str(tmp_path / "t")])


@pytest.mark.slow
def test_distilled_student_beats_noisy_baseline(tmp_path):
    """The twin of ``tests/test_distill_e2e.py:19``, with its arguments and
    bars."""
    summary = tmd.main(["--device", "cpu", "--role", "local", "--classes", "6",
                        "--train_n", "256", "--label_noise", "0.7", "--student_epochs", "20",
                        "--out", str(tmp_path / "summary.json")])
    assert summary["teacher_acc"] > 0.95, summary
    assert summary["distill_acc"] > 0.9, summary
    assert summary["gain"] >= 0.05, summary
