"""The port's text models and their NLP distillation trainer against the
JAX package: ``BowClassifier``, ``CnnClassifier`` and ``TextTransformer``
against flax on the same weights and a padded batch (forward and gradients,
f32 and the default bf16; ``tests/test_models.py:60``'s shapes), a
transformer whose padded query rows see no key (finite, and flax's), the
converter both ways, ``kl_distill_loss``, the corpus to the bit, the
student's loss against the example's ``student_loss``, ``module_teacher``
against ``jit_teacher`` on ``ids, mask``, the local role at toy size, the
entry point's device default; and, ``slow``, the twins of
``tests/test_nlp_distill.py`` (both students)."""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from edl_tpu.distill.teacher import jit_teacher
from edl_tpu.models import text as jtext
from edl_tpu_torch import train_nlp_distill as tnd
from edl_tpu_torch.distill.teacher import module_teacher
from edl_tpu_torch.models import text
from edl_tpu_torch.models.convert import text_from_jax, text_to_jax
from edl_tpu_torch.utils.device import NoCardError
from tests.helpers.flax_trees import (assert_bit_equal_trees, check_grads, close, close_trees,
                                      err_of, example, flax_value_and_grad, random_tree)

# f32: of each tensor's largest magnitude (rounding); bf16: in relative norm
# (the 8-bit mantissa through embeddings, norms, attention and the head;
# tests/helpers/flax_trees.py:err_of)
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
VOCAB, L, HEADS = 100, 16, 2
MODELS = {
    "bow": lambda dt, lib: lib.BowClassifier(vocab_size=VOCAB, dtype=dt),
    "cnn": lambda dt, lib: lib.CnnClassifier(vocab_size=VOCAB, dtype=dt),
    "transformer": lambda dt, lib: lib.TextTransformer(vocab_size=VOCAB, num_layers=2,
                                                       embed_dim=32, num_heads=HEADS,
                                                       mlp_dim=64, max_len=32, dtype=dt),
}
CPU = torch.device("cpu")


def _batch(seed=0):
    """[2, 16] ids; the second row padded after 9 tokens."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, VOCAB, (2, L)).astype(np.int32)
    mask = np.ones((2, L), np.float32)
    mask[1, 9:] = 0
    ids[1, 9:] = 0
    return ids, mask, np.array([0, 1])


def _flax_and_port(name, dtype, ids, mask):
    fmodel = MODELS[name](getattr(jnp, dtype), jtext)
    params = random_tree(jax.eval_shape(lambda: fmodel.init(jax.random.key(0), ids,
                                                            mask))["params"])
    model = MODELS[name](getattr(torch, dtype), text)
    model.load_state_dict(text_from_jax(params))
    return fmodel, params, model


def _flax_run(name, dtype, params, ids, mask, y, exact=False):
    """``(loss, logits, grads)`` of the flax model (float64 when ``exact``;
    grads None in f32, whose gradients are held to the exact ones)."""
    fmodel = MODELS[name](jnp.float64 if exact else getattr(jnp, dtype), jtext)

    def loss(p):
        logits = fmodel.apply({"params": p}, ids, mask)
        return optax.softmax_cross_entropy_with_integer_labels(logits, y).mean(), logits
    (value, logits), grads = flax_value_and_grad(loss, params, exact,
                                                 grads=exact or dtype == "bfloat16")
    return value, logits, grads


@functools.cache
def _exact_grads(name):
    """flax's float64 gradients on the padded batch (both dtypes' cases)."""
    ids, mask, y = _batch()
    params = _flax_and_port(name, "float32", ids, mask)[1]
    return _flax_run(name, "float32", params, ids, mask, y, exact=True)[2]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_text_models_match_flax_on_a_padded_batch(name, dtype):
    """Logits, the CE loss and every parameter's gradient (bf16 gradients:
    ``flax_trees.check_grads``); the CNN's max runs over the padded
    positions too, as flax's does."""
    ids, mask, y = _batch()
    _, params, model = _flax_and_port(name, dtype, ids, mask)
    loss, logits, grads = _flax_run(name, dtype, params, ids, mask, y)
    out = model(torch.from_numpy(ids), torch.from_numpy(mask))
    assert out.dtype == torch.float32 and out.shape == (2, 2)
    close(out.detach().numpy(), logits, TOL[dtype], "logits", err_of(dtype))
    tloss = torch.nn.functional.cross_entropy(out, torch.from_numpy(y))
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(loss), rtol=TOL[dtype])
    heads = HEADS if name == "transformer" else 1
    check_grads(text_to_jax({k: p.grad for k, p in model.named_parameters()}, heads), grads,
                dtype, lambda: _exact_grads(name),
                TOL[dtype])
    assert_bit_equal_trees(text_to_jax(model.state_dict(), heads), params)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_padded_query_rows_stay_finite_as_in_flax(dtype):
    """Six ids, the last three padded: a padded query row sees no key under
    ``mask & maskᵀ``.  flax fills masked logits with ``finfo(dtype).min``, so
    the row averages every key and the logits stay finite; a ``-inf`` fill
    would make the row NaN and, through the masked mean, the whole
    sequence."""
    ids = np.array([[5, 17, 42, 0, 0, 0]], np.int32)
    mask = np.array([[1, 1, 1, 0, 0, 0]], np.float32)
    fmodel, params, model = _flax_and_port("transformer", dtype, ids, mask)
    want = np.asarray(jax.jit(lambda p: fmodel.apply({"params": p}, ids, mask))(params),
                      np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    assert np.isfinite(want).all() and np.isfinite(got).all(), (want, got)
    close(got, want, TOL[dtype], "logits", err_of(dtype))


def test_kl_distill_loss_is_jaxs():
    rng = np.random.default_rng(3)
    s, t = (3 * rng.normal(size=(8, 5))).astype(np.float32), \
        (3 * rng.normal(size=(8, 5))).astype(np.float32)
    for temp in (1.0, 2.0):
        want, (gs, gt) = jax.value_and_grad(jtext.kl_distill_loss, argnums=(0, 1))(
            jnp.asarray(s), jnp.asarray(t), temp)
        ts, tt = torch.from_numpy(s).requires_grad_(), torch.from_numpy(t).requires_grad_()
        got = text.kl_distill_loss(ts, tt, temp)
        got.backward()
        np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
        close(ts.grad.numpy(), np.asarray(gs), 1e-5, "d student")
        close(tt.grad.numpy(), np.asarray(gt), 1e-5, "d teacher")


def _example():
    return example("distill/train_nlp_distill.py", "jax_train_nlp_distill")


def test_corpus_and_batches_are_the_examples():
    jex = _example()
    args = tnd.parse_args(["--device", "cpu"])
    for seed, noise in ((0, 0.0), (1, 0.65)):
        ours = tnd.make_corpus(args, 64, seed, noise)
        theirs = jex.make_corpus(args, 64, seed, noise)
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a, b)
    ids, mask, y, _ = ours
    for a, b in zip(tnd.batches(ids, mask, y, 16, 100), jex.batches(ids, mask, y, 16, 100)):
        for k in ("ids", "mask", "label"):
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("student", ["bow", "cnn"])
def test_student_loss_is_the_examples(student):
    """``student_loss`` against the example's on converted weights (f32), with
    the teacher's logits and without: the loss and every gradient."""
    jex = _example()
    args = tnd.parse_args(["--device", "cpu", "--student", student])
    corpus = tnd.make_corpus(args, 8, 1, args.label_noise)
    batch = {"ids": corpus[0], "mask": corpus[1], "label": corpus[3]}
    fmodel = jex.make_student(args)
    params = random_tree(jax.eval_shape(lambda: fmodel.init(
        jax.random.key(0), batch["ids"], batch["mask"]))["params"])
    model = tnd.make_student(args)
    for teacher in (None, (2 * np.random.default_rng(4).normal(size=(8, args.classes)))
                    .astype(np.float32)):
        b = dict(batch) if teacher is None else dict(batch, teacher_logits=teacher)
        (want, _), grads = jax.jit(jax.value_and_grad(
            lambda p, b: jex.student_loss(fmodel, args)(p, None, b, None), has_aux=True))(
            params, b)
        model.load_state_dict(text_from_jax(params))
        model.zero_grad()
        got = tnd.student_loss(args)(model, None, {k: torch.from_numpy(v)
                                                   for k, v in b.items()}, None)[0]
        got.backward()
        np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
        close_trees(text_to_jax({k: p.grad for k, p in model.named_parameters()}),
                    jax.tree.map(np.asarray, grads), 1e-5, "grad")


def test_module_teacher_is_jit_teacher_on_ids_and_mask():
    """The served transformer: feeds ``ids`` and ``mask`` in sorted key order
    into the forward, as the JAX ``jit_teacher`` passes them."""
    jex = _example()
    args = tnd.parse_args(["--device", "cpu"])
    ids, mask, _, _ = tnd.make_corpus(args, 6, 2)
    fmodel = jex.make_teacher(args)
    params = random_tree(jax.eval_shape(lambda: fmodel.init(jax.random.key(0), ids,
                                                            mask))["params"])
    want = jit_teacher(fmodel.apply, {"params": params}, fetch_name="logits",
                       train=False)({"mask": mask, "ids": ids})["logits"]
    model = tnd.make_teacher(args)
    model.load_state_dict(text_from_jax(params))
    got = module_teacher(model, device="cpu")({"mask": mask, "ids": ids})["logits"]
    close(got, want, TOL["float32"], "teacher logits")


def test_local_role_at_toy_size(tmp_path):
    out = tmp_path / "summary.json"
    summary = tnd.main(["--device", "cpu", "--student", "cnn", "--train_n", "64",
                        "--test_n", "32", "--teacher_epochs", "1", "--student_epochs", "1",
                        "--out", str(out)])
    assert set(summary) == {"student", "teacher_acc", "distill_acc", "baseline_acc", "gain",
                            "teacher_rows", "teacher_rows_per_s"}
    assert summary["student"] == "cnn" and summary["teacher_rows"] == 64
    assert json.loads(out.read_text()) == summary


def test_entry_point_runs_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(NoCardError):
        tnd.main([])


@pytest.mark.slow
@pytest.mark.parametrize("student", ["bow", "cnn"])
def test_nlp_distill_beats_noisy_baseline(student):
    """The twin of ``tests/test_nlp_distill.py:25``, with its bars."""
    summary = tnd.main(["--device", "cpu", "--role", "local", "--student", student])
    assert summary["teacher_acc"] >= 0.9, summary
    assert summary["distill_acc"] >= 0.8, summary
    assert summary["gain"] >= 0.2, summary
    assert summary["teacher_rows"] > 0 and summary["teacher_rows_per_s"] > 0
