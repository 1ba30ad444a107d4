"""The port's ResNet entry point (``edl_tpu_torch.train_resnet``): three
steps of its trainer (label-smoothed CE, Nesterov SGD with coupled weight
decay on the batch-scaled cosine-warmup schedule, BN running stats) against
the JAX example's step body; the loss on a uint8 batch; the eval metrics;
the unported flags; and a synthetic run that learns, resumes at the next
epoch and dumps every epoch's record."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from edl_tpu.models import resnet as jresnet
from edl_tpu.train import cosine_warmup as jcosine_warmup
from edl_tpu.train import scale_lr_for_batch as jscale_lr_for_batch
from edl_tpu_torch import train_resnet
from edl_tpu_torch.data import images
from edl_tpu_torch.models.convert import resnet_from_jax, resnet_to_jax
from tests.test_torch_resnet import _close, _variables

ARGV = ["--device", "cpu", "--model", "resnet18", "--width", "8", "--num_classes", "10",
        "--image_size", "33", "--batch_size", "4", "--epochs", "2", "--warmup_epochs", "0.5"]
STEPS_PER_EPOCH = 4
TOL = 1e-4   # of each tensor's largest magnitude, f32 on both sides


def _batches(n, size=33):
    rng = np.random.default_rng(0)
    return [{"image": rng.normal(size=(4, size, size, 3)).astype(np.float32),
             "label": rng.integers(0, 10, (4,)).astype(np.int32)} for _ in range(n)]


def test_trainer_steps_match_the_jax_example():
    args = train_resnet.parse_args(ARGV)
    flax_model = jresnet.ResNet18(num_classes=10, width=8, dtype=jnp.float32)
    params, stats = _variables(flax_model, 33)
    batches = _batches(3)

    lr = jscale_lr_for_batch(args.base_lr, args.batch_size, base_batch=256)
    schedule = jcosine_warmup(lr, total_steps=args.epochs * STEPS_PER_EPOCH,
                              warmup_steps=int(args.warmup_epochs * STEPS_PER_EPOCH))
    tx = optax.chain(optax.add_decayed_weights(args.weight_decay),
                     optax.sgd(schedule, momentum=args.momentum, nesterov=True))

    @jax.jit
    def jstep(params, stats, opt, image, label):
        def loss_fn(p):
            logits, mut = flax_model.apply({"params": p, "batch_stats": stats}, image,
                                           train=True, mutable=["batch_stats"])
            labels = optax.smooth_labels(jax.nn.one_hot(label, 10), args.label_smoothing)
            return optax.softmax_cross_entropy(logits, labels).mean(), mut["batch_stats"]

        (loss, new_stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt = tx.update(grads, opt, params)
        return optax.apply_updates(params, updates), new_stats, opt, loss

    jp, js, jopt, jlosses = params, stats, tx.init(params), []
    for b in batches:
        jp, js, jopt, loss = jstep(jp, js, jopt, b["image"], b["label"])
        jlosses.append(float(loss))

    init_fn, trainer, tx_t, lr_t = train_resnet.build_trainer(args, torch.device("cpu"),
                                                              STEPS_PER_EPOCH)
    assert lr_t == lr
    state = trainer.create_state(init_fn, tx_t)
    state.model.load_state_dict(resnet_from_jax(params, stats))
    gen = torch.Generator().manual_seed(0)
    losses = []
    for b in batches:
        state, metrics = trainer.step_fn(state, trainer.to_device(b), gen)
        losses.append(float(metrics["loss"]))
        assert 0.0 <= float(metrics["top1"]) <= 1.0
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    got_params, got_stats = resnet_to_jax(state.model.state_dict())
    for (path, want), got in zip(jax.tree_util.tree_leaves_with_path((jp, js)),
                                 jax.tree.leaves((got_params, got_stats))):
        _close(got, want, TOL, jax.tree_util.keystr(path))
    assert state.extra is None and state.step == 3


def test_uint8_batch_is_normalised_on_the_device():
    args = train_resnet.parse_args(ARGV)
    loss_fn = train_resnet.make_loss_fn(args)
    init_fn, *_ = train_resnet.build_trainer(args, torch.device("cpu"))
    model = init_fn()[0].train()
    u8 = np.random.default_rng(1).integers(0, 256, (4, 33, 33, 3)).astype(np.uint8)
    label = torch.tensor([1, 2, 3, 4])
    with torch.no_grad():
        got, (extra, _) = loss_fn(model, None, {"image": torch.from_numpy(u8), "label": label},
                                  None)
    f32 = torch.from_numpy((u8[..., ::-1].astype(np.float32) - images.IMAGENET_MEAN)
                           / images.IMAGENET_STD)
    with torch.no_grad():
        want, _ = loss_fn(model, None, {"image": f32, "label": label}, None)
    assert extra is None and abs(float(got) - float(want)) <= 1e-6 * abs(float(want))


def test_metric_fn_is_per_example_ce_and_top1():
    logits = torch.tensor([[2.0, 0.5, -1.0], [0.1, 0.2, 3.0]])
    model = lambda image: logits  # noqa: E731
    out = train_resnet.metric_fn(model, None, {"image": None, "label": torch.tensor([0, 1])})
    want = optax.softmax_cross_entropy(logits.numpy(), jax.nn.one_hot(jnp.array([0, 1]), 3))
    np.testing.assert_allclose(out["val_loss"].numpy(), np.asarray(want), rtol=1e-6)
    assert out["val_top1"].tolist() == [1.0, 0.0]


@pytest.mark.parametrize("flag", [["--dgc", "0.99"], ["--data_service"], ["--dcn_dp", "2"],
                                  ["--profile_steps", "3:5"], ["--remat"]])
def test_unported_flags_raise(flag):
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1"):
        train_resnet.parse_args(ARGV + flag)


def test_synthetic_run_learns_resumes_and_dumps_every_epoch(tmp_path, monkeypatch, capsys):
    for var in [k for k in os.environ if k.startswith("EDL_TPU_")]:
        monkeypatch.delenv(var)
    monkeypatch.setenv("EDL_TPU_CKPT_DIR", str(tmp_path / "ckpt"))
    monkeypatch.setenv("EDL_TPU_DEMO_MARKER", str(tmp_path / "marker"))
    dump = tmp_path / "bench.json"
    argv = ["--device", "cpu", "--synthetic", "4", "--synthetic_per_file", "64",
            "--synthetic_files", "2", "--data_dir", str(tmp_path / "data"), "--model", "resnet18",
            "--width", "16", "--image_size", "32", "--batch_size", "16", "--base_lr", "0.05",
            "--warmup_epochs", "0.5", "--num_workers", "2", "--bench_dump", str(dump)]
    threads = torch.get_num_threads()
    torch.set_num_threads(2)      # the test runs beside others, each with its own threads
    try:
        train_resnet.main(argv + ["--epochs", "2"])
        first = json.loads(dump.read_text())
        state, meta = train_resnet.main(argv + ["--epochs", "3"])
    finally:
        torch.set_num_threads(threads)
    out = capsys.readouterr().out
    assert "resume_epoch=0" in out and "resume_epoch=2" in out
    bench = json.loads(dump.read_text())
    assert [r["epoch"] for r in first["epochs"]] == [0, 1]
    assert [r["epoch"] for r in bench["epochs"]] == [0, 1, 2]
    assert bench["epochs"][:2] == first["epochs"]       # the sidecar kept them
    assert bench["epochs"][-1]["val_top1"] >= 0.9, bench
    assert bench["world"] == 1 and bench["global_batch"] == 16
    assert state.step == 3 * 8 and meta.next_epoch == 3
    marker = (tmp_path / "marker").read_text().splitlines()
    assert marker[-1].startswith("done rank=0 world=1 epochs=[0, 1, 2]")
