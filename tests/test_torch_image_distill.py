"""The port's image distillation (``edl_tpu_torch/train_image_distill.py`` and
``distill/teacher.py:module_teacher``) against the JAX package's
``examples/distill/train_image_distill.py`` on the CPU: ``module_teacher``
on converted weights against ``jit_teacher`` on the flax model; the noisy
labels against the example's flips; the distillation loss and its gradient
against the example's optax loss; student steps from converted weights
against the example's step; a teacher checkpoint round trip; the ``local``
role at toy size with the pairing audit on.  The ``slow`` twins of
``tests/test_image_distill_e2e.py``: the ``local`` role at the example's
defaults with its thresholds, and the ``student`` role under the unchanged
JAX launcher."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from edl_tpu.distill.teacher import jit_teacher
from edl_tpu.models import resnet as jresnet
from edl_tpu_torch import train_image_distill as tid
from edl_tpu_torch.distill.teacher import module_teacher
from edl_tpu_torch.models import resnet
from edl_tpu_torch.models.convert import resnet_from_jax, resnet_to_jax
from edl_tpu_torch.train.trainer import ElasticTrainer
from edl_tpu_torch.utils.device import NoCardError
from tests.test_torch_resnet import _close, _variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE_DIR = os.path.join(REPO, "examples", "distill")
SCRIPT = os.path.join(REPO, "edl_tpu_torch", "train_image_distill.py")
TOL = 1e-4   # of each tensor's largest magnitude, f32 on both sides (test_torch_resnet)
CPU = torch.device("cpu")


def _example():
    sys.path.insert(0, EXAMPLE_DIR)
    try:
        import train_image_distill as jex
    finally:
        sys.path.pop(0)
    return jex


def _toy_argv(tmp_path, *extra):
    return ["--device", "cpu", "--data_dir", str(tmp_path / "data"),
            "--teacher_dir", str(tmp_path / "teacher"), *extra]


@pytest.mark.parametrize("name", ["ResNet18", "ResNet18vd"])
def test_module_teacher_equals_jit_teacher(name):
    """Eval-mode logits of the port's module on converted weights against
    the JAX ``jit_teacher`` on the flax model (running BN statistics)."""
    fmodel = getattr(jresnet, name)(num_classes=10, width=8, dtype=jnp.float32)
    params, stats = _variables(fmodel, 32)
    x = np.random.default_rng(0).normal(size=(6, 32, 32, 3)).astype(np.float32)
    want = jit_teacher(fmodel.apply, {"params": params, "batch_stats": stats},
                       train=False)({"image": x})["logits"]
    model = getattr(resnet, name)(num_classes=10, width=8, dtype=torch.float32)
    model.load_state_dict(resnet_from_jax(params, stats))
    model.train()
    got = module_teacher(model, device="cpu")({"image": x})
    assert not model.training and got["logits"].dtype == np.float32
    _close(got["logits"], want, TOL, "teacher logits")


def test_module_teacher_feeds_in_sorted_key_order():
    class Sub(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.ones(()))

        def forward(self, a, b):
            return (a - b) * self.w

    out = module_teacher(Sub(), fetch_name="d")({"b": np.ones(3, np.float32),
                                                 "a": np.arange(3, dtype=np.float32)})
    np.testing.assert_array_equal(out["d"], [-1.0, 0.0, 1.0])
    with pytest.raises(NotImplementedError, match="item 6.5"):
        module_teacher(Sub(), mesh=object())


def test_noisy_labels_equal_the_examples_flips(tmp_path):
    jex = _example()
    args = tid.parse_args(_toy_argv(tmp_path, "--n_files", "2", "--per_file", "32"))
    train_files, _ = tid.ensure_data(args)
    jargs = jex.parse_args(["--data_dir", args.data_dir, "--n_files", "2", "--per_file", "32"])
    for rank in (0, 1):
        ours = list(tid.image_batches(args, train_files, 100, noise=0.65, rank=rank))
        theirs = list(jex.image_batches(jargs, train_files, 100, noise=0.65, rank=rank))
        assert len(ours) == len(theirs) == 4
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a["label"], b["label"])
            np.testing.assert_allclose(a["image"], b["image"], atol=1e-5)
    clean = [b["label"] for b in tid.image_batches(args, train_files, 100)]
    flipped = np.concatenate(clean) != np.concatenate([b["label"] for b in ours])
    assert 0.3 < flipped.mean() < 0.95


@pytest.mark.parametrize("with_teacher", [True, False])
def test_distill_loss_and_gradient_equal_the_examples(with_teacher):
    """The loss body of the example's ``train_student`` (optax) on the same
    logits: the loss and its gradient in the logits, f32, to 1e-6."""
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(8, 10)).astype(np.float32) * 3
    teacher = rng.normal(size=(8, 10)).astype(np.float32) * 3
    labels = rng.integers(0, 10, 8).astype(np.int32)
    alpha, T = 0.05, 2.0

    def jloss(lg):
        hard = optax.softmax_cross_entropy_with_integer_labels(lg, labels).mean()
        if not with_teacher:
            return hard
        soft = optax.softmax_cross_entropy(lg / T, jax.nn.softmax(teacher / T)).mean() * (T * T)
        return alpha * hard + (1 - alpha) * soft

    want, want_grad = jax.value_and_grad(jloss)(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    got = tid.distill_loss(x, torch.from_numpy(labels),
                           torch.from_numpy(teacher) if with_teacher else None, alpha, T)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad), rtol=1e-6,
                               atol=1e-6 * float(np.abs(want_grad).max()))


def test_student_steps_match_the_jax_example():
    """Two student steps (the example's loss, ``optax.sgd(base_lr,
    momentum=0.9)``) from converted weights: the losses and the updated
    parameters and BN statistics."""
    args = tid.parse_args(["--device", "cpu", "--classes", "10", "--width", "8"])
    fmodel = jresnet.ResNet18vd(num_classes=10, width=8, dtype=jnp.float32)
    params, stats = _variables(fmodel, 32)
    rng = np.random.default_rng(4)
    batches = [{"image": rng.normal(size=(4, 32, 32, 3)).astype(np.float32),
                "label": rng.integers(0, 10, (4,)).astype(np.int32),
                "teacher_logits": rng.normal(size=(4, 10)).astype(np.float32)}
               for _ in range(2)]
    T, alpha = args.temperature, args.alpha
    tx = optax.sgd(args.base_lr, momentum=0.9)

    @jax.jit
    def jstep(params, stats, opt, batch):
        def loss_fn(p):
            logits, mut = fmodel.apply({"params": p, "batch_stats": stats}, batch["image"],
                                       train=True, mutable=["batch_stats"])
            hard = optax.softmax_cross_entropy_with_integer_labels(
                logits, batch["label"]).mean()
            soft = optax.softmax_cross_entropy(
                logits / T, jax.nn.softmax(batch["teacher_logits"] / T)).mean() * (T * T)
            return alpha * hard + (1 - alpha) * soft, mut["batch_stats"]

        (loss, new_stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt = tx.update(grads, opt, params)
        return optax.apply_updates(params, updates), new_stats, opt, loss

    jp, js, jopt, jlosses = params, stats, tx.init(params), []
    for b in batches:
        jp, js, jopt, loss = jstep(jp, js, jopt, b)
        jlosses.append(float(loss))

    model = resnet.ResNet18vd(num_classes=10, width=8, dtype=torch.float32)
    model.load_state_dict(resnet_from_jax(params, stats))
    trainer = ElasticTrainer(tid.make_student_loss_fn(args), device=CPU)
    state = trainer.create_state(lambda: (model, None), tid._optimizer(args))
    losses = []
    for b in batches:
        state, metrics = trainer.step_fn(state, {k: torch.from_numpy(v) for k, v in b.items()},
                                         torch.Generator())
        losses.append(float(metrics["loss"]))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    got_params, got_stats = resnet_to_jax(state.model.state_dict())
    for (path, want), got in zip(jax.tree_util.tree_leaves_with_path((jp, js)),
                                 jax.tree.leaves((got_params, got_stats))):
        _close(got, want, TOL, jax.tree_util.keystr(path))


def test_teacher_checkpoint_round_trip(tmp_path):
    args = tid.parse_args(_toy_argv(tmp_path, "--n_files", "1", "--per_file", "32",
                                    "--teacher_epochs", "1", "--width", "8"))
    train_files, val_files = tid.ensure_data(args)
    model, state = tid.train_teacher(args, train_files, CPU)
    assert state.step == 2
    with pytest.raises(FileNotFoundError, match="no teacher checkpoint"):
        tid.load_teacher(args, CPU)
    tid.save_teacher(args, state)
    loaded, lstate = tid.load_teacher(args, CPU)
    assert lstate.step == 2
    for (k, a), b in zip(model.state_dict().items(), loaded.state_dict().values()):
        assert torch.equal(a, b), k
    assert 0.0 <= tid.eval_model(args, loaded, val_files, CPU) <= 1.0


def test_teacher_train_and_serve_roles_feed_the_jax_reader(coord_server, tmp_path,
                                                          monkeypatch):
    """``--role teacher_train`` saves a teacher; ``--role serve`` (a
    subprocess on the JAX coordination server) restores and serves it until
    SIGTERM; the JAX package's DistillReader, through the JAX discovery
    server, gets that teacher's logits for its images."""
    import signal

    from edl_tpu.coord.client import CoordClient as JaxCoordClient
    from edl_tpu.distill import reader as jreader
    from edl_tpu.distill.discovery import DiscoveryServer as JaxDiscoveryServer

    argv = _toy_argv(tmp_path, "--n_files", "1", "--per_file", "32", "--width", "8",
                     "--teacher_epochs", "1", "--service", "role-svc")
    assert tid.main(argv + ["--role", "teacher_train"]) == {}
    teacher, _ = tid.load_teacher(tid.parse_args(argv), CPU)
    ep = f"127.0.0.1:{coord_server.port}"
    env = {k: v for k, v in os.environ.items() if not k.startswith("EDL_TPU_")}
    env.update(PYTHONPATH=REPO, EDL_TPU_HOST_IP="127.0.0.1", OMP_NUM_THREADS="2")
    log = tmp_path / "serve.log"
    with open(log, "w") as f:
        proc = subprocess.Popen([sys.executable, "-m", "edl_tpu_torch.train_image_distill",
                                 *argv, "--role", "serve", "--coord_endpoints", ep],
                                cwd=REPO, env=env, stdout=f, stderr=subprocess.STDOUT)
    store = JaxCoordClient(ep)
    disc = JaxDiscoveryServer(store, host="127.0.0.1")
    monkeypatch.setattr(jreader, "_NOP_PREDICT_TEST", False)
    x = np.random.default_rng(5).normal(size=(8, 32, 32, 3)).astype(np.float32)
    try:
        dr = jreader.DistillReader(ins=["image"], predicts=["logits"], teacher_batch_size=4)
        dr.set_dynamic_teacher(disc.endpoint, "role-svc")
        dr.set_batch_generator(lambda: iter([(x,)]))
        [(image, logits)] = list(dr())
        with torch.inference_mode():
            want = teacher.eval()(torch.from_numpy(x)).numpy()
        _close(logits, want, TOL, "served logits")
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0, log.read_text()[-3000:]
        assert '"rows": 8' in log.read_text()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        disc.stop()
        store.close()


def test_local_role_at_toy_size_with_the_pairing_audit(tmp_path, monkeypatch):
    """The whole flow in one process: the teacher, two servers behind a
    discovery server, the distilled student (every batch's logits audited
    against the teacher's own forward) and the baseline."""
    monkeypatch.setenv("EDL_TPU_DISTILL_VERIFY", "1")
    out = tmp_path / "summary.json"
    summary = tid.main(_toy_argv(tmp_path, "--n_files", "2", "--per_file", "32", "--width", "8",
                                 "--teacher_epochs", "1", "--student_epochs", "1",
                                 "--out", str(out)))
    assert set(summary) == {"teacher_top1", "distill_top1", "baseline_top1", "gain",
                            "distill_img_s", "teacher_rows_per_s", "teacher_rows",
                            "teacher_forward_passes"}
    assert summary["teacher_rows"] == 64 and summary["teacher_forward_passes"] >= 4
    assert json.loads(out.read_text()) == summary
    assert tid._DEBUG_TEACHER is None


def test_entry_point_runs_on_the_card_unless_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(NoCardError):
        tid.main(["--data_dir", str(tmp_path / "data")])
    assert not (tmp_path / "data").exists()


@pytest.mark.slow
def test_local_distill_beats_noisy_baseline(tmp_path):
    """The twin of ``test_image_distill_e2e.py``'s local case, at the
    example's defaults and with its thresholds."""
    out = str(tmp_path / "summary.json")
    summary = tid.main(_toy_argv(tmp_path, "--out", out))
    assert summary["teacher_top1"] >= 0.9, summary
    assert summary["gain"] >= 0.3, summary
    assert summary["distill_top1"] >= 0.7, summary
    assert summary["teacher_rows"] > 0 and summary["teacher_rows_per_s"] > 0
    assert summary["teacher_forward_passes"] > 0
    assert json.load(open(out))["gain"] == summary["gain"]


@pytest.mark.slow
def test_student_under_elastic_launcher(coord_server, tmp_path):
    """The port's teacher fleet and discovery server in-process on the JAX
    coordination server; the port's student runs under the unchanged JAX
    launcher and distils through dynamic discovery, for the example's
    default 4 epochs (the JAX twin runs 3)."""
    from edl_tpu_torch.coord.client import CoordClient
    from edl_tpu_torch.distill.discovery import DiscoveryServer
    from tests.test_launch_integration import FAST, finish

    ep = f"127.0.0.1:{coord_server.port}"
    store = CoordClient(ep)
    args = tid.parse_args(_toy_argv(tmp_path))
    train_files, _val = tid.ensure_data(args)
    tmodel, _ = tid.train_teacher(args, train_files, CPU)
    disc = DiscoveryServer(store, host="127.0.0.1")
    server = tid.serve_teacher(args, store, CPU, model=tmodel, block=False)
    env = {k: v for k, v in os.environ.items() if not k.startswith("EDL_TPU_")}
    env.update(FAST)
    env.update({"PYTHONPATH": REPO + os.pathsep + env.get("PYTHONPATH", ""),
                "JAX_PLATFORMS": "cpu", "EDL_TPU_HOST_IP": "127.0.0.1",
                # the port forms stop-resume worlds only (no live reshard)
                "EDL_TPU_RESIZE_DELTA": "0", "OMP_NUM_THREADS": "2",
                "EDL_TPU_DEMO_MARKER": str(tmp_path / "marker")})
    log = open(tmp_path / "launcher.log", "wb")
    proc = subprocess.Popen(
        [sys.executable, "-m", "edl_tpu.collective.launch",
         "--job_id", "img-distill-torch", "--coord_endpoints", ep,
         "--nodes_range", "1:1", "--nproc_per_node", "1",
         "--log_dir", str(tmp_path / "log"), SCRIPT, "--",
         "--role", "student", "--device", "cpu", "--data_dir", args.data_dir,
         "--discovery", disc.endpoint, "--student_epochs", "4"],
        env=env, cwd=str(tmp_path), stdout=log, stderr=subprocess.STDOUT)
    proc._logfile = log  # noqa: SLF001
    try:
        assert finish(proc, 420) == 0, \
            (tmp_path / "launcher.log").read_text(errors="replace")[-3000:]
    finally:
        if proc.poll() is None:
            proc.kill()
        server.stop()
        disc.stop()
        store.close()
    marker = (tmp_path / "marker").read_text()
    rec = json.loads([line for line in marker.splitlines()
                      if line.startswith("done ")][-1][5:])
    assert rec["val_top1"] >= 0.7, rec
    assert rec["distill_img_s"] > 0 and rec["world"] == 1, rec
    assert server.stats()["rows"] > 0
