"""The port's ResNet entry point (``edl_tpu_torch.train_resnet``): three
steps of its trainer (label-smoothed CE, Nesterov SGD with coupled weight
decay on the batch-scaled cosine-warmup schedule, BN running stats) against
the JAX example's step body; the masked step of the data service's ragged
epoch end against the JAX example's loss body (the BN update dropped on a
padded batch), alone and in a 2-rank world on the global batch (a linear
model and a ResNet18, whose BN runs over the world); ``--remat``; the loss
on a uint8 batch; the eval metrics; the unported flags; a synthetic run
that learns, resumes at the next epoch and dumps every epoch's record; an
in-process ``--data_service --data_leader`` run through a leader failover;
and an in-process ``--data_service`` run that
stops after a mid-epoch save, resumes in a new cluster stage and trains
every record exactly once."""

import contextlib
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
from edl_tpu_torch.cluster import paths
from edl_tpu_torch.cluster.cluster import Cluster
from edl_tpu_torch.cluster.env import TrainerEnv
from edl_tpu_torch.cluster.pod import Pod
from edl_tpu_torch.cluster.state import DataCheckpoint
from edl_tpu_torch.coord.memory import MemoryKV
from edl_tpu_torch.data import images
from edl_tpu_torch.data.data_server import DataService
from edl_tpu_torch.data.elastic_input import device_put_stream
from edl_tpu_torch.data.journal import DataJournal
from edl_tpu_torch.models import resnet
from edl_tpu_torch.models.convert import resnet_from_jax, resnet_to_jax
from edl_tpu_torch.rpc.server import RpcServer
from edl_tpu_torch.train.checkpoint import CheckpointManager
from edl_tpu_torch.utils import constants
from edl_tpu_torch.utils.device import NoCardError
from tests.helpers.exactly_once import audit_spans
from tests.test_torch_resnet import _close, _variables
from tests.test_torch_sync_bn import check_rank_against_jax, jax_global_step, spawn_world

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
    for b, _ in device_put_stream(batches, trainer.device):
        state, metrics = trainer.step_fn(state, b, gen)
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


@pytest.mark.parametrize("flag", [["--dgc", "0.99"], ["--profile_steps", "3:5"]])
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


def test_a_cuda_run_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(NoCardError):
        train_resnet.main(ARGV[2:])      # the default --device cuda


# -- the masked step and --remat ----------------------------------------------------

MASK_BATCH, MASK_CLASSES = 8, 10


@pytest.mark.parametrize("padded", [True, False])
def test_masked_step_matches_the_jax_example_loss_body(padded):
    """ResNet18 (width 16, 32²) from the same weights, on a batch whose last
    3 rows are padding (zeros, mask 0) or on a full one: the port's loss,
    top-1, every gradient and the BN running stats against the JAX
    example's loss body (``examples/collective/train_resnet.py:230-250``)
    run in float64.  On the padded batch the stats come back as they were,
    to the bit; on the full one they move."""
    args = train_resnet.parse_args(["--device", "cpu", "--num_classes", str(MASK_CLASSES)])
    rng = np.random.default_rng(4)
    n_real = MASK_BATCH - 3 if padded else MASK_BATCH
    x = np.zeros((MASK_BATCH, 32, 32, 3), np.float32)
    x[:n_real] = rng.normal(size=(n_real, 32, 32, 3))
    y = np.zeros(MASK_BATCH, np.int32)
    y[:n_real] = rng.integers(0, MASK_CLASSES, n_real)
    mask = (np.arange(MASK_BATCH) < n_real).astype(np.float32)

    with jax.enable_x64(True):
        flax_model = jresnet.ResNet18(num_classes=MASK_CLASSES, width=16, dtype=jnp.float64)
        params, stats = _variables(flax_model, 32)

        @jax.jit
        def body(params, stats, image, label, mask):
            params = jax.tree.map(lambda a: a.astype(jnp.float64), params)
            stats = jax.tree.map(lambda a: a.astype(jnp.float64), stats)

            def loss_fn(p):
                logits, mutated = flax_model.apply({"params": p, "batch_stats": stats}, image,
                                                   train=True, mutable=["batch_stats"])
                labels = optax.smooth_labels(jax.nn.one_hot(label, MASK_CLASSES),
                                             args.label_smoothing)
                ce = optax.softmax_cross_entropy(logits, labels)
                hit = (logits.argmax(-1) == label).astype(jnp.float64)
                n = jnp.maximum(mask.sum(), 1.0)
                all_real = mask.min() > 0
                new = jax.tree.map(lambda a, b: jnp.where(all_real, a, b),
                                   mutated["batch_stats"], stats)
                return (ce * mask).sum() / n, (new, (hit * mask).sum() / n)

            (loss, (new, top1)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
            return loss, top1, new, grads

        want = jax.tree.map(np.asarray, body(params, stats, jnp.asarray(x, jnp.float64),
                                             jnp.asarray(y), jnp.asarray(mask, jnp.float64)))

    model = resnet.ResNet18(num_classes=MASK_CLASSES, width=16, dtype=torch.float32)
    model.load_state_dict(resnet_from_jax(params, stats))
    model.train()
    before = {k: v.clone() for k, v in model.named_buffers()}
    loss, (extra, metrics) = train_resnet.make_loss_fn(args)(
        model, None, {"image": torch.from_numpy(x), "label": torch.from_numpy(y),
                      "mask": torch.from_numpy(mask)}, None)
    loss.backward()
    assert extra is None
    _close(float(loss.detach()), want[0], TOL, "loss")
    assert float(metrics["top1"]) == pytest.approx(float(want[1]), abs=1e-12)
    got_stats = resnet_to_jax(dict(model.named_buffers()))[1]
    for (path, w), got in zip(jax.tree_util.tree_leaves_with_path(want[2]),
                              jax.tree.leaves(got_stats)):
        _close(got, w, TOL, f"batch_stats {jax.tree_util.keystr(path)}")
    got_grads = resnet_to_jax({k: p.grad for k, p in model.named_parameters()})[0]
    for (path, w), got in zip(jax.tree_util.tree_leaves_with_path(want[3]),
                              jax.tree.leaves(got_grads)):
        _close(got, w, TOL, f"grad {jax.tree_util.keystr(path)}")
    same = [torch.equal(v, before[k]) for k, v in model.named_buffers()]
    assert all(same) if padded else not any(same)


@pytest.mark.parametrize("masked", [False, True])
def test_remat_step_equals_a_plain_step(masked):
    """One trainer step with ``--remat`` and one without, from the same
    weights on the same batch: the same loss, parameters and BN running
    stats (updated once: the recomputed forward leaves them alone); on a
    padded batch the remat step keeps the stats as they were."""
    batch = _batches(1)[0]
    if masked:
        batch["image"][-1] = 0.0
        batch["mask"] = np.asarray([1, 1, 1, 0], np.float32)
    out = {}
    for remat in (False, True):
        args = train_resnet.parse_args(ARGV + (["--remat"] if remat else []))
        init_fn, trainer, tx, _ = train_resnet.build_trainer(args, torch.device("cpu"),
                                                             STEPS_PER_EPOCH)
        state = trainer.create_state(init_fn, tx)
        initial = {k: v.clone() for k, v in state.model.named_buffers()}
        state, metrics = trainer.step_fn(state, {k: torch.from_numpy(v) for k, v in batch.items()},
                                         torch.Generator().manual_seed(0))
        out[remat] = (float(metrics["loss"]), state.model.state_dict(), initial)
    assert out[True][0] == pytest.approx(out[False][0], rel=1e-6)
    for k, v in out[False][1].items():
        torch.testing.assert_close(out[True][1][k], v, rtol=1e-5, atol=1e-6, msg=k)
    buffers = [k for k in out[True][2]]
    moved = [not torch.equal(out[True][1][k], out[True][2][k]) for k in buffers]
    assert not any(moved) if masked else all(moved)


# -- the masked step in a 2-rank world ------------------------------------------------

WORLD_SHARES = [(5, 0), (6, 2), (6, 6)]   # real rows of each rank's 6-row share a step
WORLD_BATCH, WORLD_CLASSES, WORLD_SIZE = 6, 5, 4

_WORLD_RANK = r"""
import contextlib, sys
import numpy as np, torch, torch.distributed as dist
from edl_tpu_torch import train_resnet
from edl_tpu_torch.models import resnet
from edl_tpu_torch.train.state import sgd
from edl_tpu_torch.train.trainer import ElasticTrainer

rank, port, io = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2, rank=rank)
data = dict(np.load(f"{io}/in.npz"))


class Linear(torch.nn.Module):
    # no batch statistics: each rank's forward is its rows' part of the global batch's
    def __init__(self):
        super().__init__()
        self.dense = torch.nn.Linear(data["w"].shape[1], data["w"].shape[0], dtype=torch.float64)
        with torch.no_grad():
            self.dense.weight.copy_(torch.from_numpy(data["w"]))
            self.dense.bias.copy_(torch.from_numpy(data["b"]))

    def forward(self, x):
        return self.dense(x.reshape(len(x), -1))

    def stat_gate(self, gate):
        return contextlib.nullcontext()


trainer = ElasticTrainer(train_resnet.make_loss_fn(train_resnet.parse_args(["--device", "cpu"])),
                         device="cpu")
gen = torch.Generator().manual_seed(0)
out = {}
for i in range(int(data["n"])):
    label, mask = torch.from_numpy(data[f"y{i}"][rank]), torch.from_numpy(data[f"m{i}"][rank])
    state = trainer.create_state(lambda: (Linear(), None), sgd(0.1))
    state, metrics = trainer.step_fn(
        state, {"image": torch.from_numpy(data[f"x{i}"][rank]), "label": label, "mask": mask}, gen)
    out[f"loss{i}"], out[f"top1{i}"] = metrics["loss"].numpy(), metrics["top1"].numpy()
    out[f"gw{i}"] = state.model.dense.weight.grad.numpy()
    out[f"gb{i}"] = state.model.dense.bias.grad.numpy()
    model = resnet.ResNet18(num_classes=5, width=8, dtype=torch.float64)
    model.load_state_dict(torch.load(f"{io}/resnet18.pt"))
    before = [b.clone() for b in model.buffers()]
    state = trainer.create_state(lambda: (model, None), sgd(0.1))
    state, metrics = trainer.step_fn(
        state, {"image": torch.from_numpy(data[f"r{i}"][rank]), "label": label, "mask": mask}, gen)
    out[f"moved{i}"] = np.asarray([not torch.equal(a, b) for a, b in zip(before, model.buffers())])
    out[f"rn{i}/loss"], out[f"rn{i}/top1"] = metrics["loss"].numpy(), metrics["top1"].numpy()
    for k, p in model.named_parameters():
        out[f"rn{i}/grad/{k}"] = p.grad.numpy()
    for k, b in model.named_buffers():
        out[f"rn{i}/buffer/{k}"] = b.numpy()
np.savez(f"{io}/out{rank}.npz", **out)
dist.destroy_process_group()
"""


def test_masked_step_in_a_world_is_the_global_batch_step(tmp_path):
    """A 2-rank gloo world spawned by hand (a 120 s limit on each process),
    on steps whose ranks hold unequal shares of real rows, one of them none:
    the trainer's loss, top-1 and gradients equal the JAX example's loss body
    (``examples/collective/train_resnet.py:230-250``) on the concatenated
    global batch, in float64.  Two models: a linear classifier, which has
    no batch statistics and so isolates the loss's weighting, and a ResNet18
    (width 8, 16²), whose BN takes its statistics over the world's global
    batch as the JAX mesh does (``tests/test_torch_sync_bn.py``): its loss,
    top-1, every gradient and ``batch_stats`` against the flax model's.  The
    BN running stats stay on both ranks when any rank's share holds padding,
    and move on both when none does."""
    flax_model = jresnet.ResNet18(num_classes=WORLD_CLASSES, width=8, dtype=jnp.float64)
    params, stats = _variables(flax_model, 16)
    torch.save(resnet_from_jax(params, stats), tmp_path / "resnet18.pt")
    rng = np.random.default_rng(11)
    args = train_resnet.parse_args(["--device", "cpu"])
    feed = {"n": len(WORLD_SHARES),
            "w": rng.normal(size=(WORLD_CLASSES, WORLD_SIZE * WORLD_SIZE * 3)),
            "b": rng.normal(size=WORLD_CLASSES)}
    for i, shares in enumerate(WORLD_SHARES):
        real = np.arange(WORLD_BATCH)[None, :] < np.asarray(shares)[:, None]   # [rank, row]
        feed[f"x{i}"] = rng.normal(size=(2, WORLD_BATCH, WORLD_SIZE, WORLD_SIZE, 3)) * real[..., None, None, None]
        feed[f"r{i}"] = rng.normal(size=(2, WORLD_BATCH, 16, 16, 3)) * real[..., None, None, None]
        feed[f"y{i}"] = (rng.integers(0, WORLD_CLASSES, (2, WORLD_BATCH)) * real).astype(np.int32)
        feed[f"m{i}"] = real.astype(np.float32)
    np.savez(tmp_path / "in.npz", **feed)
    ranks = spawn_world(_WORLD_RANK, tmp_path)

    with jax.enable_x64(True):
        def body(w, b, image, label, mask):
            logits = image.reshape(len(image), -1) @ w.T + b
            labels = optax.smooth_labels(jax.nn.one_hot(label, WORLD_CLASSES),
                                         args.label_smoothing)
            ce = optax.softmax_cross_entropy(logits, labels)
            hit = (logits.argmax(-1) == label).astype(jnp.float64)
            n = jnp.maximum(mask.sum(), 1.0)
            return (ce * mask).sum() / n, (hit * mask).sum() / n

        grad = jax.jit(jax.value_and_grad(body, argnums=(0, 1), has_aux=True))
        for i, shares in enumerate(WORLD_SHARES):
            (loss, top1), (gw, gb) = jax.tree.map(np.asarray, grad(
                feed["w"], feed["b"], feed[f"x{i}"].reshape(2 * WORLD_BATCH, -1),
                feed[f"y{i}"].reshape(-1), feed[f"m{i}"].reshape(-1).astype(np.float64)))
            for rank, got in enumerate(ranks):
                what = f"shares {shares}, rank {rank}"
                _close(got[f"loss{i}"], loss, 1e-12, f"loss, {what}")
                assert float(got[f"top1{i}"]) == pytest.approx(float(top1), abs=1e-7), what
                _close(got[f"gw{i}"], gw, 1e-12, f"weight grad, {what}")
                _close(got[f"gb{i}"], gb, 1e-12, f"bias grad, {what}")
                moved = got[f"moved{i}"]
                assert (moved.all() if min(shares) == WORLD_BATCH else not moved.any()), what
        for i, shares in enumerate(WORLD_SHARES):
            want = jax_global_step(flax_model, params, stats,
                                   feed[f"r{i}"].reshape(2 * WORLD_BATCH, 16, 16, 3),
                                   feed[f"y{i}"].reshape(-1), feed[f"m{i}"].reshape(-1),
                                   WORLD_CLASSES, args.label_smoothing)
            for rank, got in enumerate(ranks):
                rn = {k[len(f"rn{i}/"):]: v for k, v in got.items() if k.startswith(f"rn{i}/")}
                check_rank_against_jax(rn, want, f"ResNet18, shares {shares}, rank {rank}")


# -- --data_service in one process ---------------------------------------------------

JOB = "rn-ds"
# 2 files of 21 records at bs 8: 5 full steps and one of 2 rows an epoch
DS_ARGV = ["--device", "cpu", "--data_service", "--synthetic", "4", "--synthetic_per_file", "21",
           "--synthetic_files", "2", "--model", "resnet18", "--width", "8", "--image_size",
           "32", "--batch_size", "8", "--epochs", "2", "--save_every_steps", "2",
           "--base_lr", "0.05", "--warmup_epochs", "0.5", "--num_workers", "2", "--no-eval"]
STOP_STEP = 8          # a mid-epoch save: epoch 1's second step


class _Stop(Exception):
    pass


@contextlib.contextmanager
def _launcher_stand_in():
    """What the launcher gives a trainer: a store, a DataService on an RPC
    server (journaled into the store unless ``EDL_TPU_DATA_JOURNAL=0``, as
    the JAX launcher hosts it), and a one-pod cluster record naming that
    server as the leader; ``new_stage()`` writes the record again with a new
    stage."""
    store = MemoryKV(sweep_period=0.1)
    srv = RpcServer("127.0.0.1", 0)
    srv.register_instance(DataService(
        journal=DataJournal(store, JOB) if constants.data_journal() else None))
    srv.start()

    def new_stage():
        cluster = Cluster.from_pods([Pod("pod-0", addr="127.0.0.1", port=srv.port)])
        store.put(paths.key(JOB, constants.ETCD_CLUSTER, "cluster"), cluster.to_json().encode())

    new_stage()
    try:
        yield store, new_stage
    finally:
        srv.stop()
        store.close()


def test_data_service_run_resumes_mid_epoch_exactly_once(tmp_path, monkeypatch):
    trained = []      # (epoch, file, begin, end): the spans the trainer marked
    masks = []
    mark = DataCheckpoint.mark_processed

    def marking(self, file_idx, begin, end):
        trained.append((int(self.reader_name.split("@e")[1].split("@")[0]), file_idx, begin, end))
        mark(self, file_idx, begin, end)

    monkeypatch.setattr(DataCheckpoint, "mark_processed", marking)
    make_loss_fn = train_resnet.make_loss_fn

    def recording_loss_fn(args):
        inner = make_loss_fn(args)

        def loss_fn(model, extra, batch, gen):
            masks.append(float(batch["mask"].sum()))
            return inner(model, extra, batch, gen)
        return loss_fn

    monkeypatch.setattr(train_resnet, "make_loss_fn", recording_loss_fn)
    save = CheckpointManager.save

    def stopping_save(self, step, state, meta=None, force=False):
        saved = save(self, step, state, meta, force)
        if step == STOP_STEP:
            raise _Stop(step)
        return saved

    monkeypatch.setattr(CheckpointManager, "save", stopping_save)
    argv = DS_ARGV + ["--data_dir", str(tmp_path / "data")]
    tenv = TrainerEnv({"EDL_TPU_JOB_ID": JOB, "EDL_TPU_POD_ID": "pod-0",
                       "EDL_TPU_CKPT_DIR": str(tmp_path / "ckpt")})
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        with _launcher_stand_in() as (store, new_stage):
            with pytest.raises(_Stop):
                train_resnet.train(train_resnet.parse_args(argv), torch.device("cpu"), tenv, store)
            before_stop = list(trained)
            monkeypatch.setattr(CheckpointManager, "save", save)
            new_stage()
            state, meta = train_resnet.train(train_resnet.parse_args(argv), torch.device("cpu"),
                                             tenv, store)
    finally:
        torch.set_num_threads(threads)
    for epoch in (0, 1):
        audit_spans([s[1:] for s in trained if s[0] == epoch], 2, 21)
    stopped = {(f, r) for e, f, b, t in before_stop if e == 1 for r in range(b, t)}
    resumed = {(f, r) for e, f, b, t in trained[len(before_stop):] for r in range(b, t)}
    assert len(stopped) == 16 and resumed == {(f, r) for f in range(2) for r in range(21)} - stopped
    assert masks == [8, 8, 8, 8, 8, 2] + [8, 8] + [8, 8, 8, 2]
    assert state.step == 12 and meta.next_epoch == 2
    assert [e.step_num for e in sorted(meta.epochs, key=lambda e: e.epoch_no)] == [6, 6]
    bench = meta.user_defined["bench"]
    assert [r["epoch"] for r in bench] == [0, 1] and all(r["decode_img_s"] > 0 for r in bench)


def test_data_leader_failover_trains_every_record_once(tmp_path, monkeypatch):
    """``--data_service --data_leader``: the trainer resolves the job's
    elected data leader (``data/leader.py``, a journaled DataService); after
    epoch 0's second step the seated leader stops while a standby contends,
    the standby takes the seat and rebuilds from the journal, and the
    trainer steps on: 2 epochs, every record of each trained exactly once."""
    import threading

    from edl_tpu_torch.data.leader import DataLeaderHost

    trained, failover = [], {}
    mark = DataCheckpoint.mark_processed

    def marking(self, file_idx, begin, end):
        trained.append((int(self.reader_name.split("@e")[1].split("@")[0]), file_idx, begin, end))
        mark(self, file_idx, begin, end)

    store = MemoryKV(sweep_period=0.1)
    hosts, threads = [], []

    def start():
        hosts.append(DataLeaderHost(store, JOB, host="127.0.0.1", rebuild_grace=1.0,
                                    retry_period=0.05))
        threads.append(threading.Thread(target=hosts[-1].run, daemon=True))
        threads[-1].start()

    def fail_over():
        start()
        hosts[0].stop()
        threads[0].join(timeout=10)
        failover["gone"] = True

    make_loss_fn = train_resnet.make_loss_fn

    def recording_loss_fn(args):
        inner = make_loss_fn(args)

        def loss_fn(model, extra, batch, gen):
            failover["steps"] = failover.get("steps", 0) + 1
            if failover["steps"] == 3:
                threading.Thread(target=fail_over).start()
            return inner(model, extra, batch, gen)
        return loss_fn

    monkeypatch.setattr(DataCheckpoint, "mark_processed", marking)
    monkeypatch.setattr(train_resnet, "make_loss_fn", recording_loss_fn)
    argv = DS_ARGV + ["--data_dir", str(tmp_path / "data"), "--data_leader"]
    tenv = TrainerEnv({"EDL_TPU_JOB_ID": JOB, "EDL_TPU_POD_ID": "pod-0",
                       "EDL_TPU_CKPT_DIR": str(tmp_path / "ckpt")})
    threads_before = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        start()
        cluster = Cluster.from_pods([Pod("pod-0", addr="127.0.0.1", port=1)])
        store.put(paths.key(JOB, constants.ETCD_CLUSTER, "cluster"), cluster.to_json().encode())
        state, meta = train_resnet.train(train_resnet.parse_args(argv), torch.device("cpu"),
                                         tenv, store)
        seated = [h.endpoint for h in hosts]
    finally:
        torch.set_num_threads(threads_before)
        for h in hosts:
            h.stop()
        for t in threads:
            t.join(timeout=10)
        store.close()
    assert failover.get("gone") and len(hosts) == 2 and seated[0] is None and seated[1]
    for epoch in (0, 1):
        audit_spans([s[1:] for s in trained if s[0] == epoch], 2, 21)
    assert state.step == 12 and meta.next_epoch == 2
