"""One batch norm over the world (``models/resnet.py:_WorldBatchNorm``).

A 2-rank gloo world spawned by hand (a 120 s limit on each process) takes
one trainer step of a float64 ResNet18 (width 8, 32², 4 rows a rank) from
the same weights, on a full share and on a share padded on one rank (mask
zeros, zero rows), with and without ``--remat``.  It is held against the
JAX example's loss body (``examples/collective/train_resnet.py:230-249``,
flax in float64) on the concatenated 8-row global batch: the loss, top-1,
every gradient and ``batch_stats``.  Both ranks hold equal running stats,
and the remat step updates them once.  At world 1, with no group and in a
gloo group of one, the step is bit-identical to the pre-repair
``native_batch_norm`` path and issues no collective."""

import contextlib
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F

from edl_tpu.models import resnet as jresnet
from edl_tpu_torch import train_resnet
from edl_tpu_torch.models import resnet
from edl_tpu_torch.models.convert import resnet_from_jax, resnet_to_jax
from tests.test_torch_resnet import _close, _variables

CLASSES, WIDTH, SIZE, ROWS = 10, 8, 32, 4      # ROWS: a rank's share
# |port - flax| <= TOL * max |flax| per tensor: the port's float64 model
# returns f32 logits, so it is held to f32's rounding (test_torch_resnet.py)
TOL = 1e-6
CASES = ("full", "padded")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_global_step(flax_model, params, stats, x, y, mask, classes, smoothing):
    """The JAX example's masked loss body on one global batch, in float64:
    ``(loss, top1, new batch_stats, grads)`` as numpy; the stats are kept
    when any row is padding."""
    with jax.enable_x64(True):
        @jax.jit
        def body(params, stats, image, label, mask):
            params = jax.tree.map(lambda a: a.astype(jnp.float64), params)
            stats = jax.tree.map(lambda a: a.astype(jnp.float64), stats)

            def loss_fn(p):
                logits, mutated = flax_model.apply({"params": p, "batch_stats": stats}, image,
                                                   train=True, mutable=["batch_stats"])
                labels = optax.smooth_labels(jax.nn.one_hot(label, classes), smoothing)
                ce = optax.softmax_cross_entropy(logits, labels)
                hit = (logits.argmax(-1) == label).astype(jnp.float64)
                n = jnp.maximum(mask.sum(), 1.0)
                all_real = mask.min() > 0
                new = jax.tree.map(lambda a, b: jnp.where(all_real, a, b),
                                   mutated["batch_stats"], stats)
                return (ce * mask).sum() / n, (new, (hit * mask).sum() / n)

            (loss, (new, top1)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
            return loss, top1, new, grads

        return jax.tree.map(np.asarray, body(params, stats, jnp.asarray(x, jnp.float64),
                                             jnp.asarray(y), jnp.asarray(mask, jnp.float64)))


def check_rank_against_jax(got: dict, want, what: str) -> None:
    """``got``: a rank's ``loss``, ``top1``, ``grad/<name>`` and
    ``buffer/<name>`` arrays (the port's names) against ``want``, the
    output of :func:`jax_global_step`."""
    _close(got["loss"], want[0], TOL, f"loss, {what}")
    # a share of hits, in the mask's dtype (f32 in the trainer's batches)
    assert float(got["top1"]) == pytest.approx(float(want[1]), abs=1e-7), what
    buffers = {k[len("buffer/"):]: torch.from_numpy(v) for k, v in got.items()
               if k.startswith("buffer/")}
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want[2]),
                            jax.tree.leaves(resnet_to_jax(buffers)[1])):
        _close(g, w, TOL, f"batch_stats {jax.tree_util.keystr(path)}, {what}")
    grads = {k[len("grad/"):]: torch.from_numpy(v) for k, v in got.items()
             if k.startswith("grad/")}
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want[3]),
                            jax.tree.leaves(resnet_to_jax(grads)[0])):
        _close(g, w, TOL, f"grad {jax.tree_util.keystr(path)}, {what}")


def spawn_world(script: str, io, world: int = 2, timeout: float = 120.0) -> list[dict]:
    """Run ``script`` as ranks ``0..world-1`` of a gloo world (argv: rank,
    port, ``io``), each within ``timeout`` seconds, its output in a log
    file; returns each rank's ``out<rank>.npz``."""
    from edl_tpu_torch.utils.network import find_free_port

    port = find_free_port()
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
    procs = []
    try:
        for rank in range(world):
            log = open(io / f"rank{rank}.log", "w")
            procs.append(subprocess.Popen(
                [sys.executable, "-c", script, str(rank), str(port), str(io)],
                cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT))
        for rank, p in enumerate(procs):
            rc = p.wait(timeout=timeout)
            assert rc == 0, (io / f"rank{rank}.log").read_text()[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [dict(np.load(io / f"out{rank}.npz")) for rank in range(world)]


_RANK = r"""
import sys
import numpy as np, torch, torch.distributed as dist
from edl_tpu_torch import train_resnet
from edl_tpu_torch.models import resnet
from edl_tpu_torch.train.state import sgd
from edl_tpu_torch.train.trainer import ElasticTrainer

rank, port, io = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2, rank=rank)
data = dict(np.load(f"{io}/in.npz"))
weights = torch.load(f"{io}/weights.pt")
out = {}
for remat in (False, True):
    args = train_resnet.parse_args(["--device", "cpu", "--num_classes", str(int(data["classes"]))]
                                   + (["--remat"] if remat else []))
    trainer = ElasticTrainer(train_resnet.make_loss_fn(args), device="cpu")
    for case in ("full", "padded"):
        model = resnet.ResNet18(num_classes=int(data["classes"]), width=int(data["width"]),
                                dtype=torch.float64)
        model.load_state_dict(weights)
        state = trainer.create_state(lambda: (model, None), sgd(0.1))
        batch = {k: torch.from_numpy(data[f"{case}_{k}"][rank]) for k in ("image", "label", "mask")}
        state, metrics = trainer.step_fn(state, batch, torch.Generator().manual_seed(0))
        tag = f"{case}{'_remat' if remat else ''}"
        out[f"{tag}/loss"], out[f"{tag}/top1"] = metrics["loss"].numpy(), metrics["top1"].numpy()
        for k, p in state.model.named_parameters():
            out[f"{tag}/grad/{k}"] = p.grad.numpy()
        for k, b in state.model.named_buffers():
            out[f"{tag}/buffer/{k}"] = b.numpy()
np.savez(f"{io}/out{rank}.npz", **out)
dist.destroy_process_group()
"""


def _case(rng, padded: bool):
    """``[rank, row, ...]`` arrays of one step: rank 1's last 3 rows are
    padding (zeros, label 0, mask 0) when ``padded``."""
    real = np.ones((2, ROWS), bool)
    if padded:
        real[1, 1:] = False
    x = rng.normal(size=(2, ROWS, SIZE, SIZE, 3)) * real[..., None, None, None]
    y = rng.integers(0, CLASSES, (2, ROWS)) * real
    return {"image": x.astype(np.float64), "label": y.astype(np.int32),
            "mask": real.astype(np.float64)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The flax model and weights, the steps' inputs and both ranks' outputs."""
    io = tmp_path_factory.mktemp("sync_bn")
    flax_model = jresnet.ResNet18(num_classes=CLASSES, width=WIDTH, dtype=jnp.float64)
    params, stats = _variables(flax_model, SIZE)
    rng = np.random.default_rng(21)
    cases = {c: _case(rng, c == "padded") for c in CASES}
    torch.save(resnet_from_jax(params, stats), io / "weights.pt")
    np.savez(io / "in.npz", classes=CLASSES, width=WIDTH,
             **{f"{c}_{k}": v for c, d in cases.items() for k, v in d.items()})
    ranks = spawn_world(_RANK, io)
    return flax_model, params, stats, cases, [
        {tag: {k[len(tag) + 1:]: v for k, v in r.items() if k.startswith(tag + "/")}
         for tag in ("full", "padded", "full_remat", "padded_remat")} for r in ranks]


@pytest.mark.parametrize("case", CASES)
def test_world_step_is_the_global_batch_step(world, case):
    flax_model, params, stats, cases, ranks = world
    d = cases[case]
    want = jax_global_step(flax_model, params, stats, d["image"].reshape(2 * ROWS, SIZE, SIZE, 3),
                           d["label"].reshape(-1), d["mask"].reshape(-1), CLASSES,
                           train_resnet.parse_args([]).label_smoothing)
    for rank, got in enumerate(ranks):
        check_rank_against_jax(got[case], want, f"{case} share, rank {rank}")


@pytest.mark.parametrize("case", CASES)
def test_ranks_hold_equal_running_stats(world, case):
    *_, ranks = world
    a, b = ranks[0][case], ranks[1][case]
    buffers = [k for k in a if k.startswith("buffer/")]
    assert buffers and all(np.array_equal(a[k], b[k]) for k in buffers)


@pytest.mark.parametrize("case", CASES)
def test_remat_step_updates_the_running_stats_once(world, case):
    """The recomputed forward repeats the statistics' all-reduce but not the
    running-stat update: the remat step is the plain step."""
    *_, ranks = world
    for got in ranks:
        plain, remat = got[case], got[f"{case}_remat"]
        assert set(plain) == set(remat)
        for k in plain:
            _close(remat[k], plain[k], 1e-12, f"{k}, {case}")


def _pre_repair_forward(self, x):
    """``BatchNorm.forward`` as it stood before the world branch."""
    if not self.training:
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            training=False, eps=resnet.BN_EPS)
    out, mean, invstd = torch.native_batch_norm(x, self.weight, self.bias, None, None,
                                                True, 0.0, resnet.BN_EPS)
    gate = self.stat_gate
    if isinstance(gate, torch.Tensor) or gate:
        weight = resnet.BN_MOMENTUM * gate
        with torch.no_grad():
            var = invstd.to(self.running_var.dtype).pow(-2) - resnet.BN_EPS
            self.running_mean.lerp_(mean.to(self.running_mean.dtype), weight)
            self.running_var.lerp_(var.clamp_min(0.0), weight)
    return out


@contextlib.contextmanager
def _gloo_group_of_one():
    from edl_tpu_torch.utils.network import find_free_port

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{find_free_port()}",
                            world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_world_of_one_is_the_native_path(monkeypatch):
    """A ResNet18 forward and backward in f32, with no group and in a gloo
    group of one, against the pre-repair forward: logits, every gradient and
    the running stats equal to the bit, and no collective from BN."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(4, SIZE, SIZE, 3)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, CLASSES, 4))

    def step():
        model = resnet.ResNet18(num_classes=CLASSES, width=WIDTH, dtype=torch.float32).train()
        logits = model(x)
        F.cross_entropy(logits, y).backward()
        return [logits.detach()] + [p.grad for p in model.parameters()] + list(model.buffers())

    with monkeypatch.context() as m:
        m.setattr(resnet.BatchNorm, "forward", _pre_repair_forward)
        want = step()
    calls = []
    reduce = dist.all_reduce
    monkeypatch.setattr(dist, "all_reduce", lambda *a, **k: (calls.append(a), reduce(*a, **k))[1])
    no_group = step()
    with _gloo_group_of_one():
        group_of_one = step()
    assert calls == []
    for got in (no_group, group_of_one):
        assert len(got) == len(want) and all(torch.equal(g, w) for g, w in zip(got, want))
