"""The port's linear regression and its fit_a_line trainer against the JAX
package: ``LinearRegression`` and ``mse_loss`` against flax on the same
weights (forward and gradients, f32: the flax model has no other dtype),
the converter both ways, one epoch of ``train_linear``'s SGD steps against
the JAX example's step on the same batches, a stop-resume of the entry
point, its device default; and, ``slow``, the twins of
``tests/test_elastic_training_e2e.py``'s four launcher cases with the torch
trainer under the unchanged JAX launcher."""

import json
import os
import re
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from edl_tpu.models.linear import LinearRegression as JLinear, mse_loss as jmse
from edl_tpu_torch import train_linear as tl
from edl_tpu_torch.models.convert import linear_from_jax, linear_to_jax
from edl_tpu_torch.models.linear import LinearRegression, mse_loss
from edl_tpu_torch.train.trainer import ElasticTrainer
from edl_tpu_torch.utils.device import NoCardError
from tests.helpers.flax_trees import assert_bit_equal_trees, close, close_trees, random_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN = os.path.join(REPO, "edl_tpu_torch", "train_linear.py")
TOL = 1e-5      # f32 forward and gradients, of each tensor's largest magnitude
STEP_TOL = 1e-6  # w and b after an epoch of SGD steps, absolute
CPU = torch.device("cpu")


def test_linear_regression_matches_flax():
    """``tests/test_models.py:23``'s shapes: [2, 13] -> [2, 1]."""
    fmodel = JLinear()
    x = np.random.default_rng(0).normal(size=(2, 13)).astype(np.float32)
    y = np.random.default_rng(1).normal(size=(2, 1)).astype(np.float32)
    params = random_tree(jax.eval_shape(lambda: fmodel.init(jax.random.key(0), x))["params"])

    @jax.jit
    def run(p):
        return jax.value_and_grad(lambda p: jmse(fmodel.apply({"params": p}, x), y))(p), \
            fmodel.apply({"params": p}, x)

    (loss, grads), out = run(params)
    model = LinearRegression()
    model.load_state_dict(linear_from_jax(params))
    got = model(torch.from_numpy(x))
    close(got.detach().numpy(), out, TOL, "forward")
    tloss = mse_loss(got, torch.from_numpy(y))
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(loss), rtol=TOL)
    close_trees(linear_to_jax({k: p.grad for k, p in model.named_parameters()}),
                jax.tree.map(np.asarray, grads), TOL, "grad")
    # the converter both ways, to the bit
    assert_bit_equal_trees(linear_to_jax(model.state_dict()), params)


def _example_epoch(args, epoch, pod_rank, w_true):
    """The JAX example's ``data_fn(epoch)`` (its lines, run here)."""
    erng = np.random.default_rng(1000 + epoch * 100 + pod_rank)
    for _ in range(args.steps_per_epoch):
        x = erng.normal(size=(args.batch_size, 13)).astype(np.float32)
        yield {"x": x, "y": x @ w_true}


def test_an_epoch_of_sgd_steps_matches_the_jax_example():
    """One epoch (8 steps of 16 rows) from the example's zero init with its
    ``optax.sgd(lr)`` and loss body: ``w`` and ``b`` within 1e-6."""
    args = tl.parse_args(["--device", "cpu"])
    w_true = tl.true_w()
    np.testing.assert_array_equal(w_true, np.random.default_rng(0).normal(size=(13, 1))
                                  .astype(np.float32))
    ours = list(tl.batches(args, 1, 0, w_true))
    theirs = list(_example_epoch(args, 1, 0, w_true))
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a["x"], b["x"])
        np.testing.assert_array_equal(a["y"], b["y"])
    from edl_tpu_torch.train.lr import scale_lr_for_batch
    lr = scale_lr_for_batch(args.base_lr, args.batch_size, base_batch=16)   # world 1
    tx = optax.sgd(lr)

    @jax.jit
    def jstep(params, opt, batch):
        def loss_fn(p):
            return jnp.mean((batch["x"] @ p["w"] + p["b"] - batch["y"]) ** 2)
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt = tx.update(grads, opt, params)
        return optax.apply_updates(params, updates), opt, loss

    params = {"w": jnp.zeros((13, 1)), "b": jnp.zeros((1,))}
    opt, jlosses = tx.init(params), []
    for b in theirs:
        params, opt, loss = jstep(params, opt, b)
        jlosses.append(float(loss))

    from edl_tpu_torch.train.state import sgd
    trainer = ElasticTrainer(tl.loss_fn, device=CPU)
    state = trainer.create_state(lambda: (tl.Regressor(), None),
                                 sgd(lr, momentum=0.0, nesterov=False))
    losses = []
    for b in ours:
        state, metrics = trainer.step_fn(state, {k: torch.from_numpy(v) for k, v in b.items()},
                                         torch.Generator())
        losses.append(float(metrics["loss"]))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    np.testing.assert_allclose(state.model.w.detach().numpy(), np.asarray(params["w"]),
                               atol=STEP_TOL, rtol=0)
    np.testing.assert_allclose(state.model.b.detach().numpy(), np.asarray(params["b"]),
                               atol=STEP_TOL, rtol=0)


def test_two_epochs_then_a_resume(tmp_path, monkeypatch):
    """A 2-epoch run, then the same call with ``--epochs 4``: it resumes at
    epoch 2, ``w_err`` falls, and the marker line is the example's."""
    for k in [k for k in os.environ if k.startswith("EDL_TPU_")]:
        monkeypatch.delenv(k)
    monkeypatch.setenv("EDL_TPU_CKPT_DIR", str(tmp_path / "ckpt"))
    monkeypatch.setenv("EDL_TPU_DEMO_MARKER", str(tmp_path / "marker"))
    first = tl.main(["--device", "cpu", "--epochs", "2"])
    second = tl.main(["--device", "cpu", "--epochs", "4"])
    assert first["resume_epoch"] == 0 and first["epochs"] == [0, 1]
    assert second["resume_epoch"] == 2 and second["epochs"] == [0, 1, 2, 3]
    assert second["w_err"] < first["w_err"] < 0.1, (first["w_err"], second["w_err"])
    done = (tmp_path / "marker").read_text().splitlines()
    m = re.search(r"world=(\d+) epochs=\[([0-9, ]+)\] w_err=([0-9.]+)", done[-1])
    assert done[-1].startswith("done rank=0 ") and m, done
    assert m.group(1) == "1" and float(m.group(3)) == round(second["w_err"], 5)


def test_entry_point_runs_on_the_card_unless_asked(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    monkeypatch.setenv("EDL_TPU_CKPT_DIR", str(tmp_path / "ckpt"))
    with pytest.raises(NoCardError):
        tl.main([])
    assert not (tmp_path / "ckpt").exists()


# -- the launcher cases (slow): tests/test_elastic_training_e2e.py's twins ------

def spawn(job_id, coord_ep, tmp, name, ckpt_dir, extra_env=None, epochs="10", steps="4"):
    """A JAX launcher with one torch ``train_linear`` trainer (stop-resume:
    ``EDL_TPU_RESIZE_DELTA=0``, as the JAX trainers of the originals)."""
    from tests.test_launch_integration import FAST
    env = {k: v for k, v in os.environ.items() if not k.startswith("EDL_TPU_")}
    env.update(FAST)
    env.update({"PYTHONPATH": REPO + os.pathsep + env.get("PYTHONPATH", ""),
                "JAX_PLATFORMS": "cpu", "EDL_TPU_HOST_IP": "127.0.0.1",
                "EDL_TPU_RESIZE_DELTA": "0", "EDL_TPU_DEMO_STEP_SLEEP": "0.25",
                "EDL_TPU_DEMO_MARKER": os.path.join(tmp, f"marker-{name}"),
                "OMP_NUM_THREADS": "2", **(extra_env or {})})
    log = open(os.path.join(tmp, f"launcher-{name}.log"), "wb")
    proc = subprocess.Popen(
        [sys.executable, "-m", "edl_tpu.collective.launch", "--job_id", job_id,
         "--coord_endpoints", coord_ep, "--nodes_range", "1:2", "--nproc_per_node", "1",
         "--checkpoint_dir", ckpt_dir, "--log_dir", os.path.join(tmp, f"log-{name}"), TRAIN,
         "--", "--device", "cpu", "--epochs", epochs, "--steps_per_epoch", steps],
        env=env, cwd=tmp, stdout=log, stderr=subprocess.STDOUT)
    proc._logfile = log  # noqa: SLF001
    return proc


def _logs(tmp) -> str:
    from tests.test_torch_launch_e2e import _logs as logs
    return logs(str(tmp))


def _committed(ckpt):
    return [d for d in (os.listdir(ckpt) if os.path.isdir(ckpt) else []) if d.isdigit()]


def _wait_for_checkpoints(ckpt, procs, n, deadline_s=180):
    deadline = time.time() + deadline_s
    while len(_committed(ckpt)) < n:
        assert time.time() < deadline, f"never committed {n} epoch checkpoints"
        for p in procs:
            assert p.poll() is None, "a pod died during warm-up"
        time.sleep(0.25)


def _finish_all(procs, timeout):
    from tests.test_launch_integration import finish
    try:
        return [finish(p, timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _complete_stages(ep, job):
    from edl_tpu.cluster.recovery import summarize_recovery
    from edl_tpu.coord.client import CoordClient
    client = CoordClient(ep)
    try:
        return [s for s in summarize_recovery(client, job) if "total" in s]
    finally:
        client.close()


def _status(ep, job):
    from edl_tpu.cluster.status import load_job_status
    from edl_tpu.coord.client import CoordClient
    client = CoordClient(ep)
    try:
        return load_job_status(client, job)
    finally:
        client.close()


def _done(marker):
    lines = [l for l in open(marker).read().splitlines() if l.startswith("done")]
    assert lines, marker
    m = re.search(r"world=(\d+) epochs=\[([0-9, ]+)\] w_err=([0-9.]+)", lines[-1])
    assert m, lines
    return int(m.group(1)), [int(x) for x in m.group(2).split(",")], float(m.group(3))


@pytest.mark.slow
def test_sigterm_preemption_checkpoint(coord_server, tmp_path):
    """SIGTERM one pod of a 2-pod world: both trainers checkpoint at an
    agreed step, the signalled pod departs, the survivor stop-resumes solo
    from the preemption-point checkpoint; every epoch once."""
    import signal

    from edl_tpu.cluster.status import Status
    ep = f"127.0.0.1:{coord_server.port}"
    ckpt = str(tmp_path / "ckpt")
    env = {"EDL_TPU_PREEMPT_CHECK_STEPS": "2"}
    pa = spawn("preempt-e2e", ep, str(tmp_path), "a", ckpt, env, epochs="8")
    pb = spawn("preempt-e2e", ep, str(tmp_path), "b", ckpt, env, epochs="8")
    try:
        _wait_for_checkpoints(ckpt, [pa, pb], 1, 240)
        pb.send_signal(signal.SIGTERM)
    finally:
        codes = _finish_all([pb, pa], 300)
    assert codes == [0, 0], _logs(tmp_path)[-4000:]
    assert _status(ep, "preempt-e2e") == Status.SUCCEED
    lb = (tmp_path / "launcher-b.log").read_bytes().decode(errors="replace")
    assert "flagging preemption" in lb and "preemption checkpoint complete; departing" in lb
    m = re.search(r"preemption flagged: checkpointing at step (\d+)", lb)
    assert m, lb[-3000:]
    step = int(m.group(1))
    la = (tmp_path / "launcher-a.log").read_bytes().decode(errors="replace")
    assert "peer preempted; waiting for the shrunk cluster" in la, la[-2000:]
    resumes = [int(x) for x in re.findall(r"resume_epoch=(\d+)", la)]
    assert len(resumes) >= 2 and resumes[-1] in (step // 4, (step - 1) // 4), (resumes, step)
    world, epochs, _ = _done(tmp_path / "marker-a")
    assert world == 1 and epochs == list(range(8))


@pytest.mark.slow
def test_peer_cache_restore_after_resize(coord_server, tmp_path):
    """A mid-run join: the restarted trainers restore from the surviving
    launcher's cache (``restore_source=peer``), verified bit-identical to
    storage in the trainer (``EDL_TPU_MEMSTATE_VERIFY=1``)."""
    from edl_tpu.cluster.status import Status
    ep = f"127.0.0.1:{coord_server.port}"
    ckpt = str(tmp_path / "ckpt")
    env = {"EDL_TPU_MEMSTATE_VERIFY": "1"}
    pa = spawn("memstate-e2e", ep, str(tmp_path), "a", ckpt, env)
    try:
        _wait_for_checkpoints(ckpt, [pa], 2)
        pb = spawn("memstate-e2e", ep, str(tmp_path), "b", ckpt, env)
    finally:
        codes = _finish_all([pa] + ([pb] if "pb" in locals() else []), 240)
    assert codes == [0, 0], _logs(tmp_path)[-4000:]
    assert _status(ep, "memstate-e2e") == Status.SUCCEED
    complete = _complete_stages(ep, "memstate-e2e")
    assert complete and complete[-1]["restore_source"] == "peer", complete
    logs = _logs(tmp_path)
    assert "restore_source=peer" in logs and "verified bit-identical to storage" in logs
    world, epochs, _ = _done(tmp_path / "marker-a")
    assert world == 2 and epochs == list(range(10))


@pytest.mark.slow
def test_peer_cache_miss_falls_back_to_storage(coord_server, tmp_path):
    """A 1-byte cache cap rejects every shard: the restore after the join
    falls back to storage (``restore_source=storage``)."""
    from edl_tpu.cluster.status import Status
    ep = f"127.0.0.1:{coord_server.port}"
    ckpt = str(tmp_path / "ckpt")
    env = {"EDL_TPU_MEMSTATE_MAX_BYTES": "1"}
    pa = spawn("miss-e2e", ep, str(tmp_path), "a", ckpt, env)
    try:
        _wait_for_checkpoints(ckpt, [pa], 2)
        pb = spawn("miss-e2e", ep, str(tmp_path), "b", ckpt, env)
    finally:
        codes = _finish_all([pa] + ([pb] if "pb" in locals() else []), 240)
    assert codes == [0, 0], _logs(tmp_path)[-4000:]
    assert _status(ep, "miss-e2e") == Status.SUCCEED
    complete = _complete_stages(ep, "miss-e2e")
    assert complete and complete[-1]["restore_source"] == "storage", complete
    assert "restore_source=peer" not in _logs(tmp_path)
    world, _, _ = _done(tmp_path / "marker-a")
    assert world == 2


@pytest.mark.slow
def test_elastic_join_resumes_training(coord_server, tmp_path):
    """Pod A trains solo, pod B joins once A has committed two epochs: both
    resume in a 2-rank world, the resize's recovery record is complete, all
    ten epochs run once and the regressor learned.  (The original also
    scrapes the processes' /metrics endpoints; the port has no metrics
    server yet.)"""
    from edl_tpu.cluster.status import Status
    ep = f"127.0.0.1:{coord_server.port}"
    ckpt = str(tmp_path / "ckpt")
    pa = spawn("train-e2e", ep, str(tmp_path), "a", ckpt)
    try:
        _wait_for_checkpoints(ckpt, [pa], 2)
        pb = spawn("train-e2e", ep, str(tmp_path), "b", ckpt)
    finally:
        codes = _finish_all([pa] + ([pb] if "pb" in locals() else []), 240)
    assert codes == [0, 0], _logs(tmp_path)[-4000:]
    assert _status(ep, "train-e2e") == Status.SUCCEED
    complete = _complete_stages(ep, "train-e2e")
    assert complete and 0 < complete[-1]["total"] < 300, complete
    print("recovery breakdown:", json.dumps(complete[-1]))
    world, epochs, w_err = _done(tmp_path / "marker-a")
    assert world == 2 and epochs == list(range(10)) and w_err < 0.05
