"""Deep Gradient Compression in the port (``edl_tpu_torch/train/compress.py``)
against optax's ``dgc`` of the JAX package (``edl_tpu/train/compress.py``),
on the CPU in f32: the four cases of ``tests/test_compress.py``, each run
through both; a 5-step trajectory of the whole chain against
``optax.chain(add_decayed_weights, dgc, sgd)``, with and without rampup;
the state's round trip through a checkpoint; and a synthetic
``train_resnet --dgc 0.99`` run that learns and resumes."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from edl_tpu.train.compress import dgc as jax_dgc
from edl_tpu_torch import train_resnet
from edl_tpu_torch.cluster.state import State
from edl_tpu_torch.train.checkpoint import CheckpointManager
from edl_tpu_torch.train.compress import DGC, dgc
from edl_tpu_torch.train.state import TrainState

# f32 on both sides; XLA and torch round the same products and sums, but
# XLA may fuse a multiply into an add (one rounding where torch has two),
# a difference of a few ulps that the residual carries from step to step
TOL = 1e-5


def _sent(opt: DGC, params, grads) -> list[torch.Tensor]:
    """One step of ``opt`` at lr 1 from zero parameters: what it sent (the
    parameters come back as ``-sent``, exactly)."""
    with torch.no_grad():
        for p, g in zip(params, grads):
            p.zero_()
            p.grad = torch.as_tensor(np.asarray(g)).clone()
    opt.step()
    return [-p.detach().clone() for p in params]


def _params(*shapes):
    return [torch.nn.Parameter(torch.zeros(s)) for s in shapes]


def test_topk_sparsity_and_residual_carry():
    """~10% of the largest entries sent, the rest carried; a small gradient
    below the cut accumulates until it is sent; every step equal to optax's."""
    tx = jax_dgc(sparsity=0.9, momentum=0.0, min_size=1)
    g = np.linspace(1.0, 100.0, 100).astype(np.float32)
    jstate = tx.init(jnp.asarray(g))
    params = _params(100)
    opt = dgc(1.0, sparsity=0.9, momentum=0.0, min_size=1)(params)
    send, = _sent(opt, params, [g])
    jsend, jstate = tx.update(jnp.asarray(g), jstate)
    assert int((send != 0).sum()) <= 15
    residual = opt.state[params[0]]["residual"]
    assert float((send + residual - torch.from_numpy(g)).abs().max()) < 1e-5
    np.testing.assert_allclose(send.numpy(), np.asarray(jsend), atol=TOL, rtol=0)
    np.testing.assert_allclose(residual.numpy(), np.asarray(jstate.residual), atol=TOL, rtol=0)

    tiny = np.zeros(100, np.float32)
    tiny[0] = 0.5
    total, jtotal = 0.0, 0.0
    for _ in range(30):
        send, = _sent(opt, params, [tiny])
        jsend, jstate = tx.update(jnp.asarray(tiny), jstate)
        total += float(send[0])
        jtotal += float(jsend[0])
    assert total > 0.0                # eventually transmitted, not dropped
    assert abs(total - jtotal) < TOL


def test_small_leaves_pass_dense():
    """A leaf under ``min_size`` entries is sent whole; a large one is cut;
    both as optax sends them."""
    tx = jax_dgc(sparsity=0.99, min_size=10)
    g = {"bias": np.ones(4, np.float32),
         "kernel": np.linspace(0.001, 1.0, 1000).astype(np.float32)}
    jsend, _ = tx.update(jax.tree.map(jnp.asarray, g), tx.init(jax.tree.map(jnp.asarray, g)))
    params = _params(4, 1000)
    opt = dgc(1.0, sparsity=0.99, min_size=10)(params)
    bias, kernel = _sent(opt, params, [g["bias"], g["kernel"]])
    assert float((bias - torch.from_numpy(g["bias"])).abs().max()) == 0.0
    assert int((kernel != 0).sum()) < 1000
    np.testing.assert_allclose(bias.numpy(), np.asarray(jsend["bias"]), atol=TOL, rtol=0)
    np.testing.assert_allclose(kernel.numpy(), np.asarray(jsend["kernel"]), atol=TOL, rtol=0)


def test_converges_chained_with_sgd():
    """Linear regression: DGC at 75% sparsity with momentum 0.9, then SGD
    at 0.05, reaches the true weights, as the JAX chain does."""
    rng = np.random.default_rng(0)
    w_true = torch.from_numpy(rng.normal(size=(32,)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(256, 32)).astype(np.float32))
    y = x @ w_true
    w = torch.nn.Parameter(torch.zeros(32))
    opt = dgc(0.05, sparsity=0.75, momentum=0.9, min_size=1)([w])
    for _ in range(300):
        opt.zero_grad()
        ((x @ w - y) ** 2).mean().backward()
        opt.step()
    err = float((w.detach() - w_true).abs().max())
    assert err < 0.05, err


def test_arbitrary_parameter_structure():
    """Any module's parameters, nested and of any shape, each get their own
    residual and momentum in the optimizer's state, shaped like them; what
    is sent keeps every parameter's shape."""
    module = torch.nn.ModuleDict({"a": torch.nn.Linear(10, 1, bias=False),
                                  "b": torch.nn.ModuleList([torch.nn.Linear(5, 1)])})
    params = list(module.parameters())
    opt = dgc(1.0, sparsity=0.5, min_size=1)(params)
    sent = _sent(opt, params, [np.ones(tuple(p.shape), np.float32) for p in params])
    assert [tuple(s.shape) for s in sent] == [tuple(p.shape) for p in params]
    for p in params:
        assert set(opt.state[p]) == {"residual", "momentum"}
        assert opt.state[p]["residual"].shape == p.shape == opt.state[p]["momentum"].shape
    assert opt.param_groups[0]["count"] == 1


SHAPES = {"kernel": (24, 16), "conv": (3, 3, 4, 8), "bias": (16,)}


def _trajectory(rampup: int):
    """5 steps of the port's chain and of optax's on the same gradients:
    the parameters, residuals and momenta after each step."""
    rng = np.random.default_rng(3)
    init = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(5)]
    tx = optax.chain(optax.add_decayed_weights(1e-4),
                     jax_dgc(sparsity=0.9, momentum=0.9, rampup_steps=rampup),
                     optax.sgd(0.05))
    jp = jax.tree.map(jnp.asarray, init)
    jstate = tx.init(jp)
    update = jax.jit(tx.update)
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    opt = dgc(0.05, sparsity=0.9, momentum=0.9, rampup_steps=rampup,
              weight_decay=1e-4)(list(params.values()))
    out = []
    for g in grads:
        upd, jstate = update(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        ds = jstate[1]
        out.append({k: (p.detach().numpy().copy(), np.asarray(jp[k]),
                        opt.state[p]["residual"].numpy().copy(), np.asarray(ds.residual[k]),
                        opt.state[p]["momentum"].numpy().copy(), np.asarray(ds.momentum[k]))
                    for k, p in params.items()})
    return out


@pytest.mark.parametrize("rampup", [0, 3], ids=["no_rampup", "rampup3"])
def test_chain_trajectory_matches_optax(rampup):
    """``dgc(...)`` against ``optax.chain(add_decayed_weights(1e-4),
    dgc(0.9, momentum 0.9, rampup), sgd(0.05))`` over 5 steps: the
    parameters, the residuals and the momenta after each step (the bias
    under ``min_size`` passing dense); the entries sent (the residual's
    zeros) are optax's."""
    for step, leaves in enumerate(_trajectory(rampup)):
        for k, (p, jp, res, jres, mom, jmom) in leaves.items():
            np.testing.assert_allclose(p, jp, atol=TOL, rtol=0, err_msg=f"{k} step {step}")
            np.testing.assert_allclose(res, jres, atol=TOL, rtol=0, err_msg=f"{k} step {step}")
            np.testing.assert_allclose(mom, jmom, atol=TOL, rtol=0, err_msg=f"{k} step {step}")
            if k != "bias":
                assert np.array_equal(res == 0, jres == 0), (k, step)


def test_state_round_trips_through_a_checkpoint(tmp_path):
    """A DGC state saved after 2 steps and restored into a fresh one: the
    residuals, momenta and step count come back, and the next step from
    each gives the same parameters."""
    torch.manual_seed(0)

    def make():
        model = torch.nn.Sequential(torch.nn.Linear(16, 16), torch.nn.Linear(16, 4))
        return TrainState.create(model, dgc(0.1, sparsity=0.9, rampup_steps=4,
                                            weight_decay=1e-4))

    x = torch.randn(8, 16)
    state = make()

    def step(st):
        st.optimizer.zero_grad()
        st.model(x).square().mean().backward()
        st.apply_gradients()

    for _ in range(2):
        step(state)
    meta = State(total_batch_size=8)
    meta.record_epoch(0, 1, state.step, 0.0)
    assert CheckpointManager(str(tmp_path)).save(state.step, state, meta)
    fresh = make()
    restored, _ = CheckpointManager(str(tmp_path)).restore(fresh, step=2)
    assert restored.step == 2 and restored.optimizer.param_groups[0]["count"] == 2
    for p, q in zip(state.model.parameters(), restored.model.parameters()):
        for key in ("residual", "momentum"):
            assert torch.equal(state.optimizer.state[p][key], restored.optimizer.state[q][key])
    step(state)
    step(restored)
    for p, q in zip(state.model.parameters(), restored.model.parameters()):
        assert torch.equal(p, q)


def test_synthetic_dgc_run_learns_and_resumes(tmp_path, monkeypatch, capsys):
    """``train_resnet --dgc 0.99`` on the synthetic task: the chain is DGC,
    the validation loss falls over 2 epochs, a second call resumes at epoch
    2 with the DGC state, and the last epoch reaches top-1 0.9."""
    for var in [k for k in os.environ if k.startswith("EDL_TPU_")]:
        monkeypatch.delenv(var)
    monkeypatch.setenv("EDL_TPU_CKPT_DIR", str(tmp_path / "ckpt"))
    dump = tmp_path / "bench.json"
    argv = ["--device", "cpu", "--synthetic", "4", "--synthetic_per_file", "64",
            "--synthetic_files", "2", "--data_dir", str(tmp_path / "data"), "--model", "resnet18",
            "--width", "16", "--image_size", "32", "--batch_size", "16", "--base_lr", "0.05",
            "--warmup_epochs", "0.5", "--num_workers", "2", "--bench_dump", str(dump),
            "--dgc", "0.99"]
    threads = torch.get_num_threads()
    torch.set_num_threads(2)      # the test runs beside others, each with its own threads
    try:
        train_resnet.main(argv + ["--epochs", "2"])
        state, meta = train_resnet.main(argv + ["--epochs", "3"])
    finally:
        torch.set_num_threads(threads)
    out = capsys.readouterr().out
    assert "resume_epoch=0" in out and "resume_epoch=2" in out
    epochs = json.loads(dump.read_text())["epochs"]
    assert [r["epoch"] for r in epochs] == [0, 1, 2]
    assert epochs[1]["val_loss"] < epochs[0]["val_loss"], epochs
    assert epochs[-1]["val_top1"] >= 0.9, epochs
    assert isinstance(state.optimizer, DGC) and state.optimizer.param_groups[0]["count"] == 24
    assert state.step == 24 and meta.next_epoch == 3
    assert any(float(st["residual"].abs().sum()) > 0 for st in state.optimizer.state.values())
