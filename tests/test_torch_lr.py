"""The port's world-derived LR rescale and schedules (``edl_tpu_torch/
train/lr.py``) against the JAX package's (``tests/test_lr_rescale.py``'s
cases): the world scale multiplies the effective LR, lives in the
optimizer's ``state_dict``, compounds across resizes and is applied only
under ``EDL_TPU_LR_RESCALE=1``.  Where a case has a JAX counterpart, the
same seeded numpy parameters and gradients go through
``edl_tpu.train.lr.world_scaled(optax...)`` and the port's optimizer."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from edl_tpu.train import lr as jax_lr
from edl_tpu_torch.train import lr as lr_mod
from edl_tpu_torch.train.state import TrainState, adamw
from edl_tpu_torch.train.trainer import ElasticTrainer

# f32 parameters after the same updates.  SGD: the same two roundings.
# AdamW: torch decays the weight, then steps; optax adds the decay into the
# update it applies; with the bias corrections' order that is a few f32
# roundings of |w| ~ 1 (measured on a CPU: 1.3e-6 relative after 3 steps)
RTOL = {"sgd": 1e-6, "adamw": 1e-5}

OPTIMIZERS = {
    "sgd": (lambda: optax.sgd(0.1), lambda: (lambda ps: torch.optim.SGD(ps, lr=0.1))),
    "adamw": (lambda: optax.adamw(1e-2, weight_decay=1e-4), lambda: adamw(1e-2)),
}
# factors applied before the first step: none, grow 4 -> 8, shrink 4 -> 2,
# and 4 -> 8 -> 4 (back to 1.0)
RESIZES = {"identity": [], "grow": [8 / 4], "shrink": [2 / 4], "round_trip": [8 / 4, 4 / 8]}


def _seeded(steps=3, n=6):
    rng = np.random.default_rng(0)
    w = rng.normal(size=(n,)).astype(np.float32)
    grads = [rng.normal(size=(n,)).astype(np.float32) for _ in range(steps)]
    return w, grads


def _run_jax(tx, w, grads, factors):
    tx = jax_lr.world_scaled(tx)
    params = {"w": jnp.asarray(w)}
    state = tx.init(params)
    for f in factors:
        state = jax_lr.rescale_state(state, f)
    for g in grads:
        updates, state = tx.update({"w": jnp.asarray(g)}, state, params)
        params = optax.apply_updates(params, updates)
    return np.asarray(params["w"])


def _run_torch(factory, w, grads, factors):
    p = torch.nn.Parameter(torch.from_numpy(w.copy()))
    opt = lr_mod.world_scaled(factory)([p])
    for f in factors:
        lr_mod.rescale_state(opt, f)
    for g in grads:
        p.grad = torch.from_numpy(g.copy())
        opt.step()
    return p.detach().numpy(), opt


@pytest.mark.parametrize("resize", list(RESIZES))
@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_world_scaled_matches_jax(name, resize):
    jax_tx, torch_tx = OPTIMIZERS[name]
    w, grads = _seeded()
    want = _run_jax(jax_tx(), w, grads, RESIZES[resize])
    got, opt = _run_torch(torch_tx(), w, grads, RESIZES[resize])
    np.testing.assert_allclose(got, want, rtol=RTOL[name], atol=0)
    assert lr_mod.lr_scale(opt) == float(np.prod(RESIZES[resize]))
    # the groups' own lr is untouched by the scale between steps
    assert opt.param_groups[0]["lr"] == (0.1 if name == "sgd" else 1e-2)


def _sgd_delta(factors):
    """One SGD(0.1) step's update of a unit gradient (the JAX tests'
    setup)."""
    w = np.ones(4, np.float32)
    got, _ = _run_torch(lambda ps: torch.optim.SGD(ps, lr=0.1), w, [np.ones(4, np.float32)],
                        factors)
    return float(got[0] - w[0])


def test_rescale_scales_the_update_linearly_and_compounds():
    assert np.isclose(_sgd_delta([]), -0.1), "the wrapper must not perturb the base update"
    assert np.isclose(_sgd_delta([8 / 4]), -0.2)
    assert np.isclose(_sgd_delta([2 / 4]), -0.05)
    assert np.isclose(_sgd_delta([8 / 4, 4 / 8]), -0.1)


def test_scale_survives_steps_and_state_dict_and_noops_unwrapped():
    p = torch.nn.Parameter(torch.ones(4))
    opt = lr_mod.world_scaled(lambda ps: torch.optim.SGD(ps, lr=0.1))([p])
    lr_mod.rescale_state(opt, 2.0)
    for _ in range(2):
        p.grad = torch.ones(4)
        before = p.detach().clone()
        opt.step()
        assert torch.allclose(p.detach() - before, torch.full((4,), -0.2)), \
            "the scale must persist across steps"
    sd = opt.state_dict()
    assert sd["param_groups"][0][lr_mod.SCALE_KEY] == 2.0
    q = torch.nn.Parameter(torch.ones(4))
    fresh = lr_mod.world_scaled(lambda ps: torch.optim.SGD(ps, lr=0.1))([q])
    fresh.load_state_dict(sd)
    q.grad = torch.ones(4)
    fresh.step()
    assert lr_mod.lr_scale(fresh) == 2.0 and torch.allclose(q.detach(), torch.full((4,), 0.8))
    # a plain optimizer passes through rescale_state untouched
    plain = torch.optim.SGD([torch.nn.Parameter(torch.ones(2))], lr=0.1)
    before = plain.state_dict()
    assert lr_mod.rescale_state(plain, 3.0) is plain
    assert plain.state_dict() == before and lr_mod.lr_scale(plain) == 1.0


def test_world_scaled_adamw_effective_lr():
    """AdamW's update, decay included, is proportional to its LR, so the
    scale is an exact effective-LR change (the JAX test's Adam case)."""
    w = np.ones(4, np.float32)
    g = [np.full(4, 0.5, np.float32)]
    base, _ = _run_torch(adamw(1e-3), w, g, [])
    scaled, _ = _run_torch(adamw(1e-3), w, g, [4.0])
    np.testing.assert_allclose(scaled - w, 4.0 * (base - w), rtol=1e-5)
    jax_scaled = _run_jax(optax.adamw(1e-3, weight_decay=1e-4), w, g, [4.0])
    np.testing.assert_allclose(scaled, jax_scaled, rtol=RTOL["adamw"], atol=0)


def test_trainer_world_lr_rescale_gate(monkeypatch):
    """The trainer applies the factor only under EDL_TPU_LR_RESCALE=1."""
    model = torch.nn.Linear(2, 1)
    state = TrainState.create(model, lr_mod.world_scaled(lambda ps: torch.optim.SGD(ps, lr=0.1)))
    monkeypatch.setenv("EDL_TPU_LR_RESCALE", "0")
    assert ElasticTrainer._world_lr_rescale(object(), state, 4, 8) is state
    assert lr_mod.lr_scale(state) == 1.0
    monkeypatch.setenv("EDL_TPU_LR_RESCALE", "1")
    assert lr_mod.lr_scale(ElasticTrainer._world_lr_rescale(object(), state, 4, 8)) == 2.0
    # no-op factors never touch the state
    assert ElasticTrainer._world_lr_rescale(object(), state, 8, 8) is state
    assert lr_mod.lr_scale(state) == 2.0


SCHEDULES = {
    "cosine_warmup": ((0.1, 100, 10, 0.01), list(range(0, 130, 7)) + [9, 10, 11, 100]),
    "cosine": ((0.1, 100), list(range(0, 130, 7)) + [100]),
    "piecewise_warmup": ((0.1, [30, 60], 0.1, 10), [0, 5, 9, 10, 11, 29, 30, 31, 59, 60, 99]),
    "piecewise": ((0.1, [30, 60]), [0, 29, 30, 59, 60, 200]),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedules_match_optax(name):
    args, steps = SCHEDULES[name]
    fn = "cosine_warmup" if name.startswith("cosine") else "piecewise_decay"
    ours, theirs = getattr(lr_mod, fn)(*args), getattr(jax_lr, fn)(*args)
    # f32 (optax) against f64: relative to the peak LR
    np.testing.assert_allclose([ours(s) for s in steps], [float(theirs(s)) for s in steps],
                               rtol=0, atol=1e-6 * args[0])


def test_adamw_with_a_schedule_and_world_scale_matches_optax():
    """``adamw(schedule)`` reads the schedule at AdamW's own step count, as
    optax does, and the world scale multiplies the scheduled LR."""
    w, grads = _seeded(steps=6)
    sched = (1e-2, 20, 3)
    want = _run_jax(optax.adamw(jax_lr.cosine_warmup(*sched), weight_decay=1e-4), w, grads, [0.5])
    got, opt = _run_torch(adamw(lr_mod.cosine_warmup(*sched)), w, grads, [0.5])
    np.testing.assert_allclose(got, want, rtol=RTOL["adamw"], atol=0)
    assert opt.param_groups[0]["lr"] == lr_mod.cosine_warmup(*sched)(5)


def test_scale_lr_for_batch():
    assert lr_mod.scale_lr_for_batch(0.1, 512) == jax_lr.scale_lr_for_batch(0.1, 512) == 0.2
    assert lr_mod.scale_lr_for_batch(0.1, 16, base_batch=16) == 0.1
