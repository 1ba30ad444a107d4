"""Mixture of experts over a sequence split across ``sp`` ranks, on the CPU,
against the JAX package's routing over each row's whole sequence: one
4-rank gloo world (``tests/helpers/torch_moe_sp_worker.py``, a 120 s limit
on each process) runs every multi-rank case; JAX runs at sp 1.

Every case has a capacity that binds (``drops > 0``): with ample capacity a
wrong slot offset routes the same tokens, so such a case shows nothing.

- ``compute_routing`` on sp chunks (sp 2 and sp 4, with and without a token
  mask): each rank's dispatch and combine are its rows of JAX's
  whole-sequence tensors, bit for bit, and its drop count is JAX's whole
  count; its aux is JAX's to f32 rounding (the sums are added in another
  order);
- ``train_lm --moe 4`` at dp 2 x sp 2 (ring attention) and at sp 2 x ep 2
  (the sequence gathered for attention) against the JAX LM at sp 1 on the
  same global batches: the drops before the first step, 3 steps' losses
  and aux, the first step's gradients against ``jax.grad`` of the global
  loss, and the parameters after 3 SGD steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from edl_tpu.models import transformer as jtf
from edl_tpu.models.generate import generate as jax_generate
from edl_tpu.ops.moe import compute_routing as jax_compute_routing
from edl_tpu_torch.models import transformer as ttf
from edl_tpu_torch.models.convert import params_from_jax
from edl_tpu_torch.parallel.tp import SP
from tests.helpers.torch_spawn import ROOT, run_world

WORKER = ROOT / "tests" / "helpers" / "torch_moe_sp_worker.py"
WORKER_TIMEOUT = 120      # seconds per worker process
B, S, E, K = 2, 16, 4, 2
CAPACITY = 5              # of 2 * 16 assignments a row over 4 experts: binds
CAP_FACTOR = 0.5          # the LM's: C = ceil(2 * 16 * 0.5 / 4) = 4 a row
CFG = dict(vocab_size=64, num_layers=2, embed_dim=32, num_heads=4, mlp_dim=64, max_len=32,
           moe_experts=4, moe_top_k=2, moe_capacity=CAP_FACTOR)
FLAGS = ["--device", "cpu", "--vocab", "64", "--layers", "2", "--embed", "32", "--heads", "4",
         "--mlp", "64", "--seq_len", "16", "--batch_size", "2", "--moe", "4",
         "--moe_top_k", "2", "--lr", "3e-3", "--remat", "off"]
LR, AUX = 0.1, 0.01      # plain SGD (the worker's note says why)
# f32: the aux's sums are added per chunk, then over the ranks; the LM as
# tests/test_torch_moe_mesh.py holds the port's trainer to JAX's
AUX_ATOL = 1e-6
LOSS_ATOL, GRAD_ATOL = 1e-5, 2e-5
PARAM_ATOL, PARAM_RTOL = 2e-5, 1e-4


def _jax_model():
    jc = jtf.TransformerConfig(dtype=jnp.float32, remat=False, attention_impl="dense", **CFG)
    return jc, jtf.TransformerLM(jc)


def _jax_loss(jm):
    def loss(params, ids):
        logits, aux = jm.apply({"params": params}, ids[:, :-1], with_aux=True)
        return jtf.lm_loss(logits, ids[:, 1:]) + AUX * aux
    return loss


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    io_dir = tmp_path_factory.mktemp("moe_sp")
    rng = np.random.default_rng(23)
    logits = rng.normal(size=(B, S, E)).astype(np.float32) * 2
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    valid = np.ones((B, S), bool)
    valid[0, 11:] = False
    valid[1, :3] = False
    batches = [rng.integers(0, 64, (4, 17)).astype(np.int32) for _ in range(3)]
    jc, jm = _jax_model()
    params = jax.jit(jm.init)(jax.random.key(5), jnp.zeros((1, 8), jnp.int32))["params"]
    tc = ttf.TransformerConfig(dtype=torch.float32, remat=False, **CFG)
    torch.save({"probs": torch.from_numpy(probs), "valid": torch.from_numpy(valid),
                "capacity": CAPACITY,
                "weights": params_from_jax(jax.tree.map(np.asarray, params), tc),
                "cfg": dict(CFG, dtype=torch.float32, remat=False), "flags": FLAGS,
                "batches": [torch.from_numpy(b) for b in batches], "lr": LR}, io_dir / "in.pt")
    outs = run_world(WORKER, io_dir, 4, WORKER_TIMEOUT)
    return {"probs": probs, "valid": valid, "batches": batches, "params": params, "tc": tc,
            "outs": outs}


@pytest.mark.parametrize("sp", [2, 4], ids=["sp2", "sp4"])
@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
def test_routing_on_chunks_is_the_whole_sequence(world, sp, masked):
    """Each rank's routing of its chunk against JAX's ``compute_routing`` of
    the whole rows: dispatch and combine bit-equal on its rows, the drop
    count equal (and nonzero), the aux to f32 rounding."""
    valid = jnp.asarray(world["valid"]) if masked else None
    d, c, aux, drops = jax.jit(jax_compute_routing, static_argnums=(1, 2))(
        jnp.asarray(world["probs"]), K, CAPACITY, valid)
    d, c = np.asarray(d), np.asarray(c)
    assert int(drops) > 0
    n = S // sp
    key = "masked" if masked else "all"
    for out in world["outs"]:
        got = out[f"sp{sp}"]
        rows = slice(got["chunk"] * n, (got["chunk"] + 1) * n)
        r = got[key]
        np.testing.assert_array_equal(r["dispatch"].numpy(), d[:, rows])
        np.testing.assert_array_equal(r["combine"].numpy(), c[:, rows])
        assert r["drops"] == int(drops)
        assert abs(r["aux"] - float(aux)) <= AUX_ATOL


def test_routing_without_sp_is_unchanged():
    """No sp group: the routing of the whole rows is JAX's, as before."""
    from edl_tpu_torch.ops.moe import compute_routing
    probs = np.random.default_rng(1).dirichlet(np.ones(E), size=(B, S)).astype(np.float32)
    d, c, aux, drops = compute_routing(torch.from_numpy(probs), K, CAPACITY)
    jd, jc, jaux, jdrops = jax.jit(jax_compute_routing, static_argnums=(1, 2))(
        jnp.asarray(probs), K, CAPACITY)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    assert int(drops) == int(jdrops) > 0 and abs(float(aux) - float(jaux)) <= AUX_ATOL


def test_set_sp_gives_every_moe_layer_the_group():
    moe = ttf.TransformerLM(ttf.TransformerConfig(**dict(CFG, dtype=torch.float32)))
    sp = SP(None, 1, 2)
    moe.set_sp(sp)
    assert all(layer.sp is sp and layer.moe.sp is sp for layer in moe.layers)


def _jax_steps(world):
    """The JAX MoE LM at sp 1 on the global batches: the drops at the
    initial parameters, the losses and aux of 3 AdamW steps, the first
    step's gradients and the final parameters after 3 SGD steps."""
    jc, jm = _jax_model()
    loss = _jax_loss(jm)
    # the drops are sown per layer, which the scanned training stack does
    # not keep: JAX generate's prefill counts them on the same ids
    ids0 = jnp.asarray(world["batches"][0][:, :-1])
    _, drops = jax.jit(lambda p, i: jax_generate(jc, p, i, 1, temperature=0.0,
                                                 return_drops=True))(world["params"], ids0)
    drops = int(drops)
    aux_of = jax.jit(lambda p, i: jm.apply({"params": p}, i, with_aux=True)[1])
    tx = optax.sgd(LR)
    params = world["params"]
    opt = tx.init(params)
    vg = jax.jit(jax.value_and_grad(loss))
    losses, auxes, first = [], [], None
    for ids in world["batches"]:
        ids = jnp.asarray(ids)
        val, g = vg(params, ids)
        losses.append(float(val))
        auxes.append(float(aux_of(params, ids[:, :-1])))
        first = g if first is None else first
        upd, opt = tx.update(g, opt, params)
        params = optax.apply_updates(params, upd)
    return drops, losses, auxes, jax.tree.map(np.asarray, first), jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def jax_steps(world):
    return _jax_steps(world)


@pytest.mark.parametrize("key,mesh", [
    ("dp2_sp2_ring", dict(dp=2, sp=2, ep=1)),
    ("sp2_ep2", dict(dp=1, sp=2, ep=2)),
], ids=["dp2_sp2_ring", "sp2_ep2"])
def test_moe_lm_over_sp_matches_jax_at_sp1(world, jax_steps, key, mesh):
    """``train_lm --moe 4 --sp 2`` (4 gloo ranks) against the JAX LM at sp
    1: every rank's drop count before the first step is its rows' whole-
    sequence count (summed over the data ranks: JAX's, nonzero), the losses
    and aux of 3 steps, the first step's gradients (the router's and the
    experts' among them) and the parameters after the steps."""
    drops, losses, auxes, jgrads, jparams = jax_steps
    want_g = params_from_jax(jgrads, world["tc"])
    want_p = params_from_jax(jparams, world["tc"])
    assert drops > 0
    outs = [out[key] for out in world["outs"]]
    per_data = {}
    for got in outs:
        assert {a: got["mesh"][a] for a in mesh} == mesh
        per_data.setdefault(got["data_rank"], set()).add(got["drops"])
        np.testing.assert_allclose(got["losses"], losses, atol=LOSS_ATOL, rtol=0)
        np.testing.assert_allclose(got["auxes"], auxes, atol=LOSS_ATOL, rtol=0)
        for name, g in got["grads"].items():
            torch.testing.assert_close(g, want_g[name], atol=GRAD_ATOL, rtol=0, msg=name)
        for name, p in got["params"].items():
            torch.testing.assert_close(p, want_p[name], atol=PARAM_ATOL, rtol=PARAM_RTOL,
                                       msg=name)
        assert got["w_in_local"] == (CFG["moe_experts"] // mesh["ep"], CFG["embed_dim"],
                                     CFG["mlp_dim"])
    # the sp (and ep) ranks of one data coordinate count the same drops
    assert all(len(v) == 1 for v in per_data.values())
    assert sum(next(iter(v)) for v in per_data.values()) == drops
