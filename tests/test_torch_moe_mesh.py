"""The MoE LM over the ``ep`` mesh axis, on the CPU, against the JAX
package: one 4-rank gloo world (``tests/helpers/torch_moe_mesh_worker.py``,
a 120 s limit on each process) runs every multi-rank case; the JAX side
runs on its virtual CPU devices.

- ``ElasticTrainer`` at dp 2 x ep 2, ep 2 x tp 2 and fsdp 2 x ep 2 against the JAX
  trainer on the same ``MeshSpec`` (``tests/test_moe.py:105``), same
  weights, same global batches: f32 losses over 3 steps, the parameters
  after them, and the first step's gradients (the router's ``gate`` and
  the experts' ``w_in``/``w_out`` among them) against ``jax.grad`` of the
  global loss.  At dp 2 the aux loss's ``f`` and ``P`` are the global
  batch's, so the gate gradient catches an aux taken per rank;
- the experts cut E/ep (and H/tp), the peer cache's pieces covering every
  leaf once;
- the dp 2 x ep 2 storage checkpoint resumed by one process at ep 1;
- a tp-2 MoE engine's greedy tokens against JAX ``generate``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from edl_tpu.models import transformer as jtf
from edl_tpu.models.generate import generate as jax_generate
from edl_tpu.models.logical import logical_axes_from_paths
from edl_tpu.parallel import MeshSpec as JaxMeshSpec
from edl_tpu.parallel.sharding import shard_host_batch as jax_shard_host_batch
from edl_tpu.train.trainer import ElasticTrainer as JaxTrainer
from edl_tpu.train.trainer import TrainConfig as JaxTrainConfig
from edl_tpu_torch import train_lm
from edl_tpu_torch.models import transformer as ttf
from edl_tpu_torch.models.convert import params_from_jax
from tests.helpers.torch_spawn import ROOT, run_world

WORKER = ROOT / "tests" / "helpers" / "torch_moe_mesh_worker.py"
WORKER_TIMEOUT = 120      # seconds per worker process
WORLD = 4
CFG = dict(vocab_size=64, num_layers=2, embed_dim=32, num_heads=4, mlp_dim=64, max_len=32,
           moe_experts=4, moe_top_k=2)
FLAGS = ["--device", "cpu", "--vocab", "64", "--layers", "2", "--embed", "32", "--heads", "4",
         "--mlp", "64", "--seq_len", "16", "--batch_size", "2", "--moe", "4",
         "--moe_top_k", "2", "--lr", "3e-3", "--remat", "off"]
LR, AUX = 3e-3, 0.01
# f32 throughout; the two packages sum in other orders (the ep and tp
# all-reduces, XLA's collectives)
LOSS_ATOL = 1e-5
GRAD_ATOL = 2e-5
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
    io_dir = tmp_path_factory.mktemp("moe_mesh")
    rng = np.random.default_rng(17)
    batches = [rng.integers(0, 64, (4, 17)).astype(np.int32) for _ in range(3)]
    prompts = [rng.integers(1, 64, (n,)).astype(np.int32) for n in (5, 11, 16)]
    jc, jm = _jax_model()
    params = jax.jit(jm.init)(jax.random.key(3), jnp.zeros((1, 8), jnp.int32))["params"]
    tc = ttf.TransformerConfig(dtype=torch.float32, remat=False, **CFG)
    torch.save({"weights": params_from_jax(jax.tree.map(np.asarray, params), tc),
                "cfg": dict(CFG, dtype=torch.float32, remat=False),
                "batches": [torch.from_numpy(b) for b in batches], "flags": FLAGS,
                "prompts": [torch.from_numpy(p) for p in prompts], "new": 5},
               io_dir / "in.pt")
    outs = run_world(WORKER, io_dir, WORLD, WORKER_TIMEOUT)
    return {"batches": batches, "prompts": prompts, "params": params, "outs": outs,
            "dir": io_dir, "tc": tc}


def _jax_trainer_steps(world, spec):
    """The JAX trainer at ``spec`` on 4 devices: its losses and final
    parameters."""
    jc, jm = _jax_model()
    loss = _jax_loss(jm)

    def loss_fn(p, extra, batch, rng):
        return loss(p, batch["ids"]), (extra, {})

    trainer = JaxTrainer(loss_fn, JaxTrainConfig(mesh_spec=spec), devices=jax.devices()[:WORLD])
    logical = logical_axes_from_paths(world["params"], jtf.LOGICAL_RULES)
    assert logical["layers"]["moe"]["w_in"] == ("layers", "expert", "embed", "expert_mlp")
    state = trainer.create_state(lambda: (world["params"], None), optax.adamw(LR), logical)
    losses = []
    for ids in world["batches"]:
        g = jax_shard_host_batch({"ids": ids}, trainer.mesh, trainer.rules)
        state, metrics = trainer.step_fn(state, g, jax.random.key(0))
        losses.append(float(metrics["loss"]))
    return losses, jax.tree.map(np.asarray, state.params)


@pytest.mark.parametrize("key,spec,mesh", [
    ("dp_ep", JaxMeshSpec(dp=2, ep=2), dict(dp=2, ep=2, tp=1)),
    ("ep_tp", JaxMeshSpec(dp=1, ep=2, tp=2), dict(dp=1, ep=2, tp=2)),
    ("fsdp_ep", JaxMeshSpec(dp=1, fsdp=2, ep=2), dict(dp=1, fsdp=2, ep=2, tp=1)),
], ids=["dp2_ep2", "ep2_tp2", "fsdp2_ep2"])
def test_moe_trainer_matches_the_jax_trainer(world, key, spec, mesh):
    """Three steps of ``train_lm --moe 4 --ep 2`` (4 gloo ranks) against the
    JAX trainer on the same MeshSpec: losses, the final parameters, and the
    first step's gradients against ``jax.grad`` of the global loss."""
    losses, jparams = _jax_trainer_steps(world, spec)
    _, jm = _jax_model()
    jgrads = jax.jit(jax.grad(_jax_loss(jm)))(world["params"], jnp.asarray(world["batches"][0]))
    want_g = params_from_jax(jax.tree.map(np.asarray, jgrads), world["tc"])
    want_p = params_from_jax(jparams, world["tc"])
    for r, out in enumerate(world["outs"]):
        got = out[key]
        assert {a: got["mesh"][a] for a in mesh} == mesh
        np.testing.assert_allclose(got["losses"], losses, atol=LOSS_ATOL, rtol=0)
        assert all(np.isfinite(got["auxes"]))
        for name, g in got["grads"].items():
            torch.testing.assert_close(g, want_g[name], atol=GRAD_ATOL, rtol=0, msg=name)
        for name, p in got["params"].items():
            torch.testing.assert_close(p, want_p[name], atol=PARAM_ATOL, rtol=PARAM_RTOL,
                                       msg=name)
        E, M, H = CFG["moe_experts"], CFG["embed_dim"], CFG["mlp_dim"]
        assert got["shapes"]["layers.0.moe.w_in"] == (E // 2, M, H // mesh["tp"])
        assert got["shapes"]["layers.0.moe.w_out"] == (E // 2, H // mesh["tp"], M)
        assert got["shapes"]["layers.0.moe.gate"] == (M, E)
        if key == "fsdp_ep":          # FSDP2 shards the experts' embed dim
            assert got["local"]["layers.0.moe.w_in"] == (E // 2, M // 2, H)
        assert got["data_rank"] == (r // 2 if max(mesh["dp"], mesh.get("fsdp", 1)) == 2 else 0)
    for out in world["outs"][1:]:
        for name, p in out[key]["params"].items():
            assert torch.equal(p, world["outs"][0][key]["params"][name]), name


def test_ep_pieces_cover_every_leaf_once(world):
    """The peer cache's pieces at dp 2 x ep 2: each expert leaf comes in
    two boxes, one from each ep rank of dp coordinate 0, and every leaf is
    covered exactly once, with the values of the gathered parameters."""
    full = world["outs"][0]["dp_ep"]["params"]
    cover: dict[str, np.ndarray] = {}
    for out in world["outs"]:
        for key, (entry, host) in out["dp_ep"]["pieces"].items():
            if not entry["leaf"].startswith("model/"):
                continue
            name = entry["leaf"][len("model/"):]
            box = entry["index"]
            index = tuple(slice(a, b) for a, b in box)
            assert torch.equal(host, full[name][index]), key
            c = cover.setdefault(name, np.zeros(full[name].shape, np.int32))
            c[index] += 1
    assert set(cover) == set(full)
    for name, c in cover.items():
        assert (c == 1).all(), name
    ranks = {out["rank"] for out in world["outs"] for e, _ in out["dp_ep"]["pieces"].values()
             if e["leaf"] == "model/layers.0.moe.w_in"}
    assert ranks == {0, 1}


def test_storage_resume_from_ep2_to_ep1(world, monkeypatch):
    """The dp 2 x ep 2 world's checkpoint (global leaves) restored by one
    process at ep 1: the gathered parameters and the step."""
    import os

    for var in [k for k in os.environ if k.startswith("EDL_TPU_")]:
        monkeypatch.delenv(var)
    assert all(out["dp_ep"]["saved"] for out in world["outs"])
    args = train_lm.parse_args(FLAGS)
    _, trainer, init_fn, tx = train_lm.build_trainer(args, torch.device("cpu"),
                                                     str(world["dir"] / "ckpt"))
    state, _ = trainer.restore_or_create(init_fn, tx, ttf.LOGICAL_RULES)
    assert state.step == 3 and not state.sharded
    for name, p in state.model.state_dict().items():
        assert torch.equal(p, world["outs"][0]["dp_ep"]["params"][name]), name


def test_tp2_moe_engine_matches_jax_generate(world):
    """Each tp-2 engine (two groups) gives JAX ``generate``'s greedy tokens
    on every prompt; its experts hold H / tp hidden columns."""
    jc, _ = _jax_model()
    leaders = [out for out in world["outs"] if "engine" in out]
    assert [out["rank"] for out in leaders] == [0, 2]
    for i, p in enumerate(world["prompts"]):
        want = jax.jit(lambda pp, x: jax_generate(jc, pp, x, 5, temperature=0.0))(
            world["params"], jnp.asarray(p[None]))
        for out in leaders:
            np.testing.assert_array_equal(out["engine"][i], np.asarray(want)[0])
    for out in leaders:
        assert out["engine_w_in"] == (CFG["moe_experts"], CFG["embed_dim"], CFG["mlp_dim"] // 2)
        assert out["engine_stats"]["moe_prefill_drops"] >= 0
