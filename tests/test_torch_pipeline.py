"""Pipeline parallelism in the port (``edl_tpu_torch/ops/pipeline.py``, the
pipelined LM of ``train_lm --pp``), on the CPU, against the JAX package:
the mirrors of ``tests/test_pipeline.py`` and of the pp cases of
``tests/test_lm_example.py``.  One 4-rank gloo world
(``tests/helpers/torch_pipeline_worker.py``, a 120 s limit on each
process) runs every multi-rank case; JAX runs on its 8 virtual CPU devices.

- ``pipeline_apply`` of tanh stages at pp 4 (4 microbatches), at pp 2 with
  two layers a stage, and at pp 1, held to the sequential composition and
  to JAX's ``pipeline_apply`` on the same inputs, forward and gradient;
- a regressor that learns under ``ElasticTrainer`` at dp 2 x pp 2;
- ``train_lm --pp 2`` (4 layers, narrow) at dp 2 x pp 2 and at pp 2 x tp 2
  against JAX's ``_PipelinedLM`` through ``models/convert.py``: 3 steps'
  losses, the first step's gradients against ``jax.grad`` of the global
  loss, the parameters after AdamW's steps;
- a pp-2 checkpoint resumed at pp 1, and a pp-1 one at pp 2 x tp 2;
- (slow) ``train_lm --pp 2 --tp 2 --fsdp 2`` in 8 processes learns.
"""

import importlib.util
import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from edl_tpu.models.transformer import TransformerConfig as JaxConfig
from edl_tpu.models.transformer import lm_loss as jax_lm_loss
from edl_tpu.ops.pipeline import pipeline_apply as jax_pipeline_apply
from edl_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from edl_tpu.parallel.mesh import build_mesh as jax_build_mesh
from edl_tpu_torch import train_lm
from edl_tpu_torch.cluster.state import State
from edl_tpu_torch.models.convert import pipelined_from_jax, pipelined_to_jax
from edl_tpu_torch.models.transformer import TransformerConfig
from edl_tpu_torch.ops.pipeline import pipeline_apply
from edl_tpu_torch.train.checkpoint import CheckpointManager
from edl_tpu_torch.utils.network import find_free_port
from tests.helpers.torch_spawn import ROOT, run_world

WORKER = ROOT / "tests" / "helpers" / "torch_pipeline_worker.py"
WORKER_TIMEOUT = 120      # seconds per worker process
S, D = 4, 16
CFG = dict(vocab_size=64, num_layers=4, embed_dim=32, num_heads=4, mlp_dim=64, max_len=16)
FLAGS = ["--device", "cpu", "--vocab", "64", "--layers", "4", "--embed", "32", "--heads", "4",
         "--mlp", "64", "--seq_len", "16", "--lr", "3e-3", "--remat", "off",
         "--pp_microbatches", "2"]
LR = 3e-3
# f32 throughout: the tanh stages as tests/test_pipeline.py holds them (the
# forward to 1e-5, the gradients to 1e-4); the LM as the MoE mesh test holds
# the port's trainer to JAX's (the two sum in other orders)
OUT_ATOL, GRAD_ATOL = 1e-5, 1e-4
LOSS_ATOL, LM_GRAD_ATOL = 1e-5, 2e-5
PARAM_ATOL, PARAM_RTOL = 2e-5, 1e-4


def _jax_example():
    spec = importlib.util.spec_from_file_location("jax_train_lm",
                                                  ROOT / "examples" / "lm" / "train_lm.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_stage(p, h):
    return jnp.tanh(h @ p["w"] + p["b"])


def _torch_stage(p, h):
    return torch.tanh(h @ p["w"] + p["b"])


def _sequential(params, x):
    h = x
    for i in range(len(params["w"])):
        h = _torch_stage({"w": params["w"][i], "b": params["b"][i]}, h)
    return h


def _jax_pipeline(params, x, spec, mb):
    mesh = jax_build_mesh(spec)

    def loss(p, xx):
        return (jax_pipeline_apply(_jax_stage, p, xx, mesh, n_microbatches=mb) ** 2).sum()

    out = jax.jit(lambda p, xx: jax_pipeline_apply(_jax_stage, p, xx, mesh,
                                                   n_microbatches=mb))(params, x)
    grads = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, x)
    return np.asarray(out), jax.tree.map(np.asarray, grads)


def _jax_lm():
    jc = JaxConfig(dtype=jnp.float32, remat=False, attention_impl="dense", **CFG)
    model = _jax_example()._PipelinedLM(jc, 2)
    model.mesh = jax_build_mesh(JaxMeshSpec(dp=4, pp=2))
    return jc, model


def _lm_args(*flags):
    return train_lm.parse_args(FLAGS + list(flags))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    io_dir = tmp_path_factory.mktemp("pipeline")
    rng = np.random.default_rng(0)
    stage = {"w": rng.normal(0, 0.3, (S, D, D)).astype(np.float32),
             "b": rng.normal(0, 0.1, (S, D)).astype(np.float32),
             "x": rng.normal(size=(16, D)).astype(np.float32)}
    reg_rng = np.random.default_rng(1)
    w_true = reg_rng.normal(size=(D, D)).astype(np.float32) / np.sqrt(D)
    xs = [reg_rng.normal(size=(16, D)).astype(np.float32) for _ in range(120)]
    init = np.random.default_rng(2)
    reg = {"w": torch.from_numpy(init.normal(0, 0.3, (S, D, D)).astype(np.float32)),
           "b": torch.from_numpy(init.normal(0, 0.1, (S, D)).astype(np.float32)),
           "x": [torch.from_numpy(x) for x in xs],
           "y": [torch.from_numpy(np.tanh(x @ w_true)) for x in xs]}
    batches = [rng.integers(0, 64, (8, 17)).astype(np.int32) for _ in range(3)]
    jc, jm = _jax_lm()
    params = jax.jit(jm.init)(jax.random.key(0), jnp.zeros((8, 16), jnp.int32))["params"]
    tc = TransformerConfig(dtype=torch.float32, remat=False, **CFG)
    weights = pipelined_from_jax(jax.tree.map(np.asarray, params), tc)
    pp1 = _save_pp1(io_dir / "pp1", weights, batches[0])
    torch.save({"stage": {k: torch.from_numpy(v) for k, v in stage.items()}, "reg": reg,
                "weights": weights, "flags": FLAGS,
                "batches": [torch.from_numpy(b) for b in batches]}, io_dir / "in.pt")
    outs = run_world(WORKER, io_dir, 4, WORKER_TIMEOUT)
    return {"stage": stage, "batches": batches, "params": params, "weights": weights,
            "outs": outs, "dir": io_dir, "tc": tc, "pp1": pp1}


def _save_pp1(ckpt, weights, ids):
    """One process's pipelined LM (pp 1) after one step, saved: its state."""
    args = _lm_args("--batch_size", "8")
    cfg, trainer, _, tx = train_lm.build_trainer(args, torch.device("cpu"))

    def init():
        model = train_lm.PipelinedLM(cfg, args.pp_microbatches)
        model.load_state_dict(weights)
        return model, None

    state = trainer.create_state(init, tx)
    state, _ = trainer.step_fn(state, {"ids": torch.from_numpy(ids)}, None)
    meta = State(total_batch_size=8)
    meta.record_epoch(0, 1, state.step, 0.0)
    assert CheckpointManager(str(ckpt)).save(state.step, state, meta)
    sd = state.state_dict()
    return {"step": state.step, "model": {n: t.clone() for n, t in sd["model"].items()},
            "optimizer": {i: {k: v.clone() for k, v in st.items()}
                          for i, st in sd["optimizer"]["state"].items()}}


@pytest.mark.parametrize("key,spec,mb", [
    ("pp4", JaxMeshSpec(dp=2, pp=4), 4),
    ("pp2", JaxMeshSpec(dp=4, pp=2), 2),     # 2 layers per stage
    ("pp1", JaxMeshSpec(dp=8, pp=1), 2),     # S == 1: the stages in sequence
], ids=["pp4_mb4", "pp2_mb2", "pp1_mb2"])
def test_pipeline_apply_matches_sequential_and_jax(world, key, spec, mb):
    """The outputs on every rank, and the gradients of ``sum(out^2)`` for
    each stage's layers and for ``x``: against the sequential composition
    (torch, autograd) and against JAX's ``pipeline_apply`` on its mesh."""
    s = world["stage"]
    jout, (jg, jgx) = _jax_pipeline({"w": jnp.asarray(s["w"]), "b": jnp.asarray(s["b"])},
                                    jnp.asarray(s["x"]), spec, mb)
    full = {k: torch.from_numpy(s[k]).requires_grad_() for k in ("w", "b", "x")}
    ref = _sequential(full, full["x"])
    (ref ** 2).sum().backward()
    if key == "pp1":
        mine = {k: torch.from_numpy(s[k]).requires_grad_() for k in ("w", "b", "x")}
        out = pipeline_apply(_torch_stage, {"w": mine["w"], "b": mine["b"]}, mine["x"], None, mb)
        (out ** 2).sum().backward()
        ranks = [{"out": out.detach(), "w": mine["w"].grad, "b": mine["b"].grad,
                  "x": mine["x"].grad, "stage": 0}]
        stages = 1
    else:
        ranks = [o[key] for o in world["outs"]]
        stages = int(key[2:])
    n = S // stages
    for r in ranks:
        rows = slice(r["stage"] * n, (r["stage"] + 1) * n)
        np.testing.assert_allclose(r["out"].numpy(), ref.detach().numpy(), atol=OUT_ATOL, rtol=0)
        np.testing.assert_allclose(r["out"].numpy(), jout, atol=OUT_ATOL, rtol=0)
        for k in ("w", "b"):
            np.testing.assert_allclose(r[k].numpy(), full[k].grad[rows].numpy(), atol=GRAD_ATOL,
                                       rtol=0)
            np.testing.assert_allclose(r[k].numpy(), jg[k][rows], atol=GRAD_ATOL, rtol=0)
        np.testing.assert_allclose(r["x"].numpy(), full["x"].grad.numpy(), atol=GRAD_ATOL, rtol=0)
        np.testing.assert_allclose(r["x"].numpy(), jgx, atol=GRAD_ATOL, rtol=0)


def test_pipeline_checks_the_microbatches():
    """``B % M`` is refused with JAX's message."""
    from edl_tpu_torch.parallel.tp import PP
    x = torch.zeros(6, D)
    with pytest.raises(ValueError, match="global batch 6 not divisible by 4 microbatches"):
        pipeline_apply(_torch_stage, {"w": torch.zeros(1, D, D), "b": torch.zeros(1, D)}, x,
                       PP(None, 0, 2), 4)


def test_pipeline_trains_under_elastic_trainer(world):
    """A pipelined regressor learns at dp 2 x pp 2: 120 Adam steps drop the
    loss by more than 5x, each rank holding its stage's two layers."""
    for out in world["outs"]:
        reg = out["regressor"]
        assert reg["w_local"] == (S // 2, D, D)
        assert reg["losses"][-1] < reg["losses"][0] / 5, (reg["losses"][0], reg["losses"][-1])
    assert len({tuple(o["regressor"]["losses"]) for o in world["outs"]}) == 1


def _jax_lm_steps(world):
    """JAX's ``_PipelinedLM`` on the global batches: the losses of 3 AdamW
    steps, the first step's gradients and the final parameters."""
    _, jm = _jax_lm()

    def loss(p, ids):
        return jax_lm_loss(jm.apply({"params": p}, ids[:, :-1]), ids[:, 1:])

    tx = optax.adamw(LR)
    params = world["params"]
    opt = tx.init(params)
    vg = jax.jit(jax.value_and_grad(loss))
    losses, first = [], None
    for ids in world["batches"]:
        val, g = vg(params, jnp.asarray(ids))
        losses.append(float(val))
        first = g if first is None else first
        upd, opt = tx.update(g, opt, params)
        params = optax.apply_updates(params, upd)
    return losses, jax.tree.map(np.asarray, first), jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def jax_lm(world):
    return _jax_lm_steps(world)


@pytest.mark.parametrize("key,mesh", [
    ("dp2_pp2", dict(dp=2, pp=2, tp=1)),
    ("pp2_tp2", dict(dp=1, pp=2, tp=2)),
], ids=["dp2_pp2", "pp2_tp2"])
def test_pipelined_lm_matches_jax(world, jax_lm, key, mesh):
    """``train_lm --pp 2`` (4 gloo ranks) against JAX's ``_PipelinedLM``
    through ``convert.py``: the losses of 3 steps, the first step's
    gradients (the stage-cut leaves, and the embedding, norm and head that
    every stage holds), the parameters after the steps; each stage holds
    two layers (and under tp half of each one's heads)."""
    losses, jgrads, jparams = jax_lm
    want_g = pipelined_from_jax(jgrads, world["tc"])
    want_p = pipelined_from_jax(jparams, world["tc"])
    for out in world["outs"]:
        got = out[key]
        assert {a: got["mesh"][a] for a in mesh} == mesh
        np.testing.assert_allclose(got["losses"], losses, atol=LOSS_ATOL, rtol=0)
        for name, g in got["grads"].items():
            torch.testing.assert_close(g, want_g[name], atol=LM_GRAD_ATOL, rtol=0, msg=name)
        for name, p in got["params"].items():
            torch.testing.assert_close(p, want_p[name], atol=PARAM_ATOL, rtol=PARAM_RTOL,
                                       msg=name)
        qkv = (CFG["num_layers"] // 2, 3 * CFG["embed_dim"] // mesh["tp"], CFG["embed_dim"])
        assert got["local"]["layers.attn_qkv.weight"] == qkv
        assert got["local"]["head.weight"] == (CFG["vocab_size"] // mesh["tp"], CFG["embed_dim"])
    for out in world["outs"][1:]:
        for name, p in out[key]["params"].items():
            assert torch.equal(p, world["outs"][0][key]["params"][name]), name


def test_pp2_checkpoint_resumes_at_pp1(world, monkeypatch):
    """The dp 2 x pp 2 world's checkpoint (global leaves) restored by one
    process running the pipelined LM at pp 1: the gathered parameters and
    the step."""
    for var in [k for k in os.environ if k.startswith("EDL_TPU_")]:
        monkeypatch.delenv(var)
    assert all(out["dp2_pp2"]["saved"] for out in world["outs"])
    args = _lm_args("--batch_size", "8")
    cfg, trainer, _, tx = train_lm.build_trainer(args, torch.device("cpu"),
                                                 str(world["dir"] / "ckpt"))

    def init_fn():
        return train_lm.PipelinedLM(cfg, args.pp_microbatches), None

    state, _ = trainer.restore_or_create(init_fn, tx, train_lm.PIPELINE_LOGICAL_RULES)
    assert state.step == 3 and not state.sharded
    assert isinstance(state.model, train_lm.PipelinedLM)
    for name, p in state.model.state_dict().items():
        assert torch.equal(p, world["outs"][0]["dp2_pp2"]["params"][name]), name


def test_pp1_checkpoint_resumes_at_pp2_tp2(world):
    """One process's checkpoint (pp 1, one step of AdamW) restored at pp 2 x
    tp 2: every parameter and moment, gathered from the pieces, is the
    saved one; a stage holds two layers of half the heads."""
    want = world["pp1"]
    for out in world["outs"]:
        got = out["pp1_restored"]
        assert got["step"] == want["step"] == 1
        assert got["local"] == (2, 3 * CFG["embed_dim"] // 2, CFG["embed_dim"])
        for name, p in got["model"].items():
            assert torch.equal(p, want["model"][name]), name
        for i, st in want["optimizer"].items():
            for k, v in st.items():
                assert torch.equal(got["optimizer"][i][k], v), (i, k)


def test_convert_round_trip_is_bit_identical(world):
    """JAX's ``_PipelinedLM`` tree to the port's state dict and back."""
    back = pipelined_to_jax(world["weights"], world["tc"])
    flat = jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, world["params"]))
    mine = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat) == len(mine) == 10
    for path, leaf in flat:
        assert np.array_equal(mine[path], leaf), path


@pytest.mark.parametrize("argv,message,jax_text", [
    (["--pp", "2", "--attention", "ring"], "--pp cannot combine with --sp/--attention ring",
     '"--pp cannot combine with --sp/--attention "'),
    (["--pp", "2", "--fused_ce"], "--fused_ce applies to the TransformerLM head",
     '"--fused_ce applies to the TransformerLM head; "'),
], ids=["ring", "fused_ce"])
def test_train_lm_pp_exits(argv, message, jax_text):
    """JAX's exits for ``--pp`` with ring attention and with the fused
    loss, each with its message (``jax_text``: the message in the JAX
    example's source; the others are ``tests/test_torch_moe.py``'s)."""
    with pytest.raises(SystemExit, match=re.escape(message)):
        train_lm.parse_args(["--device", "cpu"] + argv)
    assert jax_text in (ROOT / "examples" / "lm" / "train_lm.py").read_text()


def test_train_lm_pp_microbatches_clamp(capsys):
    """The microbatch count is clamped to the largest divisor of the batch,
    with JAX's message; the mesh spec puts pp beside auto tp."""
    args = train_lm.parse_args(["--device", "cpu", "--pp", "2", "--batch_size", "6",
                                "--pp_microbatches", "4"])
    assert args.pp_microbatches == 3
    assert "pp_microbatches clamped 4 -> 3 (global batch 6)" in capsys.readouterr().out
    spec = train_lm.mesh_spec(args)
    assert (spec(4).pp, spec(4).tp, spec(2).tp, spec(6).tp) == (2, 2, 1, 1)


@pytest.mark.slow
def test_train_lm_pp2_tp2_fsdp2_learns(tmp_path):
    """pp 2 x tp 2 x fsdp 2 in 8 processes (the twin of
    ``tests/test_lm_example.py:test_lm_pipeline_composes_with_tp_and_fsdp``):
    FSDP2 shards each stage's stacked layers, and the model learns."""
    port = find_free_port()
    env = {k: v for k, v in os.environ.items() if not k.startswith("EDL_TPU_")}
    logs = [open(tmp_path / f"log{r}.txt", "w+") for r in range(8)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "edl_tpu_torch.train_lm", "--device", "cpu", "--epochs", "3",
         "--steps_per_epoch", "12", "--pp", "2", "--tp", "2", "--fsdp", "2", "--layers", "4"],
        cwd=ROOT, stdout=log, stderr=subprocess.STDOUT, text=True,
        env={**env, "PYTHONPATH": str(ROOT), "EDL_TPU_TRAINER_ID": str(r),
             "EDL_TPU_TRAINERS_NUM": "8", "EDL_TPU_COORDINATOR": f"127.0.0.1:{port}",
             "OMP_NUM_THREADS": "1"})
        for r, log in enumerate(logs)]
    try:
        for p in procs:
            p.wait(timeout=300)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    text = (tmp_path / "log0.txt").read_text()
    assert all(p.returncode == 0 for p in procs), text[-4000:]
    rec = json.loads([ln for ln in text.splitlines() if ln.startswith("[train_lm] {")][-1]
                     [len("[train_lm] "):])
    assert rec["mesh"]["pp"] == 2 and rec["mesh"]["tp"] == 2 and rec["mesh"]["fsdp"] == 2
    assert rec["val_nll"] < rec["unigram_nll"] - 0.4, rec
    assert rec["nll_curve"][-1] < rec["nll_curve"][0], rec
