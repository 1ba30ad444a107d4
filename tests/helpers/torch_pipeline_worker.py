"""One rank of a 4-rank gloo world on the CPU running the multi-rank cases
of ``tests/test_torch_pipeline.py`` in one world:

    python tests/helpers/torch_pipeline_worker.py <io_dir>
        # io_dir/in.pt: {"stage": {"w", "b", "x"}, "weights": a PipelinedLM
        #   state dict, "batches": [global [B, L+1] ids], "flags": train_lm
        #   flags, "reg": the regressor's data}; io_dir/pp1: a pp-1 checkpoint
        # writes io_dir/out<rank>.pt

1. ``pipeline_apply`` of the tanh stages at pp 4 (the world, 4 microbatches)
   and at pp 2 with two layers a stage (dp 2 x pp 2, 2 microbatches): the
   outputs, the gradients of this stage's parameters and of ``x``;
2. a regressor whose stacked stages are cut over pp, under
   ``ElasticTrainer`` at dp 2 x pp 2: its losses;
3. ``train_lm --pp 2`` at dp 2 x pp 2 and at pp 2 x tp 2: 3 steps, the
   losses, the first step's gradients gathered whole, the parameters after
   the last step; the dp 2 x pp 2 state saved in io_dir/ckpt;
4. the pp-1 checkpoint restored at pp 2 x tp 2: the gathered state.
"""

import sys

import numpy as np
import torch
import torch.distributed as dist

from edl_tpu_torch import train_lm
from edl_tpu_torch.cluster.env import TrainerEnv
from edl_tpu_torch.cluster.state import State
from edl_tpu_torch.ops.pipeline import pipeline_apply
from edl_tpu_torch.parallel.mesh import MeshSpec
from edl_tpu_torch.parallel.sharding import shard_host_batch, to_full
from edl_tpu_torch.parallel.tp import PP
from edl_tpu_torch.train.checkpoint import CheckpointManager
from edl_tpu_torch.train.distributed import initialize_from_env, shutdown
from edl_tpu_torch.train.state import TrainState
from edl_tpu_torch.train.trainer import ElasticTrainer, TrainConfig


def stage(p, h):
    return torch.tanh(h @ p["w"] + p["b"])


def _pipeline(data, rank, stages, microbatches):
    """``pipeline_apply`` over pp groups of ``stages`` consecutive ranks."""
    groups = [dist.new_group(list(range(g, g + stages))) for g in range(0, 4, stages)]
    pp = PP(groups[rank // stages], rank % stages, stages)
    s = data["stage"]
    n = s["w"].shape[0] // stages
    w = s["w"][pp.rank * n:(pp.rank + 1) * n].clone().requires_grad_()
    b = s["b"][pp.rank * n:(pp.rank + 1) * n].clone().requires_grad_()
    x = s["x"].clone().requires_grad_()
    out = pipeline_apply(stage, {"w": w, "b": b}, x, pp, microbatches)
    (out ** 2).sum().backward()
    return {"out": out.detach(), "w": w.grad, "b": b.grad, "x": x.grad, "stage": pp.rank}


class Regressor(torch.nn.Module):
    """Four tanh stages stacked on a leading dim, pipelined over pp."""

    RULES = [(r"^w$", ("stage", None, None)), (r"^b$", ("stage", None))]

    def __init__(self, w, b):
        super().__init__()
        self.w, self.b = torch.nn.Parameter(w.clone()), torch.nn.Parameter(b.clone())
        self.pp = None

    def set_pp(self, pp):
        self.pp = pp

    def forward(self, x):
        return pipeline_apply(stage, {"w": self.w, "b": self.b}, x, self.pp, 4)


def _regressor(data, rank):
    reg = data["reg"]

    def loss_fn(model, extra, batch, gen):
        return ((model(batch["x"]) - batch["y"]) ** 2).mean(), (extra, {})

    trainer = ElasticTrainer(loss_fn, TrainConfig(mesh_spec=MeshSpec(dp=2, pp=2), log_every=0),
                             device="cpu")
    state = trainer.create_state(lambda: (Regressor(reg["w"], reg["b"]), None),
                                 lambda ps: torch.optim.Adam(ps, lr=1e-2), Regressor.RULES)
    losses = []
    for x, y in zip(reg["x"], reg["y"]):
        rows = shard_host_batch({"x": x.numpy(), "y": y.numpy()}, trainer.layout, rank)
        state, metrics = trainer.step_fn(state, {k: torch.from_numpy(v) for k, v in rows.items()},
                                         None)
        losses.append(float(metrics["loss"]))
    return {"losses": losses, "w_local": tuple(state.model.w.shape)}


def _lm(data, rank, flags, out, key, save=None):
    args = train_lm.parse_args(data["flags"] + flags)
    cfg, trainer, _, tx = train_lm.build_trainer(args, torch.device("cpu"))

    def init():
        model = train_lm.PipelinedLM(cfg, args.pp_microbatches)
        model.load_state_dict(data["weights"])
        return model, None

    state = trainer.create_state(init, tx, train_lm.PIPELINE_LOGICAL_RULES)
    model = state.model
    losses, grads = [], None
    for ids in data["batches"]:
        rows = shard_host_batch({"ids": ids.numpy()}, trainer.layout, rank)
        state, metrics = trainer.step_fn(state, {"ids": torch.from_numpy(rows["ids"])}, None)
        losses.append(float(metrics["loss"]))
        if grads is None:
            grads = {n: to_full(p.grad, model.param_layouts[n], model.tp, None, model.pp).clone()
                     for n, p in model.named_parameters()}
    full = state.full_state_dict()
    out[key] = {"losses": losses, "grads": grads,
                "params": {n: t.clone() for n, t in full["model"].items()},
                "local": {n: tuple(p.shape) for n, p in model.named_parameters()},
                "mesh": dict(zip(("dp", "fsdp", "pp", "sp", "tp", "ep"), trainer.layout.shape))}
    if save is not None:
        meta = State(total_batch_size=trainer.cfg.global_batch_size)
        meta.record_epoch(0, trainer.world_size, state.step, 0.0)
        out[key]["saved"] = CheckpointManager(save).save(state.step, state, meta)


def _restore_pp1(data, io_dir, out):
    """The pp-1 checkpoint (written by one process) restored at pp 2 x tp 2."""
    args = train_lm.parse_args(data["flags"] + ["--pp", "2", "--tp", "2"])
    _, trainer, init_fn, tx = train_lm.build_trainer(args, torch.device("cpu"), f"{io_dir}/pp1")
    state, _ = trainer.restore_or_create(init_fn, tx, train_lm.PIPELINE_LOGICAL_RULES)
    assert isinstance(state, TrainState) and state.sharded
    full = state.full_state_dict()
    out["pp1_restored"] = {"step": state.step,
                           "model": {n: t.clone() for n, t in full["model"].items()},
                           "optimizer": full["optimizer"]["state"],
                           "local": tuple(state.model.layers.attn_qkv.weight.shape)}


def main(io_dir):
    initialize_from_env(TrainerEnv(), "cpu")
    rank = dist.get_rank()
    torch.manual_seed(0)
    np.random.seed(0)
    data = torch.load(f"{io_dir}/in.pt", weights_only=False)
    out = {"rank": rank}
    out["pp4"] = _pipeline(data, rank, 4, 4)
    out["pp2"] = _pipeline(data, rank, 2, 2)
    out["regressor"] = _regressor(data, rank)
    _lm(data, rank, ["--pp", "2", "--tp", "1", "--batch_size", "4"], out, "dp2_pp2",
        save=f"{io_dir}/ckpt")
    _lm(data, rank, ["--pp", "2", "--tp", "2", "--batch_size", "8"], out, "pp2_tp2")
    _restore_pp1(data, io_dir, out)
    torch.save(out, f"{io_dir}/out{rank}.pt")
    shutdown()


if __name__ == "__main__":
    main(sys.argv[1])
