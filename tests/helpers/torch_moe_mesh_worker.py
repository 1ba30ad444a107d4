"""One rank of a 4-rank gloo world on the CPU running the multi-rank cases
of ``tests/test_torch_moe_mesh.py`` in one world:

    python tests/helpers/torch_moe_mesh_worker.py <io_dir>
        # io_dir/in.pt: {"weights": the MoE LM's full state dict, "cfg",
        #   "batches": [global [B, L+1] ids], "flags": train_lm flags,
        #   "prompts": [1-d prompts], "new": tokens per prompt}
        # writes io_dir/out<rank>.pt

1. ``ElasticTrainer`` at dp 2 x ep 2 (``train_lm --moe 4 --ep 2 --tp 1``):
   3 steps on this rank's rows, the losses, the first step's gradients
   gathered whole, the parameters after the last step, this rank's
   peer-cache pieces, then a storage checkpoint in io_dir/ckpt;
2. the same at ep 2 x tp 2 (every rank the whole batch), and at fsdp 2 x
   ep 2 (FSDP2 on the experts' embed dim);
3. a tp-2 MoE engine on a dp 2 x tp 2 mesh: ranks 0 and 2 lead an engine
   each and generate every prompt greedily, ranks 1 and 3 follow.
"""

import sys

import torch
import torch.distributed as dist

from edl_tpu_torch import train_lm
from edl_tpu_torch.cluster.env import TrainerEnv
from edl_tpu_torch.cluster.state import State
from edl_tpu_torch.memstate import shards
from edl_tpu_torch.models import transformer as ttf
from edl_tpu_torch.parallel.mesh import MeshSpec, build_mesh
from edl_tpu_torch.parallel.sharding import shard_host_batch, to_full
from edl_tpu_torch.serving import ContinuousBatcher
from edl_tpu_torch.train.checkpoint import CheckpointManager
from edl_tpu_torch.train.distributed import initialize_from_env, shutdown


def _train(data, rank, flags, out, key, save=None):
    args = train_lm.parse_args(data["flags"] + flags)
    cfg, trainer, _, tx = train_lm.build_trainer(args, torch.device("cpu"))

    def init():
        model = ttf.TransformerLM(cfg, init=False)
        model.load_state_dict(data["weights"])
        return model, None

    state = trainer.create_state(init, tx, ttf.LOGICAL_RULES)
    model = state.model
    gen = torch.Generator().manual_seed(0)
    losses, auxes, grads = [], [], None
    for ids in data["batches"]:
        rows = shard_host_batch({"ids": ids.numpy()}, trainer.layout, rank)
        state, metrics = trainer.step_fn(state, {"ids": torch.from_numpy(rows["ids"])}, gen)
        losses.append(float(metrics["loss"]))
        auxes.append(float(metrics["moe_aux"]))
        if grads is None:
            grads = {n: to_full(p.grad, model.param_layouts[n], model.tp, model.ep).clone()
                     for n, p in model.named_parameters()}
    full = state.full_state_dict()
    out[key] = {"losses": losses, "auxes": auxes, "grads": grads,
                "params": {n: t.clone() for n, t in full["model"].items()},
                "shapes": {n: tuple(p.shape) for n, p in model.named_parameters()},
                "local": {n: tuple(p.to_local().shape if hasattr(p, "to_local") else p.shape)
                          for n, p in model.named_parameters()},
                "mesh": dict(zip(("dp", "fsdp", "pp", "sp", "tp", "ep"), trainer.layout.shape)),
                "data_rank": trainer.data_rank}
    if save is not None:
        snap = shards.snapshot(state)
        out[key]["pieces"] = {k: (snap.manifest[k], host.clone()) for k, host in snap.shards}
        meta = State(total_batch_size=trainer.cfg.global_batch_size)
        meta.record_epoch(0, trainer.world_size, state.step, 0.0)
        out[key]["saved"] = CheckpointManager(save).save(state.step, state, meta)


def _engine(data, rank, out):
    mesh = build_mesh(MeshSpec(dp=2, tp=2), pods=[0, 0, 0, 0])
    model = ttf.TransformerLM(ttf.TransformerConfig(**data["cfg"]), init=False)
    model.load_state_dict(data["weights"])
    model.requires_grad_(False).eval()
    kw = dict(slots=2, prefill_buckets=(8, 16), temperature=0.0, steps_per_sync=4)
    if mesh.get_local_rank("tp") == 0:
        eng = ContinuousBatcher(model, mesh=mesh, **kw)
        try:
            futs = [eng.submit(p.numpy(), data["new"]) for p in data["prompts"]]
            out["engine"] = [f.result(timeout=120) for f in futs]
            out["engine_stats"] = eng.stats()
            out["engine_w_in"] = tuple(eng._model.layers[0].moe.w_in.shape)
        finally:
            eng.stop()
    else:
        ContinuousBatcher.follow(model, mesh=mesh)


def main(io_dir):
    initialize_from_env(TrainerEnv(), "cpu")
    rank = dist.get_rank()
    data = torch.load(f"{io_dir}/in.pt", weights_only=False)
    out = {"rank": rank}
    _train(data, rank, ["--ep", "2", "--tp", "1"], out, "dp_ep", save=f"{io_dir}/ckpt")
    _train(data, rank, ["--ep", "2", "--tp", "2"], out, "ep_tp")
    _train(data, rank, ["--ep", "2", "--fsdp", "2", "--tp", "1"], out, "fsdp_ep")
    _engine(data, rank, out)
    torch.save(out, f"{io_dir}/out{rank}.pt")
    shutdown()


if __name__ == "__main__":
    main(sys.argv[1])
