"""One rank of a 4-rank gloo world on the CPU running the mesh cases of
``tests/test_torch_mesh_train.py`` in one world:

    python tests/helpers/torch_mesh_worker.py <io_dir>
        # io_dir/in.pt: {"weights", "gqa_weights": full state dicts,
        #   "batches": [global [B, L+1] ids], "ids": [B, L] ids for logits,
        #   "ce": {"hidden", "weight", "targets", "g"}, "flags": train_lm flags}
        # writes io_dir/out<rank>.pt

1. meshes: ``build_mesh`` with ``dcn_dp`` over two pods, and the default mesh;
2. ``ElasticTrainer`` at fsdp 2 x tp 2 (FSDP2 and the tp forward): 3 steps
   on this rank's rows, the local shapes of every parameter and of both
   AdamW moments, this rank's peer-cache pieces, then a storage checkpoint
   (collective) in io_dir/ckpt;
3. the LM's logits on a dp 2 x tp 2 mesh, MHA and GQA (kv heads 2), each
   rank on its data coordinate's rows;
4. the vocab-parallel fused CE on that mesh's tp group: per-token NLL and
   the gradients of ``sum(nll * g)``.
"""

import sys

import torch
import torch.distributed as dist

from edl_tpu_torch import train_lm
from edl_tpu_torch.cluster.env import TrainerEnv
from edl_tpu_torch.cluster.state import State
from edl_tpu_torch.memstate import shards
from edl_tpu_torch.models import transformer as ttf
from edl_tpu_torch.ops.ce import blockwise_cross_entropy
from edl_tpu_torch.parallel.mesh import MeshSpec, build_mesh, data_index, default_mesh, mesh_sizes
from edl_tpu_torch.parallel.sharding import shard_host_batch, shard_init
from edl_tpu_torch.parallel.tp import TP
from edl_tpu_torch.train.checkpoint import CheckpointManager
from edl_tpu_torch.train.distributed import initialize_from_env, shutdown


def _local(t):
    return t.to_local() if hasattr(t, "to_local") else t


def main(io_dir):
    initialize_from_env(TrainerEnv(), "cpu")
    rank = dist.get_rank()
    data = torch.load(f"{io_dir}/in.pt", weights_only=True)
    out = {"rank": rank}

    # 1. meshes (the pods: ranks 0, 1 on pod 0; 2, 3 on pod 1)
    hybrid = build_mesh(MeshSpec(dp=-1, tp=2, dcn_dp=2), pods=[0, 0, 1, 1])
    out["hybrid"] = (mesh_sizes(hybrid), hybrid.mesh.tolist(), hybrid.get_local_rank("tp"))
    out["default"] = mesh_sizes(default_mesh(pods=[1, 0, 1, 0]))
    out["default_ranks"] = default_mesh(pods=[1, 0, 1, 0]).mesh.reshape(-1).tolist()

    # 2. the trainer at fsdp 2 x tp 2
    args = train_lm.parse_args(data["flags"] + ["--fsdp", "2", "--tp", "2"])
    cfg, trainer, _, tx = train_lm.build_trainer(args, torch.device("cpu"))

    def init():
        model = ttf.TransformerLM(cfg, init=False)
        model.load_state_dict(data["weights"])
        return model, None

    state = trainer.create_state(init, tx, ttf.LOGICAL_RULES)
    gen = torch.Generator().manual_seed(0)
    losses = []
    for ids in data["batches"]:
        rows = shard_host_batch({"ids": ids.numpy()}, trainer.layout, rank)
        state, metrics = trainer.step_fn(state, {"ids": torch.from_numpy(rows["ids"])}, gen)
        losses.append(float(metrics["loss"]))
    out["losses"] = losses
    out["world_size"], out["data_rank"] = trainer.world_size, trainer.data_rank
    out["shapes"] = {f"model/{n}": (tuple(_local(p).shape), tuple(p.shape))
                     for n, p in state.model.named_parameters()}
    params = [p for g in state.optimizer.param_groups for p in g["params"]]
    names = {id(p): n for n, p in state.model.named_parameters()}
    for p in params:
        for k in ("exp_avg", "exp_avg_sq"):
            m = state.optimizer.state[p][k]
            out["shapes"][f"{k}/{names[id(p)]}"] = (tuple(_local(m).shape),
                                                   type(m).__name__ == "DTensor")
    full = state.full_state_dict()
    out["params"] = {n: t.clone() for n, t in full["model"].items()}
    # the peer cache's pieces: this rank's first-replica boxes
    snap = shards.snapshot(state)
    out["pieces"] = {key: (snap.manifest[key], host.clone()) for key, host in snap.shards}
    ckpt = CheckpointManager(f"{io_dir}/ckpt")
    meta = State(total_batch_size=trainer.cfg.global_batch_size)
    meta.record_epoch(0, trainer.world_size, state.step, 0.0)
    out["saved"] = ckpt.save(state.step, state, meta)

    # 3. logits on dp 2 x tp 2, MHA and GQA
    mesh = build_mesh(MeshSpec(dp=2, tp=2), pods=[0, 0, 0, 0])
    coord = data_index(mesh, rank)
    for key, weights, c in (("logits", data["weights"], cfg),
                            ("gqa_logits", data["gqa_weights"], data["gqa_cfg"])):
        tc = ttf.TransformerConfig(dtype=torch.float32, remat=False, **c) if isinstance(c, dict) \
            else c

        def make(tc=tc, weights=weights):
            m = ttf.TransformerLM(tc, init=False)
            m.load_state_dict(weights)
            return m

        model = shard_init(make, ttf.LOGICAL_RULES, mesh)
        rows = data["ids"].chunk(2)[coord]
        with torch.no_grad():
            out[key] = model(rows)
        out[key + "_shapes"] = {n: tuple(p.shape) for n, p in model.named_parameters()}

    # 4. the vocab-parallel CE on the tp group
    tp = TP.of(mesh)
    ce = data["ce"]
    hidden = ce["hidden"].clone().requires_grad_(True)
    cols = ce["weight"].shape[1] // tp.size
    weight = ce["weight"][:, tp.rank * cols:(tp.rank + 1) * cols].clone().requires_grad_(True)
    nll = blockwise_cross_entropy(hidden, weight, ce["targets"], block_size=ce["block"], tp=tp)
    (nll * ce["g"]).sum().backward()
    out["ce"] = {"nll": nll.detach(), "dh": hidden.grad, "dw": weight.grad,
                 "cols": (tp.rank * cols, (tp.rank + 1) * cols)}
    torch.save(out, f"{io_dir}/out{rank}.pt")
    shutdown()


if __name__ == "__main__":
    main(sys.argv[1])
