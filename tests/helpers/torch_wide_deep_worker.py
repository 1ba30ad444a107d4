"""One rank of a gloo world training ``train_wide_deep``'s model at the
world's mesh (ep = 2 in a world of two): 3 steps on the batches in
``io_dir/batches.pt``, then a checkpoint under ``io_dir/ckpt``.  Writes
``io_dir/out<rank>.pt``: the losses, the mesh, the data rank and this
rank's table rows."""

import pathlib
import sys

import torch

from edl_tpu_torch import train_wide_deep as twd
from edl_tpu_torch.cluster.env import TrainerEnv
from edl_tpu_torch.models.wide_deep import LOGICAL_RULES
from edl_tpu_torch.parallel.mesh import mesh_sizes
from edl_tpu_torch.train.distributed import initialize_from_env, shutdown


def main(io: pathlib.Path) -> None:
    torch.set_num_threads(1)
    cpu = torch.device("cpu")
    tenv = initialize_from_env(TrainerEnv(), cpu)
    spec = torch.load(io / "batches.pt", weights_only=False)
    args = twd.parse_args(spec["argv"])
    trainer, init_fn, tx = twd.build_trainer(args, cpu, str(io / "ckpt"), tenv=tenv)
    state, meta = trainer.restore_or_create(init_fn, tx, LOGICAL_RULES)
    gen = torch.Generator()
    losses = []
    for b in spec["batches"]:
        state, metrics = trainer.step_fn(state, {k: torch.from_numpy(v) for k, v in b.items()},
                                         gen)
        losses.append(float(metrics["loss"]))
    meta.step = state.step
    trainer.ckpt.save(state.step, state, meta, force=True)
    trainer.ckpt.wait()
    tables = {n: p.detach().clone() for n, p in state.model.named_parameters()
              if n.startswith(("embed_", "wide_"))}
    torch.save({"losses": losses, "mesh": mesh_sizes(trainer.layout),
                "data_rank": trainer.data_rank, "tables": tables,
                "rank": tenv.global_rank}, io / f"out{tenv.global_rank}.pt")
    shutdown()


if __name__ == "__main__":
    main(pathlib.Path(sys.argv[1]))
