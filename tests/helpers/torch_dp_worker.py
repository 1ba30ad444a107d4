"""One rank of a data-parallel world of the PyTorch port's LM trainer, on
the CPU over gloo, for tests/test_torch_distributed.py.  The world comes
from the launcher's env (``EDL_TPU_TRAINERS_NUM``, ``EDL_TPU_TRAINER_ID``,
``EDL_TPU_COORDINATOR``).

    python tests/helpers/torch_dp_worker.py steps <io_dir> <train_lm flags...>
        # io_dir/in.pt: {"weights": state_dict, "batches": [global [B, L+1] ids],
        #                "eval": [[B, L+1] ids per eval batch]}
        # trains one step per global batch on this rank's rows, evaluates
        # this rank's share of the eval batches (rank r takes every
        # world-th batch from r), writes io_dir/out<rank>.pt
    python tests/helpers/torch_dp_worker.py main <io_dir> <train_lm flags...>
        # train_lm.main(flags); writes io_dir/out<rank>.pt with the final
        # parameters, lr scale and epoch history
"""

import sys

import torch
import torch.distributed as dist

from edl_tpu_torch import train_lm
from edl_tpu_torch.cluster.env import TrainerEnv
from edl_tpu_torch.data.elastic_input import device_put_stream
from edl_tpu_torch.models.transformer import TransformerLM
from edl_tpu_torch.train import lr as lr_mod
from edl_tpu_torch.train.distributed import initialize_from_env, shutdown


def steps(io_dir, argv):
    tenv = initialize_from_env(TrainerEnv(), "cpu")
    rank, world = dist.get_rank(), dist.get_world_size()
    data = torch.load(f"{io_dir}/in.pt", weights_only=True)
    args = train_lm.parse_args(argv)
    cfg, trainer, _, tx = train_lm.build_trainer(args, torch.device("cpu"))

    def init():
        model = TransformerLM(cfg)
        model.load_state_dict(data["weights"])
        return model, None

    state = trainer.create_state(init, tx)
    gen = torch.Generator().manual_seed(0)
    losses = []
    local = ({"ids": ids.chunk(world)[rank]} for ids in data["batches"])
    for batch, _ in device_put_stream(local, trainer.device):
        state, metrics = trainer.step_fn(state, batch, gen)
        losses.append(float(metrics["loss"]))
    shard = [{"ids": b.numpy()} for b in data["eval"][rank::world]]
    val = trainer.evaluate(state, shard, train_lm.metric_fn)
    torch.save({"params": state.model.state_dict(), "losses": losses, "eval": val,
                "world": trainer.world_size, "rank": tenv.global_rank},
               f"{io_dir}/out{rank}.pt")
    shutdown()


def main(io_dir, argv):
    state, meta = train_lm.main(argv)
    rank = TrainerEnv().global_rank
    torch.save({"params": state.model.state_dict(), "lr_scale": lr_mod.lr_scale(state),
                "epoch_worlds": [e.world_size for e in meta.epochs], "step": state.step},
               f"{io_dir}/out{rank}.pt")


if __name__ == "__main__":
    {"steps": steps, "main": main}[sys.argv[1]](sys.argv[2], sys.argv[3:])
