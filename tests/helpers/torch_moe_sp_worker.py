"""One rank of a 4-rank gloo world on the CPU running the multi-rank cases
of ``tests/test_torch_moe_sp.py`` in one world:

    python tests/helpers/torch_moe_sp_worker.py <io_dir>
        # io_dir/in.pt: {"probs": [B, S, E], "valid": [B, S] bool, "capacity",
        #   "weights": the MoE LM's full state dict, "cfg", "batches":
        #   [global [B, L+1] ids], "flags": train_lm flags, "lr": SGD's}
        # writes io_dir/out<rank>.pt

1. ``compute_routing`` on this rank's chunk of the sequence at sp 2 (two
   groups of two ranks) and at sp 4 (the world), with and without a token
   mask: dispatch, combine, aux, drops;
2. ``train_lm --moe 4`` at dp 2 x sp 2 (ring attention) and at sp 2 x ep 2
   (the sequence gathered for attention): the drops of a forward before the
   first step (this rank's rows, the whole sequence), 3 SGD steps, the losses
   and aux, the first step's gradients gathered whole, the parameters
   after the last step.
"""

import sys

import torch
import torch.distributed as dist

from edl_tpu_torch import train_lm
from edl_tpu_torch.cluster.env import TrainerEnv
from edl_tpu_torch.models import transformer as ttf
from edl_tpu_torch.ops.moe import compute_routing
from edl_tpu_torch.parallel.sharding import shard_host_batch, to_full
from edl_tpu_torch.parallel.tp import SP
from edl_tpu_torch.train.distributed import initialize_from_env, shutdown


def _routing(data, rank, size):
    """This rank's chunk of every row through ``compute_routing`` over an
    sp group of ``size`` consecutive ranks."""
    groups = [dist.new_group(list(range(g, g + size))) for g in range(0, 4, size)]
    sp = SP(groups[rank // size], rank % size, size)
    probs, valid = data["probs"], data["valid"]
    n = probs.shape[1] // size
    rows = slice(sp.rank * n, (sp.rank + 1) * n)
    out = {"chunk": sp.rank}
    for key, mask in (("all", None), ("masked", valid[:, rows])):
        d, c, aux, drops = compute_routing(probs[:, rows], 2, data["capacity"], valid=mask, sp=sp)
        out[key] = {"dispatch": d, "combine": c, "aux": float(aux), "drops": int(drops)}
    return out


def _train(data, rank, flags, out, key):
    args = train_lm.parse_args(data["flags"] + flags)
    _, trainer, _, _ = train_lm.build_trainer(args, torch.device("cpu"))
    # plain SGD: AdamW would blow a near-zero gradient's last-ulp difference
    # up to a full step of the learning rate
    tx = lambda params: torch.optim.SGD(params, lr=data["lr"])      # noqa: E731
    cfg = ttf.TransformerConfig(**data["cfg"], attention_impl=args.attention)

    def init():
        model = ttf.TransformerLM(cfg, init=False)
        model.load_state_dict(data["weights"])
        return model, None

    state = trainer.create_state(init, tx, ttf.LOGICAL_RULES)
    model = state.model
    first = shard_host_batch({"ids": data["batches"][0].numpy()}, trainer.layout, rank)
    ids, _ = train_lm._inputs(model, torch.from_numpy(first["ids"]))
    drops = torch.zeros((), dtype=torch.int32)
    with torch.no_grad():
        model(ids, return_hidden=True, drops=drops)
    losses, auxes, grads = [], [], None
    for batch in data["batches"]:
        rows = shard_host_batch({"ids": batch.numpy()}, trainer.layout, rank)
        state, metrics = trainer.step_fn(state, {"ids": torch.from_numpy(rows["ids"])}, None)
        losses.append(float(metrics["loss"]))
        auxes.append(float(metrics["moe_aux"]))
        if grads is None:
            grads = {n: to_full(p.grad, model.param_layouts[n], model.tp, model.ep).clone()
                     for n, p in model.named_parameters()}
    full = state.full_state_dict()
    out[key] = {"losses": losses, "auxes": auxes, "grads": grads, "drops": int(drops),
                "params": {n: t.clone() for n, t in full["model"].items()},
                "mesh": dict(zip(("dp", "fsdp", "pp", "sp", "tp", "ep"), trainer.layout.shape)),
                "data_rank": trainer.data_rank, "sp_rank": model.sp.rank,
                "w_in_local": tuple(model.layers[0].moe.w_in.shape)}


def main(io_dir):
    initialize_from_env(TrainerEnv(), "cpu")
    rank = dist.get_rank()
    data = torch.load(f"{io_dir}/in.pt", weights_only=False)
    out = {"rank": rank, "sp2": _routing(data, rank, 2), "sp4": _routing(data, rank, 4)}
    _train(data, rank, ["--sp", "2", "--tp", "1", "--attention", "ring"], out, "dp2_sp2_ring")
    _train(data, rank, ["--sp", "2", "--ep", "2", "--tp", "1"], out, "sp2_ep2")
    torch.save(out, f"{io_dir}/out{rank}.pt")
    shutdown()


if __name__ == "__main__":
    main(sys.argv[1])
