"""One rank of a 4-rank gloo world on the CPU running the multi-rank cases
of ``tests/test_torch_ring.py`` in one world:

    python tests/helpers/torch_ring_worker.py <io_dir>
        # io_dir/in.pt: {"attn": {case: (q, k, v, g) global arrays and
        #   options}, "lm": {"weights", "cfg", "ids"}, "batches", "flags"}
        # writes io_dir/out<rank>.pt

1. ring attention (and the gathered sequence, ``impl="dense"`` with an sp
   group) on each case's mesh: this rank's rows, sequence chunk and heads
   of the output, and of dq, dk and dv of ``sum(out * g)``; a mesh whose
   dp coordinate the world cannot hold runs its dp pieces one after the
   other;
2. the LM's logits at dp 2 x sp 2 with ring and with the gathered auto
   attention, each rank on its rows and chunk;
3. ``ElasticTrainer`` through ``train_lm --sp 2``: with ``--attention
   ring --tp 1`` (dp 2 x sp 2), with the default attention (auto tp:
   sp 2 x tp 2) and with ``--fsdp 2`` (FSDP2's mean, then sp's), 3 steps
   each: the losses and the parameters after them.
"""

import sys

import torch
import torch.distributed as dist

from edl_tpu_torch import train_lm
from edl_tpu_torch.cluster.env import TrainerEnv
from edl_tpu_torch.models import transformer as ttf
from edl_tpu_torch.ops.attention import dot_product_attention
from edl_tpu_torch.parallel.mesh import MeshSpec, build_mesh, coordinate
from edl_tpu_torch.parallel.sharding import seq_chunk, shard_host_batch, shard_init
from edl_tpu_torch.parallel.tp import SP
from edl_tpu_torch.train.distributed import initialize_from_env, shutdown


def _piece(x, rows, sp, heads):
    """``x [B, L, H, D]``'s dp rows ``(index, ways)``, this sp rank's chunk
    and the heads ``(index, ways)``."""
    x = x.chunk(rows[1], dim=0)[rows[0]]
    x = seq_chunk(x, sp)
    return x.chunk(heads[1], dim=2)[heads[0]].contiguous()


def _attention(case, rank):
    """Every dp piece of this rank's coordinate: ``[((rows, seq, q heads,
    kv heads), out, dq, dk, dv)]``, each part ``(index, ways)``."""
    mesh = build_mesh(MeshSpec(**case["mesh"]), pods=[0, 0, 0, 0])
    sp, c = SP.of(mesh), coordinate(mesh, rank)
    tp_ways = case["mesh"].get("tp", 1)
    q, k, v, g = (t.to(case["dtype"]) for t in case["tensors"])
    Hk = k.shape[2]
    res = []
    for d in range(case["dp_pieces"]):
        rows = (c["dp"] * case["dp_pieces"] + d, case["mesh"].get("dp", 1) * case["dp_pieces"])
        heads = (c["tp"], tp_ways)
        ql, gl = _piece(q, rows, sp, heads), _piece(g, rows, sp, heads)
        kl, vl = (_piece(t, rows, sp, heads if Hk > 1 else (0, 1)) for t in (k, v))
        for t in (ql, kl, vl):
            t.requires_grad_(True)
        out = dot_product_attention(ql, kl, vl, causal=case["causal"], impl=case["impl"], sp=sp,
                                    ring_kv_chunk=case["chunk"])
        (out.float() * gl.float()).sum().backward()
        seq = (0, 1) if sp is None else (sp.rank, sp.size)
        res.append(((rows, seq, heads, heads if Hk > 1 else (0, 1)),
                    out.detach(), ql.grad, kl.grad, vl.grad))
    return res


def _logits(data, rank, impl):
    mesh = build_mesh(MeshSpec(dp=2, sp=2), pods=[0, 0, 0, 0])
    cfg = ttf.TransformerConfig(attention_impl=impl, **data["lm"]["cfg"])

    def make():
        m = ttf.TransformerLM(cfg, init=False)
        m.load_state_dict(data["lm"]["weights"])
        return m

    model = shard_init(make, ttf.LOGICAL_RULES, mesh)
    rows = data["lm"]["ids"].chunk(2)[coordinate(mesh, rank)["dp"]]
    with torch.no_grad():
        return model(seq_chunk(rows, model.sp))


def _train(data, rank, flags):
    args = train_lm.parse_args(data["flags"] + flags)
    cfg, trainer, _, tx = train_lm.build_trainer(args, torch.device("cpu"))

    def init():
        model = ttf.TransformerLM(cfg, init=False)
        model.load_state_dict(data["lm"]["weights"])
        return model, None

    state = trainer.create_state(init, tx, ttf.LOGICAL_RULES)
    gen = torch.Generator().manual_seed(0)
    losses = []
    for ids in data["batches"]:
        rows = shard_host_batch({"ids": ids.numpy()}, trainer.layout, rank)
        state, metrics = trainer.step_fn(state, {"ids": torch.from_numpy(rows["ids"])}, gen)
        losses.append(float(metrics["loss"]))
    full = state.full_state_dict()
    return {"losses": losses, "params": {n: t.clone() for n, t in full["model"].items()},
            "mesh": dict(zip(("dp", "fsdp", "pp", "sp", "tp", "ep"), trainer.layout.shape))}


def main(io_dir):
    initialize_from_env(TrainerEnv(), "cpu")
    rank = dist.get_rank()
    data = torch.load(f"{io_dir}/in.pt", weights_only=False)
    out = {"rank": rank, "attn": {name: _attention(case, rank)
                                  for name, case in data["attn"].items()}}
    out["logits_ring"] = _logits(data, rank, "ring")
    out["logits_auto"] = _logits(data, rank, "auto")
    out["train_ring"] = _train(data, rank, ["--sp", "2", "--attention", "ring", "--tp", "1"])
    out["train_auto"] = _train(data, rank, ["--sp", "2"])
    out["train_fsdp"] = _train(data, rank, ["--sp", "2", "--fsdp", "2"])
    torch.save(out, f"{io_dir}/out{rank}.pt")
    shutdown()


if __name__ == "__main__":
    main(sys.argv[1])
