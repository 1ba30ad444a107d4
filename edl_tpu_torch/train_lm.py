"""Elastic LM pretraining: the PyTorch port of ``examples/lm/train_lm.py``.

    python -m edl_tpu_torch.train_lm --layers 12 --embed 768 --heads 6 \\
        --mlp 3072 --vocab 32000 --seq_len 1024 --fused_ce

Same flags as the JAX example minus ``--scan_layers`` (layers are a Python
loop here), plus ``--device`` (default ``cuda``; ``cpu`` only when asked);
``--pp`` raises (not ported yet), and so does ``--moe`` with ``--sp`` > 1.
The mesh flags are the JAX example's: ``--fsdp`` (FSDP2), ``--sp``
(sequence parallelism: each rank trains a chunk of every sequence, with
``--attention ring`` over the ring, else with the sequence gathered for
attention), ``--ep`` (expert parallelism, with ``--moe``), ``--tp`` (0 =
auto: 2 when the ranks left by fsdp x sp x ep are even, else 1, chosen
again at each live reshard) and ``--dcn_dp`` (data-parallel replica groups
across pods; 0 = one per pod when each pod holds the rest of the mesh).
``--moe E`` makes every block's MLP E routed experts (``--moe_top_k`` of
them per token); the loss adds ``--moe_aux_weight`` times the aux loss,
reported as the metric ``moe_aux``.  One process drives one card, so a
mesh is over the world's ranks, and the sp, tp and ep ranks of one data
coordinate read the same rows.  Under the elastic
launcher (``python -m edl_tpu.collective.launch ...
edl_tpu_torch/train_lm.py``) one process runs per trainer: the launcher's
env forms the world (NCCL on the card, gloo on the CPU), names the
coordination store the trainer reports to, and gives the checkpoint
directory.  Under the
launcher's defaults a membership change reshards the world live, in the
same processes, restoring from the pods' in-RAM checkpoint caches
(``train/trainer.py``); with ``EDL_TPU_RESIZE_DELTA=0`` a run stopped by
it resumes from its last checkpoint in a world of the new size.
``--batch_size`` is per data coordinate (dp x fsdp).  Compute is bf16 on the card and
f32 on the CPU; the optimizer is AdamW with optax's defaults.  The
synthetic corpus is the same order-1 Markov chain (numpy, so a seed gives
the same tokens as the JAX example): the loss must fall well below the
unigram entropy for a run to count.  ``EDL_TPU_DEMO_STEP_SLEEP`` seconds
of sleep before each step pace a run, as in the JAX example trainers.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="elastic LM pretraining")
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--steps_per_epoch", type=int, default=20)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--seq_len", type=int, default=128)
    p.add_argument("--vocab", type=int, default=256)
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--embed", type=int, default=128)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--kv_heads", type=int, default=0,
                   help="grouped-query attention: K/V heads (0 = --heads, i.e. MHA)")
    p.add_argument("--mlp", type=int, default=256)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--tp", type=int, default=0, help="0 = auto (2 if even)")
    p.add_argument("--fsdp", type=int, default=1,
                   help="zero-style parameter sharding axis size (FSDP2)")
    p.add_argument("--dcn_dp", type=int, default=0,
                   help="data-parallel replica groups across pods; 0 = auto (one group per pod)")
    p.add_argument("--sp", type=int, default=1,
                   help="sequence-parallel axis size (each rank a chunk of the sequence)")
    p.add_argument("--pp", type=int, default=1, help="not ported")
    p.add_argument("--moe", type=int, default=0,
                   help=">0 replaces each block's FFN with this many routed experts, "
                        "sharded over the ep mesh axis")
    p.add_argument("--moe_top_k", type=int, default=2)
    p.add_argument("--moe_aux_weight", type=float, default=0.01)
    p.add_argument("--ep", type=int, default=1,
                   help="expert-parallel mesh axis size (use with --moe)")
    p.add_argument("--attention", default="auto",
                   choices=["auto", "dense", "splash", "flash", "ring"])
    p.add_argument("--remat", nargs="?", const="on", default="auto",
                   choices=["auto", "on", "off"],
                   help="recompute layers in the backward; auto = off when "
                        "the batch fits device memory (transformer.auto_layout)")
    p.add_argument("--fused_ce", action="store_true",
                   help="blockwise fused cross-entropy: never build the "
                        "[B, L, vocab] logits (edl_tpu_torch/ops/ce.py)")
    p.add_argument("--ce_block", type=int, default=4096)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if args.pp != 1:
        raise NotImplementedError("--pp is not ported to edl_tpu_torch yet "
                                  "(ROADMAP.md Queue 1 item 7)")
    # the JAX example's exits, in its order
    if args.fsdp < 1 or args.sp < 1 or args.ep < 1:
        raise SystemExit("--fsdp, --sp and --ep must be >= 1")
    if args.tp < 0:
        raise SystemExit("--tp must be >= 0")
    if args.ep > 1 and not args.moe:
        raise SystemExit("--ep needs --moe (no expert weights to shard)")
    if args.moe and args.moe_top_k > args.moe:
        raise SystemExit(f"--moe_top_k {args.moe_top_k} cannot exceed "
                         f"--moe {args.moe} experts")
    if args.moe and args.sp > 1:
        raise NotImplementedError("--moe with --sp > 1 is not ported: the capacity counts "
                                  "run over each row's whole sequence (ROADMAP.md Queue 1, "
                                  "MoE x sp)")
    return args


def mesh_spec(args):
    """``world -> MeshSpec``: the JAX example's rule, ``tp`` auto from the
    ranks left once fsdp, sp and ep take their share (2 if even), over a
    world size that a live reshard may change."""
    from edl_tpu_torch.parallel.mesh import MeshSpec

    def spec(world: int) -> MeshSpec:
        free = max(1, world // (args.fsdp * args.sp * args.ep))
        tp = args.tp or (2 if free % 2 == 0 else 1)
        return MeshSpec(dp=-1, fsdp=args.fsdp, tp=tp, sp=args.sp, ep=args.ep,
                        dcn_dp=args.dcn_dp)

    return spec


def markov_corpus(args, seed):
    """Order-1 Markov chain with a sparse, peaked transition table —
    learnable sequence structure (unigram entropy >> bigram entropy)."""
    rng = np.random.default_rng(7)  # the CHAIN is fixed across hosts
    nxt = rng.integers(0, args.vocab, (args.vocab, 4))  # 4 likely successors

    def batches(epoch_rng):
        ids = np.empty((args.batch_size, args.seq_len + 1), np.int32)
        for b in range(args.batch_size):
            t = int(epoch_rng.integers(args.vocab))
            for i in range(args.seq_len + 1):
                ids[b, i] = t
                if epoch_rng.random() < 0.9:  # peaked transitions
                    t = int(nxt[t, epoch_rng.integers(4)])
                else:
                    t = int(epoch_rng.integers(args.vocab))
        return ids

    erng = np.random.default_rng(seed)
    while True:
        yield {"ids": batches(erng)}


def build_config(args, device: torch.device):
    """The model config of ``args``, with remat resolved by auto_layout."""
    from edl_tpu_torch.models.transformer import TransformerConfig, auto_layout

    cfg = TransformerConfig(vocab_size=args.vocab, num_layers=args.layers,
                            embed_dim=args.embed, num_heads=args.heads,
                            num_kv_heads=args.kv_heads, mlp_dim=args.mlp,
                            max_len=args.seq_len, attention_impl=args.attention,
                            moe_experts=args.moe, moe_top_k=args.moe_top_k,
                            dtype=torch.bfloat16 if device.type == "cuda"
                            else torch.float32)
    auto = auto_layout(cfg, args.batch_size, args.seq_len, device=device)
    return dataclasses.replace(cfg, scan_layers=auto.scan_layers, remat=(
        auto.remat if args.remat == "auto" else args.remat == "on"))


def _inputs(model, ids):
    """``(inputs, targets)`` of next-token prediction on ``ids [B, L+1]``:
    under sp this rank's chunk of each (``parallel/sharding.py:seq_chunk``)."""
    from edl_tpu_torch.parallel.sharding import seq_chunk

    sp = getattr(model, "sp", None)
    return seq_chunk(ids[:, :-1], sp), seq_chunk(ids[:, 1:], sp)


def make_loss_fn(args):
    """``loss_fn(model, extra, batch, gen)`` for the trainer: next-token CE
    of ``batch["ids"]``, fused or over the full logits, plus
    ``--moe_aux_weight`` times the MoE aux loss (metric ``moe_aux``)."""
    from edl_tpu_torch.models.transformer import lm_loss

    def loss_fn(model, extra, batch, gen):
        ids, targets = _inputs(model, batch["ids"])
        if args.fused_ce:
            # the fused loss inside the forward, where FSDP2 gathered the head
            nll, aux = model(ids, targets=targets, ce_block=args.ce_block, with_aux=True)
            loss = nll.mean()
        else:
            logits, aux = model(ids, with_aux=True)
            loss = lm_loss(logits, targets)
        metrics = {}
        if args.moe:
            loss = loss + args.moe_aux_weight * aux
            metrics["moe_aux"] = aux.detach()
        return loss, (extra, metrics)

    return loss_fn


def metric_fn(model, extra, batch):
    """Per-example mean token NLL over the full logits (under sp, of this
    rank's chunk: the ranks' means average to the whole's)."""
    ids, targets = _inputs(model, batch["ids"])
    logp = torch.log_softmax(model(ids).float(), dim=-1)
    tok = logp.gather(-1, targets.long()[..., None])[..., 0]
    return {"nll": -tok.mean(dim=-1)}


def build_trainer(args, device: torch.device, checkpoint_dir: str = "", store=None,
                  tenv=None, force_fsdp: bool = False):
    """``(cfg, trainer, init_fn, tx)`` for ``args`` on ``device``, on the
    mesh of ``args`` over the formed world (collective); the global batch
    is ``--batch_size`` times the mesh's batch divisor.  ``force_fsdp``:
    FSDP2 even on an fsdp axis of 1.  Place the model by passing
    ``LOGICAL_RULES`` to ``create_state``/``restore_or_create``."""
    from edl_tpu_torch.models.transformer import TransformerLM
    from edl_tpu_torch.train.state import adamw
    from edl_tpu_torch.train.trainer import ElasticTrainer, TrainConfig

    cfg = build_config(args, device)
    trainer = ElasticTrainer(
        make_loss_fn(args),
        TrainConfig(checkpoint_dir=checkpoint_dir, log_every=0, mesh_spec=mesh_spec(args),
                    force_fsdp=force_fsdp),
        store=store, tenv=tenv, device=device)
    trainer.cfg.global_batch_size = args.batch_size * trainer.world_size

    def init_fn():
        return TransformerLM(cfg, torch.Generator().manual_seed(0)), None

    return cfg, trainer, init_fn, adamw(args.lr)


def main(argv=None):
    """Train; returns the final ``(TrainState, State)``."""
    from edl_tpu_torch.cluster.env import TrainerEnv
    from edl_tpu_torch.train.distributed import connect_store, initialize_from_env, shutdown
    from edl_tpu_torch.utils.device import resolve_device

    args = parse_args(argv)
    device = resolve_device(args.device)
    tenv = initialize_from_env(TrainerEnv(), device)
    if device.type == "cuda" and tenv.world_size > 1:
        device = torch.device("cuda", torch.cuda.current_device())  # bound to this rank
    store = connect_store(tenv)
    try:
        return _train(args, device, tenv, store)
    finally:
        if store is not None:
            store.close()
        shutdown()


def _mesh(trainer) -> dict:
    from edl_tpu_torch.parallel.mesh import mesh_sizes
    return mesh_sizes(trainer.layout)


def _train(args, device, tenv, store):
    from edl_tpu_torch.models.transformer import LOGICAL_RULES

    rank = tenv.global_rank
    cfg, trainer, init_fn, tx = build_trainer(args, device, tenv.checkpoint_dir, store, tenv)
    world = trainer.processes
    state, meta = trainer.restore_or_create(init_fn, tx, LOGICAL_RULES)
    print(f"[train_lm] rank={rank}/{world} device={device} mesh={_mesh(trainer)} "
          f"attn={args.attention} remat={cfg.remat} resume_epoch={meta.next_epoch}", flush=True)
    step_sleep = float(os.environ.get("EDL_TPU_DEMO_STEP_SLEEP", "0"))

    def data_fn(epoch: int):
        # the data coordinate read at each epoch: a live reshard re-ranks
        # this process and may change the mesh
        gen = markov_corpus(args, 1000 * (epoch + 1) + trainer.data_rank)
        for _ in range(args.steps_per_epoch):
            if step_sleep:  # launcher tests pace the run so a pod can join mid-run
                time.sleep(step_sleep)
            yield next(gen)

    losses = []

    def on_epoch_end(epoch, st, meta_):
        gen = markov_corpus(args, 999_000 + epoch)
        val = trainer.evaluate(st, (next(gen) for _ in range(4)), metric_fn)
        losses.append(round(val["nll"], 4))
        print(f"[train_lm] epoch {epoch}: val_nll={val['nll']:.4f}", flush=True)

    state, meta = trainer.fit(state, meta, data_fn, epochs=args.epochs,
                              on_epoch_end=on_epoch_end)
    rec = {"val_nll": losses[-1] if losses else None, "nll_curve": losses,
           "unigram_nll": round(float(np.log(args.vocab)), 4), "world": trainer.processes,
           "mesh": _mesh(trainer), "device": str(device)}
    print(f"[train_lm] {json.dumps(rec)}", flush=True)
    marker = os.environ.get("EDL_TPU_DEMO_MARKER")
    if marker:
        with open(marker, "a") as f:
            f.write("done " + json.dumps(rec) + "\n")
    return state, meta


if __name__ == "__main__":
    main()
