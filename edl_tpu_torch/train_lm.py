"""Elastic LM pretraining on one card: the PyTorch port of
``examples/lm/train_lm.py``.

    python -m edl_tpu_torch.train_lm --layers 12 --embed 768 --heads 6 \\
        --mlp 3072 --vocab 32000 --seq_len 1024 --fused_ce

Same flags as the JAX example minus those for meshes, pipelines and MoE
and ``--scan_layers`` (layers are a Python loop here), with ``--attention``
limited to the ported ``auto|dense|splash|flash``, plus ``--device`` (default
``cuda``; ``cpu`` only when asked).  The
checkpoint directory comes from the launcher's ``EDL_TPU_CKPT_DIR``, so a
stopped run resumes from its last epoch.  Compute is bf16 on the card and
f32 on the CPU; the optimizer is AdamW with optax's defaults.  The
synthetic corpus is the same order-1 Markov chain (numpy, so a seed gives
the same tokens as the JAX example): the loss must fall well below the
unigram entropy for a run to count.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="LM pretraining on one card")
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
    p.add_argument("--attention", default="auto", choices=["auto", "dense", "splash", "flash"])
    p.add_argument("--remat", nargs="?", const="on", default="auto",
                   choices=["auto", "on", "off"],
                   help="recompute layers in the backward; auto = off when "
                        "the batch fits device memory (transformer.auto_layout)")
    p.add_argument("--fused_ce", action="store_true",
                   help="blockwise fused cross-entropy: never build the "
                        "[B, L, vocab] logits (edl_tpu_torch/ops/ce.py)")
    p.add_argument("--ce_block", type=int, default=4096)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


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
                            dtype=torch.bfloat16 if device.type == "cuda"
                            else torch.float32)
    auto = auto_layout(cfg, args.batch_size, args.seq_len, device=device)
    return dataclasses.replace(cfg, scan_layers=auto.scan_layers, remat=(
        auto.remat if args.remat == "auto" else args.remat == "on"))


def make_loss_fn(args):
    """``loss_fn(model, extra, batch, gen)`` for the trainer: next-token CE
    of ``batch["ids"]``, fused or over the full logits."""
    from edl_tpu_torch.models.transformer import lm_loss, lm_loss_fused

    def loss_fn(model, extra, batch, gen):
        ids = batch["ids"]
        if args.fused_ce:
            h = model(ids[:, :-1], return_hidden=True)
            loss = lm_loss_fused(model, h, ids[:, 1:], block_size=args.ce_block)
        else:
            loss = lm_loss(model(ids[:, :-1]), ids[:, 1:])
        return loss, (extra, {})

    return loss_fn


def metric_fn(model, extra, batch):
    """Per-example mean token NLL over the full logits."""
    ids = batch["ids"]
    logp = torch.log_softmax(model(ids[:, :-1]).float(), dim=-1)
    tok = logp.gather(-1, ids[:, 1:].long()[..., None])[..., 0]
    return {"nll": -tok.mean(dim=-1)}


def build_trainer(args, device: torch.device, checkpoint_dir: str = ""):
    """``(cfg, trainer, init_fn, tx)`` for ``args`` on ``device`` (one
    process, so the global batch is ``--batch_size``)."""
    from edl_tpu_torch.models.transformer import TransformerLM
    from edl_tpu_torch.train.state import adamw
    from edl_tpu_torch.train.trainer import ElasticTrainer, TrainConfig

    cfg = build_config(args, device)
    trainer = ElasticTrainer(
        make_loss_fn(args),
        TrainConfig(checkpoint_dir=checkpoint_dir, global_batch_size=args.batch_size,
                    log_every=0),
        device=device)

    def init_fn():
        return TransformerLM(cfg, torch.Generator().manual_seed(0)), None

    return cfg, trainer, init_fn, adamw(args.lr)


def main(argv=None) -> None:
    from edl_tpu_torch.cluster.env import TrainerEnv
    from edl_tpu_torch.utils.device import resolve_device

    args = parse_args(argv)
    device = resolve_device(args.device)
    tenv = TrainerEnv()
    rank = tenv.global_rank
    cfg, trainer, init_fn, tx = build_trainer(args, device, tenv.checkpoint_dir)
    state, meta = trainer.restore_or_create(init_fn, tx)
    print(f"[train_lm] device={device} attn={args.attention} remat={cfg.remat} "
          f"resume_epoch={meta.next_epoch}", flush=True)

    def data_fn(epoch: int):
        gen = markov_corpus(args, 1000 * (epoch + 1) + rank)
        for _ in range(args.steps_per_epoch):
            yield next(gen)

    losses = []

    def on_epoch_end(epoch, st, meta_):
        gen = markov_corpus(args, 999_000 + epoch)
        val = trainer.evaluate(st, (next(gen) for _ in range(4)), metric_fn)
        losses.append(round(val["nll"], 4))
        print(f"[train_lm] epoch {epoch}: val_nll={val['nll']:.4f}", flush=True)

    trainer.fit(state, meta, data_fn, epochs=args.epochs, on_epoch_end=on_epoch_end)
    rec = {"val_nll": losses[-1] if losses else None, "nll_curve": losses,
           "unigram_nll": round(float(np.log(args.vocab)), 4), "world": 1,
           "device": str(device)}
    print(f"[train_lm] {json.dumps(rec)}", flush=True)
    marker = os.environ.get("EDL_TPU_DEMO_MARKER")
    if marker:
        with open(marker, "a") as f:
            f.write("done " + json.dumps(rec) + "\n")


if __name__ == "__main__":
    main()
