"""Elastic CTR training, Wide&Deep with embedding tables cut over ``ep``: the
PyTorch port of ``examples/ctr/train_wide_deep.py`` (reference
example/ctr/ctr/train.py, tables on parameter servers).

Under the unchanged elastic launcher, one trainer a pod::

    python -m edl_tpu.collective.launch --job_id ctr --nodes_range 1:4 \\
        --checkpoint_dir /ckpt/ctr edl_tpu_torch/train_wide_deep.py -- \\
        --epochs 3 --batch_size 256

The same flags and defaults as the JAX example (8 slots of vocab 1000, 8
dense features, embed 16, hidden 128 64, batch 256 a data rank, 3 epochs of
30 steps, Adam 2e-3), plus ``--device`` (default ``cuda``; ``cpu`` only when
asked):

- the model is ``models/wide_deep.py:WideDeep`` in its default dtype, bf16,
  on the card, and in f32 on the CPU (as the JAX example computes bf16 on a
  TPU only);
- ``ep`` is 2 when the world is even, else 1 (JAX counts devices; one
  process drives one card here, so the world's processes): each ep rank
  holds ``vocab / ep`` rows of every table (``WideDeep``'s docstring), the
  ep ranks read the same rows (seeded by the trainer's data rank, the
  example's rank along dp) and ``--batch_size`` is per data rank;
- the loss is ``optax.sigmoid_binary_cross_entropy`` (``F.binary_cross_
  entropy_with_logits``), the optimizer the example's ``optax.adam(lr)``,
  AdamW without decay (``train/state.py:adamw(lr, weight_decay=0.0)``);
- the click model (truth from ``default_rng(7)``) and the rank-based AUC are
  the example's, to the bit; the test AUC is over ``--test_batches`` batches
  of ``default_rng(999)``, and the ``[wide-deep] {json}`` line and the
  ``EDL_TPU_DEMO_MARKER`` line keep the example's format.

A checkpoint holds the global tables, so a run saved at ep 2 resumes at ep
1.  :func:`main` returns the record (``auc``, ``world``, ``epochs``).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch
import torch.nn.functional as F


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="elastic Wide&Deep CTR training")
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--steps_per_epoch", type=int, default=30)
    p.add_argument("--batch_size", type=int, default=256, help="per host")
    p.add_argument("--slots", type=int, default=8)
    p.add_argument("--vocab", type=int, default=1000)
    p.add_argument("--dense_features", type=int, default=8)
    p.add_argument("--embed_dim", type=int, default=16)
    p.add_argument("--hidden", type=int, nargs="+", default=[128, 64])
    p.add_argument("--lr", type=float, default=2e-3)
    p.add_argument("--test_batches", type=int, default=20)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def click_model(args, rng, n):
    """Ground-truth CTR: logit = sum of per-id sparse weights + a dense
    term; labels are Bernoulli clicks."""
    truth = np.random.default_rng(7)
    w_sparse = truth.normal(0, 1.0, (args.slots, args.vocab)).astype(np.float32)
    w_dense = truth.normal(0, 1.0, args.dense_features).astype(np.float32)

    sparse = rng.integers(0, args.vocab, (n, args.slots)).astype(np.int32)
    dense = rng.normal(0, 1, (n, args.dense_features)).astype(np.float32)
    logit = (w_sparse[np.arange(args.slots)[None], sparse].sum(1)
             + dense @ w_dense) * 0.8
    label = (rng.random(n) < 1 / (1 + np.exp(-logit))).astype(np.float32)
    return {"dense": dense, "sparse": sparse, "label": label}


def auc(scores, labels) -> float:
    """Rank-based AUC (the reference's fluid.layers.auc metric)."""
    order = np.argsort(scores)
    ranks = np.empty(len(scores))
    ranks[order] = np.arange(1, len(scores) + 1)
    pos = labels > 0.5
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    if n_pos == 0 or n_neg == 0:
        return 0.5
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2)
                 / (n_pos * n_neg))


def make_model(args, device: torch.device, dtype: torch.dtype | None = None):
    """``WideDeep`` at ``args``' widths, seed-0 weights: bf16 compute on the
    card and f32 on the CPU unless ``dtype`` says."""
    from edl_tpu_torch.models.wide_deep import WideDeep

    if dtype is None:
        dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    return WideDeep(vocab_sizes=[args.vocab] * args.slots, dense_features=args.dense_features,
                    embed_dim=args.embed_dim, hidden=tuple(args.hidden), dtype=dtype,
                    generator=torch.Generator().manual_seed(0))


def loss_fn(model, extra, batch, gen):
    logits = model(batch["dense"], batch["sparse"])
    loss = F.binary_cross_entropy_with_logits(logits, batch["label"])
    return loss, (extra, {})


def mesh_spec(world: int):
    """The example's mesh: ``ep`` 2 when the world is even, dp the rest."""
    from edl_tpu_torch.parallel.mesh import MeshSpec
    return MeshSpec(ep=2 if world % 2 == 0 else 1)


def build_trainer(args, device: torch.device, checkpoint_dir: str = "", store=None,
                  tenv=None, dtype: torch.dtype | None = None):
    """``(trainer, init_fn, tx)`` over the formed world (collective): place
    the model with ``restore_or_create(init_fn, tx, LOGICAL_RULES)``."""
    from edl_tpu_torch.train.state import adamw
    from edl_tpu_torch.train.trainer import ElasticTrainer, TrainConfig

    trainer = ElasticTrainer(loss_fn, TrainConfig(checkpoint_dir=checkpoint_dir, log_every=0,
                                                  mesh_spec=mesh_spec),
                             store=store, tenv=tenv, device=device)
    trainer.cfg.global_batch_size = args.batch_size * trainer.world_size
    return trainer, (lambda: (make_model(args, device, dtype), None)), \
        adamw(args.lr, weight_decay=0.0)


@torch.no_grad()
def eval_auc(args, model, device: torch.device) -> float:
    """The example's test AUC: ``--test_batches`` click-model batches of
    ``default_rng(999)``."""
    rng = np.random.default_rng(999)
    scores, labels = [], []
    for _ in range(args.test_batches):
        b = click_model(args, rng, args.batch_size)
        scores.append(model(torch.from_numpy(b["dense"]).to(device),
                            torch.from_numpy(b["sparse"]).to(device)).cpu().numpy())
        labels.append(b["label"])
    return auc(np.concatenate(scores), np.concatenate(labels))


def main(argv=None) -> dict:
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


def _train(args, device, tenv, store) -> dict:
    from edl_tpu_torch.models.wide_deep import LOGICAL_RULES
    from edl_tpu_torch.parallel.mesh import mesh_sizes

    trainer, init_fn, tx = build_trainer(args, device, tenv.checkpoint_dir, store, tenv)
    state, meta = trainer.restore_or_create(init_fn, tx, LOGICAL_RULES)
    print(f"[wide-deep] rank={tenv.global_rank}/{trainer.processes} "
          f"mesh={mesh_sizes(trainer.layout)} resume_epoch={meta.next_epoch}", flush=True)

    def data_fn(epoch: int):
        # the data coordinate read at each epoch: a live reshard re-ranks
        rng = np.random.default_rng(1000 * (epoch + 1) + trainer.data_rank)
        for _ in range(args.steps_per_epoch):
            yield click_model(args, rng, args.batch_size)

    state, meta = trainer.fit(state, meta, data_fn, epochs=args.epochs)
    state.model.eval()
    rec = {"auc": round(eval_auc(args, state.model, device), 4), "world": trainer.processes,
           "epochs": sorted(e.epoch_no for e in meta.epochs)}
    print(f"[wide-deep] {json.dumps(rec)}", flush=True)
    marker = os.environ.get("EDL_TPU_DEMO_MARKER")
    if marker:
        with open(marker, "a") as f:
            f.write("done " + json.dumps(rec) + "\n")
    return rec


if __name__ == "__main__":
    main()
