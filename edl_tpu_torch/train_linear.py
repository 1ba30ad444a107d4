"""fit_a_line, elastic: the PyTorch port of
``examples/collective/train_linear.py`` (reference
example/fit_a_line/train_ft.py).

Under the unchanged elastic launcher, one trainer a pod::

    python -m edl_tpu.collective.launch --job_id lin --nodes_range 1:4 \\
        --checkpoint_dir /tmp/lin-ckpt edl_tpu_torch/train_linear.py \\
        -- --epochs 4 --steps_per_epoch 8

it reads the ``EDL_TPU_*`` env contract, forms the ``torch.distributed``
world when there is more than one trainer (NCCL on the card, gloo on the
CPU), trains a linear regressor data-parallel with a checkpoint each epoch,
and resumes from the last one whenever the launcher restarts it.  The same
flags and defaults as the JAX example, plus ``--device`` (default
``cuda``; ``cpu`` only when asked):

- the parameters ``{"w": [13, 1], "b": [1]}`` start at zero
  (:class:`Regressor`, which holds exactly those two leaves); the loss is
  ``mean((x @ w + b - y)²)``;
- the optimizer is the example's ``optax.sgd(lr)``: no momentum
  (``train/state.py:sgd(lr, momentum=0.0, nesterov=False)``), at
  ``scale_lr_for_batch(base_lr, global_batch, base_batch=16)``, recomputed
  from the world at each start;
- each trainer draws its data from ``default_rng(1000 + epoch * 100 +
  pod_rank)``; the truth is ``default_rng(0)``'s ``w``;
- the ``adjust`` hook prints ``[adjust] world old -> new`` on a world-size
  change; ``EDL_TPU_DEMO_STEP_SLEEP`` seconds of sleep before each step pace
  a run, and ``EDL_TPU_DEMO_MARKER`` names a file that gets the example's
  ``done rank=... world=... epochs=[...] w_err=...`` line.

:func:`main` returns ``{"w", "b", "w_err", "epochs", "resume_epoch",
"world"}``.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch
from torch import nn

FEATURES = 13


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="elastic linear regression (fit_a_line)")
    p.add_argument("--epochs", type=int, default=4)
    p.add_argument("--steps_per_epoch", type=int, default=8)
    p.add_argument("--batch_size", type=int, default=16, help="per host")
    p.add_argument("--base_lr", type=float, default=0.05)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


class Regressor(nn.Module):
    """The example's parameters ``w [13, 1]`` and ``b [1]``, at zero."""

    def __init__(self):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(FEATURES, 1))
        self.b = nn.Parameter(torch.zeros(1))

    def forward(self, x):
        return x @ self.w + self.b


def true_w() -> np.ndarray:
    return np.random.default_rng(0).normal(size=(FEATURES, 1)).astype(np.float32)


def batches(args, epoch: int, pod_rank: int, w_true: np.ndarray, step_sleep: float = 0.0):
    """The example's ``data_fn(epoch)`` of the trainer in pod ``pod_rank``."""
    erng = np.random.default_rng(1000 + epoch * 100 + pod_rank)
    for _ in range(args.steps_per_epoch):
        if step_sleep:   # integration tests pace the run to force joins
            time.sleep(step_sleep)
        x = erng.normal(size=(args.batch_size, FEATURES)).astype(np.float32)
        yield {"x": x, "y": x @ w_true}


def loss_fn(model, extra, batch, gen):
    loss = ((model(batch["x"]) - batch["y"]) ** 2).mean()
    return loss, (extra, {"mse": loss.detach()})


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
    from edl_tpu_torch.train.lr import scale_lr_for_batch
    from edl_tpu_torch.train.state import sgd
    from edl_tpu_torch.train.trainer import ElasticTrainer, TrainConfig

    w_true = true_w()
    step_sleep = float(os.environ.get("EDL_TPU_DEMO_STEP_SLEEP", "0"))
    global_batch = args.batch_size * max(1, tenv.world_size)
    lr = scale_lr_for_batch(args.base_lr, global_batch, base_batch=16)
    cfg = TrainConfig(checkpoint_dir=tenv.checkpoint_dir
                      or os.path.join(tempfile.gettempdir(), "edl-lin-ckpt"),
                      global_batch_size=global_batch, log_every=0)
    trainer = ElasticTrainer(loss_fn, cfg, store=store, tenv=tenv, device=device)
    # the LR rescale on a resize: the lr above is recomputed from the new
    # world at each start; the hook records the change
    trainer.adjust.register(
        lambda old, new, st: print(f"[adjust] world {old} -> {new}", flush=True))
    state, meta = trainer.restore_or_create(lambda: (Regressor(), None),
                                            sgd(lr, momentum=0.0, nesterov=False))
    resume_epoch = meta.next_epoch
    print(f"[train_linear] rank={tenv.global_rank}/{tenv.world_size} "
          f"resume_epoch={resume_epoch} lr={lr:.4f}", flush=True)
    state, meta = trainer.fit(
        state, meta, lambda e: batches(args, e, tenv.pod_rank, w_true, step_sleep),
        epochs=args.epochs)
    w = state.model.w.detach().cpu().numpy()
    final = float(np.mean((w - w_true) ** 2))
    epochs = sorted(e.epoch_no for e in meta.epochs)
    print(f"[train_linear] done: epochs={epochs} w_err={final:.5f}", flush=True)
    marker = os.environ.get("EDL_TPU_DEMO_MARKER")
    if marker:
        with open(marker, "a") as f:
            f.write(f"done rank={tenv.global_rank} world={tenv.world_size} "
                    f"epochs={epochs} w_err={final:.5f}\n")
    return {"w": w, "b": state.model.b.detach().cpu().numpy(), "w_err": final,
            "epochs": epochs, "resume_epoch": resume_epoch, "world": tenv.world_size}


if __name__ == "__main__":
    main()
