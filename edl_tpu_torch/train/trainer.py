"""ElasticTrainer: the train loop with stop-resume, single process.

The port of the JAX package's ``train/trainer.py`` for one process on one
device:

- the step: loss and gradient, then apply the gradients, then add
  ``loss`` to the metrics (the JAX step body); parameters and optimizer
  moments are updated in place;
- epoch accounting and the data checkpoint in a :class:`State` sidecar
  saved with every checkpoint (per epoch, and every ``save_every_steps``);
- resume: restore the latest checkpoint and continue from
  ``State.next_epoch``, with :class:`AdjustRegistry` callbacks on a world
  size change.

Not here yet (they wait for the distributed slice, ROADMAP.md Queue 1
item 4): the coordination store, train-status reports, the heartbeat,
the delta replication plane, live reshard and preemption.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Any, Callable, Iterable

import numpy as np
import torch

from edl_tpu_torch.cluster.state import AdjustRegistry, DataCheckpoint, State
from edl_tpu_torch.train.checkpoint import CheckpointManager
from edl_tpu_torch.train.state import OptimizerFactory, TrainState
from edl_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

# loss_fn(model, extra, batch, generator) -> (loss, (new_extra, metrics))
LossFn = Callable[[torch.nn.Module, Any, Any, torch.Generator],
                  tuple[torch.Tensor, tuple[Any, dict]]]


@dataclass
class TrainConfig:
    checkpoint_dir: str = ""
    save_every_steps: int = 0          # 0 = per-epoch only
    max_to_keep: int = 3
    log_every: int = 100
    global_batch_size: int = 0


class ElasticTrainer:
    def __init__(self, loss_fn: LossFn, config: TrainConfig | None = None,
                 device: str | torch.device = "cuda"):
        self.cfg = config or TrainConfig()
        self.loss_fn = loss_fn
        self.device = resolve_device(device)
        self.adjust = AdjustRegistry()
        self.ckpt = (CheckpointManager(self.cfg.checkpoint_dir, self.cfg.max_to_keep)
                     if self.cfg.checkpoint_dir else None)

    @property
    def world_size(self) -> int:
        return 1

    # -- state construction --------------------------------------------------
    def create_state(self, init_fn: Callable[[], tuple[torch.nn.Module, Any]],
                     tx: OptimizerFactory) -> TrainState:
        """``init_fn() -> (module, extra)``; the module is moved to the
        trainer's device before its optimizer is built."""
        model, extra = init_fn()
        return TrainState.create(model.to(self.device), tx, extra)

    def restore_or_create(self, init_fn, tx) -> tuple[TrainState, State]:
        meta = State(total_batch_size=self.cfg.global_batch_size)
        state = self.create_state(init_fn, tx)
        if self.ckpt is None or self.ckpt.latest_step() is None:
            return state, meta
        state, saved_meta = self.ckpt.restore(state)
        if saved_meta is not None:
            meta = saved_meta
        old_world = _last_world(meta)
        if old_world and old_world != self.world_size:
            logger.info("world size %d -> %d; running adjust functions",
                        old_world, self.world_size)
            self.adjust.run(old_world, self.world_size, meta)
        return state, meta

    # -- the step ------------------------------------------------------------
    def to_device(self, batch):
        """A host batch (numpy arrays, nested in dicts) as tensors on the
        trainer's device."""
        if isinstance(batch, dict):
            return {k: self.to_device(v) for k, v in batch.items()}
        if isinstance(batch, np.ndarray):
            batch = torch.from_numpy(batch)
        if isinstance(batch, torch.Tensor):
            return batch.to(self.device, non_blocking=True)
        return batch

    def step_fn(self, state: TrainState, batch, gen: torch.Generator):
        """One update on a device batch: ``(state, metrics)`` with
        ``metrics["loss"]`` a device scalar."""
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        loss, (new_extra, metrics) = self.loss_fn(state.model, state.extra, batch, gen)
        loss.backward()
        state.apply_gradients(new_extra)
        metrics = dict(metrics or {})
        metrics["loss"] = loss.detach()
        return state, metrics

    # -- the loop ------------------------------------------------------------
    def fit(self, state: TrainState, meta: State,
            data_fn: Callable[[int], Iterable[Any]], epochs: int, seed: int = 0,
            on_epoch_end: Callable[[int, TrainState, State], None] | None = None,
            ) -> tuple[TrainState, State]:
        """Run epochs ``meta.next_epoch .. epochs-1``; each ``data_fn(e)``
        yields host batches.  ``on_epoch_end`` runs after the epoch's
        checkpoint commits; what it writes into ``meta`` is patched into
        that checkpoint's sidecar."""
        for epoch in range(meta.next_epoch, epochs):
            gen = torch.Generator(device=self.device).manual_seed(
                seed * 1_000_003 + epoch)
            state, meta = self._run_epoch(state, meta, data_fn, epoch, gen, on_epoch_end)
        return state, meta

    def _run_epoch(self, state, meta, data_fn, epoch, gen, on_epoch_end=None):
        t_epoch, n_steps = time.monotonic(), 0
        start_step = state.step
        if meta.in_epoch != epoch:
            # entering fresh (not a mid-epoch resume): reset the data
            # checkpoint so mid-epoch saves this epoch start from zero
            meta.in_epoch = epoch
            meta.epoch_start_step = start_step
            meta.data_checkpoint = DataCheckpoint()
        for batch in data_fn(epoch):
            state, metrics = self.step_fn(state, self.to_device(batch), gen)
            n_steps += 1
            step = start_step + n_steps
            if self.cfg.log_every and step % self.cfg.log_every == 0:
                logger.info("epoch %d step %d: %s", epoch, step,
                            {k: float(v) for k, v in metrics.items()})
            if (self.ckpt is not None and self.cfg.save_every_steps
                    and step % self.cfg.save_every_steps == 0):
                meta.step = step
                self.ckpt.save(step, state, meta)
        dt = time.monotonic() - t_epoch
        # step_num covers the whole epoch, including segments trained
        # before a mid-epoch stop-resume; avg time reflects this segment
        total_steps = (start_step + n_steps) - meta.epoch_start_step
        meta.record_epoch(epoch, self.world_size, total_steps, dt / max(1, n_steps))
        meta.step = start_step + n_steps
        meta.epoch_no = epoch
        meta.in_epoch = -1  # epoch complete: next resume starts the next one
        if self.ckpt is not None:
            if self.cfg.save_every_steps and self.ckpt.latest_step() == state.step:
                # the last mid-epoch save already holds this step's arrays
                self.ckpt.save_meta(state.step, meta)
            else:
                self.ckpt.save(state.step, state, meta, force=True)
        if on_epoch_end is not None:
            before = meta.to_json()
            on_epoch_end(epoch, state, meta)
            if self.ckpt is not None and meta.to_json() != before:
                self.ckpt.save_meta(state.step, meta)
        logger.info("epoch %d done: %d steps in %.1fs", epoch, n_steps, dt)
        return state, meta

    # -- eval ----------------------------------------------------------------
    @torch.no_grad()
    def evaluate(self, state: TrainState, batches: Iterable[Any],
                 metric_fn) -> dict[str, float]:
        """Sample-weighted means of per-example metrics:
        ``metric_fn(model, extra, batch) -> {name: (B,) tensor}``."""
        totals: dict[str, torch.Tensor] = {}
        count = 0
        was_training = state.model.training
        state.model.eval()
        try:
            for batch in batches:
                vals = metric_fn(state.model, state.extra, self.to_device(batch))
                for k, v in vals.items():
                    totals[k] = totals.get(k, 0.0) + v.float().sum()
                count += len(next(iter(vals.values())))
        finally:
            state.model.train(was_training)
        return {k: float(v) / max(1, count) for k, v in totals.items()}


def _last_world(meta: State) -> int:
    """World size of the most recent recorded epoch."""
    if not meta.epochs:
        return 0
    return max(meta.epochs, key=lambda e: e.epoch_no).world_size
