"""ElasticTrainer: the train loop with stop-resume elasticity.

The port of the JAX package's ``train/trainer.py``, one process per card:

- the step: loss and gradient, then apply the gradients, then add
  ``loss`` to the metrics (the JAX step body); parameters and optimizer
  moments are updated in place;
- data parallelism over a ``torch.distributed`` world
  (``train/distributed.py``): parameters replicated, the batch split over
  processes, and after the backward one all-reduce per gradient dtype of
  a flat buffer, divided by the world, so the update is the gradient of
  the mean loss over the global batch (JAX's replicated-parameter mesh);
  without a process group the step does no extra work;
- input staged one batch ahead (``data/elastic_input.py:device_put_stream``:
  pinned host memory and a side CUDA stream on the card), as the JAX
  trainer's ``prefetch_batches = 1``; a data-service batch's record spans
  are marked into the data checkpoint when the batch is trained, never when
  it is staged;
- epoch accounting and the data checkpoint in a :class:`State` sidecar
  saved with every checkpoint (per epoch, and every ``save_every_steps``),
  every process's spans merged into it before each save;
- resume: restore the latest checkpoint and continue from
  ``State.next_epoch``, with :class:`AdjustRegistry` callbacks and, under
  ``EDL_TPU_LR_RESCALE=1``, the world-derived LR rescale on a world-size
  change;
- with a coordination store: train-status reports (RUNNING, NEARTHEEND,
  SUCCEED), which the launcher's generator reads to stop scaling near
  the end, and a throttled heartbeat after completed steps for its hang
  watchdog.  Both are best-effort;
- under the launcher: the trainer half of the resize's recovery-time
  record (checkpoint restored, first step after it; ``cluster/recovery.py``),
  and the SIGTERM preemption grace: at an agreed step every rank saves a
  checkpoint and exits ``PREEMPT_EXIT_CODE`` (``cluster/preempt.py``).

Not here yet (ROADMAP.md Queue 1 item 4e, second part): the live reshard,
the delta replication plane and the peer checkpoint cache; the step
metrics wait for the port's observability modules.
"""

from __future__ import annotations

import logging
import os
import sys
import time
from dataclasses import dataclass
from typing import Any, Callable, Iterable

import torch
import torch.distributed as dist

from edl_tpu_torch.cluster import heartbeat, preempt, recovery
from edl_tpu_torch.cluster.env import TrainerEnv
from edl_tpu_torch.cluster.state import AdjustRegistry, DataCheckpoint, State
from edl_tpu_torch.cluster.train_status import TrainStatus, save_train_status
from edl_tpu_torch.data.elastic_input import device_put_stream, sync_checkpoint
from edl_tpu_torch.train import lr as lr_mod
from edl_tpu_torch.train.checkpoint import CheckpointManager
from edl_tpu_torch.train.state import OptimizerFactory, TrainState
from edl_tpu_torch.utils import constants
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
    near_end_epochs: int = 1           # NEARTHEEND window, in epochs
    # liveness beat to the coordination store after completed steps,
    # throttled to this period (the launcher's hang watchdog); 0 disables
    heartbeat_every: float = 10.0


class ElasticTrainer:
    """``input_stats`` sums, over every epoch this trainer ran,
    ``input_wait_s``, the seconds the loop was blocked obtaining a batch
    (the staging's own wait taken out), and ``h2d_wait_s``, the seconds it
    waited for a staged copy."""

    def __init__(self, loss_fn: LossFn, config: TrainConfig | None = None,
                 store=None, tenv: TrainerEnv | None = None,
                 device: str | torch.device = "cuda"):
        self.cfg = config or TrainConfig()
        self.loss_fn = loss_fn
        self.device = resolve_device(device)
        self.store = store
        self.tenv = tenv
        self.adjust = AdjustRegistry()
        self.ckpt = (CheckpointManager(self.cfg.checkpoint_dir, self.cfg.max_to_keep)
                     if self.cfg.checkpoint_dir else None)
        self._run_t0: float | None = None     # fit() start: the first beat's threshold
        self._last_step_t: float | None = None
        self._step_ema: float | None = None
        self._last_beat = 0.0
        self._t_restored: float | None = None  # a restore's time, until its first step
        self._preempt_seen = False
        self._preempt_next_check: int | None = None  # the agreed next check step (world)
        self._preempt_last_check_t = 0.0              # the last check's time (solo)
        self.input_stats = {"input_wait_s": 0.0, "h2d_wait_s": 0.0}

    @property
    def world_size(self) -> int:
        """The formed process group's size (1 without one)."""
        return dist.get_world_size() if dist.is_initialized() else 1

    # -- state construction --------------------------------------------------
    def create_state(self, init_fn: Callable[[], tuple[torch.nn.Module, Any]],
                     tx: OptimizerFactory) -> TrainState:
        """``init_fn() -> (module, extra)``; the module is moved to the
        trainer's device before its optimizer is built.  Under
        ``EDL_TPU_LR_RESCALE=1`` the optimizer carries the world scale
        (``train/lr.py``), restored with it from every checkpoint."""
        if constants.lr_rescale():
            tx = lr_mod.world_scaled(tx)
        model, extra = init_fn()
        return TrainState.create(model.to(self.device), tx, extra)

    def restore_or_create(self, init_fn, tx) -> tuple[TrainState, State]:
        meta = State(total_batch_size=self.cfg.global_batch_size)
        state = self.create_state(init_fn, tx)
        if self.ckpt is None or self.ckpt.latest_step() is None:
            return state, meta
        state, saved_meta = self.ckpt.restore(state)
        self._t_restored = time.time()  # the recovery record's "restored"
        if saved_meta is not None:
            meta = saved_meta
        old_world, new_world = _last_world(meta), self.world_size
        if old_world and old_world != new_world:
            logger.info("world size %d -> %d; running adjust functions",
                        old_world, new_world)
            self.adjust.run(old_world, new_world, meta)
            state = self._world_lr_rescale(state, old_world, new_world)
        return state, meta

    def _world_lr_rescale(self, state, old_world: int, new_world: int):
        """``EDL_TPU_LR_RESCALE``: multiply the optimizer's world scale by
        new / old (the linear LR-vs-global-batch rule)."""
        if not constants.lr_rescale() or not old_world or old_world == new_world:
            return state
        factor = new_world / old_world
        logger.info("LR rescale: world %d -> %d, effective-LR factor %.3f",
                    old_world, new_world, factor)
        return lr_mod.rescale_state(state, factor)

    # -- the step ------------------------------------------------------------
    def step_fn(self, state: TrainState, batch, gen: torch.Generator):
        """One update on a device batch: ``(state, metrics)`` with
        ``metrics["loss"]`` a device scalar."""
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        loss, (new_extra, metrics) = self.loss_fn(state.model, state.extra, batch, gen)
        loss.backward()
        loss = loss.detach()
        if dist.is_initialized():
            loss = _mean_over_world(state.model, loss)
        state.apply_gradients(new_extra)
        metrics = dict(metrics or {})
        metrics["loss"] = loss
        return state, metrics

    # -- the loop ------------------------------------------------------------
    def fit(self, state: TrainState, meta: State,
            data_fn: Callable[[int], Iterable[Any]], epochs: int, seed: int = 0,
            on_epoch_end: Callable[[int, TrainState, State], None] | None = None,
            ) -> tuple[TrainState, State]:
        """Run epochs ``meta.next_epoch .. epochs-1``; each ``data_fn(e)``
        yields host batches.  ``on_epoch_end`` runs after the epoch's
        checkpoint commits; what it writes into ``meta`` is patched into
        that checkpoint's sidecar.  Reports RUNNING, NEARTHEEND for the
        last ``near_end_epochs`` epochs, and SUCCEED at the end."""
        if self._run_t0 is None:
            self._run_t0 = time.monotonic()
        self._report(TrainStatus.RUNNING)
        for epoch in range(meta.next_epoch, epochs):
            if epochs - epoch <= self.cfg.near_end_epochs:
                self._report(TrainStatus.NEARTHEEND)
            gen = torch.Generator(device=self.device).manual_seed(
                seed * 1_000_003 + epoch)
            state, meta = self._run_epoch(state, meta, data_fn, epoch, gen, on_epoch_end)
        self._report(TrainStatus.SUCCEED)
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
        stream = device_put_stream(data_fn(epoch), self.device)
        batches = iter(stream)
        while True:
            t0, h2d0 = time.perf_counter(), stream.h2d_wait_s
            item = next(batches, None)
            self.input_stats["input_wait_s"] += (time.perf_counter() - t0
                                                 - (stream.h2d_wait_s - h2d0))
            self.input_stats["h2d_wait_s"] += stream.h2d_wait_s - h2d0
            if item is None:
                break
            batch, spans = item
            # marked when the batch is trained, so a save holds exactly the
            # trained records whatever the staging depth
            for fi, b, e in spans or ():
                meta.data_checkpoint.mark_processed(fi, b, e)
            state, metrics = self.step_fn(state, batch, gen)
            n_steps += 1
            step = start_step + n_steps
            self._observe_step_time()
            if self._t_restored is not None:
                self._report_recovery(metrics)
            self._heartbeat()
            self._maybe_preempt(state, meta, step)
            if self.cfg.log_every and step % self.cfg.log_every == 0:
                logger.info("epoch %d step %d: %s", epoch, step,
                            {k: float(v) for k, v in metrics.items()})
            if (self.ckpt is not None and self.cfg.save_every_steps
                    and step % self.cfg.save_every_steps == 0):
                meta.step = step
                self._sync_data_checkpoint(meta)
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
            self._sync_data_checkpoint(meta)
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

    # -- liveness and status -------------------------------------------------
    def _observe_step_time(self) -> None:
        """EMA of the wall time between completed-step observations.  Steps
        are queued on the card asynchronously, but the queue is bounded,
        so the loop's steady rate is the card's step rate."""
        now = time.monotonic()
        if self._last_step_t is not None:
            dt = now - self._last_step_t
            self._step_ema = dt if self._step_ema is None else 0.9 * self._step_ema + 0.1 * dt
        self._last_step_t = now

    def _heartbeat(self) -> None:
        """Throttled liveness beat after a completed step (rank 0 in the
        pod), for the launcher's hang watchdog.  The first beat comes after
        step 1, so start-up is never taken for a hang.  Publishes the
        self-derived stale threshold, max(10 x EMA step, 120 s), the first
        beat's from the wall time since fit() began, unless
        ``EDL_TPU_HANG_TIMEOUT`` sets one; beats at least 3x faster than
        the threshold in force.  Best-effort."""
        if (self.store is None or self.tenv is None or not self.tenv.pod_id
                or self.tenv.rank_in_pod != 0 or not self.cfg.heartbeat_every):
            return
        hang_timeout = constants.hang_timeout()
        threshold = None
        if hang_timeout == 0:
            ema = self._step_ema
            if ema is None and self._run_t0 is not None:
                ema = time.monotonic() - self._run_t0
            threshold = heartbeat.auto_threshold(ema)
        every = self.cfg.heartbeat_every
        effective = hang_timeout if hang_timeout > 0 else threshold
        if effective:
            every = min(every, effective / 3.0)
        now = time.monotonic()
        if now - self._last_beat < every:
            return
        self._last_beat = now
        try:
            heartbeat.beat(self.store, self.tenv.job_id, self.tenv.pod_id, threshold=threshold)
        except Exception:  # noqa: BLE001 — liveness must never fail a job
            logger.exception("heartbeat write failed")

    def _report_recovery(self, metrics) -> None:
        """Trainer half of the resize's timing record: the checkpoint
        restored, and the first step after it finished.  The launcher wrote
        detect/killed/barrier/spawn under the same stage key; the merged
        record is the recovery time (``cluster/recovery.py``).  Once, on
        rank 0 of the pod, under the launcher; best-effort."""
        t_restored, self._t_restored = self._t_restored, None
        if (self.store is None or self.tenv is None or not self.tenv.cluster_stage
                or self.tenv.rank_in_pod != 0):
            return
        metrics["loss"].item()  # the step truly finished on the device
        try:
            recovery.write_trainer_half(self.store, self.tenv.job_id, self.tenv.cluster_stage,
                                        self.tenv.pod_id, restored=t_restored,
                                        first_step=time.time(), restore_source="storage")
        except Exception:  # noqa: BLE001 — metrics must never fail a job
            logger.exception("recovery record write failed")

    def _maybe_preempt(self, state: TrainState, meta: State, step: int) -> None:
        """The SIGTERM preemption grace (``cluster/preempt.py``): at a
        step-aligned cadence, check the stage's preempt flag; on a sighting,
        checkpoint at this step and exit ``PREEMPT_EXIT_CODE``.

        Who takes part is decided from env facts only, the same for every
        process the launcher spawned: a process whose store connect failed
        still enters the collective below, with nothing seen.  Only rank 0
        of a pod reads the store.  A solo process checks every
        ``preempt_check_seconds()`` of wall time.  In a world the save is
        collective, so every rank must check at the same steps: the first
        check lands on a ``preempt_check_steps()`` multiple, and each check
        is one all-reduce MAX of ``[seen, proposal]``, which gives every
        rank any sighting and the largest proposal for the distance to the
        next check (its step-time EMA's steps in ``preempt_check_seconds()``)."""
        if self.tenv is None or not self.tenv.pod_id or not self.tenv.cluster_stage:
            return
        multi = self.world_size > 1
        if multi:
            if self._preempt_next_check is None:
                if step % max(1, constants.preempt_check_steps()):
                    return
            elif step != self._preempt_next_check:
                return
        else:
            now = time.monotonic()
            if now - self._preempt_last_check_t < constants.preempt_check_seconds():
                return
            self._preempt_last_check_t = now
        if self.store is not None and self.tenv.rank_in_pod == 0 and not self._preempt_seen:
            try:
                self._preempt_seen = preempt.get_preempt(
                    self.store, self.tenv.job_id, self.tenv.cluster_stage) is not None
            except Exception:  # noqa: BLE001 — a store blip is not a preemption
                logger.exception("preempt flag read failed")
        agreed = self._preempt_seen
        if multi:
            proposal = constants.preempt_check_steps()
            if self._step_ema:
                proposal = round(constants.preempt_check_seconds() / max(self._step_ema, 1e-4))
            flags = torch.tensor([int(self._preempt_seen), max(1, proposal)],
                                 dtype=torch.int64, device=self.device)
            dist.all_reduce(flags, op=dist.ReduceOp.MAX)
            seen, spacing = flags.tolist()
            agreed = bool(seen)
            self._preempt_next_check = step + int(spacing)
        if agreed:
            self._preempt_exit(state, meta, step)

    def _preempt_exit(self, state: TrainState, meta: State, step: int) -> None:
        """Checkpoint at ``step`` (collective), wait until every rank's save
        has committed, log why, and leave with ``PREEMPT_EXIT_CODE``."""
        logger.warning("preemption flagged: checkpointing at step %d", step)
        if self.ckpt is not None:
            meta.step = step
            self._sync_data_checkpoint(meta)
            self.ckpt.save(step, state, meta, force=True)
            logger.info("preempt: checkpoint committed at step %d", step)
        if self.world_size > 1:
            dist.barrier()  # no rank leaves before every save has committed
        # the workerlog says why this pod left: its own per-pod record holds
        # the eviction reason; a pod leaving on a peer's preemption has none
        reason = "peer-preempt"
        if self.store is not None:
            try:
                info = preempt.pod_preempt_info(self.store, self.tenv.job_id,
                                                self.tenv.cluster_stage, self.tenv.pod_id)
                if info is not None:
                    reason = info[1]
            except Exception as e:  # noqa: BLE001 — the reason is best-effort
                logger.debug("preempt reason read failed: %s", e)
        logger.warning("preempt: exiting %d (reason=%s)", constants.PREEMPT_EXIT_CODE, reason)
        # os._exit, not SystemExit: the process group's teardown can hang once
        # a peer leaving by the same agreement has gone; only buffers remain
        for h in logging.getLogger().handlers:
            try:
                h.flush()
            except Exception:  # noqa: BLE001 — a last flush before the exit
                pass
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(constants.PREEMPT_EXIT_CODE)

    def _sync_data_checkpoint(self, meta: State) -> None:
        """Before every save, merge all processes' consumed data spans into
        the sidecar rank 0 writes (``data/elastic_input.py:sync_checkpoint``).
        Collective: save points are step-aligned across processes."""
        sync_checkpoint(meta.data_checkpoint)

    def _report(self, status: TrainStatus) -> None:
        if self.store is None or self.tenv is None or not self.tenv.pod_id:
            return
        try:
            save_train_status(self.store, self.tenv.job_id, self.tenv.pod_id, status)
        except Exception:  # noqa: BLE001 — reporting is best-effort
            logger.exception("train-status report failed")

    # -- eval ----------------------------------------------------------------
    @torch.no_grad()
    def evaluate(self, state: TrainState, batches: Iterable[Any],
                 metric_fn) -> dict[str, float]:
        """Sample-weighted means of per-example metrics over every rank's
        batches: ``metric_fn(model, extra, batch) -> {name: (B,) tensor}``.
        The host batches are staged on the device one ahead, as in training
        (``device_put_stream``).  Ranks may hold different numbers of
        batches (none, too); every rank returns the global means."""
        totals: dict[str, torch.Tensor] = {}
        count = 0
        was_training = state.model.training
        state.model.eval()
        try:
            for batch, _spans in device_put_stream(batches, self.device):
                vals = metric_fn(state.model, state.extra, batch)
                for k, v in vals.items():
                    totals[k] = totals.get(k, 0.0) + v.float().sum()
                count += len(next(iter(vals.values())))
        finally:
            state.model.train(was_training)
        sums = {k: float(v) for k, v in totals.items()}
        if dist.is_initialized() and dist.get_world_size() > 1:
            parts: list = [None] * dist.get_world_size()
            dist.all_gather_object(parts, (sums, count))
            sums, count = {}, 0
            for part_sums, part_count in parts:
                for k, v in part_sums.items():
                    sums[k] = sums.get(k, 0.0) + v
                count += part_count
        return {k: v / max(1, count) for k, v in sums.items()}


def _mean_over_world(model: torch.nn.Module, loss: torch.Tensor) -> torch.Tensor:
    """Replace every parameter gradient, and ``loss``, by its mean over the
    process group: one all-reduce per dtype of a flat buffer.  NCCL
    averages in the collective (its one-rank form premultiplies by 1, so a
    group of one changes no bit); gloo has no average, so it sums and
    divides.  Every rank must hold gradients for the same parameters."""
    tensors = [p.grad for p in model.parameters() if p.grad is not None] + [loss.reshape(1)]
    average = dist.get_backend() == "nccl"
    world = dist.get_world_size()
    for dtype in dict.fromkeys(t.dtype for t in tensors):
        group = [t for t in tensors if t.dtype == dtype]
        flat = torch.cat([t.reshape(-1) for t in group])
        if average:
            dist.all_reduce(flat, op=dist.ReduceOp.AVG)
        else:
            dist.all_reduce(flat)
            flat /= world
        offset = 0
        for t in group:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()
    return loss


def _last_world(meta: State) -> int:
    """World size of the most recent recorded epoch."""
    if not meta.epochs:
        return 0
    return max(meta.epochs, key=lambda e: e.epoch_no).world_size
