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
- a mesh (``TrainConfig.mesh_spec``, ``parallel/``) when the spec asks for
  more than data parallelism: the parameters placed by their logical axes
  (``create_state(param_logical=...)``), ``tp`` in the model's forward,
  ``fsdp`` as FSDP2 (HSDP with ``dp``), which reduces the gradients
  itself, ``ep`` (each rank this run of an MoE model's experts) and ``sp``
  (each rank a chunk of every sequence, the loss function's
  ``seq_chunk``); without fsdp the gradients are averaged over the data
  ranks of each (tp, ep) coordinate, dp x fsdp x sp of them (an ep-cut
  expert only over its replicas; an sp rank's partial sums with the
  others'), and under fsdp FSDP2's mean is followed by one over sp.  An
  MoE model's aux loss is the global batch's over those ranks
  (``TransformerLM.set_data``).  ``world_size`` is the mesh's batch divisor
  (dp x fsdp), the JAX trainer's for one process on a mesh of devices: the
  global batch, the LR rescale and the epoch records follow it;
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
  record (checkpoint restored, first step after it, where the state came
  from; ``cluster/recovery.py``), and the SIGTERM preemption grace: at an
  agreed step every rank saves a checkpoint and exits ``PREEMPT_EXIT_CODE``
  (``cluster/preempt.py``);
- under the launcher with the peer checkpoint cache (``EDL_TPU_MEMSTATE``,
  on by default): every committed save is teed into the pod's cache
  service, every ``EDL_TPU_DELTA_EVERY`` steps a delta record of the
  changed shards streams to it and to the ring replica, and a restore
  tries the cache (and the freshest world-agreed delta chain) before
  storage (``memstate/``);
- the live reshard (``EDL_TPU_RESIZE_DELTA``, on by default): on the
  launcher's grow flag the world pauses at an agreed step, commits a
  checkpoint and re-forms in the same processes
  (``train/distributed.py:reform_world``), restoring from the local
  snapshot and the caches; a failed collective becomes a shrink reshard
  that rolls back to the committed step or forward along the freshest
  agreed chain.  Each pod's rank 0 then writes ``done/<stage>/<pod>`` for
  the launcher's barrier, and any failure exits nonzero, which the
  launcher answers with stop-resume.  Survivors and joiners run the same
  collectives in the same order: the checkpoint's latest step, the delta
  target agreement, the restore, the all-ok vote.

The step metrics wait for the port's observability modules.
"""

from __future__ import annotations

import gc
import logging
import os
import sys
import time
import traceback
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable

import torch
import torch.distributed as dist

from edl_tpu_torch.cluster import heartbeat, preempt, recovery
from edl_tpu_torch.cluster.env import TrainerEnv
from edl_tpu_torch.cluster.state import AdjustRegistry, DataCheckpoint, State
from edl_tpu_torch.cluster.train_status import TrainStatus, save_train_status
from edl_tpu_torch.data.elastic_input import device_put_stream, sync_checkpoint
from edl_tpu_torch.parallel import mesh as mesh_mod
from edl_tpu_torch.parallel.sharding import ShardingRules, shard_init
from edl_tpu_torch.parallel.tp import AxisGroup
from edl_tpu_torch.train import distributed as edl_dist
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
class _ReshardPayload:
    """The epoch loop's hand-off to the live reshard, host-side only."""

    mode: str                    # "grow" (paused and saved) | "shrink" (roll back)
    local: dict | None = None    # {key: (manifest entry, bytes)} at ``step``
    step: int | None = None      # the paused step (grow)


class _PeerLost(RuntimeError):
    """A shrink flag seen under NCCL: the communicator was aborted."""


class _LiveReshard(Exception):
    """Raised at a step boundary to unwind the epoch loop into
    ``ElasticTrainer._live_reshard``."""

    def __init__(self, payload: _ReshardPayload):
        super().__init__(payload.mode)
        self.payload = payload


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
    # the mesh, or a function of the process count that gives it (resolved
    # again at each live reshard: a spec whose tp was chosen for a world
    # size may not divide the next one)
    mesh_spec: mesh_mod.MeshSpec | Callable[[int], mesh_mod.MeshSpec] = field(
        default_factory=mesh_mod.MeshSpec)
    rules: ShardingRules = field(default_factory=ShardingRules)
    # FSDP2 even on an fsdp axis of 1 (an NCCL group of one shows its cost)
    force_fsdp: bool = False


class ElasticTrainer:
    """``input_stats`` sums, over every epoch this trainer ran,
    ``input_wait_s``, the seconds the loop was blocked obtaining a batch
    (the staging's own wait taken out), and ``h2d_wait_s``, the seconds it
    waited for a staged copy.  ``restores`` lists each restore as
    ``{"source", "seconds", "step", "bytes", "wire_bytes", "local_bytes"}``
    and ``reshards`` each live reshard (mode, source, step, seconds, and
    the bytes kept local and moved); ``restore_fallbacks`` counts the
    cache restores that fell back to storage."""

    def __init__(self, loss_fn: LossFn, config: TrainConfig | None = None,
                 store=None, tenv: TrainerEnv | None = None,
                 device: str | torch.device = "cuda"):
        self.cfg = config or TrainConfig()
        self.loss_fn = loss_fn
        if tenv is not None and tenv.pod_id:
            _log_to_stderr()   # under the launcher stderr is the workerlog
        self.device = resolve_device(device)
        self.store = store
        self.tenv = tenv
        self.adjust = AdjustRegistry()
        self._delta_rep = None                 # memstate/delta.py, built with the manager
        self.ckpt = self._build_ckpt()
        self._build_fns = None                 # (init_fn, tx): a reshard's restore target
        self._restore_source: str | None = None   # "peer" | "delta" | "storage"
        self._reshard_seen = False
        self.restores: list[dict] = []
        self.reshards: list[dict] = []
        self.restore_fallbacks = 0
        self._run_t0: float | None = None     # fit() start: the first beat's threshold
        self._last_step_t: float | None = None
        self._step_ema: float | None = None
        self._last_beat = 0.0
        self._t_restored: float | None = None  # a restore's time, until its first step
        self._preempt_seen = False
        self._preempt_next_check: int | None = None  # the agreed next check step (world)
        self._preempt_last_check_t = 0.0              # the last check's time (solo)
        self.input_stats = {"input_wait_s": 0.0, "h2d_wait_s": 0.0}
        self._form_mesh()

    @property
    def world_size(self) -> int:
        """The mesh's batch divisor, dp x fsdp (the process count at tp = 1;
        1 without a process group)."""
        return mesh_mod.batch_divisor(self.layout)

    @property
    def processes(self) -> int:
        """The formed process group's size (1 without one): every rank takes
        part in the trainer's agreements."""
        return dist.get_world_size() if dist.is_initialized() else 1

    @property
    def data_rank(self) -> int:
        """This rank's position along the mesh's batch axes: which rows of
        the global batch it trains (the same at every tp coordinate)."""
        return mesh_mod.data_index(self.layout, dist.get_rank() if dist.is_initialized() else 0)

    def _form_mesh(self) -> None:
        """The rank layout of ``cfg.mesh_spec`` over the formed world (every
        rank's pod gathered: collective), and a ``DeviceMesh`` when the spec
        asks for more than data parallelism (or FSDP2 is forced).  Built at
        start and again after each live reshard."""
        spec = self.cfg.mesh_spec
        world = self.processes
        if callable(spec):
            spec = spec(world)
        pods = mesh_mod.pod_ranks() if world > 1 else [0]
        self.layout = mesh_mod.world_layout(spec, pods)
        sizes = mesh_mod.mesh_sizes(self.layout)
        self.mesh = self._data_group = self._sp_group = None
        # the ranks that train other rows or other chunks of them: the
        # step's gradient mean runs over them
        self._data_ways = sizes["dp"] * sizes["fsdp"] * sizes["sp"]
        self._data = (None if not dist.is_initialized() or self._data_ways == 1
                      else AxisGroup(None, dist.get_rank(), self._data_ways))
        if not dist.is_initialized() or not (self.cfg.force_fsdp or any(
                n > 1 for a, n in sizes.items() if a != "dp")):
            return
        self.mesh = mesh_mod.build_mesh(spec, pods, self.device.type)
        if sizes["sp"] > 1:
            self._sp_group = self.mesh.get_group("sp")
        if sizes["tp"] * sizes["ep"] > 1 and self._data_ways > 1:
            # the data ranks of each (tp, ep) coordinate, one group each
            # (every rank makes every group, in the same order): the step's
            # gradient mean when FSDP2 does not take it
            for t in range(sizes["tp"]):
                for e in range(sizes["ep"]):
                    ranks = sorted(int(r) for r in self.layout[..., t, e].reshape(-1))
                    group = dist.new_group(ranks)
                    if dist.get_rank() in ranks:
                        self._data_group = group
                        self._data = AxisGroup(group, ranks.index(dist.get_rank()),
                                               len(ranks))
        logger.info("mesh %s (rank %d: data rank %d)", sizes, dist.get_rank(), self.data_rank)

    def _build_ckpt(self) -> CheckpointManager | None:
        """The checkpoint manager, with the memstate tee and the delta
        replicator under the launcher.  Built at start and again after each
        live reshard (the old replicator targets the old membership)."""
        if self._delta_rep is not None:
            self._delta_rep.close(wait=False)
            self._delta_rep = None
        if not self.cfg.checkpoint_dir:
            return None
        tee = None
        if self.store is not None and self.tenv is not None and self.tenv.pod_id:
            from edl_tpu_torch import memstate
            if memstate.enabled():
                from edl_tpu_torch.memstate.tee import StateCacheTee
                tee = StateCacheTee(self.store, self.tenv.job_id, self.tenv.pod_id)
                if memstate.delta_enabled():
                    from edl_tpu_torch.memstate.delta import DeltaReplicator
                    self._delta_rep = DeltaReplicator(self.store, self.tenv.job_id,
                                                      self.tenv.pod_id)
        return CheckpointManager(self.cfg.checkpoint_dir, self.cfg.max_to_keep, tee=tee)

    # -- state construction --------------------------------------------------
    def create_state(self, init_fn: Callable[[], tuple[torch.nn.Module, Any]],
                     tx: OptimizerFactory, param_logical=None) -> TrainState:
        """``init_fn() -> (module, extra)``; the module is moved to the
        trainer's device before its optimizer is built.  ``param_logical``
        (a model's ``LOGICAL_RULES``): on a mesh the module is placed by
        them (``parallel/sharding.py:shard_init``), so AdamW's moments come
        out placed like their parameters; None keeps the parameters
        replicated.  Under ``EDL_TPU_LR_RESCALE=1`` the optimizer carries
        the world scale (``train/lr.py``), restored with it from every
        checkpoint."""
        self._build_fns = (init_fn, tx, param_logical)
        if constants.lr_rescale():
            tx = lr_mod.world_scaled(tx)
        model, extra = init_fn()
        model = model.to(self.device)
        if self.mesh is not None and param_logical is not None:
            model = shard_init(lambda: model, param_logical, self.mesh, self.cfg.rules,
                               fsdp=self.cfg.force_fsdp or None)
            model.mesh = self.mesh
        if hasattr(model, "set_data"):
            model.set_data(self._data)
        return TrainState.create(model, tx, extra)

    def restore_or_create(self, init_fn, tx, param_logical=None) -> tuple[TrainState, State]:
        """The latest checkpoint (collective) restored into a fresh state:
        from the peer cache when it holds that step (or a world-agreed
        delta chain past it), else from storage; a fresh state when there
        is none."""
        meta = State(total_batch_size=self.cfg.global_batch_size)
        state = self.create_state(init_fn, tx, param_logical)
        latest = self.ckpt.latest_step() if self.ckpt is not None else None
        if latest is None:
            return state, meta
        restored, saved_meta = self._cache_first_restore(state, latest)
        if restored is None:
            t0 = time.perf_counter()
            state, saved_meta = self.ckpt.restore(state, step=latest)
            self._note_restore("storage", time.perf_counter() - t0, latest)
        self._t_restored = time.time()  # the recovery record's "restored"
        if saved_meta is not None:
            meta = saved_meta
        old_world, new_world = _last_world(meta), self.world_size
        if old_world and old_world != new_world:
            logger.info("world size %d -> %d; running adjust functions",
                        old_world, new_world)
            self.adjust.run(old_world, new_world, meta)
            state = self._world_lr_rescale(state, old_world, new_world)
        if self._delta_rep is not None and self._restore_source != "delta":
            # re-anchor the chain on the restored committed step; after a
            # chain overlay the landed step has no base until the next save
            self._delta_rep.rebase(state.step, state)
        return state, meta

    def _note_restore(self, source: str, seconds: float, step: int, info=None) -> None:
        self._restore_source = source
        info = info or {}
        self.restores.append({"source": source, "seconds": seconds, "step": step,
                              "bytes": info.get("bytes", 0),
                              "wire_bytes": info.get("wire_bytes", 0),
                              "local_bytes": info.get("local_bytes", 0)})
        logger.info("restored step %d (restore_source=%s) in %.3fs", step, source, seconds)

    def _cache_first_restore(self, state: TrainState, latest: int):
        """``(state, meta)`` from the peer cache, or ``(None, None)`` on any
        miss (the reason is logged; the caller restores from storage).  A
        delta chain past ``latest`` is used only when the whole world agrees
        on it and every rank restored it.  ``EDL_TPU_MEMSTATE_VERIFY=1``
        also restores from storage and asserts the two bit-identical."""
        if self.store is None or self.tenv is None or not self.tenv.pod_id:
            return None, None
        from edl_tpu_torch import memstate
        if not memstate.enabled():
            return None, None
        from edl_tpu_torch.memstate import restore as ms_restore
        t0 = time.perf_counter()
        delta_step = self._agree_delta_target(latest)
        res = None
        if delta_step is not None:
            try:
                res = ms_restore.try_restore(self.store, self.tenv.job_id, state,
                                             expect_step=latest, delta_step=delta_step)
            except Exception:  # noqa: BLE001 — every rank demotes to the base restore
                logger.exception("delta-chain restore errored")
            if not self._agree_flag(res is not None):
                res = None
        source = "delta" if res is not None else "peer"
        if res is None:
            try:
                res = ms_restore.try_restore(self.store, self.tenv.job_id, state,
                                             expect_step=latest)
            except Exception:  # noqa: BLE001 — the cache never fails a restore
                logger.exception("peer-cache restore errored; restoring from storage")
                res = None
        if res is None:
            self.restore_fallbacks += 1
            return None, None
        state, meta_json, info = res
        if os.environ.get("EDL_TPU_MEMSTATE_VERIFY") == "1" and info["step"] == latest:
            stored, _ = self.ckpt.restore(self.create_state(*self._build_fns), step=latest)
            ms_restore.assert_bit_identical(state, stored)
            del stored
            logger.info("memstate: peer restore verified bit-identical to storage (step %d)",
                        latest)
        self._note_restore(source, time.perf_counter() - t0, info["step"], info)
        return state, State().from_json(meta_json)

    def _agree_delta_target(self, expect: int | None) -> int | None:
        """The world-agreed delta restore target past ``expect``, or None:
        every rank probes the freshest recoverable step and the world's
        minimum wins (-1 from any rank demotes all).  Collective whenever
        the delta plane is on: every rank calls it at the same point."""
        from edl_tpu_torch import memstate
        if not memstate.delta_enabled():
            return None
        committed = freshest = None
        try:
            from edl_tpu_torch.memstate.delta import probe_freshest
            committed, freshest = probe_freshest(self.store, self.tenv.job_id)
        except Exception:  # noqa: BLE001 — a failed probe (or no store) is no delta
            logger.exception("delta freshness probe failed")
        cand = -1
        if expect is not None and committed == expect and freshest is not None \
                and freshest > expect:
            cand = int(freshest)
        if self.processes > 1:
            cand = int(edl_dist.allgather_flag(cand).min())
        if cand < 0 or (expect is not None and cand <= expect):
            return None
        logger.info("delta restore target agreed: step %d (base %s)", cand, expect)
        return cand

    def _agree_flag(self, ok: bool) -> bool:
        """Every rank's ``ok``, and-ed (the identity without a world)."""
        if self.processes <= 1:
            return bool(ok)
        return bool(edl_dist.allgather_flag(int(bool(ok))).min())

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
        if not dist.is_initialized() or self._data_ways == 1 < self.processes:
            pass   # no group, or tp/ep over the whole world: every rank trained the same rows
        elif _is_fsdp(state.model):
            loss = _mean_over_world(None, loss)        # FSDP2 reduced the gradients over
            if self._sp_group is not None:             # dp x fsdp; the sp ranks' next
                _mean_over_world(state.model, None, self._sp_group)
        else:
            loss = _mean_over_world(state.model, loss, self._data_group)
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
        while True:
            payload = crash_exc = crash = None
            try:
                for epoch in range(meta.next_epoch, epochs):
                    if epochs - epoch <= self.cfg.near_end_epochs:
                        self._report(TrainStatus.NEARTHEEND)
                    gen = torch.Generator(device=self.device).manual_seed(
                        seed * 1_000_003 + epoch)
                    state, meta = self._run_epoch(state, meta, data_fn, epoch, gen,
                                                  on_epoch_end)
                break
            except _LiveReshard as sig:
                payload = sig.payload
            except Exception as exc:  # noqa: BLE001 — maybe a peer died
                # a peer's death fails this rank's collective before the
                # membership change is visible: under the live reshard it
                # becomes a shrink (only in a world: a solo trainer's failure
                # is its own).  The traceback is formatted, then the whole
                # cause/context chain is cleared: its frames pin the epoch's
                # device tensors
                if not (self._delta_ready()
                        and (dist.is_initialized() or isinstance(exc, _PeerLost))):
                    raise
                crash = "".join(traceback.format_exception(type(exc), exc, exc.__traceback__))
                link, hops = exc, 0
                while link is not None and hops < 20:
                    link.__traceback__ = None
                    nxt = link.__cause__ or link.__context__
                    link.__cause__ = link.__context__ = None
                    link, hops = nxt, hops + 1
                crash_exc = exc
            # the old state's memory goes before the restore builds the new
            # one, even where a caller still holds the object
            _release(state)
            state = None
            if crash_exc is not None:
                payload = self._reshard_on_failure(crash_exc, crash)
            state, meta = self._live_reshard(payload, meta)
        if self.ckpt is not None:
            self.ckpt.wait()
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
            saving = (self.ckpt is not None and self.cfg.save_every_steps
                      and step % self.cfg.save_every_steps == 0)
            if not saving and self._delta_rep is not None and self._delta_rep.want(step):
                # a delta record of this step: the host snapshot starts here,
                # the diff and the push run on the replicator's thread
                meta.step = step
                self._sync_data_checkpoint(meta)
                self._delta_rep.stage(step, state, meta)
            if saving:
                meta.step = step
                self._sync_data_checkpoint(meta)
                self.ckpt.save(step, state, meta)
                if self._delta_rep is not None:
                    self._delta_rep.rebase(step, state)   # a new base: re-anchor
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
                if self._delta_rep is not None:
                    self._delta_rep.rebase(state.step, state)
            if self.tenv is not None and self.tenv.pod_id:
                # seal the epoch's sets in the cache: a resize between epochs
                # then restores this step from the surviving pods' RAM
                self.ckpt.wait()
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
                                        first_step=time.time(),
                                        restore_source=self._restore_source or "storage")
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
        multi = self.processes > 1
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
        if self.store is not None and self.tenv.rank_in_pod == 0:
            if not self._preempt_seen:
                try:
                    self._preempt_seen = preempt.get_preempt(
                        self.store, self.tenv.job_id, self.tenv.cluster_stage) is not None
                except Exception:  # noqa: BLE001 — a store blip is not a preemption
                    logger.exception("preempt flag read failed")
            if not self._reshard_seen and self._delta_ready():
                self._reshard_seen = self._read_grow_flag()
        agreed = self._preempt_seen
        reshard = self._reshard_seen and self._delta_ready()
        if multi:
            proposal = constants.preempt_check_steps()
            if self._step_ema:
                proposal = round(constants.preempt_check_seconds() / max(self._step_ema, 1e-4))
            # one all-reduce MAX carries the sightings and the cadence proposal;
            # the resize sighting rides along where every rank can reshard live
            # (decided from the env and the config, so the same on every rank)
            flags = [int(self._preempt_seen), max(1, proposal)]
            if self._live_capable():
                flags.append(int(reshard))
            flags = torch.tensor(flags, dtype=torch.int64, device=self.device)
            dist.all_reduce(flags, op=dist.ReduceOp.MAX)
            seen, spacing, *grow = flags.tolist()
            agreed, reshard = bool(seen), bool(grow and grow[0])
            self._preempt_next_check = step + int(spacing)
        if agreed:
            self._preempt_exit(state, meta, step)
        elif reshard:
            # the whole world agreed to pause at this step (a preemption wins)
            self._pause_for_reshard(state, meta, step)

    def _read_grow_flag(self) -> bool:
        """Whether the launcher flagged a grow of this stage.  Only a grow
        starts the cooperative pause, whose save is collective and safe only
        while every member lives.  A shrink flag means a member is gone:
        under gloo the failed collective converts into the reshard; under
        NCCL, whose collectives wait for their timeout instead of failing,
        the communicator is aborted here so the step fails now."""
        from edl_tpu_torch.cluster import resize
        try:
            flag = resize.read_resize_flag(self.store, self.tenv.job_id,
                                           self.tenv.cluster_stage)
        except Exception:  # noqa: BLE001 — a store blip is not a resize
            logger.exception("resize flag read failed")
            return False
        if flag is not None and flag.get("mode") == "shrink" and dist.is_initialized() \
                and dist.get_backend() == "nccl":
            edl_dist.leak_world(abort=True)
            raise _PeerLost("a member left the world (shrink flag): NCCL group aborted")
        return flag is not None and flag.get("mode") == "grow"

    def _preempt_exit(self, state: TrainState, meta: State, step: int) -> None:
        """Checkpoint at ``step`` (collective), wait until every rank's save
        has committed, log why, and leave with ``PREEMPT_EXIT_CODE``."""
        logger.warning("preemption flagged: checkpointing at step %d", step)
        if self.ckpt is not None:
            meta.step = step
            self._sync_data_checkpoint(meta)
            self.ckpt.save(step, state, meta, force=True)
            self.ckpt.wait()   # sealed in the cache: the survivors restore from RAM
            logger.info("preempt: checkpoint committed at step %d", step)
        if self.processes > 1:
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

    # -- the live reshard ----------------------------------------------------
    def _live_capable(self) -> bool:
        """The knob, the launcher's context, a checkpoint manager (the
        pause's save, the roll-back target) and a state this trainer knows
        how to rebuild: the same answer on every rank of a launched world."""
        return bool(constants.resize_delta() and self.ckpt is not None
                    and self.tenv is not None and self.tenv.pod_id
                    and self.tenv.cluster_stage and self._build_fns is not None)

    def _delta_ready(self) -> bool:
        """Can this trainer reshard live: capable, with the store."""
        return self._live_capable() and self.store is not None

    def _pause_for_reshard(self, state: TrainState, meta: State, step: int) -> None:
        """The cooperative (grow) pause: commit a world-wide checkpoint at the
        agreed step, take this process's host copy of the state (the local,
        zero-wire source of the reshard's restore) and unwind.  Raises
        :class:`_LiveReshard`."""
        from edl_tpu_torch.memstate import shards

        logger.warning("live reshard flagged: pausing at step %d", step)
        meta.step = step
        self._sync_data_checkpoint(meta)
        self.ckpt.save(step, state, meta, force=True)
        self.ckpt.wait()    # joiners and peers restore this step
        local = shards.local_source(state)
        if self.processes > 1:
            edl_dist.allgather_flag(1)   # no rank tears down before every save committed
        raise _LiveReshard(_ReshardPayload(mode="grow", local=local, step=step))

    def _reshard_on_failure(self, exc: Exception, detail: str) -> _ReshardPayload:
        """A failed step under the live reshard: tear the group down at once
        (peers blocked on this process then fail too), wait up to
        ``EDL_TPU_RESIZE_RESHARD_TIMEOUT`` for the launcher's handshake and
        turn the crash into a shrink; without one, re-raise (the process
        exits nonzero and the launcher stop-resumes)."""
        from edl_tpu_torch.cluster import resize

        timeout = constants.resize_reshard_timeout()
        logger.warning("step failed; waiting up to %.0fs for the resize handshake\n%s",
                       timeout, detail)
        edl_dist.leak_world(abort=True)
        deadline = time.monotonic() + timeout
        old_stage = self.tenv.cluster_stage
        while time.monotonic() < deadline:
            try:
                if (resize.read_go(self.store, self.tenv.job_id, old_stage) is not None
                        or resize.read_resize_flag(self.store, self.tenv.job_id,
                                                   old_stage) is not None):
                    # no save: the dead pod's live state is gone.  The restore
                    # rolls forward along the freshest agreed chain, or back
                    # to the committed step
                    return _ReshardPayload(mode="shrink")
            except Exception:  # noqa: BLE001 — a store blip: keep polling
                logger.exception("resize handshake poll failed")
            time.sleep(0.5)
        raise exc

    def _live_reshard(self, payload: _ReshardPayload, meta: State):
        """Re-form the world in this process and rebuild the state, moving
        only the bytes this process does not hold.  Any failure raises:
        the process exits nonzero and the launcher stop-resumes."""
        from edl_tpu_torch.cluster import resize
        from edl_tpu_torch.cluster.cluster import Cluster
        from edl_tpu_torch.memstate import restore as ms_restore

        t0 = time.monotonic()
        t_detect = time.time()
        old_stage, old_world = self.tenv.cluster_stage, self.world_size
        edl_dist.leak_world()
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

        # 1. the definitive target stage and its cluster record
        timeout = constants.resize_reshard_timeout()
        deadline = time.monotonic() + timeout
        go = None
        while time.monotonic() < deadline:
            go = resize.read_go(self.store, self.tenv.job_id, old_stage)
            if go is not None:
                break
            time.sleep(0.2)
        if go is None:
            raise RuntimeError(f"no reshard go record for stage {old_stage[:8]} within "
                               f"{timeout:.0f}s")
        cluster = None
        while time.monotonic() < deadline:
            cluster = Cluster.load_from_store(self.store, self.tenv.job_id)
            if cluster is not None and cluster.stage == go["new_stage"]:
                break
            go = resize.read_go(self.store, self.tenv.job_id, old_stage) or go
            time.sleep(0.2)
        if cluster is None or cluster.stage != go["new_stage"]:
            raise RuntimeError(f"cluster record never reached go stage {go['new_stage'][:8]}")

        # 2. the new world, then the new manager (and replicator) in it
        if self.ckpt is not None:
            self.ckpt.close()
        edl_dist.reform_world(self.tenv, self.store, cluster, self.device)
        self._form_mesh()
        self.ckpt = self._build_ckpt()
        target = self.create_state(*self._build_fns)

        # 3. the restore: local snapshot, own pod's cache, then peers; the
        # collectives in the joiners' order (restore_or_create): the latest
        # step, the delta target, the restore, the all-ok vote
        t_restore = time.monotonic()
        expect = self.ckpt.latest_step()
        delta_step = self._agree_delta_target(expect)
        res = None
        if delta_step is not None:
            try:
                res = ms_restore.try_restore(self.store, self.tenv.job_id, target,
                                             expect_step=expect, local=payload.local,
                                             prefer_pod=self.tenv.pod_id,
                                             delta_step=delta_step)
            except Exception:  # noqa: BLE001 — demote to the base
                logger.exception("reshard delta-chain restore errored")
            if not self._agree_flag(res is not None):
                res = None
        if res is None:
            try:
                res = ms_restore.try_restore(self.store, self.tenv.job_id, target,
                                             expect_step=expect, local=payload.local,
                                             prefer_pod=self.tenv.pod_id)
            except Exception:  # noqa: BLE001 — storage below
                logger.exception("reshard cache restore errored")
                res = None
        payload.local = None
        if res is not None:
            state, meta_json, info = res
            meta = State().from_json(meta_json)
            source = "delta"
        else:
            # a cache miss demotes the restore to storage, not the reshard
            self.restore_fallbacks += 1
            if expect is None:
                raise RuntimeError("no checkpoint to reshard from")
            state, saved_meta = self.ckpt.restore(target, step=expect)
            meta = saved_meta if saved_meta is not None else meta
            source, info = "storage", {"step": expect}
        if (os.environ.get("EDL_TPU_MEMSTATE_VERIFY") == "1" and source == "delta"
                and delta_step is None):
            stored, _ = self.ckpt.restore(self.create_state(*self._build_fns), step=expect)
            ms_restore.assert_bit_identical(state, stored)
            del stored
            logger.info("reshard restore verified bit-identical to storage (step %s)", expect)
        self._note_restore(source, time.monotonic() - t_restore, info["step"], info)

        # 4. bookkeeping: adjust hooks, cadence state (joiners start fresh),
        # the recovery record's times, the done record for the launcher
        new_world = self.world_size
        if old_world != new_world:
            logger.info("world size %d -> %d (live); running adjust functions", old_world,
                        new_world)
            self.adjust.run(old_world, new_world, meta)
            state = self._world_lr_rescale(state, old_world, new_world)
        self._reshard_seen = self._preempt_seen = False
        self._preempt_next_check = None
        self._last_step_t = None
        self._t_restored = t_detect
        seconds = time.monotonic() - t0
        self.reshards.append({"mode": payload.mode, "source": source, "step": state.step,
                              "seconds": seconds, "world": new_world,
                              "local_bytes": info.get("local_bytes", 0),
                              "wire_bytes": info.get("wire_bytes", 0)})
        if self.tenv.rank_in_pod == 0:
            try:
                resize.write_done(self.store, self.tenv.job_id, cluster.stage, self.tenv.pod_id,
                                  {"mode": payload.mode, "source": source,
                                   "seconds": round(seconds, 3)})
            except Exception:  # noqa: BLE001 — the launcher's deadline decides
                logger.exception("reshard done record write failed")
        if self._delta_rep is not None and delta_step is None:
            self._delta_rep.rebase(state.step, state)
        logger.info("live reshard complete: stage %s, world %d, %.2fs (source=%s, step %d)",
                    cluster.stage[:8], new_world, seconds, source, state.step)
        return state, meta

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


def _release(state: TrainState | None) -> None:
    """Free a replaced state's tensors (parameters, gradients, buffers,
    optimizer moments): garbage by contract, since the live reshard
    rebuilds the state, so the card never holds two copies."""
    if state is None:
        return
    state.optimizer.state.clear()
    for t in list(state.model.parameters()) + list(state.model.buffers()):
        t.grad = None
        if not hasattr(t, "to_local"):   # a DTensor's shard goes with the module
            t.data = torch.empty(0, dtype=t.dtype, device=t.device)
    state.fences.clear()


def _log_to_stderr() -> None:
    """The port's INFO lines (restores and their source, reshards, the
    cache) on stderr, once per process."""
    root = logging.getLogger("edl_tpu_torch")
    if not root.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter("%(asctime)s %(levelname)s [%(name)s] %(message)s"))
        root.addHandler(handler)
        root.setLevel(logging.INFO)


def _is_fsdp(model: torch.nn.Module) -> bool:
    return any(hasattr(p, "to_local") for p in model.parameters())


def _mean_over_world(model: torch.nn.Module | None, loss: torch.Tensor | None,
                     pg=None) -> torch.Tensor | None:
    """Replace every parameter gradient of ``model`` (none for None; an
    FSDP2 shard's local tensor), and ``loss`` (none for None), by its mean
    over the process group ``pg`` (default: the world): one all-reduce per
    dtype of a flat buffer.  NCCL averages in the collective (its one-rank
    form premultiplies by 1, so a group of one changes no bit); gloo has no
    average, so it sums and divides.  Every rank must hold gradients for
    the same parameters."""
    grads = [] if model is None else [
        p.grad.to_local() if hasattr(p.grad, "to_local") else p.grad
        for p in model.parameters() if p.grad is not None]
    tensors = grads + ([] if loss is None else [loss.reshape(1)])
    average = dist.get_backend(pg) == "nccl"
    world = dist.get_world_size(pg)
    for dtype in dict.fromkeys(t.dtype for t in tensors):
        group = [t for t in tensors if t.dtype == dtype]
        flat = torch.cat([t.reshape(-1) for t in group])
        if average:
            dist.all_reduce(flat, op=dist.ReduceOp.AVG, group=pg)
        else:
            dist.all_reduce(flat, group=pg)
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
