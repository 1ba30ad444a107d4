"""Checkpointing: ``torch.save`` of the train state + the JSON ``State``
sidecar, one directory per step.

The port of the JAX package's ``train/checkpoint.py``, whose Orbax
manager becomes plain files with the same guarantees:

- each save is written into a temporary directory and committed by an
  atomic rename to ``<dir>/<step>``, so a reader sees a whole step or
  none (stale temporaries of a killed save are removed on start);
- ``max_to_keep`` newest steps are kept, older ones deleted;
- ``<dir>/<step>/meta/metadata`` holds ``State.to_dict()`` as JSON, the
  path and JSON Orbax writes, so a sidecar parses in either package;
- ``<dir>/<step>/state.pt`` holds the module, the optimizer, the step and
  the extra state (tensors and plain containers: it is loaded with
  ``weights_only=True``).

Saves are synchronous.  With a ``tee`` (``memstate/tee.py``, under the
launcher) every committed save is also staged into the pod's in-RAM peer
checkpoint cache by the writing rank, and :meth:`CheckpointManager.wait`
seals what was staged and advances the job's committed-step record, as the
JAX manager's ``wait`` does after its asynchronous save drains.  The cache
is best-effort: a tee failure costs a cache miss, never the checkpoint.

In a ``torch.distributed`` world (parameters
replicated, so rank 0 holds the whole state) rank 0 writes and commits,
and the other ranks wait in a broadcast of its result until the commit is
visible; rank 0 also decides ``latest_step``, so every rank restores the
same step.  Those calls are collective: every rank makes them, in the
same order.  Without a group nothing is exchanged.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
from pathlib import Path

import torch
import torch.distributed as dist

from edl_tpu_torch.cluster.state import State
from edl_tpu_torch.train.state import TrainState

logger = logging.getLogger(__name__)

_TMP_PREFIX = ".tmp-"


def _from_rank0(value: int | None) -> int | None:
    """``value`` as rank 0 has it (None travels as -1); the identity
    without a process group.  Returns only once rank 0 has called it."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return value
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
    t = torch.tensor([-1 if value is None else value], dtype=torch.int64, device=device)
    dist.broadcast(t, src=0)
    got = int(t.item())
    return None if got < 0 else got


def _is_writer() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3, tee=None):
        self._tee = tee
        self._dir = Path(directory).resolve()
        self._dir.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep
        if _is_writer():
            for stale in self._dir.glob(f"{_TMP_PREFIX}*"):
                shutil.rmtree(stale, ignore_errors=True)

    def all_steps(self) -> list[int]:
        return sorted(int(p.name) for p in self._dir.iterdir()
                      if p.is_dir() and p.name.isdigit())

    def latest_step(self) -> int | None:
        """The newest committed step, as rank 0 sees it (collective)."""
        steps = self.all_steps() if _is_writer() else []
        return _from_rank0(steps[-1] if steps else None)

    # -- save ---------------------------------------------------------------
    def save(self, step: int, state: TrainState, meta: State | None = None,
             force: bool = False) -> bool:
        """Commit ``state`` (and ``meta``) as step ``step``.  An existing
        step is kept (returns False) unless ``force`` replaces it.
        Collective: rank 0 writes, every rank returns its result."""
        done = self._save(step, state, meta, force) if _is_writer() else None
        if done and self._tee is not None:
            try:
                self._tee.stage(step, state, meta)
            except Exception:  # noqa: BLE001 — the cache is best-effort
                logger.exception("memstate tee stage failed (step %d)", step)
        return bool(_from_rank0(done))

    def wait(self) -> None:
        """Every save so far is durable (they are synchronous): seal the
        tee's staged sets and advance the committed-step record."""
        if self._tee is not None:
            self._tee.mark_committed()

    def close(self) -> None:
        """Stop the tee (its staged, unsealed sets are dropped)."""
        if self._tee is not None:
            tee, self._tee = self._tee, None
            tee.close()

    def _save(self, step: int, state: TrainState, meta: State | None, force: bool) -> bool:
        final = self._dir / str(step)
        if final.exists() and not force:
            return False
        tmp = self._dir / f"{_TMP_PREFIX}{step}-{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir()
        torch.save(state.state_dict(), tmp / "state.pt")
        if meta is not None:
            (tmp / "meta").mkdir()
            (tmp / "meta" / "metadata").write_text(json.dumps(meta.to_dict()))
        if final.exists():
            old = self._dir / f"{_TMP_PREFIX}old-{step}-{os.getpid()}"
            os.replace(final, old)
            os.replace(tmp, final)
            shutil.rmtree(old, ignore_errors=True)
        else:
            os.replace(tmp, final)
        if self.max_to_keep:
            for gone in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(self._dir / str(gone), ignore_errors=True)
        logger.info("checkpoint step %d committed to %s", step, self._dir)
        return True

    def save_meta(self, step: int, meta: State) -> bool:
        """Atomically rewrite the JSON sidecar of a committed step (for
        hooks that change ``meta`` after the epoch's save).  Collective,
        as :meth:`save`."""
        done = self._save_meta(step, meta) if _is_writer() else None
        if done and self._tee is not None:
            try:
                self._tee.update_meta(step, meta)
            except Exception:  # noqa: BLE001 — the cache is best-effort
                logger.exception("memstate tee meta update failed (step %d)", step)
        return bool(_from_rank0(done))

    def _save_meta(self, step: int, meta: State) -> bool:
        d = self._dir / str(step) / "meta"
        if not (self._dir / str(step)).exists():
            return False
        d.mkdir(exist_ok=True)
        tmp = d / f"metadata.tmp.{os.getpid()}"
        tmp.write_text(json.dumps(meta.to_dict()))
        os.replace(tmp, d / "metadata")
        return True

    # -- restore ------------------------------------------------------------
    def restore(self, state: TrainState, step: int | None = None,
                ) -> tuple[TrainState, State | None] | None:
        """Load step ``step`` (default the latest, collective) into
        ``state`` (a freshly built state of the same structure, on the
        trainer's device, where the tensors land) and return ``(state,
        meta)``; None when there is no checkpoint."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        d = self._dir / str(step)
        device = next(state.model.parameters()).device
        state.load_state_dict(torch.load(d / "state.pt", map_location=device,
                                         weights_only=True))
        meta_path = d / "meta" / "metadata"
        meta = State().from_json(meta_path.read_text()) if meta_path.exists() else None
        logger.info("restored checkpoint step %d from %s", step, self._dir)
        return state, meta
