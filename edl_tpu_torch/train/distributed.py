"""Multi-process bootstrap: a ``torch.distributed`` world from the
launcher's environment (the port of the JAX package's
``train/distributed.py``).

The launcher exports ``EDL_TPU_TRAINER_*`` (``cluster/env.py``) and
restarts every trainer on a membership change; :func:`initialize_from_env`
turns that env into ``init_process_group``: NCCL on the card, gloo on the
CPU, ``tcp://<EDL_TPU_COORDINATOR>`` (the launcher's rank-0 trainer
endpoint) as the rendezvous, rank and world from the env.  A stop-resume
resize is a new process with a new env, so a world is formed once per
process and never reshaped.  At world size 1 nothing is formed, so the
same script runs standalone, under tests and under the launcher.

The JAX package's resizable world (``EDL_TPU_RESIZE_DELTA``: trainers
that survive a membership change and re-form the world in place) is not
ported (ROADMAP.md Queue 1 item 4e, second part); a trainer asked for it
raises instead of forming a plain world the launcher would not expect.

:func:`connect_store` imports the store client (and with it ``msgpack``)
only when the env names a store; the client it returns retries, backs
off and fails over on every op (``coord/resilient.py``).

:func:`allgather_flag` and :func:`allgather_rows` are the small host-value
gathers of the data service (its per-step has-next agreement and the data
checkpoint's merge): CPU tensors under gloo, CUDA tensors under NCCL.
"""

from __future__ import annotations

import datetime
import logging
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from edl_tpu_torch.cluster.env import TrainerEnv
from edl_tpu_torch.utils import constants

logger = logging.getLogger(__name__)


def _delta_enabled(tenv: TrainerEnv) -> bool:
    """The launcher's live-reshard path engages under the launcher
    (stage and store named) unless ``EDL_TPU_RESIZE_DELTA=0``."""
    return bool(constants.resize_delta() and tenv.cluster_stage and tenv.coord_endpoints)


def _bind_device(tenv: TrainerEnv) -> None:
    """Make this trainer's card the current CUDA device: the first of
    ``EDL_TPU_DEVICE_IDS`` when the launcher exported any, else the
    trainer's rank in its pod."""
    torch.cuda.set_device(tenv.device_ids[0] if tenv.device_ids else tenv.rank_in_pod)


def initialize_from_env(tenv: TrainerEnv | None = None,
                        device: str | torch.device = "cuda") -> TrainerEnv:
    """Form the process group ``tenv`` describes (idempotent).  World size
    <= 1 forms none.  ``device`` picks the backend: NCCL for ``cuda``
    (after binding the card), gloo for ``cpu``.  Rendezvous is retried
    ``EDL_TPU_DIST_INIT_RETRIES`` times (3) with ``EDL_TPU_DIST_INIT_TIMEOUT``
    seconds each (120), and the formed world's size is checked against
    the env's: a half-formed world fails here, not in a shared checkpoint."""
    tenv = tenv or TrainerEnv()
    if _delta_enabled(tenv):
        raise RuntimeError(
            "EDL_TPU_RESIZE_DELTA is on (the JAX package's default under the launcher): "
            "its resizable world, where trainers survive a membership change, is not "
            "ported to edl_tpu_torch yet (ROADMAP.md Queue 1 item 4e); run the job with "
            "EDL_TPU_RESIZE_DELTA=0 for stop-resume")
    if tenv.world_size <= 1 or dist.is_initialized():
        return tenv
    coordinator = tenv.coordinator or (tenv.trainer_endpoints[0] if tenv.trainer_endpoints
                                       else "")
    if not coordinator:
        raise RuntimeError("world_size > 1 but no coordinator address: set "
                           "EDL_TPU_COORDINATOR or EDL_TPU_TRAINER_ENDPOINTS")
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if backend == "nccl":
        _bind_device(tenv)
    timeout = int(os.environ.get("EDL_TPU_DIST_INIT_TIMEOUT", "120"))
    retries = max(1, int(os.environ.get("EDL_TPU_DIST_INIT_RETRIES", "3")))
    logger.info("init_process_group(%s, tcp://%s, world=%d, rank=%d)", backend,
                coordinator, tenv.world_size, tenv.global_rank)
    for attempt in range(1, retries + 1):
        try:
            dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                                    world_size=tenv.world_size, rank=tenv.global_rank,
                                    timeout=datetime.timedelta(seconds=timeout))
            break
        except (RuntimeError, ValueError, OSError) as e:
            # a loaded host can time the rendezvous out with every peer
            # alive: retry with backoff before declaring the world unformable
            if attempt == retries:
                raise
            logger.warning("distributed init failed (attempt %d/%d): %s; retrying",
                           attempt, retries, e)
            if dist.is_initialized():
                dist.destroy_process_group()
            time.sleep(2.0 * attempt)
    formed = dist.get_world_size()
    if formed != tenv.world_size:
        raise RuntimeError(f"torch.distributed world did not form: get_world_size()="
                           f"{formed}, expected {tenv.world_size} (coordinator {coordinator})")
    return tenv


def connect_store(tenv: TrainerEnv):
    """Coordination-store client for a trainer, or None when running
    standalone (no launcher env, or the store unreachable)."""
    if not (tenv.coord_endpoints and tenv.pod_id):
        return None
    from edl_tpu_torch.coord.client import connect
    try:
        return connect(tenv.coord_endpoints)
    except ConnectionError:
        logger.warning("coordination store unreachable; running standalone")
        return None


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def is_coordinator(tenv: TrainerEnv | None = None) -> bool:
    tenv = tenv or TrainerEnv()
    return tenv.global_rank == 0


def _collective_device() -> torch.device:
    """Where a collective's tensors live: the current card under NCCL, the
    CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def allgather_rows(rows: np.ndarray) -> np.ndarray:
    """``rows`` ([n, ...] int32, n the same on every rank) from every rank of
    the process group, stacked in rank order: [world, n, ...]."""
    local = torch.from_numpy(np.ascontiguousarray(rows, np.int32)).to(_collective_device())
    parts = [torch.empty_like(local) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, local)
    return torch.stack(parts).cpu().numpy()


def allgather_flag(flag: int) -> np.ndarray:
    """Every rank's ``flag`` (one int32 each, in rank order): the data
    service's per-step has-next agreement.  Without a process group, just
    this process's."""
    if not dist.is_initialized():
        return np.asarray([flag], np.int32)
    return allgather_rows(np.asarray([flag], np.int32))[:, 0]
