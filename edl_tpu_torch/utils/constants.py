"""Coordination-store names and trainer knobs the port uses (copies of the
JAX package's ``utils/constants.py`` entries).

The store's table names are the contract with the JAX launcher, which
reads what a trainer writes; the knobs are read from the environment
when asked, so one process can see them change (tests do).
"""

import os

ROOT = "/edl_tpu"                   # a job's state lives under ROOT/<job_id>/<table>/
ETCD_POD_RANK = "rank"              # leader seat lives at rank/0
ETCD_STATE = "state"                # train State (data checkpoint etc.)
ETCD_TRAIN_STATUS = "train_status"  # per-pod TrainStatus
ETCD_HEARTBEAT = "heartbeat"        # per-pod trainer liveness beats
LEADER_KEY = "0"                    # rank table key seized by the leader


def _env_float(name: str, default: float) -> float:
    return float(os.environ.get(name, default))


def hang_timeout() -> float:
    """``EDL_TPU_HANG_TIMEOUT``: the launcher's hang watchdog.  0 (the
    default) = auto, the trainer publishes its own stale threshold with
    each beat; > 0 = an explicit threshold in seconds; < 0 = disabled."""
    return _env_float("EDL_TPU_HANG_TIMEOUT", 0.0)


def lr_rescale() -> bool:
    """``EDL_TPU_LR_RESCALE=1``: the trainer builds its optimizer with a
    world-scale stage (``train/lr.py``) and rescales the effective LR by
    new_world / old_world on a restore across a world change."""
    return bool(int(_env_float("EDL_TPU_LR_RESCALE", 0)))


def resize_delta() -> bool:
    """``EDL_TPU_RESIZE_DELTA``: the launcher's live-reshard path, on
    unless set to 0 (the JAX package's default)."""
    return bool(int(_env_float("EDL_TPU_RESIZE_DELTA", 1)))
