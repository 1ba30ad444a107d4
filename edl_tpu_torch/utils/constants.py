"""Coordination-store names, trainer knobs and serving knobs the port uses
(copies of the JAX package's ``utils/constants.py`` entries, under the
same ``EDL_TPU_*`` names and defaults).

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
TTL_REFRESH_FRACTION = 0.5          # a leased key's keep-alive runs at ttl/2


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


def etcd_ttl() -> float:
    """``EDL_TPU_TTL``: the lease TTL of a registration (s)."""
    return _env_float("EDL_TPU_TTL", 15.0)


def prefill_chunk() -> int:
    """``EDL_TPU_PREFILL_CHUNK``: the serving engine prefills a prompt
    longer than this many tokens in chunks of this size, one a tick,
    between its decode steps (0: every admission in one pass)."""
    return int(_env_float("EDL_TPU_PREFILL_CHUNK", 512))


def spec_k() -> int:
    """``EDL_TPU_SPEC_K``: draft tokens a round of speculative decoding
    (0: off; the port's engine raises on anything else, ROADMAP.md Queue
    1 item 6)."""
    return int(_env_float("EDL_TPU_SPEC_K", 0))


def distill_advert_period() -> float:
    """``EDL_TPU_DISTILL_ADVERT_PERIOD``: seconds between a teacher's
    refreshes of its advert (the live ``stats()`` payload)."""
    return _env_float("EDL_TPU_DISTILL_ADVERT_PERIOD", 1.0)
