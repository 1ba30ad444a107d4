"""Per-pod trainer liveness beats, the trainer's side (a copy of the JAX
package's ``cluster/heartbeat.py``: ``beat``, ``auto_threshold``,
``last_beat_info`` and ``clear``), and the stage-scoped incident flags that
the preemption grace reads (``write_stage_flag``, ``read_stage_flag``).

The trainer's rank-0-in-pod process writes a timestamp after completed
steps (throttled, ``ElasticTrainer``); the pod's launcher restarts its
trainers when the beat goes stale.  The threshold is self-tuning: the
trainer publishes ``max(10 x EMA step time, 120 s)`` with each beat, and
the launcher uses it unless ``EDL_TPU_HANG_TIMEOUT`` overrides it.  The
value is ``"<time> <threshold>"``, the bytes the JAX launcher parses.
"""

from __future__ import annotations

import time

from edl_tpu_torch.cluster import paths
from edl_tpu_torch.utils import constants

# a coordination outage may cost the step loop at most this much per
# beat: a missed beat is recoverable, a stalled step is the hang the
# beat exists to detect
BEAT_BUDGET_S = 5.0

# auto-threshold shape: a generous multiple of the observed step time,
# floored so checkpoint saves and eval passes between beats never look
# like hangs
AUTO_MULT = 10.0
AUTO_FLOOR = 120.0


def auto_threshold(ema_step_s: float | None) -> float:
    """Stale threshold derived from the observed (EMA) step time."""
    if ema_step_s is None or ema_step_s <= 0:
        return AUTO_FLOOR
    return max(AUTO_MULT * ema_step_s, AUTO_FLOOR)


def _key(job_id: str, pod_id: str) -> str:
    return paths.key(job_id, constants.ETCD_HEARTBEAT, pod_id)


def beat(store, job_id: str, pod_id: str, now: float | None = None,
         threshold: float | None = None) -> None:
    """Record liveness; ``threshold`` is the trainer's self-derived
    stale bound, published so the launcher needs no configuration."""
    val = repr(time.time() if now is None else now)
    if threshold is not None:
        val += f" {threshold!r}"
    with store.scoped_deadline(BEAT_BUDGET_S):
        store.put(_key(job_id, pod_id), val.encode())


def last_beat_info(store, job_id: str, pod_id: str
                   ) -> tuple[float, float | None] | None:
    """(timestamp, published threshold or None), or None if no beat."""
    rec = store.get(_key(job_id, pod_id))
    if rec is None or not rec.value:
        return None
    parts = rec.value.decode().split()
    try:
        ts = float(parts[0])
    except (ValueError, IndexError):
        return None
    thr = None
    if len(parts) > 1:
        try:
            thr = float(parts[1])
        except ValueError:
            thr = None
    return ts, thr


def clear(store, job_id: str, pod_id: str) -> None:
    store.delete(_key(job_id, pod_id))


# -- stage-scoped incident flags -----------------------------------------
# ``<name>/<stage>`` under the heartbeat table, value ``<timestamp>
# <pod_id>``: the JAX launcher's hang watchdog and preemption grace
# (``cluster/preempt.py``) share one encoding, so the two never drift.

def write_stage_flag(store, job_id: str, name: str, stage: str, pod_id: str) -> float:
    """Raise the ``name`` flag of ``stage`` for ``pod_id``; returns its time."""
    t = time.time()
    store.put(paths.key(job_id, constants.ETCD_HEARTBEAT, f"{name}/{stage}"),
              f"{t!r} {pod_id}".encode())
    return t


def read_stage_flag(store, job_id: str, name: str, stage: str) -> float | None:
    """The flag's timestamp, or None when it is not raised."""
    info = read_stage_flag_info(store, job_id, name, stage)
    return None if info is None else info[0]


def read_stage_flag_info(store, job_id: str, name: str, stage: str
                         ) -> tuple[float, str] | None:
    """``(timestamp, flagging pod id)``, or None."""
    rec = store.get(paths.key(job_id, constants.ETCD_HEARTBEAT, f"{name}/{stage}"))
    if rec is None or not rec.value:
        return None
    try:
        parts = rec.value.decode().split()
        return float(parts[0]), parts[1] if len(parts) > 1 else ""
    except (ValueError, IndexError):
        return None
