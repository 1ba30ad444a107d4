"""Preemption flag: the SIGTERM-grace channel between a departing launcher
and every trainer in the world (a copy of the JAX package's
``cluster/preempt.py``).

1. The signalled launcher writes ``preempt/<stage>`` (:func:`flag_preempt`).
2. Every trainer checks the flag at a step-aligned cadence; a world of
   several processes combines the sightings in one collective, so every
   process picks the same step (the checkpoint save is collective).
3. The trainers save at that step and exit ``PREEMPT_EXIT_CODE``.
4. The signalled launcher departs cleanly; the survivors stop-resume from
   the preemption-point checkpoint.

The flag is stage-scoped: a rebuilt cluster (a new stage) never sees a
stale preemption.  The per-pod marker carries why the pod was evicted:
``sigterm`` (infrastructure preemption), ``descale``, ``priority-yield`` or
``straggler-evict``.
"""

from __future__ import annotations

import json

from edl_tpu_torch.cluster import heartbeat, paths
from edl_tpu_torch.utils import constants

REASONS = ("sigterm", "descale", "priority-yield", "straggler-evict")


def _pod_key(job_id: str, stage: str, pod_id: str) -> str:
    return paths.key(job_id, constants.ETCD_HEARTBEAT, f"preempt_pod/{stage}/{pod_id}")


def flag_preempt(store, job_id: str, stage: str, pod_id: str,
                 reason: str = "sigterm") -> float:
    """Record that ``pod_id`` is being preempted at ``stage``: the stage's
    single-slot flag (what trainers poll, last writer wins) and a per-pod
    marker with the eviction ``reason`` (several pods may be preempted in
    one stage).  Returns the flag's time."""
    t = heartbeat.write_stage_flag(store, job_id, "preempt", stage, pod_id)
    store.put(_pod_key(job_id, stage, pod_id), json.dumps({"ts": t, "reason": reason}).encode())
    return t


def pod_preempt_info(store, job_id: str, stage: str, pod_id: str
                     ) -> tuple[float, str] | None:
    """``(timestamp, reason)`` of ``pod_id``'s own pending preemption at
    ``stage``, or None.  A bare ``repr(ts)`` (the record before reasons)
    reads as reason ``sigterm``."""
    rec = store.get(_pod_key(job_id, stage, pod_id))
    if rec is None or not rec.value:
        return None
    try:
        d = json.loads(rec.value.decode())
        if isinstance(d, dict):
            return float(d.get("ts", 0.0)), str(d.get("reason", "sigterm"))
        return float(d), "sigterm"
    except ValueError:
        return None


def is_pod_preempted(store, job_id: str, stage: str, pod_id: str) -> bool:
    """True iff ``pod_id`` itself has a pending preemption at ``stage``."""
    return pod_preempt_info(store, job_id, stage, pod_id) is not None


def get_preempt(store, job_id: str, stage: str) -> float | None:
    """Timestamp of the stage's pending preemption, or None."""
    return heartbeat.read_stage_flag(store, job_id, "preempt", stage)
