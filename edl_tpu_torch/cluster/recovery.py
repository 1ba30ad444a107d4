"""Elastic recovery-time records (a copy of the JAX package's
``cluster/recovery.py``, without its resize-phase histogram and trace
events, which wait for the port's observability modules).

A resize record has two halves under one stage key: the launcher's
(detect, killed, barrier, spawn: written by the unchanged JAX launcher)
and the trainer's (checkpoint restored, first post-restore step: written
here).  :func:`summarize_recovery` merges them into the number users pay
for at a resize: from noticing a membership change to the resized
world's first real training step.  The keys and the JSON are the JAX
package's, byte for byte, so either package reads what the other wrote.
"""

from __future__ import annotations

import json

from edl_tpu_torch.cluster import paths
from edl_tpu_torch.utils import constants

# phase name -> (begin timestamp key, end timestamp key), per record half.
# A stop-resume record carries detect/killed/barrier/spawn; a delta-resize
# record (the JAX package's live reshard) carries detect/flagged/barrier/
# reshard_done instead, and a fallback record both flagged and killed.
# Phases whose keys are absent are skipped.
LAUNCHER_PHASES = (
    ("detect_to_kill", "detect", "killed"),
    ("kill_to_barrier", "killed", "barrier"),
    ("barrier_to_spawn", "barrier", "spawn"),
    ("detect_to_flag", "detect", "flagged"),
    ("flag_to_barrier", "flagged", "barrier"),
    ("barrier_to_reshard", "barrier", "reshard_done"),
)
TRAINER_PHASES = (
    ("restored_to_first_step", "restored", "first_step"),
)


def write_trainer_half(store, job_id: str, stage: str, pod_id: str,
                       restored: float, first_step: float,
                       restore_source: str | None = None) -> None:
    """Trainer half of a resize record: the wall-clock times the checkpoint
    was restored and the first step after it finished.  ``restore_source``
    says where the state came from (``"storage"`` for a checkpoint read;
    the JAX package also writes ``"peer"`` and ``"delta"``)."""
    times = {"restored": restored, "first_step": first_step}
    if restore_source is not None:
        times["restore_source"] = restore_source
    store.put(paths.key(job_id, constants.ETCD_RECOVERY, f"{stage}/trainer/{pod_id}"),
              json.dumps(times).encode())


def load_recovery_records(store, job_id: str) -> dict[str, dict]:
    """{stage: {"launcher": {pod: times}, "trainer": {pod: times}}}."""
    prefix = paths.table_prefix(job_id, constants.ETCD_RECOVERY)
    recs, _rev = store.get_prefix(prefix)
    out: dict[str, dict] = {}
    for rec in recs:
        stage, role, pod = rec.key[len(prefix):].split("/", 2)
        out.setdefault(stage, {}).setdefault(role, {})[pod] = json.loads(rec.value.decode())
    return out


def summarize_recovery(store, job_id: str, kill_time: float | None = None) -> list[dict]:
    """One breakdown dict per completed resize stage, oldest first.

    Phases (seconds): ``detect_to_kill`` (terminate old trainers),
    ``kill_to_barrier`` (membership re-agreement), ``barrier_to_spawn``
    (respawn), ``spawn_to_restored`` (start-up and checkpoint restore),
    ``restored_to_first_step`` (the first step), ``total`` = detect to the
    first post-resize step.  With ``kill_time`` (a harness's SIGKILL
    timestamp) also ``kill_to_detect`` and ``total_from_kill``."""
    out = []
    for stage, halves in load_recovery_records(store, job_id).items():
        launchers = halves.get("launcher", {})
        trainers = halves.get("trainer", {})
        if not launchers:
            continue
        # the earliest detector is the canonical launcher record; the last
        # trainer to finish its first step closes the resize
        lt = min(launchers.values(), key=lambda t: t["detect"])
        mode = lt.get("resize_mode", "delta" if "reshard_done" in lt else "stop_resume")
        entry = {"stage": stage, "resize_mode": mode, "detect_at": round(lt["detect"], 3)}
        # reasoned departures (a preempt flag's eviction reason), merged
        # across every launcher half
        evicted: dict[str, str] = {}
        for t in launchers.values():
            if isinstance(t.get("evicted"), dict):
                evicted.update(t["evicted"])
        if evicted:
            entry["evicted"] = evicted
        for phase, begin, end in LAUNCHER_PHASES:
            if begin in lt and end in lt:
                entry[phase] = round(max(0.0, lt[end] - lt[begin]), 3)
        # the handoff into the trainer half: respawn for stop-resume, the
        # in-place reshard's ack for delta
        hand = lt.get("spawn", lt.get("reshard_done"))
        if trainers:
            tt = max(trainers.values(), key=lambda t: t["first_step"])
            if hand is not None:
                entry["spawn_to_restored"] = round(max(0.0, tt["restored"] - hand), 3)
            entry.update({
                "restored_to_first_step": round(tt["first_step"] - tt["restored"], 3),
                "total": round(tt["first_step"] - lt["detect"], 3),
            })
            # "peer"/"delta" only when every pod restored from the cache:
            # one storage fallback means the resize still paid storage
            sources = {t.get("restore_source") for t in trainers.values()}
            if sources != {None}:
                if sources <= {"peer", "delta"}:
                    entry["restore_source"] = "delta" if "delta" in sources else "peer"
                else:
                    entry["restore_source"] = "storage"
            if kill_time is not None:
                entry["kill_to_detect"] = round(lt["detect"] - kill_time, 3)
                entry["total_from_kill"] = round(tt["first_step"] - kill_time, 3)
        out.append(entry)
    out.sort(key=lambda e: e["detect_at"])  # chronological, oldest first
    return out
