"""Live-reshard handshake records (a copy of the JAX package's
``cluster/resize.py``): the launcher-to-trainer channel that lets
surviving trainer processes reshard in place instead of dying.

Four record kinds under the ``reshard`` table, all plain puts, scoped by
stage:

- ``flag/<old_stage>``: written by a launcher the moment its watcher sees
  a membership change with the live path eligible.  Trainers of the old
  world poll it; ``mode=grow`` asks them to pause at an agreed step and
  commit a checkpoint first, ``mode=shrink`` tells survivors of a failed
  collective what is happening.
- ``go/<old_stage>``: written after the barrier with the definitive
  target stage; trainers re-form the world toward exactly that stage's
  cluster record.
- ``worldsvc/<stage>``: the rendezvous record of a stage's world,
  published by the leader pod's launcher.  A torch trainer reads it only
  as the formation gate and as the generation nonce of its own store
  rendezvous (``train/distributed.py``).
- ``done/<new_stage>/<pod_id>``: written by the pod's rank-0 trainer once
  its reshard restore completed; the launcher's wait for these is the
  reshard barrier, and its expiry the stop-resume fallback.
"""

from __future__ import annotations

import json
import time

from edl_tpu_torch.cluster import paths
from edl_tpu_torch.utils import constants


def _key(job_id: str, name: str) -> str:
    return paths.key(job_id, constants.ETCD_RESHARD, name)


def _read(store, key: str) -> dict | None:
    rec = store.get(key)
    if rec is None or not rec.value:
        return None
    try:
        return json.loads(rec.value.decode())
    except ValueError:
        return None


def flag_resize(store, job_id: str, old_stage: str, mode: str, new_stage: str,
                pod_id: str) -> None:
    """``mode``: ``"grow"`` (every old pod survives: pause and save first)
    or ``"shrink"`` (members departed: roll back to the committed step)."""
    store.put(_key(job_id, f"flag/{old_stage}"),
              json.dumps({"mode": mode, "new_stage": new_stage, "pod": pod_id,
                          "ts": time.time()}).encode())


def read_resize_flag(store, job_id: str, old_stage: str) -> dict | None:
    return _read(store, _key(job_id, f"flag/{old_stage}"))


def write_go(store, job_id: str, old_stage: str, new_stage: str, mode: str) -> None:
    store.put(_key(job_id, f"go/{old_stage}"),
              json.dumps({"new_stage": new_stage, "mode": mode, "ts": time.time()}).encode())


def read_go(store, job_id: str, old_stage: str) -> dict | None:
    return _read(store, _key(job_id, f"go/{old_stage}"))


def publish_world_service(store, job_id: str, stage: str, endpoint: str, world: int) -> None:
    store.put(_key(job_id, f"worldsvc/{stage}"),
              json.dumps({"endpoint": endpoint, "world": int(world),
                          "ts": time.time()}).encode())


def read_world_service(store, job_id: str, stage: str) -> dict | None:
    return _read(store, _key(job_id, f"worldsvc/{stage}"))


def write_done(store, job_id: str, stage: str, pod_id: str, stats: dict | None = None) -> None:
    rec = {"ts": time.time()}
    rec.update(stats or {})
    store.put(_key(job_id, f"done/{stage}/{pod_id}"), json.dumps(rec).encode())


def load_done(store, job_id: str, stage: str) -> dict[str, dict]:
    """``{pod_id: stats}`` for every pod that finished its reshard."""
    prefix = _key(job_id, f"done/{stage}/")
    recs, _rev = store.get_prefix(prefix)
    out: dict[str, dict] = {}
    for rec in recs:
        try:
            out[rec.key[len(prefix):]] = json.loads(rec.value.decode())
        except ValueError:
            continue
    return out
