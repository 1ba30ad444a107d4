"""Per-pod training progress status (a copy of the JAX package's
``cluster/train_status.py``).

The launcher's cluster generator reads these: it refuses to add pods once
a pod reports ``NEARTHEEND`` (no point resizing a job about to finish).
Keys and values are the JAX package's, byte for byte.
"""

from __future__ import annotations

import enum

from edl_tpu_torch.cluster import paths
from edl_tpu_torch.utils import constants


class TrainStatus(str, enum.Enum):
    INITIAL = "initial"
    RUNNING = "running"
    NEARTHEEND = "neartheend"
    SUCCEED = "succeed"
    FAILED = "failed"


#: statuses during which the generator may still scale out
SCALABLE = (TrainStatus.INITIAL, TrainStatus.RUNNING)


def save_train_status(store, job_id: str, pod_id: str, status: TrainStatus) -> None:
    store.put(paths.key(job_id, constants.ETCD_TRAIN_STATUS, pod_id),
              status.value.encode())


def load_train_status(store, job_id: str, pod_id: str) -> TrainStatus | None:
    rec = store.get(paths.key(job_id, constants.ETCD_TRAIN_STATUS, pod_id))
    return TrainStatus(rec.value.decode()) if rec else None


def load_train_statuses(store, job_id: str) -> dict[str, TrainStatus]:
    recs, _ = store.get_prefix(paths.table_prefix(job_id, constants.ETCD_TRAIN_STATUS))
    return {r.key.rsplit("/", 1)[-1]: TrainStatus(r.value.decode()) for r in recs}
