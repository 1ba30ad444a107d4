"""Cluster: rank-ordered pods and the membership stage (a copy of the JAX
package's ``cluster/cluster.py``, the part a trainer reads).

The ``stage`` is a uuid regenerated iff membership changes; the leader is
``pods[0]``, and its pod server hosts the data service.  The record is the
JSON the JAX launcher writes under ``ETCD_CLUSTER/cluster``.
"""

from __future__ import annotations

import uuid

from edl_tpu_torch.cluster import paths
from edl_tpu_torch.cluster.pod import Pod
from edl_tpu_torch.utils import constants
from edl_tpu_torch.utils.exceptions import EdlTableError
from edl_tpu_torch.utils.serialization import JsonSerializable, register_serializable


@register_serializable
class Cluster(JsonSerializable):
    def __init__(self):
        self.pods: list[Pod] = []
        self.stage: str = ""

    def new_stage(self) -> None:
        self.stage = uuid.uuid4().hex

    @staticmethod
    def from_pods(pods: list[Pod]) -> "Cluster":
        """Rank pods in the given order and renumber trainer global ranks."""
        c = Cluster()
        c.pods = pods
        c.new_stage()
        base = 0
        for rank, pod in enumerate(pods):
            pod.rank = rank
            pod.stage = c.stage
            base = pod.update_trainer_global_ranks(base)
        return c

    @property
    def leader(self) -> Pod | None:
        return self.pods[0] if self.pods else None

    def pod_ids(self) -> list[str]:
        return [p.pod_id for p in self.pods]

    def get_pod(self, pod_id: str) -> Pod | None:
        return next((p for p in self.pods if p.pod_id == pod_id), None)

    def get_trainers_endpoints(self) -> list[str]:
        """Every trainer's endpoint, in global-rank order."""
        return [t.endpoint for p in self.pods for t in p.trainers]

    @property
    def world_size(self) -> int:
        return sum(len(p.trainers) for p in self.pods)

    @staticmethod
    def load_from_store(store, job_id: str) -> "Cluster | None":
        rec = store.get(paths.key(job_id, constants.ETCD_CLUSTER, "cluster"))
        if rec is None or not rec.value:
            return None
        return Cluster().from_json(rec.value.decode())

    def save_to_store(self, store, job_id: str, leader_pod_id: str) -> bool:
        """Guarded write: only while ``leader_pod_id`` still holds the seat."""
        ok = store.put_if_equals(
            paths.key(job_id, constants.ETCD_POD_RANK, constants.LEADER_KEY),
            leader_pod_id.encode(),
            paths.key(job_id, constants.ETCD_CLUSTER, "cluster"),
            self.to_json().encode())
        if not ok:
            raise EdlTableError(f"pod {leader_pod_id} is no longer leader; cluster not written")
        return True
