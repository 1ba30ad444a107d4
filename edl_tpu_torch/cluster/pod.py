"""Pod and Trainer models (a copy of the JAX package's ``cluster/pod.py``).

A Pod is one launcher process on one host: unique id, cluster rank,
address, the port of its RPC server, local device list and its trainers.
The JSON is the JAX launcher's, so a torch trainer reads the cluster record
that the unchanged launcher writes (``cluster/cluster.py``).
"""

from __future__ import annotations

import uuid

from edl_tpu_torch.utils.serialization import JsonSerializable, register_serializable


@register_serializable
class Trainer(JsonSerializable):
    def __init__(self, endpoint: str = "", rank_in_pod: int = 0,
                 global_rank: int = -1, device_ids: list[int] | None = None):
        self.endpoint = endpoint          # ip:port of the trainer's rendezvous
        self.rank_in_pod = rank_in_pod
        self.global_rank = global_rank
        self.device_ids = list(device_ids or [])


@register_serializable
class Pod(JsonSerializable):
    def __init__(self, pod_id: str | None = None, addr: str = "127.0.0.1",
                 port: int = 0, device_ids: list[int] | None = None):
        self.pod_id = pod_id or uuid.uuid4().hex
        self._rank = -1
        self.addr = addr
        self.port = port                  # pod RPC server port
        self.device_ids = list(device_ids or [])
        self.trainers: list[Trainer] = []
        self.stage: str = ""              # cluster stage this pod joined at

    @property
    def rank(self) -> int:
        return self._rank

    @rank.setter
    def rank(self, value: int) -> None:
        self._rank = value

    def update_trainer_global_ranks(self, base: int) -> int:
        """Assign global ranks to this pod's trainers starting at ``base``;
        returns the next free rank."""
        for i, t in enumerate(self.trainers):
            t.rank_in_pod = i
            t.global_rank = base + i
        return base + len(self.trainers)

    @property
    def endpoint(self) -> str:
        return f"{self.addr}:{self.port}"

    def to_dict(self) -> dict:
        d = super().to_dict()
        d["rank"] = self._rank
        d.pop("_rank", None)
        return d

    def from_dict(self, d: dict) -> "Pod":
        if not hasattr(self, "trainers"):  # instance came from __new__
            self.__init__()
        d = dict(d)
        self._rank = d.pop("rank", self._rank)
        super().from_dict(d)
        return self
