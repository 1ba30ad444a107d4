"""Trainer environment: the ``EDL_TPU_*`` env-var contract.

A copy of the trainer side of the JAX package's ``cluster/env.py``.  The
env-var set is the launcher-to-trainer contract: the launcher never
touches the training code, it exports these variables and restarts
processes, so a PyTorch trainer reads the same names as a JAX one.
"""

from __future__ import annotations

import os


class TrainerEnv:
    """What a spawned trainer process reads back from its environment."""

    def __init__(self, env: dict[str, str] | None = None):
        e = env if env is not None else os.environ
        self.job_id = e.get("EDL_TPU_JOB_ID", "")
        self.coord_endpoints = e.get("EDL_TPU_COORD_ENDPOINTS", "")
        self.global_rank = int(e.get("EDL_TPU_TRAINER_ID", "0"))
        self.rank_in_pod = int(e.get("EDL_TPU_TRAINER_RANK_IN_POD", "0"))
        eps = e.get("EDL_TPU_TRAINER_ENDPOINTS", "")
        self.trainer_endpoints = [p for p in eps.split(",") if p]
        self.world_size = int(e.get("EDL_TPU_TRAINERS_NUM", "1"))
        self.coordinator = e.get("EDL_TPU_COORDINATOR", "")
        self.pod_id = e.get("EDL_TPU_POD_ID", "")
        self.pod_rank = int(e.get("EDL_TPU_POD_RANK", "0"))
        self.cluster_stage = e.get("EDL_TPU_CLUSTER_STAGE", "")
        ids = e.get("EDL_TPU_DEVICE_IDS", "")
        self.device_ids = [int(d) for d in ids.split(",") if d != ""]
        self.checkpoint_dir = e.get("EDL_TPU_CKPT_DIR", "")

    @property
    def is_distributed(self) -> bool:
        return self.world_size > 1

    @property
    def endpoint(self) -> str:
        if self.trainer_endpoints and self.global_rank < len(self.trainer_endpoints):
            return self.trainer_endpoints[self.global_rank]
        return ""
