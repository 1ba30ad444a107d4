"""One trainer-shaped process of the resizable-world test
(``tests/test_torch_distributed.py``): it forms its world from the
launcher's env, then follows the test's control records
(``/edl_tpu/<job>/test/step/<n>``), re-forming the world in place each time
(or, with ``again``, the same stage once more under a new nonce), and
reports after each formation: its pid, rank, world size, the all-reduce of
rank + 1 and the gate's nonce.  It leaves when a stage no longer holds its
pod, or at a control record ``end``."""

import json
import os
import sys
import time

import torch
import torch.distributed as dist

from edl_tpu_torch.cluster.cluster import Cluster
from edl_tpu_torch.cluster.env import TrainerEnv
from edl_tpu_torch.coord.client import connect
from edl_tpu_torch.train import distributed


def main():
    tenv = TrainerEnv()
    store = connect(tenv.coord_endpoints)
    base = f"/edl_tpu/{tenv.job_id}"

    def report(n, **extra):
        total = None
        if dist.is_initialized():
            t = torch.tensor([tenv.global_rank + 1.0])
            dist.all_reduce(t)
            total = t.item()
        gate = store.get(f"{base}/torchworld/{tenv.cluster_stage}/gate")
        rec = {"pid": os.getpid(), "rank": tenv.global_rank, "world": tenv.world_size,
               "initialized": dist.is_initialized(), "sum": total,
               "nonce": json.loads(gate.value)["nonce"] if gate is not None else None,
               "env_world": os.environ.get("EDL_TPU_TRAINERS_NUM"), **extra}
        store.put(f"{base}/test/out/{n}/{tenv.pod_id}", json.dumps(rec).encode())

    distributed.initialize_from_env(tenv, "cpu")
    report(0)
    n = 1
    while True:
        rec = store.get(f"{base}/test/step/{n}")
        if rec is None:
            time.sleep(0.05)
            continue
        ctl = json.loads(rec.value)
        if ctl.get("end"):
            break
        if ctl["stage"] == tenv.cluster_stage and not ctl.get("again"):
            n += 1          # the stage this process was spawned into
            continue
        cluster = Cluster.load_from_store(store, tenv.job_id)
        if cluster is None or cluster.stage != ctl["stage"]:
            time.sleep(0.05)
            continue
        if cluster.get_pod(tenv.pod_id) is None:
            distributed.leak_world()
            report(n, left=True)
            break
        if ctl.get("again"):
            distributed.leak_world()
            distributed.form_world(tenv, store, "cpu", timeout=60.0, min_ts=ctl["ts"])
        else:
            distributed.reform_world(tenv, store, cluster, "cpu")
        report(n)
        n += 1
    store.close()
    distributed.shutdown()


if __name__ == "__main__":
    sys.exit(main())
