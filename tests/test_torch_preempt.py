"""The SIGTERM preemption grace in the port's trainer: the flag records
against the JAX package's ``cluster/preempt.py``, the check's cadence
(solo: wall clock; a world: a step multiple, then the step the check
agrees on), and a 2-rank gloo world in which only rank 0 reads the store:
both ranks checkpoint at the same step and exit ``PREEMPT_EXIT_CODE``."""

import json
import os
import pathlib
import subprocess
import sys

import torch
import torch.distributed as dist

from edl_tpu.cluster import preempt as jpreempt
from edl_tpu_torch.cluster import heartbeat, preempt
from edl_tpu_torch.cluster.env import TrainerEnv
from edl_tpu_torch.train.trainer import ElasticTrainer, TrainConfig
from edl_tpu_torch.utils import constants
from edl_tpu_torch.utils.network import find_free_port

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORKER_TIMEOUT = 120      # seconds per rank process


def test_flags_read_across_the_packages(memkv):
    assert constants.PREEMPT_EXIT_CODE == 94
    t = preempt.flag_preempt(memkv, "j", "stg", "pod-a", reason="descale")
    assert jpreempt.get_preempt(memkv, "j", "stg") == t == preempt.get_preempt(memkv, "j", "stg")
    assert jpreempt.pod_preempt_info(memkv, "j", "stg", "pod-a") == (t, "descale")
    t2 = jpreempt.flag_preempt(memkv, "j", "stg", "pod-b")
    assert preempt.pod_preempt_info(memkv, "j", "stg", "pod-b") == (t2, "sigterm")
    assert preempt.is_pod_preempted(memkv, "j", "stg", "pod-a")
    assert not preempt.is_pod_preempted(memkv, "j", "other", "pod-a")
    assert preempt.get_preempt(memkv, "j", "other") is None
    assert heartbeat.read_stage_flag_info(memkv, "j", "preempt", "stg") == (t2, "pod-b")
    # the record before reasons: a bare timestamp reads as sigterm
    memkv.put("/edl_tpu/j/heartbeat/preempt_pod/stg/pod-c", b"12.5")
    assert preempt.pod_preempt_info(memkv, "j", "stg", "pod-c") == (12.5, "sigterm")


class _CountingStore:
    def __init__(self, kv):
        self.kv, self.gets = kv, 0

    def get(self, key):
        self.gets += 1
        return self.kv.get(key)

    def __getattr__(self, name):
        return getattr(self.kv, name)


def _trainer(store, **env):
    tenv = TrainerEnv({"EDL_TPU_JOB_ID": "pj", "EDL_TPU_POD_ID": "pod1",
                       "EDL_TPU_CLUSTER_STAGE": "stg", **env})
    return ElasticTrainer(lambda *a: None, TrainConfig(log_every=0), store=store, tenv=tenv,
                          device="cpu")


def test_maybe_preempt_unit(memkv, monkeypatch):
    """Solo: the first step checks, a step inside the wall-clock window
    reads no store, and a due check with the flag up checkpoints and exits
    PREEMPT_EXIT_CODE (the JAX test_maybe_preempt_unit)."""
    store = _CountingStore(memkv)
    tr = _trainer(store)
    exits = []
    monkeypatch.setattr("os._exit", lambda code: exits.append(code))
    tr._maybe_preempt(None, None, 1)     # first call checks; no flag yet
    assert exits == [] and store.gets == 1
    preempt.flag_preempt(memkv, "pj", "stg", "pod2")
    tr._maybe_preempt(None, None, 2)     # inside the window: no store read
    assert exits == [] and store.gets == 1
    tr._preempt_last_check_t -= constants.preempt_check_seconds() + 1
    tr._maybe_preempt(None, None, 3)     # due and flagged: exit
    assert exits == [constants.PREEMPT_EXIT_CODE]
    # not under the launcher (no stage): never checks
    bare = _trainer(store, EDL_TPU_CLUSTER_STAGE="")
    bare._maybe_preempt(None, None, 1)
    assert store.gets == 3 and exits == [constants.PREEMPT_EXIT_CODE]  # +1: the reason read


def test_world_cadence_agrees_on_the_next_check(memkv, monkeypatch):
    """In a world: the first check on a preempt_check_steps() multiple; each
    check is one all-reduce MAX of [seen, proposal]; the next check is the
    agreed step.  Rank 1 of a pod reads no store, yet sees a peer's
    sighting through the collective."""
    monkeypatch.setenv("EDL_TPU_PREEMPT_CHECK_STEPS", "3")
    monkeypatch.setattr(ElasticTrainer, "world_size", property(lambda self: 2))
    peer = {"seen": 0, "proposal": 5}
    reduced = []

    def all_reduce(t, op=None):
        assert op == dist.ReduceOp.MAX and t.dtype == torch.int64 and t.shape == (2,)
        reduced.append(t.tolist())
        t.copy_(torch.maximum(t, torch.tensor([peer["seen"], peer["proposal"]])))

    monkeypatch.setattr(dist, "all_reduce", all_reduce)
    monkeypatch.setattr(dist, "barrier", lambda: reduced.append("barrier"))
    exits = []
    monkeypatch.setattr("os._exit", lambda code: exits.append(code))
    store = _CountingStore(memkv)
    tr = _trainer(store, EDL_TPU_TRAINER_RANK_IN_POD="1")
    tr._step_ema = 1.0                   # 2 s of checks = 2 steps: the peer's 5 wins
    for step in range(1, 9):
        tr._maybe_preempt(None, None, step)
    assert reduced == [[0, 2], [0, 2]] and tr._preempt_next_check == 13
    peer["seen"] = 1
    for step in range(9, 14):
        tr._maybe_preempt(None, None, step)
    assert reduced[2:] == [[0, 2], "barrier"] and exits == [constants.PREEMPT_EXIT_CODE]
    assert store.gets == 1               # rank 1 read only its own pod's reason


def _rank_env(rank, port, ckpt, ep):
    env = {k: v for k, v in os.environ.items() if not k.startswith("EDL_TPU_")}
    env.update({"PYTHONPATH": str(ROOT), "EDL_TPU_JOB_ID": "pj", "EDL_TPU_TRAINER_ID": str(rank),
                "EDL_TPU_TRAINER_RANK_IN_POD": "0", "EDL_TPU_TRAINERS_NUM": "2",
                "EDL_TPU_COORDINATOR": f"127.0.0.1:{port}", "EDL_TPU_POD_ID": f"pod-{rank}",
                "EDL_TPU_CLUSTER_STAGE": "stg", "EDL_TPU_CKPT_DIR": str(ckpt),
                "EDL_TPU_RESIZE_DELTA": "0", "EDL_TPU_PREEMPT_CHECK_STEPS": "3",
                "OMP_NUM_THREADS": "2"})
    if rank == 0:                        # only rank 0 is given the store
        env["EDL_TPU_COORD_ENDPOINTS"] = ep
    return env


def test_two_rank_world_checkpoints_and_exits_together(coord_server, tmp_path):
    ep = f"127.0.0.1:{coord_server.port}"
    from edl_tpu.coord.client import CoordClient
    client = CoordClient(ep)
    jpreempt.flag_preempt(client, "pj", "stg", "pod-0")
    client.close()
    port, ckpt = find_free_port(), tmp_path / "ckpt"
    argv = [sys.executable, "-m", "edl_tpu_torch.train_lm", "--device", "cpu", "--vocab", "64",
            "--layers", "1", "--embed", "32", "--heads", "2", "--mlp", "64", "--seq_len", "16",
            "--batch_size", "2", "--steps_per_epoch", "4", "--epochs", "3"]
    logs = [open(tmp_path / f"rank{r}.log", "w+") for r in range(2)]
    procs = [subprocess.Popen(argv, env=_rank_env(r, port, ckpt, ep), cwd=ROOT, stdout=log,
                              stderr=subprocess.STDOUT, text=True) for r, log in enumerate(logs)]
    try:
        for p in procs:
            p.wait(timeout=WORKER_TIMEOUT)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    outs = [(tmp_path / f"rank{r}.log").read_text() for r in range(2)]
    assert [p.returncode for p in procs] == [94, 94], outs
    for out in outs:
        assert "preemption flagged: checkpointing at step 3" in out, out[-2000:]
    assert "reason=sigterm" in outs[0] and "reason=peer-preempt" in outs[1]
    assert sorted(d for d in os.listdir(ckpt) if not d.startswith(".")) == ["3"]
    meta = json.loads((ckpt / "3" / "meta" / "metadata").read_text())
    assert meta["step"] == 3 and meta["in_epoch"] == 0
