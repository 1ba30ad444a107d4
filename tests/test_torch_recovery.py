"""The trainer half of the resize's recovery-time record: the port's copy
of ``cluster/recovery.py`` against the JAX package's (the unchanged JAX
launcher writes the other half), and the trainer's write: once, after the
first step that follows a restore, on rank 0 of the pod, under a stage."""

import json

import pytest
import torch

from edl_tpu.cluster import recovery as jrecovery
from edl_tpu.coord.memory import MemoryKV
from edl_tpu_torch import train_lm
from edl_tpu_torch.cluster import recovery
from edl_tpu_torch.cluster.env import TrainerEnv

ARGV = ["--device", "cpu", "--vocab", "64", "--layers", "1", "--embed", "32", "--heads", "2",
        "--mlp", "64", "--seq_len", "16", "--batch_size", "2", "--steps_per_epoch", "2"]
LAUNCHER = {"detect": 100.0, "killed": 100.5, "barrier": 101.25, "spawn": 102.0}


def test_trainer_half_merges_with_the_jax_launcher_half():
    """The port's trainer half and the JAX launcher's half in one JAX store
    give, in the JAX summary, the entry JAX's own trainer half gives; the
    port's summary reads the same records the same way."""
    summaries = []
    for write in (recovery.write_trainer_half, jrecovery.write_trainer_half):
        kv = MemoryKV()
        try:
            jrecovery.write_launcher_half(kv, "j", "stage-2", "pod-a", dict(LAUNCHER))
            write(kv, "j", "stage-2", "pod-a", restored=103.0, first_step=104.5,
                  restore_source="storage")
            write(kv, "j", "stage-2", "pod-b", restored=103.25, first_step=104.0)
            recs = kv.get_prefix("/edl_tpu/j/recovery/")[0]
            summaries.append((jrecovery.summarize_recovery(kv, "j", kill_time=99.0),
                              recovery.summarize_recovery(kv, "j", kill_time=99.0),
                              recovery.load_recovery_records(kv, "j"),
                              [(r.key, r.value) for r in recs]))
        finally:
            kv.close()
    (jax_of_ours, ours, records, raw), (jax_of_theirs, _, _, raw_theirs) = summaries
    assert raw == raw_theirs                     # byte-identical keys and values
    assert jax_of_ours == jax_of_theirs == ours
    entry, = ours
    assert entry["total"] == 4.5 and entry["restored_to_first_step"] == 1.5
    assert entry["spawn_to_restored"] == 1.0 and entry["restore_source"] == "storage"
    assert entry["kill_to_detect"] == 1.0 and entry["resize_mode"] == "stop_resume"
    assert set(records["stage-2"]["trainer"]) == {"pod-a", "pod-b"}
    # a stage with no launcher half is not an entry
    kv = MemoryKV()
    recovery.write_trainer_half(kv, "j", "stage-3", "pod-a", 1.0, 2.0)
    assert recovery.summarize_recovery(kv, "j") == jrecovery.summarize_recovery(kv, "j") == []
    kv.close()


class _Store:
    """A JAX MemoryKV that records the trainer's recovery writes and may
    fail them."""

    def __init__(self, fail=False):
        self.kv, self.fail, self.recovery_puts = MemoryKV(), fail, 0

    def put(self, key, value, lease_id=0):
        if "/recovery/" in key:
            self.recovery_puts += 1
            if self.fail:
                raise ConnectionError("store down")
        return self.kv.put(key, value, lease_id)

    def __getattr__(self, name):
        return getattr(self.kv, name)


def _train(tmp_path, store, env, epochs):
    args = train_lm.parse_args(ARGV)
    tenv = TrainerEnv({"EDL_TPU_JOB_ID": "j", "EDL_TPU_POD_ID": "pod-a", **env})
    _, trainer, init_fn, tx = train_lm.build_trainer(args, torch.device("cpu"),
                                                     str(tmp_path / "ckpt"), store, tenv)
    state, meta = trainer.restore_or_create(init_fn, tx)

    def data_fn(epoch):
        gen = train_lm.markov_corpus(args, epoch)
        for _ in range(args.steps_per_epoch):
            yield next(gen)

    return trainer.fit(state, meta, data_fn, epochs=epochs)


@pytest.mark.parametrize("env,writes", [
    ({"EDL_TPU_CLUSTER_STAGE": "stage-1"}, 1),
    ({"EDL_TPU_CLUSTER_STAGE": "stage-1", "EDL_TPU_TRAINER_RANK_IN_POD": "1"}, 0),
    ({}, 0)])
def test_trainer_writes_its_half_once_after_the_first_restored_step(tmp_path, env, writes):
    store = _Store()
    _train(tmp_path, store, env, 1)              # fresh: nothing restored, no record
    assert store.recovery_puts == 0
    state, _ = _train(tmp_path, store, env, 3)   # restores at epoch 1, trains 4 steps
    assert state.step == 6 and store.recovery_puts == writes
    if writes:
        half = json.loads(store.kv.get("/edl_tpu/j/recovery/stage-1/trainer/pod-a").value)
        assert set(half) == {"restored", "first_step", "restore_source"}
        assert half["restore_source"] == "storage"
        assert 0 < half["first_step"] - half["restored"] < 60
    store.kv.close()


def test_a_failed_record_write_does_not_fail_the_job(tmp_path):
    store = _Store(fail=True)
    env = {"EDL_TPU_CLUSTER_STAGE": "stage-1"}
    _train(tmp_path, store, env, 1)
    state, meta = _train(tmp_path, store, env, 2)
    assert state.step == 4 and meta.next_epoch == 2 and store.recovery_puts == 1
    store.kv.close()
