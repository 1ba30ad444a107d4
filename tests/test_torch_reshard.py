"""The port's live-reshard placement diff (``memstate/reshard.py``) and
handshake records (``cluster/resize.py``) against the JAX package's
(``tests/test_reshard.py``'s twin): the same rankings and plans on the same
pod sets, resize records written by either package read by the other, and
the shard map of the port's cached sets collected by the JAX package's
``collect_shard_map`` as by the port's."""

import pytest

from edl_tpu.cluster import resize as jax_resize
from edl_tpu.memstate import reshard as jax_reshard
from edl_tpu_torch.cluster import resize
from edl_tpu_torch.memstate import placement
from edl_tpu_torch.memstate.reshard import collect_shard_map, reshard_plan, stable_ranking


def shards_for(owners: dict[str, int], nbytes: int = 100) -> dict:
    return {f"['w']@{owner[-1]}{i}:0": {"owner": owner, "nbytes": nbytes}
            for owner, n in owners.items() for i in range(n)}


@pytest.mark.parametrize("old,new", [(["b", "a", "c"], ["c", "a", "z", "x"]),
                                     (["p1", "p2", "p3"], ["p9", "p3", "p1"]),
                                     (["p1", "p2", "p3"], ["p1", "p3", "p9"]),
                                     (["a"], ["a", "b"]), (["a", "b"], [])])
def test_stable_ranking_equals_jax(old, new):
    assert stable_ranking(old, new) == jax_reshard.stable_ranking(old, new)


PLANS = [
    (["pod-a", "pod-b"], ["pod-a", "pod-b", "pod-c"], {"pod-a": 3, "pod-b": 2}),   # grow
    (["pod-a", "pod-b", "pod-c"], ["pod-a", "pod-b"], {"pod-a": 2, "pod-b": 2, "pod-c": 3}),
    (["pod-a", "pod-b", "pod-c"], ["pod-a", "pod-b"], {"pod-c": 2}),               # replica src
    (["pod-a", "pod-b", "pod-c"], ["pod-a", "pod-c", "pod-d"],
     {"pod-a": 2, "pod-b": 2, "pod-c": 2}),                                        # swap
    (["pod-a", "pod-b", "pod-c"], ["pod-d", "pod-a", "pod-b"], {"pod-a": 1, "pod-b": 2, "pod-c": 3}),
    (["pod-a", "pod-b"], ["pod-x"], {"pod-b": 1}),                                 # no copy left
    (["a"], ["a", "b"], {}),
]


def _plan_tuple(plan):
    return (plan.ranking, [(m.key, m.nbytes, m.old_owner, m.new_owner, m.src) for m in plan.moves],
            plan.kept, plan.moved_bytes, plan.kept_bytes, plan.shards_total, plan.kept_fraction)


@pytest.mark.parametrize("old,new,owners", PLANS)
def test_reshard_plan_equals_jax(old, new, owners):
    shards = shards_for(owners)
    got = reshard_plan(old, new, shards)
    assert _plan_tuple(got) == _plan_tuple(jax_reshard.reshard_plan(old, new, shards))
    assert all(m.old_owner not in set(new) for m in got.moves)
    assert got.kept_bytes + got.moved_bytes == 100 * sum(owners.values())


def test_plan_properties():
    grow = reshard_plan(["pod-a", "pod-b"], ["pod-a", "pod-b", "pod-c"],
                        shards_for({"pod-a": 3, "pod-b": 2}))
    assert grow.moves == [] and grow.kept_fraction == 1.0
    shrink = reshard_plan(["pod-a", "pod-b", "pod-c"], ["pod-a", "pod-b"],
                          shards_for({"pod-c": 2}))
    assert {m.src for m in shrink.moves} == {placement.replica_for("pod-c",
                                                                   ["pod-a", "pod-b", "pod-c"])}
    lost = reshard_plan(["pod-a", "pod-b"], ["pod-x"], shards_for({"pod-b": 1}))
    assert [m.src for m in lost.moves] == [None]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_resize_records_roundtrip_across_the_packages(memkv, writer):
    w, r = (resize, jax_resize) if writer == "port" else (jax_resize, resize)
    w.flag_resize(memkv, "j", "s-old", "grow", "s-new", "pod-a")
    flag = r.read_resize_flag(memkv, "j", "s-old")
    assert flag["mode"] == "grow" and flag["new_stage"] == "s-new" and flag["pod"] == "pod-a"
    assert r.read_resize_flag(memkv, "j", "other") is None
    w.write_go(memkv, "j", "s-old", "s-new", "grow")
    assert r.read_go(memkv, "j", "s-old")["new_stage"] == "s-new"
    w.publish_world_service(memkv, "j", "s-new", "10.0.0.1:4242", 3)
    svc = r.read_world_service(memkv, "j", "s-new")
    assert svc["endpoint"] == "10.0.0.1:4242" and svc["world"] == 3
    assert r.read_world_service(memkv, "j", "s-old") is None
    w.write_done(memkv, "j", "s-new", "pod-a", {"mode": "grow", "seconds": 1.5})
    w.write_done(memkv, "j", "s-new", "pod-b")
    done = r.load_done(memkv, "j", "s-new")
    assert set(done) == {"pod-a", "pod-b"} and done["pod-a"]["seconds"] == 1.5


def test_collect_shard_map_of_the_ports_sets(memkv, tmp_path):
    """pod-a's tee seals a set at step 7 and pod-b holds its replica: both
    packages' collectors count the owner's set once, with the manifest's
    bytes; the plan of a grow keeps all of it."""
    from edl_tpu_torch.cluster.state import State
    from edl_tpu_torch.memstate import advert
    from edl_tpu_torch.memstate.tee import StateCacheTee
    from edl_tpu_torch.train.checkpoint import CheckpointManager
    from tests.helpers.torch_cache import JOB, serve_pods, teardown, tiny_state, wait_for

    pods = serve_pods(memkv, ["pod-a", "pod-b"])
    try:
        ck = CheckpointManager(str(tmp_path / "ck"), tee=StateCacheTee(memkv, JOB, "pod-a"))
        assert ck.save(7, tiny_state(), State())
        ck.wait()
        wait_for(lambda: advert.read_committed_step(memkv, JOB) == 7, "never sealed")
        wait_for(lambda: "pod-a" in pods["pod-b"][0].cache_manifest(), "no replica")
        got = collect_shard_map(memkv, JOB)
        assert got == jax_reshard.collect_shard_map(memkv, JOB)
        manifest = pods["pod-a"][0].cache_manifest()["pod-a"]["shards"]
        assert got == {k: {"owner": "pod-a", "nbytes": e["nbytes"]} for k, e in manifest.items()}
        plan = jax_reshard.reshard_plan(["pod-a", "pod-b"], ["pod-a", "pod-b", "pod-c"], got)
        assert plan.kept_fraction == 1.0 and plan.kept_bytes == sum(e["nbytes"]
                                                                   for e in got.values())
        ck.close()
    finally:
        teardown(pods)


def test_live_grow_at_world_one_in_process(memkv, tmp_path, monkeypatch):
    """The trainer's pause and live reshard with the launcher played in
    process (the card's ``reshard`` phase (c) at toy size): a grow flag and
    a go record to stage st-2; the same trainer pauses at its next check,
    restores from its local snapshot (``delta``, no wire bytes), writes
    st-2's done record and the recovery half, and trains on with an
    uninterrupted run's losses; the replaced state's tensors are freed."""
    import torch

    from edl_tpu.cluster.recovery import load_recovery_records
    from edl_tpu_torch import train_lm
    from edl_tpu_torch.cluster.cluster import Cluster
    from edl_tpu_torch.cluster.env import TrainerEnv
    from edl_tpu_torch.cluster.pod import Pod, Trainer
    from tests.helpers.torch_cache import JOB, serve_pods, teardown

    def cluster(stage):
        pod = Pod(pod_id="pod-a")
        pod.trainers = [Trainer(endpoint="127.0.0.1:1")]
        c = Cluster.from_pods([pod])
        c.stage = stage
        memkv.put(f"/edl_tpu/{JOB}/cluster/cluster", c.to_json().encode())

    monkeypatch.setenv("EDL_TPU_PREEMPT_CHECK_SECONDS", "0")   # a solo check every step
    args = train_lm.parse_args(["--device", "cpu", "--vocab", "64", "--layers", "1",
                                "--embed", "32", "--heads", "2", "--mlp", "64", "--seq_len", "16",
                                "--batch_size", "2", "--steps_per_epoch", "4"])
    ids = train_lm.markov_corpus(args, 5).__next__()["ids"]

    def data_fn(_epoch):
        for _ in range(args.steps_per_epoch):
            yield {"ids": ids}

    def build(ckpt, store=None, tenv=None):
        _, tr, init_fn, tx = train_lm.build_trainer(args, torch.device("cpu"), ckpt, store, tenv)
        inner, losses = tr.loss_fn, []

        def recording(*a):
            loss, aux = inner(*a)
            losses.append(float(loss.detach()))
            return loss, aux
        tr.loss_fn = recording
        return tr, init_fn, tx, losses

    straight, init_fn, tx, want = build("")
    st, meta = straight.restore_or_create(init_fn, tx)
    straight.fit(st, meta, data_fn, epochs=4)

    pods = serve_pods(memkv, ["pod-a"])
    cluster("st-1")
    tenv = TrainerEnv({"EDL_TPU_JOB_ID": JOB, "EDL_TPU_POD_ID": "pod-a",
                       "EDL_TPU_CLUSTER_STAGE": "st-1", "EDL_TPU_COORD_ENDPOINTS": "memory"})
    try:
        tr, init_fn, tx, got = build(str(tmp_path / "ck"), memkv, tenv)
        st, meta = tr.restore_or_create(init_fn, tx)
        st, meta = tr.fit(st, meta, data_fn, epochs=1)
        resize.flag_resize(memkv, JOB, "st-1", "grow", "st-2", "pod-a")
        resize.write_go(memkv, JOB, "st-1", "st-2", "grow")
        cluster("st-2")
        old = st
        st, meta = tr.fit(st, meta, data_fn, epochs=3)
        [rs] = tr.reshards
        assert (rs["mode"], rs["source"], rs["step"], rs["wire_bytes"]) == ("grow", "delta", 5, 0)
        assert rs["local_bytes"] > 0 and tr.tenv.cluster_stage == "st-2"
        assert jax_resize.load_done(memkv, JOB, "st-2")["pod-a"]["source"] == "delta"
        half = load_recovery_records(memkv, JOB)["st-2"]["trainer"]["pod-a"]
        assert half["restore_source"] == "delta" and half["first_step"] >= half["restored"]
        assert st is not old and all(p.numel() == 0 for p in old.model.parameters())
        # 4 steps, the pause after step 5, then epoch 1 again (4 steps) and epoch 2
        assert st.step == 13 and got == pytest.approx(want[:13], rel=1e-6)
    finally:
        teardown(pods)


def test_shrink_flag_aborts_an_nccl_group(memkv, tmp_path, monkeypatch):
    """Under NCCL a survivor's collective waits for its timeout instead of
    failing, so a shrink flag seen by the poll aborts the communicator and
    fails the step as a lost peer (converted into the shrink reshard); a
    grow flag starts the pause; under gloo a shrink flag changes nothing
    (the failed collective converts)."""
    import torch
    import torch.distributed as dist

    from edl_tpu_torch import train_lm
    from edl_tpu_torch.cluster.env import TrainerEnv
    from edl_tpu_torch.train import trainer as trainer_mod

    args = train_lm.parse_args(["--device", "cpu", "--vocab", "64", "--layers", "1",
                                "--embed", "32", "--heads", "2", "--mlp", "64"])
    tenv = TrainerEnv({"EDL_TPU_JOB_ID": "j", "EDL_TPU_POD_ID": "pod-a",
                       "EDL_TPU_CLUSTER_STAGE": "st-1", "EDL_TPU_COORD_ENDPOINTS": "memory"})
    _, tr, init_fn, tx = train_lm.build_trainer(args, torch.device("cpu"), str(tmp_path),
                                                memkv, tenv)
    tr.create_state(init_fn, tx)
    assert tr._delta_ready() and not tr._read_grow_flag()
    resize.flag_resize(memkv, "j", "st-1", "grow", "st-2", "pod-a")
    assert tr._read_grow_flag()
    resize.flag_resize(memkv, "j", "st-1", "shrink", "st-2", "pod-b")
    aborted = []
    backend = {"name": "gloo"}
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_backend", lambda *a: backend["name"])
    monkeypatch.setattr(trainer_mod.edl_dist, "leak_world", lambda abort=False: aborted.append(abort))
    assert not tr._read_grow_flag() and aborted == []
    backend["name"] = "nccl"
    with pytest.raises(trainer_mod._PeerLost):
        tr._read_grow_flag()
    assert aborted == [True]
