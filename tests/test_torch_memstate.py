"""The port's peer checkpoint cache (``edl_tpu_torch/memstate``) against the
JAX package's (``tests/test_memstate.py``'s twin): ring replica placement,
the chunked shard calls and their rejections on both packages' services,
the tee and the cache-first restore bit-identical to storage, into the JAX
package's service too, owner loss, CRC rejection, staleness, the adverts
and the committed-step record read by the JAX package, the recovery
record's ``restore_source``, and the trainer's cache-first restore.

Pods are cache services on RPC servers over one in-process store, the
launcher's part, as in the JAX tests."""

import functools
import os
import zlib

import pytest
import torch

from edl_tpu.memstate import advert as jax_advert
from edl_tpu.memstate import placement as jax_placement
from edl_tpu_torch import train_lm
from edl_tpu_torch.cluster.env import TrainerEnv
from edl_tpu_torch.cluster.state import State
from edl_tpu_torch.memstate import advert, placement, shards
from edl_tpu_torch.memstate import restore as ms_restore
from edl_tpu_torch.memstate.service import StateCacheService
from edl_tpu_torch.memstate.tee import StateCacheTee
from edl_tpu_torch.rpc import chunks
from edl_tpu_torch.rpc.client import RpcClient
from edl_tpu_torch.train.checkpoint import CheckpointManager
from edl_tpu_torch.utils.exceptions import EdlInternalError
from tests.helpers.torch_cache import (JOB, fresh_target, kill_pod, serve_pods, teardown,
                                       tiny_state, wait_for)


# -- ring replica placement ------------------------------------------------------
@pytest.mark.parametrize("pods", [["a"], ["a", "b"], [f"pod-{i}" for i in range(6)],
                                  [f"p{i:02d}" for i in range(10)]])
def test_replica_placement_equals_the_jax_packages(pods):
    for owner in pods:
        got = placement.replica_for(owner, pods)
        assert got == jax_placement.replica_for(owner, pods)
        assert got == placement.replica_for(owner, list(reversed(pods)))
        assert got != owner and (got in pods or len(pods) == 1)


# -- the service's calls, on the port's and the JAX package's service -------------
@pytest.fixture(params=["port", "jax"])
def pod(request, memkv):
    pods = serve_pods(memkv, ["pod-a"], jax_service=request.param == "jax")
    svc, srv, _reg = pods["pod-a"]
    client = RpcClient(f"127.0.0.1:{srv.port}")
    yield svc, client
    client.close()
    teardown(pods)


def _push(client, owner, step, key, data, chunk=1 << 10):
    return chunks.push_bytes(functools.partial(client.call, "cache_put_chunk", owner=owner,
                                               step=step, key=key), data, chunk_bytes=chunk)


def _entry(data):
    return {"crc": zlib.crc32(data), "nbytes": len(data), "dtype": "uint8",
            "shape": [len(data)], "index": [[0, len(data)]], "gshape": [len(data)],
            "leaf": "x"}


def test_chunked_shard_roundtrip(pod):
    _svc, client = pod
    data = os.urandom(5000)
    assert _push(client, "pod-a", 3, "k", data) == 5
    assert client.call("cache_commit", owner="pod-a", step=3, manifest={"k": _entry(data)},
                       meta=b"{}")["ok"]
    listing = client.call("cache_manifest")
    assert listing["pod-a"]["step"] == 3 and listing["pod-a"]["has_meta"]
    got = chunks.fetch_bytes(functools.partial(client.call, "cache_fetch", owner="pod-a",
                                               key="k"), len(data), chunk_bytes=777)
    assert got == data and client.call("cache_meta", owner="pod-a") == b"{}"


def test_chunk_sequence_violation_rejected(pod):
    _svc, client = pod
    client.call("cache_put_chunk", owner="pod-a", step=1, key="k", seq=0, data=b"a", eof=False)
    with pytest.raises(Exception, match="seq"):
        client.call("cache_put_chunk", owner="pod-a", step=1, key="k", seq=2, data=b"c",
                    eof=True)


def test_commit_rejects_bad_crc(pod):
    _svc, client = pod
    _push(client, "pod-a", 1, "k", b"payload")
    bad = dict(_entry(b"payload"), crc=zlib.crc32(b"other"))
    with pytest.raises(Exception, match="CRC"):
        client.call("cache_commit", owner="pod-a", step=1, manifest={"k": bad})
    assert client.call("cache_manifest") == {}


@pytest.mark.parametrize("jax_service", [False, True])
def test_memory_cap_rejects_push_and_allows_a_superseding_step(memkv, jax_service):
    if jax_service:
        from edl_tpu.memstate.service import StateCacheService as Service
    else:
        Service = StateCacheService
    svc = Service(memkv, JOB, "pod-a", max_bytes=100)
    with pytest.raises(Exception, match="cap"):
        svc.cache_put_chunk("pod-a", 1, "k", 0, b"x" * 101, True)
    data = b"y" * 80
    svc.cache_put_chunk("pod-a", 1, "k", 0, data, True)
    assert svc.cache_commit("pod-a", 1, {"k": _entry(data)})["ok"]
    # the next step of the same owner replaces the set: its old bytes don't count
    svc.cache_put_chunk("pod-a", 2, "k", 0, data, True)
    assert svc.cache_commit("pod-a", 2, {"k": _entry(data)})["ok"]
    assert svc.cache_stats()["owners"]["pod-a"]["step"] == 2


# -- the snapshot's manifest ----------------------------------------------------------
def test_snapshot_manifest_is_the_jax_schema_with_bf16_words():
    state = tiny_state()
    snap = shards.snapshot(state)
    blobs = shards.finish_manifest(snap)
    leaves = {e["leaf"]: e for e in snap.manifest.values()}
    assert {"model/w", "model/b", "model/count", "optimizer/state/0/exp_avg",
            "optimizer/state/1/exp_avg_sq", shards.STRUCT_LEAF} <= set(leaves)
    for key, ent in snap.manifest.items():
        assert set(ent) == {"crc", "nbytes", "dtype", "shape", "index", "gshape", "leaf"}
        assert key == shards.shard_key(ent["leaf"], ent["index"])
        assert ent["index"] == [[0, d] for d in ent["gshape"]]   # a whole-leaf box
        assert ent["crc"] == zlib.crc32(blobs[key]) and ent["nbytes"] == len(blobs[key])
    b = leaves["model/b"]
    assert b["dtype"] == "bfloat16" and b["nbytes"] == 12
    words = state.model.b.detach().view(torch.int16).numpy().tobytes()
    assert bytes(blobs[shards.shard_key("model/b", [[0, 6]])]) == words


# -- tee + cache-first restore ----------------------------------------------------------
def _tee_save(store, tmp_path, state, step=7):
    tee = StateCacheTee(store, JOB, "pod-a")
    ck = CheckpointManager(str(tmp_path / "ck"), tee=tee)
    assert ck.save(step, state, State(total_batch_size=32))
    ck.wait()
    wait_for(lambda: advert.read_committed_step(store, JOB) == step, "the tee never sealed")
    return ck


@pytest.mark.parametrize("jax_service", [False, True])
def test_tee_restore_bit_identical_to_storage(memkv, tmp_path, jax_service):
    """The tee pushes into the port's or the JAX package's service; the
    port restores bit-equal from it."""
    pods = serve_pods(memkv, ["pod-a", "pod-b"], jax_service=jax_service)
    try:
        state = tiny_state()
        ck = _tee_save(memkv, tmp_path, state)
        res = ms_restore.try_restore(memkv, JOB, fresh_target(), expect_step=7)
        assert res is not None, "expected a cache hit"
        got, meta_json, info = res
        assert info["step"] == 7 and info["wire_bytes"] == info["bytes"] > 0
        assert State().from_json(meta_json).total_batch_size == 32
        stored, _ = ck.restore(fresh_target(), step=7)
        ms_restore.assert_bit_identical(got, stored)
        ms_restore.assert_bit_identical(got, state)
        ck.close()
    finally:
        teardown(pods)


def test_restore_survives_owner_pod_loss(memkv, tmp_path):
    pods = serve_pods(memkv, ["pod-a", "pod-b"])
    try:
        state = tiny_state()
        ck = _tee_save(memkv, tmp_path, state)
        wait_for(lambda: "pod-a" in pods["pod-b"][0].cache_manifest(), "no replica")
        kill_pod(memkv, pods, "pod-a")
        res = ms_restore.try_restore(memkv, JOB, fresh_target(), expect_step=7)
        assert res is not None, "the replica on pod-b should serve the restore"
        assert res[2]["peers"] == ["pod-b"]
        ms_restore.assert_bit_identical(res[0], state)
        ck.close()
    finally:
        teardown(pods)


def test_restore_checksum_rejection_falls_back(memkv, tmp_path):
    pods = serve_pods(memkv, ["pod-a", "pod-b"])
    try:
        state = tiny_state()
        ck = _tee_save(memkv, tmp_path, state)
        wait_for(lambda: "pod-a" in pods["pod-b"][0].cache_manifest(), "no replica")
        for svc, _srv, _reg in pods.values():       # every copy of one shard
            sset = svc._sets["pod-a"]
            for key in list(sset.shards):
                if key.startswith("model/w@"):
                    sset.shards[key] = b"\x00" * len(sset.shards[key])
        assert ms_restore.try_restore(memkv, JOB, fresh_target(), expect_step=7) is None
        stored, _ = ck.restore(fresh_target(), step=7)
        ms_restore.assert_bit_identical(stored, state)
        ck.close()
    finally:
        teardown(pods)


def test_restore_refuses_stale_and_missing_record(memkv, tmp_path):
    pods = serve_pods(memkv, ["pod-a"])
    try:
        assert ms_restore.try_restore(memkv, JOB, fresh_target(), expect_step=1) is None
        ck = _tee_save(memkv, tmp_path, tiny_state())
        assert ms_restore.try_restore(memkv, JOB, fresh_target(), expect_step=9) is None
        ck.close()
    finally:
        teardown(pods)


def test_restore_from_the_local_source_moves_no_bytes(memkv, tmp_path):
    pods = serve_pods(memkv, ["pod-a"])
    try:
        state = tiny_state()
        ck = _tee_save(memkv, tmp_path, state)
        local = shards.local_source(state)
        got, _meta, info = ms_restore.try_restore(memkv, JOB, fresh_target(), expect_step=7,
                                                  local=local, prefer_pod="pod-a")
        assert info["wire_bytes"] == 0 and info["local_bytes"] == info["bytes"] > 0
        ms_restore.assert_bit_identical(got, state)
        ck.close()
    finally:
        teardown(pods)


# -- store records read across the packages ----------------------------------------------
def test_adverts_and_committed_record_read_by_the_jax_package(memkv):
    reg = advert.advertise(memkv, JOB, "pod-t", "10.0.0.1:7", ttl=30)
    jreg = jax_advert.advertise(memkv, JOB, "pod-j", "10.0.0.2:8", ttl=30)
    try:
        assert jax_advert.list_adverts(memkv, JOB) == advert.list_adverts(memkv, JOB) == {
            "pod-t": "10.0.0.1:7", "pod-j": "10.0.0.2:8"}
        advert.write_committed_step(memkv, JOB, 12)
        assert jax_advert.read_committed_step(memkv, JOB) == 12
        jax_advert.write_committed_step(memkv, JOB, 13)
        assert advert.read_committed_step(memkv, JOB) == 13
    finally:
        reg.stop()
        jreg.stop()


@pytest.mark.parametrize("sources,want", [(["peer"], "peer"), (["peer", "storage"], "storage"),
                                          (["delta", "peer"], "delta")])
def test_trainer_half_records_restore_source(memkv, sources, want):
    from edl_tpu.cluster.recovery import summarize_recovery, write_launcher_half
    from edl_tpu_torch.cluster.recovery import write_trainer_half

    write_launcher_half(memkv, "j", "stg", "p0", {"detect": 10.0, "barrier": 12.0,
                                                  "reshard_done": 13.0})
    for i, src in enumerate(sources):
        write_trainer_half(memkv, "j", "stg", f"p{i}", restored=15.0, first_step=16.0 + i,
                           restore_source=src)
    [entry] = summarize_recovery(memkv, "j")
    assert entry["restore_source"] == want


# -- the trainer's cache-first restore ------------------------------------------------------
FLAGS = ["--device", "cpu", "--vocab", "64", "--layers", "1", "--embed", "32", "--heads", "2",
         "--mlp", "64", "--seq_len", "16", "--batch_size", "2", "--steps_per_epoch", "3"]


def _data_fn(args):
    def data_fn(epoch):
        gen = train_lm.markov_corpus(args, epoch)
        for _ in range(args.steps_per_epoch):
            yield next(gen)
    return data_fn


@pytest.mark.parametrize("memstate_on", [True, False])
def test_trainer_restores_cache_first(memkv, tmp_path, monkeypatch, memstate_on):
    """An epoch's save is teed and sealed; a new trainer restores it from
    the cache (``peer``), bit-identical to storage, and writes that source
    into its recovery half; with ``EDL_TPU_MEMSTATE=0`` it reads storage."""
    from edl_tpu.cluster.recovery import load_recovery_records

    monkeypatch.setenv("EDL_TPU_MEMSTATE", "1" if memstate_on else "0")
    monkeypatch.setenv("EDL_TPU_MEMSTATE_VERIFY", "1")
    pods = serve_pods(memkv, ["pod-a"])
    tenv = TrainerEnv({"EDL_TPU_JOB_ID": JOB, "EDL_TPU_POD_ID": "pod-a",
                       "EDL_TPU_CLUSTER_STAGE": "s1"})
    args = train_lm.parse_args(FLAGS)
    try:
        _, tr, init_fn, tx = train_lm.build_trainer(args, torch.device("cpu"),
                                                    str(tmp_path / "ck"), memkv, tenv)
        state, meta = tr.restore_or_create(init_fn, tx)
        state, meta = tr.fit(state, meta, _data_fn(args), epochs=1)
        _, tr2, init_fn, tx = train_lm.build_trainer(args, torch.device("cpu"),
                                                     str(tmp_path / "ck"), memkv, tenv)
        got, meta2 = tr2.restore_or_create(init_fn, tx)
        want = "peer" if memstate_on else "storage"
        assert [r["source"] for r in tr2.restores] == [want] and meta2.next_epoch == 1
        ms_restore.assert_bit_identical(got, state)
        tr2.fit(got, meta2, _data_fn(args), epochs=2)
        half = load_recovery_records(memkv, JOB)["s1"]["trainer"]["pod-a"]
        assert half["restore_source"] == want
    finally:
        teardown(pods)


def test_tee_failure_costs_only_the_cache(tmp_path, memkv):
    """No advert for the own pod: the push fails on the worker, the save
    still commits to storage and no step is recorded as cached."""
    tee = StateCacheTee(memkv, JOB, "pod-x")
    ck = CheckpointManager(str(tmp_path / "ck"), tee=tee)
    assert ck.save(3, tiny_state(), State())
    ck.wait()
    assert ck.latest_step() == 3 and advert.read_committed_step(memkv, JOB) is None
    assert tee.stats["sets"] == 0
    ck.close()
    with pytest.raises(EdlInternalError):
        StateCacheService(memkv, JOB, "pod-x").cache_commit("pod-x", 1, {"k": _entry(b"z")})
