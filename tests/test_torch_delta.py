"""The port's delta replication plane (``edl_tpu_torch/memstate/delta.py``)
against the JAX package's (``tests/test_delta.py``'s twin): the chain
format and the freshest-cut planner give the JAX package's answers on the
same inputs, both packages' services seal, refuse and compact records
alike, the port's replicator streams records the JAX package's service
accepts and the port restores from them, bit-equal to the state at that
step, a torn chain demotes the restore, and the recovery record says
``delta``."""

import copy
import functools
import zlib

import pytest
import torch

from edl_tpu.memstate import delta as jax_delta
from edl_tpu_torch.cluster.state import State
from edl_tpu_torch.memstate import advert, delta
from edl_tpu_torch.memstate import restore as ms_restore
from edl_tpu_torch.memstate.tee import StateCacheTee
from edl_tpu_torch.rpc import chunks
from edl_tpu_torch.rpc.client import RpcClient
from edl_tpu_torch.train.checkpoint import CheckpointManager
from tests.helpers.torch_cache import (JOB, advance, fresh_target, serve_pods, teardown,
                                       tiny_state, wait_for)


def _mk_manifest(payload: dict[str, bytes]) -> dict:
    return {k: {"crc": zlib.crc32(v), "nbytes": len(v), "dtype": "uint8", "shape": [len(v)],
                "index": [[0, len(v)]], "gshape": [len(v)], "leaf": k}
            for k, v in payload.items()}


def _mk_chain(base_step, steps, payloads=None, nproc=1):
    prev, out = delta.anchor_hash(base_step), []
    for i, step in enumerate(steps):
        man = _mk_manifest(payloads[i] if payloads else {"k": b"x" * (i + 1)})
        h = delta.chain_hash(prev, step, i + 1, man)
        out.append({"step": step, "seq": i + 1, "prev": prev, "hash": h, "shards": man,
                    "nproc": nproc, "has_meta": True})
        prev = h
    return out


def _listing(chains: dict) -> dict:
    return {f"{o}/{s}": {"owner": o, "src": s, "base_step": b, "records": r}
            for (o, s), (b, r) in chains.items()}


# -- the chain format and the planner against the JAX package's -------------------
@pytest.mark.parametrize("owner,src,seq", [("pod:a", "3", 7), ("pod-a", "0", 1)])
def test_wire_owner_roundtrip_equals_jax(owner, src, seq):
    w = delta.wire_owner(owner, src, seq)
    assert w == jax_delta.wire_owner(owner, src, seq)
    assert delta.parse_wire_owner(w) == jax_delta.parse_wire_owner(w) == (owner, src, seq)
    assert delta.parse_wire_owner("pod-a") is None and delta.parse_wire_owner("~delta:junk") is None


@pytest.mark.parametrize("payload,base,step,seq", [({"k": b"abc"}, 5, 10, 1),
                                                   ({"k": b"abd", "j": b""}, 6, 10, 2),
                                                   ({}, 0, 1, 1)])
def test_chain_and_anchor_hash_equal_jax(payload, base, step, seq):
    man = _mk_manifest(payload)
    assert delta.anchor_hash(base) == jax_delta.anchor_hash(base)
    h = delta.chain_hash(delta.anchor_hash(base), step, seq, man)
    assert h == jax_delta.chain_hash(jax_delta.anchor_hash(base), step, seq, man)
    assert h != delta.chain_hash(delta.anchor_hash(base + 1), step, seq, man)


def _torn_cases():
    recs = _mk_chain(7, [10, 20, 30])
    torn = [dict(r) for r in recs]
    torn[1] = dict(torn[1], shards=_mk_manifest({"k": b"evil"}))
    return [(7, recs), (7, torn), (7, [recs[0], recs[2]]), (8, recs), (7, [])]


@pytest.mark.parametrize("base,records", _torn_cases())
def test_intact_prefix_equals_jax(base, records):
    got = delta.intact_prefix(base, records)
    assert got == jax_delta.intact_prefix(base, records)


def _plan_cases():
    a, b = _mk_chain(7, [10, 20, 30]), _mk_chain(7, [10, 20])
    a2, b2 = _mk_chain(7, [10, 20, 30], nproc=2), _mk_chain(7, [10, 20], nproc=2)
    recs = _mk_chain(7, [10, 20, 30])
    torn = [recs[0], dict(recs[1], hash="0" * 40), recs[2]]
    over = _mk_chain(7, [10, 20], payloads=[{"k1": b"v1-old", "k2": b"v2"}, {"k1": b"v1-new"}])
    two = {"pa": _listing({("pa", "0"): (7, a)}), "pb": _listing({("pb", "0"): (7, b)})}
    two2 = {"pa": _listing({("pa", "0"): (7, a2)}), "pb": _listing({("pb", "0"): (7, b2)})}
    one = {"pa": _listing({("pa", "0"): (7, recs)})}
    return [(7, two, None), (7, two2, None), (7, one, None), (7, one, 20), (8, one, None),
            (7, {"pa": _listing({("pa", "0"): (7, torn)})}, None),
            (7, {"pa": _listing({("pa", "0"): (7, over)})}, None),
            (7, {"pa": _listing({("pa", "0"): (7, recs)}),
                 "pb": _listing({("pa", "0"): (7, recs[:2])})}, None)]


@pytest.mark.parametrize("committed,listings,max_step", _plan_cases())
def test_plan_freshest_equals_jax(committed, listings, max_step):
    got = delta.plan_freshest(committed, listings, max_step=max_step)
    want = jax_delta.plan_freshest(committed, listings, max_step=max_step)
    assert got == want


def test_plan_freshest_cut_and_overlay():
    plan = delta.plan_freshest(7, _plan_cases()[1][1])
    assert plan["step"] == 20 and plan["meta"]
    plan = delta.plan_freshest(7, _plan_cases()[6][1])
    assert plan["overlay"]["k1"][1][0][2] == delta.wire_owner("pa", "0", 2)
    assert plan["overlay"]["k2"][1][0][2] == delta.wire_owner("pa", "0", 1)


# -- service-side commit verification, both packages' services ---------------------
@pytest.fixture(params=["port", "jax"])
def pod(request, memkv):
    pods = serve_pods(memkv, ["pod-a"], jax_service=request.param == "jax")
    client = RpcClient(f"127.0.0.1:{pods['pod-a'][1].port}")
    yield pods["pod-a"][0], client
    client.close()
    teardown(pods)


def _stage_record(client, owner, src, base, rec, payload):
    wire = delta.wire_owner(owner, src, rec["seq"])
    for key, data in payload.items():
        chunks.push_bytes(functools.partial(client.call, "cache_put_chunk", owner=wire,
                                            step=rec["step"], key=key), data)
    return client.call("cache_delta_commit", owner=owner, src=src, base_step=base,
                       step=rec["step"], seq=rec["seq"], prev_hash=rec["prev"],
                       chain_hash=rec["hash"], manifest=rec["shards"], nproc=1, meta=b"{}")


def test_delta_commit_links_rejects_and_dedups(pod):
    _svc, client = pod
    pays = [{"k": b"x"}, {"k": b"xy"}, {"k": b"xyz"}]
    recs = _mk_chain(7, [10, 20, 30], payloads=pays)
    assert _stage_record(client, "pod-a", "0", 7, recs[0], pays[0])["ok"]
    r = _stage_record(client, "pod-a", "0", 7, recs[2], pays[2])
    assert not r["ok"] and r["reason"] == "link"
    assert _stage_record(client, "pod-a", "0", 7, recs[1], pays[1])["ok"]
    r = _stage_record(client, "pod-a", "0", 7, recs[1], pays[1])
    assert r["ok"] and r.get("dup")
    r = _stage_record(client, "pod-a", "0", 7, dict(recs[2], hash="0" * 40), pays[2])
    assert not r["ok"] and r["reason"] == "hash"
    old = _mk_chain(5, [6], payloads=[{"k": b"z"}])[0]
    r = _stage_record(client, "pod-a", "0", 5, old, {"k": b"z"})
    assert not r["ok"] and r["reason"] == "stale"
    listing = client.call("cache_delta_manifest")
    assert [x["seq"] for x in listing["pod-a/0"]["records"]] == [1, 2]
    assert len(delta.intact_prefix(7, listing["pod-a/0"]["records"])) == 2
    assert client.call("cache_meta", owner=delta.wire_owner("pod-a", "0", 2)) == b"{}"


def test_delta_commit_payload_crc_verified(pod):
    _svc, client = pod
    rec = _mk_chain(7, [10], payloads=[{"k": b"good"}])[0]
    with pytest.raises(Exception, match="CRC"):
        _stage_record(client, "pod-a", "0", 7, rec, {"k": b"evil"})
    assert client.call("cache_delta_manifest") == {}


def test_delta_chain_cap_enforced(pod, monkeypatch):
    from edl_tpu.utils import constants as jax_constants
    monkeypatch.setenv("EDL_TPU_DELTA_MAX_CHAIN", "2")
    monkeypatch.setattr(jax_constants, "DELTA_MAX_CHAIN", 2)
    _svc, client = pod
    pays = [{"k": bytes([i])} for i in range(3)]
    recs = _mk_chain(7, [10, 20, 30], payloads=pays)
    for i in range(2):
        assert _stage_record(client, "pod-a", "0", 7, recs[i], pays[i])["ok"]
    r = _stage_record(client, "pod-a", "0", 7, recs[2], pays[2])
    assert not r["ok"] and r["reason"] == "full"


def test_checkpoint_commit_compacts_older_base_chains(pod):
    _svc, client = pod
    pay = {"k": b"v"}
    assert _stage_record(client, "pod-a", "0", 7, _mk_chain(7, [10], [pay])[0], pay)["ok"]
    data = b"d" * 64
    chunks.push_bytes(functools.partial(client.call, "cache_put_chunk", owner="pod-a",
                                        step=10, key="s"), data)
    assert client.call("cache_commit", owner="pod-a", step=10,
                       manifest=_mk_manifest({"s": data}), meta=b"{}")["ok"]
    assert client.call("cache_delta_manifest") == {}
    r = _stage_record(client, "pod-a", "0", 7, _mk_chain(7, [20], [pay])[0], pay)
    assert not r["ok"] and r["reason"] == "stale"


# -- end to end: the replicator -> a service -> the restore -------------------------------
def _commit_base(store, tmp_path, state, step):
    ck = CheckpointManager(str(tmp_path / "ck"), tee=StateCacheTee(store, JOB, "pod-a"))
    assert ck.save(step, state, State(total_batch_size=8))
    ck.wait()
    wait_for(lambda: advert.read_committed_step(store, JOB) == step, "the base never sealed")
    return ck


@pytest.mark.parametrize("jax_service", [False, True])
def test_delta_restore_beats_committed_base(memkv, tmp_path, jax_service):
    """The port's records, sealed by either package's services (own pod and
    ring replica), restore the state at the freshest step bit for bit."""
    pods = serve_pods(memkv, ["pod-a", "pod-b"], jax_service=jax_service)
    rep = None
    try:
        state = tiny_state(steps=2)
        ck = _commit_base(memkv, tmp_path, state, 2)
        rep = delta.DeltaReplicator(memkv, JOB, "pod-a", every=2)
        rep.rebase(2, state)
        for step in (4, 6):
            advance(state, 2)
            assert rep.want(step) and state.step == step
            meta = State(total_batch_size=8)
            meta.step = step
            rep.stage(step, state, meta)
            assert rep.flush()
        assert rep.stats["records"] == 2 and rep.stats["failed"] == 0
        for svc, _srv, _reg in pods.values():
            chains = svc.cache_delta_manifest()
            assert [r["step"] for r in chains["pod-a/0"]["records"]] == [4, 6]
        assert delta.probe_freshest(memkv, JOB) == (2, 6)
        assert jax_delta.probe_freshest(memkv, JOB) == (2, 6)
        got, meta_json, info = ms_restore.try_restore(memkv, JOB, fresh_target(),
                                                      expect_step=2, delta_step=6)
        assert info["step"] == 6 and State().from_json(meta_json).step == 6
        ms_restore.assert_bit_identical(got, state)
        # a step the chains cannot reach exactly is a miss, never another step
        assert ms_restore.try_restore(memkv, JOB, fresh_target(), expect_step=2,
                                      delta_step=5) is None
        ck.close()
    finally:
        if rep is not None:
            rep.close()
        teardown(pods)


def test_replicator_diffs_only_changed_shards(memkv, tmp_path):
    pods = serve_pods(memkv, ["pod-a"])
    rep = delta.DeltaReplicator(memkv, JOB, "pod-a", every=1)
    try:
        state = tiny_state()
        ck = _commit_base(memkv, tmp_path, state, 2)
        rep.rebase(2, state)
        with torch.no_grad():
            state.model.w[0, 0] += 1.0        # only w changes
        state.step = 3
        rep.stage(3, state, State())
        assert rep.flush()
        [rec] = pods["pod-a"][0].cache_delta_manifest()["pod-a/0"]["records"]
        assert {e["leaf"] for e in rec["shards"].values()} == {"model/w", "__struct__"}
        ck.close()
    finally:
        rep.close()
        teardown(pods)


def test_torn_chain_demotes_to_the_base_then_storage(memkv, tmp_path):
    pods = serve_pods(memkv, ["pod-a"])
    rep = delta.DeltaReplicator(memkv, JOB, "pod-a", every=2)
    try:
        base = tiny_state(steps=2)
        ck = _commit_base(memkv, tmp_path, base, 2)
        committed = fresh_target()
        committed.load_state_dict(copy.deepcopy(base.state_dict()))
        rep.rebase(2, base)
        advance(base, 2)
        rep.stage(4, base, State())
        assert rep.flush()
        svc = pods["pod-a"][0]
        svc._chains["pod-a/0"].records[0].hash = "0" * 40     # tear it
        assert delta.probe_freshest(memkv, JOB) == (2, None)
        assert ms_restore.try_restore(memkv, JOB, fresh_target(), expect_step=2,
                                      delta_step=4) is None
        got, _meta, info = ms_restore.try_restore(memkv, JOB, fresh_target(), expect_step=2)
        assert info["step"] == 2
        ms_restore.assert_bit_identical(got, committed)
        ck.close()
    finally:
        rep.close()
        teardown(pods)


def test_replicator_cap_saturates_staging(memkv):
    rep = delta.DeltaReplicator(memkv, JOB, "pod-a", every=1, max_chain=2)
    try:
        state = tiny_state()
        rep.rebase(2, state)
        assert [rep.want(s) for s in (2, 3)] == [False, True]
        rep.stage(3, state)
        rep.stage(4, state)
        assert not rep.want(5)                 # capped until the next rebase
        rep.rebase(5, state)
        assert rep.want(6)
    finally:
        rep.close()


def test_recovery_record_restore_source_delta(memkv):
    from edl_tpu.cluster.recovery import summarize_recovery, write_launcher_half
    from edl_tpu_torch.cluster.recovery import write_trainer_half

    write_launcher_half(memkv, "j", "stg", "p1", {"detect": 10.0, "flagged": 10.1,
                                                  "barrier": 11.0, "reshard_done": 12.0,
                                                  "resize_mode": "delta"})
    write_trainer_half(memkv, "j", "stg", "p1", restored=10.0, first_step=12.5,
                       restore_source="delta")
    [entry] = summarize_recovery(memkv, "j")
    assert entry["restore_source"] == "delta" and entry["resize_mode"] == "delta"
