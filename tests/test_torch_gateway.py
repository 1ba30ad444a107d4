"""The port's serving fleet (``edl_tpu_torch/gateway``,
``serving/replica.py``) and its shared lease (``coord/session.py``) on the
CPU, mirroring ``tests/test_gateway.py`` against port replicas over the
port's ``MemoryKV`` (the JAX replica's metric gauges become the advert and
``serve_stats`` payloads, and the gateway's metrics its ``stats()``
counters), and the ``CoordSession`` cases of
``tests/test_coord_resilience.py``.  Failure paths use the real replica
wire and advert around a fake engine with controllable latency; the
kill-under-load and migration cases run real port engines.  Across
packages: the JAX ``Gateway`` routes to a port replica and the port's to a
JAX replica, over the JAX coordination server; the ``slow`` twin of
``tests/test_serving_failover_e2e.py`` runs two replica processes behind
the port's gateway and SIGKILLs one."""

import functools
import os
import subprocess
import sys
import threading
import time
from concurrent.futures import Future
from pathlib import Path

import numpy as np
import pytest
import torch

from edl_tpu_torch.coord.memory import MemoryKV
from edl_tpu_torch.coord.register import Register
from edl_tpu_torch.coord.session import CoordSession, leased_register
from edl_tpu_torch.gateway import Gateway, GatewayConfig, GatewayServer, fleet
from edl_tpu_torch.gateway.gateway import _TokenBucket
from edl_tpu_torch.models.generate import generate
from edl_tpu_torch.models.transformer import TransformerConfig, TransformerLM
from edl_tpu_torch.rpc import chunks
from edl_tpu_torch.rpc.client import RpcClient
from edl_tpu_torch.serving import ContinuousBatcher, ReplicaServer
from edl_tpu_torch.utils.exceptions import (EdlCoordError, EdlOverloadedError,
                                            EdlRegisterError, EdlUnavailableError)

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(vocab_size=53, num_layers=1, embed_dim=32, num_heads=2, mlp_dim=64, max_len=64)


@pytest.fixture
def kv():
    store = MemoryKV(sweep_period=0.1)
    yield store
    store.close()


class _FakeEngine:
    """ContinuousBatcher stand-in: resolves ``np.arange(max_new) +
    prompt[0]`` after ``delay`` seconds (only what ReplicaServer touches)."""

    def __init__(self, delay: float = 0.0, slots: int = 4, free_slots: int | None = None,
                 queue_depth: int = 0):
        self.delay = delay
        self.slots = slots
        self._free = slots if free_slots is None else free_slots
        self._queue_depth = queue_depth
        self.served: list[list[int]] = []
        self._pending: list[Future] = []
        self._lock = threading.Lock()
        self._stopped = False

    def submit(self, ids, max_new: int, session: str | None = None) -> Future:
        del session
        with self._lock:
            if self._stopped:
                raise RuntimeError("engine stopping")
            fut: Future = Future()
            self._pending.append(fut)
        self.served.append([int(x) for x in ids])

        def run():
            time.sleep(self.delay)
            if not fut.done():
                fut.set_result(np.arange(max_new, dtype=np.int32) + int(ids[0]))

        threading.Thread(target=run, daemon=True).start()
        return fut

    def stats(self) -> dict:
        return {"slots": self.slots, "active_slots": self.slots - self._free,
                "queue_depth": self._queue_depth, "prefill_stall_s": 0.0,
                "tokens_per_s": 0.0, "max_prompt_len": 63, "draining": False}

    def kill(self) -> None:
        with self._lock:
            self._stopped = True
            pending, self._pending = self._pending, []
        for fut in pending:
            if not fut.done():
                fut.set_exception(RuntimeError("engine stopped mid-generation"))

    def drain(self, timeout=None) -> bool:
        deadline = time.monotonic() + (timeout or 60.0)
        while any(not f.done() for f in self._pending):
            if time.monotonic() > deadline:
                return False
            time.sleep(0.01)
        self._stopped = True
        return True

    def stop(self) -> None:
        self.kill()


def _fake_replica(store, rid, *, delay=0.0, free_slots=None, queue_depth=0, ttl=5.0,
                  advert_period=0.2, server_cls=ReplicaServer):
    eng = _FakeEngine(delay=delay, free_slots=free_slots, queue_depth=queue_depth)
    srv = server_cls(store, "job", eng, replica_id=rid, host="127.0.0.1", ttl=ttl,
                     advert_period=advert_period)
    return eng, srv


def _gateway(store, gateway_cls=Gateway, config_cls=GatewayConfig, **kw):
    kw.setdefault("max_inflight", 8)
    kw.setdefault("max_queue", 8)
    kw.setdefault("request_timeout_s", 60.0)
    kw.setdefault("wait_slice_s", 0.05)
    kw.setdefault("poll_period_s", 0.05)
    kw.setdefault("quarantine_s", 30.0)
    return gateway_cls(store, "job", config_cls(**kw))


def _expected(prompt, max_new):
    return np.arange(max_new, dtype=np.int32) + int(prompt[0])


def _until(cond, timeout=10.0, what="condition"):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"{what} never held"
        time.sleep(0.02)


@functools.cache
def _tiny_lm() -> TransformerLM:
    cfg = TransformerConfig(dtype=torch.float32, remat=False, **TINY)
    return TransformerLM(cfg, torch.Generator().manual_seed(0)).requires_grad_(False).eval()


def _want(p, n):
    return generate(_tiny_lm(), torch.from_numpy(np.asarray(p, np.int32)[None]), n,
                    temperature=0).numpy()[0]


# -- fleet ------------------------------------------------------------------
def test_fleet_advert_roundtrip_and_ttl_expiry(kv):
    reg = fleet.advertise(kv, "job", "r0", {"endpoint": "1.2.3.4:5", "free_slots": 3},
                          ttl=0.4)
    try:
        assert fleet.list_replicas(kv, "job")["r0"]["endpoint"] == "1.2.3.4:5"
        assert kv.get("/edl_tpu/job/serving/nodes/r0") is not None   # the JAX key path
        reg.stop_heartbeat_only()
        _until(lambda: "r0" not in fleet.list_replicas(kv, "job"), what="advert expiry")
    finally:
        reg.stop()


def test_fleet_view_tracks_membership(kv):
    view = fleet.FleetView(kv, "job", period=0.05)
    regs = [fleet.advertise(kv, "job", f"r{i}", {"endpoint": f"h:{i}"}, ttl=5)
            for i in range(3)]
    try:
        assert view.wait_for(3, timeout=10)
        assert view.ring.get_node("sess") in {"r0", "r1", "r2"}
        regs[1].stop()
        _until(lambda: "r1" not in view.replicas())
        assert "r1" not in view.ring.nodes
    finally:
        view.stop()
        for r in regs:
            r.stop()


# -- admission --------------------------------------------------------------
def test_token_bucket_grants_then_backpressures():
    tb = _TokenBucket(rate=10.0, burst=2)
    assert tb.take() == 0.0
    assert tb.take() == 0.0
    ra = tb.take()
    assert 0.0 < ra <= 0.11
    time.sleep(ra + 0.01)
    assert tb.take() == 0.0


def test_admission_rejects_when_queue_full(kv):
    eng, srv = _fake_replica(kv, "r0", delay=0.5)
    gw = _gateway(kv, max_inflight=1, max_queue=0)
    try:
        assert gw.wait_for_replicas(1, 10)
        fut = gw.submit([7], 4)
        with pytest.raises(EdlOverloadedError) as ei:
            gw.submit([8], 4)
        assert ei.value.retry_after > 0
        np.testing.assert_array_equal(fut.result(timeout=30), _expected([7], 4))
        np.testing.assert_array_equal(gw.submit([9], 4).result(timeout=30), _expected([9], 4))
        assert gw.stats()["counts"]["rejects_queue_full"] == 1
    finally:
        gw.close()
        srv.close()


def test_admission_rate_limit_rejects_with_retry_after(kv):
    eng, srv = _fake_replica(kv, "r0")
    gw = _gateway(kv, rate=1.0, burst=1.0)
    try:
        assert gw.wait_for_replicas(1, 10)
        gw.submit([3], 2).result(timeout=30)
        with pytest.raises(EdlOverloadedError) as ei:
            gw.submit([4], 2)
        assert 0.0 < ei.value.retry_after <= 1.1
        assert gw.stats()["counts"]["rejects_rate"] == 1
    finally:
        gw.close()
        srv.close()


def test_overloaded_error_crosses_the_wire_with_retry_after(kv):
    """A saturated GatewayServer rejects over the wire under the JAX error
    name, and the client rebuilds ``retry_after`` from the detail."""
    from edl_tpu.utils.exceptions import EdlOverloadedError as JaxOverloaded
    from edl_tpu_torch.utils import exceptions

    wire = exceptions.serialize(EdlOverloadedError("full; retry_after=2.5", retry_after=2.5))
    assert wire["type"] == JaxOverloaded.__name__
    with pytest.raises(EdlOverloadedError) as ei:
        exceptions.deserialize(wire)
    assert ei.value.retry_after == 2.5
    eng, srv = _fake_replica(kv, "r0", delay=1.0)
    gws = GatewayServer(kv, "job", GatewayConfig(max_inflight=1, max_queue=0, wait_slice_s=0.05,
                                                 poll_period_s=0.05), host="127.0.0.1")
    try:
        assert gws.gateway.wait_for_replicas(1, 10)
        fut = gws.gateway.submit([1], 2)
        with RpcClient(gws.endpoint) as client, pytest.raises(EdlOverloadedError) as ei:
            client.call("gate_generate", prompt=[2], max_new=2)
        assert ei.value.retry_after == 1.0
        fut.result(timeout=30)
    finally:
        gws.stop()
        srv.close()


def test_no_replicas_request_fails_at_deadline(kv):
    gw = _gateway(kv, request_timeout_s=0.4)
    try:
        fut = gw.submit([1], 2)     # admitted: fleet gaps don't reject
        with pytest.raises(TimeoutError):
            fut.result(timeout=30)
        assert gw.stats()["counts"]["requests_error"] == 1
    finally:
        gw.close()


# -- routing ----------------------------------------------------------------
def test_least_loaded_routing_prefers_free_replica(kv):
    eng_a, srv_a = _fake_replica(kv, "ra", free_slots=0, queue_depth=6)
    eng_b, srv_b = _fake_replica(kv, "rb", free_slots=4)
    gw = _gateway(kv)
    try:
        assert gw.wait_for_replicas(2, 10)
        picked = gw._pick(None, set())
        assert picked is not None and picked[0] == "rb"
        for i in range(4):
            gw.submit([10 + i], 3).result(timeout=30)
        assert len(eng_b.served) == 4 and not eng_a.served
    finally:
        gw.close()
        srv_a.close()
        srv_b.close()


def test_routing_weighs_kv_warmth_among_comparable_replicas(kv):
    base = {"endpoint": "127.0.0.1:1", "free_slots": 4, "queue_depth": 0}
    regs = [fleet.advertise(kv, "job", "cold", dict(base, kv_block=8, kv_prefix_hit_rate=0.1,
                                                    kv_blocks_free=10), ttl=30),
            fleet.advertise(kv, "job", "warm", dict(base, kv_block=8, kv_prefix_hit_rate=0.9,
                                                    kv_blocks_free=2), ttl=30)]
    gw = _gateway(kv)
    try:
        gw._fleet.refresh()
        assert gw._pick(None, set())[0] == "warm"
        regs.append(fleet.advertise(kv, "job", "roomy", dict(
            base, kv_block=8, kv_prefix_hit_rate=0.9, kv_blocks_free=64), ttl=30))
        gw._fleet.refresh()
        assert gw._pick(None, set())[0] == "roomy"
        regs.append(fleet.advertise(kv, "job", "idle", dict(base, free_slots=8), ttl=30))
        gw._fleet.refresh()
        assert gw._pick(None, set())[0] == "idle"
        assert gw._pick(None, {"idle", "warm", "roomy"})[0] == "cold"
    finally:
        gw.close()
        for r in regs:
            r.stop()


def test_session_affinity_sticks_to_ring_owner(kv):
    engines, servers = {}, []
    for rid in ("ra", "rb", "rc"):
        eng, srv = _fake_replica(kv, rid)
        engines[rid] = eng
        servers.append(srv)
    gw = _gateway(kv)
    try:
        assert gw.wait_for_replicas(3, 10)
        owner = gw._fleet.ring.get_node("user-42")
        for i in range(5):
            gw.submit([20 + i], 2, session="user-42").result(timeout=30)
        assert len(engines[owner].served) == 5
        assert sum(len(e.served) for e in engines.values()) == 5
    finally:
        gw.close()
        for s in servers:
            s.close()


def test_draining_replica_excluded_from_routing(kv):
    eng_a, srv_a = _fake_replica(kv, "ra", free_slots=4)
    eng_b, srv_b = _fake_replica(kv, "rb", free_slots=1)
    gw = _gateway(kv)
    try:
        assert gw.wait_for_replicas(2, 10)
        srv_a.serve_drain()
        _until(lambda: fleet.list_replicas(kv, "job").get("ra", {"draining": True})["draining"])
        gw._fleet.refresh()
        gw.submit([5], 2).result(timeout=30)
        assert len(eng_b.served) == 1 and not eng_a.served
    finally:
        gw.close()
        srv_a.close()
        srv_b.close()


# -- failure paths ----------------------------------------------------------
def test_failover_replica_death_mid_request(kv):
    eng_a, srv_a = _fake_replica(kv, "ra", delay=30.0, free_slots=4)
    eng_b, srv_b = _fake_replica(kv, "rb", delay=0.05, free_slots=1)
    gw = _gateway(kv)
    try:
        assert gw.wait_for_replicas(2, 10)
        fut = gw.submit([7], 5)      # lands on ra (freest), stuck 30 s
        _until(lambda: eng_a.served, what="the request reaching ra")
        eng_a.kill()                  # the in-flight future fails
        np.testing.assert_array_equal(fut.result(timeout=30), _expected([7], 5))
        assert eng_b.served == [[7]]
        stats = gw.stats()
        assert stats["counts"]["retries"] == 1 and "ra" in stats["quarantined"]
    finally:
        gw.close()
        srv_a.close()
        srv_b.close()


def test_lease_expiry_mid_assignment_completes_then_reroutes(kv):
    eng_a, srv_a = _fake_replica(kv, "ra", delay=1.0, free_slots=4, ttl=0.5,
                                 advert_period=10.0)
    eng_b, srv_b = _fake_replica(kv, "rb", delay=0.0, free_slots=1)
    gw = _gateway(kv)
    try:
        assert gw.wait_for_replicas(2, 10)
        fut = gw.submit([11], 3)
        _until(lambda: eng_a.served)
        srv_a._register.stop_heartbeat_only()   # the lease expires mid-flight
        _until(lambda: "ra" not in gw._fleet.replicas(), what="advert expiry")
        np.testing.assert_array_equal(fut.result(timeout=30), _expected([11], 3))
        gw.submit([12], 3).result(timeout=30)
        assert eng_b.served == [[12]]
    finally:
        gw.close()
        srv_a.close()
        srv_b.close()


def test_hedge_fires_and_loser_is_released(kv):
    eng_a, srv_a = _fake_replica(kv, "ra", delay=5.0, free_slots=4)
    eng_b, srv_b = _fake_replica(kv, "rb", delay=0.05, free_slots=1)
    gw = _gateway(kv, hedge_after_s=0.3)
    try:
        assert gw.wait_for_replicas(2, 10)
        t0 = time.monotonic()
        out = gw.submit([9], 4).result(timeout=30)
        dt = time.monotonic() - t0
        np.testing.assert_array_equal(out, _expected([9], 4))
        assert eng_a.served == [[9]] and eng_b.served == [[9]]
        counts = gw.stats()["counts"]
        assert counts["hedges"] == 1 and counts["hedge_wins"] == 1
        assert dt < 4.0, f"hedge did not rescue the tail: {dt:.2f}s"
        _until(lambda: not srv_a.serve_stats()["tracked_requests"], what="loser release")
    finally:
        gw.close()
        srv_a.close()
        srv_b.close()


def _real_replica(store, rid, **kw):
    eng = ContinuousBatcher(_tiny_lm(), slots=2, temperature=0.0, prefill_buckets=(8, 16),
                            steps_per_sync=4, **kw)
    return ReplicaServer(store, "job", eng, replica_id=rid, host="127.0.0.1", ttl=5,
                         advert_period=0.2)


def test_zero_lost_when_replica_killed_under_load(kv):
    servers = [_real_replica(kv, rid) for rid in ("kill-me", "survivor")]
    gw = _gateway(kv, max_inflight=8, max_queue=16, request_timeout_s=120.0)
    try:
        assert gw.wait_for_replicas(2, 10)
        rng = np.random.default_rng(3)
        prompts = [rng.integers(1, 53, (n,)).astype(np.int32)
                   for n in (3, 7, 5, 9, 4, 6, 8, 3, 5, 7, 4, 6)]
        futs = [gw.submit(p, 10) for p in prompts]
        time.sleep(0.3)               # let some land on each replica
        victim = servers[0]
        victim._rpc.stop()            # the wire dies
        victim._engine.stop()         # in-flight futures fail
        victim._register.stop()       # the advert is gone
        for p, f in zip(prompts, futs):
            np.testing.assert_array_equal(f.result(timeout=120), _want(p, 10))
        assert gw.stats()["counts"]["requests_ok"] == len(prompts)
    finally:
        gw.close()
        for s in servers[1:]:
            s.close()


# -- replica server ---------------------------------------------------------
def test_replica_drain_finishes_inflight_then_refuses(kv):
    eng, srv = _fake_replica(kv, "r0", delay=0.3)
    fut = eng.submit([1], 2)          # in-flight work
    assert "r0" in fleet.list_replicas(kv, "job")
    assert srv.drain(timeout=30)
    fut.result(timeout=1)             # completed, not failed
    with pytest.raises(EdlUnavailableError):
        srv.serve_submit(request_id="x", prompt=[1], max_new=2)
    assert "r0" not in fleet.list_replicas(kv, "job")
    srv.close()


def test_replica_wire_chunked_fetch_roundtrip(kv):
    eng, srv = _fake_replica(kv, "r0")
    try:
        with RpcClient(srv.endpoint) as client:
            client.call("serve_submit", request_id="q1", prompt=[40], max_new=6)
            client.call("serve_submit", request_id="q1", prompt=[40], max_new=6)  # retry
            deadline = time.monotonic() + 10
            while True:
                r = client.call("serve_wait", request_id="q1", timeout=0.1)
                if r["done"]:
                    break
                assert time.monotonic() < deadline
            data = chunks.fetch_bytes(functools.partial(client.call, "serve_fetch",
                                                        request_id="q1"),
                                      r["nbytes"], chunk_bytes=8)   # several chunks
            np.testing.assert_array_equal(np.frombuffer(data, np.int32), _expected([40], 6))
            client.call("serve_release", request_id="q1")
            assert srv.serve_stats()["tracked_requests"] == 0
        assert eng.served == [[40]]
    finally:
        srv.close()


def test_replica_publishes_engine_stats_in_advert_and_serve_stats(kv):
    """What the JAX replica mirrors into gauges rides the advert (the
    gateway's view) and ``serve_stats``: free slots, queue depth, prefill
    stall, tokens/s, and for a paged engine the pool's warmth."""
    srv = _real_replica(kv, "r0", kv_block=4, kv_pool_blocks=32)
    try:
        with RpcClient(srv.endpoint) as client:
            p = np.asarray([5, 9, 2, 7, 1, 3], np.int32)
            client.call("serve_submit", request_id="a", prompt=p.tolist(), max_new=4)
            _until(lambda: client.call("serve_wait", request_id="a", timeout=0.1)["done"])
            client.call("serve_submit", request_id="b", prompt=p.tolist() + [8], max_new=4)
            _until(lambda: client.call("serve_wait", request_id="b", timeout=0.1)["done"])
            stats = client.call("serve_stats")
        eng = stats["engine"]
        assert eng["requests_done"] == 2 and eng["kv_prefix_hits"] == 1
        assert stats["migration"]["sessions_out"] == 0
        _until(lambda: fleet.list_replicas(kv, "job")["r0"].get("kv_prefix_hit_rate") == 0.5,
               what="the advert's refresh")
        advert = fleet.list_replicas(kv, "job")["r0"]
        assert advert["free_slots"] == 2 and advert["queue_depth"] == 0
        assert advert["kv_block"] == 4 and advert["kv_blocks_free"] == eng["kv_blocks_free"]
        assert {"prefill_stall_s", "tokens_per_s", "max_prompt_len", "ts"} <= set(advert)
    finally:
        srv.close()


def test_chunked_transfer_paths_over_a_channel_pool():
    """``rpc/chunks.py``: an ordered push with a window in flight, a
    windowed fetch, and a server-push stream, each reassembling the blob; a
    stream that ends short raises."""
    from edl_tpu_torch.rpc.client import RpcChannelPool
    from edl_tpu_torch.rpc.server import RpcServer, Streaming
    from edl_tpu_torch.utils.exceptions import EdlStreamError

    blob = np.random.default_rng(0).integers(0, 256, 1000, dtype=np.uint8).tobytes()
    got = {"buf": bytearray(), "seq": 0, "eof": False}

    def put(seq, data, eof):
        assert seq == got["seq"] and not got["eof"]
        got["seq"] += 1
        got["buf"].extend(data)
        got["eof"] = eof
        return {"ok": True}

    def stream(offset, length, chunk_bytes, short=False):
        end = offset + length - (10 if short else 0)
        return Streaming(blob[o:min(o + chunk_bytes, end)] for o in range(offset, end, chunk_bytes))

    srv = RpcServer("127.0.0.1", 0)
    srv.register("put", put)
    srv.register("fetch", lambda offset, length: blob[offset:offset + length])
    srv.register("stream", stream)
    srv.start()
    pool = RpcChannelPool(f"127.0.0.1:{srv.port}", size=2)
    try:
        assert chunks.push_bytes_pipelined(pool, "put", blob, chunk_bytes=64, window=4) == 16
        assert bytes(got["buf"]) == blob and got["eof"]
        assert chunks.fetch_bytes_pipelined(pool, "fetch", 1000, chunk_bytes=64, window=4) == blob
        assert chunks.fetch_bytes(functools.partial(pool.call, "fetch"), 1000, 96) == blob
        assert b"".join(chunks.iter_fetch_streaming(pool, "stream", 1000, chunk_bytes=64)) == blob
        with pytest.raises(EdlStreamError, match="short"):
            list(chunks.iter_fetch_streaming(pool, "stream", 1000, chunk_bytes=64, short=True))
    finally:
        pool.close()
        srv.stop()


# -- session KV migration on drain ------------------------------------------
def _session_owned_by(gw, rid):
    return next(s for s in (f"sess-{i}" for i in range(1000))
                if gw._fleet.ring.get_node(s) == rid)


def test_session_repin_lands_on_migration_target(kv):
    origin = _real_replica(kv, "origin", kv_block=4, kv_pool_blocks=64)
    target = _real_replica(kv, "target", kv_block=4, kv_pool_blocks=64)
    gw = _gateway(kv, request_timeout_s=120.0)
    try:
        assert gw.wait_for_replicas(2, 10)
        sess = _session_owned_by(gw, "origin")
        p1 = np.asarray([7, 11, 13, 5, 9, 2], np.int32)
        out1 = gw.generate(p1, 8, session=sess, timeout=120)
        np.testing.assert_array_equal(out1, _want(p1, 8))
        assert origin._engine.stats()["kv_sessions"] == 1
        assert origin.drain(timeout=30)
        assert fleet.list_session_pins(kv, "job") == {sess: "target"}
        migration = origin.serve_stats()["migration"]
        assert migration["sessions_out"] == 1 and migration["blocks_out"] == 3
        assert target.serve_stats()["migration"]["blocks_in"] == 3
        gw._fleet.refresh()
        assert gw._fleet.session_pin(sess) == "target"
        p2 = np.concatenate([p1, out1, np.asarray([3, 1], np.int32)])
        out2 = gw.generate(p2, 6, session=sess, timeout=120)
        np.testing.assert_array_equal(out2, _want(p2, 6))
        stats = target._engine.stats()
        assert stats["kv_prefix_hits"] >= 1 and stats["kv_prefill_tokens_skipped"] > 0, stats
    finally:
        gw.close()
        origin.close()
        target.close()


def test_migration_refused_falls_back_to_cold_prefill(kv):
    origin = _real_replica(kv, "origin", kv_block=4, kv_pool_blocks=64)
    target = _real_replica(kv, "target")
    gw = _gateway(kv, request_timeout_s=120.0)
    try:
        assert gw.wait_for_replicas(2, 10)
        sess = _session_owned_by(gw, "origin")
        p1 = np.asarray([4, 8, 15, 16, 23, 42], np.int32)
        out1 = gw.generate(p1, 8, session=sess, timeout=120)
        assert origin.drain(timeout=30)
        assert fleet.list_session_pins(kv, "job") == {}
        gw._fleet.refresh()
        p2 = np.concatenate([p1, out1, np.asarray([6], np.int32)])
        np.testing.assert_array_equal(gw.generate(p2, 6, session=sess, timeout=120),
                                      _want(p2, 6))
    finally:
        gw.close()
        origin.close()
        target.close()


def test_gateway_server_wire_roundtrip(kv):
    eng, srv = _fake_replica(kv, "r0")
    gws = GatewayServer(kv, "job", GatewayConfig(max_inflight=2, max_queue=0, wait_slice_s=0.05,
                                                 poll_period_s=0.05), host="127.0.0.1")
    try:
        assert gws.gateway.wait_for_replicas(1, 10)
        with RpcClient(gws.endpoint) as client:
            r = client.call("gate_generate", prompt=[30], max_new=4)
            assert r["tokens"] == [int(x) for x in _expected([30], 4)]
            assert "r0" in client.call("gate_stats")["replicas"]
    finally:
        gws.stop()
        srv.close()


# -- across packages ---------------------------------------------------------
def test_jax_gateway_routes_to_port_replica_and_back(coord_server):
    """Over the JAX coordination server: the JAX ``Gateway`` drives a port
    replica (a real engine; tokens equal the port's ``generate``) with a
    session, and the port's ``Gateway`` drives a JAX replica."""
    from edl_tpu.coord.client import CoordClient as JaxCoordClient
    from edl_tpu.gateway import Gateway as JaxGateway, GatewayConfig as JaxGatewayConfig
    from edl_tpu.serving.replica import ReplicaServer as JaxReplicaServer
    from edl_tpu_torch.coord.client import CoordClient

    ep = f"127.0.0.1:{coord_server.port}"
    store, jstore = CoordClient(ep, timeout=10), JaxCoordClient(ep, timeout=10)
    srv = _real_replica(store, "port-r", kv_block=4, kv_pool_blocks=32)
    jgw = _gateway(jstore, JaxGateway, JaxGatewayConfig, request_timeout_s=60.0)
    try:
        assert jgw.wait_for_replicas(1, 10)
        p = np.asarray([3, 1, 4, 1, 5, 9], np.int32)
        np.testing.assert_array_equal(jgw.generate(p, 7, session="s", timeout=60), _want(p, 7))
        assert srv._engine.stats()["kv_sessions"] == 1
    finally:
        jgw.close()
        srv.close()
    _, jsrv = _fake_replica(jstore, "jax-r", server_cls=JaxReplicaServer)
    gw = _gateway(store)
    try:
        assert gw.wait_for_replicas(1, 10)
        np.testing.assert_array_equal(gw.generate([21], 5, timeout=30), _expected([21], 5))
    finally:
        gw.close()
        jsrv.close()
        store.close()
        jstore.close()


# -- CoordSession -----------------------------------------------------------
def test_session_owns_multiple_keys_one_lease(kv):
    s = CoordSession(kv, ttl=5.0)
    s.register("/m/a", b"1")
    s.register("/m/b", b"2")
    assert kv.get("/m/a").lease_id == s.lease_id == kv.get("/m/b").lease_id
    s.update("/m/a", b"1b")
    assert kv.get("/m/a").value == b"1b"
    s.unregister("/m/b")
    assert kv.get("/m/b") is None
    s.close()
    assert kv.get("/m/a") is None          # the revoke swept the lease's keys


def test_session_regrants_and_reputs_after_lease_loss(kv):
    s = CoordSession(kv, ttl=0.6)
    s.register("/h/a", b"1")
    s.register("/h/b", b"2")
    first = s.lease_id
    kv.lease_revoke(first)                 # a blip longer than one TTL
    _until(lambda: kv.get("/h/a") is not None and s.lease_id != first)
    assert kv.get("/h/a").value == b"1" and kv.get("/h/b").value == b"2"
    assert kv.get("/h/a").lease_id == s.lease_id
    assert not s.is_stopped
    s.close()


def test_session_exclusive_key_stops_on_lease_loss(kv):
    lost: list = []
    s = CoordSession(kv, ttl=0.6, on_lost=lost.append)
    s.register("/seat/x", b"A", exclusive=True)
    kv.lease_revoke(s.lease_id)
    kv.put("/seat/x", b"B")                # a usurper takes the seat
    _until(lambda: s.is_stopped)
    assert isinstance(s.error, EdlRegisterError)
    assert lost and isinstance(lost[0], EdlRegisterError)
    assert kv.get("/seat/x").value == b"B"


def test_session_survives_nondurable_server_restart():
    """On the JAX coordination server without its log: the restarted server
    forgot the lease, and the session re-grants and re-puts."""
    from edl_tpu.coord.server import start_server
    from edl_tpu_torch.coord.resilient import ResilientCoordClient

    server = start_server("127.0.0.1", 0)
    port = server.port
    rc = ResilientCoordClient([f"127.0.0.1:{port}"], timeout=2.0, retry_deadline=15.0,
                              backoff_init=0.01)
    s = CoordSession(rc, ttl=1.0)
    s.register("/nv/adv", b"ep")
    server.stop()
    time.sleep(1.5)                        # an outage longer than one TTL
    server2 = start_server("127.0.0.1", port)
    try:
        _until(lambda: rc.get("/nv/adv") is not None, 20, "the re-registration")
        assert not s.is_stopped
    finally:
        s.close()
        rc.close()
        server2.stop()


def test_advert_modules_share_one_session(kv):
    """A replica advert, a session pin and a plain leased key ride one
    lease; stopping one leaves the others."""
    s = CoordSession(kv, ttl=5.0)
    h1 = fleet.advertise(kv, "j", "rep0", {"endpoint": "1.2.3.4:2"}, session=s)
    h2 = fleet.pin_session(kv, "j", "conv", "rep0", coord_session=s)
    h3 = leased_register(kv, "/edl_tpu/j/other/k", b"v", session=s)
    assert "rep0" in fleet.list_replicas(kv, "j")
    assert fleet.list_session_pins(kv, "j") == {"conv": "rep0"}
    assert {kv.get(k).lease_id for k in ("/edl_tpu/j/serving/nodes/rep0",
                                         "/edl_tpu/j/serving/sessions/conv",
                                         "/edl_tpu/j/other/k")} == {s.lease_id}
    h1.update(b'{"endpoint": "1.2.3.4:2", "free_slots": 3}')
    assert fleet.list_replicas(kv, "j")["rep0"]["free_slots"] == 3
    h2.stop()
    assert fleet.list_session_pins(kv, "j") == {}
    assert "rep0" in fleet.list_replicas(kv, "j") and not h1.is_stopped
    assert h2.is_stopped
    h3.stop()
    h1.stop()
    s.close()


def test_unregister_failure_retried_by_heartbeat(kv):
    s = CoordSession(kv, ttl=0.4)
    s.register("/u/a", b"1")
    real_delete = kv.delete
    fails = {"n": 2}

    def flaky_delete(key):
        if fails["n"] > 0:
            fails["n"] -= 1
            raise EdlCoordError("blip")
        return real_delete(key)

    kv.delete = flaky_delete
    try:
        s.unregister("/u/a")              # parked as an orphan, no raise
        _until(lambda: kv.get("/u/a") is None, what="the orphaned delete")
        assert fails["n"] == 0
    finally:
        kv.delete = real_delete
        s.close()


def test_unregister_wins_over_racing_heal_reput(kv):
    s = CoordSession(kv, ttl=0.3)
    s.register("/r/k", b"v")
    real_get = kv.get
    in_heal = threading.Event()
    release = threading.Event()

    def gated_get(key):
        if key == "/r/k" and not release.is_set():
            in_heal.set()
            release.wait(10)
        return real_get(key)

    kv.delete("/r/k")      # swept out from under the session
    kv.get = gated_get
    try:
        assert in_heal.wait(10), "heartbeat never entered heal"
        t = threading.Thread(target=lambda: s.unregister("/r/k"))
        t.start()
        time.sleep(0.2)
        release.set()
        t.join(10)
        assert not t.is_alive()
    finally:
        kv.get = real_get
        release.set()
    _until(lambda: real_get("/r/k") is None, 5, "the key's removal")
    s.close()


def test_unregister_untracked_key_is_a_noop(kv):
    s = CoordSession(kv, ttl=5.0)
    s.register("/n/k", b"v")
    s.unregister("/n/k", delete=False)     # moved to a throwaway lease
    assert kv.get("/n/k") is not None
    s.unregister("/n/k", delete=False)     # a double stop: a no-op
    assert kv.get("/n/k") is not None
    s.unregister("/n/k")                   # not ours any more
    assert kv.get("/n/k") is not None
    kv.put("/n/foreign", b"x")
    s.unregister("/n/foreign")             # never registered here
    assert kv.get("/n/foreign") is not None
    s.close()


def test_update_losing_race_to_unregister_never_puts(kv):
    s = CoordSession(kv, ttl=5.0)
    s.register("/r/u", b"v0")
    puts = []
    real_put = kv.put

    def spy_put(key, value, lease_id=0):
        puts.append((key, value))
        return real_put(key, value, lease_id)

    kv.put = spy_put
    try:
        s._op_lock.acquire()          # pin both racers at the lock
        t_upd = threading.Thread(target=lambda: s.update("/r/u", b"v1"))
        t_upd.start()
        _until(lambda: s._keys["/r/u"].value == b"v1", 5)
        t_unr = threading.Thread(target=lambda: s.unregister("/r/u"))
        t_unr.start()
        _until(lambda: "/r/u" not in s._keys, 5)
        s._op_lock.release()
        t_upd.join(10)
        t_unr.join(10)
        assert not t_upd.is_alive() and not t_unr.is_alive()
        assert kv.get("/r/u") is None, "unregister must win"
        assert ("/r/u", b"v1") not in puts, "an update that lost the race must skip its put"
    finally:
        kv.put = real_put
        s.close()


def test_reregister_cancels_pending_orphaned_unregister(kv):
    s = CoordSession(kv, ttl=0.4)
    s.register("/o/k", b"old")
    real_delete = kv.delete

    def failing_delete(key):
        raise EdlCoordError("blip")

    kv.delete = failing_delete
    try:
        s.unregister("/o/k")          # parked as an orphan, no raise
    finally:
        kv.delete = real_delete
    deleted = []

    def spy_delete(key):
        deleted.append(key)
        return real_delete(key)

    kv.delete = spy_delete
    try:
        s.register("/o/k", b"new")    # re-advertise: cancels the orphan
        time.sleep(1.2)               # several beats of the orphan drain
        assert "/o/k" not in deleted, "the orphan drain deleted the re-registered advert"
        rec = kv.get("/o/k")
        assert rec is not None and rec.value == b"new"
    finally:
        kv.delete = real_delete
        s.close()


def test_failed_exclusive_seize_spawns_no_heartbeat_thread():
    """A ``Register`` whose first put fails raises before its keep-alive
    thread starts and revokes its lease; a shared session's failed
    exclusive seize leaves the holder's seat and tracks nothing."""
    store = MemoryKV(sweep_period=0.1)
    real_put = store.put

    def refusing_put(key, value, lease_id=0):
        if key == "/seat":
            raise ConnectionError("store blip")
        return real_put(key, value, lease_id)

    store.put = refusing_put
    try:
        for _ in range(3):
            with pytest.raises(ConnectionError):
                Register(store, "/seat", b"l", ttl=5.0)
    finally:
        store.put = real_put
    assert not [t for t in threading.enumerate() if t.name == "coord-session:/seat"]
    assert not store._leases, "the failed registrations' leases revoked"
    winner = Register(store, "/seat", b"w", ttl=5.0)
    loser = CoordSession(store, ttl=5.0)
    with pytest.raises(EdlRegisterError):
        loser.register("/seat", b"l", exclusive=True)
    assert not loser.is_registered("/seat") and store.get("/seat").value == b"w"
    loser.close()
    winner.stop()
    store.close()


def test_register_facade_heals_a_deleted_key(kv):
    """The one-key ``Register`` rides the session's heal: a key deleted
    under its live lease is put back with its last value."""
    reg = Register(kv, "/f/k", b"a", ttl=0.4)
    try:
        reg.update(b"b")
        kv.delete("/f/k")
        _until(lambda: kv.get("/f/k") is not None, what="the heal")
        assert kv.get("/f/k").value == b"b" and kv.get("/f/k").lease_id == reg.lease_id
    finally:
        reg.stop()
    assert kv.get("/f/k") is None


# -- processes --------------------------------------------------------------
def _spawn_replica(coord_ep: str, rid: str, log: Path) -> subprocess.Popen:
    env = {k: v for k, v in os.environ.items() if not k.startswith("EDL_TPU_")}
    env["PYTHONPATH"] = str(ROOT)
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "edl_tpu_torch.serving.replica", "--device", "cpu",
             "--coord_endpoints", coord_ep, "--job_id", "job", "--replica_id", rid,
             "--host", "127.0.0.1", "--vocab", "53", "--layers", "1", "--embed", "32",
             "--heads", "2", "--mlp", "64", "--max_len", "64", "--slots", "2",
             "--steps_per_sync", "4", "--temperature", "0", "--seed", "0", "--ttl", "2"],
            cwd=ROOT, env=env, stdout=f, stderr=subprocess.STDOUT)
    return proc


@pytest.mark.slow
def test_replica_processes_sigkill_failover_e2e(coord_server, tmp_path):
    """Two ``python -m edl_tpu_torch.serving.replica`` processes behind the
    port's gateway on the JAX coordination server: greedy tokens of the
    seeded model through the gateway; one replica SIGKILLed under load and
    every accepted request still completes, replayed on the survivor."""
    import signal

    from edl_tpu_torch.coord.client import CoordClient

    ep = f"127.0.0.1:{coord_server.port}"
    logs = [tmp_path / f"r{i}.log" for i in range(2)]
    procs = [_spawn_replica(ep, f"r{i}", logs[i]) for i in range(2)]
    store = CoordClient(ep, timeout=10)
    gw = _gateway(store, max_inflight=8, max_queue=32, request_timeout_s=120.0)
    try:
        for log, proc in zip(logs, procs):
            _until(lambda: "serving on" in log.read_text() or proc.poll() is not None, 120)
            assert proc.poll() is None, log.read_text()[-3000:]
        assert gw.wait_for_replicas(2, 30)
        rng = np.random.default_rng(5)
        prompts = [rng.integers(1, 53, (int(n),)).astype(np.int32)
                   for n in rng.integers(3, 12, 24)]
        for p in prompts[:4]:
            np.testing.assert_array_equal(gw.generate(p, 8, timeout=60), _want(p, 8))
        futs = [gw.submit(p, 12) for p in prompts]
        time.sleep(0.3)
        procs[0].send_signal(signal.SIGKILL)
        for p, f in zip(prompts, futs):
            np.testing.assert_array_equal(f.result(timeout=120), _want(p, 12))
        assert gw.stats()["counts"].get("requests_error", 0) == 0
    finally:
        gw.close()
        store.close()
        for proc in procs:
            if proc.poll() is None:
                proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()


def test_replica_cli_needs_a_card_unless_told_cpu(coord_server, tmp_path):
    """Without ``--device`` the replica asks for the card and, with none
    here, exits with ``NoCardError`` before leasing anything."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("EDL_TPU_")}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-m", "edl_tpu_torch.serving.replica",
                          "--coord_endpoints", f"127.0.0.1:{coord_server.port}",
                          "--job_id", "job"], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0 and "NoCardError" in out.stderr
