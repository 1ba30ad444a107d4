"""The port's distillation plane (``edl_tpu_torch/distill/``, ``coord/kv.py``'s
watcher, ``coord/consistent_hash.py``) on the CPU: every case of
``tests/test_distill.py`` against the port's modules (the nop pool's order
and shapes, the soak, fault-injection requeue, the starvation timeout, the
three rebalance cases, the redirect between two tables, live discovery end
to end, client GC and the env-gated timeline), the reader-throughput probe;
the port against the JAX package on the same inputs (the balance
assignments, the ring's owners, the nop pool's and the reader's batches in
each mode); and the wire in both directions (each package's reader against
the other's teacher server, each package's discovery client against the
other's discovery server on the JAX coordination server)."""

import threading
import time

import numpy as np
import pytest

from edl_tpu.coord import consistent_hash as jch
from edl_tpu.coord.client import CoordClient as JaxCoordClient
from edl_tpu.coord.memory import MemoryKV as JaxMemoryKV
from edl_tpu.distill import balance as jbalance
from edl_tpu.distill import predict_pool as jpool
from edl_tpu.distill import reader as jreader
from edl_tpu.distill.discovery import DiscoveryClient as JaxDiscoveryClient
from edl_tpu.distill.discovery import DiscoveryServer as JaxDiscoveryServer
from edl_tpu.distill.predict_client import NopPredictClient as JaxNop
from edl_tpu.distill.teacher import TeacherServer as JaxTeacherServer
from edl_tpu_torch.coord import consistent_hash
from edl_tpu_torch.coord.client import CoordClient
from edl_tpu_torch.coord.kv import KVRecord, KVStore, PrefixWatcher, WaitResult, WatchEvent
from edl_tpu_torch.coord.memory import MemoryKV
from edl_tpu_torch.distill import reader as reader_mod
from edl_tpu_torch.distill.balance import (
    BALANCE_SERVICE, OK, REDIRECT, UNREGISTERED, BalanceTable, Service, server_key,
)
from edl_tpu_torch.distill.discovery import DiscoveryClient, DiscoveryServer
from edl_tpu_torch.distill.predict_client import NopPredictClient
from edl_tpu_torch.distill.predict_pool import PoolError, PredictPool
from edl_tpu_torch.distill.reader import DistillReader
from edl_tpu_torch.distill.teacher import TeacherServer

W = np.arange(6, dtype=np.float32).reshape(3, 2)


def linear(feed):
    return {"logits": feed["x"] @ W}


def sample_list_gen(n_batches=8, bs=4, dim=3):
    def gen():
        for b in range(n_batches):
            yield [(np.full((dim,), b * bs + i, np.float32), b * bs + i)
                   for i in range(bs)]
    return gen


def make_nop_reader(n_batches=8, bs=4, fixed=("t1", "t2"), tbs=3):
    dr = DistillReader(ins=["x", "idx"], predicts=["prediction"],
                       feeds=["x"], teacher_batch_size=tbs)
    dr.set_fixed_teacher(*fixed)
    dr.set_sample_list_generator(sample_list_gen(n_batches, bs))
    return dr


def wait_for(fn, timeout=20.0, period=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        v = fn()
        if v:
            return v
        time.sleep(period)
    raise AssertionError("condition never became true")


@pytest.fixture
def tkv():
    kv = MemoryKV(sweep_period=0.1)
    yield kv
    kv.close()


@pytest.fixture(autouse=True)
def nop_mode(monkeypatch):
    monkeypatch.setattr(reader_mod, "_NOP_PREDICT_TEST", True)
    yield


# -- the pool ------------------------------------------------------------------

def test_nop_pool_order_and_shapes():
    dr = make_nop_reader(n_batches=10, bs=4)
    dr._pool_kw = {"manage_period": 0.05}
    batches = list(dr())
    assert len(batches) == 10
    for b, (x, idx, pred) in enumerate(batches):
        assert x.shape == (4, 3) and idx.shape == (4,) and pred.shape == (4, 1)
        # order preserved: batch b carries global ids [4b, 4b+4)
        np.testing.assert_array_equal(idx, np.arange(4 * b, 4 * b + 4))
        np.testing.assert_array_equal(x[:, 0], idx.astype(np.float32))


def test_nop_soak_multi_epoch():
    dr = make_nop_reader(n_batches=6, bs=5, tbs=4)
    dr._pool_kw = {"manage_period": 0.05}
    for _ in range(10):
        assert sum(len(b[0]) for b in dr()) == 30


def test_pool_fault_injection_requeues():
    """A teacher failing every Nth call loses its worker; the manager
    re-attaches it and every task still completes exactly once; after the
    run no worker is left (one attached during the shutdown ends too)."""
    clients = []

    def factory(ep):
        c = NopPredictClient(ep, ["prediction"], fail_every=5)
        clients.append(c)
        return c

    stream_batches = [(i, [(np.ones(2, np.float32) * (4 * i + j), 4 * i + j)
                           for j in range(4)]) for i in range(12)]
    pool = PredictPool(factory, lambda: ["t1", "t2"], ["x"], [0],
                       teacher_batch_size=3, manage_period=0.05,
                       no_teacher_timeout=10.0)
    out = list(pool.run(iter(stream_batches), ["prediction"]))
    assert len(out) == 12
    ids = np.concatenate([b[1] for b in out])
    np.testing.assert_array_equal(ids, np.arange(48))
    assert len(clients) > 2  # workers died and were re-attached
    wait_for(lambda: not [t for t in threading.enumerate() if t.name.startswith("predict:")],
             timeout=5.0)


def test_pool_starvation_times_out():
    def factory(ep):
        raise ConnectionError("nobody home")

    pool = PredictPool(factory, lambda: ["t1"], ["x"], [0],
                       manage_period=0.05, no_teacher_timeout=0.5)
    stream = iter([(0, [(np.ones(2, np.float32), 0)])])
    with pytest.raises(PoolError, match="no live teacher"):
        list(pool.run(stream, ["prediction"]))


def test_pool_stops_its_threads_when_the_consumer_stops_early():
    """A consumer that leaves mid-epoch halts the pool: the reader, the
    manager and every worker end (a pool is built per epoch)."""
    def pool_threads():
        return [t for t in threading.enumerate() if t.is_alive() and (
            t.name in ("pool-reader", "pool-manager") or t.name.startswith("predict:"))]

    wait_for(lambda: not pool_threads(), timeout=10.0)   # earlier tests' pools
    dr = make_nop_reader(n_batches=50, bs=4)
    dr._pool_kw = {"manage_period": 0.05}
    it = dr()
    next(it)
    assert pool_threads()
    it.close()
    wait_for(lambda: not pool_threads(), timeout=10.0)


# -- the balance table ---------------------------------------------------------

def test_service_rebalance_spreads_load(tkv):
    svc = Service("svc", tkv, period=0.05)
    try:
        for t in ("t1", "t2", "t3", "t4"):
            tkv.put(server_key("svc", t), t.encode())
        for c in range(8):
            svc.add_client(f"c{c}", require_num=4)
        svc._refresh_servers()
        # 8 clients / 4 teachers: every client gets max(1, 4 // 8) = 1
        # teacher, each teacher serves ceil(8 / 4) = 2 clients
        loads = {}
        for c in range(8):
            _, servers = svc.get_servers(f"c{c}", -1)
            assert len(servers) == 1
            loads[servers[0]] = loads.get(servers[0], 0) + 1
        assert all(v == 2 for v in loads.values())
    finally:
        svc.close()


def test_service_rebalance_many_teachers_few_clients(tkv):
    svc = Service("svc2", tkv, period=0.05)
    try:
        for t in range(6):
            tkv.put(server_key("svc2", f"t{t}"), b"x")
        svc.add_client("c0", require_num=2)
        svc.add_client("c1", require_num=99)
        svc._refresh_servers()
        _, s0 = svc.get_servers("c0", -1)
        _, s1 = svc.get_servers("c1", -1)
        assert len(s0) == 2            # capped by require_num
        assert len(s1) == 3            # capped by floor(6 / 2)
    finally:
        svc.close()


def test_service_version_advances_only_on_change(tkv):
    svc = Service("svc3", tkv, period=0.05)
    try:
        tkv.put(server_key("svc3", "t1"), b"x")
        svc.add_client("c0", require_num=1)
        svc._refresh_servers()
        v1, servers = svc.get_servers("c0", -1)
        assert servers == ["t1"]
        v2, none = svc.get_servers("c0", v1)
        assert v2 == v1 and none is None
        tkv.put(server_key("svc3", "t2"), b"x")
        svc._refresh_servers()
        v3, servers3 = svc.get_servers("c0", v1)
        # the same version gives no list
        if v3 == v1:
            assert servers3 is None
    finally:
        svc.close()


def test_service_follows_teacher_changes_through_its_watch(tkv):
    """The service's store watch (``PrefixWatcher``) alone, with no manual
    refresh, brings a joining teacher in and a leaving one out."""
    svc = Service("svc4", tkv, period=0.05)
    try:
        svc.add_client("c0", require_num=2)
        tkv.put(server_key("svc4", "t1"), b"x")
        wait_for(lambda: svc.get_servers("c0", -1)[1] == ["t1"])
        tkv.put(server_key("svc4", "t2"), b"x")
        wait_for(lambda: svc.get_servers("c0", -1)[1] == ["t1", "t2"])
        tkv.delete(server_key("svc4", "t1"))
        wait_for(lambda: svc.get_servers("c0", -1)[1] == ["t2"])
    finally:
        svc.close()


def test_balance_redirect_between_two_tables(tkv):
    ta = BalanceTable(tkv, "hostA:1")
    tkv.put(server_key("__balance__", "hostA:1"), b"x")
    tkv.put(server_key("__balance__", "hostB:2"), b"x")
    tb = BalanceTable(tkv, "hostB:2")
    ta._refresh_ring()
    tb._refresh_ring()
    try:
        # each service name is owned by exactly one of the two tables
        svc = "some-service"
        owners = {ta.owner_of(svc), tb.owner_of(svc)}
        assert len(owners) == 1
        owner = owners.pop()
        owning, other = (ta, tb) if owner == "hostA:1" else (tb, ta)
        assert other.register_client("c0", svc)["code"] == REDIRECT
        assert owning.register_client("c0", svc)["code"] == OK
    finally:
        ta.close()
        tb.close()


def test_client_gc_reassigns_dead_students_teachers(tkv):
    """A student that dies silently (no unregister) is expired after the
    client TTL and its teachers go to the survivors; the dead client's
    next heartbeat is told to re-register."""
    table = BalanceTable(tkv, "ep-gc", client_ttl=1.5)
    try:
        for t in ("t1", "t2"):
            tkv.put(server_key("svc-gc", t), t.encode())
        assert table.register_client("alive", "svc-gc", require_num=2)["code"] == OK
        assert table.register_client("dead", "svc-gc", require_num=2)["code"] == OK
        table.service("svc-gc")._refresh_servers()
        r = table.heartbeat("alive", "svc-gc", -1)
        assert r["code"] == OK and len(r["servers"]) == 1, r
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            r = table.heartbeat("alive", "svc-gc", -1)
            if r["code"] == OK and len(r.get("servers") or []) == 2:
                break
            time.sleep(0.1)
        assert r["code"] == OK and len(r["servers"]) == 2, r
        assert table.heartbeat("dead", "svc-gc", -1)["code"] == UNREGISTERED
    finally:
        table.close()


# -- the JAX package's answers on the same inputs ----------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_service_assigns_what_the_jax_service_assigns(seed):
    """Seeded teacher and client sets, joins, leaves and a client
    departure: both services give every client the same teachers and
    versions at every stage."""
    rng = np.random.default_rng(seed)
    teachers = [f"10.0.{seed}.{i}:9{i}" for i in range(int(rng.integers(1, 9)))]
    clients = [(f"c{i}", int(rng.integers(1, 6))) for i in range(int(rng.integers(1, 12)))]
    tkv, jkv = MemoryKV(sweep_period=0.1), JaxMemoryKV(sweep_period=0.1)
    ours, theirs = Service("s", tkv, period=60.0), jbalance.Service("s", jkv, period=60.0)

    def view(svc):
        return {c: svc.get_servers(c, -1) for c, _ in clients if svc.is_registered(c)}

    try:
        for t in teachers:
            tkv.put(server_key("s", t), b"x")
            jkv.put(jbalance.server_key("s", t), b"x")
        stages = []
        for svc in (ours, theirs):
            svc._refresh_servers()
            seen = []
            for c, n in clients:
                svc.add_client(c, n)
            seen.append(view(svc))
            stages.append(seen)
        # a teacher leaves, another joins, a client leaves
        changes = [("del", teachers[0]), ("put", "10.9.9.9:99")]
        for kind, t in changes:
            for kv, key in ((tkv, server_key("s", t)), (jkv, jbalance.server_key("s", t))):
                kv.delete(key) if kind == "del" else kv.put(key, b"x")
            for svc, seen in zip((ours, theirs), stages):
                svc._refresh_servers()
                seen.append(view(svc))
        for svc, seen in zip((ours, theirs), stages):
            svc.remove_client(clients[0][0])
            seen.append(view(svc))
        assert stages[0] == stages[1]
        assert any(servers for stage in stages[0] for _, servers in stage.values())
    finally:
        ours.close()
        theirs.close()
        tkv.close()
        jkv.close()


@pytest.mark.parametrize("n_nodes", [1, 2, 5])
def test_ring_owners_equal_the_jax_ring(n_nodes):
    nodes = [f"10.1.0.{i}:70{i}" for i in range(n_nodes)]
    ours, theirs = consistent_hash.ConsistentHash(nodes), jch.ConsistentHash(nodes)
    keys = [f"service-{i}" for i in range(200)]
    assert [ours.get_node(k) for k in keys] == [theirs.get_node(k) for k in keys]
    assert ([ours.get_replica(k, nodes[0]) for k in keys]
            == [theirs.get_replica(k, nodes[0]) for k in keys])
    ours.add_node("extra:1")
    theirs.add_node("extra:1")
    ours.remove_node(nodes[0])
    theirs.remove_node(nodes[0])
    assert ours.nodes == theirs.nodes
    assert [ours.get_node(k) for k in keys] == [theirs.get_node(k) for k in keys]


def _inputs(mode):
    """The same user generator for both readers in ``mode``."""
    rng = np.random.default_rng(5)
    data = [(rng.normal(size=(7, 3)).astype(np.float32), np.arange(7, dtype=np.int32) + 7 * b)
            for b in range(5)]
    if mode == "sample":
        return lambda: iter([(xr, ir) for x, i in data for xr, ir in zip(x, i)])
    if mode == "sample_list":
        return lambda: iter([list(zip(x, i)) for x, i in data])
    return lambda: iter(data)


@pytest.mark.parametrize("mode", ["sample", "sample_list", "batch"])
def test_reader_batches_equal_the_jax_readers(mode, monkeypatch):
    monkeypatch.setattr(jreader, "_NOP_PREDICT_TEST", True)
    out = []
    for cls in (DistillReader, jreader.DistillReader):
        dr = cls(ins=["x", "idx"], predicts=["p"], feeds=["x"], teacher_batch_size=3)
        dr.set_fixed_teacher("t1", "t2")
        getattr(dr, f"set_{mode}_generator")(_inputs(mode))
        dr._pool_kw = {"manage_period": 0.05}
        out.append(list(dr()))
    assert len(out[0]) == len(out[1]) == (35 if mode == "sample" else 5)
    for ours, theirs in zip(*out):
        assert len(ours) == len(theirs) == 3
        for a, b in zip(ours, theirs):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_pool_output_equals_the_jax_pool():
    stream = [(i, [(np.full(2, 4 * i + j, np.float32), 4 * i + j) for j in range(4)])
              for i in range(6)]
    ours = PredictPool(lambda ep: NopPredictClient(ep, ["p"]), lambda: ["t1"], ["x"], [0],
                       teacher_batch_size=3, manage_period=0.05)
    theirs = jpool.PredictPool(lambda ep: JaxNop(ep, ["p"]), lambda: ["t1"], ["x"], [0],
                               teacher_batch_size=3, manage_period=0.05)
    a = list(ours.run(iter(stream), ["p"]))
    b = list(theirs.run(iter(stream), ["p"]))
    assert len(a) == len(b) == 6
    for x, y in zip(a, b):
        for u, v in zip(x, y):
            np.testing.assert_array_equal(u, v)


# -- the prefix watcher ---------------------------------------------------------

class _SnapshotStore(KVStore):
    """A store whose first wait answers with a snapshot lacking ``/p/a``."""

    def __init__(self):
        self.calls = 0

    def get_prefix(self, prefix):
        return [KVRecord("/p/a", b"1"), KVRecord("/p/b", b"2")], 5

    def wait(self, prefix, since_revision, timeout):
        self.calls += 1
        if self.calls == 1:
            return WaitResult([WatchEvent("put", KVRecord("/p/b", b"2")),
                               WatchEvent("put", KVRecord("/p/c", b"3"))], 9, snapshot=True)
        time.sleep(0.05)
        return WaitResult([], 9)


def test_watcher_snapshot_replaces_the_view():
    """A snapshot result replaces the watcher's view: the keys it lacks
    come first as synthetic deletes, then its puts."""
    got = []
    w = PrefixWatcher(_SnapshotStore(), "/p/", got.extend, 0.1)
    w.start()
    try:
        wait_for(lambda: got)
    finally:
        w.stop()
        w.join(timeout=5)
    assert [(e.type, e.record.key) for e in got] == [
        ("delete", "/p/a"), ("put", "/p/b"), ("put", "/p/c")]
    assert w._known == {"/p/b", "/p/c"}


def test_watch_prefix_over_the_jax_coordination_server(coord_server):
    """The port's store client watches a prefix on the JAX coordination
    server through its own connection, and stops it."""
    client = CoordClient(f"127.0.0.1:{coord_server.port}", timeout=10)
    got = []
    w = client.watch_prefix("/w/", got.extend, period=0.2)
    try:
        client.put("/w/a", b"1")
        client.put("/x/b", b"2")
        client.delete("/w/a")
        wait_for(lambda: len(got) >= 2)
    finally:
        w.stop()
        w.join(timeout=5)
        client.close()
    assert [(e.type, e.record.key) for e in got] == [("put", "/w/a"), ("delete", "/w/a")]


# -- live end to end ---------------------------------------------------------------

def test_live_teacher_discovery_end_to_end(tkv, monkeypatch):
    """A real RPC teacher, discovery server and DistillReader, no fakes."""
    monkeypatch.setattr(reader_mod, "_NOP_PREDICT_TEST", False)
    teacher = TeacherServer(linear, buckets=(2, 4, 8))
    disc = DiscoveryServer(tkv, ttl=2.0)
    teacher.register(tkv, "lin-svc", ttl=2.0)
    try:
        dr = DistillReader(ins=["x", "idx"], predicts=["logits"],
                           feeds=["x"], teacher_batch_size=4)
        dr.set_dynamic_teacher(disc.endpoint, "lin-svc", max_teachers=2)
        dr.set_sample_list_generator(sample_list_gen(n_batches=5, bs=3))
        dr._pool_kw = {"manage_period": 0.1, "no_teacher_timeout": 30.0}
        batches = list(dr())
        assert len(batches) == 5
        for x, idx, logits in batches:
            np.testing.assert_allclose(logits, x @ W, rtol=1e-6)
    finally:
        teacher.stop()
        disc.stop()


def test_discovery_server_session_raises(tkv):
    """``DiscoveryServer(session=)`` serves, its ring advert on the
    session's lease; a session that can no longer take keys raises, and
    the server's own stop leaves the session's other keys alone."""
    from edl_tpu_torch.coord.session import CoordSession

    session = CoordSession(tkv, ttl=2.0, name="disc-session")
    session.register("/other", b"1")
    disc = DiscoveryServer(tkv, host="127.0.0.1", session=session)
    try:
        rec = tkv.get(server_key(BALANCE_SERVICE, disc.endpoint))
        assert rec is not None and rec.lease_id == session.lease_id
    finally:
        disc.stop()
    assert tkv.get(server_key(BALANCE_SERVICE, disc.endpoint)) is None
    assert tkv.get("/other").lease_id == session.lease_id
    session.close()
    with pytest.raises(Exception):
        DiscoveryServer(tkv, host="127.0.0.1", session=session)


def _read_linear(reader_cls, endpoint):
    dr = reader_cls(ins=["x", "idx"], predicts=["logits"], feeds=["x"], teacher_batch_size=4)
    dr.set_fixed_teacher(endpoint)
    dr.set_sample_list_generator(sample_list_gen(n_batches=4, bs=5))
    dr._pool_kw = {"manage_period": 0.1, "no_teacher_timeout": 30.0}
    return list(dr())


@pytest.mark.parametrize("direction", ["jax_reader_port_teacher", "port_reader_jax_teacher"])
def test_readers_and_teachers_across_packages(direction, monkeypatch):
    """The JAX reader streams from the port's teacher server, and the
    port's reader from the JAX one: the same wire both ways."""
    monkeypatch.setattr(reader_mod, "_NOP_PREDICT_TEST", False)
    monkeypatch.setattr(jreader, "_NOP_PREDICT_TEST", False)
    if direction == "jax_reader_port_teacher":
        server, reader_cls = TeacherServer(linear, host="127.0.0.1"), jreader.DistillReader
    else:
        server, reader_cls = JaxTeacherServer(linear, host="127.0.0.1"), DistillReader
    try:
        batches = _read_linear(reader_cls, server.endpoint)
        stats = server.stats()
    finally:
        server.stop()
    assert len(batches) == 4 and stats["rows"] == 20
    for b, (x, idx, logits) in enumerate(batches):
        np.testing.assert_array_equal(idx, np.arange(5 * b, 5 * b + 5))
        np.testing.assert_allclose(logits, x @ W, rtol=1e-6)


@pytest.mark.parametrize("direction", ["port_client_jax_server", "jax_client_port_server"])
def test_discovery_across_packages(direction, coord_server, monkeypatch):
    """Each package's discovery client against the other's discovery
    server, both on the JAX coordination server; the teacher registered
    by the port's server, then a second one joins and the first leaves."""
    monkeypatch.setattr(reader_mod, "_NOP_PREDICT_TEST", False)
    ep = f"127.0.0.1:{coord_server.port}"
    jstore, tstore = JaxCoordClient(ep), CoordClient(ep)
    if direction == "port_client_jax_server":
        disc = JaxDiscoveryServer(jstore, host="127.0.0.1", ttl=2.0)
        client_cls = DiscoveryClient
    else:
        disc = DiscoveryServer(tstore, host="127.0.0.1", ttl=2.0)
        client_cls = JaxDiscoveryClient
    teachers = [TeacherServer(linear, host="127.0.0.1").register(tstore, "x-svc", ttl=2.0)]
    client = client_cls(disc.endpoint, "x-svc", require_num=2, heartbeat_period=0.2).start()
    try:
        wait_for(lambda: client.servers() == [teachers[0].endpoint])
        teachers.append(TeacherServer(linear, host="127.0.0.1").register(tstore, "x-svc",
                                                                          ttl=2.0))
        wait_for(lambda: client.servers() == sorted(t.endpoint for t in teachers))
        teachers[0].stop()
        wait_for(lambda: client.servers() == [teachers[1].endpoint])
    finally:
        client.stop()
        for t in teachers:
            t.stop()
        disc.stop()
        jstore.close()
        tstore.close()


def test_timeline_profiler_env_gated(monkeypatch, capsys):
    from edl_tpu_torch.distill import timeline as tl

    monkeypatch.setattr(tl, "_instance", None)
    monkeypatch.delenv("EDL_TPU_DISTILL_PROFILE", raising=False)
    assert not tl.timeline().enabled

    monkeypatch.setattr(tl, "_instance", None)
    monkeypatch.setenv("EDL_TPU_DISTILL_PROFILE", "1")
    t = tl.timeline()
    assert t.enabled
    with t.span("predict", teacher="t1", n=4):
        pass
    err = capsys.readouterr().err
    assert "[timeline] op=predict" in err and "teacher=t1" in err
    monkeypatch.setattr(tl, "_instance", None)


def test_qps_probe_reports_throughput():
    from edl_tpu_torch.distill.qps import run_probe

    out = run_probe(nop=True, batches=120, batch_size=16, warmup=10)
    assert out["metric"] == "distill_reader_qps"
    assert out["value"] > 0, out
    assert out["unit"] == "samples/s"


def test_reader_env_overrides_code(monkeypatch):
    """``EDL_TPU_DISTILL_*`` take precedence over the constructor, as in the
    JAX reader: the teacher batch size, the fixed teachers and discovery."""
    monkeypatch.setenv("EDL_TPU_DISTILL_TEACHER_BATCH_SIZE", "5")
    monkeypatch.setenv("EDL_TPU_DISTILL_TEACHERS", "a:1, b:2")
    monkeypatch.setenv("EDL_TPU_DISTILL_MAX_TEACHER", "3")
    for cls in (DistillReader, jreader.DistillReader):
        dr = cls(ins=["x"], predicts=["p"], teacher_batch_size=16)
        assert (dr._tbs, dr._fixed, dr._max_teachers, dr._discovery) == (5, ["a:1", "b:2"], 3,
                                                                         None)
    monkeypatch.setenv("EDL_TPU_DISTILL_DISCOVERY", "d:1")
    monkeypatch.setenv("EDL_TPU_DISTILL_SERVICE_NAME", "svc")
    assert DistillReader(ins=["x"], predicts=["p"])._discovery == ("d:1", "svc")
    with pytest.raises(ValueError, match="not among ins"):
        DistillReader(ins=["x"], predicts=["p"], feeds=["y"])


def test_teacher_server_gives_its_thread_an_indexed_card(monkeypatch):
    """``device="cuda"`` names the constructing thread's current card: the
    inference thread sets that index (``set_device`` takes no index-less
    device, and a fresh thread's own current card is 0)."""
    import torch

    seen = []
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: seen.append(torch.device(d)))
    server = TeacherServer(linear, host="127.0.0.1", device="cuda")
    try:
        wait_for(lambda: seen)
    finally:
        server.stop()
    assert seen == [torch.device("cuda", 3)]


def test_teacher_server_refuses_requests_when_its_thread_cannot_start(monkeypatch):
    """An inference thread that cannot enter its device stops the server:
    requests fail (retryably) instead of waiting forever."""
    import torch

    from edl_tpu_torch.distill.predict_client import TeacherClient
    from edl_tpu_torch.utils.exceptions import EdlUnavailableError

    def refuse(_device):
        raise ValueError("no such card")

    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_device", refuse)
    server = TeacherServer(linear, host="127.0.0.1", device="cuda")
    client = TeacherClient(server.endpoint, ["logits"], timeout=10, first_timeout=10)
    try:
        wait_for(lambda: server._stopping)
        with pytest.raises(ConnectionError, match=EdlUnavailableError.__name__ + "|stopping"):
            client.predict({"x": np.ones((2, 3), np.float32)})
    finally:
        client.close()
        server.stop()


def test_discovery_client_follows_a_redirect(tkv):
    """Two discovery servers share the ring; a client that asks the one
    that does not own its service is redirected to the owner and gets its
    teachers from there."""
    servers = [DiscoveryServer(tkv, host="127.0.0.1", ttl=2.0) for _ in range(2)]
    teacher = TeacherServer(linear, host="127.0.0.1").register(tkv, "r-svc", ttl=2.0)
    client = None
    try:
        for s in servers:
            s._table._refresh_ring()
        owner = servers[0]._table.owner_of("r-svc")
        other = next(s for s in servers if s.endpoint != owner)
        client = DiscoveryClient(other.endpoint, "r-svc", heartbeat_period=0.2).start()
        wait_for(lambda: client.servers() == [teacher.endpoint])
        owning = next(s for s in servers if s.endpoint == owner)
        assert owning._table.service("r-svc").is_registered(client.client_id)
        assert "r-svc" not in other._table._services
    finally:
        if client is not None:
            client.stop()
        teacher.stop()
        for s in servers:
            s.stop()


def test_discovery_cli_serves_until_sigterm(coord_server, tmp_path):
    """``python -m edl_tpu_torch.distill.discovery`` on the JAX coordination
    server: it announces its endpoint, answers the JAX discovery client,
    and exits 0 on SIGTERM."""
    import os
    import signal
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ep = f"127.0.0.1:{coord_server.port}"
    out = tmp_path / "discovery.log"
    env = {k: v for k, v in os.environ.items() if not k.startswith("EDL_TPU_")}
    env.update(PYTHONPATH=root, EDL_TPU_HOST_IP="127.0.0.1")
    with open(out, "w") as f:
        proc = subprocess.Popen([sys.executable, "-m", "edl_tpu_torch.distill.discovery",
                                 "--coord_endpoints", ep], cwd=root, env=env, stdout=f,
                                stderr=subprocess.STDOUT)
    store = CoordClient(ep)
    teacher = TeacherServer(linear, host="127.0.0.1").register(store, "cli-svc", ttl=2.0)
    client = None
    try:
        line = wait_for(lambda: next((ln for ln in out.read_text().splitlines()
                                      if "[discovery] serving on" in ln), None))
        endpoint = line.split("serving on")[1].strip()
        client = JaxDiscoveryClient(endpoint, "cli-svc", heartbeat_period=0.2).start()
        wait_for(lambda: client.servers() == [teacher.endpoint])
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0, out.read_text()[-2000:]
    finally:
        if client is not None:
            client.stop()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        teacher.stop()
        store.close()
