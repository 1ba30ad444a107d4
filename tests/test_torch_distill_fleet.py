"""Teacher fleets as serving jobs in the port (``distill/fleet.py``,
``distill/backlog.py``, ``cluster/scale.py``), the cases of
``tests/test_distill_fleet.py:141-390`` on the port's ``MemoryKV``: a
teacher's advert on a shared session, a replica's two adverts on one
lease, the fleet's filter and least-loaded pick, a routed predict's
failover and hedge, a student surviving a teacher's death exactly once,
the feed's accounting, cleanup and backlog record, and torn records
skipped.  Across the packages: a JAX ``DistillReader`` through a port
fleet and a port reader through a JAX one, the JAX ``DistillAutoscaler``
stepping its target on the port's backlog record, the JAX controller's job
view counting the port's replica adverts, and the scale records byte for
byte both ways."""

import json
import time

import numpy as np
import pytest

from edl_tpu.cluster import scale as jscale
from edl_tpu.coord.memory import MemoryKV as JMemoryKV
from edl_tpu.distill import reader as jreader
from edl_tpu.distill.fleet import DistillFleet as JDistillFleet
from edl_tpu.distill.fleet import TeacherReplica as JTeacherReplica
from edl_tpu.distill.reader import DistillReader as JDistillReader
from edl_tpu.distill.teacher import TeacherServer as JTeacherServer
from edl_tpu_torch.cluster import paths, scale
from edl_tpu_torch.coord.memory import MemoryKV
from edl_tpu_torch.coord.session import CoordSession
from edl_tpu_torch.distill import reader as reader_mod
from edl_tpu_torch.distill.backlog import StudentFeed
from edl_tpu_torch.distill.balance import server_key
from edl_tpu_torch.distill.fleet import DISTILL_SERVICE_CLASS, DistillFleet, TeacherReplica
from edl_tpu_torch.distill.reader import DistillReader
from edl_tpu_torch.distill.teacher import TeacherServer
from edl_tpu_torch.gateway import fleet as gw_fleet
from edl_tpu_torch.utils import constants
from tests.test_torch_distill import sample_list_gen


@pytest.fixture
def kv():
    store = MemoryKV(sweep_period=0.1)
    yield store
    store.close()


def _wait_until(cond, timeout: float, period: float = 0.05) -> float:
    t0 = time.monotonic()
    while not cond():
        assert time.monotonic() < t0 + timeout, "condition not met in time"
        time.sleep(period)
    return time.monotonic() - t0


def double(feed):
    time.sleep(0.02)                   # slow enough for a teacher to die mid-epoch
    return {"prediction": feed["x"] * 2.0}


def _check_doubled(batches, n_batches, bs):
    assert len(batches) == n_batches
    ids = np.concatenate([b[1] for b in batches])
    np.testing.assert_array_equal(ids, np.arange(n_batches * bs))
    preds = np.concatenate([b[2] for b in batches])
    np.testing.assert_allclose(preds[:, 0], np.arange(n_batches * bs) * 2.0)


# -- teacher adverts on one shared session ---------------------------------------

def test_teacher_advert_rides_shared_session(kv):
    server = TeacherServer(lambda feed: {"p": feed["x"]}, host="127.0.0.1")
    session = CoordSession(kv, ttl=1.0, name="test-teacher")
    try:
        server.register(kv, "shared-svc", session=session, advert_period=60.0)
        rec = kv.get(server_key("shared-svc", server.endpoint))
        assert rec is not None and rec.lease_id == session.lease_id
        stats = json.loads(rec.value.decode())
        assert stats["endpoint"] == server.endpoint
        assert "queue_depth" in stats and "rows_per_s" in stats
        session.abandon()              # the process's keep-alive dies: the advert expires
        _wait_until(lambda: kv.get(server_key("shared-svc", server.endpoint)) is None, 3.0)
    finally:
        server.stop()
        session.close()


def test_teacher_replica_dual_advert_one_lease(kv):
    server = TeacherServer(lambda feed: {"p": feed["x"]}, host="127.0.0.1")
    replica = TeacherReplica(kv, "teachjob", server, "dual-svc", ttl=1.0, advert_period=60.0)
    try:
        reps = gw_fleet.list_replicas(kv, "teachjob")
        payload = reps[replica.replica_id]
        assert payload["service_class"] == DISTILL_SERVICE_CLASS
        assert payload["endpoint"] == server.endpoint
        balance = kv.get(server_key("dual-svc", server.endpoint))
        node = kv.get(gw_fleet.node_key("teachjob", replica.replica_id))
        assert balance.lease_id == node.lease_id == replica._coord_session.lease_id
        replica._halt.set()
        server._advert_halt.set()
        replica._coord_session.abandon()
        _wait_until(lambda: not gw_fleet.list_replicas(kv, "teachjob")
                    and kv.get(server_key("dual-svc", server.endpoint)) is None, 3.0)
    finally:
        replica.stop()


# -- DistillFleet routing --------------------------------------------------------

def _advert(kv, job, rid, ep, queue_depth=0, service="svc",
            service_class=DISTILL_SERVICE_CLASS, draining=False, ttl=5.0):
    return gw_fleet.advertise(kv, job, rid, {"endpoint": ep, "service": service,
                                             "service_class": service_class,
                                             "queue_depth": queue_depth,
                                             "draining": draining}, ttl=ttl)


def test_fleet_filters_and_picks_least_loaded(kv):
    regs = [_advert(kv, "fl", "t1", "t1:1", queue_depth=4),
            _advert(kv, "fl", "t2", "t2:2", queue_depth=1),
            _advert(kv, "fl", "lm", "lm:3", service_class="lm"),
            _advert(kv, "fl", "t3", "t3:4", queue_depth=0, draining=True)]
    fleet = DistillFleet(kv, "fl", period=0.05)
    try:
        assert fleet.wait_for(2, timeout=3.0)
        assert set(fleet.teachers()) == {"t1", "t2"}
        assert fleet.counts["teachers"] == 2
        assert fleet.pick() == "t2:2"
        fleet.drop("t2:2")
        assert fleet.pick() == "t1:1"
        assert fleet.endpoints() == ["t1:1"]
    finally:
        fleet.stop()
        for r in regs:
            r.stop()


class _Client:
    def __init__(self, ep, slow="", dead=""):
        self.ep, self.slow, self.dead = ep, slow, dead

    def predict(self, feed):
        if self.ep == self.dead:
            raise ConnectionError("teacher gone")
        if self.ep == self.slow:
            time.sleep(1.5)
        return {"from": self.ep}

    def close(self):
        pass


def test_fleet_routed_predict_fails_over(kv):
    regs = [_advert(kv, "fo", "t1", "dead:1", queue_depth=0),
            _advert(kv, "fo", "t2", "live:2", queue_depth=3)]
    fleet = DistillFleet(kv, "fo", period=0.05)
    try:
        assert fleet.wait_for(2, timeout=3.0)
        out = fleet.predict({"x": 1}, ["from"], retries=2,
                            client_factory=lambda ep: _Client(ep, dead="dead:1"))
        assert out == {"from": "live:2"}
        assert "dead:1" not in fleet.endpoints()
        assert fleet.counts["retries"] == 1
    finally:
        fleet.stop()
        for r in regs:
            r.stop()


def test_fleet_hedged_predict_backup_wins(kv):
    regs = [_advert(kv, "hg", "t1", "slow:1", queue_depth=0),
            _advert(kv, "hg", "t2", "fast:2", queue_depth=1)]
    fleet = DistillFleet(kv, "hg", period=0.05)
    try:
        assert fleet.wait_for(2, timeout=3.0)
        t0 = time.monotonic()
        out = fleet.predict({"x": 1}, ["from"], hedge_after_s=0.05,
                            client_factory=lambda ep: _Client(ep, slow="slow:1"))
        assert out == {"from": "fast:2"} and time.monotonic() - t0 < 1.0
        assert fleet.counts["hedges"] == 1
    finally:
        fleet.stop()
        for r in regs:
            r.stop()


# -- the fleet-backed student, a teacher's death mid-epoch ------------------------

def _kill(replica):
    """A SIGKILL as the store and the students see it: no more adverts, no
    server, a keep-alive that stops."""
    replica._halt.set()
    replica.server._advert_halt.set()
    replica.server._rpc.stop()
    replica._coord_session.abandon()


def _read_through(reader_cls, servers_fn, victim, n_batches=20, bs=3):
    dr = reader_cls(ins=["x", "idx"], predicts=["prediction"], feeds=["x"],
                    teacher_batch_size=bs)
    dr.set_sample_list_generator(sample_list_gen(n_batches, bs))
    dr.set_servers_fn(servers_fn)
    dr._pool_kw = {"manage_period": 0.2, "no_teacher_timeout": 20.0}
    batches = []
    for i, batch in enumerate(dr()):
        batches.append(batch)
        if i == 2 and victim is not None:
            _kill(victim)
    return batches


def test_student_survives_teacher_sigkill_exactly_once(kv, monkeypatch):
    monkeypatch.setattr(reader_mod, "_NOP_PREDICT_TEST", False)
    replicas = [TeacherReplica(kv, "ek", TeacherServer(double, host="127.0.0.1"), "ek-svc",
                               replica_id=f"t{i}", ttl=1.0, advert_period=0.2)
                for i in range(2)]
    fleet = DistillFleet(kv, "ek", period=0.1)
    try:
        assert fleet.wait_for(2, timeout=5.0)
        _check_doubled(_read_through(DistillReader, fleet.endpoints_fn(), replicas[0]), 20, 3)
    finally:
        for r in replicas:
            r.stop()


# -- StudentFeed and the backlog record ----------------------------------------

def test_student_feed_accounting_and_cleanup(kv, monkeypatch):
    monkeypatch.setattr(reader_mod, "_NOP_PREDICT_TEST", True)
    n_batches, bs = 8, 4
    dr = DistillReader(ins=["x", "idx"], predicts=["prediction"], feeds=["x"],
                       teacher_batch_size=3)
    dr.set_fixed_teacher("t1", "t2")
    dr.set_sample_list_generator(sample_list_gen(n_batches, bs))
    dr._pool_kw = {"manage_period": 0.05}
    feed = StudentFeed(kv, "teachjob", dr, student_id="s1", period=0.05)
    batches = list(feed)
    assert len(batches) == n_batches
    assert feed.submitted_rows == feed.consumed_rows == n_batches * bs
    assert feed.backlog_rows() == 0
    assert scale.load_backlogs(kv, "teachjob") == {}


def test_student_feed_publishes_backlog_record(kv, monkeypatch):
    monkeypatch.setattr(reader_mod, "_NOP_PREDICT_TEST", True)
    dr = DistillReader(ins=["x", "idx"], predicts=["prediction"], feeds=["x"])
    dr.set_fixed_teacher("t1")
    dr.set_sample_list_generator(sample_list_gen(2, 2))
    feed = StudentFeed(kv, "teachjob", dr, student_id="s2", period=60.0)
    feed.submitted_rows, feed.consumed_rows = 30, 10
    feed._publish_once(now=100.0)
    recs = scale.load_backlogs(kv, "teachjob")
    assert recs["s2"]["queued_rows"] == 20 and recs["s2"]["rows_per_s"] == 0.0
    feed.consumed_rows = 30
    feed._publish_once(now=101.0)
    recs = scale.load_backlogs(kv, "teachjob")
    assert recs["s2"]["queued_rows"] == 0
    assert recs["s2"]["rows_per_s"] == pytest.approx(20.0)
    assert feed.observed_rows_per_s() == pytest.approx(20.0)


def test_load_backlogs_skips_torn_records(kv):
    scale.save_backlog(kv, "tj", "good", 5, 1.0)
    kv.put(paths.key("tj", constants.ETCD_SCALE, "backlog/torn"), b"{not json")
    recs = scale.load_backlogs(kv, "tj")
    assert set(recs) == {"good"} and recs["good"]["queued_rows"] == 5


# -- across the packages ---------------------------------------------------------

def test_jax_reader_through_a_port_fleet(kv, monkeypatch):
    monkeypatch.setattr(jreader, "_NOP_PREDICT_TEST", False)
    replicas = [TeacherReplica(kv, "xp", TeacherServer(double, host="127.0.0.1"), "xp-svc",
                               replica_id=f"t{i}", ttl=1.0, advert_period=0.2)
                for i in range(2)]
    fleet = DistillFleet(kv, "xp", period=0.1)
    try:
        assert fleet.wait_for(2, timeout=5.0)
        _check_doubled(_read_through(JDistillReader, fleet.endpoints_fn(), replicas[0]), 20, 3)
    finally:
        for r in replicas:
            r.stop()


def test_port_reader_through_a_jax_fleet(monkeypatch):
    """JAX replicas behind a JAX fleet on the JAX store: the port's reader
    reads through it, and the port's fleet sees the same teachers."""
    monkeypatch.setattr(reader_mod, "_NOP_PREDICT_TEST", False)
    jkv = JMemoryKV(sweep_period=0.1)
    replicas = [JTeacherReplica(jkv, "px", JTeacherServer(double, host="127.0.0.1"), "px-svc",
                                replica_id=f"t{i}", ttl=1.0, advert_period=0.2)
                for i in range(2)]
    jfleet = JDistillFleet(jkv, "px", period=0.1)
    port_fleet = DistillFleet(jkv, "px", period=0.1)
    try:
        assert jfleet.wait_for(2, timeout=5.0) and port_fleet.wait_for(2, timeout=5.0)
        assert port_fleet.teachers() == jfleet.teachers()
        _check_doubled(_read_through(DistillReader, jfleet.endpoints_fn(), replicas[0]), 20, 3)
    finally:
        port_fleet.stop()
        for r in replicas:
            r.stop()
        jkv.close()


def test_jax_autoscaler_steps_on_the_ports_backlog_record(kv, monkeypatch):
    """The JAX DistillAutoscaler reads the backlog record a port feed wrote:
    grow after the held window, decay after the feed's stop cleared it."""
    from edl_tpu.controller.autoscale import DistillAutoscaler

    monkeypatch.setattr(reader_mod, "_NOP_PREDICT_TEST", True)
    dr = DistillReader(ins=["x", "idx"], predicts=["prediction"], feeds=["x"])
    dr.set_fixed_teacher("t1")
    dr.set_sample_list_generator(sample_list_gen(2, 2))
    feed = StudentFeed(kv, "tj", dr, student_id="s1", period=60.0)
    feed.submitted_rows = 100                      # 100 rows queued, no rate yet
    feed._publish_once(now=0.0)
    a = DistillAutoscaler(kv, step=1, grow_s=5.0, hold_s=10.0, quiet_s=30.0, demand_ttl=120.0)
    assert a.backlog_seconds("tj") == pytest.approx(100.0)
    assert a.desired("tj", 1, 3, 1, now=0.0) == 1
    assert a.desired("tj", 1, 3, 1, now=10.0) == 2
    assert a.desired("tj", 1, 3, 2, now=20.0) == 3
    feed.stop()
    assert a.backlog_seconds("tj") is None
    assert a.desired("tj", 1, 3, 3, now=51.0) == 2


def test_jax_controller_counts_the_ports_replica_adverts(kv):
    from edl_tpu.controller.autoscale import DistillAutoscaler
    from edl_tpu.controller.controller import Controller

    scale.save_nodes_range(kv, "teach", 1, 3)
    scale.save_job_spec(kv, "teach", kind="distill", fleet=True)
    replicas = [TeacherReplica(kv, "teach", TeacherServer(double, host="127.0.0.1"), "teach-svc",
                               replica_id=f"t{i}", advert_period=60.0) for i in range(2)]
    scale.save_backlog(kv, "teach", "s1", 500, 1.0)
    ctrl = Controller(kv, job_ids=["teach"], distill_autoscaler=DistillAutoscaler(
        kv, step=1, grow_s=1.0, hold_s=0.0, quiet_s=60.0))
    try:
        view = ctrl.job_view("teach")
        assert view.kind == "distill" and view.priority == 50
        assert view.current_nodes == 2
        assert view.demand == 3
    finally:
        for r in replicas:
            r.stop()


def _scale_writes(mod, store, monkeypatch):
    monkeypatch.setattr(mod.time, "time", lambda: 1700000000.25)
    mod.save_desired_nodes(store, "sj", 3, by="ctl")
    mod.save_nodes_range(store, "sj", 1, 4)
    mod.save_job_spec(store, "sj", kind="distill", priority=7, gang=True, fleet=True)
    mod.save_job_spec(store, "sk")
    mod.save_demand(store, "sj", 5, reason="alert")
    mod.save_backlog(store, "sj", "stu", 42, 2.5)


def test_scale_records_are_byte_equal_both_ways(monkeypatch):
    """Each record the port writes is the JAX package's to the byte, and
    each package's loaders read the other's records."""
    stores = {"port": MemoryKV(sweep_period=0.1), "jax": MemoryKV(sweep_period=0.1)}
    try:
        with monkeypatch.context() as m:
            _scale_writes(scale, stores["port"], m)
        with monkeypatch.context() as m:
            _scale_writes(jscale, stores["jax"], m)
        recs = {name: {r.key: r.value for r in kv.get_prefix("/edl_tpu/")[0]}
                for name, kv in stores.items()}
        assert len(recs["port"]) == 6 and recs["port"] == recs["jax"]
        for writer, reader in ((stores["port"], jscale), (stores["jax"], scale)):
            assert reader.load_desired_nodes(writer, "sj") == 3
            assert reader.load_nodes_range(writer, "sj") == (1, 4)
            assert reader.load_job_spec(writer, "sj") == {"kind": "distill", "gang": True,
                                                          "priority": 7, "fleet": True}
            assert reader.load_demand(writer, "sj")["replicas"] == 5
            assert reader.load_backlogs(writer, "sj")["stu"]["queued_rows"] == 42
        for name, mod in (("port", scale), ("jax", jscale)):
            other = stores["jax" if name == "port" else "port"]
            mod.clear_desired_nodes(other, "sj")
            mod.clear_demand(other, "sj")
            mod.clear_backlog(other, "sj", "stu")
            assert other.get(paths.key("sj", constants.ETCD_SCALE, "desired")) is None
            assert scale.load_demand(other, "sj") is None and scale.load_backlogs(other, "sj") == {}
    finally:
        for kv in stores.values():
            kv.close()
