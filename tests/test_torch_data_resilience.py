"""Fault tolerance of the port's data plane, the cases of
``tests/test_data_resilience.py``: the resilient client's budget and its
abort after a reattach, a reader riding out transient transport faults,
the bounded reader shutdown, and the reader registry's wait (by watch, by
polling, on timeout), with the registry's records read across the
packages; the port's in-process store (``coord/memory.py``) against the
JAX one; and the twelve cases that build a ``DataJournal``
(``data/journal.py``): a successor rebuilt minus what was consumed,
idempotent report, ack and grant, an ack replayed on a rebuilt leader, the
rebuild grace, a reattach restoring held batches and the producer, repairs
pending behind a live owner, a requeue keeping a live owner journaled, the
GC tombstone across a failover, pod death and reconcile, a reader
reattaching across a leader restart, and the drain on a successor.  A
journal written by either package is rebuilt by the other's service."""

import random
import threading
import time

import pytest

from edl_tpu.coord.memory import MemoryKV as JMemoryKV
from edl_tpu.data import register_reader as j_register_reader
from edl_tpu.data import wait_dist_readers as j_wait_dist_readers
from edl_tpu.data.data_server import DataService as JDataService
from edl_tpu.data.journal import DataJournal as JDataJournal
from edl_tpu_torch.coord.memory import MemoryKV
from edl_tpu_torch.data import resilient as resilient_mod
from edl_tpu_torch.data.data_server import DataService, PodDataServer
from edl_tpu_torch.data.distribute_reader import DistributedReader
from edl_tpu_torch.data.journal import DataJournal
from edl_tpu_torch.data.registry import register_reader, wait_dist_readers
from edl_tpu_torch.data.resilient import CallAborted, ResilientDataClient
from edl_tpu_torch.rpc.client import RpcClient
from edl_tpu_torch.rpc.server import RpcServer
from edl_tpu_torch.utils.exceptions import (
    EdlCoordError, EdlDataError, EdlReaderGoneError, EdlStopIteration,
)
from tests.helpers.exactly_once import audit_spans

ALL = sorted(f"f{f}r{r}" for f in range(4) for r in range(10))


@pytest.fixture
def files(tmp_path):
    paths = []
    for f in range(4):
        p = tmp_path / f"part-{f}.txt"
        p.write_text("".join(f"f{f}r{r}\n" for r in range(10)))
        paths.append(str(p))
    return paths


@pytest.fixture
def kv():
    store = MemoryKV(sweep_period=0.1)
    yield store
    store.close()


def test_reader_survives_transient_faults(files, monkeypatch):
    """Transport errors on 30% of the leader calls, below the retry
    deadline, cause no reader failure: every record once."""
    rng = random.Random(7)
    injected = []

    class Flaky(RpcClient):
        def call(self, method, _timeout=None, **kwargs):
            if (method in ("get_batch_meta", "next_file", "report_batch_meta")
                    and rng.random() < 0.3):
                injected.append(method)
                raise EdlCoordError(f"injected fault on {method}")
            return super().call(method, _timeout=_timeout, **kwargs)

    monkeypatch.setattr(resilient_mod, "RpcClient", Flaky)
    a = PodDataServer("podA", is_leader=True)
    try:
        ra = DistributedReader("rf", "podA", a.endpoint, a, batch_size=4)
        ra.create(files)
        got, spans = [], []
        for _bid, payload in ra:
            got.extend(payload["records"])
            spans.extend(payload["spans"])
        assert sorted(got) == ALL
        audit_spans(spans, 4, 10)
        assert injected, "a 30% fault rate must have exercised the retries"
    finally:
        a.stop()


def test_resilient_client_raises_after_budget():
    client = ResilientDataClient("127.0.0.1:1", timeout=0.2, retry_deadline=0.8)
    t0 = time.monotonic()
    with pytest.raises(EdlCoordError):
        client.call("reader_status", reader="x")
    assert time.monotonic() - t0 < 10.0
    client.close()


def test_call_aborted_after_reattach_abandon():
    """A leader failover mid-report triggers a reattach on the retry; when
    that reattach learns the file was re-granted elsewhere (the abandon
    flag), the retried report is not delivered to the successor."""
    delivered = []
    srv = RpcServer("127.0.0.1", 0)
    srv.register("report_batch_meta", lambda **kw: (delivered.append(kw), {"backlog": 0})[1])
    srv.start()
    abandoned = threading.Event()
    eps = iter(["127.0.0.1:1", f"127.0.0.1:{srv.port}"])
    last = {"ep": "127.0.0.1:1"}

    def resolver():
        last["ep"] = next(eps, last["ep"])
        return last["ep"]

    client = ResilientDataClient(resolver, timeout=0.5, retry_deadline=10.0,
                                 on_reattach=lambda raw_call: abandoned.set(),
                                 name="abort-test")
    try:
        with pytest.raises(CallAborted):
            client.call("report_batch_meta", reader="r", pod_id="p", endpoint="e",
                        batches=[["b0", [[0, 0, 4]]]], _abort_if=abandoned.is_set)
        assert delivered == []
    finally:
        client.close()
        srv.stop()


def test_close_bounds_stuck_producer(files):
    """A producer blocked in a leader call does not outlive close(): the stop
    flag and the capped call budget unwind it."""
    srv = RpcServer("127.0.0.1", 0)
    release = threading.Event()

    def slow_next_file(reader, pod_id):
        release.wait(30.0)  # a leader that never answers in time
        return {"file": None, "skip": [], "eof": True}

    svc = DataService()
    svc.create_reader("rc", files[:1])
    srv.register_instance(svc)
    srv.register("next_file", slow_next_file)
    srv.start()
    cache = PodDataServer("podA")
    try:
        ra = DistributedReader("rc", "podA", f"127.0.0.1:{srv.port}", cache, batch_size=4)
        ra._files = files[:1]
        ra._producer = threading.Thread(target=ra._produce, daemon=True)
        ra._producer.start()
        time.sleep(0.3)  # the producer now waits inside next_file
        t0 = time.monotonic()
        ra.close(deadline=1.0)
        assert time.monotonic() - t0 < 5.0
    finally:
        release.set()
        cache.stop()
        srv.stop()


# -- the reader registry ------------------------------------------------------------

def test_wait_dist_readers_watch_reacts_fast(kv):
    reg_a = register_reader(kv, "jw", "r", "podA", "epA")
    done = {}

    def waiter():
        t0 = time.monotonic()
        done["got"] = wait_dist_readers(kv, "jw", "r", ["podA", "podB"], timeout=10.0)
        done["took"] = time.monotonic() - t0

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.4)
    reg_b = register_reader(kv, "jw", "r", "podB", "epB")
    t.join(5.0)
    assert not t.is_alive() and done["got"] == {"podA": "epA", "podB": "epB"}
    assert done["took"] < 2.0, done
    reg_a.stop(), reg_b.stop()


def test_wait_dist_readers_falls_back_to_polling(kv):
    class NoWatch:
        """A store whose watch path is missing (an old server)."""

        def __init__(self, store):
            self._store = store

        def get_prefix(self, prefix):
            return self._store.get_prefix(prefix)

        def wait(self, prefix, since_revision, timeout):
            raise NotImplementedError("old server")

    reg = register_reader(kv, "jp", "r", "podA", "epA")
    assert wait_dist_readers(NoWatch(kv), "jp", "r", ["podA"], timeout=5.0) == {"podA": "epA"}
    reg.stop()


def test_wait_dist_readers_timeout(kv):
    t0 = time.monotonic()
    with pytest.raises(EdlDataError):
        wait_dist_readers(kv, "jt", "r", ["ghost"], timeout=0.6)
    assert time.monotonic() - t0 < 5.0


def test_registry_records_cross_the_packages():
    """A pod that registered through one package is seen by the other's wait,
    on either package's store: the keys and the JSON are the same."""
    for store in (MemoryKV(sweep_period=0.1), JMemoryKV(sweep_period=0.1)):
        try:
            reg_a = register_reader(store, "jx", "r", "podA", "epA")
            reg_b = j_register_reader(store, "jx", "r", "podB", "epB")
            want = {"podA": "epA", "podB": "epB"}
            assert wait_dist_readers(store, "jx", "r", ["podA", "podB"], timeout=5.0) == want
            assert j_wait_dist_readers(store, "jx", "r", ["podA", "podB"], timeout=5.0) == want
            reg_a.stop(), reg_b.stop()
        finally:
            store.close()


def test_store_client_waits_on_the_jax_server(coord_server):
    """The port's store client long-polls the JAX coordination server: a put
    under the prefix wakes ``wait`` with that event, so the registry's wait
    reacts by watch there too, not by polling."""
    from edl_tpu_torch.coord.client import connect

    store = connect(f"127.0.0.1:{coord_server.port}")
    try:
        _, rev = store.get_prefix("/w/")
        timer = threading.Timer(0.3, lambda: store.put("/w/k", b"v"))
        timer.start()
        t0 = time.monotonic()
        res = store.wait("/w/", rev, 5.0)
        timer.join()
        assert [(e.type, e.record.key, e.record.value) for e in res.events] == [
            ("put", "/w/k", b"v")]
        assert time.monotonic() - t0 < 3.0 and res.revision > rev
    finally:
        store.close()


# -- the in-process store -----------------------------------------------------------

def test_memory_kv_leases_guards_and_wait():
    """Lease expiry deletes its keys; the guarded puts; ``wait`` returns the
    changes under its prefix, nothing at its timeout, and a full snapshot
    for a position from another store."""
    kv = MemoryKV(sweep_period=0.05)
    try:
        lease = kv.lease_grant(0.3)
        kv.put("/a/leased", b"1", lease)
        assert kv.put_if_absent("/a/seat", b"x") and not kv.put_if_absent("/a/seat", b"y")
        assert kv.put_if_equals("/a/seat", b"x", "/a/guarded", b"g")
        assert not kv.put_if_equals("/a/seat", b"y", "/a/guarded", b"h")
        recs, rev = kv.get_prefix("/a/")
        assert [r.key for r in recs] == ["/a/guarded", "/a/leased", "/a/seat"]
        assert kv.wait("/a/", rev, 0.1).events == []
        res = kv.wait("/a/", rev, 5.0)           # the lease expires meanwhile
        assert [(e.type, e.record.key) for e in res.events] == [("delete", "/a/leased")]
        assert kv.get("/a/leased") is None and not kv.lease_keepalive(lease)
        snap = kv.wait("/a/", res.revision + 10**6, 0.1)
        assert snap.snapshot and [e.record.key for e in snap.events] == ["/a/guarded", "/a/seat"]
        assert kv.delete("/a/seat") and not kv.delete("/a/seat")
        assert [r.key for r in kv.get_prefix("/a/")[0]] == ["/a/guarded"]
    finally:
        kv.close()


# -- the journal: a successor rebuilds the generation ------------------------------


def _serve(service) -> tuple[RpcServer, str]:
    srv = RpcServer("127.0.0.1", 0)
    srv.register_instance(service)
    srv.start()
    return srv, f"127.0.0.1:{srv.port}"


def test_journal_rebuild_minus_consumed(kv, files):
    journal = DataJournal(kv, "j1")
    a = DataService(journal=journal, rebuild_grace=0.0)
    a.create_reader("r@e0@s1", files, consumed=[[3, 0, 4]])
    assert a.next_file("r@e0@s1", "podA")["file"] == [0, files[0]]
    a.report_batch_meta("r@e0@s1", "podA", "127.0.0.1:1",
                        [["podA:0", [[0, 0, 4]]], ["podA:1", [[0, 4, 8]]]])
    a.file_done("r@e0@s1", "podA", 0)
    got = a.get_batch_meta("r@e0@s1", "podB", n=1)["metas"]
    assert got[0][2] == "podA:0"
    a.get_batch_meta("r@e0@s1", "podB", n=0, ack_ids=["podA:0"])

    b = DataService(journal=journal, rebuild_grace=0.0)   # the successor: a lazy rebuild
    st = b.reader_status("r@e0@s1")
    assert st["files"] == 4 and st["done"] == [0]
    assert st["consumed"]["0"] == [[0, 4]]       # the ack survived
    assert st["consumed"]["3"] == [[0, 4]]       # the restored checkpoint
    assert st["parked"] == 1                     # podA:1 awaits its consumer
    nxt = b.next_file("r@e0@s1", "podC")
    assert nxt["file"][0] in (1, 2, 3)
    if nxt["file"][0] == 3:
        assert nxt["skip"] == [[0, 4]]


def test_idempotent_report_ack_and_grant(kv, files):
    svc = DataService(journal=DataJournal(kv, "j2"))
    svc.create_reader("r", files[:1])
    first = svc.next_file("r", "podA")["file"]
    assert svc.next_file("r", "podA")["file"] == first     # a retried grant: the same file
    batches = [["podA:0", [[0, 0, 4]]]]
    svc.report_batch_meta("r", "podA", "ep", batches)
    svc.report_batch_meta("r", "podA", "ep", batches)
    assert svc.reader_status("r")["produced"] == 1
    svc.get_batch_meta("r", "podB", n=1)
    svc.get_batch_meta("r", "podB", n=0, ack_ids=["podA:0"])
    svc.get_batch_meta("r", "podB", n=0, ack_ids=["podA:0"])
    st = svc.reader_status("r")
    assert st["acked"] == 1 and st["consumed"]["0"] == [[0, 4]]


def test_ack_replay_lands_on_rebuilt_leader(kv, files):
    """An ack of a batch fetched from the old leader lands on the new one,
    and the acked batch is never handed out again after a second crash
    (the journal's tombstone keeps the dedup)."""
    journal = DataJournal(kv, "j3")
    a = DataService(journal=journal)
    a.create_reader("r", files[:1])
    a.next_file("r", "podA")
    a.report_batch_meta("r", "podA", "ep", [["podA:0", [[0, 0, 4]]]])
    a.get_batch_meta("r", "podB", n=1)
    b = DataService(journal=journal, rebuild_grace=10.0)
    b.get_batch_meta("r", "podB", n=0, ack_ids=["podA:0"])
    st = b.reader_status("r")
    assert st["parked"] == 0 and st["consumed"]["0"] == [[0, 4]]
    c = DataService(journal=journal, rebuild_grace=0.0)
    st = c.reader_status("r")
    assert st["parked"] == 0 and st["acked"] == 1
    c.report_batch_meta("r", "podA", "ep", [["podA:0", [[0, 0, 4]]]])
    assert c.reader_status("r")["queued"] == 0


def test_rebuild_grace_parks_then_releases(kv, files):
    journal = DataJournal(kv, "j4")
    a = DataService(journal=journal)
    a.create_reader("r", files[:1])
    a.next_file("r", "podA")
    a.report_batch_meta("r", "podA", "ep", [["podA:0", [[0, 0, 4]]]])
    a.get_batch_meta("r", "podX", n=1)
    b = DataService(journal=journal, rebuild_grace=0.6)
    assert b.get_batch_meta("r", "podY", n=4)["metas"] == []
    assert b.next_file("r", "podY")["file"] is None
    time.sleep(0.7)
    assert [m[2] for m in b.get_batch_meta("r", "podY", n=4)["metas"]] == ["podA:0"]
    assert b.next_file("r", "podY")["file"] is None
    assert b.next_file("r", "podA")["file"][0] == 0


def test_reattach_restores_held_and_producer(kv, files):
    journal = DataJournal(kv, "j5")
    a = DataService(journal=journal)
    a.create_reader("r", files[:2])
    assert a.next_file("r", "podA")["file"][0] == 0
    a.report_batch_meta("r", "podA", "ep", [["podA:0", [[0, 0, 4]]]])
    a.get_batch_meta("r", "podB", n=1)
    b = DataService(journal=journal, rebuild_grace=30.0)
    assert b.reattach_reader("r", "podB", held=["podA:0", "ghost"])["drop"] == ["ghost"]
    b.get_batch_meta("r", "podB", n=0, ack_ids=["podA:0"])
    assert b.reader_status("r")["consumed"]["0"] == [[0, 4]]
    assert not b.reattach_reader("r", "podA", producing=[0, None])["abandon_file"]
    assert b.next_file("r", "podA")["file"][0] == 0
    c = DataService(journal=journal, rebuild_grace=0.0)
    c.reattach_reader("r", "podA", producing=None, finished=[0])
    st = c.reader_status("r")
    assert 0 in st["done"] and st["owned"] == 0


def test_rebuild_pends_repairs_behind_live_whole_file_owner(kv, files):
    journal = DataJournal(kv, "jr1")
    a = DataService(journal=journal)
    a.create_reader("r", files[:1])
    a.next_file("r", "podX")
    a.report_batch_meta("r", "podX", "epX", [["podX:0", [[0, 0, 4]]]])
    a.get_batch_meta("r", "podA", n=1)
    a.mark_pod_dead("podX")
    assert a.next_file("r", "podB")["skip"] == [[0, 4]]
    a.nack_batches("r", "podA", ["podX:0"], producer_dead=True)
    assert a.reader_status("r")["pending"] == 1
    b = DataService(journal=journal, rebuild_grace=0.0)
    st = b.reader_status("r")
    assert st["owned"] == 1 and st["pending"] == 1, st
    b.file_done("r", "podB", 0)
    rep = b.next_file("r", "podC")
    assert rep["file"][0] == 0 and rep["only"] == [[0, 4]], rep


def test_requeue_keeps_live_owner_journaled(kv, files):
    journal = DataJournal(kv, "j9")
    a = DataService(journal=journal)
    a.create_reader("r", files[:1])
    a.next_file("r", "podX")
    a.report_batch_meta("r", "podX", "epX", [["podX:0", [[0, 0, 4]]]])
    a.get_batch_meta("r", "podC", n=1)
    a.mark_pod_dead("podX")
    assert a.next_file("r", "podB")["file"][0] == 0
    a.nack_batches("r", "podC", ["podX:0"], producer_dead=True)
    b = DataService(journal=journal, rebuild_grace=0.0)
    st = b.reader_status("r")
    assert st["owned"] == 1 and st["pending"] == 1, st
    assert b.next_file("r", "podB")["file"][0] == 0


def test_gcd_tombstone_survives_failover(kv, files):
    journal = DataJournal(kv, "jt")
    a = DataService(journal=journal)
    a.create_reader("t@e0@s", files[:1])
    a.create_reader("t@e1@s", files[:1])     # GCs t@e0@s and journals "dead"
    b = DataService(journal=journal, rebuild_grace=0.0)
    with pytest.raises(EdlDataError, match="superseded"):
        b.reattach_reader("t@e0@s", "podB", files=files[:1])
    assert b.reader_status("t@e1@s")["files"] == 1


def test_pod_death_event_rebuilds_lazily(kv, files):
    journal = DataJournal(kv, "jl")
    a = DataService(journal=journal)
    a.create_reader("r", files[:1])
    a.next_file("r", "podX")
    b = DataService(journal=journal, rebuild_grace=0.0)
    b.mark_pod_dead("podX", reader="r")
    st = b.reader_status("r")
    assert st["owned"] == 0 and st["pending"] == 1, st


def test_reconcile_requeues_pods_with_no_advert(kv, files):
    journal = DataJournal(kv, "jr2")
    a = DataService(journal=journal)
    a.create_reader("r", files[:2])
    a.next_file("r", "podX")
    b = DataService(journal=journal, rebuild_grace=0.0)
    assert b.reconcile_pods("r", ["podY"])["dead"] == ["podX"]
    st = b.reader_status("r")
    assert st["owned"] == 0 and st["pending"] == 2, st


def test_reader_reattaches_across_leader_restart(kv, files):
    """The leader's server dies mid-epoch and a successor on the same
    journal comes up elsewhere: the reader re-resolves, reattaches and
    finishes the epoch, every record exactly once."""
    journal = DataJournal(kv, "j6")
    cache = PodDataServer("podA")
    srv1, ep1 = _serve(DataService(journal=journal, rebuild_grace=1.0))
    endpoint = {"ep": ep1}
    srv2 = None
    try:
        ra = DistributedReader("rk", "podA", lambda: endpoint["ep"], cache, batch_size=4,
                               retry_deadline=30.0)
        ra.create(files)
        got, spans = [], []
        it = iter(ra)
        for _ in range(3):
            _bid, payload = next(it)
            got.extend(payload["records"])
            spans.extend(payload["spans"])
        srv1.stop()
        srv2, endpoint["ep"] = _serve(DataService(journal=journal, rebuild_grace=1.0))
        for _bid, payload in it:
            got.extend(payload["records"])
            spans.extend(payload["spans"])
        assert sorted(got) == ALL
        audit_spans(spans, 4, 10)
    finally:
        cache.stop()
        for s in (srv1, srv2):
            if s is not None:
                s.stop()


def test_drain_completes_on_successor(kv, files):
    journal = DataJournal(kv, "j8")
    a = DataService(journal=journal)
    a.create_reader("r", files[:1])
    a.next_file("r", "podA")
    a.report_batch_meta("r", "podA", "ep", [["podA:0", [[0, 0, 10]]]])
    a.file_done("r", "podA", 0)
    b = DataService(journal=journal, rebuild_grace=0.2)
    b.get_batch_meta("r", "podA", n=0, ack_ids=["podA:0"])
    time.sleep(0.25)
    with pytest.raises(EdlStopIteration):
        b.get_batch_meta("r", "podA", n=1)
    assert b.next_file("r", "podA")["eof"] is True


# -- the journal across the packages ---------------------------------------------


def _journaled_history(svc, files):
    """One generation's mutations: a create with a restored span, a grant, a
    report, a done, a consumed and acked batch, a second grant left open, a
    dead pod with a requeue, and a GC'd earlier generation."""
    svc.create_reader("g@e0@s", files[:1])
    svc.create_reader("g@e1@s", files, consumed=[[3, 0, 2]])   # GCs g@e0@s
    svc.next_file("g@e1@s", "podA")
    svc.report_batch_meta("g@e1@s", "podA", "epA", [["podA:0", [[0, 0, 4]]],
                                                     ["podA:1", [[0, 4, 8]]]])
    svc.file_done("g@e1@s", "podA", 0)
    svc.get_batch_meta("g@e1@s", "podB", n=1)
    svc.get_batch_meta("g@e1@s", "podB", n=0, ack_ids=["podA:0"])
    svc.next_file("g@e1@s", "podX")
    svc.next_file("g@e1@s", "podY")
    svc.mark_pod_dead("podY")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_journal_is_rebuilt_across_the_packages(writer, files):
    """A journal written by one package's service is rebuilt by the
    other's, to the same generation state as its own package's rebuild,
    and both packages' journals hold the same records; the GC tombstone
    holds across."""
    stores = {"jax": JMemoryKV(sweep_period=0.1), "port": MemoryKV(sweep_period=0.1)}
    journals = {"jax": lambda kv: JDataJournal(kv, "jx"), "port": lambda kv: DataJournal(kv, "jx")}
    services = {"jax": JDataService, "port": DataService}
    try:
        for name, kv in stores.items():
            _journaled_history(services[name](journal=journals[name](kv)), files)
        records = {name: {r.key: r.value for r in kv.get_prefix("/edl_tpu/jx/")[0]}
                   for name, kv in stores.items()}
        assert records["jax"] == records["port"]
        kv = stores[writer]
        other = "port" if writer == "jax" else "jax"
        assert journals[other](kv).load("g@e1@s") == journals[writer](kv).load("g@e1@s")
        assert journals[other](kv).list_readers() == ["g@e1@s"]
        same = services[writer](journal=journals[writer](kv), rebuild_grace=0.0)
        cross = services[other](journal=journals[other](kv), rebuild_grace=0.0)
        status = [{k: v for k, v in svc.reader_status("g@e1@s").items() if k != "inc"}
                  for svc in (cross, same)]      # "inc": each service's own incarnation
        assert status[0] == status[1]
        assert cross.reader_status("g@e1@s")["consumed"] == {"0": [[0, 4]], "3": [[0, 2]]}
        with pytest.raises(Exception, match="superseded"):
            cross.reattach_reader("g@e0@s", "podB", files=files[:1])
        # the rebuilt generation drains on the other package's service
        nxt = cross.next_file("g@e1@s", "podC")
        assert nxt["file"] is not None
    finally:
        for kv in stores.values():
            kv.close()
