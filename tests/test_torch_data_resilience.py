"""Fault tolerance of the port's data plane, the cases of
``tests/test_data_resilience.py`` that need no journal: the resilient
client's budget and its abort after a reattach, a reader riding out
transient transport faults, the bounded reader shutdown, and the reader
registry's wait (by watch, by polling, on timeout), with the registry's
records read across the packages; and the port's in-process store
(``coord/memory.py``) against the JAX one.  The journal cases wait for
``data/journal.py`` (ROADMAP.md Queue 1 item 5)."""

import random
import threading
import time

import pytest

from edl_tpu.coord.memory import MemoryKV as JMemoryKV
from edl_tpu.data import register_reader as j_register_reader
from edl_tpu.data import wait_dist_readers as j_wait_dist_readers
from edl_tpu_torch.coord.memory import MemoryKV
from edl_tpu_torch.data import resilient as resilient_mod
from edl_tpu_torch.data.data_server import DataService, PodDataServer
from edl_tpu_torch.data.distribute_reader import DistributedReader
from edl_tpu_torch.data.registry import register_reader, wait_dist_readers
from edl_tpu_torch.data.resilient import CallAborted, ResilientDataClient
from edl_tpu_torch.rpc.client import RpcClient
from edl_tpu_torch.rpc.server import RpcServer
from edl_tpu_torch.utils.exceptions import EdlCoordError, EdlDataError
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
