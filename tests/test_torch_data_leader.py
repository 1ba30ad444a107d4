"""The port's standalone elected data leader (``data/leader.py``): the
seat's election and a successor after the winner's stop, candidates of
both packages contending for one seat, ``resolve_data_leader`` raising
while the seat is empty, a stop that drains the op in flight before it
frees the seat, a port ``DistributedReader`` riding a leader
failover (port to port, and JAX to port on one journal) to exactly-once
delivery, and a JAX reader against the port's leader.  Every leader runs
in a thread of the test's process, on an in-process store."""

import threading
import time

import pytest

from edl_tpu.data import DistributedReader as JDistributedReader
from edl_tpu.data import PodDataServer as JPodDataServer
from edl_tpu.data.leader import DataLeaderHost as JDataLeaderHost
from edl_tpu.data.leader import resolve_data_leader as j_resolve_data_leader
from edl_tpu_torch.coord.memory import MemoryKV
from edl_tpu_torch.data.data_server import PodDataServer
from edl_tpu_torch.data.distribute_reader import DistributedReader
from edl_tpu_torch.data.leader import DataLeaderHost, resolve_data_leader
from edl_tpu_torch.data.registry import register_reader
from edl_tpu_torch.utils.exceptions import EdlCoordError
from tests.helpers.exactly_once import audit_spans

JOB = "leader-job"
TTL = 1.0
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


def _start(host):
    t = threading.Thread(target=host.run, daemon=True)
    t.start()
    return t


def _wait_seated(hosts, timeout=10.0):
    """The one host of ``hosts`` that holds the seat (and the others none)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        seated = [h for h in hosts if h.service is not None]
        if seated:
            assert len(seated) == 1, "two candidates seated at once"
            return seated[0]
        time.sleep(0.02)
    raise AssertionError("no candidate took the seat")


def _candidate(kv, package="port"):
    cls = DataLeaderHost if package == "port" else JDataLeaderHost
    return cls(kv, JOB, host="127.0.0.1", ttl=TTL, rebuild_grace=0.5, retry_period=0.05)


def test_resolve_raises_while_the_seat_is_empty(kv):
    with pytest.raises(EdlCoordError, match="no data leader"):
        resolve_data_leader(kv, JOB)


def test_stop_drains_an_op_in_flight_before_freeing_the_seat(kv, files, monkeypatch):
    """A stop while a handler is inside a journal write: the seat stays
    held and later ops are refused until that write lands; then the seat
    is freed and the write is in the journal a successor rebuilds from.
    Freeing the seat first, or stopping the server and then freeing it,
    lets the write land after a successor has rebuilt."""
    from edl_tpu_torch.data.journal import DataJournal
    from edl_tpu_torch.rpc.client import RpcClient

    entered, release = threading.Event(), threading.Event()
    grant = DataJournal.grant

    def held_grant(self, *args, **kwargs):
        entered.set()
        release.wait(10.0)
        return grant(self, *args, **kwargs)

    monkeypatch.setattr(DataJournal, "grant", held_grant)
    host = _candidate(kv)
    thread = _start(host)
    try:
        _wait_seated([host])
        endpoint = host.endpoint
        RpcClient(endpoint, 10.0).call("create_reader", reader="g@e0", files=files)
        answer = {}
        caller = threading.Thread(target=lambda: answer.update(
            RpcClient(endpoint, 10.0).call("next_file", reader="g@e0", pod_id="podA")))
        caller.start()
        assert entered.wait(5.0)
        host.stop()
        time.sleep(0.5)
        assert thread.is_alive() and resolve_data_leader(kv, JOB) == endpoint
        with pytest.raises(EdlCoordError, match="standing down"):
            RpcClient(endpoint, 10.0).call("reader_status", reader="g@e0")
        release.set()
        caller.join(timeout=5.0)
        thread.join(timeout=5.0)
        assert not thread.is_alive() and answer["file"][0] == 0
        with pytest.raises(EdlCoordError, match="no data leader"):
            resolve_data_leader(kv, JOB)
        assert DataJournal(kv, JOB).load("g@e0")["owner"][0][0] == "podA"
    finally:
        release.set()
        host.stop()
        thread.join(timeout=5.0)


@pytest.mark.parametrize("packages", [("port", "port"), ("jax", "port"), ("port", "jax")])
def test_one_seat_and_a_successor_after_the_winners_stop(kv, packages):
    """Two candidates (of the packages given) contend: one is seated, its
    endpoint the seat's value in both packages' resolvers; its stop frees
    the seat and the other takes it."""
    hosts = [_candidate(kv, p) for p in packages]
    threads = [_start(h) for h in hosts]
    try:
        winner = _wait_seated(hosts)
        assert resolve_data_leader(kv, JOB) == winner.endpoint
        assert j_resolve_data_leader(kv, JOB) == winner.endpoint
        winner.stop()
        threads[hosts.index(winner)].join(timeout=5.0)
        successor = _wait_seated([h for h in hosts if h is not winner])
        assert resolve_data_leader(kv, JOB) == successor.endpoint != winner.endpoint
    finally:
        for h in hosts:
            h.stop()
        for t in threads:
            t.join(timeout=5.0)
    with pytest.raises(EdlCoordError):
        resolve_data_leader(kv, JOB)


@pytest.mark.parametrize("first", ["port", "jax"])
def test_reader_rides_a_leader_failover_exactly_once(kv, files, first):
    """A port reader (registered in the reader registry, as trainers are)
    resolves the leader through the seat; after 3 batches the seated leader
    (a port or a JAX one) stops and a port successor rebuilds from the
    journal: every record trained exactly once.  Behind a port leader the
    successor is a standby already contending for the seat."""
    hosts = [_candidate(kv, first)]
    threads = [_start(hosts[0])]
    cache = PodDataServer("podA")
    reg = register_reader(kv, JOB, "rl@e0", "podA", cache.endpoint)
    try:
        _wait_seated(hosts)
        # one meta a leader round trip and none buffered ahead, so the
        # batches after the stop come through the successor
        reader = DistributedReader("rl@e0", "podA", lambda: resolve_data_leader(kv, JOB), cache,
                                   batch_size=4, retry_deadline=30.0, meta_prefetch=1,
                                   prefetch_depth=1)
        reader.create(files)
        it = iter(reader)
        got, spans = [], []
        for _ in range(3):
            _bid, payload = next(it)
            got.extend(payload["records"])
            spans.extend(payload["spans"])
        if first == "port":             # a standby contends while the leader serves
            hosts.append(_candidate(kv))
            threads.append(_start(hosts[1]))
        hosts[0].stop()
        threads[0].join(timeout=5.0)
        if first == "jax":
            # the JAX leader frees its seat before its server stops, so a
            # standby could rebuild while it still serves: the successor
            # starts once it is down
            hosts.append(_candidate(kv))
            threads.append(_start(hosts[1]))
        for _bid, payload in it:
            got.extend(payload["records"])
            spans.extend(payload["spans"])
        assert hosts[1].service.reader_status("rl@e0")["acked"] >= 12 - 3 - 1
        assert sorted(got) == ALL
        audit_spans(spans, 4, 10)
    finally:
        reg.stop()
        cache.stop()
        for h in hosts:
            h.stop()
        for t in threads:
            t.join(timeout=5.0)


def test_jax_reader_against_the_ports_leader(kv, files):
    """The JAX reader resolves the port's leader through the JAX resolver
    and drains the epoch from it exactly once."""
    host = _candidate(kv)
    thread = _start(host)
    cache = JPodDataServer("podJ")
    try:
        _wait_seated([host])
        reader = JDistributedReader("rj@e0", "podJ", lambda: j_resolve_data_leader(kv, JOB),
                                    cache, batch_size=4, retry_deadline=30.0)
        reader.create(files)
        got, spans = [], []
        for _bid, payload in reader:
            got.extend(payload["records"])
            spans.extend(payload["spans"])
        assert sorted(got) == ALL
        audit_spans(spans, 4, 10)
        assert host.service.reader_status("rj@e0")["acked"] == 4 * 3   # 4 + 4 + 2 a file
    finally:
        cache.stop()
        host.stop()
        thread.join(timeout=5.0)
