"""The port's data service (``edl_tpu_torch/data``) against the JAX
package's: the cases of ``tests/test_data_service.py`` on the port's
modules (exactly-once delivery, file-level work stealing, resume from a
checkpoint, dead-pod re-production minus consumed spans, span bookkeeping),
and the cases that make the wire compatible: each package's reader against
the other's ``DataService`` and ``PodDataServer``, two pods of different
packages under one service, a solo reader's spans equal to the JAX
reader's on the same files, typed errors crossing both ways, and a
``DataCheckpoint`` written by one package resumed by the other."""

import threading
import time

import pytest

from edl_tpu.cluster.state import DataCheckpoint as JDataCheckpoint
from edl_tpu.data import DistributedReader as JReader
from edl_tpu.data import PodDataServer as JPodDataServer
from edl_tpu.data.data_server import intersect_spans as j_intersect
from edl_tpu.rpc.client import RpcClient as JRpcClient
from edl_tpu.utils import exceptions as jexc
from edl_tpu_torch.cluster.state import DataCheckpoint
from edl_tpu_torch.data.data_server import PodDataServer
from edl_tpu_torch.data.distribute_reader import DistributedReader
from edl_tpu_torch.rpc.client import RpcClient
from edl_tpu_torch.utils.exceptions import EdlDataError, EdlStopIteration
from edl_tpu_torch.utils.spans import in_spans, intersect_spans, merge_span
from tests.helpers.exactly_once import audit_spans

ALL = sorted(f"f{f}r{r}" for f in range(4) for r in range(10))
PACKAGES = {"port": (PodDataServer, DistributedReader), "jax": (JPodDataServer, JReader)}


@pytest.fixture
def files(tmp_path):
    paths = []
    for f in range(4):
        p = tmp_path / f"part-{f}.txt"
        p.write_text("".join(f"f{f}r{r}\n" for r in range(10)))
        paths.append(str(p))
    return paths


def make_pod(pod_id, leader=False):
    return PodDataServer(pod_id, is_leader=leader)


def drain(reader, spans: list | None = None):
    got = []
    for _bid, payload in reader:
        got.extend(payload["records"])
        if spans is not None:
            spans.extend(payload["spans"])
    return got


def consume_both(readers: dict) -> tuple[dict, dict]:
    """Drain every reader in its own thread; (records, raw spans) by name."""
    got = {k: [] for k in readers}
    spans = {k: [] for k in readers}
    threads = [threading.Thread(target=lambda k=k, r=r: got[k].extend(drain(r, spans[k])))
               for k, r in readers.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not any(t.is_alive() for t in threads)
    return got, spans


def test_merge_span():
    spans = []
    merge_span(spans, 5, 8)
    merge_span(spans, 0, 2)
    assert spans == [[0, 2], [5, 8]]
    merge_span(spans, 2, 4)  # adjacent-left merge
    assert spans == [[0, 4], [5, 8]]
    merge_span(spans, 4, 5)  # bridges the gap
    assert spans == [[0, 8]]
    merge_span(spans, 3, 6)  # contained
    assert spans == [[0, 8]]
    merge_span(spans, 10, 12)
    merge_span(spans, 7, 11)  # overlaps both sides
    assert spans == [[0, 12]]
    assert in_spans(spans, 11) and not in_spans(spans, 12)
    a, b = [[5, 9], [0, 3], [2, 4]], [[1, 6], [8, 20]]
    assert intersect_spans(a, b) == j_intersect(a, b) == [[1, 4], [5, 6], [8, 9]]


def test_two_pods_exactly_once(files):
    a = make_pod("podA", leader=True)
    b = make_pod("podB")
    try:
        ra = DistributedReader("r1", "podA", a.endpoint, a, batch_size=4)
        rb = DistributedReader("r1", "podB", a.endpoint, b, batch_size=4)
        ra.create(files)
        rb.create(files)
        got, spans = consume_both({"podA": ra, "podB": rb})
        # exactly once across both consumers, whatever the steal split
        assert sorted(got["podA"] + got["podB"]) == ALL
        audit_spans(spans["podA"] + spans["podB"], 4, 10)
    finally:
        a.stop(); b.stop()


def test_remote_fetch_of_peer_batches(files):
    """podB only produces; podA consumes everything, fetched over podB's
    data-server RPC."""
    a = make_pod("podA", leader=True)
    b = make_pod("podB")
    try:
        ra = DistributedReader("rr", "podA", a.endpoint, a, batch_size=4)
        rb = DistributedReader("rr", "podB", a.endpoint, b, batch_size=4)
        ra.create(files)
        rb.create(files)
        tb = threading.Thread(target=rb._produce)
        tb.start()
        got = drain(ra)
        tb.join(10)
        assert sorted(got) == ALL
    finally:
        a.stop(); b.stop()


def test_checkpoint_resume_skips_processed(files):
    a = make_pod("podA", leader=True)
    try:
        ra = DistributedReader("r2", "podA", a.endpoint, a, batch_size=4)
        ra.create(files)
        consumed = []
        for _bid, payload in ra:
            consumed.extend(payload["records"])
            if len(consumed) >= 12:
                break
        ckpt_json = ra.checkpoint.to_json()
    finally:
        a.stop()
    # a new generation seeded with the checkpoint: only unprocessed records
    a2 = make_pod("podA", leader=True)
    try:
        ckpt = DataCheckpoint().from_json(ckpt_json)
        ra2 = DistributedReader("r2@gen2", "podA", a2.endpoint, a2, batch_size=4,
                                checkpoint=ckpt)
        ra2.create(files)
        rest = drain(ra2)
        assert not (set(consumed) & set(rest))
        assert sorted(consumed + rest) == ALL
    finally:
        a2.stop()


def test_dead_consumer_requeues_inflight(files):
    """Metas handed to a consumer that dies return to the pool."""
    a = make_pod("podA", leader=True)
    try:
        svc = a.service
        svc.create_reader("r3", files[:1])
        svc.report_batch_meta("r3", "podA", a.endpoint,
                              [["podA:0", [[0, 0, 4]]], ["podA:1", [[0, 4, 8]]]])
        svc.get_batch_meta("r3", "podB", n=2)        # podB takes both, then dies
        assert svc.get_batch_meta("r3", "podA", n=2)["metas"] == []
        svc.mark_pod_dead("podB")
        metas = svc.get_batch_meta("r3", "podA", n=2)["metas"]
        assert [m[2] for m in metas] == ["podA:0", "podA:1"]
    finally:
        a.stop()


def test_dead_producer_requeues_files_minus_consumed(files):
    """Batches produced by a dead pod are not lost: their files re-produce,
    minus the consumed spans."""
    a = make_pod("podA", leader=True)
    try:
        svc = a.service
        svc.create_reader("r4", files[:1])
        assert svc.next_file("r4", "podB")["file"] == [0, files[0]]
        svc.report_batch_meta("r4", "podB", "127.0.0.1:1",  # a dead endpoint
                              [["podB:0", [[0, 0, 4]]], ["podB:1", [[0, 4, 8]]],
                               ["podB:2", [[0, 8, 10]]]])
        svc.file_done("r4", "podB", 0)
        metas = svc.get_batch_meta("r4", "podA", n=1)["metas"]
        assert metas[0][2] == "podB:0"
        svc.get_batch_meta("r4", "podA", n=0, ack_ids=["podB:0"])
        svc.mark_pod_dead("podB")
        nxt = svc.next_file("r4", "podA")
        assert nxt["file"] == [0, files[0]]
        assert nxt["skip"] == [[0, 4]]  # the consumed span is left out
    finally:
        a.stop()


def test_nack_reproduces_via_live_producer(files):
    """The producer dies after reporting metas; the consumer's fetch fails,
    nacks, and a surviving producer re-produces the file: every record
    still arrives exactly once."""
    a = make_pod("podA", leader=True)
    b = make_pod("podB")
    try:
        rb = DistributedReader("r5", "podB", a.endpoint, b, batch_size=4)
        rb.create(files[:2])
        tb = threading.Thread(target=rb._produce, daemon=True)
        tb.start()
        deadline = time.monotonic() + 10
        while a.service.reader_status("r5")["produced"] < 6 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert a.service.reader_status("r5")["produced"] == 6
        rb._stop_produce.set()
        tb.join(5)
        b.stop()  # ...and dies; its cache is unreachable
        ra = DistributedReader("r5", "podA", a.endpoint, a, batch_size=4)
        got = drain(ra)
        assert sorted(got) == sorted(f"f{f}r{r}" for f in range(2) for r in range(10))
    finally:
        a.stop()


def test_cache_eviction_repairs_without_killing_producer(files):
    """A live producer evicting a batch is not declared dead: the consumer
    nacks with producer_dead=False and only the lost spans re-produce."""
    a = PodDataServer("podA", is_leader=True, cache_cap=2)
    try:
        ra = DistributedReader("rv", "podA", a.endpoint, a, batch_size=4)
        ra._backpressure = 10_000  # no throttling: force the eviction
        ra.create(files[:1])
        spans: list = []
        got = drain(ra, spans)  # 3 batches published, the cache keeps 2
        assert sorted(got) == sorted(f"f0r{r}" for r in range(10))
        assert len(got) == 10
        audit_spans(spans, 1, 10)
    finally:
        a.stop()


def test_spans_cover_every_record(files):
    a = make_pod("podA", leader=True)
    try:
        ra = DistributedReader("rs", "podA", a.endpoint, a, batch_size=16)
        ra.create(files)
        for _ in ra:
            pass
        ckpt = ra.checkpoint
        for f in range(4):
            for r in range(10):
                assert ckpt.is_processed(f, r), (f, r, ckpt.to_dict())
        for pr in ckpt.processed:
            assert 0 <= pr.begin < pr.end <= 10
    finally:
        a.stop()


def test_producer_error_fails_all_consumers(files, tmp_path):
    """An unreadable file fails the generation for every consumer."""
    a = make_pod("podA", leader=True)
    missing = str(tmp_path / "nope.txt")
    try:
        ra = DistributedReader("re", "podA", a.endpoint, a, batch_size=4)
        ra.create(files[:1] + [missing])
        with pytest.raises((FileNotFoundError, EdlDataError)):
            for _ in ra:
                pass
        client = RpcClient(a.endpoint)
        with pytest.raises(EdlDataError):
            client.call("get_batch_meta", reader="re", pod_id="podC", n=1)
        client.close()
    finally:
        a.stop()


@pytest.mark.parametrize("server", ["port", "jax"])
@pytest.mark.parametrize("client", ["port", "jax"])
def test_drained_raises_typed_stop(files, server, client):
    """End of data crosses the wire by class name, both ways."""
    a = PACKAGES[server][0]("podA", is_leader=True)
    try:
        a.service.create_reader("r6", [])
        rpc, stop = ((RpcClient, EdlStopIteration) if client == "port"
                     else (JRpcClient, jexc.EdlStopIteration))
        c = rpc(a.endpoint)
        with pytest.raises(stop):
            c.call("get_batch_meta", reader="r6", pod_id="podA", n=1)
        c.close()
    finally:
        a.stop()


def test_producer_coalesces_meta_reports(files):
    """Metas ride the leader wire in chunks, far fewer reports than batches,
    and delivery stays exactly once."""
    a = make_pod("podA", leader=True)
    try:
        ra = DistributedReader("rcoal", "podA", a.endpoint, a, batch_size=4,
                               produce_meta_batch=4)
        calls: list[int] = []
        orig = ra._leader.call

        def counted(method, **kw):
            if method == "report_batch_meta":
                calls.append(len(kw.get("batches") or []))
            return orig(method, **kw)

        ra._leader.call = counted
        ra.create(files)
        spans: list = []
        got = drain(ra, spans)
        assert sorted(got) == ALL
        audit_spans(spans, 4, per_file=10)
        reports = [c for c in calls if c > 0]
        # 4 files x 10 records / bs 4 = 12 batches
        assert sum(reports) == 12
        assert len(reports) < 12, f"not coalesced: {reports}"
        assert max(reports) > 1 and max(reports) <= 4, reports
    finally:
        a.stop()


def test_generation_gc(files):
    a = make_pod("podA", leader=True)
    try:
        svc = a.service
        svc.create_reader("train@e0@s1", files)
        svc.create_reader("other@e0@s1", files)
        svc.create_reader("train@e1@s1", files)  # GCs train@e0@s1
        with pytest.raises(EdlDataError):
            svc.reader_status("train@e0@s1")
        assert svc.reader_status("train@e1@s1")["files"] == 4
        assert svc.reader_status("other@e0@s1")["files"] == 4
    finally:
        a.stop()


# -- across the packages ------------------------------------------------------------

@pytest.mark.parametrize("leader", ["jax", "port"])
def test_mixed_pods_under_one_service_exactly_once(files, leader):
    """Two pods under one DataService, one reading through the port and one
    through the JAX package, each serving its own package's cache: every
    batch one pod produced and the other consumed crossed the other
    package's streamed fetch.  Every record once, in the union of both."""
    other = "port" if leader == "jax" else "jax"
    lead = PACKAGES[leader][0]("podA", is_leader=True)
    peer = PACKAGES[other][0]("podB")
    try:
        ra = PACKAGES[leader][1]("rx", "podA", lead.endpoint, lead, batch_size=4)
        rb = PACKAGES[other][1]("rx", "podB", lead.endpoint, peer, batch_size=4)
        ra.create(files)
        rb.create(files)
        got, spans = consume_both({"podA": ra, "podB": rb})
        assert sorted(got["podA"] + got["podB"]) == ALL
        audit_spans(spans["podA"] + spans["podB"], 4, 10)
    finally:
        lead.stop(); peer.stop()


@pytest.mark.parametrize("consumer", ["jax", "port"])
def test_each_reader_fetches_from_the_other_packages_cache(files, consumer):
    """One pod only produces, in one package; the other package's pod
    consumes everything over the producer's streamed path."""
    producer = "port" if consumer == "jax" else "jax"
    a = PACKAGES[consumer][0]("podA", is_leader=True)
    b = PACKAGES[producer][0]("podB")
    try:
        ra = PACKAGES[consumer][1]("rf", "podA", a.endpoint, a, batch_size=4)
        rb = PACKAGES[producer][1]("rf", "podB", a.endpoint, b, batch_size=4)
        ra.create(files)
        rb.create(files)
        tb = threading.Thread(target=rb._produce, daemon=True)
        tb.start()
        # every batch is the producer's before the consumer starts: each
        # one crosses between the packages
        deadline = time.monotonic() + 10
        while a.service.reader_status("rf")["produced"] < 12 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert a.service.reader_status("rf")["produced"] == 12
        spans: list = []
        got = drain(ra, spans)
        tb.join(10)
        assert sorted(got) == ALL
        audit_spans(spans, 4, 10)
    finally:
        a.stop(); b.stop()


@pytest.mark.parametrize("service", ["jax", "port"])
def test_solo_port_reader_spans_equal_the_jax_readers(files, service):
    """A solo port reader and a solo JAX reader, each under the ``service``
    package's DataService, on the same files: the same batches (records and
    spans), and the same merged checkpoint."""
    runs = {}
    for name, (_server, reader_cls) in PACKAGES.items():
        a = PACKAGES[service][0]("podA", is_leader=True)
        try:
            r = reader_cls("rsolo", "podA", a.endpoint, a, batch_size=4)
            r.create(files)
            batches = sorted((p["spans"], p["records"]) for _bid, p in r)
            runs[name] = (batches, [[x.file_idx, x.begin, x.end]
                                    for x in r.checkpoint.processed])
        finally:
            a.stop()
    assert runs["port"] == runs["jax"]
    assert len(runs["port"][0]) == 12
    assert sorted(runs["port"][1]) == [[f, 0, 10] for f in range(4)]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_checkpoint_written_by_one_package_resumes_in_the_other(files, writer):
    """The data checkpoint's spans cross the packages in the State sidecar's
    JSON: a reader of one package resumes from the other's checkpoint and
    reads exactly the records it lacks."""
    ckpt = (JDataCheckpoint if writer == "jax" else DataCheckpoint)("r")
    ckpt.mark_processed(0, 0, 10)
    ckpt.mark_processed(2, 3, 7)
    reader_pkg = "port" if writer == "jax" else "jax"
    restored = (DataCheckpoint if reader_pkg == "port" else JDataCheckpoint)().from_json(
        ckpt.to_json())
    assert restored.to_json() == ckpt.to_json()
    a = PACKAGES[reader_pkg][0]("podA", is_leader=True)
    try:
        r = PACKAGES[reader_pkg][1]("rck", "podA", a.endpoint, a, batch_size=4,
                                    checkpoint=restored)
        r.create(files)
        got = drain(r)
    finally:
        a.stop()
    skipped = {f"f0r{i}" for i in range(10)} | {f"f2r{i}" for i in range(3, 7)}
    assert sorted(got) == sorted(set(ALL) - skipped)
