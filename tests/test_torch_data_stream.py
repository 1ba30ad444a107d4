"""Streamed batch delivery in the port's data plane, the cases of
``tests/test_data_stream.py``: the framed transport, demotion of an old peer
to the per-batch path, repair after a stream-protocol error, drain
invariants, one timeout for a dead producer shared by the fetch workers,
the forced per-batch mode; the channel pool's pipelined path against the
JAX server; and ``device_put_stream`` on the CPU (one-deep order, spans on
the host)."""

import threading
import time

import numpy as np
import pytest
import torch

from edl_tpu.rpc.server import RpcServer as JRpcServer
from edl_tpu_torch.data.data_server import PodDataServer
from edl_tpu_torch.data.distribute_reader import DistributedReader
from edl_tpu_torch.data.elastic_input import SPANS_KEY, device_put_stream
from edl_tpu_torch.rpc.client import RpcChannelPool
from edl_tpu_torch.rpc.server import Streaming
from edl_tpu_torch.utils.exceptions import EdlStreamError, EdlUnavailableError
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


def drain(reader, spans: list | None = None):
    got = []
    for _bid, payload in reader:
        got.extend(payload["records"])
        if spans is not None:
            spans.extend(payload["spans"])
    return got


def _produce_in_background(reader):
    t = threading.Thread(target=reader._produce, daemon=True)
    t.start()
    return t


def _produce_all_first(leader, reader, name, batches=12):
    """The peer produces every batch before the consumer starts, so each of
    them crosses the wire (the consumer's own producer finds no file left)."""
    t = _produce_in_background(reader)
    deadline = time.monotonic() + 10
    while (leader.service.reader_status(name)["produced"] < batches
           and time.monotonic() < deadline):
        time.sleep(0.02)
    assert leader.service.reader_status(name)["produced"] == batches
    return t


def test_remote_fetch_rides_the_streamed_path(files):
    """podB produces, podA consumes: the batches cross the wire as
    get_batch_stream frames (no per-batch RPC), exactly once."""
    a = PodDataServer("podA", is_leader=True)
    b = PodDataServer("podB")
    try:
        ra = DistributedReader("rs1", "podA", a.endpoint, a, batch_size=4)
        rb = DistributedReader("rs1", "podB", a.endpoint, b, batch_size=4)
        ra.create(files)
        rb.create(files)
        tb = _produce_all_first(a, rb, "rs1")
        spans: list = []
        got = drain(ra, spans)
        tb.join(10)
        assert sorted(got) == ALL
        audit_spans(spans, 4, 10)
        assert ra.counts.get("stream", 0) > 0
        assert "rpc" not in ra.counts
    finally:
        a.stop(); b.stop()


def test_old_peer_demotion_roundtrip(files):
    """A producer without the get_batch_stream handler demotes the consumer's
    pool to per-batch fetch, probed once (at most once a fetch worker), and
    every record still arrives exactly once."""
    a = PodDataServer("podA", is_leader=True)
    b = PodDataServer("podB")
    del b._rpc._server.methods["get_batch_stream"]   # an old peer's surface
    try:
        ra = DistributedReader("rs2", "podA", a.endpoint, a, batch_size=4)
        rb = DistributedReader("rs2", "podB", a.endpoint, b, batch_size=4)
        ra.create(files)
        rb.create(files)
        tb = _produce_all_first(a, rb, "rs2")
        spans: list = []
        got = drain(ra, spans)
        tb.join(10)
        assert sorted(got) == ALL
        audit_spans(spans, 4, 10)
        assert 1 <= ra.counts["demotions"] <= ra._n_workers
        assert ra.counts["rpc"] > 0
    finally:
        a.stop(); b.stop()


@pytest.mark.parametrize("mode", ["short", "mismatch", "garbage"])
def test_stream_protocol_errors_repair_via_requeue(files, mode):
    """Short, mismatched and undecodable frames surface as EdlStreamError and
    the unreceived batches re-fetch through the leader's requeue repair:
    never dropped, never acked twice."""
    a = PodDataServer("podA", is_leader=True)
    b = PodDataServer("podB")
    real = b.get_batch_stream

    def broken_stream(batch_ids):
        def frames():
            for i, frame in enumerate(real(batch_ids).it):
                if mode == "short" and i == len(batch_ids) - 1:
                    return  # ends one frame early
                if mode == "mismatch" and i == 0:
                    frame = dict(frame, batch_id="not-a-batch")
                if mode == "garbage" and i == 0:
                    frame = b"\x00not msgpack\xff"
                yield frame
        return Streaming(frames())

    b._rpc._server.methods["get_batch_stream"] = broken_stream
    try:
        ra = DistributedReader("rs3", "podA", a.endpoint, a, batch_size=4)
        rb = DistributedReader("rs3", "podB", a.endpoint, b, batch_size=4)
        ra.create(files[:2])
        rb.create(files[:2])
        tb = _produce_in_background(rb)
        deadline = time.monotonic() + 10
        while a.service.reader_status("rs3")["produced"] < 1 and time.monotonic() < deadline:
            time.sleep(0.05)
        spans: list = []
        got = drain(ra, spans)
        tb.join(10)
        assert sorted(got) == sorted(f"f{f}r{r}" for f in range(2) for r in range(10))
        audit_spans(spans, 2, 10)
        assert ra.counts["stream_errors"] > 0
    finally:
        a.stop(); b.stop()


def test_producer_killed_mid_epoch_streamed_exactly_once(files):
    """A producer dies after publishing metas: its batches fail the stream
    open, conclude dead, nack, and its files re-produce."""
    a = PodDataServer("podA", is_leader=True)
    b = PodDataServer("podB")
    try:
        rb = DistributedReader("rs4", "podB", a.endpoint, b, batch_size=4)
        rb.create(files[:2])
        tb = _produce_in_background(rb)
        deadline = time.monotonic() + 10
        while a.service.reader_status("rs4")["produced"] < 6 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert a.service.reader_status("rs4")["produced"] == 6
        rb._stop_produce.set()
        tb.join(5)
        b.stop()  # the cache endpoint goes dark
        ra = DistributedReader("rs4", "podA", a.endpoint, a, batch_size=4)
        spans: list = []
        got = drain(ra, spans)
        assert sorted(got) == sorted(f"f{f}r{r}" for f in range(2) for r in range(10))
        audit_spans(spans, 2, 10)
    finally:
        a.stop()


def test_prefetch_drain_leaves_zero_unacked(files):
    """After the end of data: no unacked batch on the reader, none in the
    leader's inflight table, and the fetch workers gone."""
    a = PodDataServer("podA", is_leader=True)
    try:
        ra = DistributedReader("rs5", "podA", a.endpoint, a, batch_size=4)
        ra.create(files)
        assert sorted(drain(ra)) == ALL
        with ra._state_lock:
            assert not ra._held
        status = a.service.reader_status("rs5")
        assert all(n == 0 for n in status["inflight"].values()), status
        assert status["acked"] == status["produced"]
        for t in ra._fetch_workers:
            t.join(5)
            assert not t.is_alive()
    finally:
        a.stop()


def test_dead_producer_costs_workers_one_timeout_in_parallel(monkeypatch):
    """Fetch-worker groups against one dead producer share a channel pool
    with a lock a connection, so they fail in about one retry cycle in
    parallel, not one cycle each in series."""
    from edl_tpu_torch.rpc import client as client_mod

    def slow_connect(endpoint, timeout):
        time.sleep(0.2)
        raise OSError("connect timed out")

    monkeypatch.setattr(client_mod, "_connect", slow_connect)
    a = PodDataServer("podA", is_leader=True)
    try:
        ra = DistributedReader("rs6", "podA", a.endpoint, a, batch_size=4, stream=False,
                               fetch_workers=4)
        ra._closed = True  # skip the sleeps between attempts
        results: list = []

        def worker(i):
            meta = ["podB", "198.51.100.1:9", f"podB:{i}", [[0, 0, 4]]]
            results.append(ra._fetch_group("podB", "198.51.100.1:9", [meta]))

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
        t0 = time.monotonic()
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        wall = time.monotonic() - t0
        assert all(r[0][2] == "dead" for r in results), results
        # a group: 3 attempts x 2 dials x 0.2 s = 1.2 s; four in series >= 4.8 s
        assert wall < 3.0, f"dead-producer fetches serialised: {wall:.2f}s"
    finally:
        a.stop()


def test_forced_legacy_mode_still_exact(files):
    """stream=False (EDL_TPU_DATA_PREFETCH_STREAM=0) keeps every fetch on
    per-batch RPCs, still exactly once."""
    a = PodDataServer("podA", is_leader=True)
    b = PodDataServer("podB")
    try:
        ra = DistributedReader("rs7", "podA", a.endpoint, a, batch_size=4, stream=False)
        rb = DistributedReader("rs7", "podB", a.endpoint, b, batch_size=4, stream=False)
        ra.create(files)
        rb.create(files)
        tb = _produce_all_first(a, rb, "rs7")
        spans: list = []
        got = drain(ra, spans)
        tb.join(10)
        assert sorted(got) == ALL
        audit_spans(spans, 4, 10)
        assert "stream" not in ra.counts and ra.counts["rpc"] > 0
    finally:
        a.stop(); b.stop()


def test_channel_pool_against_the_jax_server():
    """The port's pool on the JAX server: a pipelined window answers in
    request order, a typed error is raised after the frames in flight drain
    (the channel stays usable), and a streamed reply checks its sequence."""
    from edl_tpu.rpc.server import Streaming as JStreaming
    from edl_tpu.utils.exceptions import EdlUnavailableError as JUnavailable

    def echo(i):
        if i == 5:
            raise JUnavailable("five")
        return {"i": i}

    srv = JRpcServer("127.0.0.1", 0)
    srv.register("echo", echo)
    srv.register("frames", lambda n: JStreaming(iter([{"k": k} for k in range(n)]
                                                     + [b"raw-bytes"])))
    srv.start()
    pool = RpcChannelPool(f"127.0.0.1:{srv.port}", size=2, timeout=10.0)
    try:
        got = list(pool.iter_call_pipelined("echo", [{"i": i} for i in range(5)], window=3))
        assert got == [{"i": i} for i in range(5)]
        with pytest.raises(EdlUnavailableError):
            list(pool.iter_call_pipelined("echo", [{"i": i} for i in range(8)], window=4))
        assert pool.call("echo", i=7) == {"i": 7}
        assert list(pool.call_streaming("frames", n=3)) == [
            {"k": 0}, {"k": 1}, {"k": 2}, bytearray(b"raw-bytes")]
        with pytest.raises(EdlStreamError):   # a plain answer where frames were due
            list(pool.call_streaming("echo", i=1))
    finally:
        pool.close()
        srv.stop()


def test_device_put_stream_on_the_cpu_keeps_order_and_spans_host_side():
    """On the CPU the stage passes batches through in order: numpy arrays
    become tensors, the spans come out beside the batch and never in it, a
    batch without spans gives None, and nothing is waited on."""
    def batches():
        for i in range(4):
            b = {"x": np.full((2, 3), i, np.float32), "ids": torch.arange(i, i + 2)}
            if i != 2:
                b[SPANS_KEY] = [[0, i, i + 1]]
            yield b

    stream = device_put_stream(batches(), "cpu")
    seen = []
    for dev_batch, spans in stream:
        assert SPANS_KEY not in dev_batch
        assert isinstance(dev_batch["x"], torch.Tensor) and dev_batch["x"].device.type == "cpu"
        seen.append((int(dev_batch["x"][0, 0]), dev_batch["ids"].tolist(), spans))
    assert seen == [(i, [i, i + 1], None if i == 2 else [[0, i, i + 1]]) for i in range(4)]
    assert stream.batches == 4 and stream.h2d_wait_s == 0.0
