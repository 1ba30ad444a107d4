"""The port's resilient store client against the JAX package's
coordination server: failover to a live endpoint, a server restart ridden
out, the scoped deadline (one budget shared by every op in the scope), a
hung endpoint left within one op (the in-flight request is bounded by the
budget), and ``connect`` returning the resilient client (the client cases
of ``tests/test_coord_resilience.py``)."""

import socket
import threading
import time

import pytest

from edl_tpu.coord.server import start_server
from edl_tpu_torch.cluster.env import TrainerEnv
from edl_tpu_torch.coord.client import connect
from edl_tpu_torch.coord.resilient import ResilientCoordClient
from edl_tpu_torch.train import distributed
from edl_tpu_torch.utils.exceptions import EdlCoordError


def test_resilient_client_fails_over_to_live_endpoint(coord_server):
    live = f"127.0.0.1:{coord_server.port}"
    rc = ResilientCoordClient(["127.0.0.1:1", live], timeout=2.0, retry_deadline=20.0,
                              backoff_init=0.01)
    assert rc.put("/r/k", b"v") > 0          # the dead first endpoint is survived
    assert rc.get("/r/k").value == b"v"
    assert rc.endpoint == live               # seated on the survivor
    rc.close()


def test_resilient_client_survives_server_restart(tmp_path):
    d = str(tmp_path / "coord")
    server = start_server("127.0.0.1", 0, data_dir=d)
    port = server.port
    rc = ResilientCoordClient([f"127.0.0.1:{port}"], timeout=2.0, retry_deadline=20.0,
                              backoff_init=0.01)
    lid = rc.lease_grant(30.0)
    rc.put("/sr/k", b"v", lid)
    server.stop()
    server.kv.close()  # release the WAL before the restart reopens it
    done, result = threading.Event(), {}

    def op():
        try:
            result["rec"] = rc.get("/sr/k")
        except Exception as e:  # noqa: BLE001 — reported below
            result["err"] = e
        done.set()

    t = threading.Thread(target=op)
    t.start()                                # retries against the dead port
    time.sleep(0.5)
    server2 = start_server("127.0.0.1", port, data_dir=d)
    try:
        assert done.wait(15), "the op never completed after the restart"
        t.join(timeout=5)
        assert not t.is_alive() and "err" not in result, result.get("err")
        assert result["rec"].value == b"v" and result["rec"].lease_id == lid
        assert rc.lease_keepalive(lid) is True
    finally:
        rc.close()
        server2.stop()


def test_scoped_deadline_bounds_blocking():
    rc = ResilientCoordClient(["127.0.0.1:1"], timeout=0.2, retry_deadline=60.0,
                              backoff_init=0.01)
    t0 = time.monotonic()
    with pytest.raises(EdlCoordError):
        with rc.scoped_deadline(0.5):
            rc.put("/x", b"v")
    assert time.monotonic() - t0 < 5.0, "the scoped budget must bound retrying"
    rc.close()


def test_hung_endpoint_fails_over_within_one_op(coord_server):
    """A blackholed endpoint (the listen backlog accepts, nothing answers)
    must not eat the whole budget in one attempt: the op reaches the healthy
    standby inside its own budget."""
    sink = socket.socket()
    sink.bind(("127.0.0.1", 0))
    sink.listen(1)
    hung = f"127.0.0.1:{sink.getsockname()[1]}"
    rc = ResilientCoordClient([hung, f"127.0.0.1:{coord_server.port}"], timeout=30.0,
                              retry_deadline=8.0, backoff_init=0.01)
    try:
        t0 = time.monotonic()
        rc.put("/ho/k", b"v")                # must not raise
        assert time.monotonic() - t0 < 8.0
        assert rc.get("/ho/k").value == b"v"
    finally:
        rc.close()
        sink.close()


def test_scoped_deadline_budget_shared_across_ops():
    """One absolute deadline for every op in the scope: three ops against a
    dead store give up after about one budget in all, not one each."""
    rc = ResilientCoordClient(["127.0.0.1:1"], timeout=0.2, retry_deadline=60.0,
                              backoff_init=0.01)
    t0 = time.monotonic()
    with rc.scoped_deadline(0.8):
        for _ in range(3):
            with pytest.raises(EdlCoordError):
                rc.put("/x", b"v")
    assert time.monotonic() - t0 < 2.0, "the scoped budget must be shared across the scope"
    rc.close()


def test_connect_returns_resilient_and_reports_cause(coord_server):
    ep = f"127.0.0.1:{coord_server.port}"
    store = connect(f"127.0.0.1:1,{ep}")
    assert isinstance(store, ResilientCoordClient) and store.endpoint == ep
    store.put("/c/k", b"v")
    assert store.ping()
    store.close()
    with pytest.raises(ConnectionError) as ei:
        connect("127.0.0.1:1", timeout=0.2)
    assert "None" not in str(ei.value)       # ping's transport error is surfaced
    tenv = TrainerEnv({"EDL_TPU_COORD_ENDPOINTS": ep, "EDL_TPU_POD_ID": "pod-a"})
    trainer_store = distributed.connect_store(tenv)
    assert isinstance(trainer_store, ResilientCoordClient)
    trainer_store.close()
