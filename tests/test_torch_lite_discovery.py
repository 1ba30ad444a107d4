"""The port's lite discovery (``edl_tpu_torch/distill/lite_discovery.py``): both
cases of ``tests/test_lite_discovery.py`` against the port's modules, and
the ``EDLJ`` wire in both directions (the port's client against the JAX
package's balance server, and the JAX client against the port's)."""

import time

import numpy as np
import pytest

from edl_tpu.coord.memory import MemoryKV as JaxMemoryKV
from edl_tpu.coord.register import Register as JaxRegister
from edl_tpu.distill import balance as jbalance
from edl_tpu.distill import lite_discovery as jlite
from edl_tpu_torch.coord.memory import MemoryKV
from edl_tpu_torch.coord.register import Register
from edl_tpu_torch.distill import reader as reader_mod
from edl_tpu_torch.distill.balance import server_key
from edl_tpu_torch.distill.lite_discovery import LiteBalanceServer, LiteDiscoveryClient


def register_teacher(kv, service, endpoint, ttl=1.0):
    return Register(kv, server_key(service, endpoint), endpoint.encode(), ttl=ttl)


def wait_for(fn, timeout=10.0, period=0.05):
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


def test_register_heartbeat_rebalance(tkv):
    regs = [register_teacher(tkv, "svc", f"10.0.0.{i}:90") for i in (1, 2)]
    server = LiteBalanceServer(tkv, host="127.0.0.1", poll_period=0.2)
    clients = []
    try:
        clients = [LiteDiscoveryClient(server.endpoint, "svc",
                                       require_num=1, period=0.1).start()
                   for _ in range(2)]
        # both students get a teacher, balanced across the two
        wait_for(lambda: all(c.servers() for c in clients))
        assigned = [c.servers() for c in clients]
        assert all(len(a) == 1 for a in assigned), assigned
        assert {a[0] for a in assigned} == {"10.0.0.1:90", "10.0.0.2:90"}

        # teacher death (lease revoked) -> reassignment through heartbeats
        dead = assigned[0][0]
        regs[0 if dead.endswith(".1:90") else 1].stop()
        wait_for(lambda: all(c.servers() == ["10.0.0.2:90" if dead.endswith(".1:90")
                                             else "10.0.0.1:90"]
                             for c in clients))

        # a new teacher joining raises versions and spreads again
        regs.append(register_teacher(tkv, "svc", "10.0.0.3:90"))
        wait_for(lambda: {c.servers()[0] for c in clients if c.servers()}
                 and len({c.servers()[0] for c in clients}) == 2)
    finally:
        for c in clients:
            c.stop()
        server.stop()
        for r in regs:
            r.stop()


def test_distill_reader_over_lite_discovery(tkv, monkeypatch):
    """DistillReader streams through the lite wire (a custom servers_fn)
    with the nop teacher backend."""
    reg = register_teacher(tkv, "lite-svc", "127.0.0.1:1")
    server = LiteBalanceServer(tkv, host="127.0.0.1", poll_period=0.2)
    client = LiteDiscoveryClient(server.endpoint, "lite-svc",
                                 require_num=2, period=0.1).start()
    monkeypatch.setattr(reader_mod, "_NOP_PREDICT_TEST", True)
    try:
        wait_for(lambda: client.servers())
        dr = reader_mod.DistillReader(ins=["x", "y"], predicts=["p"],
                                      feeds=["x"], teacher_batch_size=4)

        def fn():
            return client.servers()
        fn.close = client.stop  # type: ignore[attr-defined]
        dr.set_servers_fn(fn)

        def gen():
            for i in range(6):
                yield np.full((8, 2), i, np.float32), np.arange(8, dtype=np.int32)
        dr.set_batch_generator(gen)
        got = list(dr)
        assert len(got) == 6  # the original batch shapes reassembled
        for i, (x, y, p) in enumerate(got):
            assert len(x) == len(y) == len(p) == 8
            assert (x == i).all()
    finally:
        server.stop()
        reg.stop()


@pytest.mark.parametrize("direction", ["port_client_jax_server", "jax_client_port_server"])
def test_lite_wire_across_packages(direction):
    """Each package's lite client against the other's balance server: the
    register answer, then a second teacher's join through heartbeats."""
    if direction == "port_client_jax_server":
        kv, reg_cls, key = JaxMemoryKV(sweep_period=0.1), JaxRegister, jbalance.server_key
        server = jlite.LiteBalanceServer(kv, host="127.0.0.1", poll_period=0.2)
        client_cls = LiteDiscoveryClient
    else:
        kv, reg_cls, key = MemoryKV(sweep_period=0.1), Register, server_key
        server = LiteBalanceServer(kv, host="127.0.0.1", poll_period=0.2)
        client_cls = jlite.LiteDiscoveryClient
    regs = [reg_cls(kv, key("x-svc", "10.0.1.1:90"), b"t", ttl=2.0)]
    client = client_cls(server.endpoint, "x-svc", require_num=2, period=0.1).start()
    try:
        wait_for(lambda: client.servers() == ["10.0.1.1:90"])
        regs.append(reg_cls(kv, key("x-svc", "10.0.1.2:90"), b"t", ttl=2.0))
        wait_for(lambda: client.servers() == ["10.0.1.1:90", "10.0.1.2:90"])
        regs[0].stop()
        wait_for(lambda: client.servers() == ["10.0.1.2:90"])
    finally:
        client.stop()
        server.stop()
        for r in regs:
            r.stop()
        kv.close()
