"""Shared pieces of the port's peer-checkpoint-cache tests: pods as cache
services on RPC servers over one coordination store (either package's
service, on either package's server, advertised by either package), and a
small torch TrainState with optimizer moments, a bf16 leaf and an integer
buffer."""

import time

import torch

from edl_tpu_torch.train.state import TrainState, adamw

JOB = "job"


def serve_pods(store, names, jax_service=False):
    """``{name: (service, server, advert)}``; ``jax_service``: the JAX
    package's service on the JAX server, advertised by the JAX package."""
    if jax_service:
        from edl_tpu.memstate import advert
        from edl_tpu.memstate.service import StateCacheService
        from edl_tpu.rpc.server import RpcServer
    else:
        from edl_tpu_torch.memstate import advert
        from edl_tpu_torch.memstate.service import StateCacheService
        from edl_tpu_torch.rpc.server import RpcServer
    pods = {}
    for name in names:
        svc = StateCacheService(store, JOB, name)
        srv = RpcServer("127.0.0.1", 0)
        srv.register_instance(svc)
        srv.start()
        reg = advert.advertise(store, JOB, name, f"127.0.0.1:{srv.port}", ttl=30)
        pods[name] = (svc, srv, reg)
    return pods


def teardown(pods):
    for _svc, srv, reg in pods.values():
        reg.stop()
        srv.stop()


def kill_pod(store, pods, name):
    """The pod's server down and its advert gone (the launcher died)."""
    _svc, srv, reg = pods.pop(name)
    reg.stop()
    srv.stop()
    store.delete(f"/edl_tpu/{JOB}/memstate/nodes/{name}")


def wait_for(cond, what, timeout=30.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.02)


class Tiny(torch.nn.Module):
    """An f32 matrix, a bf16 vector and an integer buffer."""

    def __init__(self, seed=0):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.w = torch.nn.Parameter(torch.randn(8, 8, generator=g))
        self.b = torch.nn.Parameter(torch.randn(6, generator=g).to(torch.bfloat16))
        self.register_buffer("count", torch.tensor([3, 1, 4], dtype=torch.int64))


def tiny_factory():
    return adamw(1e-2)


def tiny_state(seed=0, steps=2):
    """A Tiny module and AdamW after ``steps`` updates on seeded gradients."""
    state = TrainState.create(Tiny(seed), tiny_factory())
    advance(state, steps, seed)
    return state


def advance(state, steps, seed=0):
    g = torch.Generator().manual_seed(1000 + seed + state.step)
    for _ in range(steps):
        for p in state.model.parameters():
            p.grad = torch.randn(p.shape, generator=g).to(p.dtype)
        state.apply_gradients()
        state.model.count += 1
    return state


def fresh_target():
    """A freshly built state of the same structure (a restore's target)."""
    return TrainState.create(Tiny(99), tiny_factory())
