"""The command channel of a tensor-parallel serving group.

In the JAX package one process drives every chip of a replica, and XLA
inserts the tp collectives into one program.  In PyTorch one process
drives one card, so a tp server is an SPMD group of processes: rank 0 of
the mesh's ``tp`` group (the *leader*) fronts the wire and runs the
scheduler; before each device call it broadcasts that call as a
*command* to the other ranks (the *followers*), which loop on
:meth:`Channel.serve` and run the same call on their own heads, so every
collective inside the model's forward (``parallel/tp.py``) is entered by
every rank in the same order.

A command is an op code, a short list of ints, host arrays and device
tensors:

- the op code, the ints and each operand's dtype and shape travel in one
  int64 header over a gloo group of the same ranks on the CPU (the
  *control* group, which works beside any backend of the ``tp`` group);
- host arrays (prompt ids, block ids, a migrated chain's KV blocks)
  travel over the control group as raw bytes;
- device tensors (the last tokens, a speculative round's drafts) travel
  over the ``tp`` group on the card, in the command's order, so no host
  copy is made on the leader.

Objects that live across commands (a prefilled slab that waits for its
insert, a chunked admission's cache) are named by integer *handles*: the
leader names an object once (:meth:`Channel.handle`), each follower files
its own twin under that handle (:meth:`Channel.adopt`), and when the
leader's object is garbage collected its handle rides the next header,
and each follower drops its twin.

Liveness: every wait on the control group is bounded by :data:`TIMEOUT`
(60 s).  An idle leader sends a no-op every ``TIMEOUT / 6`` seconds, so
a follower whose leader has gone, hung or been killed raises within
``TIMEOUT`` (a killed leader's sockets close, so at once in practice)
instead of waiting in a collective for ever.  The leader's
:meth:`Channel.close` sends the stop; a leader that fails calls it too,
so its failure reaches the followers as a stop.
"""

from __future__ import annotations

import logging
import threading
import time
import weakref
from dataclasses import dataclass, field
from datetime import timedelta
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from edl_tpu_torch.parallel.tp import TP

logger = logging.getLogger(__name__)

TIMEOUT = 60.0                    # seconds: the bound on every wait of a tp group

OP_STOP = 0
OP_NOOP = 1
# the users' op codes: the engine's device calls (serving/engine.py)
OP_CONFIG, OP_SLAB, OP_PREFILL, OP_STEP, OP_VERIFY, OP_INSERT, OP_CHUNK_MID, \
    OP_CHUNK_FINAL = range(16, 24)
# the paged pool's block moves (serving/kv_cache.py)
OP_KV_LOAD, OP_KV_STORE, OP_KV_IMPORT, OP_KV_EXPORT = range(32, 36)
# a teacher's forward (distill/teacher.py) and serve_lm's batch generate
OP_FORWARD, OP_GENERATE = 40, 41

_HEADER = 64                      # int64 words of the fixed first broadcast
_DTYPES = (torch.int64, torch.int32, torch.int16, torch.int8, torch.uint8, torch.bool,
           torch.float32, torch.float16, torch.bfloat16, torch.float64)
_CODE = {dt: i for i, dt in enumerate(_DTYPES)}


class FollowerExit(RuntimeError):
    """A follower cannot go on: its leader is gone (a failed or timed-out
    wait), or a command failed on this rank (its peers' collectives are
    then out of step)."""


@dataclass
class Command:
    """One command as a follower receives it."""

    op: int
    ints: list[int] = field(default_factory=list)
    arrays: list[torch.Tensor] = field(default_factory=list)    # on the CPU
    tensors: list[torch.Tensor] = field(default_factory=list)   # on the channel's device


def _control_group(mesh):
    """A gloo group on the CPU over this rank's tp row, made once per mesh
    and kept on it, so the channels built on one mesh, one after another,
    share it (the first is collective: every rank of the world creates
    every row's group, in the same order)."""
    from edl_tpu_torch.parallel.mesh import AXIS_ORDER, rank_array

    mine = getattr(mesh, "_spmd_control", None)
    if mine is not None:
        return mine
    arr = np.moveaxis(rank_array(mesh), AXIS_ORDER.index("tp"), -1)
    me = dist.get_rank()
    for row in arr.reshape(-1, arr.shape[-1]):
        g = dist.new_group([int(r) for r in row], backend="gloo",
                           timeout=timedelta(seconds=TIMEOUT))
        if me in row:
            mine = g
    mesh._spmd_control = mine
    return mine


def _spec(t: torch.Tensor) -> list[int]:
    return [_CODE[t.dtype], t.ndim, *t.shape]


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().reshape(-1).view(torch.uint8)


class Channel:
    """The command channel of this rank's ``tp`` group of ``mesh`` (built
    by every rank of the world at the same point: it creates the control
    groups).  ``device``: where device operands live (the model's card,
    or the CPU)."""

    def __init__(self, mesh, device: torch.device | str):
        self.tp = TP.of(mesh)
        if self.tp is None:
            raise ValueError("a command channel needs a tp group wider than 1")
        self.device = torch.device(device)
        self.leader = self.tp.rank == 0
        self.src = dist.get_global_rank(self.tp.group, 0)
        self._ctl = _control_group(mesh)
        self._lock = threading.RLock()
        self._objects: dict[int, Any] = {}           # follower: handle -> object
        self._next_handle = 1
        self.sent = 0                                # commands sent (not heartbeats)
        self._dead: list[int] = []                   # leader: handles to drop
        self._closed = False
        self._last_send = time.monotonic()
        self._halt = threading.Event()
        self._beat: threading.Thread | None = None
        if self.leader:
            self._beat = threading.Thread(target=self._heartbeat, daemon=True,
                                          name="spmd-heartbeat")
            self._beat.start()

    # -- handles ---------------------------------------------------------------
    def handle(self, obj) -> int:
        """The leader's handle of ``obj`` (named on first use)."""
        h = getattr(obj, "spmd_handle", None)
        if h is None:
            h = self._next_handle
            self._next_handle += 1
            obj.spmd_handle = h
            weakref.finalize(obj, self._dead.append, h)
        return h

    def adopt(self, h: int, obj):
        """A follower files ``obj`` as the twin of the leader's handle ``h``."""
        obj.spmd_handle = h
        self._objects[h] = obj
        return obj

    def lookup(self, h: int):
        return self._objects[h]

    # -- the leader ------------------------------------------------------------
    def send(self, op: int, ints=(), arrays=(), tensors=()) -> None:
        """Broadcast one command (leader only).  ``arrays``: host arrays or
        CPU tensors; ``tensors``: tensors on the channel's device."""
        if not self.leader:
            raise RuntimeError("only the tp leader sends commands")
        arrays = [torch.as_tensor(np.ascontiguousarray(a)) if isinstance(a, np.ndarray) else a
                  for a in arrays]
        with self._lock:
            if self._closed:
                raise RuntimeError("the tp group's channel is closed")
            self.sent += 1
            self._send_locked(op, [int(i) for i in ints], arrays, list(tensors))

    def _send_locked(self, op, ints, arrays, tensors) -> None:
        dead = []
        while self._dead:             # list.pop is atomic against a finalizer
            dead.append(self._dead.pop())
        meta = [op, len(ints), *ints, len(dead), *dead, len(arrays)]
        for a in arrays:
            meta += _spec(a)
        meta.append(len(tensors))
        for t in tensors:
            meta += _spec(t)
        head = torch.zeros(_HEADER, dtype=torch.int64)
        head[0] = len(meta)
        if len(meta) < _HEADER:
            head[1:1 + len(meta)] = torch.tensor(meta, dtype=torch.int64)
        dist.broadcast(head, self.src, group=self._ctl)
        if len(meta) >= _HEADER:
            dist.broadcast(torch.tensor(meta, dtype=torch.int64), self.src, group=self._ctl)
        for a in arrays:
            if a.numel():
                dist.broadcast(_as_bytes(a), self.src, group=self._ctl)
        for t in tensors:
            if t.numel():
                dist.broadcast(_as_bytes(t), self.src, group=self.tp.group)
        self._last_send = time.monotonic()

    def broadcast(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as the leader holds it, on every rank (in place), over the
        ``tp`` group: what a follower computed is replaced."""
        dist.broadcast(t, self.src, group=self.tp.group)
        return t

    def hold(self):
        """The send lock (reentrant), for a leader whose command is followed
        by more traffic on the control group (:meth:`gather_to_leader`):
        held across both, no heartbeat comes between them."""
        return self._lock

    def gather_to_leader(self, t: torch.Tensor) -> list[torch.Tensor] | None:
        """Every rank's tensor ``t`` (one shape and dtype on all), in tp
        order, on the leader's CPU (None on the others), over the control
        group.  The leader calls it under :meth:`hold`, with the command
        that asked for it."""
        buf = _as_bytes(t.cpu())
        parts = [torch.empty_like(buf) for _ in range(self.tp.size)] if self.leader else None
        dist.gather(buf, parts, dst=self.src, group=self._ctl)
        if parts is None:
            return None
        return [p.view(t.dtype).reshape(t.shape) for p in parts]

    def _heartbeat(self) -> None:
        period = TIMEOUT / 6
        while not self._halt.wait(period / 2):
            if time.monotonic() - self._last_send < period:
                continue
            with self._lock:
                if self._closed:
                    return
                try:
                    self._send_locked(OP_NOOP, [], [], [])
                except Exception as e:  # noqa: BLE001 — the next command fails too
                    logger.warning("tp heartbeat failed: %s", e)
                    return

    def close(self) -> None:
        """Stop the followers (leader; idempotent, best-effort)."""
        self._halt.set()
        if not self.leader:
            return
        with self._lock:
            if self._closed:
                return
            try:
                self._send_locked(OP_STOP, [], [], [])
            except Exception as e:  # noqa: BLE001 — followers time out instead
                logger.warning("tp stop could not reach the followers: %s", e)
            finally:
                self._closed = True

    # -- the followers ---------------------------------------------------------
    def recv(self) -> Command:
        """The next command (follower only).  Raises :class:`FollowerExit`
        when the leader is gone."""
        try:
            head = torch.zeros(_HEADER, dtype=torch.int64)
            dist.broadcast(head, self.src, group=self._ctl)
            n = int(head[0])
            if n < _HEADER:
                meta = head[1:1 + n].tolist()
            else:
                buf = torch.zeros(n, dtype=torch.int64)
                dist.broadcast(buf, self.src, group=self._ctl)
                meta = buf.tolist()
            cmd = Command(meta[0])
            at = 2 + meta[1]
            cmd.ints = meta[2:at]
            n_dead = meta[at]
            for h in meta[at + 1:at + 1 + n_dead]:
                self._objects.pop(h, None)
            at += 1 + n_dead
            specs = []
            for _ in range(2):
                count, at = meta[at], at + 1
                group = []
                for _ in range(count):
                    ndim = meta[at + 1]
                    group.append((_DTYPES[meta[at]], meta[at + 2:at + 2 + ndim]))
                    at += 2 + ndim
                specs.append(group)
            for dtype, shape in specs[0]:
                cmd.arrays.append(self._recv_one(dtype, shape, "cpu", self._ctl))
            for dtype, shape in specs[1]:
                cmd.tensors.append(self._recv_one(dtype, shape, self.device, self.tp.group))
            return cmd
        except FollowerExit:
            raise
        except Exception as e:  # noqa: BLE001 — a dead leader's socket or a timeout
            raise FollowerExit(f"the tp leader is gone: {e}") from e

    def _recv_one(self, dtype, shape, device, group) -> torch.Tensor:
        t = torch.empty(shape, dtype=dtype, device=device)
        if t.numel():
            buf = torch.empty(t.numel() * t.element_size(), dtype=torch.uint8, device=device)
            dist.broadcast(buf, self.src, group=group)
            t = buf.view(dtype).reshape(shape)
        return t

    def serve(self, handlers: dict[int, Callable[[Command], Any]]) -> None:
        """Run commands until the stop (follower only).  Raises
        :class:`FollowerExit` when the leader is gone or a command fails."""
        while True:
            cmd = self.recv()
            if cmd.op == OP_STOP:
                return
            if cmd.op == OP_NOOP:
                continue
            try:
                handlers[cmd.op](cmd)
            except Exception as e:  # noqa: BLE001 — the group cannot go on
                raise FollowerExit(f"command {cmd.op} failed on tp rank {self.tp.rank}: "
                                   f"{e!r}") from e


# -- a tp server's processes ---------------------------------------------------------

def join_group(tp: int, rank: int, addr: str, device: str):
    """Form the ``tp``-process world of a tp server (rank 0 hosts the
    rendezvous at ``addr``, ``host:port``) and return ``(device, mesh)``,
    the mesh ``MeshSpec(dp=1, tp=tp)``: NCCL with card ``rank`` on ``cuda``,
    gloo on the CPU, every wait bounded by :data:`TIMEOUT`.  Fewer
    cards than ``tp`` exit with a message, as the JAX entry points do."""
    from edl_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    from edl_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        if torch.cuda.device_count() < tp:
            raise SystemExit(f"--tp {tp} but only {torch.cuda.device_count()} devices")
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"tcp://{addr}", world_size=tp, rank=rank,
                            timeout=timedelta(seconds=TIMEOUT))
    mesh = build_mesh(MeshSpec(dp=1, tp=tp), pods=[0] * tp, device_type=dev.type)
    return dev, mesh


def die_with_parent() -> None:
    """Have this process SIGKILLed when its parent dies
    (``PR_SET_PDEATHSIG``): a follower's first call.  (A parent gone before
    it ran leaves no rendezvous to join, so the follower fails there.)"""
    import ctypes
    import signal

    ctypes.CDLL("libc.so.6", use_errno=True).prctl(1, int(signal.SIGKILL))


def lead_group(module: str, argv: list[str], tp: int, device: str):
    """Rank 0 of a tp server: spawn ranks 1..tp-1 as ``python -m module
    *argv --tp_rank r --tp_addr addr`` (their stdout discarded, their
    stderr this process's; each calls :func:`die_with_parent`), form the
    group and return ``(mesh, followers)``.  Spawn from the main thread."""
    import os
    import subprocess
    import sys

    from edl_tpu_torch.utils.network import find_free_port

    if torch.device(device).type == "cuda" and torch.cuda.device_count() < tp:
        raise SystemExit(f"--tp {tp} but only {torch.cuda.device_count()} devices")
    addr = f"127.0.0.1:{find_free_port()}"
    followers = [subprocess.Popen([sys.executable, "-m", module, *argv, "--tp_rank", str(r),
                                   "--tp_addr", addr],
                                  stdout=subprocess.DEVNULL, env=dict(os.environ))
                 for r in range(1, tp)]
    try:
        _, mesh = join_group(tp, 0, addr, device)
    except BaseException:
        reap(followers, 0)
        raise
    return mesh, followers


def reap(followers, timeout: float = 30.0) -> None:
    """Wait for the followers (the channel's stop reached them), killing any
    still alive after ``timeout`` seconds."""
    deadline = time.monotonic() + timeout
    for proc in followers:
        try:
            proc.wait(timeout=max(0.0, deadline - time.monotonic()))
        except Exception:  # noqa: BLE001 — a follower that hangs is killed
            proc.kill()
            proc.wait()


def follower_exit(code: int) -> None:
    """End a follower's process at once: a group's teardown would wait on a
    leader that may be gone."""
    import os
    import sys

    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)
