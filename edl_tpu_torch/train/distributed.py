"""Multi-process bootstrap: a ``torch.distributed`` world from the
launcher's environment (the port of the JAX package's
``train/distributed.py``).

The launcher exports ``EDL_TPU_TRAINER_*`` (``cluster/env.py``);
:func:`initialize_from_env` turns that env into ``init_process_group``:
NCCL on the card, gloo on the CPU, rank and world from the env.  At world
size 1 nothing is formed, so the same script runs standalone, under tests
and under the launcher.

Two rendezvous:

- stop-resume (``EDL_TPU_RESIZE_DELTA=0``, or no launcher store): the
  launcher restarts every trainer on a membership change, and a world is
  formed once per process at ``tcp://<EDL_TPU_COORDINATOR>``, the rank-0
  trainer's endpoint;
- the resizable world (``EDL_TPU_RESIZE_DELTA``, on by default under the
  launcher): trainers survive a membership change and :func:`reform_world`
  re-forms the group in the same process.  The launcher's
  ``worldsvc/<stage>`` record (``cluster/resize.py``) names a JAX
  coordination service, which a torch trainer never connects to: rank 0
  reads it (a record of the stage's world size, no older than this
  process's spawn, ``EDL_TPU_SPAWN_TS``) as the generation nonce and
  relays it as the stage's gate record, which the other ranks wait for;
  when the launcher published none (its JAX service could not be hosted),
  rank 0 relays a nonce of its own.  The group forms through
  :class:`CoordRendezvousStore`, a ``torch.distributed.Store`` over the
  coordination store, under ``<job>/torchworld/<stage>/<nonce>/``:
  the coordination store outlives every trainer, binds no port here, and a
  same-stage re-formation (a hang restart) gets a fresh endpoint, so it
  never meets stale keys.  :func:`leak_world` tears a group down and drops
  every reference to it (``destroy_process_group``, or an abort of the
  NCCL communicators when a member may be gone); under NCCL the group's
  timeout is ``EDL_TPU_RESIZE_RESHARD_TIMEOUT``.

:func:`connect_store` imports the store client (and with it ``msgpack``)
only when the env names a store; the client it returns retries, backs
off and fails over on every op (``coord/resilient.py``).

:func:`allgather_flag` and :func:`allgather_rows` are the small host-value
gathers of the data service (its per-step has-next agreement and the data
checkpoint's merge) and of the trainer's agreements: CPU tensors under
gloo, CUDA tensors under NCCL.
"""

from __future__ import annotations

import datetime
import inspect
import json
import logging
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from edl_tpu_torch.cluster.env import TrainerEnv
from edl_tpu_torch.utils import constants

logger = logging.getLogger(__name__)


# the formed resizable world's rendezvous client, when this module opened it
# (closed with the group)
_OWNED_KV: list = []
# the formed resizable world's rendezvous store: the group keeps only its
# C++ half, so the Python object (whose methods every later new_group
# calls, a mesh's sub-groups) is held here until the group goes
_STORES: list = []


class CoordRendezvousStore(dist.Store):
    """A ``torch.distributed.Store`` over a coordination-store client
    (``coord/kv.py``: ``get``, ``put``, ``put_if_absent``,
    ``put_if_equals``, ``delete``, ``get_prefix``), every key under
    ``prefix``.  A blocking ``get``/``wait`` polls with backoff until the
    store's timeout; ``add`` and ``compare_set`` are compare-and-swap
    loops on the store's guarded puts, so they are atomic across processes."""

    def __init__(self, kv, prefix: str, timeout: float):
        super().__init__()
        self._kv = kv
        self._prefix = prefix
        self.set_timeout(datetime.timedelta(seconds=timeout))

    def _key(self, key: str) -> str:
        return self._prefix + key

    def _poll(self, key: str, deadline: float) -> bytes:
        delay = 0.002
        while True:
            rec = self._kv.get(self._key(key))
            if rec is not None:
                return rec.value
            if time.monotonic() > deadline:
                raise RuntimeError(f"rendezvous key {key!r} not set within the timeout")
            time.sleep(delay)
            delay = min(2 * delay, 0.05)

    def set(self, key, value):
        self._kv.put(self._key(key), bytes(value))

    def get(self, key):
        return self._poll(key, time.monotonic() + self.timeout.total_seconds())

    def add(self, key, amount):
        k = self._key(key)
        while True:
            rec = self._kv.get(k)
            if rec is None:
                if self._kv.put_if_absent(k, str(int(amount)).encode()):
                    return int(amount)
                continue
            new = int(rec.value) + int(amount)
            if self._kv.put_if_equals(k, rec.value, k, str(new).encode()):
                return new

    def compare_set(self, key, expected, desired):
        k = self._key(key)
        expected, desired = bytes(expected), bytes(desired)
        while True:
            rec = self._kv.get(k)
            if rec is None:
                if not expected and self._kv.put_if_absent(k, desired):
                    return desired
                if expected:
                    return expected  # absent: torch's stores answer with the expected value
                continue
            if rec.value != expected:
                return rec.value
            if self._kv.put_if_equals(k, expected, k, desired):
                return desired

    def check(self, keys):
        return all(self._kv.get(self._key(k)) is not None for k in keys)

    def wait(self, keys, timeout=None):
        t = self.timeout if timeout is None else timeout
        deadline = time.monotonic() + t.total_seconds()
        for k in keys:
            self._poll(k, deadline)

    def delete_key(self, key):
        return bool(self._kv.delete(self._key(key)))

    def num_keys(self):
        return len(self._kv.get_prefix(self._prefix)[0])



def _delta_enabled(tenv: TrainerEnv) -> bool:
    """The launcher's live-reshard path engages under the launcher
    (stage and store named) unless ``EDL_TPU_RESIZE_DELTA=0``."""
    return bool(constants.resize_delta() and tenv.cluster_stage and tenv.coord_endpoints)


def _world_gate(tenv: TrainerEnv, kv, deadline: float, min_ts: float) -> str:
    """The generation nonce of ``tenv``'s formation.  Rank 0, whose pod's
    launcher publishes the stage's ``worldsvc`` record before rank 0 can
    form (before it spawns it, or before the go record of a reshard), takes
    the record's endpoint, or its own nonce when the launcher published none
    (a launcher that cannot host its JAX coordination service), and writes
    it as the stage's gate; every other rank waits for that gate (the
    stage's world size, ``ts >= min_ts``), so all ranks agree."""
    import uuid

    from edl_tpu_torch.cluster import paths, resize

    gate_key = paths.key(tenv.job_id, constants.ETCD_TORCH_WORLD, f"{tenv.cluster_stage}/gate")

    def fresh(rec) -> bool:
        return (rec is not None and rec.get("world") == tenv.world_size
                and float(rec.get("ts", 0.0)) >= min_ts)

    if tenv.global_rank == 0:
        grace = time.monotonic() + 2.0   # store lag: the record precedes this process
        while True:
            rec = resize.read_world_service(kv, tenv.job_id, tenv.cluster_stage)
            if fresh(rec):
                nonce = rec["endpoint"]
                break
            if time.monotonic() > min(grace, deadline):
                nonce = f"nonce-{uuid.uuid4().hex}"
                logger.warning("no world-service record for stage %s: rank 0 chose %s",
                               tenv.cluster_stage[:8], nonce)
                break
            time.sleep(0.1)
        kv.put(gate_key, json.dumps({"nonce": nonce, "world": tenv.world_size,
                                     "ts": time.time()}).encode())
        return nonce
    while time.monotonic() < deadline:
        rec = kv.get(gate_key)
        gate = json.loads(rec.value.decode()) if rec is not None and rec.value else None
        if fresh(gate):
            return gate["nonce"]
        time.sleep(0.1)
    raise RuntimeError(f"no world gate for stage {tenv.cluster_stage[:8]} within the timeout")


def _form_resizable_world(tenv: TrainerEnv, kv, timeout: float, device,
                          min_ts: float = 0.0) -> float:
    """Form ``tenv``'s world through the coordination store: agree on the
    stage's nonce (:func:`_world_gate`), then ``init_process_group`` over a
    :class:`CoordRendezvousStore` under it.  Returns the seconds the group
    took to form once the gate opened."""
    from edl_tpu_torch.cluster import paths

    nonce = _world_gate(tenv, kv, time.monotonic() + timeout, min_ts)
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    kwargs = {}
    if backend == "nccl":
        _bind_device(tenv)
        if "device_id" in inspect.signature(dist.init_process_group).parameters:
            # the communicator forms now, while the rendezvous keys are fresh
            kwargs["device_id"] = torch.device("cuda", torch.cuda.current_device())
        group_timeout = constants.resize_reshard_timeout()
    else:
        group_timeout = timeout
    store = CoordRendezvousStore(
        kv, paths.key(tenv.job_id, constants.ETCD_TORCH_WORLD,
                      f"{tenv.cluster_stage}/{nonce}/"), timeout)
    logger.info("forming the resizable world %s/%s as rank %d/%d (%s)", tenv.cluster_stage[:8],
                nonce, tenv.global_rank, tenv.world_size, backend)
    t0 = time.perf_counter()
    dist.init_process_group(backend, store=store, world_size=tenv.world_size,
                            rank=tenv.global_rank,
                            timeout=datetime.timedelta(seconds=group_timeout), **kwargs)
    _STORES.append(store)
    return time.perf_counter() - t0


def form_world(tenv: TrainerEnv, kv, device, timeout: float | None = None,
               min_ts: float = 0.0) -> float:
    """Form ``tenv``'s resizable world through ``kv`` at any world size (a
    group of one too) and check its size; the seconds it took to form."""
    seconds = _form_resizable_world(
        tenv, kv, constants.resize_reshard_timeout() if timeout is None else timeout,
        device, min_ts)
    if dist.get_world_size() != tenv.world_size:
        raise RuntimeError(f"resizable world did not form: get_world_size()="
                           f"{dist.get_world_size()}, expected {tenv.world_size}")
    return seconds


def leak_world(abort: bool = False) -> None:
    """Tear the current group down and drop every reference to it:
    ``destroy_process_group``, or with ``abort`` (a member may be gone, and
    NCCL would wait in its teardown) an abort of the communicators first.
    The caller drops its own references to the old state before it
    restores (a live reshard must not hold two copies on the card)."""
    import gc

    if dist.is_initialized():
        if abort and dist.get_backend() == "nccl":
            try:
                dist.distributed_c10d._abort_process_group()
            except Exception:  # noqa: BLE001 — the destroy below still drops it
                logger.exception("NCCL abort failed")
        if dist.is_initialized():
            dist.destroy_process_group()
    _STORES.clear()
    while _OWNED_KV:
        _OWNED_KV.pop().close()
    gc.collect()


def reform_world(tenv: TrainerEnv, store, cluster, device) -> TrainerEnv:
    """Re-form the world in this process against ``cluster`` (the new
    membership record): tear the old group down, update ``tenv`` in place
    (every holder of it sees the new topology) and the process env (so
    ``TrainerEnv()`` agrees), and form the new stage's group through
    ``store``.  Raises on any failure: the caller exits nonzero and the
    launcher stop-resumes."""
    me = cluster.get_pod(tenv.pod_id)
    if me is None:
        raise RuntimeError(f"pod {tenv.pod_id[:8]} is not in stage {cluster.stage[:8]}; "
                           f"cannot reshard into it")
    if tenv.rank_in_pod >= len(me.trainers):
        raise RuntimeError(f"rank_in_pod {tenv.rank_in_pod} exceeds the new pod's "
                           f"{len(me.trainers)} trainers")
    leak_world()
    endpoints = cluster.get_trainers_endpoints()
    tenv.global_rank = me.trainers[tenv.rank_in_pod].global_rank
    tenv.world_size = cluster.world_size
    tenv.trainer_endpoints = list(endpoints)
    tenv.coordinator = endpoints[0] if endpoints else ""
    tenv.pod_rank = me.rank
    tenv.cluster_stage = cluster.stage
    os.environ.update({
        "EDL_TPU_TRAINER_ID": str(tenv.global_rank),
        "EDL_TPU_TRAINERS_NUM": str(tenv.world_size),
        "EDL_TPU_TRAINER_ENDPOINTS": ",".join(endpoints),
        "EDL_TPU_COORDINATOR": tenv.coordinator,
        "EDL_TPU_POD_RANK": str(tenv.pod_rank),
        "EDL_TPU_CLUSTER_STAGE": tenv.cluster_stage,
    })
    if tenv.world_size > 1:
        form_world(tenv, store, device)
    logger.info("world re-formed in place: rank %d/%d, stage %s", tenv.global_rank,
                tenv.world_size, cluster.stage[:8])
    return tenv


def _bind_device(tenv: TrainerEnv) -> None:
    """Make this trainer's card the current CUDA device: the first of
    ``EDL_TPU_DEVICE_IDS`` when the launcher exported any, else the
    trainer's rank in its pod."""
    torch.cuda.set_device(tenv.device_ids[0] if tenv.device_ids else tenv.rank_in_pod)


def initialize_from_env(tenv: TrainerEnv | None = None,
                        device: str | torch.device = "cuda") -> TrainerEnv:
    """Form the process group ``tenv`` describes (idempotent).  World size
    <= 1 forms none.  ``device`` picks the backend: NCCL for ``cuda``
    (after binding the card), gloo for ``cpu``.  Rendezvous is retried
    ``EDL_TPU_DIST_INIT_RETRIES`` times (3) with ``EDL_TPU_DIST_INIT_TIMEOUT``
    seconds each (120), and the formed world's size is checked against
    the env's: a half-formed world fails here, not in a shared checkpoint."""
    tenv = tenv or TrainerEnv()
    if tenv.world_size <= 1 or dist.is_initialized():
        return tenv
    timeout = int(os.environ.get("EDL_TPU_DIST_INIT_TIMEOUT", "120"))
    if _delta_enabled(tenv):
        # the resizable world: reform_world can later reshape it in place.
        # EDL_TPU_SPAWN_TS (stamped by the spawning launcher) bounds how old
        # an acceptable worldsvc record may be; 30 s covers clock slack
        # across hosts and still rejects any earlier formation's record
        from edl_tpu_torch.coord.client import connect
        kv = connect(tenv.coord_endpoints)
        _OWNED_KV.append(kv)
        form_world(tenv, kv, device, float(timeout),
                   min_ts=float(os.environ.get("EDL_TPU_SPAWN_TS", 0.0)) - 30.0)
        return tenv
    coordinator = tenv.coordinator or (tenv.trainer_endpoints[0] if tenv.trainer_endpoints
                                       else "")
    if not coordinator:
        raise RuntimeError("world_size > 1 but no coordinator address: set "
                           "EDL_TPU_COORDINATOR or EDL_TPU_TRAINER_ENDPOINTS")
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if backend == "nccl":
        _bind_device(tenv)
    retries = max(1, int(os.environ.get("EDL_TPU_DIST_INIT_RETRIES", "3")))
    logger.info("init_process_group(%s, tcp://%s, world=%d, rank=%d)", backend,
                coordinator, tenv.world_size, tenv.global_rank)
    for attempt in range(1, retries + 1):
        try:
            dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                                    world_size=tenv.world_size, rank=tenv.global_rank,
                                    timeout=datetime.timedelta(seconds=timeout))
            break
        except (RuntimeError, ValueError, OSError) as e:
            # a loaded host can time the rendezvous out with every peer
            # alive: retry with backoff before declaring the world unformable
            if attempt == retries:
                raise
            logger.warning("distributed init failed (attempt %d/%d): %s; retrying",
                           attempt, retries, e)
            if dist.is_initialized():
                dist.destroy_process_group()
            time.sleep(2.0 * attempt)
    formed = dist.get_world_size()
    if formed != tenv.world_size:
        raise RuntimeError(f"torch.distributed world did not form: get_world_size()="
                           f"{formed}, expected {tenv.world_size} (coordinator {coordinator})")
    return tenv


def connect_store(tenv: TrainerEnv):
    """Coordination-store client for a trainer, or None when running
    standalone (no launcher env, or the store unreachable)."""
    if not (tenv.coord_endpoints and tenv.pod_id):
        return None
    from edl_tpu_torch.coord.client import connect
    try:
        return connect(tenv.coord_endpoints)
    except ConnectionError:
        logger.warning("coordination store unreachable; running standalone")
        return None


def shutdown() -> None:
    leak_world()


def is_coordinator(tenv: TrainerEnv | None = None) -> bool:
    tenv = tenv or TrainerEnv()
    return tenv.global_rank == 0


def _collective_device() -> torch.device:
    """Where a collective's tensors live: the current card under NCCL, the
    CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def allgather_rows(rows: np.ndarray) -> np.ndarray:
    """``rows`` ([n, ...] int32, n the same on every rank) from every rank of
    the process group, stacked in rank order: [world, n, ...]."""
    local = torch.from_numpy(np.ascontiguousarray(rows, np.int32)).to(_collective_device())
    parts = [torch.empty_like(local) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, local)
    return torch.stack(parts).cpu().numpy()


def allgather_flag(flag: int) -> np.ndarray:
    """Every rank's ``flag`` (one int32 each, in rank order): the data
    service's per-step has-next agreement.  Without a process group, just
    this process's."""
    if not dist.is_initialized():
        return np.asarray([flag], np.int32)
    return allgather_rows(np.asarray([flag], np.int32))[:, 0]
