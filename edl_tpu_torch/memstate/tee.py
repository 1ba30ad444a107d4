"""StateCacheTee: the trainer-side producer of the peer checkpoint cache (a
port of the JAX package's ``memstate/tee.py``).

``CheckpointManager.save`` calls :meth:`stage` on the writing rank: the
host snapshot starts there, before the next optimizer step updates the
state in place (``memstate/shards.py`` fences it); the CRCs and the chunked
push to the pod's cache service run on one worker thread.  Sealing is
two-phase: a pushed set stays staged until :meth:`mark_committed`, called
by ``CheckpointManager.wait()`` once the storage save is durable, promotes
it and writes the job-wide committed-step record.  A cache entry never
claims a step that storage does not also hold.  With a sharded state each
rank's tee seals its own pieces, and the record waits for every rank's
seal: :meth:`mark_committed` with ``record=False``, a barrier, then
:meth:`publish_committed` on the writing rank (``CheckpointManager.wait``).
Such a seal also waits (bounded) until the pod's ring replica holds the
set: a rank's pieces exist nowhere else, so a pod lost between its commit
and the service's replication would cost every survivor a storage restore.
"""

from __future__ import annotations

import functools
import logging
import queue
import threading
import time
import zlib

from edl_tpu_torch.memstate import advert, shards

logger = logging.getLogger(__name__)


class StateCacheTee:
    """``stats`` sums ``stage_s`` (the synchronous snapshot), ``push_s``,
    ``pushed_bytes`` and counts ``sets``, the sets sealed."""

    def __init__(self, store, job_id: str, pod_id: str):
        self._store = store
        self._job_id = job_id
        self._pod_id = pod_id
        self._q: queue.Queue = queue.Queue()
        self._pool = None
        self._pushed_step: int | None = None   # the worker's
        self.stats = {"stage_s": 0.0, "push_s": 0.0, "pushed_bytes": 0, "sets": 0}
        self._worker = threading.Thread(target=self._run, daemon=True, name="memstate-tee")
        self._worker.start()

    # -- producer side (the train loop) ---------------------------------------
    def stage(self, step: int, state, meta) -> None:
        """Start the host snapshot of ``state`` and queue the push (the
        meta sidecar goes with it)."""
        t0 = time.perf_counter()
        snap = shards.snapshot(state)
        self.stats["stage_s"] += time.perf_counter() - t0
        if not snap.manifest:
            return   # none of this rank's pieces is a first replica
        self._q.put(("push", int(step), snap, None if meta is None else meta.to_json().encode()))

    def mark_committed(self, flush_timeout: float = 10.0, record: bool = True) -> None:
        """Storage is durable: seal everything pushed so far, and wait
        (bounded) for the seal, which matters at the exits that follow a
        final save.  In steady state the shards were pushed during the
        epoch, so this waits only for the commit call.  ``record=False``:
        the committed-step record waits for :meth:`publish_committed`."""
        self._q.put(("commit", record))
        self._flush(flush_timeout)

    def publish_committed(self, flush_timeout: float = 10.0) -> None:
        """Write the committed-step record of the sets sealed without one
        (every rank's pieces are sealed by now)."""
        self._q.put(("publish",))
        self._flush(flush_timeout)

    def _flush(self, timeout: float) -> None:
        if timeout > 0:
            done = threading.Event()
            self._q.put(("flush", done))
            done.wait(timeout)

    def update_meta(self, step: int, meta) -> None:
        """Re-push only the sidecar of a sealed step (``save_meta``)."""
        self._q.put(("meta", int(step), meta.to_json().encode()))

    def close(self) -> None:
        self._q.put(None)
        self._worker.join(timeout=30.0)
        if self._pool is not None:
            self._pool.close()

    # -- worker side ----------------------------------------------------------
    def _run(self) -> None:
        pending: dict[int, tuple[dict, bytes | None]] = {}  # pushed, not sealed
        unpublished: list[int] = []    # sealed with a sidecar, record not written
        while True:
            op = self._q.get()
            if op is None:
                return
            try:
                if op[0] == "push":
                    _, step, snap, meta_json = op
                    if self._pushed_step is not None and step <= self._pushed_step:
                        continue   # a newer save supersedes this one
                    try:
                        self._push(step, snap)
                    finally:
                        snap.release()
                    pending[step] = (snap.manifest, meta_json)
                    self._pushed_step = step
                elif op[0] == "commit":
                    for step in sorted(pending):
                        manifest, meta_json = pending.pop(step)
                        resp = self._call("cache_commit", owner=self._pod_id, step=step,
                                          manifest=manifest, meta=meta_json)
                        if not (resp or {}).get("ok"):
                            continue  # refused (a newer set sealed): no record
                        self.stats["sets"] += 1
                        if meta_json is not None and op[1]:
                            advert.write_committed_step(self._store, self._job_id, step)
                        elif meta_json is not None:
                            unpublished.append(step)
                        if not op[1]:
                            self._await_replica(step)
                elif op[0] == "publish":
                    for step in unpublished:
                        advert.write_committed_step(self._store, self._job_id, step)
                    unpublished.clear()
                elif op[0] == "flush":
                    op[1].set()
                elif op[0] == "meta":
                    _, step, meta_json = op
                    from edl_tpu_torch.rpc import chunks
                    key = "__meta__"   # a sealed sidecar patch: a tiny re-commit
                    chunks.push_bytes(functools.partial(self._call, "cache_put_chunk",
                                                        owner=self._pod_id, step=step,
                                                        key=key), meta_json)
                    self._call("cache_commit", owner=self._pod_id, step=step,
                               manifest={key: {"crc": zlib.crc32(meta_json),
                                               "nbytes": len(meta_json), "dtype": "meta",
                                               "shape": [], "index": [], "gshape": [],
                                               "leaf": key}},
                               meta=meta_json)
            except Exception:  # noqa: BLE001 — the cache is best-effort
                logger.exception("memstate tee op %s failed; the next restore falls back to "
                                 "storage", op[0])
                if self._pool is not None:
                    self._pool.close()
                self._pool = None

    def _push(self, step: int, snap) -> None:
        from edl_tpu_torch.memstate.service import push_shards_parallel

        blobs = shards.finish_manifest(snap)
        total = sum(len(b) for b in blobs.values())
        t0 = time.perf_counter()
        push_shards_parallel(self._channels(), blobs, owner=self._pod_id, step=step)
        dt = time.perf_counter() - t0
        self.stats["push_s"] += dt
        self.stats["pushed_bytes"] += total
        logger.info("memstate: staged step %d (%d shards, %d bytes, %.1f MiB/s) to the local "
                    "cache", step, len(blobs), total, total / (1 << 20) / max(dt, 1e-9))

    def _await_replica(self, step: int, timeout: float = 5.0) -> None:
        """Poll the ring replica's manifest until it holds this pod's set at
        ``step`` (the service replicates after a commit), at most
        ``timeout`` seconds; a miss is logged, not raised."""
        from edl_tpu_torch.memstate import placement
        from edl_tpu_torch.rpc.client import RpcChannelPool

        adverts = advert.list_adverts(self._store, self._job_id)
        target = placement.replica_for(self._pod_id, list(adverts))
        if target is None or target not in adverts:
            return
        pool = RpcChannelPool(adverts[target])
        deadline = time.monotonic() + timeout
        try:
            while time.monotonic() < deadline:
                info = pool.call("cache_manifest").get(self._pod_id)
                if info is not None and int(info["step"]) >= step:
                    return
                time.sleep(0.02)
        except Exception:  # noqa: BLE001 — a lost replica is not the commit's failure
            logger.exception("memstate: the ring replica %s did not answer", target[:8])
            return
        finally:
            pool.close()
        logger.warning("memstate: the ring replica %s did not hold step %d within %.0fs",
                       target[:8], step, timeout)

    def _channels(self):
        """The channel pool to the own pod's cache service (lazy: the advert
        may not exist yet when the tee is built)."""
        if self._pool is None:
            ep = advert.list_adverts(self._store, self._job_id).get(self._pod_id)
            if ep is None:
                raise ConnectionError(f"no memstate advert for own pod {self._pod_id[:8]}")
            from edl_tpu_torch.rpc.client import RpcChannelPool
            self._pool = RpcChannelPool(ep)
        return self._pool

    def _call(self, method: str, **kw):
        return self._channels().call(method, **kw)
