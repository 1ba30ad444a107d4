"""The delta replication plane (a port of the JAX package's
``memstate/delta.py`` without its metrics): failover that loses at most
``EDL_TPU_DELTA_EVERY`` steps instead of a checkpoint interval.

Every ``EDL_TPU_DELTA_EVERY`` steps the producing trainer (global rank 0,
which holds the replicated state) host-snapshots its shards, diffs their
CRCs against the last sealed record, and pushes only the changed shards,
off the step path on one worker thread, to its own pod's cache service and
to the pod's ring replica.

A chain is identified by ``(owner pod, src)``, ``src`` the producing
process.  Records link hash to hash from an anchor derived from the base
step (the committed checkpoint the diff is against):

    prev_0 = sha1("edl-delta-anchor:<base_step>")
    hash_i = sha1(prev_{i-1}, step_i, seq_i, sorted (key, crc32, nbytes))

so a verifier detects a torn chain with no trust in the holder, and the
per-shard CRCs guard the bytes.  Record payloads ride the ordinary
``cache_put_chunk``/``cache_fetch`` calls under the wire owner
``~delta:<owner>:<src>:<seq>``.  A step F is recoverable iff every producer
has an intact record at exactly F and the producer count matches the
records' claim; the overlay for F is the base set patched by each chain's
records up to F.  Chains are bounded by ``EDL_TPU_DELTA_MAX_CHAIN`` and
compacted by the next checkpoint commit, on which the producer re-anchors
(:meth:`DeltaReplicator.rebase`).
"""

from __future__ import annotations

import hashlib
import json
import logging
import queue
import threading

from edl_tpu_torch.memstate import advert, placement, shards
from edl_tpu_torch.utils import constants

logger = logging.getLogger(__name__)

# the owner namespace record payloads ride under ('~' cannot start a pod id)
WIRE_PREFIX = "~delta:"


def anchor_hash(base_step: int) -> str:
    """The chain anchor: the ``prev`` of a chain's first record."""
    return hashlib.sha1(f"edl-delta-anchor:{int(base_step)}".encode()).hexdigest()


def chain_hash(prev_hash: str, step: int, seq: int, manifest: dict) -> str:
    """One record's hash, linking ``prev_hash``: the step, the seq and the
    manifest's (key, crc, nbytes) triples."""
    body = json.dumps([prev_hash, int(step), int(seq),
                       sorted((k, int(e["crc"]), int(e["nbytes"])) for k, e in manifest.items())],
                      separators=(",", ":"))
    return hashlib.sha1(body.encode()).hexdigest()


def wire_owner(owner: str, src: str, seq: int) -> str:
    """The owner string one record's payload is staged and fetched under."""
    return f"{WIRE_PREFIX}{owner}:{src}:{int(seq)}"


def parse_wire_owner(s: str):
    """``(owner, src, seq)`` of a delta wire owner, else None."""
    if not isinstance(s, str) or not s.startswith(WIRE_PREFIX):
        return None
    try:
        owner, src, seq = s[len(WIRE_PREFIX):].rsplit(":", 2)
        return owner, src, int(seq)
    except ValueError:
        return None


def intact_prefix(base_step: int, records: list) -> list:
    """The longest verified prefix of ``records``: seq contiguous from 1,
    steps increasing past the base, every link recomputed from the
    record's own manifest."""
    prev = anchor_hash(base_step)
    nseq, last_step = 1, int(base_step)
    out = []
    for rec in sorted(records or [], key=lambda r: int(r.get("seq", 0))):
        step, seq = int(rec.get("step", -1)), int(rec.get("seq", -1))
        if (seq != nseq or step <= last_step or rec.get("prev") != prev
                or chain_hash(prev, step, seq, rec.get("shards") or {}) != rec.get("hash")):
            break
        out.append(rec)
        prev, nseq, last_step = rec["hash"], nseq + 1, step
    return out


def plan_freshest(committed: int, listings: dict, max_step: int | None = None):
    """The freshest recoverable overlay over the ``committed`` base, or
    None.  ``listings``: ``{pod: cache_delta_manifest()}``.  Returns
    ``{"step": F, "overlay": {key: (ent, [(pod, ent, wire_owner)])},
    "meta": [(pod, wire_owner)]}``; ``max_step`` bounds F."""
    producers: dict[tuple, dict[int, list]] = {}
    nproc_at: dict[int, int] = {}
    for pod, listing in (listings or {}).items():
        for ch in (listing or {}).values():
            if int(ch.get("base_step", -1)) != int(committed):
                continue
            by = producers.setdefault((str(ch.get("owner")), str(ch.get("src", "0"))), {})
            for rec in intact_prefix(committed, ch.get("records")):
                step = int(rec["step"])
                if max_step is not None and step > int(max_step):
                    break
                by.setdefault(step, []).append((pod, rec))
                n = int(rec.get("nproc") or 0)
                if n:
                    nproc_at[step] = max(nproc_at.get(step, 0), n)
    producers = {p: by for p, by in producers.items() if by}
    if not producers:
        return None
    # every producer needs an intact record at exactly F, and as many
    # producers as the records claim: never a torn mix of steps
    target = None
    for step in sorted({s for by in producers.values() for s in by}, reverse=True):
        want = nproc_at.get(step, 0) or len(producers)
        if len(producers) == want and all(step in by for by in producers.values()):
            target = step
            break
    if target is None:
        return None
    overlay: dict[str, tuple] = {}
    meta_srcs: list[tuple[str, str]] = []
    for (owner, src), by in producers.items():
        for step in sorted(by):
            if step > target:
                break
            recs = by[step]
            w = wire_owner(owner, src, int(recs[0][1]["seq"]))
            for key, ent in (recs[0][1].get("shards") or {}).items():
                overlay[key] = (ent, [(pod, ent, w) for pod, _r in recs])
            if step == target:
                meta_srcs.extend((pod, w) for pod, rec in recs if rec.get("has_meta"))
    return {"step": target, "overlay": overlay, "meta": meta_srcs}


def probe_freshest(store, job_id: str):
    """``(committed, freshest)``: the committed base step and the freshest
    recoverable delta step past it (each or None), from manifests only."""
    committed = advert.read_committed_step(store, job_id)
    if committed is None:
        return None, None
    from edl_tpu_torch.rpc.client import RpcChannelPool

    listings: dict[str, dict] = {}
    for pod, ep in advert.list_adverts(store, job_id).items():
        try:
            with RpcChannelPool(ep) as pool:
                listings[pod] = pool.call("cache_delta_manifest")
        except Exception as e:  # noqa: BLE001 — a dead peer holds no chains
            logger.debug("delta probe: %s unreachable (%s)", pod[:8], e)
    plan = plan_freshest(committed, listings)
    return committed, (None if plan is None else int(plan["step"]))


class DeltaReplicator:
    """The trainer-side delta producer.  The loop calls :meth:`want` and
    :meth:`stage` (the host snapshot is the only cost on the step path) and
    :meth:`rebase` after every checkpoint save.  A target that rejects or
    misses a sealed record has a gap and is skipped until the next rebase;
    if no target seals a record the diff baseline stays, so the next record
    carries the accumulated changes under the same seq.

    Every rank keeps one (``want`` must agree across ranks, for the
    collective sync the trainer runs before staging); only the producing
    rank snapshots and pushes.  One staged snapshot waits while a record is
    pushed: a newer stage replaces it (it carries every change since the
    last sealed record), so a slow wire costs freshness, never more than two
    host copies of the state."""

    def __init__(self, store, job_id: str, pod_id: str, src: str = "0",
                 every: int | None = None, max_chain: int | None = None):
        self._store = store
        self._job_id = job_id
        self._pod_id = pod_id
        self._src = src
        self._every = constants.delta_every() if every is None else int(every)
        self._max_chain = constants.delta_max_chain() if max_chain is None else int(max_chain)
        self._base: int | None = None
        self._staged = 0
        self._slot = None                # the staged snapshot awaiting the worker
        self._slot_lock = threading.Lock()
        self._q: queue.Queue = queue.Queue()
        self._pools: dict[str, tuple[str, object]] = {}
        self.stats = {"records": 0, "coalesced": 0, "failed": 0, "bytes": 0,
                      "stage_s": 0.0, "push_s": 0.0}
        self._worker = threading.Thread(target=self._run, daemon=True, name="memstate-delta")
        self._worker.start()

    # -- producer side (the train loop) ---------------------------------------
    def want(self, step: int) -> bool:
        """Is ``step`` a staging step?  The same answer on every rank."""
        return (self._every > 0 and self._base is not None and self._staged < self._max_chain
                and int(step) > self._base and int(step) % self._every == 0)

    def stage(self, step: int, state, meta=None) -> None:
        """Start the host snapshot of ``state`` and queue the diff and push."""
        import time

        self._staged += 1
        if not shards.is_producer():
            return
        t0 = time.perf_counter()
        with self._slot_lock:
            older, self._slot = self._slot, None
        if older is not None:
            # not taken by the worker yet: the newer copy replaces it, into
            # its buffers (the copies run in order on the same streams)
            self.stats["coalesced"] += 1
        item = (int(step), shards.snapshot(state, reuse=older[1] if older else None),
                None if meta is None else meta.to_json().encode())
        self.stats["stage_s"] += time.perf_counter() - t0
        with self._slot_lock:
            self._slot = item
        self._q.put(("push",))

    def rebase(self, step: int, state) -> None:
        """A checkpoint landed at ``step``: snapshot the new base's CRCs and
        start a fresh chain anchored on it.  Every rank calls it."""
        self._base = int(step)
        self._staged = 0
        if shards.is_producer():
            self._q.put(("rebase", int(step), shards.snapshot(state)))

    def flush(self, timeout: float = 10.0) -> bool:
        """Wait (bounded) until everything queued so far is processed."""
        done = threading.Event()
        self._q.put(("flush", done))
        return done.wait(timeout)

    def close(self, wait: bool = True) -> None:
        """Stop the worker; ``wait=False`` only signals (a reshard must not
        block on an RPC to a dead peer)."""
        self._q.put(None)
        if wait:
            self._worker.join(timeout=30.0)

    # -- worker side ----------------------------------------------------------
    def _run(self) -> None:
        import time

        base: int | None = None
        seq, prev = 0, ""
        ref: dict[str, int] = {}      # key -> crc as of the last sealed record
        broken: set[str] = set()      # targets with a gap, until the rebase
        while True:
            op = self._q.get()
            if op is None:
                for _ep, pool in self._pools.values():
                    pool.close()
                self._pools.clear()
                return
            try:
                if op[0] == "rebase":
                    _, step, snap = op
                    shards.finish_manifest(snap)
                    snap.release()
                    ref = {k: int(e["crc"]) for k, e in snap.manifest.items()}
                    base, seq, prev = step, 0, anchor_hash(step)
                    broken.clear()
                elif op[0] == "push":
                    with self._slot_lock:
                        item, self._slot = self._slot, None
                    if item is None:
                        continue    # a replaced snapshot's token
                    step, snap, meta_json = item
                    if base is None or step <= base or seq >= self._max_chain > 0:
                        snap.release()
                        continue
                    t0 = time.perf_counter()
                    blobs = shards.finish_manifest(snap)
                    changed = {k: b for k, b in blobs.items()
                               if int(snap.manifest[k]["crc"]) != ref.get(k)}
                    rec_manifest = {k: dict(snap.manifest[k]) for k in changed}
                    nseq = seq + 1
                    ch = chain_hash(prev, step, nseq, rec_manifest)
                    try:
                        sealed = self._push_record(base, step, nseq, prev, ch, changed,
                                                   rec_manifest, meta_json, broken)
                    finally:
                        snap.release()
                    if sealed:
                        seq, prev = nseq, ch
                        ref.update({k: int(e["crc"]) for k, e in rec_manifest.items()})
                        self.stats["records"] += 1
                        self.stats["bytes"] += sum(int(e["nbytes"]) for e in rec_manifest.values())
                    else:
                        self.stats["failed"] += 1
                    self.stats["push_s"] += time.perf_counter() - t0
                elif op[0] == "flush":
                    op[1].set()
            except Exception:  # noqa: BLE001 — deltas are best-effort
                logger.exception("delta replicator op %s failed; the chain resumes at the "
                                 "next record", op[0])
                self.stats["failed"] += 1

    def _push_record(self, base, step, nseq, prev, ch, changed, rec_manifest, meta_json,
                     broken) -> bool:
        from edl_tpu_torch.memstate.service import push_shards_parallel

        adverts = advert.list_adverts(self._store, self._job_id)
        targets = [t for t in dict.fromkeys(
            [self._pod_id, placement.replica_for(self._pod_id, list(adverts))])
            if t is not None and t in adverts]
        sealed, errored = False, []
        wire = wire_owner(self._pod_id, self._src, nseq)
        for target in targets:
            if target in broken:
                continue
            try:
                pool = self._pool(target, adverts[target])
                push_shards_parallel(pool, changed, owner=wire, step=step)
                resp = pool.call("cache_delta_commit", owner=self._pod_id, src=self._src,
                                 base_step=base, step=step, seq=nseq, prev_hash=prev,
                                 chain_hash=ch, manifest=rec_manifest, nproc=1,
                                 meta=meta_json) or {}
                if resp.get("ok"):
                    sealed = True
                else:
                    broken.add(target)  # a gap on this target until the rebase
                    logger.warning("delta: %s rejected seq %d (%s)", target[:8], nseq,
                                   resp.get("reason"))
            except Exception as e:  # noqa: BLE001 — per-target best effort
                errored.append(target)
                self._drop_pool(target)
                logger.warning("delta: push of seq %d to %s failed (%s)", nseq, target[:8], e)
        if sealed:
            broken.update(errored)   # missed a record the others sealed
        return sealed

    def _pool(self, target: str, endpoint: str):
        cached = self._pools.get(target)
        if cached is not None and cached[0] == endpoint:
            return cached[1]
        self._drop_pool(target)
        from edl_tpu_torch.rpc.client import RpcChannelPool
        pool = RpcChannelPool(endpoint)
        self._pools[target] = (endpoint, pool)
        return pool

    def _drop_pool(self, target: str) -> None:
        cached = self._pools.pop(target, None)
        if cached is not None:
            cached[1].close()
