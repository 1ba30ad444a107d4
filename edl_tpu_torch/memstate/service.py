"""StateCacheService: the per-pod in-RAM checkpoint shard cache (a copy of
the JAX package's ``memstate/service.py`` without its metrics and trace
events, on the port's :class:`~edl_tpu_torch.rpc.server.RpcServer`).

It lives in the launcher, which survives every trainer exit, so the cache
does too.  One committed shard-set per owner pod: its own pod's, and the
replica of any owner the hash ring placed here.  Staged chunks live apart
and are promoted by ``cache_commit`` after per-shard CRC verification, so a
reader never sees a torn set.  Delta chains (``memstate/delta.py``) are
held beside the sets and compacted by the next commit.  Every public method
is wire surface (hence the ``cache_`` prefix); the JAX launcher's service
answers the same calls, so a torch trainer pushes to either.
"""

from __future__ import annotations

import logging
import threading
import zlib

from edl_tpu_torch.memstate import advert, delta, placement
from edl_tpu_torch.utils import constants
from edl_tpu_torch.utils.exceptions import EdlInternalError

logger = logging.getLogger(__name__)


def push_shards_parallel(pool, blobs: dict, owner: str, step: int) -> None:
    """Push a shard-set's blobs over ``pool``: distinct shards on distinct
    channels (at most ``EDL_TPU_TRANSFER_WORKERS``), each shard's chunks
    windowed on its channel, largest first.  One key's chunks never split
    across channels, so the receiver's per-key sequence check holds.  The
    first failure propagates; a partial push stays staged and is replaced
    by the next stream."""
    from concurrent.futures import ThreadPoolExecutor

    from edl_tpu_torch.rpc import chunks

    keys = sorted(blobs, key=lambda k: -len(blobs[k]))
    if not keys:
        return

    def push_one(key: str) -> None:
        chunks.push_bytes_pipelined(pool, "cache_put_chunk", blobs[key], owner=owner,
                                    step=int(step), key=key)

    workers = min(len(pool), len(keys), constants.transfer_workers())
    if workers <= 1:
        for key in keys:
            push_one(key)
        return
    with ThreadPoolExecutor(max_workers=workers, thread_name_prefix="memstate-push") as ex:
        list(ex.map(push_one, keys))


class _Set:
    """One committed shard-set: ``{key: bytes}``, its manifest and sidecar."""

    __slots__ = ("step", "shards", "manifest", "meta")

    def __init__(self, step: int):
        self.step = step
        self.shards: dict[str, bytes] = {}
        self.manifest: dict[str, dict] = {}
        self.meta: bytes | None = None

    @property
    def nbytes(self) -> int:
        return sum(len(b) for b in self.shards.values())


class _Staging:
    __slots__ = ("buf", "next_seq", "done")

    def __init__(self):
        self.buf = bytearray()
        self.next_seq = 0
        self.done = False


class _DeltaRec:
    """One sealed delta record: the changed shards' bytes and the chain
    linkage a restorer re-verifies."""

    __slots__ = ("step", "seq", "prev", "hash", "manifest", "shards", "nproc", "meta")

    def __init__(self, step, seq, prev, hash_, manifest, shards_, nproc, meta):
        self.step = int(step)
        self.seq = int(seq)
        self.prev = prev
        self.hash = hash_
        self.manifest = manifest
        self.shards = shards_
        self.nproc = int(nproc)
        self.meta = meta

    @property
    def nbytes(self) -> int:
        return sum(len(b) for b in self.shards.values())


class _Chain:
    """One producer's delta chain over a committed base (``owner/src``)."""

    __slots__ = ("owner", "src", "base_step", "records")

    def __init__(self, owner: str, src: str, base_step: int):
        self.owner = owner
        self.src = src
        self.base_step = int(base_step)
        self.records: list[_DeltaRec] = []

    @property
    def nbytes(self) -> int:
        return sum(r.nbytes for r in self.records)


def _verified(staging: dict, wire: str, step: int, manifest: dict, what: str) -> dict:
    """The staged bytes of every shard ``manifest`` names, each checked
    against its length and CRC (a failed one is dropped and raises)."""
    staged: dict[str, bytes] = {}
    for key, ent in manifest.items():
        st = staging.get((wire, step, key))
        if st is None or not st.done:
            raise EdlInternalError(f"commit of unstaged {what} {key}")
        data = bytes(st.buf)
        if len(data) != int(ent["nbytes"]) or zlib.crc32(data) != int(ent["crc"]):
            staging.pop((wire, step, key), None)
            raise EdlInternalError(f"{what} {key} failed CRC/length verification")
        staged[key] = data
    return staged


class StateCacheService:
    def __init__(self, store, job_id: str, pod_id: str, max_bytes: int | None = None):
        self._store = store
        self._job_id = job_id
        self._pod_id = pod_id
        self._max_bytes = constants.memstate_max_bytes() if max_bytes is None else max_bytes
        self._lock = threading.Lock()
        self._sets: dict[str, _Set] = {}            # owner -> committed set
        self._staging: dict[tuple[str, int, str], _Staging] = {}
        self._chains: dict[str, _Chain] = {}        # "owner/src" -> chain

    # -- push (trainer tee, replicating peer) --------------------------------
    def cache_put_chunk(self, owner: str, step: int, key: str, seq: int, data: bytes,
                        eof: bool) -> dict:
        with self._lock:
            sk = (owner, int(step), key)
            st = self._staging.get(sk)
            if seq == 0:
                # a fresh stream replaces a stale staging of this key: a push
                # killed mid-stream must not poison the restarted trainer's
                st = self._staging[sk] = _Staging()
            elif st is None or seq != st.next_seq:
                self._staging.pop(sk, None)
                raise EdlInternalError(f"chunk seq {seq} != expected "
                                       f"{st.next_seq if st else 0} for {key}")
            if self._over_cap(len(data), owner, int(step)):
                self._staging.pop(sk, None)
                raise EdlInternalError(f"cache over {self._max_bytes}B cap; rejecting {key}")
            st.buf.extend(data)
            st.next_seq += 1
            st.done = bool(eof)
        return {"ok": True}

    def cache_commit(self, owner: str, step: int, manifest: dict,
                     meta: bytes | None = None) -> dict:
        """Seal the staged shards ``manifest`` names into ``owner``'s set
        (merging with a set at the same step), CRC-verified under the lock."""
        step = int(step)
        with self._lock:
            staged = _verified(self._staging, owner, step, manifest, "shard")
            cur = self._sets.get(owner)
            if cur is not None and cur.step > step:
                for key in manifest:
                    self._staging.pop((owner, step, key), None)
                return {"ok": False, "stale": True}
            if cur is None or cur.step < step:
                cur = self._sets[owner] = _Set(step)
            for key, data in staged.items():
                cur.shards[key] = data
                cur.manifest[key] = dict(manifest[key])
                self._staging.pop((owner, step, key), None)
            if meta is not None:
                cur.meta = bytes(meta)
            for sk in [sk for sk in self._staging if sk[0] == owner and sk[1] < step]:
                self._staging.pop(sk, None)
            # the new base subsumes every chain built over an older one
            for cid in [cid for cid, ch in self._chains.items()
                        if ch.owner == owner and ch.base_step < step]:
                self._chains.pop(cid, None)
        if owner == self._pod_id:
            # replicate own sets only; a thread keeps the commit non-blocking
            threading.Thread(target=self._replicate, args=(owner, step), daemon=True,
                             name=f"memstate-repl:{step}").start()
        return {"ok": True}

    # -- read (restoring trainers) -------------------------------------------
    def cache_manifest(self) -> dict:
        """``{owner: {"step", "shards": manifest, "has_meta"}}``."""
        with self._lock:
            return {owner: {"step": s.step, "shards": s.manifest, "has_meta": s.meta is not None}
                    for owner, s in self._sets.items()}

    def cache_fetch(self, owner: str, key: str, offset: int, length: int) -> bytes:
        with self._lock:
            blob = self._blob_locked(owner, key)
            return blob[int(offset):int(offset) + int(length)]

    def cache_fetch_stream(self, owner: str, key: str, offset: int = 0, length: int = -1,
                           chunk_bytes: int = 0):
        """One request, the range as ordered response frames (``length=-1``:
        to the end of the shard)."""
        from edl_tpu_torch.rpc.server import Streaming

        with self._lock:
            data = self._blob_locked(owner, key)   # immutable: stream outside the lock
        offset = max(0, int(offset))
        end = len(data) if int(length) < 0 else min(len(data), offset + int(length))
        cb = int(chunk_bytes) or constants.chunk_bytes()

        def gen(mv=memoryview(data)):
            for pos in range(offset, end, cb):
                yield mv[pos:min(end, pos + cb)]
        return Streaming(gen())

    def cache_meta(self, owner: str) -> bytes | None:
        with self._lock:
            parsed = delta.parse_wire_owner(owner)
            if parsed is not None:
                rec = self._delta_rec_locked(*parsed)
                return None if rec is None else rec.meta
            s = self._sets.get(owner)
            return None if s is None else s.meta

    # -- delta chains ---------------------------------------------------------
    def cache_delta_commit(self, owner: str, src: str, base_step: int, step: int, seq: int,
                           prev_hash: str, chain_hash: str, manifest: dict, nproc: int = 0,
                           meta: bytes | None = None) -> dict:
        """Seal one delta record staged under its wire owner: every payload
        shard's CRC and length, the record hash and the chain linkage are
        verified under the lock."""
        step, seq, base_step = int(step), int(seq), int(base_step)
        src = str(src)
        wire = delta.wire_owner(owner, src, seq)
        if delta.chain_hash(prev_hash, step, seq, manifest) != chain_hash:
            return {"ok": False, "reason": "hash"}
        with self._lock:
            cid = f"{owner}/{src}"
            ch = self._chains.get(cid)
            if ch is not None and ch.base_step != base_step:
                if base_step < ch.base_step:
                    return {"ok": False, "reason": "stale"}
                ch = None  # a newer base re-anchors: replace the chain
            if ch is None:
                if seq != 1:
                    return {"ok": False, "reason": "gap"}
                own_set = self._sets.get(owner)
                if own_set is not None and own_set.step > base_step:
                    return {"ok": False, "reason": "stale"}
                ch = _Chain(owner, src, base_step)
            tail = ch.records[-1] if ch.records else None
            expect_prev = tail.hash if tail else delta.anchor_hash(base_step)
            expect_seq = (tail.seq if tail else 0) + 1
            if tail is not None and seq <= tail.seq:
                dup = next((r for r in ch.records if r.seq == seq), None)
                if dup is not None and dup.hash == chain_hash:
                    return {"ok": True, "dup": True}  # an idempotent re-push
                return {"ok": False, "reason": "link"}
            if (seq != expect_seq or prev_hash != expect_prev
                    or step <= (tail.step if tail else base_step)):
                return {"ok": False, "reason": "link"}
            if len(ch.records) >= constants.delta_max_chain() > 0:
                return {"ok": False, "reason": "full"}
            staged = _verified(self._staging, wire, step, manifest, "delta shard")
            for key in manifest:
                self._staging.pop((wire, step, key), None)
            ch.records.append(_DeltaRec(step, seq, prev_hash, chain_hash,
                                        {k: dict(v) for k, v in manifest.items()}, staged,
                                        int(nproc), None if meta is None else bytes(meta)))
            self._chains[cid] = ch
        return {"ok": True}

    def cache_delta_manifest(self) -> dict:
        """Every chain held here with its linkage fields:
        ``{cid: {owner, src, base_step, records: [...]}}``."""
        with self._lock:
            return {cid: {
                "owner": ch.owner, "src": ch.src, "base_step": ch.base_step,
                "records": [{"step": r.step, "seq": r.seq, "prev": r.prev, "hash": r.hash,
                             "shards": r.manifest, "nproc": r.nproc,
                             "has_meta": r.meta is not None} for r in ch.records],
            } for cid, ch in self._chains.items()}

    def cache_stats(self) -> dict:
        with self._lock:
            return {
                "pod": self._pod_id,
                "owners": {o: {"step": s.step, "shards": len(s.shards), "nbytes": s.nbytes}
                           for o, s in self._sets.items()},
                "chains": {cid: {"base_step": ch.base_step, "records": len(ch.records),
                                 "nbytes": ch.nbytes} for cid, ch in self._chains.items()},
                "staging": len(self._staging),
                "max_bytes": self._max_bytes,
            }

    # -- internals -------------------------------------------------------------
    def _blob_locked(self, owner: str, key: str) -> bytes:
        """One shard's bytes: a committed set's by owner, a delta record's
        by its ``~delta:`` wire owner."""
        parsed = delta.parse_wire_owner(owner)
        if parsed is not None:
            rec = self._delta_rec_locked(*parsed)
            if rec is None or key not in rec.shards:
                raise EdlInternalError(f"no cached delta shard {owner}/{key}")
            return rec.shards[key]
        s = self._sets.get(owner)
        if s is None or key not in s.shards:
            raise EdlInternalError(f"no cached shard {owner}/{key}")
        return s.shards[key]

    def _delta_rec_locked(self, owner: str, src: str, seq: int):
        ch = self._chains.get(f"{owner}/{src}")
        if ch is None:
            return None
        return next((r for r in ch.records if r.seq == int(seq)), None)

    def _over_cap(self, incoming: int, owner: str, step: int) -> bool:
        """Admission of one more chunk of ``owner``'s ``step``; the owner's
        own older set does not count (the commit replaces it)."""
        if not self._max_bytes:
            return False
        held = (sum(s.nbytes for o, s in self._sets.items() if not (o == owner and s.step < step))
                + sum(ch.nbytes for ch in self._chains.values())
                + sum(len(st.buf) for st in self._staging.values()))
        return held + incoming > self._max_bytes

    def _replicate(self, owner: str, step: int) -> None:
        """Push ``owner``'s committed set to its ring replica, skipping the
        shards the target already holds at this step with the same CRC.
        Best-effort: a failure costs redundancy until the next commit."""
        try:
            adverts = advert.list_adverts(self._store, self._job_id)
            target = placement.replica_for(owner, list(adverts))
            if target is None or target == self._pod_id or target not in adverts:
                return
            with self._lock:
                s = self._sets.get(owner)
                if s is None or s.step != step:
                    return  # superseded while the thread started
                shards = dict(s.shards)
                manifest = {k: dict(v) for k, v in s.manifest.items()}
                meta = s.meta
            from edl_tpu_torch.rpc.client import RpcChannelPool
            with RpcChannelPool(adverts[target]) as pool:
                theirs = {}
                try:
                    listing = pool.call("cache_manifest").get(owner)
                    if listing and listing["step"] == step:
                        theirs = listing["shards"]
                except Exception as e:  # noqa: BLE001 — a cold target gets the full set
                    logger.debug("manifest probe of %s failed (%s)", target[:8], e)
                todo = {k: v for k, v in shards.items()
                        if k not in theirs or theirs[k].get("crc") != manifest[k]["crc"]}
                push_shards_parallel(pool, todo, owner=owner, step=step)
                pool.call("cache_commit", owner=owner, step=step,
                          manifest={k: manifest[k] for k in todo}, meta=meta)
            logger.info("replicated step %d (%d/%d shards) to %s", step, len(todo),
                        len(shards), target[:8])
        except Exception:  # noqa: BLE001 — redundancy is best-effort
            logger.exception("replication of step %d failed", step)
