"""Leader data service and per-pod batch cache server (a copy of the JAX
package's ``data/data_server.py`` without its metrics; it speaks the JAX
package's wire, so a torch reader works against either package's service
and cache, and a JAX reader against the port's).

The leader runs a **span-aware work queue**:

- *files* are handed to producer pods dynamically (``next_file``), so a
  slow or late pod simply produces fewer files: work stealing with no
  rebalance barrier;
- every produced batch carries its **record spans** ``(file_idx, begin,
  end)``; consumers ack them back, and the service keeps the union of
  consumed spans per file;
- if a producer dies, its in-progress and unconsumed files are re-queued
  **minus the consumed spans**, so survivors re-produce only what was never
  consumed;
- a reader is created per *generation* (callers key it by epoch and
  cluster stage); ``create_reader`` takes the restored
  :class:`~edl_tpu_torch.cluster.state.DataCheckpoint` spans, which is how
  a stop-resume restart (same or other world size) resumes mid-epoch
  exactly once.

With a ``journal`` (``data/journal.py``, whose records are the JAX
package's, so either package's successor rebuilds) every generation mutation is
written ahead into the coordination store and a successor leader rebuilds
generations lazily (``_lookup``), parks the journaled unacked metas and
holds new grants for a rebuild grace, so reattaching readers reclaim their
in-flight work first.  Without one, a successor answers
:class:`EdlReaderGoneError` and readers reattach: they re-seed the
generation from their own checkpoint and claimed spans.

Delivery: exactly once per generation without producer death; at least
once for batches consumed but unacked when their producer dies.  Under the
JAX launcher the service rides every pod's launcher server (only the
leader's is addressed), so it outlives trainer restarts; batch data never
moves through the leader, each pod serves its own cache.
"""

from __future__ import annotations

import logging
import threading
import time
import uuid
from collections import OrderedDict, deque

from edl_tpu_torch.rpc.server import RpcServer, Streaming
from edl_tpu_torch.utils import constants
from edl_tpu_torch.utils.exceptions import (
    EdlDataError,
    EdlReaderGoneError,
    EdlStopIteration,
    EdlTableError,
)
from edl_tpu_torch.utils.network import local_ip
from edl_tpu_torch.utils.spans import in_spans, intersect_spans, merge_span

logger = logging.getLogger(__name__)

class _Meta:
    """One produced batch: where it lives and which records it covers."""

    __slots__ = ("producer", "endpoint", "batch_id", "spans")

    def __init__(self, producer: str, endpoint: str, batch_id: str,
                 spans: list[list[int]]):
        self.producer = producer
        self.endpoint = endpoint
        self.batch_id = batch_id
        self.spans = spans  # [[file_idx, begin, end], ...]

    def wire(self) -> list:
        return [self.producer, self.endpoint, self.batch_id, self.spans]


class _ReaderGen:
    """State of one reader generation.

    ``pending`` entries are ``[file_idx, only]`` where ``only`` is None
    (produce the whole file minus consumed spans) or a span list
    (re-produce JUST those records — the cache-eviction repair path,
    which must not duplicate the file's still-fetchable batches)."""

    def __init__(self, files: list[str]):
        # per-generation lock: ops (and their journal writes) on one
        # generation never block another generation's readers — only
        # the _gens map itself rides the service-wide lock
        self.lock = threading.Lock()
        self.files = list(files)
        self.pending: deque[list] = deque([i, None] for i in range(len(files)))
        # file_idx -> (producing pod, only-spans or None for whole file)
        self.owner: dict[int, tuple[str, list | None]] = {}
        self.done: set[int] = set()          # files reported file_done
        self.consumed: dict[int, list[list[int]]] = {}  # file_idx -> spans
        self.queue: deque[_Meta] = deque()
        self.inflight: dict[str, OrderedDict[str, _Meta]] = {}
        # journal-recovered metas awaiting their consumer's reattach;
        # released to ``queue`` when the rebuild grace expires
        self.parked: dict[str, _Meta] = {}
        self.grace_until: float = 0.0
        self.seen: set[str] = set()          # every batch_id ever reported
        self.acked_ids: set[str] = set()     # replay-dedup for acks
        # per-pod response cache for get_batch_meta: a retried call
        # whose first response was lost must receive the SAME metas
        # back, or they would strand in inflight with no owner aware
        self.last_meta_resp: dict[str, tuple[int, list]] = {}
        # the skip each live grant was issued with: a whole-file
        # requeue overlapping it re-pends those spans as a REPAIR (the
        # owner is NOT emitting them), never assumes the owner covers
        # them
        self.granted_skip: dict[int, list[list[int]]] = {}
        self.error: str | None = None        # fatal producer error
        # created by a reattach with no journal: any batch metas the
        # old leader held are unrecoverable, so a re-asserted in-flight
        # grant must repair the records behind the producer's position
        self.reseeded = False
        self.produced = 0
        self.acked = 0

    def exhausted(self) -> bool:
        """Nothing left to hand out (now)."""
        return (not self.pending and not self.owner and not self.queue
                and not self.parked)

    def covered_spans(self, file_idx: int) -> list[list[int]]:
        """Consumed spans of ``file_idx`` UNIONED with the spans of
        every batch still live in the system (queued, parked, or held
        by any consumer).  This is the grant-time ``skip``: a record in
        a live batch is either about to train or will come back through
        a nack — re-producing it now would train it twice.  (The race
        this closes: a dead pod's whole-file requeue landing while a
        prior re-production of the same records sits trained-but-
        unacked in a survivor's inflight.)"""
        spans = [list(s) for s in self.consumed.get(file_idx, [])]
        metas = [m for m in self.queue] + list(self.parked.values())
        for held in self.inflight.values():
            metas.extend(held.values())
        for meta in metas:
            for fi, b, e in meta.spans:
                if fi == file_idx:
                    merge_span(spans, b, e)
        return spans

    def drained(self) -> bool:
        """Nothing left AND nothing in flight that could nack back.

        Gates the producer ``eof`` only (a producer exiting on
        queue-empty would leave nacked files with no producer).  Consumers
        must NOT wait on each other's inflight — a finished consumer
        blocking here while a peer waits for it in the per-step
        agreement collective deadlocks the epoch."""
        return self.exhausted() and not any(len(h)
                                            for h in self.inflight.values())

    def release_parked_if_due(self, now: float) -> None:
        """Past the rebuild grace, unclaimed parked metas re-enter the
        queue: their consumers never reattached (died), so any live
        consumer may take them (the consumer-death at-least-once
        caveat, unchanged)."""
        if self.parked and now >= self.grace_until:
            for meta in self.parked.values():
                self.queue.append(meta)
            self.parked.clear()


class DataService:
    """Leader-hosted; registered on the pod's launcher RPC server.

    ``journal`` (a :class:`~edl_tpu_torch.data.journal.DataJournal`) makes
    generation state survive this process; ``rebuild_grace`` is the
    post-rebuild window during which parked metas and new grants are
    held for reattaching readers."""

    def __init__(self, journal=None, rebuild_grace: float | None = None):
        self._lock = threading.Lock()
        self._gens: dict[str, _ReaderGen] = {}
        # generations deliberately GC'd (superseded by a newer epoch/
        # stage of the same base): a straggler still addressing one
        # must FAIL FAST, not re-seed it through the reattach fallback
        # and re-train a completed epoch.  Bounded: oldest pruned.
        self._dead_readers: "OrderedDict[str, None]" = OrderedDict()
        self._journal = journal
        self._grace = (constants.data_rebuild_grace()
                       if rebuild_grace is None else rebuild_grace)
        # one id per DataService instance, echoed in every response:
        # readers detect a leader restart/failover by the change and
        # reattach proactively (before their parked work's grace ends)
        self.incarnation = uuid.uuid4().hex[:12]

    def _out(self, payload: dict) -> dict:
        payload["inc"] = self.incarnation
        return payload

    # -- lifecycle -----------------------------------------------------------
    def create_reader(self, reader: str, files: list[str],
                      consumed: list[list[int]] | None = None) -> dict:
        """Idempotent: the first caller creates the generation, later
        callers join it (and their ``consumed`` spans — the restored
        DataCheckpoint — are unioned in only at creation, when the set
        is identical across pods anyway: all pods restore the same
        checkpoint).  On a successor leader the journal, if present,
        wins over a fresh create: the journaled consumed union is a
        superset of any one pod's restored checkpoint."""
        base = reader.split("@", 1)[0]
        with self._lock:
            if reader in self._dead_readers:
                raise EdlDataError(
                    f"reader {reader!r} was superseded by a newer "
                    f"generation (GC'd); restart the epoch")
            known = reader in self._gens
        if not known:
            gen = self._try_rebuild(reader)
            if gen is None:
                gen = _ReaderGen(files)
                for file_idx, b, e in consumed or []:
                    merge_span(gen.consumed.setdefault(int(file_idx), []),
                               int(b), int(e))
                # drop pending files that are already fully consumed is
                # not knowable here (record counts unknown); producers
                # discover emptiness and report file_done with 0 batches
                if self._journal is not None:
                    self._journal.create(
                        reader, gen.files,
                        {k: [list(s) for s in v]
                         for k, v in gen.consumed.items()})
                with self._lock:
                    if reader not in self._gens:  # racing creator wins once
                        self._gens[reader] = gen
            # GC older generations of the same base reader name: a
            # new epoch/stage obsoletes them (launcher-hosted state
            # must not grow across a long job) — journal included
            with self._lock:
                stale = [k for k in self._gens
                         if k != reader and k.split("@", 1)[0] == base]
                for k in stale:
                    del self._gens[k]
                    self._dead_readers[k] = None
                while len(self._dead_readers) > 256:
                    self._dead_readers.popitem(last=False)
            if self._journal is not None:
                for k in stale:
                    self._journal.gc(k)
                for k in self._journal.list_readers():
                    if k != reader and k.split("@", 1)[0] == base:
                        self._journal.gc(k)
            logger.info("reader %s: %d files (%d stale gens dropped)",
                        reader, len(files), len(stale))
        return self._out({})

    def _lookup(self, reader: str) -> _ReaderGen:
        """Resolve a generation (lazily rebuilding from the journal on
        a successor leader).  Only the ``_gens`` map rides the
        service-wide lock — the journal READ happens outside it
        (double-checked install), so a slow store or a stale reader
        name can never stall other generations' RPCs behind a 5 s
        journal budget."""
        with self._lock:
            if reader in self._dead_readers:
                raise EdlDataError(
                    f"reader {reader!r} was superseded by a newer "
                    f"generation (GC'd); restart the epoch")
            gen = self._gens.get(reader)
        if gen is None:
            gen = self._try_rebuild(reader)
        if gen is None:
            raise EdlReaderGoneError(f"unknown reader {reader!r}")
        return gen

    def _try_rebuild(self, reader: str) -> "_ReaderGen | None":
        """Load the journal (no locks held) and install the rebuilt
        generation under the map lock; a concurrent rebuild of the
        same reader wins by whoever installs first."""
        if self._journal is None:
            return None
        state = self._journal.load(reader)
        if state is None:
            return None
        if state.get("dead"):
            # the journal's durable GC tombstone: this generation was
            # superseded on a previous incarnation — remember and fail
            # fast (the reattach re-seed must not resurrect it)
            with self._lock:
                self._dead_readers[reader] = None
                while len(self._dead_readers) > 256:
                    self._dead_readers.popitem(last=False)
            raise EdlDataError(
                f"reader {reader!r} was superseded by a newer "
                f"generation (GC'd); restart the epoch")
        gen = self._gen_from_state(reader, state)
        with self._lock:
            raced = self._gens.get(reader)
            if raced is not None:
                return raced
            self._gens[reader] = gen
        logger.info(
            "reader %s rebuilt from journal: %d files (%d done, %d owned, "
            "%d pending), %d parked metas, %d consumed files; grace %.1fs",
            reader, len(gen.files), len(gen.done), len(gen.owner),
            len(gen.pending), len(gen.parked), len(gen.consumed),
            self._grace)
        return gen

    def _gen_from_state(self, reader: str, state: dict) -> _ReaderGen:
        """Reconstruct a generation from a journal snapshot."""
        gen = _ReaderGen(state["files"])
        gen.consumed = {k: [list(s) for s in v]
                        for k, v in state["consumed"].items()}
        gen.done = set(state["done"])
        gen.owner = {k: (pod, only) for k, (pod, only)
                     in state["owner"].items()}
        gen.granted_skip = {k: [list(s) for s in v]
                            for k, v in state["granted_skip"].items()}
        # journaled repair spans re-pend even when the file has a live
        # owner — UNLESS that owner holds the repair grant itself
        # (only != None), or, for a whole-file owner, only the part of
        # the repair the owner's own skip excludes (records the owner
        # IS emitting must not re-produce)
        gen.pending = deque()
        for idx, spans in sorted(state["repair"].items()):
            holder = gen.owner.get(idx)
            if holder is not None and holder[1] is None:
                # whole-file owner: only the part its own skip excludes
                # needs a repair (the owner emits the rest)
                keep = intersect_spans(spans,
                                       gen.granted_skip.get(idx, []))
                if keep:
                    gen.pending.append([idx, keep])
            elif holder is None and idx in gen.done:
                gen.pending.append([idx, spans])
            # else: the repair's own holder is producing it, or the file
            # is not done and the full pass below covers these spans
        # every file neither done nor under a WHOLE-file grant needs a
        # full pass — including one whose owner only holds a repair
        # grant (the in-memory full pass queued behind a repair has
        # exactly this journal signature: not-done + repair-owner)
        gen.pending.extend(
            [idx, None] for idx in range(len(gen.files))
            if idx not in gen.done
            and (idx not in gen.owner or gen.owner[idx][1] is not None))
        for bid, producer, endpoint, spans in state["metas"]:
            gen.parked[bid] = _Meta(producer, endpoint, bid, spans)
            gen.seen.add(bid)
        gen.acked_ids = set(state["acked"])
        gen.seen |= gen.acked_ids
        gen.acked = len(gen.acked_ids)
        gen.produced = len(gen.seen)
        gen.error = state["error"]
        gen.grace_until = time.monotonic() + self._grace
        return gen

    def reattach_reader(self, reader: str, pod_id: str, endpoint: str = "",
                        files: list[str] | None = None,
                        consumed: list[list[int]] | None = None,
                        held: list[str] | None = None,
                        producing: list | None = None,
                        finished: list[int] | None = None) -> dict:
        """A reader re-establishes itself after a leader change.

        ``consumed`` is the union of the reader's checkpointed spans
        and every span it has *claimed* (fetched + yielded) — merged
        into the generation so nothing it owns is re-produced.
        ``held`` are its unacked batch ids: parked/queued copies move
        back to its inflight; ids the leader cannot restore come back
        in ``drop`` (the reader forgets them — their records are
        covered by ``consumed``).  ``producing`` = ``[file_idx, only]``
        re-asserts the producer's in-flight grant; if the file was
        re-granted elsewhere meanwhile, ``abandon_file`` tells the
        producer to stop emitting it.  ``finished`` lists every file
        the pod completed this generation, closing out journaled
        grants whose ``file_done`` a torn journal lost; other
        unclaimed grants stay owned (the pod's idempotent retries
        re-sync them — see the reconciliation comment below)."""
        with self._lock:
            if reader in self._dead_readers:
                raise EdlDataError(
                    f"reader {reader!r} was superseded by a newer "
                    f"generation (GC'd); restart the epoch")
            gen = self._gens.get(reader)
        if gen is None:
            gen = self._try_rebuild(reader)
        if gen is None:
            if files is None:
                raise EdlReaderGoneError(
                    f"unknown reader {reader!r} and no files to re-seed")
            gen = _ReaderGen(files)
            gen.reseeded = True
            gen.grace_until = time.monotonic() + self._grace
            if self._journal is not None:
                self._journal.create(reader, gen.files, {})
            with self._lock:
                raced = self._gens.get(reader)
                if raced is not None:
                    gen = raced
                else:
                    self._gens[reader] = gen
                    logger.warning("reader %s re-seeded from a reattach "
                                   "(no journal state); grace %.1fs",
                                   reader, self._grace)
        with gen.lock:
            # merge the reader's view of what it owns
            touched: dict[int, list[list[int]]] = {}
            for file_idx, b, e in consumed or []:
                spans = gen.consumed.setdefault(int(file_idx), [])
                merge_span(spans, int(b), int(e))
                touched[int(file_idx)] = [list(s) for s in spans]
            if touched and self._journal is not None:
                self._journal.consumed(reader, touched)
            # restore its unacked in-flight batches
            held_map = gen.inflight.setdefault(pod_id, OrderedDict())
            drop: list[str] = []
            for bid in held or []:
                if bid in held_map:
                    continue  # already restored (reattach replay)
                meta = gen.parked.pop(bid, None)
                if meta is None:
                    meta = next((m for m in gen.queue
                                 if m.batch_id == bid), None)
                    if meta is not None:
                        gen.queue.remove(meta)
                if meta is not None:
                    held_map[bid] = meta
                elif bid in gen.acked_ids:
                    continue  # ack already landed; nothing to restore
                else:
                    drop.append(bid)
            # reconcile journal-attributed grants with what the pod
            # claims to have FINISHED (a torn journal can lose a
            # file_done): close those out.  Grants the pod neither
            # finished nor claims to be producing are deliberately left
            # owned — the reattach snapshot races the pod's own producer
            # thread (it may have moved to a new file since), and its
            # idempotent next_file/file_done retries re-sync any grant
            # whose response was lost; re-pending here would hand a file
            # a live producer is mid-emitting to a second pod (records
            # trained twice)
            claimed_done = {int(f) for f in finished or []}
            producing_idx = int(producing[0]) if producing is not None else None
            for idx, (pod, only) in list(gen.owner.items()):
                if (pod != pod_id or idx == producing_idx
                        or idx not in claimed_done):
                    continue
                del gen.owner[idx]
                gen.granted_skip.pop(idx, None)
                if only is None:
                    gen.done.add(idx)
                if self._journal is not None:
                    try:
                        self._journal.file_done(reader, idx,
                                                whole_file=only is None)
                    except Exception:  # noqa: BLE001 — reattach retries
                        logger.warning("journal file_done for %s/%d "
                                       "failed during reattach",
                                       reader, idx)
            # re-assert the producer's in-flight grant
            abandon = False
            if producing is not None:
                file_idx, only = producing_idx, producing[1]
                position = int(producing[2]) if len(producing) > 2 else None
                holder = gen.owner.get(file_idx)
                if holder is not None and holder[0] != pod_id:
                    abandon = True  # re-granted elsewhere past grace
                elif only is None and file_idx in gen.done:
                    abandon = True  # completed elsewhere meanwhile
                else:
                    # drop only pending entries that duplicate THIS
                    # grant's work (same type): a queued repair/full
                    # pass for the file is separate recovery work and
                    # must survive a (possibly spurious) reattach
                    gen.pending = deque(
                        e for e in gen.pending
                        if e[0] != file_idx
                        or (e[1] is None) != (only is None))
                    gen.owner[file_idx] = (pod_id, only)
                    # the producer keeps emitting against its ORIGINAL
                    # skip; the journal-rebuilt value survives in
                    # granted_skip — only a re-seeded generation (no
                    # journal) approximates it with the current cover
                    skip = gen.granted_skip.setdefault(
                        file_idx, gen.covered_spans(file_idx))
                    logger.info("reader %s: reattach re-asserted file %d "
                                "for %s (only=%s, pos=%s)", reader, file_idx,
                                pod_id[:8], only, position)
                    if self._journal is not None:
                        self._journal.grant(reader, file_idx, pod_id, only,
                                            skip=skip)
                    if (gen.reseeded and only is None and position
                            and position > 0):
                        # re-seeded generation: the batches this
                        # producer already published died with the old
                        # leader, so the records BEHIND its position
                        # that nobody claimed re-pend as a repair
                        # (their grant-time skip excludes whatever IS
                        # consumed or live) — without this the producer
                        # finishes from its position and the lost spans
                        # silently never train
                        self._requeue_spans_locked(
                            gen, [[file_idx, 0, position]],
                            whole_file=False)
            logger.info("reader %s: pod %s reattached (%d held restored, "
                        "%d dropped%s)", reader, pod_id[:8],
                        len(held or []) - len(drop), len(drop),
                        ", producer told to abandon" if abandon else "")
            return self._out({"drop": drop, "abandon_file": abandon})

    # -- producer side -------------------------------------------------------
    def next_file(self, reader: str, pod_id: str) -> dict:
        """Assign the next unproduced file to this pod; ``skip`` carries
        the already-consumed spans of that file so re-produced files
        (dead producer, resumed epoch) emit only unconsumed records.

        ``file=None, eof=False`` means "nothing right now, poll again":
        a dead peer's files may requeue later — producers must outlive
        their own slice, or requeued work would have no producer.

        Idempotent per pod: a pod that already holds a grant gets the
        SAME assignment back (a retried ``next_file`` whose first
        response was lost must not strand a file on an owner that
        never learned about it)."""
        gen = self._lookup(reader)
        with gen.lock:
            existing = next(((idx, only) for idx, (pod, only)
                             in gen.owner.items() if pod == pod_id), None)
            if existing is not None:
                file_idx, only = existing
                # the STORED grant skip, not a recomputation: every
                # response for one grant must carry the identical skip,
                # or the requeue logic couldn't know which records the
                # owner is actually emitting
                skip = gen.granted_skip.get(file_idx)
                if skip is None:
                    skip = gen.granted_skip[file_idx] = \
                        gen.covered_spans(file_idx)
                return self._out({
                    "file": [file_idx, gen.files[file_idx]], "eof": False,
                    "only": only, "skip": [list(s) for s in skip]})
            now = time.monotonic()
            gen.release_parked_if_due(now)
            # grants: only entries whose file has NO current owner — a
            # repair entry for an owned file waits for that grant to
            # close (owner is a single slot per file; overwriting it
            # would orphan the first producer's assignment).  Within
            # the rebuild grace no NEW grants go out at all: a file
            # whose pre-crash owner has not reattached yet must not be
            # double-granted (two producers emitting overlapping spans
            # would double-train records).
            entry = None
            if now >= gen.grace_until:
                entry = next((e for e in gen.pending
                              if e[0] not in gen.owner), None)
            if entry is None:
                return self._out({
                    "file": None, "skip": [],
                    "eof": (now >= gen.grace_until and gen.drained())
                    or gen.error is not None})
            gen.pending.remove(entry)
            file_idx, only = entry
            skip = gen.covered_spans(file_idx)
            try:
                if self._journal is not None:
                    self._journal.grant(reader, file_idx, pod_id, only,
                                        skip=skip)
            except Exception:
                gen.pending.appendleft([file_idx, only])
                raise
            gen.owner[file_idx] = (pod_id, only)
            gen.granted_skip[file_idx] = skip
            logger.info("reader %s: granted file %d to %s (only=%s, skip=%s)",
                        reader, file_idx, pod_id[:8], only, skip)
            return self._out({
                "file": [file_idx, gen.files[file_idx]], "eof": False,
                "only": only, "skip": [list(s) for s in skip]})

    def report_batch_meta(self, reader: str, pod_id: str, endpoint: str,
                          batches: list) -> dict:
        """``batches``: [[batch_id, [[file_idx, begin, end], ...]], ...].
        Returns the queue backlog so producers can throttle before their
        local caches evict unfetched batches (an empty ``batches`` call
        is the cheap backlog poll).  Replay-safe: batch ids already
        seen (a retried report whose response was lost) are skipped."""
        gen = self._lookup(reader)
        with gen.lock:
            fresh = [[bid, spans] for bid, spans in batches
                     if bid not in gen.seen]
            if fresh and self._journal is not None:
                self._journal.metas(reader, [
                    (bid, pod_id, endpoint,
                     [list(map(int, s)) for s in spans])
                    for bid, spans in fresh])
            for batch_id, spans in fresh:
                gen.seen.add(batch_id)
                gen.queue.append(_Meta(pod_id, endpoint, batch_id,
                                       [list(map(int, s)) for s in spans]))
            gen.produced += len(fresh)
            return self._out({"backlog": len(gen.queue)})

    def file_done(self, reader: str, pod_id: str, file_idx: int) -> dict:
        gen = self._lookup(reader)
        with gen.lock:
            holder = gen.owner.get(int(file_idx))
            if holder is not None and holder[0] == pod_id:
                if self._journal is not None:
                    self._journal.file_done(reader, int(file_idx),
                                            whole_file=holder[1] is None)
                del gen.owner[int(file_idx)]
                gen.granted_skip.pop(int(file_idx), None)
                if holder[1] is None:
                    gen.done.add(int(file_idx))
                logger.info("reader %s: file %d done by %s", reader,
                            int(file_idx), pod_id[:8])
        return self._out({})

    def file_failed(self, reader: str, pod_id: str, file_idx: int,
                    error: str) -> dict:
        """A producer hit a non-transient error (unreadable file): fail
        the whole generation so every consumer sees it, not only the
        producing pod."""
        gen = self._lookup(reader)
        with gen.lock:
            gen.error = f"producer {pod_id[:8]} file {file_idx}: {error}"
            if self._journal is not None:
                try:
                    self._journal.error(reader, gen.error)
                except Exception:  # noqa: BLE001 — the error IS applied
                    logger.warning("journal error record for %s failed",
                                   reader)
            logger.error("reader %s failed: %s", reader, gen.error)
        return self._out({})

    # -- consumer side -------------------------------------------------------
    def get_batch_meta(self, reader: str, pod_id: str, n: int = 1,
                       ack_ids: list[str] | None = None,
                       req_id: int | None = None) -> dict:
        """Pop up to ``n`` metas for this consumer; ``ack_ids`` confirms
        previously handed-out batches were consumed (their spans join
        the consumed union).  Raises EdlStopIteration once every file is
        produced and every batch handed out.

        Ack replay is idempotent by ``(reader, batch_id)``: an ack the
        leader already applied is skipped, and an ack for a batch the
        (rebuilt) leader holds parked or queued — the consumer fetched
        it from the *previous* incarnation — still lands.  The meta
        HAND-OUT is made replay-safe by ``req_id``: a retried call
        (same pod, same id) whose first response was lost on the wire
        gets the SAME metas back — without this they would strand in
        this pod's inflight with no consumer aware of them, and the
        epoch could never drain."""
        gen = self._lookup(reader)
        with gen.lock:
            held = gen.inflight.setdefault(pod_id, OrderedDict())
            cached = (gen.last_meta_resp.get(pod_id)
                      if req_id is not None else None)
            if cached is not None and cached[0] == req_id:
                # replay of a call whose response was lost: the acks
                # below are dedup'd by acked_ids, the metas are the
                # ones already moved to this pod's inflight
                replay_metas = cached[1]
            else:
                replay_metas = None
            # resolve each ack to its meta WITHOUT mutating yet: the
            # journal write goes ahead of the in-memory apply, and a
            # journal failure must leave state untouched for the retry
            acks: list[tuple[str, _Meta]] = []
            for bid in ack_ids or []:
                if bid in gen.acked_ids:
                    continue
                meta = held.get(bid)
                if meta is None:
                    meta = gen.parked.get(bid)
                if meta is None:
                    meta = next((m for m in gen.queue
                                 if m.batch_id == bid), None)
                if meta is not None:
                    acks.append((bid, meta))
            if acks:
                touched: dict[int, list[list[int]]] = {}
                for _bid, meta in acks:
                    for file_idx, b, e in meta.spans:
                        spans = touched.get(file_idx)
                        if spans is None:
                            spans = touched[file_idx] = [
                                list(s)
                                for s in gen.consumed.get(file_idx, [])]
                        merge_span(spans, b, e)
                if self._journal is not None:
                    self._journal.ack(reader, [bid for bid, _m in acks],
                                      touched)
                for bid, meta in acks:
                    held.pop(bid, None)
                    gen.parked.pop(bid, None)
                    if meta in gen.queue:
                        gen.queue.remove(meta)
                    gen.acked_ids.add(bid)
                    gen.acked += 1
                gen.consumed.update(touched)
            if gen.error is not None:
                raise EdlDataError(gen.error)
            now = time.monotonic()
            gen.release_parked_if_due(now)
            if replay_metas is not None:
                # re-deliver only what is STILL unacked (acks may have
                # ridden this very retry)
                metas = [m for m in replay_metas if m[2] in held]
            else:
                metas = []
                while gen.queue and len(metas) < n:
                    meta = gen.queue.popleft()
                    held[meta.batch_id] = meta
                    metas.append(meta.wire())
                if req_id is not None:
                    gen.last_meta_resp[pod_id] = (req_id, metas)
            # end-of-data is per consumer: ITS acks are in (held empty)
            # and nothing is pending globally.  Other consumers' inflight
            # must not delay it (deadlock vs the step agreement); should
            # one of their batches nack later, any still-live producer
            # re-produces it and still-consuming pods pick it up.  Within
            # a rebuild grace nothing ends: a reattaching producer may
            # yet re-pend a grant the journal attributed to it.
            if (not metas and not held and gen.exhausted()
                    and now >= gen.grace_until):
                raise EdlStopIteration(
                    f"reader {reader} drained ({gen.produced} batches, "
                    f"{gen.acked} acked)")
            return self._out({"metas": metas})

    def nack_batches(self, reader: str, pod_id: str, batch_ids: list[str],
                     producer_dead: bool = True) -> dict:
        """Consumer could not fetch these batches.

        ``producer_dead=True`` (transport failure): the producer is
        presumed dead and ALL its work requeues via mark_pod_dead.
        ``producer_dead=False`` (the producer answered "not in cache" —
        it evicted the batch under pressure): re-produce ONLY the lost
        batches' spans; the producer is healthy and its other queued
        batches are still fetchable, so declaring it dead would drop
        them and double-produce their files."""
        producers = set()
        gen = self._lookup(reader)
        with gen.lock:
            held = gen.inflight.get(pod_id, OrderedDict())
            nacked = 0
            muts = _JournalMuts()
            for bid in batch_ids:
                meta = held.pop(bid, None)
                if meta is not None:
                    nacked += 1
                    producers.add(meta.producer)
                    muts.dropped_metas.append(bid)
                    self._requeue_spans_locked(
                        gen, meta.spans, whole_file=producer_dead, muts=muts)
            self._journal_muts(reader, gen, muts)
        if producer_dead:
            for producer in producers:
                self.mark_pod_dead(producer, reader=reader)
        return self._out({})

    # -- failure handling ----------------------------------------------------
    def mark_pod_dead(self, pod_id: str, reader: str | None = None) -> dict:
        """A pod left the cluster (or stopped answering fetches): across
        the given (default: every) generation, requeue the metas it held
        as a consumer, drop the queued metas it produced, and requeue
        its files — all minus already-consumed spans."""
        if reader is not None:
            # force the lazy journal rebuild first: a registry-expiry
            # event naming a generation this (successor) instance has
            # not served yet must still requeue the dead pod's restored
            # grants — dropping it here would pin the epoch open, and
            # the advert delete never fires twice
            try:
                self._lookup(reader)
            except (EdlReaderGoneError, EdlDataError):
                pass  # nothing journaled (or superseded): nothing to heal
        with self._lock:
            gens = ({reader: self._gens[reader]}
                    if reader and reader in self._gens
                    else dict(self._gens) if reader is None else {})
        for gen_name, gen in gens.items():
            with gen.lock:
                muts = _JournalMuts()
                # consumer side: unconsumed handed-out metas return to the
                # pool (unless their producer is the dead pod itself)
                held = gen.inflight.pop(pod_id, None)
                gen.last_meta_resp.pop(pod_id, None)
                requeued = 0
                for meta in reversed((held or {}).values()):
                    if meta.producer == pod_id:
                        muts.dropped_metas.append(meta.batch_id)
                        self._requeue_spans_locked(gen, meta.spans,
                                                   whole_file=True, muts=muts)
                    else:
                        gen.queue.appendleft(meta)  # reversed: keeps order
                        requeued += 1
                # producer side: queued AND parked batches of a dead
                # producer point at a dead cache — re-produce their
                # files instead
                dead_queued = [m for m in gen.queue if m.producer == pod_id]
                dead_queued += [m for m in gen.parked.values()
                                if m.producer == pod_id]
                if dead_queued:
                    gen.queue = deque(m for m in gen.queue
                                      if m.producer != pod_id)
                    gen.parked = {bid: m for bid, m in gen.parked.items()
                                  if m.producer != pod_id}
                    for meta in dead_queued:
                        muts.dropped_metas.append(meta.batch_id)
                        self._requeue_spans_locked(gen, meta.spans,
                                                   whole_file=True, muts=muts)
                # metas it produced that other consumers hold will fail
                # their fetch and come back through nack_batches
                for file_idx, (owner, _only) in list(gen.owner.items()):
                    if owner == pod_id:
                        del gen.owner[file_idx]
                        gen.granted_skip.pop(file_idx, None)
                        # whole-file re-production supersedes any pending
                        # span-only repair entry for this file
                        gen.pending = deque(e for e in gen.pending
                                            if e[0] != file_idx)
                        gen.pending.appendleft([file_idx, None])
                        gen.done.discard(file_idx)
                        muts.whole_files.add(file_idx)
                if held or dead_queued:
                    logger.info(
                        "pod %s dead: requeued %d metas, re-producing %d "
                        "batches' files", pod_id[:8], requeued,
                        len(dead_queued))
                self._journal_muts(gen_name, gen, muts)
        return self._out({})

    def _journal_muts(self, reader: str, gen: _ReaderGen,
                      muts: "_JournalMuts") -> None:
        """Best-effort journal update for a requeue batch (the strict
        write-ahead discipline is for reader-facing ops; stale requeue
        records self-heal through nacks).  Caller holds the lock."""
        if self._journal is None or muts.empty():
            return
        repairs = {idx: [list(s) for s in entry[1]]
                   for idx in muts.repair_files
                   for entry in gen.pending
                   if entry[0] == idx and entry[1] is not None}
        self._journal.requeue(
            reader, whole_files=sorted(muts.whole_files), repairs=repairs,
            dropped_metas=muts.dropped_metas,
            done_cleared=sorted(muts.done_cleared),
            cleared_owners=sorted(muts.cleared_owners))

    def _requeue_spans_locked(self, gen: _ReaderGen, spans: list,
                              whole_file: bool,
                              muts: "_JournalMuts | None" = None) -> None:
        """Mark lost batches for re-production.

        ``whole_file=True`` (producer dead: every unconsumed record of
        the file needs a new producer) requeues the file unless already
        pending/owned.  ``whole_file=False`` (single evicted batch from
        a live producer) requeues ONLY the batch's spans — even if the
        file is currently owned, since these records were already
        produced and are disjoint from whatever the owner is still
        emitting."""
        if muts is not None:
            muts.requeued_records += sum(e - b for _f, b, e in spans)
        if whole_file:
            for file_idx in {s[0] for s in spans}:
                holder = gen.owner.get(file_idx)
                if holder is not None and holder[1] is None:
                    # a full production is already in progress: the
                    # owner's grant (and its journal record) stay — BUT
                    # any of these spans the owner was told to SKIP are
                    # not being emitted by it, so they re-pend as a
                    # repair (they were skipped because a then-live
                    # batch covered them; that batch just died)
                    file_spans = [[b, e] for f, b, e in spans
                                  if f == file_idx]
                    overlap = intersect_spans(
                        file_spans, gen.granted_skip.get(file_idx, []))
                    overlap = [s for s in overlap
                               if not all(in_spans(
                                   gen.consumed.get(file_idx, []), r)
                                   for r in range(s[0], s[1]))]
                    if overlap:
                        self._requeue_spans_locked(
                            gen, [[file_idx, b, e] for b, e in overlap],
                            whole_file=False, muts=muts)
                    continue
                gen.done.discard(file_idx)
                if holder is not None:
                    # the current owner only covers a span-repair subset —
                    # queue a full pass behind it so the dead producer's
                    # other unconsumed records still re-produce (consumed
                    # skip keeps the overlap minimal).  The repair OWNER
                    # stays journaled; only done-ness changed
                    gen.pending = deque(e for e in gen.pending
                                        if e[0] != file_idx)
                    gen.pending.append([file_idx, None])
                    if muts is not None:
                        muts.done_cleared.add(file_idx)
                    continue
                if muts is not None:
                    muts.whole_files.add(file_idx)
                entry = next((e for e in gen.pending if e[0] == file_idx),
                             None)
                if entry is None:
                    gen.pending.append([file_idx, None])
                else:
                    entry[1] = None  # upgrade a span-only repair entry
        else:
            by_file: dict[int, list[list[int]]] = {}
            for file_idx, b, e in spans:
                merge_span(by_file.setdefault(file_idx, []), b, e)
            for file_idx, only in by_file.items():
                if muts is not None:
                    muts.repair_files.add(file_idx)
                entry = next((e for e in gen.pending
                              if e[0] == file_idx and e[1] is not None), None)
                if entry is not None:
                    for b, e in only:
                        merge_span(entry[1], b, e)
                elif any(e[0] == file_idx and e[1] is None
                         for e in gen.pending):
                    pass  # whole-file re-production already covers these
                else:
                    gen.pending.append([file_idx, only])

    def reconcile_pods(self, reader: str, live_pods: list[str]) -> dict:
        """Mark dead every pod this generation references that is NOT
        in ``live_pods`` (the current reader-registry adverts).  A
        successor leader calls this once per journaled generation at
        seat time: a pod whose advert expired BEFORE the successor's
        registry watch started never produces a delete event, and its
        journal-restored grants would otherwise pin the generation
        open forever."""
        gen = self._lookup(reader)
        with gen.lock:
            referenced = {pod for pod, _only in gen.owner.values()}
            referenced.update(gen.inflight.keys())
            referenced.update(m.producer for m in gen.queue)
            referenced.update(m.producer for m in gen.parked.values())
        dead = sorted(referenced - set(live_pods))
        for pod in dead:
            logger.warning("reader %s: pod %s referenced by the rebuilt "
                           "generation has no live advert; marking dead",
                           reader, pod[:8])
            self.mark_pod_dead(pod, reader=reader)
        return self._out({"dead": dead})

    # -- introspection --------------------------------------------------------
    def reader_status(self, reader: str) -> dict:
        gen = self._lookup(reader)
        with gen.lock:
            return self._out({
                "files": len(gen.files), "pending": len(gen.pending),
                "owned": len(gen.owner), "queued": len(gen.queue),
                "parked": len(gen.parked), "done": sorted(gen.done),
                "inflight": {k: len(v) for k, v in gen.inflight.items()},
                "produced": gen.produced, "acked": gen.acked,
                "consumed": {str(k): [list(s) for s in v]
                             for k, v in gen.consumed.items()},
                "error": gen.error,
            })


class _JournalMuts:
    """Journal mutations accumulated across one requeue batch."""

    __slots__ = ("whole_files", "repair_files", "dropped_metas",
                 "done_cleared", "cleared_owners", "requeued_records")

    def __init__(self):
        self.whole_files: set[int] = set()   # re-pended, no owner left
        self.repair_files: set[int] = set()  # span-repair entries changed
        self.dropped_metas: list[str] = []
        self.done_cleared: set[int] = set()  # done-ness revoked, owner kept
        self.cleared_owners: set[int] = set()  # grant dropped, done kept
        self.requeued_records = 0

    def empty(self) -> bool:
        return not (self.whole_files or self.repair_files
                    or self.dropped_metas or self.done_cleared
                    or self.cleared_owners)


class PodDataServer:
    """Every pod's batch cache + RPC surface.  The leader's instance
    additionally carries the :class:`DataService` (tests and standalone
    use; under the JAX launcher the service rides the launcher's pod
    server instead).  The cache's endpoint is ``host``, else
    ``utils/network.py:local_ip()`` (``EDL_TPU_HOST_IP`` or the loopback
    address)."""

    def __init__(self, pod_id: str, is_leader: bool = False,
                 host: str | None = None, port: int = 0,
                 cache_cap: int = 256, journal=None,
                 rebuild_grace: float | None = None):
        self.pod_id = pod_id
        self._cache: OrderedDict[str, dict] = OrderedDict()
        self._cache_cap = cache_cap
        self._lock = threading.Lock()
        self._rpc = RpcServer(host="0.0.0.0", port=port)
        self._rpc.register("get_batch_data", self.get_batch_data)
        self._rpc.register("get_batch_stream", self.get_batch_stream)
        self.service = (DataService(journal=journal,
                                    rebuild_grace=rebuild_grace)
                        if is_leader else None)
        if self.service is not None:
            self._rpc.register_instance(self.service)
        self._rpc.start()
        self.endpoint = f"{host or local_ip()}:{self._rpc.port}"

    # -- local cache ---------------------------------------------------------
    def put_batch(self, batch_id: str, payload: dict) -> None:
        with self._lock:
            self._cache[batch_id] = payload
            while len(self._cache) > self._cache_cap:
                evicted, _ = self._cache.popitem(last=False)
                logger.warning("cache full: evicted batch %s (the consumer "
                               "will nack and the file re-produces)", evicted)

    def pop_batch(self, batch_id: str):
        with self._lock:
            return self._cache.pop(batch_id, None)

    def get_batch_data(self, batch_id: str) -> dict:
        with self._lock:
            payload = self._cache.get(batch_id)
        if payload is None:
            raise EdlTableError(f"batch {batch_id} not in cache of {self.pod_id}")
        return {"payload": payload}

    def get_batch_stream(self, batch_ids: list) -> Streaming:
        """Framed multi-batch fetch: ONE request answered by one
        q-numbered frame per requested batch id, in request order — a
        consumer's whole prefetch group costs a single round trip
        instead of ``len(batch_ids)``.  Each frame carries
        ``{"batch_id", "payload"}``; ``payload`` None means not in
        cache (the consumer nacks that batch as an eviction miss,
        exactly like the per-batch ``EdlTableError`` answer).

        The frames ride the server's streaming envelope directly (ONE
        msgpack pack per batch — packing the payload into a raw blob
        first would serialize it twice and cost more CPU than the
        round trips save; consumers accept the raw-bytes frame shape
        too, for a future zero-copy payload format).  Old SERVERS
        answer "no such method" to this and the consumer demotes that
        endpoint to :meth:`get_batch_data` for the reader's lifetime
        (probed once per endpoint)."""
        return Streaming(self._stream_batches([str(b) for b in batch_ids]))

    def _stream_batches(self, batch_ids: list[str]):
        for bid in batch_ids:
            with self._lock:
                payload = self._cache.get(bid)
            yield {"batch_id": bid, "payload": payload}

    def stop(self) -> None:
        self._rpc.stop()
