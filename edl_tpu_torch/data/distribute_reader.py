"""Trainer-side distributed reader (a copy of the JAX package's
``data/distribute_reader.py`` without its metrics; it speaks the JAX
package's wire unchanged, so under the JAX launcher a torch trainer reads
from the JAX ``DataService`` and from JAX pods' caches).  Three roles in
one object:

- **produce** (thread): pull file grants from the leader (``next_file``),
  parse each into batches of records, skipping already-consumed spans,
  cache them in the local :class:`PodDataServer` and report ``(batch_id,
  spans)`` metas;
- **consume** (iterator): pull metas from the leader (acking the previous
  ones: work stealing), fetch the batches locally or from the producing
  pod's cache, and yield ``(batch_id, payload)`` with ``payload =
  {"records": [...], "spans": [[file_idx, b, e], ...]}``;
- **checkpoint**: a yielded batch's spans mark a :class:`DataCheckpoint`
  (or, with ``mark_on_yield=False``, the caller marks them when it trains
  the batch), so a mid-epoch save captures exactly what was consumed and a
  resumed job (any world size) re-creates the generation from it.

Every leader call rides a :class:`ResilientDataClient`: retries with
backoff, leader re-resolution and the **reattach handshake**, which
re-asserts this reader's consumed and claimed spans, unacked batch ids and
the producer's current grant on a successor.  The loops see three ends:
end of data (``EdlStopIteration``), a generation-fatal producer error
(``EdlDataError``), or a leader unreachable past the retry budget.

**Streamed, prefetched delivery**: the iterator keeps up to
``EDL_TPU_DATA_PREFETCH_DEPTH`` metas dispatched to
``EDL_TPU_DATA_PREFETCH_WORKERS`` fetch workers; a worker fetches a group
of one producer's batches over a shared :class:`RpcChannelPool` with one
``get_batch_stream`` request (a ``q``-numbered frame a batch).  A peer
without the handler demotes, probed once per endpoint, to the per-batch
``get_batch_data``; a malformed stream surfaces as ``EdlStreamError`` and
the unreceived batches re-fetch through the leader's requeue repair.  Acks
ride the call after the yield, never the fetch, so the prefetch depth
changes nothing of exactly-once.  Streamed frames are decoded through
``rpc/framing.py``.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Callable, Iterator

from edl_tpu_torch.cluster.state import DataCheckpoint
from edl_tpu_torch.data.data_server import PodDataServer
from edl_tpu_torch.data.dataset import FileSplitter, TxtFileSplitter
from edl_tpu_torch.data.resilient import CallAborted, ResilientDataClient
from edl_tpu_torch.rpc import framing
from edl_tpu_torch.rpc.client import RpcChannelPool
from edl_tpu_torch.utils import constants
from edl_tpu_torch.utils.exceptions import (
    EdlCoordError,
    EdlError,
    EdlInternalError,
    EdlStopIteration,
    EdlStreamError,
    EdlTableError,
)
from edl_tpu_torch.utils.spans import in_spans, merge_span

logger = logging.getLogger(__name__)

class DistributedReader:
    def __init__(self, reader_name: str, pod_id: str,
                 leader_endpoint: "str | Callable[[], str]",
                 data_server: PodDataServer,
                 batch_size: int = 32,
                 splitter: FileSplitter | None = None,
                 checkpoint: DataCheckpoint | None = None,
                 meta_prefetch: int | None = None,
                 mark_on_yield: bool = True,
                 retry_deadline: float | None = None,
                 fetch_workers: int | None = None,
                 prefetch_depth: int | None = None,
                 stream: bool | None = None,
                 produce_meta_batch: int | None = None):
        self.name = reader_name
        self.pod_id = pod_id
        self._leader = ResilientDataClient(
            leader_endpoint, on_reattach=self._do_reattach,
            retry_deadline=retry_deadline,
            name=f"{reader_name}/{pod_id[:8]}")
        self._server = data_server
        self._bs = batch_size
        self._splitter = splitter or TxtFileSplitter()
        self.checkpoint = checkpoint or DataCheckpoint(reader_name)
        # every prefetch knob defaults from its EDL_TPU_DATA_PREFETCH_*
        # env constant, so the launcher/ElasticInput path picks up
        # operator tuning without any code change
        self._prefetch = (constants.data_prefetch_meta()
                          if meta_prefetch is None else meta_prefetch)
        self._n_workers = max(1, constants.data_prefetch_workers()
                              if fetch_workers is None else fetch_workers)
        self._depth = max(self._prefetch,
                          constants.data_prefetch_depth()
                          if prefetch_depth is None else prefetch_depth)
        self._stream = (constants.data_prefetch_stream()
                        if stream is None else bool(stream))
        # mark_on_yield=False defers checkpoint marking to the caller
        # (elastic_input marks per record as batches are actually fed to
        # the train step, so a mid-epoch save never claims records that
        # were fetched but not yet trained)
        self._mark_on_yield = mark_on_yield
        # producer pauses when the leader's unfetched backlog exceeds
        # this (half the default PodDataServer cache, so local caches
        # never evict in steady state)
        self._backpressure = 128
        # producer-side meta coalescing: one
        # report_batch_meta leader RPC per chunk of produced batches
        # instead of one per batch.  Buffered metas are guarded by
        # _state_lock because the reattach handshake flushes them from
        # whichever thread hit the leader failure (see _do_reattach:
        # unflushed metas MUST land before the rebuild grace expires,
        # or a re-seeded leader's span repair would re-produce them)
        self._meta_batch = max(1, constants.data_produce_meta_batch()
                               if produce_meta_batch is None
                               else produce_meta_batch)
        self._meta_buf: list[list] = []
        self._produce_exc: BaseException | None = None
        self._stop_produce = threading.Event()
        self._producer: threading.Thread | None = None
        # one channel pool per producer endpoint, SHARED by the fetch
        # workers: per-connection locking means a dead producer costs
        # the workers one timeout in parallel, not N in series
        self._peer_pools: dict[str, RpcChannelPool] = {}
        self._pools_lock = threading.Lock()
        # endpoints demoted to per-batch fetch (old peer without the
        # streaming handler): probed at most once per endpoint for the
        # reader's life, surviving pool churn
        self._demoted: set[str] = set()
        self._task_q: "queue.Queue" = queue.Queue()
        self._done_q: "queue.Queue" = queue.Queue()
        self._fetch_workers: list[threading.Thread] = []
        self._closed = False
        # -- reattach state (all guarded by _state_lock): what this
        # reader would need to re-establish itself on a successor leader
        self._state_lock = threading.Lock()
        self._files: list[str] = []
        self._held: set[str] = set()          # fetched/yielded, unacked
        self._claimed: dict[int, list[list[int]]] = {}  # spans we own
        self._finished_files: list[int] = []
        self._producing: list | None = None   # [file_idx, only] in flight
        self._abandon_produce = threading.Event()
        # batches delivered by path ("local", "stream", "rpc"), stream
        # errors and demotions: the first thing to read when input slows
        self.counts: dict[str, int] = {}
        self._counts_lock = threading.Lock()

    def _count(self, key: str) -> None:
        with self._counts_lock:
            self.counts[key] = self.counts.get(key, 0) + 1

    def create(self, files: list[str]) -> "DistributedReader":
        """Create/join this reader's generation on the leader, seeding it
        with this pod's restored checkpoint spans (identical across pods
        — every pod restores the same shared checkpoint)."""
        with self._state_lock:
            self._files = list(files)
        self._leader.call("create_reader", reader=self.name, files=files,
                          consumed=self._checkpoint_spans())
        return self

    def _checkpoint_spans(self) -> list[list[int]]:
        return [[r.file_idx, r.begin, r.end]
                for r in self.checkpoint.processed]

    # -- reattach ------------------------------------------------------------
    def _do_reattach(self, raw_call) -> None:
        """Handshake run by the resilient client after a leader
        failover/restart (or "generation gone"): merge what this reader
        owns back into the (possibly re-seeded) generation and reclaim
        its in-flight work.  Replay-idempotent by construction."""
        with self._state_lock:
            if not self._files:
                return  # create() not yet called: nothing to re-assert
            consumed: dict[int, list[list[int]]] = {
                fi: [list(s) for s in spans]
                for fi, spans in self._claimed.items()}
            held = sorted(self._held)
            producing = list(self._producing) if self._producing else None
            finished = list(self._finished_files)
            files = list(self._files)
        for fi, b, e in self._checkpoint_spans():
            merge_span(consumed.setdefault(fi, []), b, e)
        resp = raw_call(
            "reattach_reader", reader=self.name, pod_id=self.pod_id,
            endpoint=self._server.endpoint, files=files,
            consumed=[[fi, b, e] for fi, spans in sorted(consumed.items())
                      for b, e in spans],
            held=held, producing=producing, finished=finished)
        dropped = resp.get("drop") or []
        with self._state_lock:
            for bid in dropped:
                self._held.discard(bid)
        if dropped:
            logger.warning(
                "reader %s: leader dropped %d unrestorable in-flight "
                "batches on reattach (their spans ride our consumed set)",
                self.name, len(dropped))
        if resp.get("abandon_file"):
            # our in-flight file was re-granted elsewhere: stop emitting
            # it (the producer loop checks this between records)
            self._abandon_produce.set()
            with self._state_lock:
                self._meta_buf.clear()   # the new owner covers them
        else:
            # flush coalesced-but-unreported metas on the successor NOW,
            # inside the rebuild grace: their spans ride our producing
            # position, so a repair grant issued before this report
            # would re-produce them (grant-time skip covers spans that
            # are already reported — exactly the single-batch
            # mid-publish-crash ordering, widened to the buffer)
            with self._state_lock:
                buf = list(self._meta_buf)
            if buf:
                raw_call("report_batch_meta", reader=self.name,
                         pod_id=self.pod_id,
                         endpoint=self._server.endpoint, batches=buf)
                with self._state_lock:
                    del self._meta_buf[:len(buf)]
        logger.info("reader %s: reattached to leader %s (%d held, "
                    "producing=%s)", self.name, self._leader.endpoint,
                    len(held), producing)

    def _claim(self, spans: list) -> None:
        """Record spans this reader now owns (fetched + will train):
        they ride every reattach so a re-seeded generation never
        re-produces them."""
        with self._state_lock:
            for file_idx, b, e in spans:
                merge_span(self._claimed.setdefault(int(file_idx), []),
                           int(b), int(e))

    # -- producer ------------------------------------------------------------
    def _produce(self) -> None:
        try:
            seq = 0
            while not self._stop_produce.is_set():
                assignment = self._leader.call("next_file", reader=self.name,
                                               pod_id=self.pod_id)
                if assignment["file"] is None:
                    if assignment.get("eof"):
                        return  # generation fully drained — really done
                    # stay alive: a dead peer's files may requeue to us
                    time.sleep(0.05)
                    continue
                file_idx, path = assignment["file"]
                skip = assignment["skip"]
                only = assignment.get("only")
                self._abandon_produce.clear()
                with self._state_lock:
                    # [file_idx, only, position]: position is a
                    # conservative upper bound of records this producer
                    # has (or is about to have) published — a re-seeded
                    # successor repairs [0, position) since the old
                    # leader's metas died with it
                    self._producing = [int(file_idx), only, 0]
                try:
                    seq = self._produce_file(int(file_idx), path, skip, only,
                                             seq)
                finally:
                    with self._state_lock:
                        self._producing = None
        except BaseException as e:  # noqa: BLE001 — surfaced by consumer
            self._produce_exc = e

    def _produce_file(self, file_idx: int, path: str,
                      skip: list[list[int]], only: list[list[int]] | None,
                      seq: int) -> int:
        """Emit batches for one file, skipping consumed spans (and, for a
        span-only repair assignment, everything outside ``only``);
        report failure to the leader so ALL consumers see it (the
        producing pod alone would not tell them)."""
        try:
            batch: list = []
            spans: list[list[int]] = []
            begin = None
            record_no = -1
            for record_no, record in self._splitter.split(path):
                if self._abandon_produce.is_set():
                    # the leader re-granted this file elsewhere while we
                    # were partitioned: stop emitting, report nothing —
                    # the new owner covers the remainder (including any
                    # metas still buffered: reporting them NOW would
                    # double-produce spans the re-grant already covers)
                    with self._state_lock:
                        self._meta_buf.clear()
                    logger.warning("reader %s: abandoning file %d "
                                   "mid-production (re-granted elsewhere)",
                                   self.name, file_idx)
                    return seq
                if self._stop_produce.is_set():
                    return seq
                if (only is not None and not in_spans(only, record_no)) or \
                        in_spans(skip, record_no) or \
                        self.checkpoint.is_processed(file_idx, record_no):
                    if begin is not None:
                        spans.append([file_idx, begin, record_no])
                        begin = None
                    continue
                if begin is None:
                    begin = record_no
                batch.append(record)
                if len(batch) == self._bs:
                    spans.append([file_idx, begin, record_no + 1])
                    self._note_position(record_no + 1)
                    seq = self._publish(seq, batch, spans)
                    batch, spans, begin = [], [], None
            if begin is not None:
                spans.append([file_idx, begin, record_no + 1])
            if batch:
                self._note_position(record_no + 1)
                seq = self._publish(seq, batch, spans)
            # the tail of the coalescing buffer must land before the
            # grant closes: file_done with unreported metas could let
            # the generation drain without them
            self._flush_metas()
            if self._abandon_produce.is_set():
                # re-granted elsewhere during the tail flush (or after
                # the last record check): the new owner finishes the
                # file — a file_done from us would close THEIR grant
                logger.warning("reader %s: abandoning file %d at "
                               "file_done (re-granted elsewhere)",
                               self.name, file_idx)
                return seq
            self._leader.call("file_done", reader=self.name,
                              pod_id=self.pod_id, file_idx=file_idx)
            with self._state_lock:
                self._finished_files.append(file_idx)
            return seq
        except EdlError:
            raise  # leader unreachable etc. — not a file problem
        except Exception as e:  # noqa: BLE001 — unreadable/corrupt file
            try:
                self._leader.call("file_failed", reader=self.name,
                                  pod_id=self.pod_id, file_idx=file_idx,
                                  error=f"{type(e).__name__}: {e}")
            except Exception as report_err:  # noqa: BLE001
                # the original error still propagates below; the leader
                # learns of the dead grant via requeue-on-expiry instead
                logger.debug("file_failed report for file %d lost: %s",
                             file_idx, report_err)
            raise

    def _note_position(self, position: int) -> None:
        """Advance the in-flight grant's published-records bound —
        BEFORE the publish, so a crash mid-publish still repairs the
        batch on a re-seeded leader (the retried publish makes its
        records live, which the repair's grant-time skip then covers)."""
        with self._state_lock:
            if self._producing is not None:
                self._producing[2] = max(self._producing[2], position)

    def _publish(self, seq: int, batch: list, spans: list) -> int:
        batch_id = f"{self.pod_id}:{self.name}:{seq}"
        self._server.put_batch(batch_id, {"records": batch, "spans": spans})
        with self._state_lock:
            self._meta_buf.append([batch_id, [list(s) for s in spans]])
            full = len(self._meta_buf) >= self._meta_batch
        if full:
            self._flush_metas(throttle=True)
        return seq + 1

    def _flush_metas(self, throttle: bool = False) -> None:
        """Report every buffered meta in ONE leader RPC (the coalesced
        cadence: leader traffic amortizes to 1/meta_batch per batch on
        the produce side, matching the consumer's chunked hand-out)."""
        with self._state_lock:
            buf, self._meta_buf = self._meta_buf, []
        if not buf and not throttle:
            return
        abort = self._abandon_produce.is_set
        try:
            backlog = self._leader.call(
                "report_batch_meta", reader=self.name, pod_id=self.pod_id,
                endpoint=self._server.endpoint, batches=buf,
                _abort_if=abort)["backlog"]
        except CallAborted:
            # the file was re-granted elsewhere during a reattach a
            # retry of THIS report triggered: the re-grant's skip does
            # not cover these unreported spans (the new owner produces
            # them), so replaying the swapped-out buffer on the
            # successor would double-produce.  Drop it — the record
            # loop's abandon check ends the grant.
            logger.warning("reader %s: dropped %d in-flight metas (file "
                           "re-granted elsewhere mid-report)",
                           self.name, len(buf))
            return
        # throttle: running far ahead of consumption would evict
        # unfetched batches from the local cache (repairable, but wasted
        # re-production); an empty report is the cheap backlog poll
        while (throttle and backlog > self._backpressure
               and not self._stop_produce.is_set()):
            time.sleep(0.05)
            try:
                backlog = self._leader.call(
                    "report_batch_meta", reader=self.name,
                    pod_id=self.pod_id, endpoint=self._server.endpoint,
                    batches=[], _abort_if=abort)["backlog"]
            except CallAborted:
                return   # metas already delivered; just stop polling

    # -- consumer ------------------------------------------------------------
    def __iter__(self) -> Iterator[tuple[str, list]]:
        self._producer = threading.Thread(target=self._produce, daemon=True,
                                          name=f"produce:{self.name}")
        self._producer.start()
        for i in range(self._n_workers):
            t = threading.Thread(target=self._fetch_worker, daemon=True,
                                 name=f"fetch:{self.name}:{i}")
            self._fetch_workers.append(t)
            t.start()
        ack_ids: list[str] = []
        nacks: dict[bool, list[str]] = {True: [], False: []}
        req_id = 0
        pending = 0  # metas dispatched to workers, result not yet popped
        eof = False
        try:
            while True:
                # flush nacks BEFORE asking for more work: the leader
                # must requeue lost batches before it can run dry.
                # "dead" (unreachable) kills the producer's work; "miss"
                # (evicted or stream-mangled by a live producer)
                # re-produces just those batches' spans
                for dead, ids in nacks.items():
                    if ids:
                        logger.warning("nacking %d batches "
                                       "(producer_dead=%s)", len(ids), dead)
                        self._leader.call("nack_batches", reader=self.name,
                                          pod_id=self.pod_id, batch_ids=ids,
                                          producer_dead=dead)
                        with self._state_lock:
                            self._held.difference_update(ids)
                nacks = {True: [], False: []}
                got_metas = False
                # top up in prefetch-sized chunks (not per pop): one
                # leader round trip hands out — and acks — up to
                # meta_prefetch batches, so leader traffic amortizes to
                # 1/meta_prefetch per batch however deep the pipeline
                room = self._depth - pending
                if not eof and (room >= self._prefetch or pending == 0):
                    try:
                        # req_id makes the hand-out replay-safe: a RETRY
                        # of this call (same id) whose first response
                        # was lost gets the SAME metas back instead of
                        # stranding them in our server-side inflight
                        req_id += 1
                        metas = self._leader.call(
                            "get_batch_meta", reader=self.name,
                            pod_id=self.pod_id,
                            n=min(self._prefetch, room),
                            ack_ids=ack_ids, req_id=req_id)["metas"]
                    except EdlStopIteration:
                        # the leader only answers this once OUR held set
                        # is empty and the generation is drained — the
                        # acks on this very call landed before the raise
                        eof = True
                        metas = []
                    with self._state_lock:
                        self._held.difference_update(ack_ids)
                    ack_ids = []
                    if metas:
                        with self._state_lock:
                            self._held.update(m[2] for m in metas)
                        pending += len(metas)
                        got_metas = True
                        self._dispatch(metas)
                if pending == 0:
                    if eof:
                        break
                    if self._produce_exc is not None:
                        raise self._produce_exc
                    if not got_metas:
                        time.sleep(0.05)
                    continue
                # pop ONE completed fetch; the bounded wait keeps the
                # meta top-up (and produce_exc checks) responsive while
                # fetches are in flight
                try:
                    bid, payload, failure = self._done_q.get(timeout=0.5)
                except queue.Empty:
                    continue
                pending -= 1
                if payload is None:
                    nacks[failure == "dead"].append(bid)
                    continue
                self._claim(payload["spans"])
                if self._mark_on_yield:
                    for file_idx, begin, end in payload["spans"]:
                        self.checkpoint.mark_processed(file_idx, begin, end)
                # ack rides the NEXT get_batch_meta call — issued on
                # yield, never on fetch, so a crash between fetch and
                # train leaves the batch reclaimable on reattach
                ack_ids.append(bid)
                yield bid, payload
            if self._produce_exc is not None:
                raise self._produce_exc
        finally:
            self.close()

    def close(self, deadline: float = 5.0) -> None:
        """Shut the reader down within ``deadline`` seconds.

        The stop flag is set *and* the leader client's in-flight retry
        loops are capped by the deadline before the producer join, so a
        producer thread blocked in a leader call unwinds instead of
        outliving the join; the fetch workers drain under the same
        budget.  A thread that still won't die (e.g. wedged in a kernel
        recv) is logged — never silently leaked."""
        if self._closed:
            return
        self._closed = True
        self._stop_produce.set()
        self._leader.close_after(deadline)
        for _ in self._fetch_workers:
            self._task_q.put(None)
        producer = self._producer
        if producer is not None and producer.is_alive():
            producer.join(timeout=deadline)
            if producer.is_alive():
                logger.warning(
                    "reader %s: producer thread still blocked in an "
                    "in-flight leader call after the %.1fs close deadline; "
                    "abandoning it (daemon thread, call timeout capped)",
                    self.name, deadline)
        end = time.monotonic() + deadline
        for t in self._fetch_workers:
            t.join(timeout=max(0.0, end - time.monotonic()))
        stuck = [t for t in self._fetch_workers if t.is_alive()]
        if stuck:
            # closing a pool blocks on its per-channel locks, and a
            # wedged worker may hold one — leave those pools to the
            # daemon threads rather than wedging close() itself
            logger.warning(
                "reader %s: %d fetch workers still blocked mid-fetch "
                "after the %.1fs close deadline; abandoning them (daemon "
                "threads; their channel pools stay open)",
                self.name, len(stuck), deadline)
        else:
            for pool in self._peer_pools.values():
                pool.close()
        self._leader.close()

    # -- the fetch pipeline --------------------------------------------------
    def _pool(self, endpoint: str) -> RpcChannelPool:
        with self._pools_lock:
            pool = self._peer_pools.get(endpoint)
            if pool is None:  # construction is lazy: no connect here
                pool = self._peer_pools[endpoint] = RpcChannelPool(
                    endpoint, timeout=10.0)
            return pool

    def _dispatch(self, metas: list) -> None:
        """Group fresh metas by producer endpoint (request order kept
        within a group) and hand them to the fetch workers; group size
        is capped by ``EDL_TPU_DATA_STREAM_BATCH`` so one stream never
        monopolizes a worker (or a channel) for a whole depth's
        worth of batches."""
        groups: dict[tuple[str, str], list] = {}
        for m in metas:
            groups.setdefault((m[0], m[1]), []).append(m)
        cap = max(1, constants.data_stream_batch())
        for (pod, ep), group in groups.items():
            for i in range(0, len(group), cap):
                self._task_q.put((pod, ep, group[i:i + cap]))

    def _fetch_worker(self) -> None:
        while True:
            task = self._task_q.get()
            if task is None:
                return
            producer_pod, endpoint, metas = task
            try:
                results = self._fetch_group(producer_pod, endpoint, metas)
            except Exception as e:  # noqa: BLE001 — a worker survives
                # backstop for bugs, not for transport verdicts: report
                # "miss" (requeue just these spans), never "dead" — an
                # unexpected local error must not kill a live
                # producer's whole work set (that double-produces its
                # files)
                logger.warning("fetch worker: group fetch from %s failed "
                               "unexpectedly: %s", endpoint, e)
                results = [(m[2], None, "miss") for m in metas]
            for item in results:
                self._done_q.put(item)

    def _fetch_group(self, producer_pod: str, endpoint: str, metas: list,
                     ) -> list[tuple[str, dict | None, str | None]]:
        """Fetch one producer's batch group; per batch: ``(batch_id,
        payload, None)`` on success, ``(batch_id, None, "miss")`` when a
        LIVE producer answered without the batch (cache eviction, or a
        stream-protocol error mangled its frames), ``(batch_id, None,
        "dead")`` when the producer is unreachable."""
        if producer_pod == self.pod_id:
            out = []
            for _pod, _ep, bid, _spans in metas:
                local = self._server.pop_batch(bid)
                if local is not None:
                    self._count("local")
                # a local miss means our own cache evicted it; we are
                # alive, so it repairs rather than killing our work
                out.append((bid, local, None if local is not None
                            else "miss"))
            return out
        pool = self._pool(endpoint)
        out = []
        leftover = [m[2] for m in metas]
        if self._stream and endpoint not in self._demoted:
            got, verdict = self._fetch_streamed(pool, leftover)
            leftover = []
            for _pod, _ep, bid, _spans in metas:
                if bid in got:
                    payload = got[bid]
                    if payload is None:
                        out.append((bid, None, "miss"))
                    else:
                        self._count("stream")
                        out.append((bid, payload, None))
                elif verdict == "stream":
                    # the producer answered but its stream desynced:
                    # treat the unreceived batches like evictions — the
                    # leader requeues exactly their spans for
                    # re-production (never dropped, never double-acked)
                    out.append((bid, None, "miss"))
                else:
                    leftover.append(bid)  # demoted / transport: retry
        # per-batch path: old peers (probe-once demotion), forced
        # legacy mode, and the remainder of a transport-failed stream.
        # One batch concluding "dead" concludes the whole group — the
        # batches share one endpoint, and a full retry cycle is the
        # same evidence for all of them (paying it per batch would
        # serialize N retry cycles against one dead producer)
        dead = False
        for bid in leftover:
            if dead:
                out.append((bid, None, "dead"))
                continue
            payload, failure = self._fetch_one(pool, bid)
            dead = failure == "dead"
            out.append((bid, payload, failure))
        return out

    def _fetch_streamed(self, pool: RpcChannelPool, batch_ids: list[str],
                        ) -> tuple[dict, str | None]:
        """One ``get_batch_stream`` request for the whole group.
        Returns ``(received, verdict)`` where ``received`` maps batch
        id -> payload (None = producer-side miss) and ``verdict`` is
        None (complete), ``"demote"`` (old peer — the endpoint joins
        ``_demoted`` and is never probed again), ``"stream"`` (typed
        protocol error; the channel is already torn down), or
        ``"transport"``."""
        got: dict[str, dict | None] = {}
        idx = 0
        try:
            for frame in pool.call_streaming("get_batch_stream",
                                             batch_ids=batch_ids):
                if idx >= len(batch_ids):
                    raise EdlStreamError(
                        f"get_batch_stream from {pool.endpoint}: frame "
                        f"{idx} past the {len(batch_ids)} requested "
                        f"batches")
                if isinstance(frame, (bytes, bytearray, memoryview)):
                    # raw-frame variant: the payload envelope was packed
                    # into one blob server-side (zero-copy formats)
                    try:
                        rec = framing.unpack(frame)
                    except Exception as e:
                        raise EdlStreamError(
                            f"get_batch_stream from {pool.endpoint}: "
                            f"undecodable frame {idx}: {e}") from e
                else:
                    rec = frame
                if not isinstance(rec, dict) \
                        or rec.get("batch_id") != batch_ids[idx]:
                    raise EdlStreamError(
                        f"get_batch_stream from {pool.endpoint}: frame "
                        f"{idx} answers batch "
                        f"{rec.get('batch_id') if isinstance(rec, dict) else rec!r}, "
                        f"expected {batch_ids[idx]!r}")
                got[batch_ids[idx]] = rec.get("payload")
                idx += 1
            if idx != len(batch_ids):
                raise EdlStreamError(
                    f"get_batch_stream from {pool.endpoint} ended after "
                    f"{idx} of {len(batch_ids)} batches")
            return got, None
        except EdlStreamError as e:
            self._count("stream_errors")
            logger.warning("streamed fetch from %s failed (%s); the "
                           "unreceived batches re-fetch via requeue",
                           pool.endpoint, e)
            return got, "stream"
        except EdlInternalError as e:
            if "no such method" in str(e):
                # probe-once demotion: an
                # old peer is asked for the stream once per endpoint
                # (concurrent workers already mid-probe may each pay
                # one, bounded by the worker count)
                self._demoted.add(pool.endpoint)
                self._count("demotions")
                logger.info("producer %s has no streamed delivery; "
                            "demoting this pool to per-batch fetch",
                            pool.endpoint)
                return got, "demote"
            self._count("stream_errors")
            logger.warning("streamed fetch from %s raised %s; the "
                           "unreceived batches re-fetch via requeue",
                           pool.endpoint, e)
            return got, "stream"
        except EdlCoordError as e:
            logger.warning("streamed fetch from %s transport failure: %s",
                           pool.endpoint, e)
            return got, "transport"
        except EdlError as e:
            # any other typed error crossed the wire: the producer
            # ANSWERED — it is alive, so the unreceived batches repair
            # as misses rather than condemning its whole work set
            self._count("stream_errors")
            logger.warning("streamed fetch from %s raised a typed error "
                           "(%s); the unreceived batches re-fetch via "
                           "requeue", pool.endpoint, e)
            return got, "stream"

    def _fetch_one(self, pool: RpcChannelPool, batch_id: str,
                   ) -> tuple[dict | None, str | None]:
        """Legacy per-batch request/reply fetch (one round trip).  A
        transient stall (peer busy compiling, GC pause) must not be
        read as death — declaring a LIVE producer dead re-produces its
        files and double-trains records; so retry before concluding."""
        for attempt in range(3):
            try:
                payload = pool.call("get_batch_data",
                                    batch_id=batch_id)["payload"]
                self._count("rpc")
                return payload, None
            except EdlTableError as e:  # server answered: batch evicted
                logger.warning("fetch %s from %s: %s", batch_id,
                               pool.endpoint, e)
                return None, "miss"
            except EdlError as e:  # transport failure
                logger.warning("fetch %s from %s failed (try %d/3): %s",
                               batch_id, pool.endpoint, attempt + 1, e)
                if attempt < 2 and not self._closed:
                    time.sleep(1.0 * (attempt + 1))
        return None, "dead"
