"""ElasticInput: the data service wired into collective training (the port
of the JAX package's ``data/elastic_input.py``).

One object per trainer process turns the span-aware work queue
(``data/data_server.py``) into **fixed-size, collectively agreed, masked
batches**:

- per epoch, every pod registers its batch cache in the reader registry
  and waits until the reader set equals the cluster's pods
  (``data/registry.py``), so all processes enter together;
- records stream in through a :class:`DistributedReader` (work stealing,
  so pods consume different amounts) and are re-chunked into host batches
  of exactly ``batch_size`` records;
- every step runs a **has-next agreement** (an all-gather of one flag over
  the process group, ``train/distributed.py:allgather_flag``): while any
  process still has records, every process steps, and one with a short or
  empty buffer pads with zeros and a 0 mask.  The loss must be the masked
  mean, which makes the ragged end of an epoch trained instead of dropped;
  a model with batch statistics (BatchNorm) still sees the padded rows in
  them, so its running-stat update is dropped on a padded step
  (``train_resnet.py``);
- a batch carries its record spans under ``DATA_SPANS_KEY``; the trainer
  marks them into the job's :class:`DataCheckpoint` when it trains the
  batch, and :func:`sync_checkpoint` merges every process's spans before a
  save, so a mid-epoch checkpoint holds exactly the trained records and a
  resume (any world size) trains the rest once.

:func:`device_put_stream` stages host batches on the card one batch ahead
(pinned host tensors copied on a side CUDA stream).  Its module imports
nothing of the data plane's wire (``msgpack``): the trainer imports it for
every run, the data plane is imported when an :class:`ElasticInput` is
made.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator

import numpy as np
import torch

from edl_tpu_torch.cluster.state import DataCheckpoint, ProcessedRange
from edl_tpu_torch.utils import constants
from edl_tpu_torch.utils.device import enter_device
from edl_tpu_torch.utils.exceptions import EdlDataError
from edl_tpu_torch.utils.spans import merge_span

# assemble(records) -> {"name": np.ndarray (B', ...)} for B' <= batch_size
Assemble = Callable[[list], dict]

SPANS_KEY = constants.DATA_SPANS_KEY


def sync_checkpoint(checkpoint: DataCheckpoint) -> None:
    """Merge every process's consumed spans into ``checkpoint`` in place.

    Rank 0 writes the sidecar, but each process marks only the records it
    trained: without this merge a mid-epoch checkpoint would lose the other
    ranks' spans and a resume would train them again.  Collective: every
    rank calls it at the same step (the trainer does, before each save).
    Two all-gathers over the process group, the span counts and then the
    spans padded to ``[max count, 3]``; with no group (or a group of one)
    it does nothing."""
    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_world_size() <= 1:
        return
    from edl_tpu_torch.train.distributed import allgather_rows

    local = np.asarray([[r.file_idx, r.begin, r.end] for r in checkpoint.processed],
                       np.int32).reshape(-1, 3)
    counts = allgather_rows(np.asarray([len(local)], np.int32))[:, 0]
    cap = int(counts.max())
    if cap == 0:
        return
    padded = np.zeros((cap, 3), np.int32)
    padded[:len(local)] = local
    gathered = allgather_rows(padded)
    per_file: dict[int, list[list[int]]] = {}
    for p in range(gathered.shape[0]):
        for i in range(int(counts[p])):
            fi, b, e = (int(x) for x in gathered[p, i])
            merge_span(per_file.setdefault(fi, []), b, e)
    checkpoint.processed = [ProcessedRange(fi, b, e) for fi in sorted(per_file)
                            for b, e in per_file[fi]]


def _split(batch):
    """``(batch without its spans, spans or None)``; the spans stay host-side."""
    if isinstance(batch, dict) and SPANS_KEY in batch:
        batch = dict(batch)
        return batch, batch.pop(SPANS_KEY)
    return batch, None


def _tree(batch, leaf):
    """``leaf`` applied to every array of a batch (dicts, lists and tuples
    of numpy arrays or tensors; other values pass through)."""
    if isinstance(batch, dict):
        return {k: _tree(v, leaf) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(_tree(v, leaf) for v in batch)
    if isinstance(batch, np.ndarray):
        batch = torch.from_numpy(np.ascontiguousarray(batch))
    return leaf(batch) if isinstance(batch, torch.Tensor) else batch


class device_put_stream:
    """Stage host batches on ``device`` one batch ahead; iterate
    ``(device_batch, spans)``.

    On a card: batch k+1 is copied into pinned host memory and on to the
    card on a side CUDA stream, by one staging thread, while the caller
    consumes batch k.  The consumer's stream waits on the copy's event (the
    host does not), and ``record_stream`` tells the allocator that the
    consumer's stream uses the new tensors.  Tensors already on the card
    pass as they are.  ``h2d_wait_s`` sums the seconds the consumer waited
    for a staged batch (0 while the staging keeps ahead), over ``batches``.
    The depth stays one batch, and the source is read by the consumer's
    thread, so any collective inside it (the has-next agreement) runs in
    the same order on every process.  A failed copy raises: there is no
    synchronous fallback.

    ``SPANS_KEY`` is split out before the put and never leaves the host: the
    consumer marks the spans when it trains the batch, never the stage (a
    checkpoint would otherwise claim records one batch ahead).

    On the CPU the stage is a pass-through in the same order (numpy arrays
    become tensors)."""

    def __init__(self, batches: Iterable, device: str | torch.device):
        self._batches = batches
        self.device = torch.device(device)
        self.h2d_wait_s = 0.0
        self.batches = 0

    def __iter__(self) -> Iterator[tuple[object, list | None]]:
        if self.device.type != "cuda":
            for batch in self._batches:
                host, spans = _split(batch)
                self.batches += 1
                yield _tree(host, lambda t: t.to(self.device)), spans
            return
        if self.device.index is None:   # "cuda": the consumer's current card
            self.device = torch.device("cuda", torch.cuda.current_device())
        side = torch.cuda.Stream(self.device)

        def put(host):
            enter_device(self.device)   # the staging thread's current card
            made: list[torch.Tensor] = []

            def copy(t: torch.Tensor) -> torch.Tensor:
                if t.device.type == "cuda":
                    return t
                out = t.pin_memory().to(self.device, non_blocking=True)
                made.append(out)
                return out

            with torch.cuda.stream(side):
                dev = _tree(host, copy)
                event = torch.cuda.Event()
                event.record(side)
            return dev, event, made

        with ThreadPoolExecutor(1, thread_name_prefix="h2d-stage") as pool:
            staged = None
            for batch in self._batches:
                host, spans = _split(batch)
                nxt = (pool.submit(put, host), spans)
                if staged is not None:
                    yield self._take(*staged)
                staged = nxt
            if staged is not None:
                yield self._take(*staged)

    def _take(self, fut, spans):
        t0 = time.perf_counter()
        dev, event, made = fut.result()
        self.h2d_wait_s += time.perf_counter() - t0
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(event)
        for t in made:
            t.record_stream(stream)
        self.batches += 1
        return dev, spans


class ElasticInput:
    """Lives for the whole trainer process; ``epoch()`` yields one epoch's
    batches.  ``assemble`` builds host arrays from raw records (and takes an
    empty list: a process whose buffer ran dry pads a whole batch); a short
    batch is zero-padded and masked.  The reader's prefetch tuning comes
    from the ``EDL_TPU_DATA_PREFETCH_*`` knobs.  The pod's batch cache
    (``PodDataServer``) serves from construction until :meth:`stop`.
    ``leader``: a zero-argument resolver of the data service's endpoint
    (``lambda: resolve_data_leader(store, job_id)`` for a standalone
    elected leader, ``data/leader.py``); by default the current cluster
    record's leader."""

    def __init__(self, store, job_id: str, pod_id: str, reader_base: str,
                 files: list[str], batch_size: int, splitter, assemble: Assemble,
                 distributed: bool = False, cache_cap: int = 256,
                 leader: Callable[[], str] | None = None):
        from edl_tpu_torch.data.data_server import PodDataServer

        self._store = store
        self._job_id = job_id
        self._pod_id = pod_id
        self._base = reader_base
        self._files = sorted(files)
        self._bs = batch_size
        self._splitter = splitter
        self._assemble = assemble
        self._distributed = distributed
        self._leader = leader
        self.server = PodDataServer(pod_id, cache_cap=cache_cap)

    def _leader_resolver(self):
        """The reader's leader resolver: the endpoint is read again from the
        current cluster record on every failover, so a successor hosting the
        service is found without restarting the epoch."""
        from edl_tpu_torch.cluster.cluster import Cluster

        if self._leader is not None:
            return self._leader

        def resolve() -> str:
            cluster = Cluster.load_from_store(self._store, self._job_id)
            if cluster is None or cluster.leader is None:
                raise EdlDataError("cluster has no pods")
            return cluster.leader.endpoint
        return resolve

    def epoch(self, epoch: int, checkpoint: DataCheckpoint) -> Iterator[dict]:
        """Yield masked host batches for one epoch.  The generation is
        ``base@e<epoch>@<stage>``: a new cluster stage (a resize) or epoch
        makes a fresh generation, seeded from ``checkpoint`` (the restored
        mid-epoch spans on a resume)."""
        from edl_tpu_torch.cluster.cluster import Cluster
        from edl_tpu_torch.data import registry
        from edl_tpu_torch.data.distribute_reader import DistributedReader

        cluster = Cluster.load_from_store(self._store, self._job_id)
        if cluster is None:
            raise EdlDataError("no cluster in store; is the launcher up?")
        name = f"{self._base}@e{epoch}@{cluster.stage[:8]}"
        checkpoint.reader_name = name
        reg = registry.register_reader(self._store, self._job_id, name, self._pod_id,
                                       self.server.endpoint)
        reader = None
        try:
            registry.wait_dist_readers(self._store, self._job_id, name, cluster.pod_ids())
            reader = DistributedReader(
                name, self._pod_id, self._leader_resolver(), self.server,
                batch_size=self._bs, splitter=self._splitter, checkpoint=checkpoint,
                mark_on_yield=False)
            reader.create(self._files)
            yield from self._batches(reader)
        finally:
            if reader is not None:
                reader.close()
            reg.stop()

    # -- the re-chunk + agreement loop ---------------------------------------
    def _batches(self, reader) -> Iterator[dict]:
        buf: list[tuple[object, int, int]] = []  # (record, file_idx, record_no)
        it = iter(reader)
        exhausted = False
        while True:
            while len(buf) < self._bs and not exhausted:
                try:
                    _bid, payload = next(it)
                except StopIteration:
                    exhausted = True
                    break
                records = payload["records"]
                coords = [(fi, no) for fi, b, e in payload["spans"] for no in range(b, e)]
                if len(coords) != len(records):
                    raise EdlDataError(f"spans cover {len(coords)} records, got {len(records)}")
                buf.extend((r, fi, no) for r, (fi, no) in zip(records, coords))
            has = int(bool(buf))
            if self._distributed:
                from edl_tpu_torch.train.distributed import allgather_flag
                if not allgather_flag(has).any():
                    return
            elif not has:
                return
            take, buf = buf[:self._bs], buf[self._bs:]
            batch = self._assemble([r for r, _fi, _no in take])
            n = len(take)
            pad = self._bs - n
            if pad:
                batch = {k: np.concatenate([v, np.zeros((pad,) + v.shape[1:], v.dtype)])
                         for k, v in batch.items()}
            batch["mask"] = np.concatenate([np.ones(n, np.float32), np.zeros(pad, np.float32)])
            # the batch carries its record spans (contiguous runs); the
            # consumer marks them when it trains the batch
            runs: list[list[int]] = []
            for _r, fi, no in take:
                if runs and runs[-1][0] == fi and runs[-1][2] == no:
                    runs[-1][2] = no + 1
                else:
                    runs.append([fi, no, no + 1])
            batch[SPANS_KEY] = runs
            yield batch

    def stop(self) -> None:
        self.server.stop()
