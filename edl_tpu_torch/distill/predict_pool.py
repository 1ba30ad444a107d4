"""The predict pool: slicing, dispatch, retry, reorder (a copy of the JAX
package's ``distill/predict_pool.py``).

Thread-model port of the reference's concurrency core
(distill_worker.py:336-847), protocol-for-protocol:

- a reader thread cuts the sample stream into teacher-batch ``Task``s,
  bounded by a semaphore of ``2 × max_teachers + 2`` in-flight tasks
  (ordering window + backpressure, :547-596);
- one worker thread per attached teacher; a predict failure (after the
  client's own 3 retries) **requeues the task** and retires the worker
  — the reference's poison-pill accounting (:435-506) collapses to
  this because threads share the queues directly;
- a manager thread diffs desired teachers from discovery against
  attached workers, retiring dropped teachers and attaching new ones
  (:58-171);
- the consuming thread reorders completed tasks and re-stacks original
  batches (fetch_out, :720-847), releasing the semaphore as batches
  are yielded.

Unlike the JAX pool, a worker also ends when the pool halts, so a worker
the manager attaches during the consumer's shutdown does not outlive the
pool (a pool is built per epoch); and while it holds no teacher, the
manager looks again every ``FIRST_ATTACH_PERIOD`` seconds, not every
``manage_period``: a reader built per epoch over discovery otherwise waits
a whole period (2 s) for the discovery client's first list.

Threads, not processes: the workers are network-bound (the GIL is
released in socket IO), which removes the reference's fork-vs-logging
deadlock (distill_reader.py:384-393) and its cross-process poison-pill
reconciliation entirely.
"""

from __future__ import annotations

import itertools
import logging
import queue
import threading
import time
from typing import Callable, Iterable, Iterator

import numpy as np

from edl_tpu_torch.distill.tasks import BatchBuilder, Task
from edl_tpu_torch.distill.timeline import timeline

logger = logging.getLogger(__name__)

MAX_TASK_RETRIES = 8
FIRST_ATTACH_PERIOD = 0.05   # s: the manager's period while no teacher is attached


class PoolError(RuntimeError):
    pass


class _PoolHalted(Exception):
    """Internal: the consumer shut the pool down; stop reading quietly."""


class _Worker(threading.Thread):
    def __init__(self, pool: "PredictPool", endpoint: str, client):
        super().__init__(daemon=True, name=f"predict:{endpoint}")
        self.endpoint = endpoint
        self.client = client
        self.stop_event = threading.Event()
        self._pool = pool

    def run(self):
        pool = self._pool
        # the pool's halt ends a worker too: the manager may attach one
        # after the consumer's shutdown took its snapshot of the workers
        while not (self.stop_event.is_set() or pool._halt.is_set()):
            try:
                task = pool._in_queue.get(timeout=0.2)
            except queue.Empty:
                continue
            if self.stop_event.is_set():
                pool._in_queue.put(task)  # hand back; we're retiring
                break
            try:
                with timeline().span("predict", teacher=self.endpoint,
                                     task=task.task_id,
                                     n=len(task.samples)):
                    preds = self.client.predict(pool._feed_of(task))
            except Exception as e:  # noqa: BLE001 — teacher died
                logger.warning("worker %s failed on task %d: %s",
                               self.endpoint, task.task_id, e)
                task.retries += 1
                pool._requeue(task)
                pool._worker_died(self)
                self._close_client()
                return
            pool._out_queue.put(("done", task, preds))
        pool._worker_retired(self)
        self._close_client()

    def _close_client(self):
        try:
            self.client.close()
        except Exception as e:  # noqa: BLE001 — shutdown best-effort
            logger.debug("client close for %s failed: %s", self.endpoint, e)

    def stop(self):
        self.stop_event.set()


class PredictPool:
    """``run(stream)`` yields stacked (ins..., predicts...) batches.

    ``stream`` yields ``(batch_id, samples)`` with consecutive batch ids
    from 0; ``get_servers_fn()`` returns the currently-desired teacher
    endpoints (fixed list or discovery-backed)."""

    def __init__(self, client_factory: Callable[[str], object],
                 get_servers_fn: Callable[[], list[str]],
                 feed_names: list[str], feed_indices: list[int],
                 teacher_batch_size: int = 16, max_teachers: int = 8,
                 manage_period: float = 2.0, no_teacher_timeout: float = 120.0):
        self._client_factory = client_factory
        self._get_servers = get_servers_fn
        self._feed_names = list(feed_names)
        self._feed_indices = list(feed_indices)
        self._tbs = teacher_batch_size
        self._manage_period = manage_period
        self._no_teacher_timeout = no_teacher_timeout
        self._sem = threading.BoundedSemaphore(2 * max_teachers + 2)

        self._in_queue: queue.Queue[Task] = queue.Queue()
        self._out_queue: queue.Queue = queue.Queue()
        self._workers: dict[str, _Worker] = {}
        self._lock = threading.Lock()
        self._halt = threading.Event()
        self._reader_exc: BaseException | None = None

    # -- worker bookkeeping --------------------------------------------------
    def _worker_died(self, worker: _Worker) -> None:
        with self._lock:
            if self._workers.get(worker.endpoint) is worker:
                del self._workers[worker.endpoint]
        self._out_queue.put(("worker_died", worker.endpoint, None))

    def _worker_retired(self, worker: _Worker) -> None:
        with self._lock:
            if self._workers.get(worker.endpoint) is worker:
                del self._workers[worker.endpoint]

    def _live_workers(self) -> int:
        with self._lock:
            return len(self._workers)

    def _requeue(self, task: Task) -> None:
        if task.retries > MAX_TASK_RETRIES:
            self._out_queue.put(("fatal", PoolError(
                f"task {task.task_id} failed {task.retries} times"), None))
        else:
            self._in_queue.put(task)

    # -- manager -------------------------------------------------------------
    def _manage(self):
        while not self._halt.is_set():
            try:
                desired = set(self._get_servers())
            except Exception:  # noqa: BLE001 — discovery hiccup
                logger.exception("teacher discovery failed; keeping current set")
                desired = None
            if desired is not None:
                with self._lock:
                    current = dict(self._workers)
                for ep, w in current.items():
                    if ep not in desired:
                        logger.info("dropping teacher %s", ep)
                        w.stop()
                for ep in desired - set(current):
                    try:
                        client = self._client_factory(ep)
                    except Exception:  # noqa: BLE001 — not alive yet
                        logger.warning("teacher %s not reachable; skipping", ep)
                        continue
                    w = _Worker(self, ep, client)
                    with self._lock:
                        self._workers[ep] = w
                    logger.info("attached teacher %s", ep)
                    w.start()
            self._halt.wait(self._manage_period if self._live_workers()
                            else min(self._manage_period, FIRST_ATTACH_PERIOD))

    # -- reader --------------------------------------------------------------
    def _read(self, stream: Iterable[tuple[int, list[tuple]]],
              batch_sizes: dict[int, int]):
        try:
            counter = itertools.count()
            pending: list[tuple] = []
            pending_tags: list[tuple[int, int]] = []
            n_tasks = 0
            for batch_id, samples in stream:
                batch_sizes[batch_id] = len(samples)
                for slot, s in enumerate(samples):
                    pending.append(s)
                    pending_tags.append((batch_id, slot))
                    if len(pending) == self._tbs:
                        n_tasks += self._emit(next(counter), pending, pending_tags)
                        pending, pending_tags = [], []
            if pending:
                n_tasks += self._emit(next(counter), pending, pending_tags)
            self._out_queue.put(("end", n_tasks, None))
        except _PoolHalted:
            pass
        except BaseException as e:  # noqa: BLE001 — surface in consumer
            self._reader_exc = e
            self._out_queue.put(("fatal", e, None))

    def _emit(self, task_id: int, samples: list, tags: list) -> int:
        # poll the halt flag while waiting: a consumer that stops early
        # must not leave this thread parked on the semaphore forever
        while not self._sem.acquire(timeout=0.2):
            if self._halt.is_set():
                raise _PoolHalted
        self._in_queue.put(Task(task_id, list(samples), list(tags)))
        return 1

    # -- feeds ---------------------------------------------------------------
    def _feed_of(self, task: Task) -> dict[str, np.ndarray]:
        return {name: np.stack([np.asarray(s[idx]) for s in task.samples])
                for name, idx in zip(self._feed_names, self._feed_indices)}

    # -- the consuming loop --------------------------------------------------
    def run(self, stream: Iterable[tuple[int, list[tuple]]],
            fetch: list[str]) -> Iterator[tuple]:
        batch_sizes: dict[int, int] = {}
        reader = threading.Thread(target=self._read, args=(stream, batch_sizes),
                                  daemon=True, name="pool-reader")
        manager = threading.Thread(target=self._manage, daemon=True,
                                   name="pool-manager")
        reader.start()
        manager.start()
        builders: dict[int, BatchBuilder] = {}
        next_batch = 0
        done_tasks = 0
        total_tasks: int | None = None
        starved_since: float | None = None
        try:
            while total_tasks is None or done_tasks < total_tasks:
                try:
                    kind, a, b = self._out_queue.get(timeout=1.0)
                except queue.Empty:
                    starved_since = self._check_starvation(starved_since)
                    continue
                if kind == "fatal":
                    raise a if isinstance(a, BaseException) else PoolError(str(a))
                if kind == "end":
                    total_tasks = a
                    continue
                if kind == "worker_died":
                    starved_since = self._check_starvation(starved_since)
                    continue
                starved_since = None
                task, preds = a, b
                done_tasks += 1
                with timeline().span("reorder", task=task.task_id):
                    per_sample = _split_predicts(preds, fetch,
                                                 len(task.samples))
                    for (batch_id, slot), sample, pred in zip(
                            task.tags, task.samples, per_sample):
                        builder = builders.get(batch_id)
                        if builder is None:
                            builder = builders[batch_id] = BatchBuilder(
                                batch_id, batch_sizes[batch_id])
                        builder.add(slot, sample, pred)
                self._sem.release()
                while next_batch in builders and builders[next_batch].complete:
                    yield builders.pop(next_batch).stack()
                    next_batch += 1
            # drain any remaining complete batches (ids are dense)
            while next_batch in builders and builders[next_batch].complete:
                yield builders.pop(next_batch).stack()
                next_batch += 1
            if builders:
                raise PoolError(f"incomplete batches left: {sorted(builders)}")
        finally:
            self._halt.set()
            with self._lock:
                workers = list(self._workers.values())
            for w in workers:
                w.stop()

    def _check_starvation(self, starved_since: float | None) -> float:
        """No progress and no workers: start (or check) the starvation
        clock; discovery may still deliver new teachers until the
        timeout."""
        if self._live_workers() > 0:
            return None
        now = time.monotonic()
        if starved_since is None:
            return now
        if now - starved_since > self._no_teacher_timeout:
            raise PoolError(
                f"no live teacher for {self._no_teacher_timeout:.0f}s "
                "with work pending")
        return starved_since


def _split_predicts(preds: dict[str, np.ndarray], fetch: list[str],
                    n: int) -> list[tuple]:
    cols = [preds[name] for name in fetch]
    for name, c in zip(fetch, cols):
        if len(c) != n:
            raise PoolError(f"teacher returned {len(c)} rows for {name}, "
                            f"expected {n}")
    return [tuple(c[i] for c in cols) for i in range(n)]
