"""StudentFeed: stream a DistillReader while publishing the durable backlog
record that the controller's distillation autoscaler turns into a teacher
count (a copy of the JAX package's ``distill/backlog.py``, writing the same
record).

The backlog is the student's own accounting: rows handed to the predict
pool minus rows received back.  Every ``EDL_TPU_DISTILL_BACKLOG_PERIOD``
seconds it is written as a per-student record (``cluster/scale.py
save_backlog``, key ``scale/backlog/<student>``), timestamped and judged
against ``EDL_TPU_DEMAND_TTL`` by the reader of it, so a dead student's
last backlog decays instead of pinning teachers scaled out.  The JAX
module's gauges are not ported (ROADMAP.md Queue 1 item 8): the feed's
attributes carry the numbers.

The publisher is a thread, not an iteration hook: the backlog grows
exactly while the student loop is blocked inside the pool, when an inline
hook would never run.
"""

from __future__ import annotations

import logging
import os
import threading
import time
import uuid

from edl_tpu_torch.cluster import scale
from edl_tpu_torch.utils import constants
from edl_tpu_torch.utils.network import local_ip

logger = logging.getLogger(__name__)


class StudentFeed:
    """Iterate ``reader`` (a configured DistillReader) while publishing the
    backlog record for ``job_id`` (the teacher fleet's job)::

        feed = StudentFeed(store, "teachers", reader)
        for batch in feed:
            ...

    The feed counts rows as they stream into the pool (``submitted_rows``,
    from the wrapped input generator) and out of it (``consumed_rows``, the
    yielded batches); the difference is the backlog."""

    def __init__(self, store, job_id: str, reader, student_id: str | None = None,
                 period: float | None = None, batch_rows=None):
        self._store = store
        self.job_id = job_id
        self._reader = reader
        self.student_id = student_id or f"{local_ip()}-{os.getpid()}-{uuid.uuid4().hex[:6]}"
        self._period = constants.distill_backlog_period() if period is None else float(period)
        # the rows a yielded batch carries: by default the length of its
        # first field (a sample-list batch is a tuple of stacked arrays)
        self._batch_rows = batch_rows or (lambda b: len(b[0]))
        self._lock = threading.Lock()
        self.submitted_rows = 0
        self.consumed_rows = 0
        self._rate_ema = 0.0            # rows/s the teachers deliver
        self._last_pub_rows = 0
        self._last_pub_t: float | None = None
        self._halt = threading.Event()
        self._thread: threading.Thread | None = None
        self._wrap_input()

    # -- input and output accounting -----------------------------------------
    def _wrap_input(self) -> None:
        """Count rows as the pool pulls them from the user's generator: one
        a sample, ``len`` of a sample list, ``len`` of a batch's first
        column."""
        inner, mode = self._reader._gen, self._reader._mode
        if inner is None:
            raise RuntimeError("reader has no input generator configured")

        def counted():
            for item in inner():
                n = 1 if mode == "sample" else len(item) if mode == "sample_list" else len(item[0])
                with self._lock:
                    self.submitted_rows += n
                yield item
        self._reader._gen = counted

    def __iter__(self):
        self._start()
        try:
            for batch in self._reader():
                n = int(self._batch_rows(batch))
                with self._lock:
                    self.consumed_rows += n
                yield batch
        finally:
            self.stop()

    def __call__(self):
        return iter(self)

    # -- the backlog signal --------------------------------------------------
    def backlog_rows(self) -> int:
        with self._lock:
            return max(0, self.submitted_rows - self.consumed_rows)

    def observed_rows_per_s(self) -> float:
        with self._lock:
            return self._rate_ema

    def _publish_once(self, now: float | None = None) -> None:
        now = time.monotonic() if now is None else now
        with self._lock:
            queued = max(0, self.submitted_rows - self.consumed_rows)
            consumed = self.consumed_rows
            if self._last_pub_t is not None:
                inst = (consumed - self._last_pub_rows) / max(1e-6, now - self._last_pub_t)
                # an EMA, so one idle window does not read as a dead fleet;
                # alpha 0.5 follows a scale-out within about two periods
                self._rate_ema = (inst if self._rate_ema == 0.0
                                  else 0.5 * self._rate_ema + 0.5 * inst)
            self._last_pub_rows = consumed
            self._last_pub_t = now
            rate = self._rate_ema
        try:
            scale.save_backlog(self._store, self.job_id, self.student_id, queued, rate)
        except Exception as e:  # noqa: BLE001 — a store blip skips one beat
            logger.warning("backlog record publish failed: %s", e)

    def _run(self) -> None:
        while not self._halt.wait(self._period):
            self._publish_once()

    def _start(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name=f"student-backlog:{self.student_id[:12]}")
            self._thread.start()

    def stop(self) -> None:
        self._halt.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        try:
            scale.clear_backlog(self._store, self.job_id, self.student_id)
        except Exception as e:  # noqa: BLE001 — the freshness TTL decays it
            logger.debug("backlog record clear failed (%s); the freshness TTL decays it", e)
