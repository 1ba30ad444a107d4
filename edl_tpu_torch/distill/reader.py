"""DistillReader: the student-side user API (the port of the JAX package's
``distill/reader.py``; numpy in, numpy out, so a student of either package
reads through it).

Reference: distill_reader.py (416).  Wraps any sample / sample-list /
batch generator; appends teacher prediction fields to every yielded
batch.  Teachers come from a fixed list, from the discovery service, or
from env (the reference's ``PADDLE_DISTILL_*`` becomes
``EDL_TPU_DISTILL_*``, same precedence: env overrides code,
distill_reader.py:255-298).

    dr = DistillReader(ins=["image", "label"], predicts=["logits"])
    dr.set_fixed_teacher("10.0.0.5:9000")
    dr.set_sample_list_generator(train_reader)
    for image, label, logits in dr():
        ...
"""

from __future__ import annotations

import logging
import os
from typing import Callable, Iterable, Iterator

import numpy as np

from edl_tpu_torch.distill.predict_client import NopPredictClient, TeacherClient
from edl_tpu_torch.distill.predict_pool import PredictPool

logger = logging.getLogger(__name__)

# test hook, reference distill_worker._NOP_PREDICT_TEST (:23 in tests)
_NOP_PREDICT_TEST = False


class DistillReader:
    def __init__(self, ins: list[str], predicts: list[str],
                 feeds: list[str] | None = None,
                 teacher_batch_size: int | None = None):
        self._ins = list(ins)
        self._predicts = list(predicts)
        self._feeds = list(feeds) if feeds is not None else list(ins)
        for f in self._feeds:
            if f not in self._ins:
                raise ValueError(f"feed {f!r} not among ins {self._ins}")
        env_tbs = os.environ.get("EDL_TPU_DISTILL_TEACHER_BATCH_SIZE")
        self._tbs = int(env_tbs) if env_tbs else (teacher_batch_size or 16)
        self._gen: Callable[[], Iterable] | None = None
        self._mode = "sample_list"
        self._fixed: list[str] = []
        self._discovery: tuple | None = None
        self._servers_fn_override: Callable[[], list[str]] | None = None
        self._max_teachers = int(os.environ.get("EDL_TPU_DISTILL_MAX_TEACHER", 8))
        self._pool_kw: dict = {}
        self._apply_env()

    def _apply_env(self) -> None:
        teachers = os.environ.get("EDL_TPU_DISTILL_TEACHERS")
        if teachers:
            self._fixed = [t.strip() for t in teachers.split(",") if t.strip()]
        disc = os.environ.get("EDL_TPU_DISTILL_DISCOVERY")
        service = os.environ.get("EDL_TPU_DISTILL_SERVICE_NAME")
        if disc and service:
            self._discovery = (disc, service)

    # -- teacher config ------------------------------------------------------
    def set_teacher_batch_size(self, n: int) -> "DistillReader":
        self._tbs = n
        return self

    def set_fixed_teacher(self, *endpoints: str) -> "DistillReader":
        self._fixed = list(endpoints)
        self._discovery = None
        return self

    def set_dynamic_teacher(self, discovery_endpoints: str, service: str,
                            max_teachers: int = 8) -> "DistillReader":
        self._discovery = (discovery_endpoints, service)
        self._max_teachers = max_teachers
        self._fixed = []
        return self

    def set_servers_fn(self, fn: Callable[[], list[str]]) -> "DistillReader":
        """Plug a custom discovery backend: any callable returning the
        current teacher endpoints (e.g. LiteDiscoveryClient.servers).
        An optional ``fn.close`` is called when iteration ends."""
        self._servers_fn_override = fn
        return self

    # -- input config --------------------------------------------------------
    def set_sample_generator(self, fn) -> "DistillReader":
        self._gen, self._mode = fn, "sample"
        return self

    def set_sample_list_generator(self, fn) -> "DistillReader":
        self._gen, self._mode = fn, "sample_list"
        return self

    def set_batch_generator(self, fn) -> "DistillReader":
        self._gen, self._mode = fn, "batch"
        return self

    # -- iteration -----------------------------------------------------------
    def __call__(self) -> Iterator[tuple]:
        return self._iterate()

    def __iter__(self) -> Iterator[tuple]:
        return self._iterate()

    def _iterate(self) -> Iterator[tuple]:
        if self._gen is None:
            raise RuntimeError("no input generator configured")
        pool = self._make_pool()
        try:
            yield from pool.run(self._stream(), self._predicts)
        finally:
            close = getattr(self._servers_fn, "close", None)
            if close:
                close()

    def _make_pool(self) -> PredictPool:
        self._servers_fn = self._build_servers_fn()
        if _NOP_PREDICT_TEST:
            factory = lambda ep: NopPredictClient(ep, self._predicts)  # noqa: E731
        else:
            factory = lambda ep: TeacherClient(ep, self._predicts)  # noqa: E731
        feed_idx = [self._ins.index(f) for f in self._feeds]
        return PredictPool(factory, self._servers_fn, self._feeds, feed_idx,
                           teacher_batch_size=self._tbs,
                           max_teachers=self._max_teachers, **self._pool_kw)

    def _build_servers_fn(self):
        if self._servers_fn_override is not None:
            return self._servers_fn_override
        if self._discovery is not None:
            from edl_tpu_torch.distill.discovery import DiscoveryClient
            endpoints, service = self._discovery
            client = DiscoveryClient(endpoints, service,
                                     require_num=self._max_teachers)
            client.start()

            def dynamic() -> list[str]:
                return client.servers()
            dynamic.close = client.stop  # type: ignore[attr-defined]
            return dynamic
        if self._fixed:
            fixed = list(self._fixed)
            return lambda: fixed
        raise RuntimeError("no teachers configured: call set_fixed_teacher / "
                           "set_dynamic_teacher or set EDL_TPU_DISTILL_*")

    def _stream(self) -> Iterator[tuple[int, list[tuple]]]:
        """Normalise the user generator into (batch_id, samples)."""
        gen = self._gen()
        if self._mode == "sample":
            for i, sample in enumerate(gen):
                yield i, [tuple(sample)]
        elif self._mode == "sample_list":
            for i, samples in enumerate(gen):
                yield i, [tuple(s) for s in samples]
        else:  # batch: tuple of stacked arrays → rows
            for i, batch in enumerate(gen):
                n = len(batch[0])
                yield i, [tuple(np.asarray(col)[j] for col in batch)
                          for j in range(n)]
