"""Env-gated distill timeline profiler (a copy of the JAX package's
``distill/timeline.py``).

Reference: python/edl/distill/timeline.py:21-47 — when
``DISTILL_READER_PROFILE=1`` a ``_RealTimeLine`` writes per-op
millisecond records to stderr; otherwise a ``_NopTimeLine`` costs
nothing.  Here the switch is ``EDL_TPU_DISTILL_PROFILE=1`` and spans
wrap the predict-pool hot ops (queue get/put, teacher predict,
reorder), each line::

    [timeline] op=<name> pid=<pid> tid=<tid> ms=<elapsed> <extra k=v ...>
"""

from __future__ import annotations

import os
import sys
import threading
import time
from contextlib import contextmanager, nullcontext

_NULL_SPAN = nullcontext()


class _NopTimeline:
    enabled = False

    def record(self, op: str, ms: float, **extra) -> None:
        pass

    def span(self, op: str, **extra):
        # shared nullcontext: the disabled path must not allocate per call
        # (it sits in the predict-pool hot loop)
        return _NULL_SPAN


class _RealTimeline:
    enabled = True

    def record(self, op: str, ms: float, **extra) -> None:
        fields = " ".join(f"{k}={v}" for k, v in extra.items())
        sys.stderr.write(
            f"[timeline] op={op} pid={os.getpid()} "
            f"tid={threading.get_ident()} ms={ms:.3f}"
            + (f" {fields}" if fields else "") + "\n")

    @contextmanager
    def span(self, op: str, **extra):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(op, (time.perf_counter() - t0) * 1e3, **extra)


def timeline():
    """Singleton selected once per process from the environment."""
    global _instance
    if _instance is None:
        _instance = (_RealTimeline()
                     if os.environ.get("EDL_TPU_DISTILL_PROFILE") == "1"
                     else _NopTimeline())
    return _instance


_instance: _NopTimeline | _RealTimeline | None = None
