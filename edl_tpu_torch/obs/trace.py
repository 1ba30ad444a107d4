"""Structured JSONL event trace with monotonic spans (a copy of the JAX
package's ``obs/trace.py``: the same keys, so ``python -m edl_tpu.obs.dump
--merge`` reads a port process's file).

One line per event::

    {"ts": 1700000000.123456, "name": "resize/kill_to_barrier",
     "component": "launcher", "dur": 0.512, ...}

``ts`` is wall-clock (joinable across hosts via NTP-class skew) and is
the *begin* of the span for events that carry ``dur``; ``dur`` is
measured with the *monotonic* clock, so spans are immune to wall-clock
steps.  MLPerf-style training logs and Chrome trace events use the same
shape: flat JSON records keyed by a hierarchical name.

When a distributed :mod:`~edl_tpu_torch.obs.context` is ambient, every event
additionally carries ``trace_id`` / ``span_id`` (and ``parent_id``), so
``edl-obs-dump --merge`` can join per-process files into one causal
timeline; with no ambient context, events are exactly as before.

Library code calls :func:`get_tracer` and emits unconditionally — the
default is a :class:`NullTracer`, so a job that never opted in pays a
no-op call.  CLI entry points opt in via
:func:`configure_from_env` (``EDL_TPU_TRACE_DIR``), the same pattern
as ``utils.logger.configure``; the per-process file name carries the
component and pid so every process of a job can share one directory.

``EDL_TPU_TRACE_MAX_MB`` caps the file: on overflow the file rotates to
``<path>.1`` (one rotated generation kept), so a long-running job can
never fill the disk with trace events.  Rotations and any events
dropped on write/rotation failure are counted in
``edl_trace_rotations_total`` / ``edl_trace_dropped_events_total``.
"""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager

from edl_tpu_torch.obs import context as obs_context
from edl_tpu_torch.obs import metrics as obs_metrics

_DROPPED_TOTAL = obs_metrics.counter(
    "edl_trace_dropped_events_total",
    "Trace events dropped, by reason (write failure, failed rotation)",
    ("reason",))
_ROTATIONS_TOTAL = obs_metrics.counter(
    "edl_trace_rotations_total",
    "Trace file rotations forced by EDL_TPU_TRACE_MAX_MB")

# in-process observers of every emitted trace event (the flight
# recorder's ring — obs/flightrec.py).  Taps see the fully-built record
# dict (context ids stamped) and run OUTSIDE any tracer file lock; a
# tap that raises is dropped from the event, never from the process.
# With taps installed, even a NullTracer process (no EDL_TPU_TRACE_DIR)
# builds and delivers records — the flight recorder must capture the
# last seconds before a crash whether or not durable tracing is on.
_TAPS: list = []


def add_tap(fn) -> None:
    """Register ``fn(rec: dict)`` to observe every emitted event."""
    if fn not in _TAPS:
        _TAPS.append(fn)


def remove_tap(fn) -> None:
    try:
        _TAPS.remove(fn)
    except ValueError:
        pass


def _run_taps(rec: dict) -> None:
    for fn in list(_TAPS):
        try:
            fn(rec)
        # taps run inside every emit on the hot path; logging a broken tap per event would flood the
        # very log the flight recorder is also hooked into
        except Exception:  # noqa: BLE001 — a bad tap must not stop tracing
            pass


def _build_record(name: str, component: str, dur: float | None,
                  at: float | None, fields: dict) -> dict:
    rec: dict = {"ts": round(time.time() if at is None else at, 6),
                 "name": name}
    if component:
        rec["component"] = component
    if dur is not None:
        rec["dur"] = round(float(dur), 6)
    rec.update(fields)
    ctx = obs_context.current()
    if ctx is not None:
        # setdefault: an event may legitimately pin its own ids
        # (e.g. re-emitting another process's record)
        rec.setdefault("trace_id", ctx.trace_id)
        rec.setdefault("span_id", ctx.span_id)
        if ctx.parent_id is not None:
            rec.setdefault("parent_id", ctx.parent_id)
    return rec


class NullTracer:
    """Disabled tracer: every operation is a no-op (when no tap is
    installed; with taps, records are built and delivered to them —
    ring-only tracing)."""

    enabled = False

    def emit(self, name: str, *, dur: float | None = None,
             at: float | None = None, **fields) -> None:
        if _TAPS:
            _run_taps(_build_record(name, "", dur, at, fields))

    @contextmanager
    def span(self, name: str, **fields):
        if not _TAPS:
            yield
            return
        t_wall = time.time()
        t0 = time.monotonic()
        try:
            yield
        finally:
            self.emit(name, dur=time.monotonic() - t0, at=t_wall, **fields)

    def close(self) -> None:
        pass


def _max_bytes_from_env() -> int:
    try:
        return int(float(os.environ.get("EDL_TPU_TRACE_MAX_MB", "0"))
                   * (1 << 20))
    except ValueError:
        return 0


class Tracer:
    """Append-only JSONL writer; thread-safe, flushed per event (events
    are rare — phase boundaries, not per-step — so durability beats
    buffering: the interesting lines are the ones just before a kill)."""

    enabled = True

    def __init__(self, path: str, component: str = "",
                 max_bytes: int | None = None):
        self.path = path
        self.component = component
        # 0 = unlimited; None = read EDL_TPU_TRACE_MAX_MB
        self.max_bytes = (_max_bytes_from_env() if max_bytes is None
                          else int(max_bytes))
        self._lock = threading.Lock()
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(path, "a", encoding="utf-8")
        try:
            self._bytes = self._f.tell()
        except OSError:
            self._bytes = 0

    def emit(self, name: str, *, dur: float | None = None,
             at: float | None = None, **fields) -> None:
        rec = _build_record(name, self.component, dur, at, fields)
        if _TAPS:
            _run_taps(rec)
        line = json.dumps(rec) + "\n"
        # the tracer's file lock: serializing the JSONL append is its whole purpose, and
        # nothing but emit()/rotate contends on it
        with self._lock:
            if self._f is None:
                _DROPPED_TOTAL.labels(reason="rotate").inc()
                return
            if (self.max_bytes
                    and self._bytes + len(line) > self.max_bytes
                    and not self._rotate_locked()):
                _DROPPED_TOTAL.labels(reason="rotate").inc()
                return
            try:
                self._f.write(line)
                self._f.flush()
                self._bytes += len(line)
            except (OSError, ValueError):  # closed/full disk: best-effort
                _DROPPED_TOTAL.labels(reason="write").inc()

    def _rotate_locked(self) -> bool:
        """Roll the file to ``<path>.1`` (previous generation replaced)
        and start fresh; on failure fall back to the existing file so
        one bad rename doesn't end tracing for the process."""
        try:
            self._f.close()
        except OSError:
            pass
        try:
            os.replace(self.path, self.path + ".1")
            self._f = open(self.path, "a", encoding="utf-8")
            self._bytes = 0
            _ROTATIONS_TOTAL.inc()
            return True
        except OSError:
            try:
                self._f = open(self.path, "a", encoding="utf-8")
                self._bytes = self._f.tell()
            except OSError:
                self._f = None  # give up; emit() counts the drops
            return False

    @contextmanager
    def span(self, name: str, **fields):
        """Emit ``name`` with its monotonic duration when the block exits
        (exceptions included — the span's end is the interesting part of
        a failing phase).  ``ts`` is the span's BEGIN wall-clock time,
        matching the recovery-derived phase events, so merged timelines
        order by start.  Inside the block, a child trace context is
        ambient (when any context is), so nested spans and outbound RPCs
        link to this span as their parent."""
        parent = obs_context.current()
        child = parent.child() if parent is not None else None
        token = obs_context.attach(child) if child is not None else None
        t_wall = time.time()
        t0 = time.monotonic()
        try:
            yield
        finally:
            dur = time.monotonic() - t0
            try:
                self.emit(name, dur=dur, at=t_wall, **fields)
            finally:
                if token is not None:
                    obs_context.detach(token)

    def close(self) -> None:
        with self._lock:
            try:
                if self._f is not None:
                    self._f.close()
            except OSError:
                pass


_lock = threading.Lock()
_tracer: NullTracer | Tracer = NullTracer()


def get_tracer() -> NullTracer | Tracer:
    return _tracer


def install(tracer: NullTracer | Tracer) -> NullTracer | Tracer:
    """Swap the process-wide tracer, returning the previous one (the
    bench's tracing-on/off comparison and tests save/restore with this
    instead of poking the module global)."""
    global _tracer
    with _lock:
        prev = _tracer
        _tracer = tracer
        return prev


def configure(path: str, component: str = "") -> Tracer:
    """Install a process-wide tracer writing to ``path``."""
    global _tracer
    # once-only install gate: opening the trace file under it is the point
    with _lock:
        if isinstance(_tracer, Tracer):
            _tracer.close()
        _tracer = Tracer(path, component)
        return _tracer


def configure_from_env(component: str = "") -> Tracer | None:
    """``EDL_TPU_TRACE_DIR`` set → trace to
    ``<dir>/trace-<component>-<pid>.jsonl``; unset → leave the
    NullTracer in place.  Idempotent per process."""
    d = os.environ.get("EDL_TPU_TRACE_DIR")
    if not d:
        return None
    with _lock:
        if isinstance(_tracer, Tracer):
            return _tracer
    path = os.path.join(d, f"trace-{component or 'proc'}-{os.getpid()}.jsonl")
    return configure(path, component)


def emit(name: str, **kw) -> None:
    _tracer.emit(name, **kw)


def span(name: str, **fields):
    return _tracer.span(name, **fields)
