"""Per-process black-box flight recorder (a copy of the JAX package's
``obs/flightrec.py``, its log ring on the port's ``edl_tpu_torch`` logger).

An incident's most valuable evidence is the last few seconds *inside*
the processes involved — and that is exactly what today's surfaces
lose: trace files need ``EDL_TPU_TRACE_DIR`` and a shared filesystem,
logs scroll away with the pod, and a /metrics page shows only the
current instant.  The flight recorder is the always-on, bounded answer:
every instrumented process (``obs.install_from_env``) keeps in-memory
rings of

- **recent trace events** (tapped from :mod:`edl_tpu_torch.obs.trace` —
  including processes running a ``NullTracer``, which become ring-only
  tracers),
- **recent log records** (a bounded ``logging.Handler`` on the
  ``edl_tpu_torch`` root logger), and
- **the last-scraped /metrics page** (what the aggregator last saw,
  via :func:`~edl_tpu_torch.obs.exposition.observe_scrapes`; falls back to a
  live registry render when the process was never scraped),

served as JSON at ``GET /flightrec`` on the process's existing metrics
endpoint — no second server, no second advert.  The JAX package's
postmortem bundler (``edl_tpu/obs/bundle.py``) fans out to these routes
when an alert fires and freezes the rings into a durable archive.

Ring capacity is ``EDL_TPU_FLIGHTREC_RING`` events (logs at half
that); eviction is the deque dropping the oldest record, counted in
``edl_flightrec_evicted_total``.  ``EDL_TPU_FLIGHTREC=0`` disables the
recorder entirely.  The hot path is one deque append + one counter
bump per event; nothing here touches the card.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from collections import deque

from edl_tpu_torch.obs import exposition
from edl_tpu_torch.obs import metrics as obs_metrics
from edl_tpu_torch.obs import trace as obs_trace

_RECORDS_TOTAL = obs_metrics.counter(
    "edl_flightrec_records_total",
    "Records captured into the flight-recorder rings, by kind "
    "(event / log)", ("kind",))
_EVICTED_TOTAL = obs_metrics.counter(
    "edl_flightrec_evicted_total",
    "Oldest records evicted from a full flight-recorder ring, by kind",
    ("kind",))

_LOGGER_ROOT = "edl_tpu_torch"
_DEFAULT_RING = 512
_MAX_LOG_CHARS = 512


def _ring_capacity() -> int:
    try:
        return max(16, int(os.environ.get("EDL_TPU_FLIGHTREC_RING",
                                          _DEFAULT_RING)))
    except ValueError:
        return _DEFAULT_RING


class FlightRecorder:
    """The bounded rings + their snapshot; one per process."""

    def __init__(self, component: str = "edl", capacity: int | None = None):
        cap = _ring_capacity() if capacity is None else max(16, int(capacity))
        self.component = component
        self.capacity = cap
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=cap)
        self._logs: deque = deque(maxlen=max(64, cap // 2))
        self._scrape: tuple[float, str] | None = None
        self._started = time.time()
        self.handler: logging.Handler | None = None   # the log ring's, once installed
        # pre-resolved labeled children: the tap runs on every trace
        # event and must stay cheap enough for the <2% overhead gate
        self._ev_total = _RECORDS_TOTAL.labels(kind="event")
        self._ev_evicted = _EVICTED_TOTAL.labels(kind="event")
        self._log_total = _RECORDS_TOTAL.labels(kind="log")
        self._log_evicted = _EVICTED_TOTAL.labels(kind="log")

    # -- capture (hot paths) -------------------------------------------------
    def record_event(self, rec: dict) -> None:
        """Trace tap: one fully-built event record."""
        with self._lock:
            if len(self._events) == self._events.maxlen:
                self._ev_evicted.inc()
            self._events.append(rec)
        self._ev_total.inc()

    def record_log(self, record: logging.LogRecord) -> None:
        try:
            msg = record.getMessage()
        except Exception:  # noqa: BLE001 — a bad format must not kill logging
            msg = str(record.msg)
        rec = {"ts": round(record.created, 6), "level": record.levelname,
               "logger": record.name, "msg": msg[:_MAX_LOG_CHARS],
               "src": f"{record.filename}:{record.lineno}"}
        with self._lock:
            if len(self._logs) == self._logs.maxlen:
                self._log_evicted.inc()
            self._logs.append(rec)
        self._log_total.inc()

    def note_scrape(self, text: str) -> None:
        with self._lock:
            self._scrape = (time.time(), text)

    # -- snapshot (the GET /flightrec body) ----------------------------------
    def snapshot(self, limit: int | None = None) -> dict:
        with self._lock:
            events = list(self._events)
            logs = list(self._logs)
            scrape = self._scrape
        if limit is not None and limit > 0:
            events = events[-limit:]
            logs = logs[-limit:]
        if scrape is None:
            # never scraped: a live render is fresher than nothing
            scrape = (time.time(), obs_metrics.REGISTRY.render())
            source = "live"
        else:
            source = "scrape"
        return {"component": self.component, "pid": os.getpid(),
                "ts": time.time(), "started": self._started,
                "capacity": self.capacity,
                "events": events, "logs": logs,
                "metrics": {"ts": scrape[0], "source": source,
                            "text": scrape[1]}}

    def route(self, query: dict) -> dict:
        limit = int(exposition.query_float(query, "n", 0.0)) or None
        return self.snapshot(limit=limit)


class _RingHandler(logging.Handler):
    """Feeds the ``edl_tpu_torch`` root logger into the recorder's log ring;
    never raises, never formats beyond ``getMessage()``."""

    def __init__(self, recorder: FlightRecorder):
        super().__init__(level=logging.INFO)
        self._recorder = recorder

    def emit(self, record: logging.LogRecord) -> None:
        try:
            self._recorder.record_log(record)
        # a logging handler must never
        # raise or log (either recurses straight back into itself)
        except Exception:  # noqa: BLE001 — logging must never raise
            pass


_install_lock = threading.Lock()
_recorder: FlightRecorder | None = None


def installed() -> FlightRecorder | None:
    return _recorder


def install(component: str = "edl") -> FlightRecorder | None:
    """Start this process's flight recorder (idempotent; never raises;
    ``EDL_TPU_FLIGHTREC=0`` disables): tap the tracer, hook the root
    logger, observe served scrapes, and mount ``GET /flightrec`` on the
    process's metrics endpoint."""
    global _recorder
    if os.environ.get("EDL_TPU_FLIGHTREC", "1") == "0":
        return None
    with _install_lock:
        if _recorder is not None:
            return _recorder
        try:
            rec = FlightRecorder(component)
            obs_trace.add_tap(rec.record_event)
            rec.handler = _RingHandler(rec)
            logging.getLogger(_LOGGER_ROOT).addHandler(rec.handler)
            exposition.observe_scrapes(rec.note_scrape)
            exposition.register_route("/flightrec", rec.route)
            _recorder = rec
        except Exception:  # noqa: BLE001 — observability must never fail a job
            logging.getLogger(_LOGGER_ROOT).exception(
                "flight recorder install failed")
            return None
    return _recorder


def uninstall() -> None:
    """Stop this process's flight recorder: untap the tracer, unhook the
    logger, stop observing scrapes and unmount ``/flightrec`` (a harness
    comparing a run with observability on and off; idempotent)."""
    global _recorder
    with _install_lock:
        rec, _recorder = _recorder, None
    if rec is None:
        return
    obs_trace.remove_tap(rec.record_event)
    logging.getLogger(_LOGGER_ROOT).removeHandler(rec.handler)
    exposition.unobserve_scrapes(rec.note_scrape)
    exposition.unregister_route("/flightrec")
