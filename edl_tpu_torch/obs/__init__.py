"""Observability: metrics registry + /metrics exposition + structured
JSONL trace + distributed trace context + flight recorder, and the
trainer's step-phase ledger, profiler capture and FLOP accounting.

Copies of the JAX package's ``obs/`` modules that a trainer needs, on the
same metric names, text format, trace keys and env knobs, so the JAX-side
readers (``edl-obs-agg``, ``edl-obs-dump --merge``, the rules) read a port
process as they read a JAX one:

- **Metrics** (:mod:`edl_tpu_torch.obs.metrics`): dependency-free Counter /
  Gauge / Histogram with labels on a process-wide registry, exposed in
  Prometheus text format by :mod:`edl_tpu_torch.obs.exposition`
  (``EDL_TPU_METRICS_PORT``).
- **Trace** (:mod:`edl_tpu_torch.obs.trace`): JSONL events with monotonic
  span durations (``EDL_TPU_TRACE_DIR``, size-capped via
  ``EDL_TPU_TRACE_MAX_MB``).
- **Trace context** (:mod:`edl_tpu_torch.obs.context`): Dapper-style
  (trace_id, span_id, baggage), attached to every emitted event
  (``EDL_TPU_TRACE_CONTEXT`` seeds spawned trainers).
- **Flight recorder** (:mod:`edl_tpu_torch.obs.flightrec`): rings of
  recent events, log records and the last scrape at ``GET /flightrec``.
- **Step ledger and capture** (:mod:`edl_tpu_torch.obs.ledger`,
  :mod:`edl_tpu_torch.obs.profile`): the per-step phase split and
  ``GET /profile`` (``torch.profiler`` on the card).
- **Adverts** (:mod:`edl_tpu_torch.obs.advert`): the /metrics endpoint
  in the coordination store for the JAX aggregator.

Entry points call :func:`install_from_env`; library code never starts
servers or opens files at import time.  ``advert`` is deliberately NOT
imported here: it pulls in the coordination layer, which a run without a
store never loads.
"""

from edl_tpu_torch.obs import context  # noqa: F401
from edl_tpu_torch.obs.context import TraceContext, new_trace  # noqa: F401
from edl_tpu_torch.obs.exposition import (  # noqa: F401
    MetricsServer, installed_server, serve_from_env,
)
from edl_tpu_torch.obs.metrics import (  # noqa: F401
    DEFAULT_BUCKETS, REGISTRY, RESIZE_BUCKETS, Counter, Gauge, Histogram,
    Registry, counter, gauge, histogram, parse_exposition,
)
from edl_tpu_torch.obs.trace import (  # noqa: F401
    NullTracer, Tracer, emit, get_tracer, span,
)
from edl_tpu_torch.obs.trace import configure_from_env as configure_tracer_from_env  # noqa: F401


def install_from_env(component: str = "edl") -> None:
    """Enable the env-gated observability surfaces for this process:
    the /metrics endpoint (``EDL_TPU_METRICS_PORT``), the JSONL
    tracer (``EDL_TPU_TRACE_DIR``), the inherited distributed
    trace context (``EDL_TPU_TRACE_CONTEXT``, stamped by the launcher
    so a trainer's whole process joins its resize epoch's trace), and
    the always-on flight recorder (``GET /flightrec`` —
    :mod:`edl_tpu_torch.obs.flightrec`; ``EDL_TPU_FLIGHTREC=0`` opts out).
    Idempotent, never raises."""
    serve_from_env(component)
    configure_tracer_from_env(component)
    context.install_from_env()
    from edl_tpu_torch.obs import flightrec
    flightrec.install(component)
