"""Coordination-store adverts for per-process /metrics endpoints (the
JAX package's ``obs/advert.py`` without its target watcher, which serves
the JAX-side aggregator): a TTL-leased advert under the ``obs`` table, so
the job-level aggregator (``edl_tpu/obs/agg.py``) discovers a port
process's endpoint with one prefix read, and a dead process's advert
expires with its lease::

    obs/metrics/<component>-<pid> -> JSON {
        "endpoint": "ip:port",   # the process's MetricsServer
        "component": "trainer",
        "pid": 4242,
        "ts": 1700000000.5,
    }

The payloads and keys are the JAX package's.  This module reaches the
coordination layer, so the trainer imports it only when it has a store.
"""

from __future__ import annotations

import json
import logging
import os
import time

from edl_tpu_torch.cluster import paths
from edl_tpu_torch.coord.register import Register
from edl_tpu_torch.coord.session import CoordSession, SessionKey, leased_register
from edl_tpu_torch.utils import constants

logger = logging.getLogger(__name__)


def _prefix(job_id: str) -> str:
    return paths.key(job_id, constants.ETCD_OBS, "metrics/")


def advertise_metrics(store, job_id: str, component: str, endpoint: str,
                      name: str | None = None, ttl: float | None = None,
                      session: CoordSession | None = None,
                      extra: dict | None = None):
    """TTL-leased /metrics advert (``ttl`` default ``EDL_TPU_TTL``);
    returns a handle to ``stop()``.  With ``session`` the advert rides that
    shared lease.  ``extra`` fields ride the payload (trainers publish
    ``{"pod": <pod_id>}``)."""
    name = name or f"{component}-{os.getpid()}"
    payload = {"endpoint": endpoint, "component": component,
               "pid": os.getpid(), "ts": time.time()}
    if extra:
        payload.update(extra)
    return leased_register(
        store, paths.key(job_id, constants.ETCD_OBS, f"metrics/{name}"),
        json.dumps(payload).encode(), ttl=constants.etcd_ttl() if ttl is None else ttl,
        session=session)


def _decode_advert(value: bytes) -> dict | None:
    """Advert payload, or None for a torn advert (the lease expires it)."""
    try:
        payload = json.loads(value.decode())
        payload["endpoint"]
    except (ValueError, KeyError, TypeError, AttributeError):
        return None
    return payload


def list_metrics_targets(store, job_id: str) -> dict[str, dict]:
    """Live /metrics endpoints: ``{advert_name: payload}``."""
    prefix = _prefix(job_id)
    recs, _rev = store.get_prefix(prefix)
    out: dict[str, dict] = {}
    for rec in recs:
        payload = _decode_advert(rec.value)
        if payload is not None:
            out[rec.key[len(prefix):]] = payload
    return out


def publish_job_trace(store, job_id: str, ctx, stage: str | None = None) -> None:
    """Publish the job's current generation trace context, so store
    readers can link what they observe now to that generation's spans.
    Best-effort, never raises."""
    try:
        payload = {"trace_id": ctx.trace_id, "ts": time.time()}
        if stage is not None:
            payload["stage"] = stage
        store.put(paths.key(job_id, constants.ETCD_OBS, "trace/current"),
                  json.dumps(payload).encode())
    except Exception:  # noqa: BLE001 — metrics must never fail a job
        logger.exception("job trace publish failed for %s", job_id)


def current_job_trace(store, job_id: str) -> dict | None:
    """The last published generation trace record
    (``{"trace_id", "ts"[, "stage"]}``), or None."""
    rec = store.get(paths.key(job_id, constants.ETCD_OBS, "trace/current"))
    if rec is None:
        return None
    try:
        payload = json.loads(rec.value.decode())
        payload["trace_id"]
    except (ValueError, KeyError, TypeError, AttributeError):
        return None
    return payload


def advertise_installed(store, job_id: str, component: str, ttl: float | None = None,
                        session: CoordSession | None = None, extra: dict | None = None,
                        ) -> Register | SessionKey | None:
    """Advertise this process's env-gated /metrics endpoint (if one is
    serving) in the coordination store.  Best-effort, never raises."""
    from edl_tpu_torch.obs import exposition

    srv = exposition.installed_server()
    if srv is None:
        return None
    try:
        return advertise_metrics(store, job_id, component, srv.endpoint,
                                 ttl=ttl, session=session, extra=extra)
    except Exception:  # noqa: BLE001 — metrics must never fail a job
        logger.exception("metrics advert failed for %s", component)
        return None
