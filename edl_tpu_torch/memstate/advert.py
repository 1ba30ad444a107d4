"""The store records of the peer checkpoint cache (a copy of the JAX
package's ``memstate/advert.py``), under the ``memstate`` table:

- ``nodes/<pod_id>`` -> ``{"endpoint": "ip:port"}``: a leased advert of the
  pod's cache service, which dies with its launcher;
- ``committed`` -> ``{"step": N, "ts": ...}``: the newest step whose
  shard-set is sealed in the cache and durable in storage, written by the
  primary trainer only after both.  A cache restore refuses any other step.
"""

from __future__ import annotations

import json
import time

from edl_tpu_torch.cluster import paths
from edl_tpu_torch.coord.session import CoordSession, leased_register
from edl_tpu_torch.utils import constants


def _nodes_prefix(job_id: str) -> str:
    return paths.key(job_id, constants.ETCD_MEMSTATE, "nodes/")


def advertise(store, job_id: str, pod_id: str, endpoint: str, ttl: float | None = None,
              session: CoordSession | None = None):
    """A leased cache advert; returns a handle to ``stop()``.  With
    ``session`` it rides that shared lease."""
    return leased_register(store, paths.key(job_id, constants.ETCD_MEMSTATE, f"nodes/{pod_id}"),
                           json.dumps({"endpoint": endpoint}).encode(),
                           ttl=ttl if ttl is not None else constants.etcd_ttl(),
                           session=session)


def list_adverts(store, job_id: str) -> dict[str, str]:
    """The live cache services: ``{pod_id: endpoint}``."""
    prefix = _nodes_prefix(job_id)
    recs, _rev = store.get_prefix(prefix)
    out: dict[str, str] = {}
    for rec in recs:
        try:
            out[rec.key[len(prefix):]] = json.loads(rec.value.decode())["endpoint"]
        except (ValueError, KeyError):
            continue  # a torn advert: its lease expires it
    return out


def write_committed_step(store, job_id: str, step: int) -> None:
    store.put(paths.key(job_id, constants.ETCD_MEMSTATE, "committed"),
              json.dumps({"step": int(step), "ts": time.time()}).encode())


def read_committed_step(store, job_id: str) -> int | None:
    rec = store.get(paths.key(job_id, constants.ETCD_MEMSTATE, "committed"))
    if rec is None or not rec.value:
        return None
    try:
        return int(json.loads(rec.value.decode())["step"])
    except (ValueError, KeyError):
        return None
