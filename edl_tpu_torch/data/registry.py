"""Reader registry: which pods serve batches for a reader generation (a
copy of the JAX package's ``data/registry.py``).

Every trainer registers its batch cache's endpoint under the generation's
key, leased (``coord/register.py``), and waits until every pod of the
cluster has done the same, so no epoch starts with a partial data plane and
the per-step has-next agreement (``data/elastic_input.py``) can assume that
every process enters the epoch together.
"""

from __future__ import annotations

import json
import logging
import random
import time

from edl_tpu_torch.cluster import paths
from edl_tpu_torch.coord.register import Register
from edl_tpu_torch.utils import constants
from edl_tpu_torch.utils.exceptions import EdlDataError

logger = logging.getLogger(__name__)


def _reader_key(job_id: str, reader: str, pod_id: str) -> str:
    return paths.key(job_id, constants.ETCD_READER, f"{reader}/{pod_id}")


def register_reader(store, job_id: str, reader: str, pod_id: str, endpoint: str,
                    ttl: float | None = None) -> Register:
    """Advertise this pod's data server for ``reader`` (TTL-leased)."""
    meta = json.dumps({"name": reader, "pod_id": pod_id, "endpoint": endpoint}).encode()
    return Register(store, _reader_key(job_id, reader, pod_id), meta, ttl=ttl)


def _scan_readers(store, job_id: str, reader: str) -> tuple[dict[str, str], int]:
    """({pod_id: endpoint}, store revision) for ``reader``'s adverts."""
    recs, rev = store.get_prefix(paths.key(job_id, constants.ETCD_READER, f"{reader}/"))
    out = {}
    for rec in recs:
        meta = json.loads(rec.value.decode())
        out[meta["pod_id"]] = meta["endpoint"]
    return out, rev


def load_readers(store, job_id: str, reader: str) -> dict[str, str]:
    """{pod_id: endpoint} registered for ``reader``."""
    return _scan_readers(store, job_id, reader)[0]


def wait_dist_readers(store, job_id: str, reader: str, pod_ids: list[str],
                      timeout: float = 60.0, period: float = 0.2) -> dict[str, str]:
    """Block until the reader set covers the cluster's pods; returns
    {pod_id: endpoint}.  Raises EdlDataError at ``timeout``: a pod that never
    registers means the data plane cannot serve this epoch.

    Waits on the store's ``wait`` long-poll, so the last registration wakes
    it at once; against a store without watches (or whose watch errors) it
    polls with jittered backoff from ``period``, doubling up to 2 s."""
    want = set(pod_ids)
    prefix = paths.key(job_id, constants.ETCD_READER, f"{reader}/")
    deadline = time.monotonic() + timeout
    delay = period
    watch_ok = True
    while True:
        got, rev = _scan_readers(store, job_id, reader)
        if set(got) >= want:
            return {p: got[p] for p in want}
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            raise EdlDataError(f"reader {reader}: registered {sorted(got)} != cluster "
                               f"{sorted(want)} after {timeout:.0f}s")
        if watch_ok:
            try:
                # returns as soon as anything changes under the prefix (or
                # after the slice); the loop re-reads the whole set
                store.wait(prefix, rev, min(remaining, 2.0))
                delay = period
                continue
            except NotImplementedError:
                watch_ok = False  # the store has no watch: poll from now on
            except Exception as e:  # noqa: BLE001 — a blip: poll this round
                logger.debug("reader-registry watch failed (%s); polling this round", e)
        time.sleep(min(random.uniform(period, delay), remaining))
        delay = min(delay * 2, 2.0)
