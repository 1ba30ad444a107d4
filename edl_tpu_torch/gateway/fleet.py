"""Coordination-store surface of the serving fleet (a copy of the JAX
package's ``gateway/fleet.py``, under its key paths, so one fleet can mix
replicas of both packages).

One record per live replica under the ``serving`` table::

    serving/nodes/<replica_id> -> JSON {
        "endpoint": "ip:port",        # the replica's EDL1 RPC server
        "slots": 8, "free_slots": 5,  # engine capacity right now
        "queue_depth": 0,             # engine queue + pending
        "prefill_stall_s": 0.12,      # cumulative admission stall
        "tokens_per_s": 812.3,
        "max_prompt_len": 1023,
        "draining": false,            # graceful removal in progress
        "ts": 1700000000.5,
        # paged engines: "kv_block", "kv_blocks_free", "kv_prefix_hit_rate";
        # speculative ones: "spec_k", "spec_accept_rate"
    }

and one pin per migrated session, ``serving/sessions/<session> ->
{"replica": ...}``.  Both are TTL-leased by the replica process itself, so
an advert dying is the liveness signal; load stats ride the same record,
refreshed every ``EDL_TPU_SERVING_ADVERT_PERIOD``, so the gateway's view is
at most one period stale (its own in-flight counts cover the gap).
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time

from edl_tpu_torch.cluster import paths
from edl_tpu_torch.coord.consistent_hash import ConsistentHash
from edl_tpu_torch.coord.session import CoordSession, leased_register
from edl_tpu_torch.utils import constants

logger = logging.getLogger(__name__)


def _nodes_prefix(job_id: str) -> str:
    return paths.key(job_id, constants.ETCD_SERVING, "nodes/")


def node_key(job_id: str, replica_id: str) -> str:
    return paths.key(job_id, constants.ETCD_SERVING, f"nodes/{replica_id}")


def advertise(store, job_id: str, replica_id: str, payload: dict,
              ttl: float | None = None, session: CoordSession | None = None):
    """TTL-leased replica advert; returns a handle (``update()`` to
    refresh load stats, ``stop()`` to release).  With ``session`` the
    advert rides that shared self-healing lease instead of its own."""
    return leased_register(store, node_key(job_id, replica_id),
                           json.dumps(payload).encode(), ttl=ttl,
                           session=session)


def _sessions_prefix(job_id: str) -> str:
    return paths.key(job_id, constants.ETCD_SERVING, "sessions/")


def session_pin_key(job_id: str, session: str) -> str:
    return paths.key(job_id, constants.ETCD_SERVING, f"sessions/{session}")


def pin_session(store, job_id: str, session: str, replica_id: str,
                ttl: float | None = None, coord_session: CoordSession | None = None):
    """TTL-leased session **pin**: ``serving/sessions/<session> ->
    {replica}``, written by the replica that ADOPTED the session's
    migrated KV chain (ReplicaServer drain handoff).  The gateway
    prefers a pinned replica over the consistent-hash ring owner, so a
    conversation follows its KV instead of re-prefilling wherever the
    ring points after the fleet changed.  Leased by the adopter: the
    pin dies with it and routing falls back to the ring."""
    return leased_register(store, session_pin_key(job_id, session),
                           json.dumps({"replica": replica_id,
                                       "ts": time.time()}).encode(),
                           ttl=ttl, session=coord_session)


def list_session_pins(store, job_id: str) -> dict[str, str]:
    """Live session pins: ``{session: replica_id}``."""
    prefix = _sessions_prefix(job_id)
    recs, _rev = store.get_prefix(prefix)
    out: dict[str, str] = {}
    for rec in recs:
        try:
            out[rec.key[len(prefix):]] = json.loads(
                rec.value.decode())["replica"]
        except (ValueError, KeyError):
            continue  # torn pin: the lease will expire it
    return out


def list_replicas(store, job_id: str) -> dict[str, dict]:
    """Live replica adverts: ``{replica_id: payload}``."""
    prefix = _nodes_prefix(job_id)
    recs, _rev = store.get_prefix(prefix)
    out: dict[str, dict] = {}
    for rec in recs:
        try:
            payload = json.loads(rec.value.decode())
            payload["endpoint"]  # torn advert without an endpoint: skip
        except (ValueError, KeyError):
            continue  # the lease will expire it
        out[rec.key[len(prefix):]] = payload
    return out


class FleetView:
    """Background-refreshed view of the replica fleet.

    The background thread keeps the view current and a consistent-hash
    ring of the live replica ids in step (for session affinity).  By
    default it rides the store's long-poll ``wait()`` on the nodes
    prefix as a **doorbell**: a replica advert appearing or
    expiring wakes the thread immediately, which then runs the same
    :meth:`refresh` read path as ever — pins and ring stay the product
    of one code path, and an idle fleet costs one mostly-idle long
    poll per period instead of waking only to re-read an unchanged
    prefix.  ``EDL_TPU_FLEET_WATCH=0`` (or a store whose ``wait``
    raises ``NotImplementedError``) restores pure periodic polling;
    every wait return — event or timeout — still refreshes, so the
    view is never staler than one period either way.  Readers get
    copy-on-write snapshots — the same single-writer/many-readers
    split as the hash ring itself.  The gateway additionally calls
    :meth:`refresh` inline after a transport failure so a death is
    acted on before the next tick.
    """

    def __init__(self, store, job_id: str, period: float | None = None):
        self._store = store
        self._job_id = job_id
        self._period = constants.gateway_poll_period() if period is None else period
        self._lock = threading.Lock()       # writers only
        self._replicas: dict[str, dict] = {}
        self._pins: dict[str, str] = {}     # session -> adopted replica
        self.ring = ConsistentHash()
        self._halt = threading.Event()
        self._watch = (os.environ.get("EDL_TPU_FLEET_WATCH", "1") != "0"
                       and callable(getattr(store, "wait", None)))
        self._rev = 0                       # watch thread only
        self.refresh()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"fleet:{job_id}")
        self._thread.start()

    def refresh(self) -> dict[str, dict]:
        # the gateway calls this INLINE on a routing failure: on a
        # resilient store, bound the retrying so a coord outage costs
        # the request path a couple of seconds, not the full op budget
        # — the stale view (plus quarantine) already covers the gap
        try:
            with self._store.scoped_deadline(2.0):
                fresh = list_replicas(self._store, self._job_id)
                # pins can only exist while a paged replica (the only
                # possible adopter) is live — an unpaged fleet (the
                # default) must not pay a second prefix read per poll
                pins = (list_session_pins(self._store, self._job_id)
                        if any(p.get("kv_block") for p in fresh.values())
                        else {})
        except Exception as e:  # noqa: BLE001 — store blips must not kill the view
            logger.warning("fleet refresh failed: %s", e)
            return self.replicas()
        with self._lock:
            if set(fresh) != set(self._replicas):
                self.ring.set_nodes(sorted(fresh))
            self._replicas = fresh
            self._pins = pins
        return dict(fresh)

    def replicas(self) -> dict[str, dict]:
        with self._lock:
            return dict(self._replicas)

    def session_pin(self, session: str) -> str | None:
        """The replica that adopted this session's migrated KV chain,
        if any (routing prefers it over the ring owner)."""
        with self._lock:
            return self._pins.get(session)

    def drop(self, replica_id: str) -> None:
        """Remove a replica the caller observed dead (its advert may
        outlive the process by up to the lease TTL); the next refresh
        re-adds it only if the advert is still being kept alive."""
        with self._lock:
            if replica_id in self._replicas:
                del self._replicas[replica_id]
                self.ring.set_nodes(sorted(self._replicas))

    def wait_for(self, n: int, timeout: float) -> bool:
        """Block until at least ``n`` replicas are advertised."""
        deadline = time.monotonic() + timeout
        while len(self.refresh()) < n:
            if time.monotonic() >= deadline:
                return False
            time.sleep(min(0.05, self._period))
        return True

    def _run(self) -> None:
        while not self._halt.is_set():
            if self._watch:
                try:
                    res = self._store.wait(_nodes_prefix(self._job_id),
                                           self._rev, self._period)
                    self._rev = res.revision
                except NotImplementedError:
                    self._watch = False     # permanent poll fallback
                    logger.info("fleet watch unsupported by this store; "
                                "falling back to polling")
                    continue
                except Exception:  # noqa: BLE001 — store blip: poll this round
                    logger.debug("fleet watch wait failed", exc_info=True)
                    if self._halt.wait(min(1.0, self._period)):
                        return
            elif self._halt.wait(self._period):
                return
            self.refresh()
            if self._watch and self._halt.wait(min(0.25, self._period)):
                # debounce: every Register.update() load-stat write
                # rings the doorbell too — coalesce storms to at most
                # a few refreshes per second, still far under a period
                return

    def stop(self) -> None:
        self._halt.set()
        self._thread.join(timeout=5.0)
