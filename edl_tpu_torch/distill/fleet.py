"""Teacher fleets as elastic serving jobs (a copy of the JAX package's
``distill/fleet.py`` on the port's gateway fleet view and coordination
session, its adverts and key paths unchanged, so a fleet can mix teachers
of both packages and either package's students can read it).

- :class:`TeacherReplica`, the fleet member: a
  :class:`~edl_tpu_torch.distill.teacher.TeacherServer` advertised twice on
  one shared :class:`~edl_tpu_torch.coord.session.CoordSession` (one lease
  a process): a replica advert in the teacher job's ``serving`` table,
  whose payload carries ``service_class="distill"``, and the balance-table
  registration students rebalance over.  A refresh loop republishes the
  live ``stats()`` (rows/s, queue depth) into both every
  ``EDL_TPU_DISTILL_ADVERT_PERIOD``.
- :class:`DistillFleet`, the student or router side: the gateway's
  :class:`~edl_tpu_torch.gateway.fleet.FleetView` over the teacher job's
  serving table, filtered to the distill class: least-loaded routing with
  quarantine after a transport failure, an ``endpoints_fn()`` for
  ``DistillReader.set_servers_fn`` (the predict pool's requeue on a
  teacher's death then rides the fleet view: a death costs a retry, not a
  batch), and a routed :meth:`~DistillFleet.predict` with failover and
  latency hedging.

``service_class`` is read here only: the gateway routes by job id and does
not filter on it, in both packages, so teachers and LM replicas stay apart
by living in different jobs.  The JAX module's metrics are not ported
(ROADMAP.md Queue 1 item 8): the fleet keeps counts (``DistillFleet.counts``).
"""

from __future__ import annotations

import json
import logging
import threading
import time

from edl_tpu_torch.coord.session import CoordSession
from edl_tpu_torch.gateway import fleet as gw_fleet
from edl_tpu_torch.utils import constants

logger = logging.getLogger(__name__)

#: the service-class tag a distill teacher's advert carries in the serving
#: table; DistillFleet routes only to adverts that carry it
DISTILL_SERVICE_CLASS = "distill"

# engine stats a paged LM teacher's server surfaces, copied onto its advert
_ENGINE_STATS = ("engine_kv_prefix_hits", "engine_kv_prefix_misses",
                 "engine_kv_prefill_tokens_skipped", "engine_tokens_per_s")


class TeacherReplica:
    """One fleet member: a TeacherServer advertised as a serving replica
    and registered in the balance table, on one shared lease.

    ``replica_id`` is the serving-table node key; the balance key stays the
    endpoint (the table's contract).  ``stop()`` drops both adverts, then
    the server, then the session."""

    def __init__(self, store, job_id: str, server, service: str,
                 replica_id: str | None = None, ttl: float | None = None,
                 advert_period: float | None = None, slots: int | None = None):
        self.job_id = job_id
        self.server = server
        self.service = service
        self.replica_id = replica_id or f"teacher-{server.endpoint}"
        self._slots = int(slots) if slots else len(getattr(server, "_buckets", ())) or 8
        self._coord_session = CoordSession(store, ttl=ttl, name=f"teacher:{server.endpoint}")
        # the balance-table advert (students rebalance over it), on the same
        # session, so one keep-alive covers both
        server.register(store, service, ttl=ttl, session=self._coord_session,
                        advert_period=advert_period)
        # the serving-table replica advert (a controller counts these)
        self._register = gw_fleet.advertise(store, job_id, self.replica_id, self._payload(),
                                            ttl=ttl, session=self._coord_session)
        period = (constants.distill_advert_period() if advert_period is None
                  else float(advert_period))
        self._halt = threading.Event()
        self._thread = threading.Thread(target=self._refresh_loop, args=(period,), daemon=True,
                                        name=f"teacher-replica:{server.endpoint}")
        self._thread.start()
        logger.info("teacher replica %s advertised in job %s (service %s)",
                    self.replica_id, job_id, service)

    def _payload(self) -> dict:
        stats = self.server.stats()
        depth = int(stats.get("queue_depth", 0))
        payload = {"endpoint": self.server.endpoint,
                   "service": self.service,
                   "service_class": DISTILL_SERVICE_CLASS,
                   "slots": self._slots,
                   "free_slots": max(0, self._slots - depth),
                   "queue_depth": depth,
                   "rows_per_s": float(stats.get("rows_per_s", 0.0)),
                   "rows": int(stats.get("rows", 0)),
                   "draining": False,
                   "ts": time.time()}
        # an LM teacher's paged engine: its cache warmth rides the advert
        payload.update({k: stats[k] for k in _ENGINE_STATS if k in stats})
        return payload

    def _refresh_loop(self, period: float) -> None:
        while not self._halt.wait(period):
            if self._register.is_stopped:
                continue
            try:
                self._register.update(json.dumps(self._payload()).encode())
            except Exception as e:  # noqa: BLE001 — the session heals
                logger.warning("teacher replica advert refresh failed: %s", e)

    def stop(self) -> None:
        self._halt.set()
        self._thread.join(timeout=2.0)
        try:
            self._register.stop()
        except Exception as e:  # noqa: BLE001 — the lease expires it
            logger.debug("replica advert stop failed (%s); the lease expires it", e)
        self.server.stop()              # drops the balance advert too
        self._coord_session.close()


class DistillFleet:
    """The student side's routed view of a teacher fleet, on the gateway's
    FleetView.  ``service=None`` takes every distill-class teacher of the
    job; a name keeps that service's.  ``counts``: ``teachers`` (live, at
    the last look), ``retries`` (routed predicts retried on another
    teacher) and ``hedges`` (hedge requests fired)."""

    def __init__(self, store, job_id: str, service: str | None = None,
                 period: float | None = None, quarantine_s: float | None = None):
        self.job_id = job_id
        self.service = service
        self._view = gw_fleet.FleetView(store, job_id, period=period)
        self._quarantine_s = (constants.gateway_quarantine() if quarantine_s is None
                              else quarantine_s)
        self._lock = threading.Lock()
        self._quarantined: dict[str, float] = {}   # endpoint -> until
        self._inflight: dict[str, int] = {}        # endpoint -> count
        self.counts = {"teachers": 0, "retries": 0, "hedges": 0}

    # -- membership ----------------------------------------------------------
    def teachers(self) -> dict[str, dict]:
        """Live distill-class adverts ``{replica_id: payload}``, draining and
        quarantined ones left out."""
        now = time.monotonic()
        with self._lock:
            for ep in [ep for ep, until in self._quarantined.items() if until <= now]:
                del self._quarantined[ep]
            quarantined = set(self._quarantined)
        out = {}
        for rid, payload in self._view.replicas().items():
            if payload.get("service_class") != DISTILL_SERVICE_CLASS:
                continue
            if self.service and payload.get("service") != self.service:
                continue
            if payload.get("draining") or payload["endpoint"] in quarantined:
                continue
            out[rid] = payload
        self.counts["teachers"] = len(out)
        return out

    def endpoints(self) -> list[str]:
        return sorted(p["endpoint"] for p in self.teachers().values())

    def endpoints_fn(self):
        """A ``DistillReader.set_servers_fn`` plug: the reader's predict pool
        adds and removes teacher workers as this view tracks the adverts;
        its ``close`` stops the view."""
        def servers() -> list[str]:
            return self.endpoints()
        servers.close = self.stop  # type: ignore[attr-defined]
        return servers

    def wait_for(self, n: int, timeout: float) -> bool:
        deadline = time.monotonic() + timeout
        while len(self.teachers()) < n:
            if time.monotonic() >= deadline:
                return False
            self._view.refresh()
            time.sleep(0.05)
        return True

    # -- routing -------------------------------------------------------------
    def pick(self) -> str | None:
        """The least-loaded endpoint: the advertised queue depth plus this
        object's own in-flight calls (the advert may be a period stale)."""
        teachers = self.teachers()
        if not teachers:
            return None
        with self._lock:
            return min(teachers.values(),
                       key=lambda p: (int(p.get("queue_depth", 0))
                                      + self._inflight.get(p["endpoint"], 0),
                                      p["endpoint"]))["endpoint"]

    def drop(self, endpoint: str) -> None:
        """Quarantine an endpoint observed dead and drop its advert from the
        view (the advert may outlive the process by a TTL); the view is
        read again at once."""
        with self._lock:
            self._quarantined[endpoint] = time.monotonic() + self._quarantine_s
        for rid, payload in self._view.replicas().items():
            if payload.get("endpoint") == endpoint:
                self._view.drop(rid)
        self._view.refresh()

    def predict(self, feed: dict, fetch: list[str], retries: int = 2,
                hedge_after_s: float | None = None, client_factory=None) -> dict:
        """One routed teacher call: a transport failure quarantines the
        teacher and retries on the next least-loaded one (``retries``
        count).  ``hedge_after_s`` arms a latency hedge: if the first
        teacher has not answered by then, the same rows race on a second
        and the first answer wins (``hedges`` count)."""
        from edl_tpu_torch.distill.predict_client import TeacherClient

        factory = client_factory or (lambda ep: TeacherClient(ep, fetch))
        last: Exception | None = None
        tried: set[str] = set()
        for _attempt in range(max(1, retries + 1)):
            ep = self._pick_excluding(tried)
            if ep is None:
                break
            tried.add(ep)
            try:
                if hedge_after_s is not None:
                    return self._hedged(ep, feed, hedge_after_s, factory, tried)
                return self._one(ep, feed, factory)
            except Exception as e:  # noqa: BLE001 — route around the death
                last = e
                logger.warning("routed predict on %s failed: %s", ep, e)
                self.drop(ep)
                self.counts["retries"] += 1
        raise ConnectionError(f"no distill teacher answered for job {self.job_id}: {last}")

    def _pick_excluding(self, tried: set[str]) -> str | None:
        for p in sorted(self.teachers().values(),
                        key=lambda p: (int(p.get("queue_depth", 0)), p["endpoint"])):
            if p["endpoint"] not in tried:
                return p["endpoint"]
        return None

    def _one(self, ep: str, feed: dict, factory) -> dict:
        with self._lock:
            self._inflight[ep] = self._inflight.get(ep, 0) + 1
        client = factory(ep)
        try:
            return client.predict(feed)
        finally:
            with self._lock:
                self._inflight[ep] = max(0, self._inflight.get(ep, 1) - 1)
            close = getattr(client, "close", None)
            if close:
                close()

    def _hedged(self, primary: str, feed: dict, delay: float, factory,
                tried: set[str]) -> dict:
        """The primary and, after ``delay``, one backup; the first answer
        wins and the other is dropped (a teacher's predict is pure)."""
        result: dict = {}
        done = threading.Event()
        errors: list[Exception] = []

        def run(ep: str) -> None:
            try:
                out = self._one(ep, feed, factory)
                with self._lock:
                    if not result:
                        result.update(out)
                done.set()
            except Exception as e:  # noqa: BLE001 — the race absorbs one loss
                errors.append(e)

        threads = [threading.Thread(target=run, args=(primary,), daemon=True)]
        threads[0].start()
        if not done.wait(delay):
            backup = self._pick_excluding(tried | {primary})
            if backup is not None:
                tried.add(backup)
                self.counts["hedges"] += 1
                threads.append(threading.Thread(target=run, args=(backup,), daemon=True))
                threads[-1].start()
        # the first success wins; both legs failing ends the wait too
        while not done.is_set() and any(t.is_alive() for t in threads):
            done.wait(0.05)
        if result:
            return dict(result)
        raise errors[0] if errors else ConnectionError("the hedge lost both legs")

    def stop(self) -> None:
        self._view.stop()
