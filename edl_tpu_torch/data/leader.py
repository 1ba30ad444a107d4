"""Standalone elected data-service leader (a copy of the JAX package's
``data/leader.py``, under its seat key, so candidates of both packages
contend for one seat and readers of both resolve it).

Under the elastic launcher the :class:`DataService` rides every pod's
launcher server and trainers address the cluster leader's.  This module
hosts the same service behind its own **exclusive coordination-store
seat**, ``<job>/rank/data_leader``, elected like the cluster leader (a
lease-guarded put-if-absent, failover at the TTL), for deployments whose
data plane outlives any one trainer world:

- the seat's value is the winner's RPC endpoint, so election and discovery
  are one record: readers resolve the leader with
  :func:`resolve_data_leader` (their resilient client asks again after
  every failure, which is the whole failover);
- the winner's service carries the coordination-store **journal**
  (``data/journal.py``), so a successor seizing the seat rebuilds every
  live generation minus consumed spans and readers reattach without
  restarting the epoch;
- the winner watches the reader **registry**: a pod whose leased advert
  expires is marked dead, and its files and unconsumed batches requeue
  minus the consumed union; at the start of a term the journaled
  generations are reconciled against the adverts as they are then.

``python -m edl_tpu_torch.data.leader --coord_endpoints ... --job_id ...``
runs a candidate: it contends, serves while it holds the seat, and goes
back to contending if the seat is lost.
"""

from __future__ import annotations

import argparse
import functools
import logging
import threading

from edl_tpu_torch.cluster import paths
from edl_tpu_torch.coord.session import CoordSession
from edl_tpu_torch.data.data_server import DataService
from edl_tpu_torch.data.journal import DataJournal
from edl_tpu_torch.rpc.server import RpcServer
from edl_tpu_torch.utils import constants
from edl_tpu_torch.utils.exceptions import EdlCoordError, EdlRegisterError, EdlRetryableError
from edl_tpu_torch.utils.network import local_ip

logger = logging.getLogger(__name__)

_SEAT = "data_leader"


def _seat_key(job_id: str) -> str:
    return paths.key(job_id, constants.ETCD_POD_RANK, _SEAT)


def resolve_data_leader(store, job_id: str) -> str:
    """The current data leader's endpoint (the seat's value); raises
    :class:`EdlCoordError` while no leader holds the seat, so a resilient
    caller retries through the failover window."""
    rec = store.get(_seat_key(job_id))
    if rec is None or not rec.value:
        raise EdlCoordError(f"no data leader seated for job {job_id}")
    return rec.value.decode()


class _Gate:
    """A term's fence around its service.  ``wrap(fn)`` runs ``fn`` unless
    the gate is shut (then it raises :class:`EdlCoordError`, which a
    resilient client retries against the resolved leader); ``shut()``
    refuses every later op and waits for those in flight, so no journal
    write of a term lands after its seat is freed and a successor has
    rebuilt from the journal."""

    def __init__(self):
        self._cv = threading.Condition()
        self._inflight = 0
        self._shut = False

    def wrap(self, fn):
        @functools.wraps(fn)
        def gated(*args, **kwargs):
            with self._cv:
                if self._shut:
                    raise EdlCoordError("data leader standing down")
                self._inflight += 1
            try:
                return fn(*args, **kwargs)
            finally:
                with self._cv:
                    self._inflight -= 1
                    self._cv.notify_all()
        return gated

    def shut(self, timeout: float) -> bool:
        """Refuse new ops; True once none is in flight, False at ``timeout``."""
        with self._cv:
            self._shut = True
            return self._cv.wait_for(lambda: self._inflight == 0, timeout)


class DataLeaderHost:
    """One election candidate.  ``run()`` loops: contend for the seat, serve
    the journaled DataService while it is held, stand down on its loss.
    ``service`` and ``endpoint`` are set while seated."""

    def __init__(self, store, job_id: str, host: str | None = None, port: int = 0,
                 ttl: float | None = None, rebuild_grace: float | None = None,
                 retry_period: float = 0.5):
        self._store = store
        self._job_id = job_id
        self._host = host
        self._port = port
        self._ttl = constants.etcd_ttl() if ttl is None else ttl
        self._grace = rebuild_grace
        self._retry_period = retry_period
        self._halt = threading.Event()
        self._journal: DataJournal | None = None
        self._gate: _Gate | None = None
        self.service: DataService | None = None
        self.endpoint: str | None = None

    def stop(self) -> None:
        self._halt.set()

    # -- one leadership term -------------------------------------------------
    def _on_registry_events(self, prefix: str, events) -> None:
        """A reader advert expiring (``<reader>/<pod_id>``): the pod died or
        was partitioned past a TTL, so its work requeues."""
        for ev in events:
            if ev.type != "delete":
                continue
            rel = ev.record.key[len(prefix):]
            if "/" not in rel:
                continue
            reader, pod_id = rel.rsplit("/", 1)
            logger.warning("reader advert %s/%s expired; marking the pod dead", reader, pod_id[:8])
            try:
                self._gate.wrap(self.service.mark_pod_dead)(pod_id, reader=reader)
            except Exception:  # noqa: BLE001 — keep watching
                logger.exception("mark_pod_dead failed")

    def _serve_term(self, session: CoordSession) -> None:
        from edl_tpu_torch.data.registry import load_readers

        watcher = None
        prefix = paths.table_prefix(self._job_id, constants.ETCD_READER)
        try:
            try:
                watcher = self._store.watch_prefix(
                    prefix, lambda events: self._on_registry_events(prefix, events), period=2.0)
            except Exception:  # noqa: BLE001 — degraded: consumer nacks heal
                logger.exception("registry watch unavailable; dead pods heal via consumer "
                                 "nacks only")
            # a pod that died before this term's watch started fires no
            # delete event: reconcile the journaled generations against the
            # adverts as they are now, or its rebuilt grants would pin the
            # generation open
            try:
                for gen_name in self._journal.list_readers():
                    live = list(load_readers(self._store, self._job_id, gen_name))
                    try:
                        self._gate.wrap(self.service.reconcile_pods)(gen_name, live)
                    except Exception:  # noqa: BLE001 — a torn or empty generation
                        logger.exception("reconcile of %s failed", gen_name)
            except Exception:  # noqa: BLE001 — store blip: nacks heal
                logger.exception("seat-time registry reconcile failed")
            while not self._halt.is_set() and not session.is_stopped:
                self._halt.wait(self._retry_period)
        finally:
            if watcher is not None:
                watcher.stop()

    def _seize(self, session: CoordSession, key: str, endpoint: str) -> bool:
        """Contend for the seat on ``session`` until it is held (True) or
        the host halts (False)."""
        while not self._halt.is_set():
            try:
                session.register(key, endpoint.encode(), exclusive=True)
                return True
            except EdlRegisterError:
                pass                                        # the seat is held
            except EdlRetryableError as e:
                logger.warning("seat seize attempt failed (transient): %s", e)
            self._halt.wait(self._retry_period)
        return False

    def run(self) -> None:
        key = _seat_key(self._job_id)
        while not self._halt.is_set():
            server = RpcServer(host="0.0.0.0", port=self._port)
            self._journal = DataJournal(self._store, self._job_id)
            service = DataService(journal=self._journal, rebuild_grace=self._grace)
            self._gate = gate = _Gate()
            for name in dir(service):
                if not name.startswith("_") and callable(getattr(service, name)):
                    server.register(name, gate.wrap(getattr(service, name)))
            server.start()
            host = self._host or local_ip(getattr(self._store, "endpoint", None))
            endpoint = f"{host}:{server.port}"
            session = CoordSession(self._store, ttl=self._ttl, name=key)
            try:
                if not self._seize(session, key, endpoint):
                    return  # halted while contending
                self.service, self.endpoint = service, endpoint
                logger.info("data leader seated at %s (job %s)", endpoint, self._job_id)
                print(f"data leader serving on {endpoint}", flush=True)
                self._serve_term(session)
                if not self._halt.is_set():
                    logger.warning("data leader seat lost; standing down and re-contending")
            finally:
                self.service, self.endpoint = None, None
                # the term's ops drain before the seat is freed: a successor
                # rebuilds from the journal when it takes the seat, so no
                # journal write of this term may land after that
                if not gate.shut(timeout=max(self._ttl, 10.0)):
                    logger.warning("data leader ops still in flight at stand-down")
                server.stop()
                session.close()  # frees the seat (a no-op if it was lost)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description="Standalone elected data-service leader")
    p.add_argument("--coord_endpoints", required=True)
    p.add_argument("--job_id", required=True)
    p.add_argument("--host", default=None)
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--ttl", type=float, default=None)
    p.add_argument("--rebuild_grace", type=float, default=None)
    args = p.parse_args(argv)

    from edl_tpu_torch.coord.client import connect_wait

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s [%(name)s] %(message)s")
    store = connect_wait(args.coord_endpoints)
    host = DataLeaderHost(store, args.job_id, host=args.host, port=args.port, ttl=args.ttl,
                          rebuild_grace=args.rebuild_grace)
    try:
        host.run()
    except KeyboardInterrupt:
        pass
    finally:
        host.stop()
        store.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
