"""Teacher/student balance table (a copy of the JAX package's
``distill/balance.py``; the same greedy assignment, ring and codes, so a
port discovery server and a JAX one agree on every answer).

Reference: balance_table.py (688).  Teachers register in the
coordination store under ``/edl_tpu_distill/<service>/nodes/<endpoint>``
(TTL-leased, via ``coord/register.py``).  Each discovery server runs a
BalanceTable that:

- self-registers under the ``__balance__`` service and shards service
  names across discovery servers with the consistent-hash ring
  (:513-535): a register or heartbeat for a service it does not own gets
  REDIRECT and the owner's endpoint;
- per service, watches the store for teacher changes and runs the
  greedy bipartite rebalance (:242-338): ``server_max = ceil(clients /
  servers)`` connections per teacher, ``client_max = max(1, servers //
  clients)`` capped by the client's require_num; over-limit links break,
  then least-loaded clients link to least-loaded teachers;
- versions each client's assignment (:340-347): a heartbeat returns the
  server list only when the version advanced.
"""

from __future__ import annotations

import logging
import math
import os
import threading
import time
from dataclasses import dataclass, field

from edl_tpu_torch.coord.consistent_hash import ConsistentHash

logger = logging.getLogger(__name__)

# Dead students are expired after this long without a heartbeat so their
# teacher assignments return to the pool (reference timing-wheel GC,
# balance_table.py:384-388, :466-493).
DEFAULT_CLIENT_TTL = float(os.environ.get("EDL_TPU_DISTILL_CLIENT_TTL", "30"))

DISTILL_ROOT = "/edl_tpu_distill"
BALANCE_SERVICE = "__balance__"

# discovery protocol codes (reference distill_discovery.proto:21-50)
OK = "ok"
NO_READY = "no_ready"
REDIRECT = "redirect"
UNREGISTERED = "unregistered"


def service_prefix(service: str) -> str:
    return f"{DISTILL_ROOT}/{service}/nodes/"


def server_key(service: str, endpoint: str) -> str:
    return f"{DISTILL_ROOT}/{service}/nodes/{endpoint}"


@dataclass
class _Client:
    client_id: str
    require_num: int
    version: int = 0
    servers: set[str] = field(default_factory=set)
    last_seen: float = 0.0


class Service:
    """One service's clients + teachers + assignment."""

    def __init__(self, name: str, store, period: float = 3.0,
                 client_ttl: float = DEFAULT_CLIENT_TTL):
        self.name = name
        self._store = store
        self._lock = threading.Lock()
        self._clients: dict[str, _Client] = {}
        self._servers: set[str] = set()
        self._ttl = client_ttl
        self._watcher = store.watch_prefix(service_prefix(name),
                                           self._on_change, period)
        self._refresh_servers()

    def close(self) -> None:
        self._watcher.stop()

    def gc_expired(self) -> None:
        """Expire clients whose heartbeats stopped: a silently-dead
        student must not hold teacher assignments forever, starving the
        survivors (reference balance_table.py:466-493).  Driven by the
        BalanceTable's single sweeper thread."""
        now = time.monotonic()
        with self._lock:
            dead = [cid for cid, c in self._clients.items()
                    if now - c.last_seen > self._ttl]
            for cid in dead:
                del self._clients[cid]
            if dead:
                logger.info("service %s: expired clients %s", self.name, dead)
                self._rebalance_locked()

    def _on_change(self, events) -> None:
        del events
        self._refresh_servers()

    def _refresh_servers(self) -> None:
        # the store read rides the ResilientCoordClient's retry and
        # failover (what coord.client.connect returns), deadline-scoped so a
        # store outage costs one bounded round; a blip that still escapes
        # defers the rebalance round (the stale teacher set is kept and the
        # watcher retries at its next poll) instead of unwinding into the
        # watcher's callback and dropping it
        try:
            with self._store.scoped_deadline(5.0):
                recs, _ = self._store.get_prefix(service_prefix(self.name))
        except Exception as e:  # noqa: BLE001 — keep the stale view
            logger.warning("service %s teacher refresh failed (%s); "
                           "rebalance round deferred to the next watch "
                           "poll", self.name, e)
            return
        prefix_len = len(service_prefix(self.name))
        servers = {r.key[prefix_len:] for r in recs}
        with self._lock:
            if servers != self._servers:
                logger.info("service %s teachers: %s", self.name, sorted(servers))
                self._servers = servers
                self._rebalance_locked()

    # -- client API ----------------------------------------------------------
    def add_client(self, client_id: str, require_num: int) -> None:
        with self._lock:
            if client_id not in self._clients:
                self._clients[client_id] = _Client(
                    client_id, max(1, require_num),
                    last_seen=time.monotonic())
                self._rebalance_locked()
            else:
                self._clients[client_id].last_seen = time.monotonic()

    def remove_client(self, client_id: str) -> None:
        with self._lock:
            if self._clients.pop(client_id, None) is not None:
                self._rebalance_locked()

    def get_servers(self, client_id: str,
                    known_version: int) -> tuple[int, list[str] | None]:
        """(version, servers) — servers None when nothing changed.
        Counts as a heartbeat for client GC."""
        with self._lock:
            c = self._clients.get(client_id)
            if c is None:
                raise KeyError(client_id)
            c.last_seen = time.monotonic()
            if c.version == known_version:
                return c.version, None
            return c.version, sorted(c.servers)

    def is_registered(self, client_id: str) -> bool:
        with self._lock:
            return client_id in self._clients

    # -- the greedy rebalance (call with lock held) --------------------------
    def _rebalance_locked(self) -> None:
        servers, clients = self._servers, list(self._clients.values())
        if not clients:
            return
        if not servers:
            for c in clients:
                if c.servers:
                    c.servers = set()
                    c.version += 1
            return
        server_max = math.ceil(len(clients) / len(servers))
        load: dict[str, int] = {s: 0 for s in servers}
        changed: set[str] = set()
        # break links to dead teachers, count surviving load
        for c in clients:
            kept = c.servers & servers
            if kept != c.servers:
                changed.add(c.client_id)
            c.servers = kept
            for s in kept:
                load[s] += 1
        # per-client cap, then break over-limit links (most-loaded first)
        for c in clients:
            cmax = min(c.require_num,
                       max(1, len(servers) // max(1, len(clients))))
            while len(c.servers) > cmax:
                drop = max(c.servers, key=lambda s: load[s])
                c.servers.discard(drop)
                load[drop] -= 1
                changed.add(c.client_id)
        # break server overload (steal from clients with most conns)
        for s in sorted(servers, key=lambda s: -load[s]):
            while load[s] > server_max:
                victims = [c for c in clients if s in c.servers]
                victim = max(victims, key=lambda c: len(c.servers))
                victim.servers.discard(s)
                load[s] -= 1
                changed.add(victim.client_id)
        # greedy link: least-connected clients to least-loaded teachers
        for c in sorted(clients, key=lambda c: len(c.servers)):
            cmax = min(c.require_num,
                       max(1, len(servers) // max(1, len(clients))))
            candidates = sorted(servers - c.servers, key=lambda s: load[s])
            for s in candidates:
                if len(c.servers) >= cmax:
                    break
                if load[s] >= server_max and len(c.servers) > 0:
                    continue
                c.servers.add(s)
                load[s] += 1
                changed.add(c.client_id)
        for c in clients:
            if c.client_id in changed:
                c.version += 1


class BalanceTable:
    """All services on one discovery server + the redirect ring."""

    def __init__(self, store, my_endpoint: str, ring_period: float = 3.0,
                 client_ttl: float = DEFAULT_CLIENT_TTL):
        self._store = store
        self._endpoint = my_endpoint
        self._client_ttl = client_ttl
        self._services: dict[str, Service] = {}
        self._lock = threading.Lock()
        self._hash = ConsistentHash([my_endpoint])
        self._ring_watcher = store.watch_prefix(
            service_prefix(BALANCE_SERVICE), self._on_ring_change, ring_period)
        self._refresh_ring()
        # one sweeper for all services (thread count must not scale with
        # client-supplied service-name cardinality)
        self._gc_halt = threading.Event()
        self._gc = threading.Thread(target=self._gc_loop, daemon=True,
                                    name="balance-client-gc")
        self._gc.start()

    def _gc_loop(self) -> None:
        while not self._gc_halt.wait(max(0.2, self._client_ttl / 3)):
            with self._lock:
                services = list(self._services.values())
            for svc in services:
                svc.gc_expired()

    def close(self) -> None:
        self._gc_halt.set()
        self._ring_watcher.stop()
        self._gc.join(timeout=2.0)
        with self._lock:
            services = list(self._services.values())
            self._services = {}
        for s in services:
            s.close()

    def _on_ring_change(self, events) -> None:
        del events
        self._refresh_ring()

    def _refresh_ring(self) -> None:
        # same deferral contract as Service._refresh_servers: a coord
        # blip keeps the stale ring (we always include ourselves, so
        # requests keep being served) rather than killing the watcher
        try:
            with self._store.scoped_deadline(5.0):
                recs, _ = self._store.get_prefix(
                    service_prefix(BALANCE_SERVICE))
        except Exception as e:  # noqa: BLE001 — keep the stale ring
            logger.warning("balance ring refresh failed (%s); keeping "
                           "the previous ring until the next watch poll", e)
            return
        plen = len(service_prefix(BALANCE_SERVICE))
        nodes = sorted({r.key[plen:] for r in recs} | {self._endpoint})
        self._hash = ConsistentHash(nodes)

    def owner_of(self, service: str) -> str:
        return self._hash.get_node(service)

    def service(self, name: str) -> Service:
        with self._lock:
            svc = self._services.get(name)
        if svc is not None:
            return svc
        # built outside the table lock: Service.__init__ starts a store
        # watch and runs a get_prefix, so building it under _lock would
        # stall every register, heartbeat and unregister behind one slow
        # store round trip.  Double-checked insert; a losing racer closes
        # its copy.
        fresh = Service(name, self._store, client_ttl=self._client_ttl)
        with self._lock:
            svc = self._services.setdefault(name, fresh)
        if svc is not fresh:
            fresh.close()
        return svc

    # -- RPC handlers (wired by DiscoveryServer) -----------------------------
    def register_client(self, client_id: str, service: str,
                        require_num: int = 1) -> dict:
        owner = self.owner_of(service)
        if owner != self._endpoint:
            return {"code": REDIRECT, "discovery_servers": [owner]}
        self.service(service).add_client(client_id, require_num)
        return {"code": OK}

    def heartbeat(self, client_id: str, service: str, version: int = -1) -> dict:
        owner = self.owner_of(service)
        if owner != self._endpoint:
            return {"code": REDIRECT, "discovery_servers": [owner]}
        svc = self.service(service)
        try:
            new_version, servers = svc.get_servers(client_id, version)
        except KeyError:
            # not registered, or expired by GC between check and read —
            # the client re-registers on this code
            return {"code": UNREGISTERED}
        if not servers and new_version == 0:
            return {"code": NO_READY, "version": 0}
        return {"code": OK, "version": new_version, "servers": servers}

    def unregister_client(self, client_id: str, service: str) -> dict:
        with self._lock:
            svc = self._services.get(service)
        if svc is not None:
            svc.remove_client(client_id)
        return {"code": OK}
