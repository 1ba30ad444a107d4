"""In-process KV engine with TTL leases, revisions and ``wait`` (a copy of
the JAX package's ``coord/memory.py`` without its write-ahead log, snapshot
and restart hooks, and without its metrics).

The port has no store server, so this is the store that an in-process data
service, its reader registry and the tests use.  One lock and condition
variable around a dict: waiters block on the condition and replay a bounded
event log; a sweeper thread expires leases and deletes their keys, as etcd
does.
"""

from __future__ import annotations

import threading
import time
from collections import deque

from edl_tpu_torch.coord.kv import KVRecord, KVStore, WaitResult, WatchEvent

_EVENT_LOG_CAP = 4096


class _Lease:
    __slots__ = ("ttl", "expires_at", "keys")

    def __init__(self, ttl: float, now: float):
        self.ttl = ttl
        self.expires_at = now + ttl
        self.keys: set[str] = set()


class MemoryKV(KVStore):
    def __init__(self, sweep_period: float = 0.25):
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._data: dict[str, KVRecord] = {}
        self._leases: dict[int, _Lease] = {}
        # clock-seeded counters, as the JAX engine's: a restarted store lands
        # its revision ahead of any earlier watcher's position, and never
        # re-grants a lease id an earlier holder may still refresh
        self._revision = int(time.time() * 1000)
        self._next_lease = int(time.time() * 1000)
        self._events: deque[tuple[int, WatchEvent]] = deque(maxlen=_EVENT_LOG_CAP)
        self._closed = False
        self._stop_evt = threading.Event()
        self._sweeper = threading.Thread(target=self._sweep_loop, args=(sweep_period,),
                                         daemon=True, name="memkv-sweeper")
        self._sweeper.start()

    # -- internal (lock held) ----------------------------------------------
    def _bump(self) -> int:
        self._revision += 1
        return self._revision

    def _emit(self, etype: str, rec: KVRecord) -> None:
        self._events.append((rec.revision, WatchEvent(etype, rec)))
        self._cond.notify_all()

    def _put_locked(self, key: str, value: bytes, lease_id: int) -> int:
        lease = None
        if lease_id:
            lease = self._leases.get(lease_id)
            if lease is None:
                raise KeyError(f"lease {lease_id} not found")
            lease.keys.add(key)
        old = self._data.get(key)
        if old is not None and old.lease_id and old.lease_id != lease_id:
            old_lease = self._leases.get(old.lease_id)
            if old_lease:
                old_lease.keys.discard(key)
        rec = KVRecord(key, value, self._bump(), lease_id)
        self._data[key] = rec
        self._emit("put", rec)
        return rec.revision

    def _delete_locked(self, key: str) -> bool:
        rec = self._data.pop(key, None)
        if rec is None:
            return False
        if rec.lease_id:
            lease = self._leases.get(rec.lease_id)
            if lease:
                lease.keys.discard(key)
        self._emit("delete", KVRecord(key, b"", self._bump(), rec.lease_id))
        return True

    def _expire_locked(self, now: float) -> None:
        for lid in [lid for lid, lease in self._leases.items() if lease.expires_at <= now]:
            for key in list(self._leases[lid].keys):
                self._delete_locked(key)
            self._leases.pop(lid)

    def _sweep_loop(self, period: float) -> None:
        while not self._stop_evt.wait(period):
            with self._lock:
                if self._closed:
                    return
                self._expire_locked(time.monotonic())

    # -- kv ----------------------------------------------------------------
    def put(self, key: str, value: bytes, lease_id: int = 0) -> int:
        with self._lock:
            self._expire_locked(time.monotonic())
            return self._put_locked(key, value, lease_id)

    def get(self, key: str):
        with self._lock:
            self._expire_locked(time.monotonic())
            return self._data.get(key)

    def get_prefix(self, prefix: str):
        with self._lock:
            self._expire_locked(time.monotonic())
            recs = sorted((r for k, r in self._data.items() if k.startswith(prefix)),
                          key=lambda r: r.key)
            return recs, self._revision

    def delete(self, key: str) -> bool:
        with self._lock:
            self._expire_locked(time.monotonic())
            return self._delete_locked(key)

    # -- leases ------------------------------------------------------------
    def lease_grant(self, ttl: float) -> int:
        with self._lock:
            lid = self._next_lease
            self._next_lease += 1
            self._leases[lid] = _Lease(ttl, time.monotonic())
            return lid

    def lease_keepalive(self, lease_id: int) -> bool:
        with self._lock:
            now = time.monotonic()
            self._expire_locked(now)
            lease = self._leases.get(lease_id)
            if lease is None:
                return False
            lease.expires_at = now + lease.ttl
            return True

    def lease_revoke(self, lease_id: int) -> None:
        with self._lock:
            lease = self._leases.pop(lease_id, None)
            if lease:
                for key in list(lease.keys):
                    self._delete_locked(key)

    # -- transactions ------------------------------------------------------
    def put_if_absent(self, key: str, value: bytes, lease_id: int = 0) -> bool:
        with self._lock:
            self._expire_locked(time.monotonic())
            cur = self._data.get(key)
            if cur is not None:
                # idempotent re-seize: same value under the same live lease
                return bool(cur.value == value and lease_id and cur.lease_id == lease_id)
            self._put_locked(key, value, lease_id)
            return True

    def put_if_equals(self, guard_key: str, guard_value: bytes, key: str, value: bytes,
                      lease_id: int = 0) -> bool:
        with self._lock:
            self._expire_locked(time.monotonic())
            cur = self._data.get(guard_key)
            if cur is None or cur.value != guard_value:
                return False
            self._put_locked(key, value, lease_id)
            return True

    # -- watch -------------------------------------------------------------
    def wait(self, prefix: str, since_revision: int, timeout: float) -> WaitResult:
        """Events under ``prefix`` newer than ``since_revision``, as soon as
        there are any or at ``timeout``.  A position older than the event
        log (or newer than the store: another store's) gets a full
        snapshot of the prefix, ``snapshot=True``."""
        deadline = time.monotonic() + timeout
        with self._lock:
            while True:
                self._expire_locked(time.monotonic())
                rev = self._revision
                if since_revision > rev or (since_revision < rev and (
                        not self._events or since_revision < self._events[0][0] - 1)):
                    recs = sorted((r for r in self._data.values() if r.key.startswith(prefix)),
                                  key=lambda r: r.key)
                    return WaitResult([WatchEvent("put", r) for r in recs], rev, snapshot=True)
                evs = [ev for erev, ev in self._events
                       if erev > since_revision and ev.record.key.startswith(prefix)]
                remaining = deadline - time.monotonic()
                if evs or remaining <= 0:
                    return WaitResult(evs, rev)
                # the bounded slice re-runs lease expiry, whose deletes are
                # changes a waiter must see
                self._cond.wait(min(remaining, 0.25))

    def close(self) -> None:
        with self._lock:
            self._closed = True
        self._stop_evt.set()
        if threading.current_thread() is not self._sweeper:
            self._sweeper.join(timeout=10.0)
