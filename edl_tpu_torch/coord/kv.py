"""KV-store interface, the record types its clients return, and the
prefix watcher (a copy of the JAX package's ``coord/kv.py``).

Semantics follow what the reference used from etcd3: flat keys, prefix
range reads with a store-wide revision, a guarded put, and ``wait``, a
long-poll on a prefix, which :class:`PrefixWatcher` turns into callbacks
(the distillation balance table watches its teachers with it).
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field
from typing import Callable, Optional


@dataclass(frozen=True)
class KVRecord:
    key: str
    value: bytes
    revision: int = 0          # store revision of last modification
    lease_id: int = 0          # 0 = no lease


@dataclass(frozen=True)
class WatchEvent:
    type: str                  # "put" | "delete"
    record: KVRecord


@dataclass
class WaitResult:
    events: list[WatchEvent] = field(default_factory=list)
    revision: int = 0          # store revision as of this response
    # True when ``events`` is a full current-state resync (every live key
    # under the prefix as a "put"), not a delta: the caller's revision
    # predated the bounded event log, or the store restarted
    snapshot: bool = False


class KVStore:
    """Abstract coordination store."""

    def put(self, key: str, value: bytes, lease_id: int = 0) -> int:
        raise NotImplementedError

    def get(self, key: str) -> Optional[KVRecord]:
        raise NotImplementedError

    def get_prefix(self, prefix: str) -> tuple[list[KVRecord], int]:
        """Returns (records sorted by key, store revision)."""
        raise NotImplementedError

    def delete(self, key: str) -> bool:
        raise NotImplementedError

    def delete_prefix(self, prefix: str) -> int:
        """Delete every key under ``prefix``; returns how many went."""
        raise NotImplementedError

    def put_if_equals(self, guard_key: str, guard_value: bytes, key: str, value: bytes,
                      lease_id: int = 0) -> bool:
        """Write ``key`` iff ``guard_key`` currently holds ``guard_value``."""
        raise NotImplementedError

    def put_if_absent(self, key: str, value: bytes, lease_id: int = 0) -> bool:
        """Write ``key`` iff it does not exist (a seat's seize)."""
        raise NotImplementedError

    # -- leases: a key put under a lease is deleted when the lease expires
    def lease_grant(self, ttl: float) -> int:
        raise NotImplementedError

    def lease_keepalive(self, lease_id: int) -> bool:
        """Refresh the lease; False when it has already expired."""
        raise NotImplementedError

    def lease_revoke(self, lease_id: int) -> None:
        """End the lease now, deleting its keys."""
        raise NotImplementedError

    def wait(self, prefix: str, since_revision: int, timeout: float) -> WaitResult:
        """Block until a change under ``prefix`` with revision >
        ``since_revision``, or ``timeout``; returns the events and the new
        revision.  A store without watches raises NotImplementedError, and
        callers poll."""
        raise NotImplementedError

    def close(self) -> None:
        pass

    @contextlib.contextmanager
    def scoped_deadline(self, seconds: float):
        """Bound this thread's time for ops inside the block (liveness
        beats use it: a missed beat is recoverable, a stalled step is
        not).  A no-op here; clients override it."""
        yield self

    def watch_prefix(self, prefix: str, callback: Callable[[list[WatchEvent]], None],
                     period: float = 5.0) -> "PrefixWatcher":
        """Start a thread that long-polls ``wait`` and calls ``callback``
        with each batch of events."""
        w = PrefixWatcher(self, prefix, callback, period)
        w.start()
        return w


class PrefixWatcher(threading.Thread):
    """Long-polls ``wait`` and feeds the callback incremental events.

    Tracks the set of live keys it has reported, so a **snapshot** result
    (``WaitResult.snapshot``: the watcher's revision fell out of the
    bounded event log, or the store restarted) replaces the view instead
    of merging: keys it knew of that the snapshot lacks surface as
    synthetic ``delete`` events, and no consumer keeps a phantom entry
    whose tombstone was compacted away.
    """

    def __init__(self, store: KVStore, prefix: str, callback, period: float,
                 close_store: bool = False):
        super().__init__(daemon=True, name=f"watch:{prefix}")
        self._store = store
        self._prefix = prefix
        self._callback = callback
        self._period = period
        self._close_store = close_store  # the store is this watcher's own
        self._halt = threading.Event()
        recs, self._revision = store.get_prefix(prefix)
        self._known: set[str] = {r.key for r in recs}

    def _resync(self, events: list[WatchEvent]) -> list[WatchEvent]:
        """A snapshot result as a delta against the known view: deletes of
        the vanished keys first, then the snapshot's puts."""
        live = {e.record.key for e in events if e.type == "put"}
        gone = sorted(self._known - live)
        deletes = [WatchEvent("delete", KVRecord(k, b"")) for k in gone]
        self._known = live
        return deletes + events

    def run(self):
        while not self._halt.is_set():
            try:
                res = self._store.wait(self._prefix, self._revision, self._period)
            except Exception:  # noqa: BLE001 — a store blip: poll again
                if self._halt.is_set():
                    return
                self._halt.wait(1.0)
                continue
            self._revision = res.revision
            events = res.events
            if res.snapshot:
                events = self._resync(events)
            else:
                for e in events:
                    if e.type == "put":
                        self._known.add(e.record.key)
                    else:
                        self._known.discard(e.record.key)
            if events:
                self._callback(events)

    def stop(self):
        self._halt.set()
        if self._close_store:
            self._store.close()
