"""TTL-leased registration with a background keep-alive (the port of the
JAX package's ``coord/register.py`` and of the part of its
``coord/session.py`` that one key needs): a server advertises itself
under a key on a lease until ``stop()``; the key vanishes when the lease
is revoked or, if the process dies, expires.

- The key is put under a fresh lease at construction.
- A keep-alive thread refreshes the lease every ``ttl *
  TTL_REFRESH_FRACTION`` seconds.
- ``update`` records the new value first and then puts it, so a put lost
  in a store blip is re-asserted by the next heal.
- A lost lease (expired during a blip longer than one TTL, or forgotten
  by a restarted store) is re-granted and the key re-put with its last
  value.
- ``MAX_FAILURES`` consecutive transport failures stop the registration
  (``is_stopped``, ``error`` says why).
- ``stop`` ends the thread and revokes the lease, deleting the key.

Not ported: several keys on one lease, exclusive (put-if-absent) seats,
unregistering a key from a live session, the heal of a key deleted under
a live lease, and the test hook that abandons a lease (ROADMAP.md Queue
1 item 6, with the replica fleet).
"""

from __future__ import annotations

import logging
import threading

from edl_tpu_torch.coord.kv import KVStore
from edl_tpu_torch.utils import constants
from edl_tpu_torch.utils.exceptions import EdlRegisterError

logger = logging.getLogger(__name__)

# consecutive failed keep-alive beats before the registration gives up
MAX_FAILURES = 45


class Register:
    """Keep ``key=value`` alive in the store until ``stop()``."""

    def __init__(self, store: KVStore, key: str, value: bytes, ttl: float | None = None):
        self._store = store
        self._key = key
        self._value = value
        self._ttl = constants.etcd_ttl() if ttl is None else ttl
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._error: Exception | None = None
        self._lease_id = store.lease_grant(self._ttl)
        try:
            store.put(key, value, self._lease_id)
        except BaseException:
            try:
                store.lease_revoke(self._lease_id)
            except Exception as e:  # noqa: BLE001 — the lease lapses at TTL
                logger.debug("cleanup revoke of lease %d failed: %s", self._lease_id, e)
            raise
        self._thread = threading.Thread(target=self._heartbeat, daemon=True,
                                        name=f"coord-register:{key}")
        self._thread.start()

    def _scope(self):
        """A beat's store ops are bounded to about one TTL: a keep-alive
        that cannot land within a TTL fails this beat, the next one heals."""
        return self._store.scoped_deadline(max(self._ttl, 2.0))

    @property
    def lease_id(self) -> int:
        with self._lock:
            return self._lease_id

    @property
    def is_stopped(self) -> bool:
        return self._stop.is_set()

    @property
    def error(self) -> Exception | None:
        return self._error

    def update(self, value: bytes) -> None:
        """Put a new value; a heal after a lost lease re-asserts it."""
        with self._lock:
            self._value = value
            lease_id = self._lease_id
        with self._scope():
            self._store.put(self._key, value, lease_id)

    def _heartbeat(self) -> None:
        period = self._ttl * constants.TTL_REFRESH_FRACTION
        failures = 0
        while not self._stop.wait(period):
            try:
                with self._scope():
                    if not self._store.lease_keepalive(self.lease_id):
                        lease_id = self._store.lease_grant(self._ttl)
                        with self._lock:
                            self._lease_id = lease_id
                            value = self._value
                        self._store.put(self._key, value, lease_id)
                        logger.info("re-registered %s after a lost lease", self._key)
                failures = 0
            except Exception as e:  # noqa: BLE001 — a transport blip
                failures += 1
                logger.warning("register %s heartbeat failed (%d/%d): %s", self._key,
                               failures, MAX_FAILURES, e)
                if failures >= MAX_FAILURES:
                    self._error = EdlRegisterError(f"lost registration {self._key}: {e}")
                    self._stop.set()
                    return

    def stop(self, revoke: bool = True) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)
        if revoke:
            try:
                with self._scope():
                    self._store.lease_revoke(self.lease_id)
            except Exception as e:  # noqa: BLE001 — best effort: the lease lapses at TTL
                logger.debug("shutdown revoke of lease %d failed: %s", self.lease_id, e)


def leased_register(store: KVStore, key: str, value: bytes,
                    ttl: float | None = None) -> Register:
    """A standalone one-key :class:`Register` (the JAX package's entry point
    also rides a shared multi-key session, which is not ported)."""
    return Register(store, key, value, ttl=ttl)
