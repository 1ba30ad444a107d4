"""TTL-leased registration with a background keep-alive (the port of the
JAX package's ``coord/register.py``): a server advertises itself under a
key on a lease until ``stop()``; the key vanishes when the lease is revoked
or, if the process dies, expires.

``Register`` is a one-key facade over
:class:`~edl_tpu_torch.coord.session.CoordSession`, which owns the lease's
life for any number of keys: the keep-alive at ``ttl *
TTL_REFRESH_FRACTION``, the heal of a key deleted under a live lease, the
re-grant and re-put after a lost lease.  ``session.MAX_FAILURES``
consecutive transport failures stop the registration (``is_stopped``;
``error`` says why).
"""

from __future__ import annotations

from edl_tpu_torch.coord.kv import KVStore
from edl_tpu_torch.coord.session import CoordSession, leased_register

__all__ = ["Register", "leased_register"]


class Register:
    """Keep ``key=value`` alive in the store until ``stop()``."""

    def __init__(self, store: KVStore, key: str, value: bytes, ttl: float | None = None):
        self._key = key
        # initial= puts the key before the keep-alive thread starts
        self._session = CoordSession(store, ttl=ttl, name=key, initial=(key, value))

    @property
    def lease_id(self) -> int:
        return self._session.lease_id

    def update(self, value: bytes) -> None:
        """Put a new value; a heal after a lost lease re-asserts it."""
        self._session.update(self._key, value)

    @property
    def is_stopped(self) -> bool:
        return self._session.is_stopped

    @property
    def error(self) -> Exception | None:
        return self._session.error

    def stop(self, revoke: bool = True) -> None:
        self._session.close(revoke=revoke)

    def stop_heartbeat_only(self) -> None:
        """Test hook: stop refreshing but keep the lease until TTL expiry
        (how a process whose keep-alive died looks from outside)."""
        self._session.abandon()
