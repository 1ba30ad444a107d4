"""CoordSession: one lease and every key registered under it, self-healed
(a copy of the JAX package's ``coord/session.py``).

- one background keep-alive at ``ttl * TTL_REFRESH_FRACTION``;
- a key deleted out from under a live lease (a table sweep) is re-put;
- a lost lease (expired during a long blip, or forgotten by a restarted
  store) is re-granted and every registered key re-put as it was, so a
  reconnect converges to the state before the blip;
- **exclusive** keys (leader seats) never self-heal across a lost lease:
  the seat may belong to someone else now, so the session stops with an
  error and the owner re-contends.

:class:`~edl_tpu_torch.coord.register.Register` is a one-key facade over
this; :func:`leased_register` puts a key on a caller's shared session or on
a standalone ``Register``.
"""

from __future__ import annotations

import logging
import threading

from edl_tpu_torch.coord.kv import KVStore
from edl_tpu_torch.utils import constants
from edl_tpu_torch.utils.exceptions import EdlRegisterError

logger = logging.getLogger(__name__)

# consecutive failed keep-alive beats before a session gives up
MAX_FAILURES = 45


class _Entry:
    __slots__ = ("value", "exclusive")

    def __init__(self, value: bytes, exclusive: bool):
        self.value = value
        self.exclusive = exclusive


class CoordSession:
    """Owns one lease; keys registered on it survive blips and lease
    loss.  ``MAX_FAILURES`` consecutive *transport* failures stop the
    session (``on_lost``/``error`` fire so a supervisor can fail the
    pod)."""

    def __init__(self, store: KVStore, ttl: float | None = None, on_lost=None, name: str = "",
                 initial: "tuple[str, bytes] | None" = None):
        self._store = store
        self._ttl = ttl = constants.etcd_ttl() if ttl is None else ttl
        self._on_lost = on_lost
        self._name = name or f"session@{id(self):x}"
        self._lock = threading.Lock()
        # serializes the heartbeat's heal/re-grant store ops against
        # unregister(): without it a key popped + deleted concurrently
        # with _heal_deleted_keys/_regrant is re-put on the refreshed
        # shared lease with nothing left tracking it — an untracked
        # stale advert that lives until the whole session closes.
        # Never acquired while holding ``_lock``.
        self._op_lock = threading.Lock()
        self._keys: dict[str, _Entry] = {}
        # keys whose unregister store-op failed mid-blip; the heartbeat
        # retries their removal so they can't ride the shared lease
        # (which WE keep refreshing) forever
        self._orphans: dict[str, _Entry | None] = {}
        self._stop = threading.Event()
        self._stopped_with_error: Exception | None = None
        self._lease_id = store.lease_grant(ttl)
        if initial is not None:
            # put before the thread starts: a failed first put leaves no
            # thread behind, and its lease is revoked
            key, value = initial
            try:
                self._put_on_lease(key, value, False, self._lease_id)
            except BaseException:
                try:
                    store.lease_revoke(self._lease_id)
                except Exception as e:  # noqa: BLE001 — lease lapses at TTL
                    logger.debug("cleanup revoke of lease %d failed (%s); "
                                 "it lapses at TTL", self._lease_id, e)
                raise
            self._keys[key] = _Entry(value, False)
        self._thread = threading.Thread(target=self._heartbeat, daemon=True,
                                        name=f"coord-session:{self._name}")
        self._thread.start()

    # -- key management -----------------------------------------------------
    def _put_on_lease(self, key: str, value: bytes, exclusive: bool,
                      lease_id: int) -> None:
        if exclusive:
            if not self._store.put_if_absent(key, value, lease_id):
                raise EdlRegisterError(f"key {key} already held")
        else:
            self._store.put(key, value, lease_id)

    def _put_current(self, key: str, value: bytes, exclusive: bool) -> None:
        """Put under the current lease.  The caller holds ``_op_lock``,
        and ``_regrant`` — the only writer of ``_lease_id`` — runs
        under it too, so the lease cannot change under this put; a
        dead-lease failure surfaces to the caller and the next
        heartbeat heals (``update`` records the value first for exactly
        that reason)."""
        with self._lock:
            lease_id = self._lease_id
        self._put_on_lease(key, value, exclusive, lease_id)

    def register(self, key: str, value: bytes, exclusive: bool = False) -> None:
        """Put ``key`` under this session's lease and keep it alive.
        Exclusive keys use the lease-guarded put-if-absent (leader
        seats); a held seat raises :class:`EdlRegisterError`."""
        # _op_lock: re-registering a key whose earlier unregister was
        # parked as an orphan must CANCEL that orphan before the put —
        # serialized against _drain_orphans, or the drain would delete
        # (or stale-revert) the fresh advert one beat later.  Scoped
        # like every other _op_lock holder: a blip must not pin the
        # lock (stalling keepalive beats) for the 30 s default budget,
        # which outlives the lease.
        with self._op_lock:
            with self._lock:
                self._orphans.pop(key, None)
            with self._scope():
                self._put_current(key, value, exclusive)
            with self._lock:
                self._keys[key] = _Entry(value, exclusive)

    def is_registered(self, key: str) -> bool:
        """Whether ``key`` is currently tracked (registered and not
        unregistered) on this session."""
        with self._lock:
            return key in self._keys

    def update(self, key: str, value: bytes) -> None:
        """Refresh the payload (load stats etc.); the new value is what
        any later self-heal re-asserts — it is recorded BEFORE the put,
        so even a put that fails mid-blip is re-asserted by the next
        heal."""
        with self._lock:
            entry = self._keys.get(key)
            if entry is None:
                raise KeyError(f"{key} not registered on this session")
            entry.value = value
        # _op_lock + membership re-check: an update racing unregister()
        # must never land its put AFTER the delete — that would
        # resurrect the key on the refreshed shared lease with nothing
        # left tracking it.  Scoped like every other serialized store
        # op, so a blip can't pin _op_lock (and block unregister) past
        # about one TTL.
        with self._op_lock:
            with self._lock:
                if self._keys.get(key) is not entry:
                    return  # unregistered (or re-registered) mid-update
            with self._scope():
                self._put_current(key, value, exclusive=False)

    def unregister(self, key: str, delete: bool = True) -> None:
        """Stop healing ``key``.  ``delete`` removes it from the store
        now; otherwise it is moved onto a throwaway never-refreshed
        lease so it still lapses at TTL — the session's own lease keeps
        refreshing, so simply detaching would leave the key alive
        forever (Register.stop(revoke=False) parity).  A store op that
        fails mid-blip is parked as an orphan and retried by the
        heartbeat: the caller never blocks past the scoped deadline,
        and the key cannot stay pinned to the refreshed shared lease."""
        with self._lock:
            entry = self._keys.pop(key, None)
        if entry is None:
            # not tracked (double-stop, or never registered here): a
            # delete now would tear down a key this session doesn't own
            # — and with delete=False it would be the exact opposite of
            # the requested keep-until-TTL semantics
            return
        keep = entry if not delete else None
        try:
            # _op_lock: a heal/regrant that snapshotted _keys before our
            # pop finishes (possibly re-putting the key) before we
            # delete — our delete always lands last
            with self._op_lock, self._scope():
                self._finish_unregister(key, keep)
        except Exception:  # noqa: BLE001 — heartbeat retries it
            with self._lock:
                self._orphans[key] = keep
            logger.warning("session %s: unregister of %s deferred to "
                           "heartbeat retry", self._name, key)

    def _finish_unregister(self, key: str, keep: "_Entry | None") -> None:
        if keep is None:
            self._store.delete(key)
        elif self._store.get(key) is not None:
            # still present (on OUR lease): move it to a throwaway
            # never-refreshed lease; if it already vanished (shared
            # lease lapsed mid-blip), TTL expiry did the job
            lid = self._store.lease_grant(self._ttl)
            self._store.put(key, keep.value, lid)

    def _drain_orphans(self) -> None:
        with self._lock:
            pending = list(self._orphans.items())
        for key, keep in pending:
            try:
                self._finish_unregister(key, keep)
            except Exception as e:  # noqa: BLE001 — retry next beat
                logger.debug("orphan unregister of %s failed (%s); "
                             "retrying next beat", key, e)
                continue
            with self._lock:
                self._orphans.pop(key, None)

    # -- lifecycle ----------------------------------------------------------
    @property
    def lease_id(self) -> int:
        with self._lock:
            return self._lease_id

    @property
    def is_stopped(self) -> bool:
        return self._stop.is_set()

    @property
    def error(self) -> Exception | None:
        return self._stopped_with_error

    def _fail(self, err: Exception) -> None:
        self._stopped_with_error = err
        self._stop.set()
        if self._on_lost:
            try:
                self._on_lost(err)
            except Exception:  # noqa: BLE001
                logger.exception("on_lost callback failed for %s", self._name)

    def _scope(self):
        """Bound per-beat retrying (resilient store) to about one TTL:
        a keepalive that can't land within a TTL should fail THIS beat
        and let the next one rediscover the world — the lease-loss path
        below heals either way."""
        return self._store.scoped_deadline(max(self._ttl, 2.0))

    def _heartbeat(self) -> None:
        period = self._ttl * constants.TTL_REFRESH_FRACTION
        failures = 0
        while not self._stop.wait(period):
            try:
                with self._scope():
                    if self._store.lease_keepalive(self.lease_id):
                        failures = 0
                        with self._op_lock:
                            self._heal_deleted_keys()
                            self._drain_orphans()
                        continue
                    # lease lost: expired during a blip longer than one
                    # TTL, or a (non-durable) coord restart forgot it
                    with self._lock:
                        exclusive = sorted(k for k, e in self._keys.items()
                                           if e.exclusive)
                    if exclusive:
                        # an exclusive seat whose lease lapsed may
                        # already belong to someone else; a silent
                        # re-seize would bypass the owner's
                        # on-lose/on-become lifecycle.  _fail runs the
                        # user callback — never under our lock.
                        self._fail(EdlRegisterError(
                            f"exclusive key {exclusive[0]}: lease lost"))
                        return
                    with self._op_lock:
                        self._regrant()
                    failures = 0
            except EdlRegisterError as e:
                self._fail(e)
                return
            except Exception as e:  # noqa: BLE001 — transport blip
                failures += 1
                logger.warning("session %s heartbeat failed (%d/%d): %s",
                               self._name, failures, MAX_FAILURES, e)
                if failures >= MAX_FAILURES:
                    self._fail(EdlRegisterError(
                        f"lost session {self._name}: {e}"))
                    return

    def _heal_deleted_keys(self) -> None:
        """Lease alive but a key may have been deleted out from under us
        (e.g. a table sweep); re-put it — unless it was exclusive, where
        a delete means the seat lifecycle must restart."""
        with self._lock:
            snapshot = list(self._keys.items())
            lease_id = self._lease_id
        for key, entry in snapshot:
            if self._store.get(key) is not None:
                continue
            if entry.exclusive:
                raise EdlRegisterError(f"exclusive key {key}: deleted")
            self._store.put(key, entry.value, lease_id)
            logger.info("re-put deleted key %s", key)

    def _regrant(self) -> None:
        """Grant a fresh lease and idempotently re-assert every key."""
        lease_id = self._store.lease_grant(self._ttl)
        with self._lock:
            self._lease_id = lease_id
            snapshot = list(self._keys.items())
        for key, entry in snapshot:
            self._store.put(key, entry.value, lease_id)
        logger.info("session %s re-registered %d key(s) after lost lease",
                    self._name, len(snapshot))

    def close(self, revoke: bool = True) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)
        if revoke:
            try:
                # scoped: a teardown during the very outage that caused
                # it must not stall the full retry budget per register —
                # an unrevoked lease TTL-expires on its own anyway
                with self._scope():
                    self._store.lease_revoke(self.lease_id)
            except Exception as e:  # noqa: BLE001 — best effort on shutdown
                logger.debug("shutdown revoke of lease %d failed (%s); "
                             "it lapses at TTL", self.lease_id, e)

    def abandon(self) -> None:
        """Test hook: stop refreshing but keep the lease until TTL
        expiry (how TTL-failover is simulated)."""
        self._stop.set()
        self._thread.join(timeout=5.0)


def leased_register(store, key: str, value: bytes, ttl: float | None = None,
                    session: "CoordSession | None" = None):
    """The one advert-registration entry point the advert modules
    (the fleet's, the teachers') share: register on the caller's shared
    ``session`` (its lease/TTL governs; ``ttl`` is ignored) when given,
    else mint a standalone one-key
    :class:`~edl_tpu_torch.coord.register.Register`.  Either handle answers
    ``update``/``stop``/``is_stopped``/``error``."""
    if session is not None:
        session.register(key, value)
        return SessionKey(session, key)
    from edl_tpu_torch.coord.register import Register
    return Register(store, key, value, ttl=ttl)


class SessionKey:
    """Handle for ONE key registered on a shared :class:`CoordSession`
    — API-compatible with :class:`~edl_tpu_torch.coord.register.Register`
    (``update``/``stop``/``is_stopped``/``error``), so advert modules
    can return either."""

    def __init__(self, session: CoordSession, key: str):
        self._session = session
        self._key = key

    def update(self, value: bytes) -> None:
        self._session.update(self._key, value)

    @property
    def is_stopped(self) -> bool:
        # Register parity: true after OUR stop(), not just the shared
        # session's — a refresh loop polling its handle must go quiet
        # once its key is gone, not KeyError every period
        return (self._session.is_stopped
                or not self._session.is_registered(self._key))

    @property
    def error(self) -> Exception | None:
        return self._session.error

    def stop(self, revoke: bool = True) -> None:
        """Drop THIS key; the shared session (and its other keys) lives
        on.  ``revoke`` deletes the key from the store now, else it
        lapses at TTL like ``Register.stop(revoke=False)``."""
        self._session.unregister(self._key, delete=revoke)

    def stop_heartbeat_only(self) -> None:
        """Test hook (Register parity): abandon the UNDERLYING shared
        session — every key riding it expires at TTL, which is what a
        process whose keepalive died looks like from outside."""
        self._session.abandon()
