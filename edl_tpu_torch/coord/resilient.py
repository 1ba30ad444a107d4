"""Self-healing coordination client: retry, backoff, endpoint failover (a
copy of the JAX package's ``coord/resilient.py``, over the operations the
port's :class:`~edl_tpu_torch.coord.client.CoordClient` has, without its
retry, failover and outage metrics, which wait for the port's metrics
module).

``CoordClient`` is one TCP client pinned to one endpoint: a transport error
surfaces at once and a dead endpoint stays dead.  This wrapper:

- retries every op's ``EdlCoordError`` (transport failures) with
  exponential backoff and full jitter under a total deadline budget, so a
  store restart is a bounded hiccup instead of an exception;
- fails over to the next endpoint of the list after ``FAILOVER_AFTER``
  consecutive errors on the current one (a one-endpoint list redials).
  Failover is sticky: the servers are independent stores, not a quorum, so
  one dropped packet must not move a process to another store;
- lets errors the server raised (``EdlRegisterError`` and the like)
  through at once: the server answered, and a retry would not change it.

Latency-sensitive callers (trainer heartbeats) scope the budget down; the
scope is one absolute deadline shared by every op inside it::

    with store.scoped_deadline(5.0):
        store.put(key, value)
"""

from __future__ import annotations

import contextlib
import logging
import random
import threading
import time

from edl_tpu_torch.coord.client import CoordClient
from edl_tpu_torch.coord.kv import KVStore, PrefixWatcher
from edl_tpu_torch.utils import constants
from edl_tpu_torch.utils.exceptions import EdlCoordError

logger = logging.getLogger(__name__)


class ResilientCoordClient(KVStore):
    # consecutive transport errors on the current endpoint before the client
    # leaves it for the next one
    FAILOVER_AFTER = 3

    def __init__(self, endpoints: str | list[str], timeout: float = 30.0,
                 retry_deadline: float | None = None, backoff_init: float | None = None,
                 backoff_max: float | None = None, start_index: int = 0):
        if isinstance(endpoints, str):
            endpoints = [e.strip() for e in endpoints.split(",") if e.strip()]
        if not endpoints:
            raise ValueError("no coordination endpoints given")
        self.endpoints = list(endpoints)
        self._timeout = timeout
        self._deadline = (constants.coord_retry_deadline() if retry_deadline is None
                          else retry_deadline)
        self._backoff_init = (constants.coord_backoff_init() if backoff_init is None
                              else backoff_init)
        self._backoff_max = (constants.coord_backoff_max() if backoff_max is None
                             else backoff_max)
        self._lock = threading.Lock()
        self._clients: dict[str, CoordClient] = {}
        self._cur = int(start_index) % len(self.endpoints)  # the caller-verified endpoint
        self._cur_errors = 0  # consecutive transport errors on _cur
        self._closed = False
        self._local = threading.local()  # this thread's scoped deadline
        self._rng = random.Random()

    # -- endpoint management ------------------------------------------------
    @property
    def endpoint(self) -> str:
        """The endpoint currently preferred."""
        with self._lock:
            return self.endpoints[self._cur]

    def _client_for(self, ep: str) -> CoordClient:
        """The pooled client of ``ep`` (callers hold ``_lock``)."""
        if self._closed:
            raise EdlCoordError("resilient coord client is closed")
        client = self._clients.get(ep)
        if client is None:
            client = self._clients[ep] = CoordClient(ep, self._timeout)
        return client

    def _client(self) -> CoordClient:
        with self._lock:
            return self._client_for(self.endpoints[self._cur])

    def _note_ok(self) -> None:
        with self._lock:
            self._cur_errors = 0

    def _fail_over(self, from_ep: str) -> None:
        with self._lock:
            if self.endpoints[self._cur] != from_ep:
                return  # another thread already moved on
            self._cur_errors += 1
            if len(self.endpoints) > 1 and self._cur_errors >= self.FAILOVER_AFTER:
                self._cur = (self._cur + 1) % len(self.endpoints)
                self._cur_errors = 0
                logger.warning("coord failover %s -> %s", from_ep, self.endpoints[self._cur])

    @contextlib.contextmanager
    def scoped_deadline(self, seconds: float):
        """Bound the total retry budget of every op this thread issues inside
        the block to one shared absolute deadline: k ops against a dead
        store fail within ``seconds`` overall, not ``seconds`` each."""
        prev = getattr(self._local, "deadline_at", None)
        self._local.deadline_at = time.monotonic() + seconds
        try:
            yield self
        finally:
            self._local.deadline_at = prev

    # -- the retry loop -----------------------------------------------------
    def _invoke(self, op: str, *args):
        deadline = getattr(self._local, "deadline_at", None)
        if deadline is None:
            budget = self._deadline
            deadline = time.monotonic() + budget
        else:
            budget = max(0.0, deadline - time.monotonic())
        delay = self._backoff_init
        # the in-flight request is bounded by the remaining budget too, so a
        # hung endpoint (connection accepted, no answer) stays inside it; with
        # standbys the remainder is split so FAILOVER_AFTER hung attempts
        # still leave time to reach one
        split = (self.FAILOVER_AFTER + 1) if len(self.endpoints) > 1 else 1
        while True:
            client = self._client()
            try:
                remaining = deadline - time.monotonic()
                result = getattr(client, op)(
                    *args, _timeout=max(0.25, min(self._timeout, remaining / split)))
                self._note_ok()
                return result
            except EdlCoordError as e:
                self._fail_over(client.endpoint)
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise EdlCoordError(f"coord op {op} failed after retry budget "
                                        f"({budget:.1f}s) across {self.endpoints}: {e}") from e
                # full jitter spreads a whole job's retries over the window
                time.sleep(min(self._rng.uniform(0, delay), remaining))
                delay = min(delay * 2, self._backoff_max)

    # -- KVStore surface ----------------------------------------------------
    def put(self, key, value, lease_id=0):
        return self._invoke("put", key, value, lease_id)

    def get(self, key):
        return self._invoke("get", key)

    def get_prefix(self, prefix):
        return self._invoke("get_prefix", prefix)

    def delete(self, key):
        return self._invoke("delete", key)

    def delete_prefix(self, prefix):
        return self._invoke("delete_prefix", prefix)

    def lease_grant(self, ttl):
        return self._invoke("lease_grant", ttl)

    def lease_keepalive(self, lease_id):
        return self._invoke("lease_keepalive", lease_id)

    def lease_revoke(self, lease_id):
        return self._invoke("lease_revoke", lease_id)

    # CAS retries are safe against a lost response: put_if_absent also
    # succeeds when the key already holds the same value under the same
    # live lease (the store's idempotent re-seize), and put_if_equals
    # re-checks its guard, so False after a guard change is the right answer
    def put_if_absent(self, key, value, lease_id=0):
        return self._invoke("put_if_absent", key, value, lease_id)

    def put_if_equals(self, guard_key, guard_value, key, value, lease_id=0):
        return self._invoke("put_if_equals", guard_key, guard_value, key, value, lease_id)

    def wait(self, prefix, since_revision, timeout):
        """The long-poll, retried as any op.  After a failover its revision
        is another store's, so callers use it as a wake-up and re-read what
        they wait for (the data service's reader registry does), never as a
        delta to apply."""
        return self._invoke("wait", prefix, since_revision, timeout)

    def ping(self) -> bool:
        """True if any endpoint answers a ping now (no retries)."""
        last_err: Exception | None = None
        for ep in list(self.endpoints):
            with self._lock:
                if self._closed:
                    return False  # never resurrect clients after close()
                client = self._client_for(ep)
            try:
                if client.ping():
                    return True
            except Exception as e:  # noqa: BLE001 — probing, not failing
                last_err = e
        if last_err is not None:
            logger.debug("ping failed on all endpoints: %s", last_err)
        return False

    def watch_prefix(self, prefix, callback, period: float = 5.0):
        """A callback watch over a resilient client of its own (long-polls
        must not hold up regular ops), seated where this one is."""
        with self._lock:
            cur = self._cur
        dedicated = ResilientCoordClient(
            self.endpoints, self._timeout, retry_deadline=self._deadline,
            backoff_init=self._backoff_init, backoff_max=self._backoff_max, start_index=cur)
        try:
            w = PrefixWatcher(dedicated, prefix, callback, period, close_store=True)
        except BaseException:
            dedicated.close()
            raise
        w.start()
        return w

    def close(self):
        with self._lock:
            self._closed = True
            clients, self._clients = list(self._clients.values()), {}
        for client in clients:
            client.close()
