"""Coordination-store client: a KVStore over the RPC wire (a copy of the
JAX package's ``coord/client.py``, with the operations a trainer, a
leased advert and a prefix watch use).

The same requests as the JAX client, so it talks to the JAX package's
coordination server (``python -m edl_tpu.coord.server``) and to the C++
daemon.  :class:`CoordClient` is pinned to one endpoint; ``connect``
returns a :class:`~edl_tpu_torch.coord.resilient.ResilientCoordClient`
(retry, backoff and endpoint failover on every op) seated on the first
endpoint that answers a ping, as the JAX ``connect`` does.
"""

from __future__ import annotations

import logging

from edl_tpu_torch.coord.kv import KVRecord, KVStore, PrefixWatcher, WaitResult, WatchEvent
from edl_tpu_torch.rpc.client import RpcClient
from edl_tpu_torch.utils import exceptions, retry

logger = logging.getLogger(__name__)


def _wire_to_rec(w):
    return None if w is None else KVRecord(w[0], w[1], w[2], w[3])


class CoordClient(KVStore):
    def __init__(self, endpoint: str, timeout: float = 30.0):
        self.endpoint = endpoint
        self._timeout = timeout
        self._rpc = RpcClient(endpoint, timeout)

    def _call(self, method: str, _timeout=None, **kwargs):
        """One request; the transport bound is ``_timeout`` (the resilient
        client's share of its deadline), else the client default."""
        return self._rpc.call(method, _timeout=_timeout, **kwargs)

    # -- kv ----------------------------------------------------------------
    def put(self, key, value, lease_id=0, _timeout=None):
        return self._call("kv_put", _timeout, key=key, value=value, lease_id=lease_id)["rev"]

    def get(self, key, _timeout=None):
        return _wire_to_rec(self._call("kv_get", _timeout, key=key)["rec"])

    def get_prefix(self, prefix, _timeout=None):
        r = self._call("kv_range", _timeout, prefix=prefix)
        return [_wire_to_rec(w) for w in r["recs"]], r["rev"]

    def delete(self, key, _timeout=None):
        return self._call("kv_del", _timeout, key=key)["deleted"]

    # -- leases ------------------------------------------------------------
    def lease_grant(self, ttl, _timeout=None):
        return self._call("lease_grant", _timeout, ttl=ttl)["lease_id"]

    def lease_keepalive(self, lease_id, _timeout=None):
        return self._call("lease_keepalive", _timeout, lease_id=lease_id)["alive"]

    def lease_revoke(self, lease_id, _timeout=None):
        self._call("lease_revoke", _timeout, lease_id=lease_id)

    # -- transactions ------------------------------------------------------
    def put_if_absent(self, key, value, lease_id=0, _timeout=None):
        return self._call("txn_put_if_absent", _timeout, key=key, value=value,
                          lease_id=lease_id)["succeeded"]

    def put_if_equals(self, guard_key, guard_value, key, value, lease_id=0, _timeout=None):
        return self._call("txn_put_if_equals", _timeout, guard_key=guard_key,
                          guard_value=guard_value, key=key, value=value,
                          lease_id=lease_id)["succeeded"]

    # -- watch -------------------------------------------------------------
    def wait(self, prefix, since_revision, timeout, _timeout=None):
        """The long-poll; its transport bound is ``timeout`` plus slack, at
        least ``_timeout``."""
        bound = max(float(timeout) + 10.0, _timeout or 0.0)
        r = self._call("wait", bound, prefix=prefix, since_revision=since_revision,
                       timeout=timeout)
        return WaitResult([WatchEvent(t, _wire_to_rec(w)) for t, w in r["events"]],
                          r["rev"], snapshot=bool(r.get("snap", False)))

    def ping(self) -> bool:
        """True if this endpoint answers a coordination ping.  Transport
        failures raise ``EdlCoordError``; a reachable server whose handler
        errors returns False, because retrying that endpoint cannot help."""
        try:
            return bool(self._rpc.call("ping").get("pong"))
        except exceptions.EdlCoordError:
            raise
        except exceptions.EdlError as e:
            logger.debug("ping handler error on %s: %s", self.endpoint, e)
            return False

    def watch_prefix(self, prefix, callback, period: float = 5.0):
        """A callback watch over a client of its own, so its long-polls do
        not hold up this client's ops; the watcher closes it on stop()."""
        dedicated = CoordClient(self.endpoint, self._timeout)
        try:
            w = PrefixWatcher(dedicated, prefix, callback, period, close_store=True)
        except BaseException:
            dedicated.close()
            raise
        w.start()
        return w

    def close(self):
        self._rpc.close()


def connect(endpoints: str | list[str], timeout: float = 30.0) -> KVStore:
    """A :class:`~edl_tpu_torch.coord.resilient.ResilientCoordClient` over a
    comma-separated endpoint list, seated on the first endpoint that
    answers a ping; ConnectionError when none does."""
    if isinstance(endpoints, str):
        endpoints = [e.strip() for e in endpoints.split(",") if e.strip()]
    last_err: Exception | None = None
    for i, ep in enumerate(endpoints):
        client = CoordClient(ep, timeout)
        ok = False
        try:
            ok = client.ping()
        except exceptions.EdlCoordError as e:
            last_err = e
        client.close()
        if ok:
            # deferred import: resilient.py wraps CoordClient
            from edl_tpu_torch.coord.resilient import ResilientCoordClient
            return ResilientCoordClient(list(endpoints), timeout, start_index=i)
    raise ConnectionError(f"no reachable coordination endpoint in {endpoints}: {last_err}")


@retry.retry_until_timeout(interval=0.5, backoff=2.0, max_interval=8.0)
def _connect_retryable(endpoints, timeout):
    try:
        return connect(endpoints, timeout)
    except ConnectionError as e:
        raise exceptions.EdlCoordError(str(e)) from e


def connect_wait(endpoints: str | list[str], timeout: float = 30.0,
                 wait: float = 60.0) -> KVStore:
    """``connect`` that tolerates the store booting after this process:
    retries with exponential backoff and jitter for up to ``wait`` s."""
    try:
        return _connect_retryable(endpoints, timeout, timeout=wait)
    except exceptions.EdlCoordError as e:
        raise ConnectionError(str(e)) from e
