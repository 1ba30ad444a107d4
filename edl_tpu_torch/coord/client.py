"""Coordination-store client: a KVStore over the RPC wire (a copy of the
JAX package's ``coord/client.py``, with the operations a trainer uses).

The same requests as the JAX client, so it talks to the JAX package's
coordination server (``python -m edl_tpu.coord.server``) and to the C++
daemon.  ``connect`` seats one client on the first endpoint that answers
a ping.  The JAX package's resilient client (retry, backoff and endpoint
failover on every op, ``coord/resilient.py``) is not ported yet (ROADMAP.md
Queue 1 item 4e): a trainer's store writes are best-effort, and
:meth:`CoordClient.scoped_deadline` bounds each one as the resilient
client's does.
"""

from __future__ import annotations

import contextlib
import logging
import threading

from edl_tpu_torch.coord.kv import KVRecord, KVStore
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
        self._scope = threading.local()

    def _call(self, method: str, _timeout=None, **kwargs):
        """One request; the transport bound is ``_timeout``, else this
        thread's :meth:`scoped_deadline`, else the client default."""
        if _timeout is None:
            _timeout = getattr(self._scope, "seconds", None)
        return self._rpc.call(method, _timeout=_timeout, **kwargs)

    @contextlib.contextmanager
    def scoped_deadline(self, seconds: float):
        prev = getattr(self._scope, "seconds", None)
        self._scope.seconds = seconds if prev is None else min(prev, seconds)
        try:
            yield self
        finally:
            self._scope.seconds = prev

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

    # -- transactions ------------------------------------------------------
    def put_if_equals(self, guard_key, guard_value, key, value, lease_id=0, _timeout=None):
        return self._call("txn_put_if_equals", _timeout, guard_key=guard_key,
                          guard_value=guard_value, key=key, value=value,
                          lease_id=lease_id)["succeeded"]

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

    def close(self):
        self._rpc.close()


def connect(endpoints: str | list[str], timeout: float = 30.0) -> CoordClient:
    """A client seated on the first endpoint of a comma-separated list
    that answers a ping; ConnectionError when none does."""
    if isinstance(endpoints, str):
        endpoints = [e.strip() for e in endpoints.split(",") if e.strip()]
    last_err: Exception | None = None
    for ep in endpoints:
        client = CoordClient(ep, timeout)
        ok = False
        try:
            ok = client.ping()
        except exceptions.EdlCoordError as e:
            last_err = e
        if ok:
            return client
        client.close()
    raise ConnectionError(f"no reachable coordination endpoint in {endpoints}: {last_err}")


@retry.retry_until_timeout(interval=0.5, backoff=2.0, max_interval=8.0)
def _connect_retryable(endpoints, timeout):
    try:
        return connect(endpoints, timeout)
    except ConnectionError as e:
        raise exceptions.EdlCoordError(str(e)) from e


def connect_wait(endpoints: str | list[str], timeout: float = 30.0,
                 wait: float = 60.0) -> CoordClient:
    """``connect`` that tolerates the store booting after this process:
    retries with exponential backoff and jitter for up to ``wait`` s."""
    try:
        return _connect_retryable(endpoints, timeout, timeout=wait)
    except exceptions.EdlCoordError as e:
        raise ConnectionError(str(e)) from e
