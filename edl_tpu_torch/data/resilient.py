"""Self-healing leader-RPC client for the data plane (a copy of the JAX
package's ``data/resilient.py`` without its metrics).

- Every call retries the transport-class ``EdlCoordError`` with exponential
  backoff and full jitter under a total deadline
  (``EDL_TPU_DATA_RETRY_DEADLINE``).
- Between attempts the leader endpoint is re-resolved through the caller's
  resolver (the cluster record): a failover swaps the underlying client and
  triggers a **reattach**, so the successor restores this reader's
  in-flight work.
- The service's incarnation id (``inc``, echoed in every response) catches
  a leader that restarted on the same endpoint: a change triggers the same
  reattach.
- ``EdlReaderGoneError`` (a successor with no journal) reattaches, which
  re-seeds the generation from the reader's own state, then replays the
  call; every DataService mutation is replay-idempotent.
- Other typed errors (``EdlStopIteration``, ``EdlDataError``) propagate at
  once: the server answered.
- ``close_after(deadline)`` caps every in-flight and later call, so
  ``DistributedReader.close()`` bounds a producer blocked mid-call.
"""

from __future__ import annotations

import logging
import random
import threading
import time
from typing import Callable

from edl_tpu_torch.rpc.client import RpcClient
from edl_tpu_torch.utils import constants
from edl_tpu_torch.utils.exceptions import EdlCoordError, EdlReaderGoneError

logger = logging.getLogger(__name__)


class CallAborted(Exception):
    """Raised by :meth:`ResilientDataClient.call` when the caller's
    ``_abort_if`` turned true between attempts: the op was not delivered on
    the aborted attempt.  Not an ``EdlError``: local control flow, never a
    wire or service failure."""


class ResilientDataClient:
    """Retry, leader re-resolution and reattach for DataService calls.

    ``endpoint`` is a ``host:port`` or a zero-argument resolver of the
    current leader's endpoint (asked again after failures).
    ``on_reattach(call)``, when set, runs (serialised, once per incident)
    with a raw single-shot call function for the reattach RPC itself; it
    must be replay-idempotent."""

    def __init__(self, endpoint: "str | Callable[[], str]", timeout: float = 10.0,
                 retry_deadline: float | None = None, on_reattach=None, name: str = ""):
        self._resolver = endpoint if callable(endpoint) else (lambda: endpoint)
        self._timeout = timeout
        self._deadline = (constants.data_retry_deadline() if retry_deadline is None
                          else retry_deadline)
        self._on_reattach = on_reattach
        self._name = name
        self._lock = threading.Lock()
        self._client: RpcClient | None = None
        self._incarnation: str | None = None
        self._closed = False
        self._close_at: float | None = None
        # one incident heals once, however many threads (producer and
        # consumer) tripped over it
        self._attach_lock = threading.Lock()
        self._attach_gen = 0
        self._need_attach = False
        self._rng = random.Random()

    # -- endpoint management -------------------------------------------------
    @property
    def endpoint(self) -> str | None:
        with self._lock:
            return self._client.endpoint if self._client else None

    def _ensure_client(self, reresolve: bool = False) -> RpcClient:
        """The current client; with ``reresolve`` the resolver is asked and
        an endpoint change swaps the client (a failover)."""
        with self._lock:
            if self._closed:
                raise EdlCoordError(f"data client {self._name} is closed")
            client = self._client
        if client is not None and not reresolve:
            return client
        try:
            endpoint = self._resolver()
        except EdlCoordError:
            raise
        except Exception as e:  # noqa: BLE001 — the resolver reads the store
            # a store blip or a cluster record mid-rewrite is transport-class:
            # retryable, so the backoff loop re-resolves
            raise EdlCoordError(f"data client {self._name}: leader resolution failed: "
                                f"{e}") from e
        if not endpoint:
            raise EdlCoordError(f"data client {self._name}: leader endpoint unresolved")
        with self._lock:
            if self._closed:
                raise EdlCoordError(f"data client {self._name} is closed")
            if self._client is not None and self._client.endpoint == endpoint:
                return self._client
            old, self._client = self._client, RpcClient(endpoint, self._timeout)
            if old is not None:
                self._need_attach = True
                logger.warning("data leader failover %s -> %s (%s)", old.endpoint, endpoint,
                               self._name)
            client = self._client
        if old is not None:
            old.close()
        return client

    def _remaining(self, deadline: float) -> float:
        """Time left, also capped by the close deadline."""
        with self._lock:
            close_at = self._close_at
        if close_at is not None:
            deadline = min(deadline, close_at)
        return deadline - time.monotonic()

    # -- reattach ------------------------------------------------------------
    def _flag_reattach(self) -> None:
        with self._lock:
            self._need_attach = True

    def _note_incarnation(self, resp) -> None:
        """Flag only: the reattach runs at the head of the next call.  Run
        here, its RPC would sit in the caller's retry scope, and a transient
        failure of it would throw away a response already applied."""
        if not isinstance(resp, dict):
            return
        inc = resp.pop("inc", None)
        if inc is None:
            return
        with self._lock:
            prev, self._incarnation = self._incarnation, inc
        if prev is not None and prev != inc:
            logger.warning("data leader incarnation changed (%s -> %s); reattaching %s "
                           "on the next call", prev, inc, self._name)
            self._flag_reattach()

    def _maybe_reattach(self) -> None:
        """Run the reader's reattach handshake if one is pending; a second
        thread arriving for the same incident sees the bumped generation and
        skips."""
        if self._on_reattach is None:
            return
        with self._lock:
            if not self._need_attach:
                return
            gen = self._attach_gen
        with self._attach_lock:
            with self._lock:
                if not self._need_attach or self._attach_gen != gen:
                    return
            client = self._ensure_client()

            def raw_call(method: str, **kwargs):
                resp = client.call(method, _timeout=self._timeout, **kwargs)
                if isinstance(resp, dict):
                    inc = resp.pop("inc", None)
                    if inc is not None:
                        with self._lock:
                            self._incarnation = inc
                return resp

            self._on_reattach(raw_call)
            with self._lock:
                self._need_attach = False
                self._attach_gen += 1

    # -- the retry loop ------------------------------------------------------
    def call(self, op: str, _abort_if: "Callable[[], bool] | None" = None, **kwargs):
        """``_abort_if``, when set, is checked at the head of every attempt,
        after any pending reattach: a reattach can invalidate the op it
        interrupted (the producer's file was re-granted elsewhere, so a
        buffered ``report_batch_meta`` must not reach the successor).  Raises
        :class:`CallAborted` instead of delivering."""
        deadline = time.monotonic() + self._deadline
        delay = constants.data_backoff_init()
        attempt = 0
        while True:
            try:
                client = self._ensure_client(reresolve=attempt > 0)
                self._maybe_reattach()
                if _abort_if is not None and _abort_if():
                    raise CallAborted(op)
                remaining = self._remaining(deadline)
                if remaining <= 0:
                    raise EdlCoordError(f"data rpc {op} out of budget before dispatch")
                resp = client.call(op, _timeout=max(0.25, min(self._timeout, remaining)),
                                   **kwargs)
                self._note_incarnation(resp)
                return resp
            except EdlReaderGoneError:
                # the service has no state for this reader: a plain retry
                # loops on the same answer, so reattach (re-seed), then replay
                if self._on_reattach is None:
                    raise
                self._flag_reattach()
                if self._remaining(deadline) <= 0:
                    raise
                attempt += 1
            except EdlCoordError as e:
                attempt += 1
                # a transport failure may be the leader dying: whatever
                # answers next must restore our in-flight state first
                self._flag_reattach()
                remaining = self._remaining(deadline)
                if remaining <= 0:
                    raise EdlCoordError(f"data rpc {op} failed after retry budget "
                                        f"({self._deadline:.1f}s): {e}") from e
                time.sleep(min(self._rng.uniform(0, delay), remaining))
                delay = min(delay * 2, constants.data_backoff_max())

    # -- lifecycle -----------------------------------------------------------
    def close_after(self, deadline: float) -> None:
        """Cap every in-flight retry loop (and later call) to end within
        ``deadline`` seconds."""
        with self._lock:
            self._close_at = time.monotonic() + max(0.0, deadline)

    def close(self) -> None:
        with self._lock:
            self._closed = True
            client, self._client = self._client, None
        if client is not None:
            client.close()
