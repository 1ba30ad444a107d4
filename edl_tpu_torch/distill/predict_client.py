"""Teacher RPC client: feed arrays in, prediction arrays out (the port of
the JAX package's ``distill/predict_client.py``).

Arrays cross the EDL1 wire as ``{"d": dtype, "s": shape, "b": bytes}``;
``predict`` tries ``retries`` times before it declares the teacher dead.
The first calls get ``first_timeout`` (a teacher's first calls per batch
bucket may compile or warm up), later ones ``timeout``.
:class:`NopPredictClient` is the test stand-in that answers without a
server.
"""

from __future__ import annotations

import logging

import numpy as np

from edl_tpu_torch.rpc.client import RpcClient

logger = logging.getLogger(__name__)


def encode_array(a) -> dict:
    a = np.ascontiguousarray(a)
    return {"d": a.dtype.str, "s": list(a.shape), "b": a.tobytes()}


def decode_array(d: dict) -> np.ndarray:
    return np.frombuffer(d["b"], dtype=np.dtype(d["d"])).reshape(d["s"])


class TeacherClient:
    """One connection to one teacher server."""

    def __init__(self, endpoint: str, fetch: list[str], timeout: float = 45.0,
                 first_timeout: float = 180.0, retries: int = 2):
        self.endpoint = endpoint
        self._fetch = list(fetch)
        self._retries = retries
        self._cold_calls = 4  # the common batch buckets' first calls
        self._first_timeout = first_timeout
        self._rpc = RpcClient(endpoint, timeout)

    def predict(self, feed: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
        wire = {k: encode_array(v) for k, v in feed.items()}
        last: Exception | None = None
        for attempt in range(self._retries):
            # the cold budget is spent per attempt, success or not: a teacher
            # wedged in its first call falls through to the tight timeout
            cold = self._cold_calls > 0
            self._cold_calls -= 1
            try:
                r = self._rpc.call("predict", feed=wire, fetch=self._fetch,
                                   _timeout=self._first_timeout if cold else None)
                return {k: decode_array(v) for k, v in r["out"].items()}
            except Exception as e:  # noqa: BLE001
                last = e
                logger.warning("predict on %s failed (%d/%d): %s", self.endpoint,
                               attempt + 1, self._retries, e)
        raise ConnectionError(f"teacher {self.endpoint} failed: {last}")

    def close(self) -> None:
        self._rpc.close()


class NopPredictClient:
    """Test stand-in (reference _TestNopPaddlePredictServer,
    distill_worker.py:324-333): returns zeros shaped [n, 1] per fetch, so
    the whole pool runs with no server; ``fail_every`` raises on every
    n-th call."""

    def __init__(self, endpoint: str = "nop", fetch: list[str] | None = None,
                 fail_every: int = 0):
        self.endpoint = endpoint
        self._fetch = list(fetch or ["prediction"])
        self._fail_every = fail_every
        self._calls = 0

    def predict(self, feed: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
        self._calls += 1
        if self._fail_every and self._calls % self._fail_every == 0:
            raise ConnectionError(f"injected failure on call {self._calls}")
        n = len(next(iter(feed.values())))
        return {name: np.zeros((n, 1), np.float32) for name in self._fetch}

    def close(self) -> None:
        pass
