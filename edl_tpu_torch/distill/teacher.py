"""Teacher server: batched inference behind the EDL1 wire (the port of the
JAX package's ``distill/teacher.py``).

Requests from many students are coalesced: RPC threads enqueue their
rows, one inference thread drains the queue into the largest fitting
batch bucket, pads it to the bucket, calls ``predict_fn`` and fans the
rows back out, so concurrent students share forward passes.  Requests
whose feeds differ in keys, per-row shapes or dtypes are served in
separate passes.  A server registers under its service in the
coordination store on a TTL lease, its advert value the live ``stats()``
payload, refreshed every ``advert_period`` seconds.  A server built
without a ``host`` advertises the interface that routes to the store.

The inference thread enters ``torch.inference_mode`` and, given a CUDA
``device``, makes it the thread's current device: both are per thread,
and a fresh thread has neither.

Not ported: ``jit_teacher`` (a flax apply behind the wire), whose
counterpart waits for the first non-LM teacher (ROADMAP.md Queue 1
item 5), and the shared multi-key session of ``register``.
"""

from __future__ import annotations

import json
import logging
import queue
import threading
import time
from typing import Callable

import numpy as np
import torch

from edl_tpu_torch.coord.register import leased_register
from edl_tpu_torch.distill.balance import server_key
from edl_tpu_torch.distill.predict_client import decode_array, encode_array
from edl_tpu_torch.rpc.server import RpcServer
from edl_tpu_torch.utils import constants
from edl_tpu_torch.utils.device import enter_device
from edl_tpu_torch.utils.exceptions import EdlUnavailableError
from edl_tpu_torch.utils.network import local_ip

logger = logging.getLogger(__name__)

DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32, 64)


class _Request:
    __slots__ = ("arrays", "fetch", "n", "done", "out", "error")

    def __init__(self, arrays: dict, fetch: list[str], n: int):
        self.arrays = arrays
        self.fetch = fetch
        self.n = n
        self.done = threading.Event()
        self.out: dict[str, np.ndarray] | None = None
        self.error: Exception | None = None


class TeacherServer:
    """Serve ``predict_fn(feed_dict) -> fetch_dict``; padding, bucketing and
    coalescing are handled here, so ``predict_fn`` always sees one of
    ``buckets`` batch sizes.  ``device``: the inference thread's current
    device."""

    def __init__(self, predict_fn: Callable[[dict], dict], host: str | None = None,
                 port: int = 0, buckets: tuple[int, ...] = DEFAULT_BUCKETS,
                 coalesce_wait_ms: float = 2.0,
                 extra_stats: Callable[[], dict] | None = None,
                 device: torch.device | str | None = None):
        self._predict_fn = predict_fn
        self._extra_stats = extra_stats
        self._buckets = tuple(sorted(buckets))
        self._wait = coalesce_wait_ms / 1000.0
        self._device = device
        self._queue: queue.Queue[_Request | None] = queue.Queue()
        self._stopping = False
        # makes check-stopping + enqueue atomic against stop()'s drain
        self._enqueue_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self._rows = 0
        self._forwards = 0
        self._requests = 0
        self._busy_s = 0.0
        self._t0 = time.monotonic()
        self._worker = threading.Thread(target=self._serve_loop, daemon=True,
                                        name="teacher-infer")
        self._worker.start()
        self._rpc = RpcServer(host="0.0.0.0", port=port)
        self._rpc.register("predict", self._predict)
        self._rpc.register("ping", lambda: {"pong": True})
        self._rpc.register("stats", self.stats)
        self._rpc.start()
        self._host = host
        self.endpoint = f"{host or local_ip()}:{self._rpc.port}"
        self._register = None
        self._advert_halt = threading.Event()
        self._advert_thread: threading.Thread | None = None
        logger.info("teacher server on %s (buckets %s)", self.endpoint, self._buckets)

    # -- registration --------------------------------------------------------
    def register(self, store, service: str, ttl: float | None = None,
                 advert_period: float | None = None) -> "TeacherServer":
        """TTL-leased registration under the service's balance prefix; the
        advert's value is the live ``stats()`` payload, republished every
        ``advert_period`` seconds."""
        if self._host is None:
            self.endpoint = f"{local_ip(getattr(store, 'endpoint', None))}:{self._rpc.port}"
        self._register = leased_register(store, server_key(service, self.endpoint),
                                         self._advert_value(), ttl=ttl)
        period = (constants.distill_advert_period() if advert_period is None
                  else float(advert_period))
        self._advert_thread = threading.Thread(target=self._advert_loop, args=(period,),
                                               daemon=True, name="teacher-advert")
        self._advert_thread.start()
        return self

    def _advert_value(self) -> bytes:
        return json.dumps({"endpoint": self.endpoint, **self.stats()}).encode()

    def _advert_loop(self, period: float) -> None:
        while not self._advert_halt.wait(period):
            reg = self._register
            if reg is None or reg.is_stopped:
                continue
            try:
                reg.update(self._advert_value())
            except Exception as e:  # noqa: BLE001 — the session heals
                logger.warning("teacher advert refresh failed: %s", e)

    # -- RPC side ------------------------------------------------------------
    def _predict(self, feed: dict, fetch: list[str]) -> dict:
        arrays = {k: decode_array(v) for k, v in feed.items()}
        req = _Request(arrays, list(fetch), len(next(iter(arrays.values()))))
        with self._enqueue_lock:
            # typed and retryable, so a student routes to another teacher
            if self._stopping:
                raise EdlUnavailableError("teacher server stopping")
            self._queue.put(req)
        req.done.wait()
        if req.error is not None:
            raise req.error
        assert req.out is not None
        return {"out": {name: encode_array(a) for name, a in req.out.items()}}

    # -- inference side ------------------------------------------------------
    def _serve_loop(self) -> None:
        enter_device(self._device)
        with torch.inference_mode():
            while True:
                req = self._queue.get()
                if req is None:
                    return
                batch = [req]
                rows = req.n
                # coalesce briefly: rows from waiting students share a pass
                deadline = time.monotonic() + self._wait
                while rows < self._buckets[-1]:
                    try:
                        nxt = self._queue.get(timeout=max(0.0, deadline - time.monotonic()))
                    except queue.Empty:
                        break
                    if nxt is None:
                        self._finish(batch, self._infer_safe(batch))
                        return
                    batch.append(nxt)
                    rows += nxt.n
                self._finish(batch, self._infer_safe(batch))

    def _infer_safe(self, batch: list[_Request]):
        try:
            return self._infer(batch)
        except Exception as e:  # noqa: BLE001 — fan the error out
            return e

    def _infer(self, batch: list[_Request]) -> list[dict]:
        def sig(r: _Request):
            return {k: (a.shape[1:], a.dtype.str) for k, a in r.arrays.items()}

        keys = sorted(batch[0].arrays)
        fetch = batch[0].fetch
        sig0 = sig(batch[0])
        for r in batch[1:]:
            if sorted(r.arrays) != keys or r.fetch != fetch or sig(r) != sig0:
                # mixed feed keys or per-row shapes/dtypes: serve apart
                return self._infer(batch[:1]) + self._infer(batch[1:])
        arrays = {k: np.concatenate([r.arrays[k] for r in batch]) for k in keys}
        n = sum(r.n for r in batch)
        t0 = time.monotonic()
        out: dict[str, list[np.ndarray]] = {name: [] for name in fetch}
        done = forwards = 0
        while done < n:
            take = min(n - done, self._buckets[-1])
            bucket = self._bucket(take)
            chunk = {k: _pad_to(a[done:done + take], bucket) for k, a in arrays.items()}
            preds = self._predict_fn(chunk)
            forwards += 1
            for name in fetch:
                if name not in preds:
                    raise KeyError(f"teacher fetch {name!r} not produced (has {sorted(preds)})")
                out[name].append(np.asarray(preds[name])[:take])
            done += take
        full = {name: np.concatenate(parts) for name, parts in out.items()}
        with self._stats_lock:
            self._rows += n
            self._requests += len(batch)
            self._forwards += forwards
            self._busy_s += time.monotonic() - t0
        results, at = [], 0
        for r in batch:
            results.append({name: a[at:at + r.n] for name, a in full.items()})
            at += r.n
        return results

    def _finish(self, batch: list[_Request], results) -> None:
        if isinstance(results, Exception):
            for r in batch:
                r.error = results
                r.done.set()
            return
        for r, out in zip(batch, results):
            r.out = out
            r.done.set()

    def _bucket(self, n: int) -> int:
        return next((b for b in self._buckets if n <= b), self._buckets[-1])

    # -- observability -------------------------------------------------------
    def stats(self) -> dict:
        with self._stats_lock:
            dt = max(1e-9, time.monotonic() - self._t0)
            out = {"rows": self._rows, "requests": self._requests,
                   "forward_passes": self._forwards, "busy_s": round(self._busy_s, 3),
                   "uptime_s": round(dt, 3), "rows_per_s": round(self._rows / dt, 1),
                   "queue_depth": self._queue.qsize()}
        if self._extra_stats is not None:
            try:
                out.update(self._extra_stats())
            except Exception:  # noqa: BLE001 — stats must never fail
                logger.exception("extra_stats failed")
        return out

    def stop(self) -> None:
        self._advert_halt.set()
        if self._advert_thread is not None:
            self._advert_thread.join(timeout=2.0)
        if self._register is not None:
            self._register.stop()
        # refuse new enqueues first (the lock makes check + put atomic, so
        # nothing races in behind the drain), then stop the worker and
        # release anything already queued
        with self._enqueue_lock:
            self._stopping = True
        self._queue.put(None)
        self._worker.join(timeout=5.0)
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            if req is not None:
                req.error = RuntimeError("teacher server stopped")
                req.done.set()
        self._rpc.stop()


def _pad_to(a: np.ndarray, n: int) -> np.ndarray:
    if len(a) == n:
        return a
    return np.concatenate([a, np.zeros((n - len(a),) + a.shape[1:], a.dtype)])


def lm_teacher(engine, max_new: int = 8) -> Callable[[dict], dict]:
    """A teacher ``predict_fn`` over a serving ``ContinuousBatcher``: feed
    ``{"ids": [B, L] int32, "lens": [B] int32}``, fetch ``{"tokens": [B,
    max_new] int32}`` (rows right-padded with -1).  Rows go to the engine
    as separate submits, and its slot scheduler batches them; zero-length
    rows (the server's bucket padding) cost one 1-token prompt each and
    are sliced off by the server."""
    def predict(feed: dict) -> dict:
        ids = np.asarray(feed["ids"], np.int32)
        lens = np.asarray(feed["lens"], np.int32).reshape(-1)
        futs = [engine.submit(row[:max(1, int(n))], max_new) for row, n in zip(ids, lens)]
        out = np.full((len(ids), max_new), -1, np.int32)
        for i, f in enumerate(futs):
            toks = np.asarray(f.result(), np.int32)[:max_new]
            out[i, :len(toks)] = toks
        return {"tokens": out}

    return predict
