"""The serving front door: route, admit, hedge, fail over (the port of the
JAX package's ``gateway/gateway.py``; it drives replicas of either package
over their common poll wire).

A :class:`Gateway` accepts generate requests and drives them to completion
against the advertised replica fleet (:mod:`edl_tpu_torch.gateway.fleet`):

- **routing**: least loaded by live advert stats corrected with the
  gateway's own in-flight counts per replica (an advert is up to one
  refresh period stale); among comparable replicas the warmer paged-KV
  pool wins.  A ``session`` prefers the replica that adopted its migrated
  KV chain, then its consistent-hash ring owner, while routable;
- **admission control**: a bounded accepted set (``max_inflight``
  dispatching + ``max_queue`` waiting) and an optional token bucket
  (``rate``/``burst``); saturation rejects with
  :class:`EdlOverloadedError` carrying ``retry_after``;
- **hedging**: a request not done ``hedge_after_s`` after dispatch is
  re-issued on a second replica; the first finisher wins and the loser's
  buffer is released;
- **transparent failover**: a replica dying mid-request (transport error,
  drain refusal) is quarantined from routing and the request replayed on
  a survivor; once ``submit()`` returned a future, the request fails only
  on a request-level error or its deadline.

Every accepted request runs on one pool thread (bounded by
``max_inflight``); each replica attempt (a "leg") gets its own thread and
connection.  The JAX gateway's metrics and trace spans are observability
hooks, not ported (ROADMAP.md Queue 1 item 8): ``stats()`` carries the
counters instead (requests by outcome, rejects by reason, retries, hedges,
hedge wins) and ``latencies()`` the recent requests' latencies.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import math
import queue as queue_mod
import threading
import time
import uuid
from collections import Counter, deque
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np

from edl_tpu_torch.gateway.fleet import FleetView
from edl_tpu_torch.rpc import chunks
from edl_tpu_torch.rpc.client import RpcClient
from edl_tpu_torch.rpc.server import RpcServer
from edl_tpu_torch.utils import constants
from edl_tpu_torch.utils.exceptions import EdlCoordError, EdlOverloadedError, EdlUnavailableError

logger = logging.getLogger(__name__)

class _TokenBucket:
    """Non-blocking token bucket: ``take()`` returns 0.0 on grant, else
    the seconds until a token will exist (the caller's retry-after)."""

    def __init__(self, rate: float, burst: float):
        self.rate = float(rate)
        self.burst = max(1.0, float(burst) or math.ceil(rate))
        self._tokens = self.burst
        self._t = time.monotonic()
        self._lock = threading.Lock()

    def take(self) -> float:
        with self._lock:
            now = time.monotonic()
            self._tokens = min(self.burst,
                               self._tokens + (now - self._t) * self.rate)
            self._t = now
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return 0.0
            return (1.0 - self._tokens) / self.rate


@dataclasses.dataclass
class GatewayConfig:
    max_inflight: int = 64          # concurrently dispatching requests
    max_queue: int = 128            # admitted beyond that, awaiting a worker
    rate: float = 0.0               # requests/s token bucket; 0 = unlimited
    burst: float = 0.0              # bucket size (default: ceil(rate))
    hedge_after_s: float = 0.0      # 0 disables hedging
    request_timeout_s: float = 600.0
    wait_slice_s: float = 0.2       # serve_wait quantum (failure-detect bound)
    rpc_timeout_s: float = 10.0
    poll_period_s: float = dataclasses.field(default_factory=constants.gateway_poll_period)
    quarantine_s: float = dataclasses.field(default_factory=constants.gateway_quarantine)


class _GwRequest:
    __slots__ = ("id", "prompt", "max_new", "session", "future")

    def __init__(self, prompt: list[int], max_new: int, session: str | None):
        self.id = uuid.uuid4().hex
        self.prompt = prompt
        self.max_new = max_new
        self.session = session
        self.future: Future = Future()


class Gateway:
    """``submit(prompt_1d, max_new) -> Future[np.ndarray]`` over a
    leased replica fleet.  Use as a library front door in-process, or
    behind :class:`GatewayServer` over the wire."""

    def __init__(self, store, job_id: str, cfg: GatewayConfig | None = None):
        self.cfg = cfg or GatewayConfig()
        self.job_id = job_id
        self._fleet = FleetView(store, job_id, period=self.cfg.poll_period_s)
        self._pool = ThreadPoolExecutor(max_workers=self.cfg.max_inflight,
                                        thread_name_prefix="gw-req")
        self._adm_lock = threading.Lock()
        self._admitted = 0
        self._bucket = (_TokenBucket(self.cfg.rate, self.cfg.burst)
                        if self.cfg.rate > 0 else None)
        self._state_lock = threading.Lock()
        self._inflight: dict[str, int] = {}      # replica -> active legs
        self._quarantined: dict[str, float] = {}  # replica -> until (mono)
        self._closed = False
        # what the JAX gateway's metrics count, read through stats()
        self._counts: Counter = Counter()
        self._latencies: deque[float] = deque(maxlen=10_000)

    # -- public --------------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int, *,
               session: str | None = None) -> Future:
        """Admit one request or raise :class:`EdlOverloadedError` with a
        ``retry_after`` hint.  The returned future resolves to the
        generated tokens (np.int32) and survives replica death."""
        ids = np.asarray(prompt, np.int32).reshape(-1)
        if ids.size == 0:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        with self._adm_lock:
            if self._closed:
                raise RuntimeError("gateway closed")
            cap = self.cfg.max_inflight + self.cfg.max_queue
            if self._admitted >= cap:
                self._count("rejects_queue_full")
                raise EdlOverloadedError(
                    f"gateway saturated: {self._admitted} admitted "
                    f"(cap {cap}); retry_after=1.0", retry_after=1.0)
            if self._bucket is not None:
                ra = self._bucket.take()
                if ra > 0.0:
                    self._count("rejects_rate")
                    raise EdlOverloadedError(
                        f"rate limit {self.cfg.rate}/s exceeded; "
                        f"retry_after={ra:.3f}", retry_after=ra)
            self._admitted += 1
        req = _GwRequest(ids.tolist(), int(max_new_tokens), session)
        try:
            self._pool.submit(self._run, req)
        except BaseException:
            with self._adm_lock:
                self._admitted -= 1
            raise
        return req.future

    def generate(self, prompt, max_new_tokens: int, *,
                 session: str | None = None,
                 timeout: float | None = None) -> np.ndarray:
        """Blocking convenience wrapper around :meth:`submit`."""
        return self.submit(prompt, max_new_tokens,
                           session=session).result(timeout)

    def stats(self) -> dict:
        reps = self._fleet.replicas()
        with self._adm_lock:
            admitted = self._admitted
        with self._state_lock:
            now = time.monotonic()
            quarantined = sorted(r for r, t in self._quarantined.items()
                                 if t > now)
            inflight = dict(self._inflight)
            counts = dict(self._counts)
        return {"replicas": reps, "admitted": admitted,
                "inflight": inflight, "quarantined": quarantined, "counts": counts}

    def latencies(self) -> list[float]:
        """Seconds from admission to resolution of the last 10,000 resolved
        requests, in the order they resolved."""
        with self._state_lock:
            return list(self._latencies)

    def _count(self, name: str) -> None:
        with self._state_lock:
            self._counts[name] += 1

    def wait_for_replicas(self, n: int, timeout: float = 60.0) -> bool:
        return self._fleet.wait_for(n, timeout)

    def close(self) -> None:
        with self._adm_lock:
            self._closed = True
        self._fleet.stop()
        self._pool.shutdown(wait=False)

    # -- routing -------------------------------------------------------------
    def _pick(self, session: str | None,
              exclude: set[str]) -> tuple[str, dict] | None:
        """Choose a routable replica: the session's migration pin (the
        replica that adopted its KV chain on a drain) if routable, else
        the session ring owner, else least loaded by ``queue_depth +
        gateway legs - free_slots`` (advert staleness corrected by our
        own assignment counts)."""
        reps = self._fleet.replicas()
        now = time.monotonic()
        with self._state_lock:
            self._quarantined = {r: t for r, t in self._quarantined.items()
                                 if t > now}
            quarantined = set(self._quarantined)
            inflight = dict(self._inflight)
        cands = {rid: p for rid, p in reps.items()
                 if rid not in exclude and rid not in quarantined
                 and not p.get("draining")}
        if not cands:
            return None
        if session is not None:
            pinned = self._fleet.session_pin(session)
            if pinned is not None and pinned in cands:
                return pinned, cands[pinned]
            pref = self._fleet.ring.get_node(session)
            if pref in cands:
                return pref, cands[pref]

        def load(rid: str):
            p = cands[rid]
            # primary: least loaded (advert stats corrected by our own
            # leg counts).  Among otherwise-comparable replicas, prefer
            # the warmer paged-KV cache: a higher advertised prefix hit
            # rate, then more free KV blocks — a request landing on a
            # warm replica skips most of its prefill (serving/kv_cache)
            try:
                kv_hit = -float(p.get("kv_prefix_hit_rate") or 0.0)
                kv_free = -int(p.get("kv_blocks_free") or 0)
            except (TypeError, ValueError):
                kv_hit, kv_free = 0.0, 0
            return (int(p.get("queue_depth", 0)) + inflight.get(rid, 0)
                    - int(p.get("free_slots", 0)), inflight.get(rid, 0),
                    kv_hit, kv_free, rid)

        rid = min(cands, key=load)
        return rid, cands[rid]

    def _quarantine(self, replica_id: str) -> None:
        self._fleet.drop(replica_id)
        with self._state_lock:
            self._quarantined[replica_id] = (time.monotonic()
                                             + self.cfg.quarantine_s)

    # -- the request loop ----------------------------------------------------
    def _run(self, req: _GwRequest) -> None:
        t0 = time.monotonic()
        deadline = t0 + self.cfg.request_timeout_s
        hedge_at = (t0 + self.cfg.hedge_after_s
                    if self.cfg.hedge_after_s > 0 else math.inf)
        results: queue_mod.Queue = queue_mod.Queue()
        winner = threading.Event()
        hedge_legs: set[str] = set()
        active = 0
        tried: set[str] = set()
        err: Exception | None = None
        try:
            while not req.future.done():
                now = time.monotonic()
                if now >= deadline:
                    err = err or TimeoutError(
                        f"request {req.id[:8]} exceeded "
                        f"{self.cfg.request_timeout_s}s deadline")
                    break
                if active == 0:
                    picked = self._pick(req.session, tried)
                    if picked is None and tried:
                        tried = set()   # all replicas tried once: start over
                        picked = self._pick(req.session, tried)
                    if picked is None:
                        # fleet momentarily empty (resize, mass preempt):
                        # keep watching until the deadline — an admitted
                        # request outlives a fleet gap
                        self._fleet.refresh()
                        time.sleep(min(self.cfg.poll_period_s,
                                       max(0.01, deadline - now)))
                        continue
                    rid, _ = picked
                    tried.add(rid)
                    self._launch(req, rid, picked[1]["endpoint"], winner,
                                 results, deadline, hedged=False)
                    active += 1
                wait_until = min(deadline, hedge_at)
                try:
                    kind, rid, val = results.get(
                        timeout=max(0.01, wait_until - time.monotonic()))
                except queue_mod.Empty:
                    if time.monotonic() >= hedge_at and active == 1:
                        picked = self._pick(req.session, tried)
                        if picked is None:
                            # no second replica routable right now
                            # (quarantine, drain): re-arm rather than
                            # forfeit hedging for the request's lifetime
                            hedge_at = (time.monotonic()
                                        + self.cfg.hedge_after_s)
                        else:
                            hedge_at = math.inf      # hedge once
                            rid, payload = picked
                            tried.add(rid)
                            hedge_legs.add(rid)
                            self._count("hedges")
                            self._launch(req, rid, payload["endpoint"],
                                         winner, results, deadline,
                                         hedged=True)
                            active += 1
                    continue
                active -= 1
                if kind == "ok":
                    winner.set()
                    if rid in hedge_legs:
                        self._count("hedge_wins")
                    self._resolve(req, t0, val)
                    return
                if kind == "moved":
                    # replica-level failure: quarantine + replay elsewhere
                    err = val
                    self._quarantine(rid)
                    self._count("retries")
                    logger.info("request %s replayed after %s failed: %s", req.id[:8], rid,
                                f"{type(val).__name__}: {val}"[:200])
                    continue
                err = val            # request-level error
                if active == 0:
                    break            # no other leg can still save it
        except BaseException as e:  # noqa: BLE001 — future must resolve
            err = e
        finally:
            winner.set()
            if not req.future.done():
                self._resolve(req, t0, err=err or RuntimeError("gateway request dropped"))

    def _resolve(self, req: _GwRequest, t0: float, val=None,
                 err: BaseException | None = None) -> None:
        """Free the request's admission, count it, then resolve its future
        (in that order, so a caller woken by the future sees both)."""
        with self._adm_lock:
            self._admitted -= 1
        with self._state_lock:
            self._latencies.append(time.monotonic() - t0)
            self._counts["requests_ok" if err is None else "requests_error"] += 1
        if err is None:
            req.future.set_result(val)
        else:
            req.future.set_exception(err)

    def _launch(self, req: _GwRequest, rid: str, endpoint: str,
                winner: threading.Event, results: queue_mod.Queue,
                deadline: float, hedged: bool) -> None:
        with self._state_lock:
            self._inflight[rid] = self._inflight.get(rid, 0) + 1

        def leg():
            try:
                out = self._attempt(req, endpoint, winner, deadline)
                if out is None:                # winner elsewhere; released
                    results.put(("cancelled", rid, None))
                else:
                    results.put(("ok", rid, out))
            except (EdlCoordError, EdlUnavailableError,
                    EdlOverloadedError) as e:
                results.put(("moved", rid, e))
            except Exception as e:  # noqa: BLE001 — leg must report, not die
                results.put(("err", rid, e))
            finally:
                with self._state_lock:
                    n = self._inflight.get(rid, 1) - 1
                    if n <= 0:
                        self._inflight.pop(rid, None)
                    else:
                        self._inflight[rid] = n

        threading.Thread(target=leg, daemon=True,
                         name=f"gw-leg:{rid[:8]}{'-hedge' if hedged else ''}").start()

    def _attempt(self, req: _GwRequest, endpoint: str,
                 winner: threading.Event,
                 deadline: float) -> np.ndarray | None:
        """One replica attempt over its own connection: submit, poll
        ``serve_wait`` in bounded slices (so a winner elsewhere or a
        dead replica is noticed within one slice), then chunk-fetch the
        token buffer and release it.  Returns None when cancelled."""
        with RpcClient(endpoint, timeout=self.cfg.rpc_timeout_s) as client:
            # the session key rides to the replica so a paged-KV engine
            # can pin the conversation's chain (omitted when absent:
            # pre-session replicas keep working)
            extra = ({"session": req.session}
                     if req.session is not None else {})
            client.call("serve_submit", request_id=req.id,
                        prompt=req.prompt, max_new=req.max_new, **extra)
            while True:
                if winner.is_set():
                    self._release(client, req.id)
                    return None
                if time.monotonic() >= deadline:
                    self._release(client, req.id)
                    raise TimeoutError("request deadline passed in flight")
                r = client.call("serve_wait", request_id=req.id,
                                timeout=self.cfg.wait_slice_s,
                                _timeout=self.cfg.rpc_timeout_s
                                + self.cfg.wait_slice_s)
                if r.get("done"):
                    break
            data = chunks.fetch_bytes(
                functools.partial(client.call, "serve_fetch",
                                  request_id=req.id), int(r["nbytes"]))
            self._release(client, req.id)
            return np.frombuffer(data, np.int32)

    @staticmethod
    def _release(client: RpcClient, request_id: str) -> None:
        try:
            client.call("serve_release", request_id=request_id)
        except Exception as e:  # noqa: BLE001 — result TTL evicts anyway
            logger.debug("release of %s failed (%s); the replica's "
                         "result TTL evicts it", request_id[:8], e)


class GatewayServer:
    """The gateway behind the EDL1 RPC wire (``gate_generate`` /
    ``gate_stats``).  One request per client connection is in flight at
    a time (thread-per-connection server); clients wanting pipelining
    open more connections or use the in-process :class:`Gateway`."""

    def __init__(self, store, job_id: str, cfg: GatewayConfig | None = None,
                 host: str = "0.0.0.0", port: int = 0):
        self.gateway = Gateway(store, job_id, cfg)
        self._rpc = RpcServer(host=host, port=port)
        self._rpc.register("gate_generate", self._gate_generate)
        self._rpc.register("gate_stats", self.gateway.stats)
        self._rpc.start()
        self.endpoint = self._rpc.endpoint
        logger.info("gateway for job %s on %s", job_id, self.endpoint)

    def _gate_generate(self, prompt, max_new: int, session: str | None = None,
                       timeout: float | None = None) -> dict:
        toks = self.gateway.generate(prompt, max_new, session=session,
                                     timeout=timeout)
        return {"tokens": [int(t) for t in toks]}

    def stop(self) -> None:
        self._rpc.stop()
        self.gateway.close()


def main(argv: list[str] | None = None) -> None:
    """``python -m edl_tpu_torch.gateway``: the front door of a job's fleet.
    Its first line is ``[edl-gateway] serving on <host:port>``; clients
    call ``gate_generate(prompt, max_new, session=None)`` over the EDL1
    wire.  The gateway runs no model, so it needs no card."""
    import argparse

    from edl_tpu_torch.coord.client import connect

    p = argparse.ArgumentParser("edl_tpu_torch.gateway")
    p.add_argument("--coord_endpoints", required=True)
    p.add_argument("--job_id", required=True)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--max_inflight", type=int, default=64)
    p.add_argument("--max_queue", type=int, default=128)
    p.add_argument("--rate", type=float, default=0.0)
    p.add_argument("--burst", type=float, default=0.0)
    p.add_argument("--hedge_after", type=float, default=0.0)
    p.add_argument("--request_timeout", type=float, default=600.0)
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    cfg = GatewayConfig(max_inflight=args.max_inflight,
                        max_queue=args.max_queue, rate=args.rate,
                        burst=args.burst, hedge_after_s=args.hedge_after,
                        request_timeout_s=args.request_timeout)
    server = GatewayServer(connect(args.coord_endpoints), args.job_id,
                           cfg, host=args.host, port=args.port)
    print(f"[edl-gateway] serving on {server.endpoint}", flush=True)
    try:
        threading.Event().wait()
    finally:
        server.stop()


if __name__ == "__main__":
    main()
