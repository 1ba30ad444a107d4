"""ReplicaServer: a ContinuousBatcher behind the EDL1 RPC wire, leased into
the gateway fleet (the port of the JAX package's ``serving/replica.py``;
its wire, advert and error names are the JAX package's, so a JAX gateway
routes to a port replica and the port's gateway to a JAX one).

One replica = one engine + one RPC server + one TTL-leased advert
(:mod:`edl_tpu_torch.gateway.fleet`) carrying live load stats.  The wire
is poll-based, so a gateway leg sees a replica die within one wait slice
and a long generation never holds a connection:

- ``serve_submit(request_id, prompt, max_new, session=None)``: enqueue
  (idempotent on ``request_id``: a gateway transport retry is safe);
- ``serve_wait(request_id, timeout)``: a bounded block; ``{"done":
  False}`` or ``{"done": True, "nbytes": N}``;
- ``serve_fetch(request_id, offset, length)``: chunk reads of the finished
  int32 token buffer (``rpc/chunks.fetch_bytes``);
- ``serve_release(request_id)``: drop the buffer (an ack, or a hedge
  loser's cancel; buffers nobody releases expire after
  ``EDL_TPU_SERVING_RESULT_TTL``);
- ``serve_stats`` / ``serve_drain``: introspection and graceful removal;
- ``serve_kv_import_begin`` / ``serve_kv_import_chunk``: a draining peer
  pushes a pinned session's KV chain here.

``drain()`` is the preemption path: refuse new submits
(:class:`EdlUnavailableError`; the advert flips ``draining`` so gateways
route elsewhere), finish what is queued and in flight, push every pinned
session chain to an adoptive replica, which re-pins the session in the
store so the gateway sends its next turn there, then release the lease.
The RPC server stays up until ``close()`` so finished buffers stay
fetchable.  The JAX replica's metric gauges are observability hooks, not
ported (ROADMAP.md Queue 1 item 8): the engine's stats ride the advert and
``serve_stats``, and the migration's counts ``serve_stats()["migration"]``.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import threading
import time
import uuid
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutureTimeout

import numpy as np

from edl_tpu_torch.coord.session import CoordSession
from edl_tpu_torch.gateway import fleet
from edl_tpu_torch.rpc.server import RpcServer
from edl_tpu_torch.utils import constants
from edl_tpu_torch.utils.exceptions import EdlCoordError, EdlInternalError, EdlUnavailableError
from edl_tpu_torch.utils.network import local_ip

logger = logging.getLogger(__name__)


class ReplicaServer:
    """Own the wire and the advert around one engine.  ``store`` is any
    KVStore (a ``MemoryKV`` in one process, a ``CoordClient`` in a job)."""

    # a migration push abandoned mid-stream (its exporter killed between
    # chunks) would park its partial blob forever; a minute is far beyond a
    # live push's gap between chunks
    _IMPORT_STAGING_TTL = 60.0

    def __init__(self, store, job_id: str, engine, *, replica_id: str | None = None,
                 host: str = "0.0.0.0", port: int = 0, ttl: float | None = None,
                 advert_period: float | None = None, result_ttl: float | None = None,
                 migrate_sessions: bool | None = None):
        self._engine = engine
        self._store = store
        self._job_id = job_id
        self._ttl = constants.etcd_ttl() if ttl is None else ttl
        self._migrate = constants.kv_migrate() if migrate_sessions is None else migrate_sessions
        self.replica_id = replica_id or f"{local_ip()}-{os.getpid()}-{uuid.uuid4().hex[:6]}"
        self._lock = threading.Lock()
        self._futures: dict[str, Future] = {}
        self._results: dict[str, tuple[bytes, float]] = {}  # rid -> (buf, t)
        self._result_ttl = constants.serving_result_ttl() if result_ttl is None else result_ttl
        self._draining = False
        self._drained = threading.Event()
        self._import_staging: dict[str, dict] = {}   # session -> staging
        self._session_pins: dict[str, object] = {}   # session -> pin handle
        self._pin_misses: dict[str, int] = {}        # pruner-thread-only state
        self.migration = {"sessions_out": 0, "blocks_out": 0, "bytes_out": 0, "seconds": 0.0,
                          "sessions_in": 0, "blocks_in": 0}
        self._rpc = RpcServer(host=host, port=port)
        for name in ("serve_submit", "serve_wait", "serve_fetch", "serve_release",
                     "serve_stats", "serve_drain", "serve_kv_import_begin",
                     "serve_kv_import_chunk"):
            self._rpc.register(name, getattr(self, name))
        self._rpc.start()
        self.endpoint = (self._rpc.endpoint if host not in ("", "0.0.0.0")
                         else f"{local_ip(getattr(store, 'endpoint', None))}:{self._rpc.port}")
        # one shared lease for the advert and every session pin: an adopting
        # replica must not mint a keep-alive thread and a lease per session
        self._coord_session = CoordSession(store, ttl=self._ttl,
                                           name=f"replica:{self.replica_id[:8]}")
        self._register = fleet.advertise(store, job_id, self.replica_id, self._payload(),
                                         session=self._coord_session)
        self._halt = threading.Event()
        period = constants.serving_advert_period() if advert_period is None else advert_period
        self._advert_thread = threading.Thread(target=self._refresh_loop, args=(period,),
                                               daemon=True,
                                               name=f"replica-advert:{self.replica_id[:8]}")
        self._advert_thread.start()
        logger.info("replica %s serving on %s", self.replica_id, self.endpoint)

    # -- wire surface --------------------------------------------------------
    def serve_submit(self, request_id: str, prompt, max_new: int,
                     session: str | None = None) -> dict:
        with self._lock:
            if self._draining:
                raise EdlUnavailableError(f"replica {self.replica_id} draining")
            if request_id in self._futures or request_id in self._results:
                return {"ok": True}      # an idempotent transport retry
        # session rides as a keyword only when present, so engines without
        # chain pinning keep their signature
        kwargs = {} if session is None else {"session": session}
        try:
            fut = self._engine.submit(np.asarray(prompt, np.int32), int(max_new), **kwargs)
        except RuntimeError as e:
            # the engine is draining or stopping: go elsewhere
            raise EdlUnavailableError(str(e)) from e
        with self._lock:
            self._futures[request_id] = fut
        return {"ok": True}

    def serve_wait(self, request_id: str, timeout: float = 0.2) -> dict:
        with self._lock:
            buf = self._results.get(request_id)
            fut = self._futures.get(request_id)
        if buf is not None:
            return {"done": True, "nbytes": len(buf[0])}
        if fut is None:
            raise EdlInternalError(f"unknown request {request_id}")
        try:
            toks = fut.result(timeout=min(float(timeout), 30.0))
        except FutureTimeout:
            return {"done": False}
        except RuntimeError as e:
            with self._lock:
                self._futures.pop(request_id, None)
            # "engine stopped mid-generation" and the like: the work is not
            # coming; retryable, so the gateway replays it elsewhere
            raise EdlUnavailableError(str(e)) from e
        except Exception as e:
            with self._lock:
                self._futures.pop(request_id, None)
            raise EdlInternalError(f"generation failed: {type(e).__name__}: {e}") from e
        data = np.asarray(toks, np.int32).tobytes()
        with self._lock:
            self._futures.pop(request_id, None)
            self._results[request_id] = (data, time.monotonic())
        return {"done": True, "nbytes": len(data)}

    def serve_fetch(self, request_id: str, offset: int, length: int) -> bytes:
        with self._lock:
            buf = self._results.get(request_id)
        if buf is None:
            raise EdlInternalError(f"no result for request {request_id}")
        return buf[0][int(offset):int(offset) + int(length)]

    def serve_release(self, request_id: str) -> dict:
        # a hedge loser cancelled mid-generation: its lane still finishes,
        # and its output is dropped on arrival (nothing tracks it any more)
        with self._lock:
            self._results.pop(request_id, None)
            self._futures.pop(request_id, None)
        return {"ok": True}

    def serve_stats(self) -> dict:
        with self._lock:
            tracked = len(self._futures) + len(self._results)
            draining = self._draining
            migration = dict(self.migration)
        return {"replica": self.replica_id, "endpoint": self.endpoint, "draining": draining,
                "tracked_requests": tracked, "engine": self._engine.stats(),
                "migration": migration}

    def serve_drain(self, timeout: float | None = None) -> dict:
        """Start a graceful drain in the background and return at once (the
        caller may be a preempting launcher on its grace budget)."""
        threading.Thread(target=self.drain, args=(timeout,), daemon=True,
                         name=f"replica-drain:{self.replica_id[:8]}").start()
        return {"ok": True}

    def serve_kv_import_begin(self, session: str, tokens: list, meta: dict,
                              nbytes: int) -> dict:
        """Open a staging buffer for one migrated session chain, pushed by
        a draining peer.  Refused at once when this engine cannot adopt it,
        and the exporter then lets the session cold-start."""
        if getattr(self._engine, "import_session", None) is None or \
                not self._engine.stats().get("kv_block"):
            raise EdlUnavailableError(f"replica {self.replica_id} has no paged KV cache; "
                                      "session migration refused")
        with self._lock:
            if self._draining:
                raise EdlUnavailableError(f"replica {self.replica_id} draining; cannot adopt")
            self._import_staging[session] = {
                "tokens": [int(t) for t in tokens], "meta": meta, "nbytes": int(nbytes),
                "buf": bytearray(), "seq": 0, "t": time.monotonic()}
        return {"ok": True}

    def serve_kv_import_chunk(self, session: str, seq: int, data, eof: bool) -> dict:
        """One ordered chunk of a chain's blob; at ``eof`` the chain lands
        on the engine thread, the session is pinned here, and its store pin
        (the gateway's routing record) is published."""
        with self._lock:
            st = self._import_staging.get(session)
            if st is None:
                raise EdlInternalError(f"no kv import in progress for session {session}")
            if int(seq) != st["seq"]:
                del self._import_staging[session]
                raise EdlInternalError(f"kv import chunk {seq} out of order (want {st['seq']})")
            st["seq"] += 1
            st["t"] = time.monotonic()
            st["buf"].extend(data)
            if not eof:
                return {"ok": True}
            del self._import_staging[session]
        if len(st["buf"]) != st["nbytes"]:
            raise EdlInternalError(f"kv import for {session}: {len(st['buf'])} of "
                                   f"{st['nbytes']} bytes at eof")
        try:
            blocks = self._engine.import_session(session, st["tokens"], st["meta"],
                                                 bytes(st["buf"]))
        except (RuntimeError, ValueError, TimeoutError) as e:
            raise EdlUnavailableError(f"kv import failed on {self.replica_id}: {e}") from e
        self._pin_session(session)
        with self._lock:
            self.migration["sessions_in"] += 1
            self.migration["blocks_in"] += blocks
        return {"ok": True, "blocks": blocks}

    def _pin_session(self, session: str) -> None:
        """Publish (or refresh) the store pin mapping this session here."""
        with self._lock:
            old = self._session_pins.pop(session, None)
        if old is not None:
            old.stop()
        handle = fleet.pin_session(self._store, self._job_id, session, self.replica_id,
                                   coord_session=self._coord_session)
        with self._lock:
            self._session_pins[session] = handle

    # -- lifecycle -----------------------------------------------------------
    def drain(self, timeout: float | None = None) -> bool:
        """Stop admission, advertise ``draining``, finish queued and
        in-flight requests, migrate the pinned sessions, then release the
        lease.  The RPC server stays up until :meth:`close`."""
        with self._lock:
            already = self._draining
            self._draining = True
        if already:
            return self._drained.wait(timeout)
        try:
            self._register.update(json.dumps(self._payload()).encode())
        except Exception as e:  # noqa: BLE001 — the lease expires a stale advert
            logger.debug("draining-advert refresh failed (%s)", e)
        ok = self._engine.drain(timeout)
        if ok and self._migrate:
            try:
                self._migrate_sessions()
            except Exception:  # noqa: BLE001 — a failed handoff costs a cold prefill
                logger.exception("session KV migration failed; sessions will cold-start "
                                 "on their next turn")
        self._stop_session_pins()
        self._halt.set()
        self._register.stop()
        self._drained.set()
        logger.info("replica %s drained (complete=%s)", self.replica_id, ok)
        return ok

    def _stop_session_pins(self) -> None:
        with self._lock:
            pins, self._session_pins = self._session_pins, {}
        for handle in pins.values():
            try:
                handle.stop()
            except Exception as e:  # noqa: BLE001 — teardown
                logger.debug("session pin release failed: %s", e)

    def _migrate_sessions(self) -> None:
        """Export every pinned session chain from the stopped engine and
        push each to an adoptive replica over the chunked wire; the adopter
        pins the session in the store.  A failure is per session: a refused
        or broken push means that session cold-starts, never a stuck drain."""
        from edl_tpu_torch.rpc import chunks
        from edl_tpu_torch.rpc.client import RpcClient

        export = getattr(self._engine, "export_sessions", None)
        if export is None:
            return
        t0 = time.monotonic()
        exported = export()
        if not exported:
            return
        # release our pins first, so the adopter's is the only one left
        self._stop_session_pins()
        replicas = fleet.list_replicas(self._store, self._job_id)
        # only paged peers can adopt; the advert carries kv_block for that
        cands = {rid: p for rid, p in replicas.items()
                 if rid != self.replica_id and not p.get("draining") and p.get("kv_block")}
        if not cands:
            logger.warning("no paged adoptive replica for %d session chains; they will "
                           "cold-start", len(exported))
            return
        ranked = sorted(cands, key=lambda r: (int(cands[r].get("queue_depth", 0))
                                              - int(cands[r].get("free_slots", 0)), r))
        moved = 0
        # one connection per candidate for the whole loop
        clients: dict[str, RpcClient] = {}
        try:
            for session, tokens, meta, blob in exported:
                target = None
                for cand in list(ranked):   # a refusal tries the next peer
                    try:
                        client = clients.get(cand)
                        if client is None:
                            client = clients[cand] = RpcClient(cands[cand]["endpoint"],
                                                               timeout=10.0)
                        client.call("serve_kv_import_begin", session=session, tokens=tokens,
                                    meta=meta, nbytes=len(blob))
                        chunks.push_bytes(lambda **kw: client.call(
                            "serve_kv_import_chunk", session=session, **kw), blob)
                        target = cand
                        break
                    except EdlCoordError as e:
                        # the peer is dead or hung: later sessions must not
                        # pay its timeout again
                        client = clients.pop(cand, None)
                        if client is not None:
                            client.close()
                        ranked.remove(cand)
                        logger.warning("session %s migration to %s failed (%s); peer "
                                       "dropped", session, cand, e)
                    except Exception as e:  # noqa: BLE001 — this peer only
                        # a typed refusal (no paging, pool full, layout): the
                        # peer may still adopt a later, smaller chain
                        logger.warning("session %s migration to %s refused (%s)", session,
                                       cand, e)
                if target is None:
                    logger.warning("session %s found no adopter; it will cold-start", session)
                    continue
                moved += 1
                with self._lock:
                    self.migration["sessions_out"] += 1
                    self.migration["blocks_out"] += int(meta["n"])
                    self.migration["bytes_out"] += len(blob)
        finally:
            for client in clients.values():
                client.close()
            with self._lock:
                self.migration["seconds"] += time.monotonic() - t0
        logger.info("replica %s migrated %d/%d session chains on drain", self.replica_id,
                    moved, len(exported))

    def close(self) -> None:
        """Hard teardown: advert gone, engine stopped (in-flight futures
        fail: :meth:`drain` first for a graceful removal)."""
        self._halt.set()
        self._advert_thread.join(timeout=5.0)
        self._stop_session_pins()
        self._register.stop()
        self._coord_session.close()
        self._engine.stop()
        self._rpc.stop()

    # -- internals -----------------------------------------------------------
    def _payload(self) -> dict:
        s = self._engine.stats()
        with self._lock:
            draining = self._draining
        payload = {"endpoint": self.endpoint, "slots": s["slots"],
                   "free_slots": s["slots"] - s["active_slots"],
                   "queue_depth": s["queue_depth"], "prefill_stall_s": s["prefill_stall_s"],
                   "tokens_per_s": s["tokens_per_s"], "max_prompt_len": s["max_prompt_len"],
                   "draining": draining, "ts": time.time()}
        if s.get("kv_block"):
            # how warm this replica's pool runs, for the gateway's routing
            admits = s["kv_prefix_hits"] + s["kv_prefix_misses"]
            payload["kv_block"] = s["kv_block"]
            payload["kv_blocks_free"] = s["kv_blocks_free"]
            payload["kv_prefix_hit_rate"] = (round(s["kv_prefix_hits"] / admits, 3)
                                             if admits else 0.0)
        if s.get("spec_k"):
            payload["spec_k"] = s["spec_k"]
            payload["spec_accept_rate"] = s["spec_accept_rate"]
        return payload

    def _refresh_loop(self, period: float) -> None:
        while not self._halt.wait(period):
            if not self._register.is_stopped:
                try:
                    self._register.update(json.dumps(self._payload()).encode())
                except Exception as e:  # noqa: BLE001 — the session self-heals
                    logger.warning("advert refresh failed: %s", e)
            self._evict_stale_results()
            self._prune_session_pins()

    def _prune_session_pins(self) -> None:
        """Drop the store pin of a session whose chain the engine has since
        unpinned (its session LRU): the pin would only misroute.  Pins are
        snapshotted before the engine is read, and one is dropped only
        after two consecutive periods absent, so a session re-pinned
        between the snapshot and the stop survives."""
        with self._lock:
            candidates = list(self._session_pins)
        if not candidates:
            return
        poll = getattr(self._engine, "kv_pinned_sessions", None)
        snap = poll() if poll is not None else None
        if snap is None:        # a racy read lost: retry next period
            return
        live = set(snap)
        misses = self._pin_misses
        for s in candidates:
            misses[s] = misses.get(s, 0) + 1 if s not in live else 0
        for s in [s for s in misses if s not in candidates or not misses[s]]:
            del misses[s]
        with self._lock:
            dead = {s: self._session_pins.pop(s) for s in candidates
                    if misses.get(s, 0) >= 2 and s in self._session_pins}
        for session, handle in dead.items():
            misses.pop(session, None)
            try:
                handle.stop()
            except Exception as e:  # noqa: BLE001 — the lease lapses it anyway
                logger.debug("pruned pin release for %s failed: %s", session, e)
            logger.info("session %s pin pruned (engine unpinned its chain)", session)

    def _evict_stale_results(self) -> None:
        cutoff = time.monotonic() - self._IMPORT_STAGING_TTL
        with self._lock:
            for session in [s for s, st in self._import_staging.items() if st["t"] < cutoff]:
                del self._import_staging[session]
                logger.warning("kv import for session %s abandoned mid-stream; staging "
                               "dropped", session)
        if not self._result_ttl:
            return
        cutoff = time.monotonic() - self._result_ttl
        with self._lock:
            for rid in [rid for rid, (_, t) in self._results.items() if t < cutoff]:
                del self._results[rid]


def parse_args(argv=None):

    p = argparse.ArgumentParser("edl_tpu_torch.serving.replica")
    p.add_argument("--coord_endpoints", required=True)
    p.add_argument("--job_id", required=True)
    p.add_argument("--replica_id", default=None)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--checkpoint_dir", default=None,
                   help="restore edl_tpu_torch.train_lm's parameters (else seeded init)")
    p.add_argument("--vocab", type=int, default=53)
    p.add_argument("--layers", type=int, default=1)
    p.add_argument("--embed", type=int, default=32)
    p.add_argument("--heads", type=int, default=2)
    p.add_argument("--mlp", type=int, default=64)
    p.add_argument("--max_len", type=int, default=64)
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--steps_per_sync", type=int, default=4)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--top_k", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ttl", type=float, default=None, help="lease TTL (EDL_TPU_TTL)")
    p.add_argument("--kv_block", type=int, default=constants.kv_block(),
                   help="paged-KV block size in tokens; 0 = contiguous slabs, no prefix "
                        "reuse (EDL_TPU_KV_BLOCK)")
    p.add_argument("--kv_pool_blocks", type=int, default=constants.kv_pool_blocks(),
                   help="paged-KV pool size; 0 = 2x the slot capacity (EDL_TPU_KV_POOL_BLOCKS)")
    p.add_argument("--prefill_chunk", type=int, default=constants.prefill_chunk(),
                   help="chunked-prefill chunk size in tokens; 0 = one pass "
                        "(EDL_TPU_PREFILL_CHUNK)")
    p.add_argument("--spec_k", type=int, default=constants.spec_k(),
                   help="speculative-decode draft length; 0 = off (EDL_TPU_SPEC_K; greedy "
                        "only)")
    p.add_argument("--draft_layers", type=int, default=1)
    p.add_argument("--draft_embed", type=int, default=16)
    p.add_argument("--draft_heads", type=int, default=2)
    p.add_argument("--draft_mlp", type=int, default=32)
    p.add_argument("--draft_seed", type=int, default=None,
                   help="seeded draft (default --seed; the target's dims and seed make a "
                        "self-draft)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel width: > 1 serves the engine (its paged KV pool "
                        "too) over a (dp, tp) group of this many processes, one card each "
                        "on cuda")
    p.add_argument("--tp_rank", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--tp_addr", default="", help=argparse.SUPPRESS)
    return p.parse_args(argv)


def _seeded_model(vocab, layers, embed, heads, mlp, max_len, seed, device):
    import torch

    from edl_tpu_torch.models.transformer import TransformerConfig, TransformerLM

    cfg = TransformerConfig(vocab_size=vocab, num_layers=layers, embed_dim=embed,
                            num_heads=heads, mlp_dim=mlp, max_len=max_len, remat=False,
                            dtype=torch.bfloat16 if device.type == "cuda" else torch.float32)
    model = TransformerLM(cfg, torch.Generator().manual_seed(seed)).to(device)
    return model.requires_grad_(False).eval()


def build_target(args, device, mesh=None):
    """The replica's target model: seeded, or restored from
    ``--checkpoint_dir`` (on a tp group, each rank's part into its cut of
    the decode model).  Compute is bf16 on the card and f32 on the CPU."""
    model = _seeded_model(args.vocab, args.layers, args.embed, args.heads, args.mlp,
                          args.max_len, args.seed, device)
    if args.checkpoint_dir:
        from edl_tpu_torch.models.generate import shard_decode_model
        from edl_tpu_torch.train.checkpoint import CheckpointManager
        from edl_tpu_torch.train.state import TrainState, adamw

        if mesh is not None:
            model = shard_decode_model(model, mesh)
        restored = CheckpointManager(args.checkpoint_dir).restore(
            TrainState.create(model, adamw(1e-3)))
        if restored is None:
            raise SystemExit(f"no checkpoint under {args.checkpoint_dir}")
        model = restored[0].model.requires_grad_(False).eval()
    return model


def build_engine(args, device, mesh=None):
    """The replica's engine: the target (:func:`build_target`) and, with
    ``--spec_k``, the seeded draft; ``mesh``: this process leads its tp
    group."""
    from edl_tpu_torch.serving.engine import ContinuousBatcher

    model = build_target(args, device, mesh)
    draft = None
    if args.spec_k > 0:
        draft = _seeded_model(args.vocab, args.draft_layers, args.draft_embed, args.draft_heads,
                              args.draft_mlp, args.max_len,
                              args.seed if args.draft_seed is None else args.draft_seed, device)
    return ContinuousBatcher(model, slots=args.slots, temperature=args.temperature,
                             top_k=args.top_k, steps_per_sync=args.steps_per_sync,
                             kv_block=args.kv_block, kv_pool_blocks=args.kv_pool_blocks,
                             prefix_reuse=constants.kv_reuse(),
                             prefill_chunk=args.prefill_chunk, spec_k=args.spec_k,
                             draft_model=draft, mesh=mesh)


def _follow(args) -> None:
    """A tp rank other than 0: join the group, build the same target, run
    the leader's engine commands until its stop."""
    import sys

    from edl_tpu_torch.serving.engine import ContinuousBatcher
    from edl_tpu_torch.serving.spmd import (FollowerExit, die_with_parent, follower_exit,
                                            join_group)

    die_with_parent()
    device, mesh = join_group(args.tp, args.tp_rank, args.tp_addr, args.device)
    try:
        ContinuousBatcher.follow(build_target(args, device, mesh), mesh=mesh)
    except FollowerExit as e:
        print(f"[edl-replica] tp rank {args.tp_rank}: {e}", file=sys.stderr)
        follower_exit(1)
    follower_exit(0)


def main(argv=None) -> None:
    """``python -m edl_tpu_torch.serving.replica``: build an engine and lease
    it into the fleet.  The JAX replica's flags, plus ``--device`` (default
    ``cuda``: without a card it raises ``NoCardError`` unless given
    ``--device cpu``).  ``--tp N``: this process is rank 0 of a tp group of
    N processes, which it spawns (``serving/spmd.py:lead_group``; NCCL a
    card each on cuda, gloo on the CPU); it alone leases the replica, so
    the gateway sees one replica.  Its first line is ``[edl-replica] <id>
    serving on <host:port>``; SIGTERM drains (migrating pinned sessions
    through the group's export), then exits, and the followers with it."""
    import signal
    import sys

    import torch

    from edl_tpu_torch.coord.client import connect
    from edl_tpu_torch.utils.device import resolve_device

    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    if args.tp > 1 and args.tp_rank > 0:
        _follow(args)
        return
    mesh, followers = None, []
    device = resolve_device(args.device)
    if args.tp > 1:
        from edl_tpu_torch.serving.spmd import lead_group

        mesh, followers = lead_group("edl_tpu_torch.serving.replica", argv, args.tp,
                                     args.device)
        if device.type == "cuda":
            device = torch.device("cuda", 0)
    engine = build_engine(args, device, mesh)
    store = connect(args.coord_endpoints)
    server = ReplicaServer(store, args.job_id, engine, replica_id=args.replica_id,
                           host=args.host, port=args.port, ttl=args.ttl)
    print(f"[edl-replica] {server.replica_id} serving on {server.endpoint}", flush=True)
    done = threading.Event()

    def _sigterm(_sig, _frm):
        # preemption: drain gracefully, then exit (SIGKILL is the hard path
        # that the gateway's failover covers)
        threading.Thread(target=lambda: (server.drain(), done.set()), daemon=True).start()

    signal.signal(signal.SIGTERM, _sigterm)
    try:
        done.wait()
    except KeyboardInterrupt:
        pass
    server.close()
    if followers:
        from edl_tpu_torch.serving.spmd import reap

        reap(followers)


if __name__ == "__main__":
    main()
