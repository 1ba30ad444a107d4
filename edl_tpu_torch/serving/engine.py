"""Slot-based continuous batching for TransformerLM decode (the port of the
JAX package's ``serving/engine.py:ContinuousBatcher``, without mesh).

A fixed pool of ``slots`` decode lanes shares ONE persistent
:class:`~edl_tpu_torch.models.transformer.KVCache`:

- a new request **prefills** into any free slot, padded to its prompt
  bucket (buckets extend by doubling to the cache length, so any prompt
  that leaves room for one generated token is accepted); waiting
  requests of one bucket prefill together, in sub-batches from the
  ``PREFILL_KS`` ladder;
- every decode dispatch advances ALL slots ``steps_per_sync`` tokens,
  each at the position its own cache index holds;
- each engine **tick** dispatches at most ONE prefill group, then the
  decode chunk for the lanes already live, then the insert of the
  prefilled lanes into the pool, and reads everything back in ONE
  device-to-host copy, so live lanes advance ``steps_per_sync`` tokens
  every tick however fast requests arrive (``stats()['prefill_stall_s']``
  is the host time prefill dispatches took while lanes were live);
- **chunked prefill** (``prefill_chunk``, default
  ``EDL_TPU_PREFILL_CHUNK`` = 512): a prompt longer than the chunk
  prefills into a private one-lane cache one chunk a tick, between the
  decode dispatches; its last chunk rides the shared insert path;
- **paged KV with prefix reuse** (``kv_block > 0``, :mod:`.kv_cache`):
  a finished request's full KV blocks persist in a block pool, and an
  admission whose prompt extends a committed chain gathers it into its
  slot and prefills only the suffix; ``submit(..., session=)`` pins the
  conversation's chain, which :meth:`ContinuousBatcher.export_sessions`
  and :meth:`ContinuousBatcher.import_session` move between replicas;
- **speculative decoding** (``spec_k > 0`` with a draft model over the
  same vocabulary, greedy only): each tick runs draft-k / verify-once
  rounds; the target checks all k+1 positions in one multi-token pass
  and keeps the longest prefix equal to its own argmax plus its next
  token, so the emitted stream is the plain greedy one;
- a finished slot (token budget or ``eos_id``) frees at once and the next
  queued request takes it.

Each slot's position and mask advance alone (the per-example cache index),
so a slot is the same computation as its request decoded alone; with
greedy sampling on the CPU in f32 the tokens are equal to
:func:`~edl_tpu_torch.models.generate.generate`'s.

Thread model: callers ``submit()`` from any thread and get a Future; one
engine thread owns the device state (the pool cache, the last tokens,
the generator).  That thread enters ``torch.inference_mode`` and makes the
model's device its current one, since both are per thread.

Tensor parallelism (``mesh`` with a ``tp`` dim wider than 1, the JAX
engine's mesh serving): the engine is an SPMD group of processes, one a
card.  The process at tp rank 0 builds the engine and keeps the whole
host side (the queue, the scheduler, chunking, prefix reuse, the trie,
``stats``, ``drain``); every other rank calls :meth:`ContinuousBatcher.
follow` with the same whole model and mesh.  Each rank holds its cut of
the weights (``models/generate.py:shard_decode_model``) and its kv heads
of every cache; each device call of the engine thread (a prefill, one
tick's ``steps_per_sync`` decode steps, a speculative round's verify, an
insert, a chunk, a block move) goes to the followers as one command
(``serving/spmd.py``) before the leader runs it, so every rank enters the
model's collectives in one order.  The leader alone samples (each token
broadcast) and runs the speculative draft, whole, as the JAX engine
replicates it; its proposals travel in the verify command.  ``warm``, the
session import and export run on the engine thread, the only thread that
drives the group; a mesh engine exports its pinned sessions as it stops,
before it stops the followers.  A tick that fails on the leader stops the
group: the followers get the stop, and its requests fail.
"""

from __future__ import annotations

import dataclasses
import logging
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import NamedTuple

import numpy as np
import torch

from edl_tpu_torch.models.generate import sample_on_leader, shard_decode_model
from edl_tpu_torch.models.transformer import KVCache, TransformerLM, decode_model
from edl_tpu_torch.serving import spmd
from edl_tpu_torch.serving.kv_cache import PagedKVCache
from edl_tpu_torch.utils import constants
from edl_tpu_torch.utils.device import enter_device

logger = logging.getLogger(__name__)

DEFAULT_PREFILL_BUCKETS = (32, 64, 128, 256, 512)


@dataclasses.dataclass
class _Slot:
    request: "_Request | None" = None
    emitted: list[int] = dataclasses.field(default_factory=list)
    remaining: int = 0

    @property
    def free(self) -> bool:
        return self.request is None


class _Request:
    __slots__ = ("ids", "max_new", "future", "session")

    def __init__(self, ids: np.ndarray, max_new: int, session: str | None = None):
        self.ids = ids
        self.max_new = max_new
        self.session = session
        self.future: Future = Future()


@dataclasses.dataclass
class _ChunkState:
    """One chunked admission in flight: the request holds a claimed slot
    while its prompt prefills into a private one-lane cache, one chunk a
    tick."""

    req: _Request
    slot: int
    slab: KVCache         # its index == offset
    offset: int           # prompt tokens already prefilled


class _Task:
    """A closure the engine thread runs between ticks."""

    __slots__ = ("fn", "future")

    def __init__(self, fn):
        self.fn = fn
        self.future: Future = Future()


class _Admission(NamedTuple):
    """A dispatched prefill: its one-lane-per-request cache and first
    tokens (on the device), and where they go; with speculative decoding
    also the draft's cache of the same prompts."""

    slab: KVCache
    toks: torch.Tensor
    slots: list[int]
    reqs: list[_Request]
    lens: list[int]
    dslab: KVCache | None = None


class ContinuousBatcher:
    """``submit(prompt_1d) -> Future[np.ndarray]`` over a slot pool.

    ``model`` is the trained :class:`TransformerLM` (its decode copy, with
    the weights cast once to the compute dtype, is built here) on the
    device the engine runs on.  ``max_len`` bounds prompt + generation
    per slot (default ``model.cfg.max_len``); the pool cache is ``[slots,
    ..., max_len]``.  ``steps_per_sync`` trades scheduling latency for
    fewer host round trips: a finished slot wastes at most
    ``steps_per_sync - 1`` lane-steps before the host notices.

    ``kv_block > 0`` pages the KV state in blocks of that many tokens
    (``kv_pool_blocks``: the pool, default ``2 * slots * max_len //
    kv_block + 1``; ``kv_max_sessions``: pinned session chains, default
    ``EDL_TPU_KV_SESSIONS``; ``prefix_reuse=False`` commits and pins but
    prefills every admission cold).  ``spec_k > 0`` (default
    ``EDL_TPU_SPEC_K``) needs ``draft_model``, a model over the same
    vocabulary on the same device, and a greedy engine (``temperature <=
    0``): acceptance compares the draft with the target's argmax.

    ``mesh`` (a ``DeviceMesh`` whose ``tp`` dim is wider than 1; the world
    formed): this process is the group's leader (tp rank 0), ``model`` is
    whole and is cut here, and the other ranks run :meth:`follow`.  Its
    tokens equal the unsharded engine's.
    """

    def __init__(self, model: TransformerLM, *, slots: int = 8, max_len: int | None = None,
                 prefill_buckets: tuple[int, ...] = DEFAULT_PREFILL_BUCKETS,
                 temperature: float = 1.0, top_k: int = 0, top_p: float = 0.0,
                 eos_id: int | None = None, steps_per_sync: int = 8, rng_seed: int = 20_26,
                 mesh=None, kv_block: int = 0, kv_pool_blocks: int = 0,
                 prefix_reuse: bool = True, kv_max_sessions: int | None = None,
                 prefill_chunk: int | None = None, spec_k: int | None = None,
                 draft_model: TransformerLM | None = None):
        cache_len = max_len or model.cfg.max_len
        self.cfg = model.cfg
        self._chan: spmd.Channel | None = None
        self._mesh = mesh
        self._pending: deque[_Request] = deque()
        self._slots = [_Slot() for _ in range(slots)]
        # prefill sub-batch ladder: a run of waiting same-bucket requests
        # splits greedily into these sizes, so admissions share dispatches
        self.PREFILL_KS = tuple(k for k in (32, 16, 8, 4, 2, 1) if k <= slots) or (1,)
        buckets = sorted(b for b in prefill_buckets if b <= cache_len) or [cache_len]
        # the prompt cap is the cache, not the configured bucket list
        while buckets[-1] < cache_len:
            buckets.append(min(buckets[-1] * 2, cache_len))
        self._buckets = tuple(buckets)
        self._temperature = temperature
        self._top_k = top_k
        self._top_p = top_p
        self._eos = eos_id
        self._reuse = bool(prefix_reuse)
        k = constants.spec_k() if spec_k is None else int(spec_k)
        if k > 0:
            if draft_model is None:
                raise ValueError("spec_k > 0 requires a draft model (a smaller model over "
                                 "the same vocabulary)")
            if temperature > 0:
                raise ValueError("speculative decoding is greedy-only (temperature <= 0): "
                                 "acceptance compares the draft against the target's "
                                 "argmax, which keeps the output that of plain decode")
            if draft_model.cfg.vocab_size != model.cfg.vocab_size:
                raise ValueError(f"draft vocab {draft_model.cfg.vocab_size} != target "
                                 f"vocab {model.cfg.vocab_size}")
        n_blocks = 0
        if kv_block > 0:
            n_blocks = kv_pool_blocks or (2 * slots * max(1, cache_len // kv_block) + 1)
        sessions = constants.kv_sessions() if kv_max_sessions is None else kv_max_sessions
        config = [slots, cache_len, max(1, steps_per_sync), kv_block, n_blocks, sessions, k]
        local = shard_decode_model(model, mesh)
        if local.tp is not None:
            self._chan = spmd.Channel(mesh, local.tok_embed.weight.device)
            if not self._chan.leader:
                raise ValueError("a tp rank other than 0 runs ContinuousBatcher.follow()")
        try:
            self._init_device(local, *config)
            if self._chan is not None:
                self._chan.send(spmd.OP_CONFIG, config + [self._chan.handle(self._cache)])
        except BaseException:
            if self._chan is not None:          # the followers wait for the config
                self._chan.close()
            raise
        self._gen = torch.Generator(device=self._device).manual_seed(rng_seed)
        self._toks = torch.zeros(slots, dtype=torch.int32, device=self._device)
        self._exported: list | None = None
        self._kv_hits = 0
        self._kv_misses = 0
        self._prefill_tokens = 0
        self._prefill_tokens_skipped = 0
        chunk = constants.prefill_chunk() if prefill_chunk is None else prefill_chunk
        self._chunk_tokens = max(0, int(chunk))
        self._chunking: _ChunkState | None = None
        self._prefill_chunks = 0
        self._chunked_admissions = 0
        self._tasks: deque[_Task] = deque()
        self._queue: queue.Queue[_Request | _Task | None] = queue.Queue()
        self._stopping = False
        self._draining = False
        # makes check-stopping + enqueue atomic against stop()'s drain
        self._enqueue_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self._done_requests = 0
        self._submitted_requests = 0
        self._failed_requests = 0
        self._emitted_tokens = 0
        self._lane_steps = 0          # slot-steps dispatched
        self._active_lane_steps = 0   # of those, slots with live requests
        self._prefill_stall_s = 0.0   # prefill dispatch time with lanes live
        self._t0 = time.monotonic()
        # -- speculative decoding (draft-k / verify-once rounds); the draft
        # runs whole on the leader, its cache beside the pool's
        self._spec_proposed = 0
        self._spec_accepted = 0
        self._spec_rounds_run = 0
        if self._spec_k:
            self._draft = decode_model(draft_model)
            self._dcfg = self._draft.cfg
            self._draft_cache = KVCache.zeros(self._dcfg, slots, cache_len, self._device)
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="continuous-batcher")
        self._thread.start()

    def _init_device(self, model: TransformerLM, slots: int, cache_len: int, steps: int,
                     kv_block: int, n_blocks: int, sessions: int, spec_k: int) -> None:
        """The device state every rank of a tp group holds alike: the decode
        model (this rank's cut), the pool cache, the paged pool and the
        verify model."""
        self._model = model
        self._mcfg = model.cfg
        self._tp = model.tp
        self._device = model.tok_embed.weight.device
        self._cache_len = cache_len
        self._T = steps
        self._cache = self._new_cache(slots)
        # -- the paged KV pool and its prefix index (kv_cache.py); with
        # kv_block=0 the engine runs exactly the unpaged path
        self._kv: PagedKVCache | None = None
        if kv_block > 0:
            self._kv = PagedKVCache(self._mcfg, cache_len, kv_block, n_blocks, sessions,
                                    self._device, mesh=self._mesh, channel=self._chan)
        self._spec_k = spec_k
        if spec_k:
            # rounds per tick sized so a tick still consumes about
            # steps_per_sync tokens at full acceptance
            self._spec_rounds = max(1, self._T // (spec_k + 1))
            # the verify model shares the target's weights and cache layout
            # but writes multi-token calls at per-example indices
            self._vmodel = decode_model(self._model, decode_scatter=True)

    @classmethod
    def follow(cls, model: TransformerLM, *, mesh) -> None:
        """Run a tp group's device side on this rank (tp rank > 0) until the
        leader's engine stops: ``model`` and ``mesh`` as the leader's (the
        rest of the configuration comes from the leader).  Raises
        :class:`~edl_tpu_torch.serving.spmd.FollowerExit` when the leader
        is gone."""
        self = cls.__new__(cls)
        dmodel = shard_decode_model(model, mesh)
        self._chan = chan = spmd.Channel(mesh, dmodel.tok_embed.weight.device)
        if chan.leader:
            raise ValueError("tp rank 0 builds the ContinuousBatcher; follow() is for the "
                             "others")
        self._mesh = mesh
        self._temperature, self._top_k, self._top_p = 0.0, 0, 0.0
        enter_device(dmodel.tok_embed.weight.device)
        with torch.inference_mode():
            cmd = chan.recv()
            while cmd.op == spmd.OP_NOOP:
                cmd = chan.recv()
            if cmd.op == spmd.OP_STOP:
                return
            if cmd.op != spmd.OP_CONFIG:
                raise RuntimeError(f"a follower's first command is {cmd.op}, not the config")
            self._init_device(dmodel, *cmd.ints[:7])
            chan.adopt(cmd.ints[7], self._cache)
            lookup = chan.lookup
            handlers = {
                spmd.OP_SLAB: lambda c: chan.adopt(c.ints[0], self._new_cache(c.ints[1])),
                spmd.OP_PREFILL: lambda c: self._prefill_into(
                    lookup(c.ints[0]), c.arrays[0].numpy(), c.arrays[1].numpy(), None),
                spmd.OP_STEP: lambda c: self._step(lookup(c.ints[0]), c.tensors[0], None),
                spmd.OP_VERIFY: lambda c: self._verify(lookup(c.ints[0]), *c.tensors),
                spmd.OP_INSERT: lambda c: self._insert_lanes(
                    lookup(c.ints[0]), c.ints[1:], c.arrays[0].numpy()),
                spmd.OP_CHUNK_MID: lambda c: self._chunk_mid(
                    lookup(c.ints[0]), c.arrays[0].numpy(), c.ints[1]),
                spmd.OP_CHUNK_FINAL: lambda c: self._chunk_final(
                    lookup(c.ints[0]), c.arrays[0].numpy(), c.ints[1], None, c.ints[2]),
            }
            if self._kv is not None:
                handlers.update(self._kv.handlers())
            chan.serve(handlers)

    # -- public --------------------------------------------------------------
    def submit(self, prompt: np.ndarray, max_new_tokens: int,
               session: str | None = None) -> Future:
        """Queue one prompt (1-D int32).  The future resolves to the
        generated tokens (<= max_new_tokens; truncated after eos_id).
        ``session`` (paged engines) pins the finished conversation's KV
        chain, so its next turn resumes from it and a drain migrates it."""
        ids = np.asarray(prompt, np.int32).reshape(-1)
        cache_len = self._cache_len
        if len(ids) == 0:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if len(ids) >= cache_len:
            raise ValueError(f"prompt length {len(ids)} must leave room for at least one "
                             f"generated token (cache_len {cache_len})")
        if len(ids) + max_new_tokens > cache_len:
            raise ValueError(f"prompt {len(ids)} + new {max_new_tokens} exceeds max_len "
                             f"{cache_len}")
        req = _Request(ids, max_new_tokens, session)
        with self._enqueue_lock:
            if self._stopping:
                raise RuntimeError("engine stopping")
            if self._draining:
                raise RuntimeError("engine draining")
            self._submitted_requests += 1
            self._queue.put(req)
        return req.future

    def generate(self, prompt: np.ndarray, max_new_tokens: int,
                 timeout: float | None = None) -> np.ndarray:
        """Blocking convenience wrapper around :meth:`submit`."""
        return self.submit(prompt, max_new_tokens).result(timeout)

    def run_on_engine(self, fn, timeout: float = 30.0):
        """Run ``fn()`` on the engine thread between ticks and return its
        result (the single-writer rule for device state)."""
        task = _Task(fn)
        with self._enqueue_lock:
            if self._stopping:
                raise RuntimeError("engine stopping")
            self._queue.put(task)
        return task.future.result(timeout)

    def import_session(self, session: str, tokens: list[int], meta: dict,
                       blob: bytes) -> int:
        """Adopt one migrated session chain on the engine thread; returns
        the blocks newly uploaded.  Raises on an unpaged engine or a layout
        mismatch (the exporter lets the session cold-start elsewhere)."""
        if self._kv is None:
            raise RuntimeError("paged KV cache disabled on this engine")
        return self.run_on_engine(lambda: self._kv.import_chain(session, tokens, meta, blob))

    def kv_pinned_sessions(self) -> list[str] | None:
        """A snapshot of pinned session ids from any thread ([] unpaged);
        None when an engine-thread pin raced the read (retry later)."""
        if self._kv is None:
            return []
        try:
            return self._kv.sessions()
        except RuntimeError:
            return None

    def export_sessions(self) -> list[tuple[str, list[int], dict, bytes]]:
        """``[(session, tokens, meta, blob)]`` for every pinned chain.  Only
        legal once the engine thread has stopped (after :meth:`drain`).

        A tp engine's thread exported them as it stopped: its pool lies
        partly on the followers, which only that thread may command and
        which leave with its stop, so the gather cannot wait for this call
        (the blobs are those of one process).  A one-process engine's
        pool stays readable after its thread ends, so it exports here,
        only when asked: a stop that no migration follows (a hard stop,
        ``EDL_TPU_KV_MIGRATE=0``) copies no chain off the card."""
        if self._kv is None:
            return []
        if self._thread.is_alive():
            raise RuntimeError("export_sessions() requires a stopped engine (call "
                               "drain() first)")
        if self._chan is not None:
            return list(self._exported or [])
        return self._export_all()

    def _export_all(self) -> list[tuple[str, list[int], dict, bytes]]:
        out = []
        for session in self._kv.sessions():
            chain = self._kv.chain_of(session)
            if chain:
                meta, blob = self._kv.export_chain(chain)
                out.append((session, self._kv.chain_tokens(chain), meta, blob))
        return out

    def _in_flight(self) -> int:
        with self._enqueue_lock, self._stats_lock:
            return self._submitted_requests - self._done_requests - self._failed_requests

    def warm(self, prompt_len: int) -> None:
        """Run, before traffic arrives, every computation that serving
        ``prompt_len``-class prompts reaches: the prefill at each
        ``PREFILL_KS`` sub-batch size, a decode step, the chunk pair
        when the prompt would be chunked, a prefix-hit prefill at each
        suffix bucket (paged engines), and the draft's prefills and a
        speculative dispatch (``spec_k``), on scratch caches (the card's
        first call of a shape picks its library kernels and grows the
        allocator's pools).  Only legal while no request is in flight,
        and enforced: a request submitted but not finished raises."""
        in_flight = self._in_flight()
        if in_flight:
            raise RuntimeError(f"ContinuousBatcher.warm() called with {in_flight} request(s) "
                               "in flight; warm() must run before the first submit()")
        if self._chan is not None:
            # only the engine thread drives the tp group
            self.run_on_engine(lambda: self._warm(prompt_len), timeout=None)
            return
        enter_device(self._device)
        with torch.inference_mode():
            self._warm(prompt_len)

    def _warm(self, prompt_len: int) -> None:
        gen = torch.Generator(device=self._device).manual_seed(0)
        P = self._bucket(prompt_len)
        for K in self.PREFILL_KS:
            self._prefill(np.zeros((K, P), np.int32), np.ones(K, np.int32), gen)
        self._step(self._slab(len(self._slots)),
                   torch.zeros(len(self._slots), dtype=torch.int32, device=self._device), gen)
        C = self._chunk_tokens
        if C and prompt_len > C:
            off = C * ((prompt_len - 1) // C)
            if off + self._bucket(prompt_len - off) <= self._cache_len:
                slab = self._slab(1)
                self._chunk_mid(slab, np.zeros(C, np.int32), 0)
                self._chunk_final(slab, np.ones(prompt_len - off, np.int32), C, gen)
        if self._kv is not None and self._reuse:
            # a one-block hit from the scratch block at every suffix bucket
            for Pb in (b for b in self._buckets if b <= P):
                if self._kv.block + Pb <= self._cache_len:
                    slab = self._slab(1)
                    self._kv.load_prefix_into(slab, [0], self._kv.block)
                    self._chunk_final(slab, np.ones(Pb, np.int32), self._kv.block, gen)
        if self._spec_k:
            for K in self.PREFILL_KS:
                self._draft_prefill(np.zeros((K, P), np.int32))
            B = len(self._slots)
            self._spec(self._slab(B), KVCache.zeros(self._dcfg, B, self._cache_len, self._device),
                       torch.zeros(B, dtype=torch.int32, device=self._device))
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)

    def stats(self) -> dict:
        with self._stats_lock:
            dt = max(1e-9, time.monotonic() - self._t0)
            lanes = max(1, self._lane_steps)
            return {
                "slots": len(self._slots),
                "active_slots": sum(not s.free for s in self._slots),
                "queue_depth": self._queue.qsize() + len(self._pending),
                "requests_done": self._done_requests,
                "tokens_emitted": self._emitted_tokens,
                "tokens_per_s": round(self._emitted_tokens / dt, 1),
                # dispatched lane-steps that served a live request
                "slot_utilization": round(self._active_lane_steps / lanes, 3),
                "prefill_stall_s": round(self._prefill_stall_s, 3),
                "max_prompt_len": self._cache_len - 1,
                "uptime_s": round(dt, 3),
                "draining": self._draining,
                "prefill_chunk": self._chunk_tokens,
                "prefill_chunks": self._prefill_chunks,
                "chunked_admissions": self._chunked_admissions,
                **self._kv_stats(),
                **self._spec_stats(),
            }

    def _spec_stats(self) -> dict:
        """Speculative-decoding counters (none when it is off)."""
        if not self._spec_k:
            return {}
        return {"spec_k": self._spec_k, "spec_proposed": self._spec_proposed,
                "spec_accepted": self._spec_accepted,
                "spec_accept_rate": round(self._spec_accepted / max(1, self._spec_proposed), 3),
                "spec_rounds": self._spec_rounds_run}

    def _kv_stats(self) -> dict:
        """Paged-KV counters (none when paging is off)."""
        if self._kv is None:
            return {}
        return {"kv_block": self._kv.block, "kv_blocks_used": self._kv.blocks_used(),
                "kv_blocks_free": self._kv.blocks_free(), "kv_prefix_hits": self._kv_hits,
                "kv_prefix_misses": self._kv_misses, "kv_prefill_tokens": self._prefill_tokens,
                "kv_prefill_tokens_skipped": self._prefill_tokens_skipped,
                "kv_evictions": self._kv.evictions, "kv_commit_skips": self._kv.commit_skips,
                "kv_sessions": self._kv.session_count()}

    def drain(self, timeout: float | None = None) -> bool:
        """Graceful shutdown: stop admission (submit() raises), let every
        queued and in-flight request finish, then stop.  Returns True when
        everything completed; at ``timeout`` (seconds) it falls back to
        the hard :meth:`stop` and returns False."""
        with self._enqueue_lock:
            self._draining = True
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            in_flight = self._in_flight()
            if in_flight == 0:
                self.stop()
                return True
            if deadline is not None and time.monotonic() >= deadline:
                logger.warning("drain timed out with %d request(s) left; falling back to "
                               "hard stop", in_flight)
                self.stop()
                return False
            time.sleep(0.01)

    def stop(self) -> None:
        """Hard stop: every request not yet finished fails."""
        with self._enqueue_lock:
            self._stopping = True
        self._queue.put(None)
        # a tp engine's thread exports its sessions and stops the group first
        self._thread.join(timeout=30.0 if self._chan is None else 30.0 + spmd.TIMEOUT)
        for s in self._slots:
            if s.request is not None:
                s.request.future.set_exception(RuntimeError("engine stopped mid-generation"))
                s.request = None
        if self._chunking is not None:
            self._chunking.req.future.set_exception(RuntimeError("engine stopped mid-prefill"))
            self._chunking = None
        self._fail_queued(RuntimeError("engine stopped"))

    def _fail_queued(self, e: Exception) -> None:
        for pending in (self._pending, self._tasks):
            while pending:
                pending.popleft().future.set_exception(e)
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                item.future.set_exception(e)

    # -- device work -----------------------------------------------------------
    # Each device call a tp group's ranks share starts with _cmd: on the
    # leader it sends the call to the followers, which run the same method
    # from Channel.serve (follow()); elsewhere it does nothing.
    def _cmd(self, op: int, caches=(), ints=(), arrays=(), tensors=()) -> None:
        if self._chan is not None and self._chan.leader:
            handles = [self._chan.handle(c) for c in caches]
            self._chan.send(op, [*handles, *ints], arrays, tensors)

    def _new_cache(self, batch: int) -> KVCache:
        """An empty ``batch``-lane cache of the pool's length, this rank's
        kv heads."""
        return KVCache.zeros(self._mcfg, batch, self._cache_len, self._device, self._tp)

    def _slab(self, batch: int) -> KVCache:
        """A new cache that every rank of a tp group holds (the leader's
        call; the followers' twins are filed under its handle)."""
        slab = self._new_cache(batch)
        if self._chan is not None:
            self._chan.send(spmd.OP_SLAB, [self._chan.handle(slab), batch])
        return slab

    def _sent(self) -> int:
        return self._chan.sent if self._chan is not None else 0

    def _local_failure(self, sent_before: int) -> bool:
        """Whether a failure may fail only its own requests: always without
        a tp group; in one, only when no command went out since
        ``sent_before`` (after one, the followers may be mid-call, and the
        group must stop)."""
        return self._sent() == sent_before

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        # non_blocking: a copy from pageable memory is staged at once, and
        # the stream is not synchronised (the tick's one sync is its read)
        return torch.from_numpy(a).to(self._device, non_blocking=True)

    def _sample(self, hidden: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
        """``[B, D]`` final-norm hidden states -> ``[B]`` tokens, through the
        head on those rows only; :func:`generate`'s sampling recipe (in a tp
        group the leader samples and broadcasts)."""
        return sample_on_leader(self._model.head(hidden), self._tp, gen,
                                temperature=self._temperature, top_k=self._top_k,
                                top_p=self._top_p)

    def _prefill(self, ids: np.ndarray, lens: np.ndarray, gen) -> tuple[KVCache, torch.Tensor]:
        """A fresh K-lane cache holding the padded prompts ``ids [K, P]``,
        and one token per lane sampled at its last real position (the pad
        positions' keys lie past ``lens``, where the insert's index reset
        and the masks keep them unread)."""
        slab = self._slab(ids.shape[0])
        self._cmd(spmd.OP_PREFILL, [slab], arrays=[ids, lens])
        return slab, self._prefill_into(slab, ids, lens, gen)

    def _prefill_into(self, slab: KVCache, ids: np.ndarray, lens: np.ndarray,
                      gen) -> torch.Tensor:
        K = ids.shape[0]
        hidden = self._model(self._to_device(ids), cache=slab, return_hidden=True)
        last = self._to_device(lens.astype(np.int64) - 1)
        rows = torch.arange(K, device=self._device)
        return self._sample(hidden[rows, last], gen)

    def _step(self, cache: KVCache, toks: torch.Tensor, gen) -> tuple[torch.Tensor,
                                                                     torch.Tensor]:
        """Advance every lane of ``cache`` ``steps_per_sync`` tokens from
        ``toks [slots]``, each at the position its cache index holds; returns
        the tokens ``[slots, T]`` and the last ones, on the device."""
        self._cmd(spmd.OP_STEP, [cache], tensors=[toks])
        out = []
        for _ in range(self._T):
            hidden = self._model(toks[:, None], positions=cache.index[:, None], cache=cache,
                                 return_hidden=True)
            toks = self._sample(hidden[:, 0], gen)
            out.append(toks)
        return torch.stack(out, dim=1), toks

    def _draft_prefill(self, ids: np.ndarray) -> KVCache:
        """The draft's cache of the padded prompts ``ids [K, P]`` (no
        sampling: the draft always continues from the target's token)."""
        slab = KVCache.zeros(self._dcfg, ids.shape[0], self._cache_len, self._device)
        self._draft(self._to_device(ids), cache=slab, return_hidden=True)
        return slab

    def _draft_slab_for(self, req: _Request) -> KVCache:
        """A one-lane draft prefill of the whole prompt, for the admissions
        that never fed the draft (prefix hits, chunked prompts).  The draft
        has no pool: its state moves the accept rate, never the tokens."""
        ids = np.zeros((1, self._bucket(len(req.ids))), np.int32)
        ids[0, :len(req.ids)] = req.ids
        return self._draft_prefill(ids)

    def _spec(self, cache: KVCache, dcache: KVCache, toks: torch.Tensor):
        """``_spec_rounds`` draft-k / verify-once rounds for every lane, on
        the device.  A round puts the draft on the target's frontier, runs
        k greedy draft steps (and writes the last draft token's KV too, so
        a perfect draft does not attend to a hole next round), feeds the
        last token and the k drafts through the verify model at each lane's
        own positions, accepts the longest prefix equal to the target's
        argmax and adds the target's next token (the bonus), then sets both
        caches' indices to the accepted frontier; the stale K/V beyond it is
        overwritten before any mask reaches it.  Returns ``out [R, slots,
        k+1]`` and ``counts [R, slots]`` (tokens of ``out`` to consume) and
        the last tokens."""
        k = self._spec_k
        outs, counts = [], []
        for _ in range(self._spec_rounds):
            dcache.index.copy_(cache.index)
            last, drafts = toks, []
            for _ in range(k):
                hidden = self._draft(last[:, None], positions=dcache.index[:, None],
                                     cache=dcache, return_hidden=True)
                last = self._draft.head(hidden[:, 0]).argmax(-1).to(torch.int32)
                drafts.append(last)
            self._draft(last[:, None], positions=dcache.index[:, None], cache=dcache,
                        return_hidden=True)                           # the last draft's KV
            out, count, toks = self._verify(cache, toks, torch.stack(drafts, dim=1))
            dcache.index.copy_(cache.index)
            outs.append(out)
            counts.append(count)
        return torch.stack(outs), torch.stack(counts), toks

    def _verify(self, cache: KVCache, toks: torch.Tensor, drafts: torch.Tensor):
        """One verify pass of the last tokens and the drafts ``[B, k]``: the
        round's tokens ``[B, k+1]``, their count and the bonus tokens, and
        the cache's index set to the accepted frontier (a tp group's
        command: the drafts travel in it; the argmax is the leader's)."""
        self._cmd(spmd.OP_VERIFY, [cache], tensors=[toks, drafts])
        k = drafts.shape[1]
        j = torch.arange(k + 1, device=self._device)
        idx = cache.index.clone()
        feed = torch.cat([toks[:, None], drafts], dim=1)
        hidden = self._vmodel(feed, positions=idx[:, None] + j, cache=cache, return_hidden=True)
        greedy = self._vmodel.head(hidden).argmax(-1).to(torch.int32)   # [B, k+1]
        if self._chan is not None:
            self._chan.broadcast(greedy)
        n_acc = (greedy[:, :k] == drafts).to(torch.int32).cumprod(dim=1).sum(dim=1)
        bonus = greedy.gather(1, n_acc[:, None].long())
        dpad = torch.cat([drafts, torch.zeros_like(drafts[:, :1])], dim=1)
        out = torch.where(j < n_acc[:, None], dpad, torch.where(j == n_acc[:, None], bonus, 0))
        cache.index.copy_(idx + n_acc + 1)
        return out, n_acc + 1, bonus[:, 0]

    def _insert(self, adm: _Admission) -> None:
        """Copy the admitted lanes into their pool slots (never aliasing
        the slab) and set those slots' indices to the true prompt
        lengths and their last tokens to the sampled ones."""
        self._cmd(spmd.OP_INSERT, [adm.slab], adm.slots, [np.asarray(adm.lens, np.int32)])
        at = self._insert_lanes(adm.slab, adm.slots, adm.lens)
        if adm.dslab is not None:
            self._copy_lanes(self._draft_cache, adm.dslab, at, adm.lens)
        self._toks.index_copy_(0, at, adm.toks)

    def _insert_lanes(self, slab: KVCache, slots, lens) -> torch.Tensor:
        """The pool cache's part of an insert (every rank's); returns the
        slots on the device."""
        at = self._to_device(np.asarray(slots, np.int64))
        self._copy_lanes(self._cache, slab, at, lens)
        return at

    def _copy_lanes(self, cache: KVCache, slab: KVCache, at: torch.Tensor, lens) -> None:
        for big, small in zip(cache.keys + cache.values, slab.keys + slab.values):
            big.index_copy_(0, at, small)
        cache.index.index_copy_(0, at, self._to_device(np.asarray(lens, np.int32)))

    def _chunk_mid(self, slab: KVCache, ids: np.ndarray, offset: int) -> None:
        """Advance a one-lane slab by one full chunk of prompt tokens."""
        self._cmd(spmd.OP_CHUNK_MID, [slab], [offset], [ids])
        positions = torch.arange(offset, offset + len(ids), device=self._device)[None]
        self._model(self._to_device(ids[None]), positions=positions, cache=slab,
                    return_hidden=True)

    def _chunk_final(self, slab: KVCache, rest: np.ndarray, offset: int, gen,
                     P: int | None = None) -> torch.Tensor:
        """The last chunk, padded to its suffix bucket ``P`` (the leader's
        choice), sampled at the prompt's true last position."""
        P = self._bucket(len(rest)) if P is None else P
        self._cmd(spmd.OP_CHUNK_FINAL, [slab], [offset, P], [rest])
        tail = np.zeros((1, P), np.int32)
        tail[0, :len(rest)] = rest
        positions = torch.arange(offset, offset + P, device=self._device)[None]
        hidden = self._model(self._to_device(tail), positions=positions, cache=slab,
                             return_hidden=True)
        return self._sample(hidden[:, len(rest) - 1], gen)

    # -- the loop ------------------------------------------------------------
    def _loop(self) -> None:
        enter_device(self._device)
        with torch.inference_mode():
            while True:
                # a mid-chunk admission is live work even with no active
                # slots and an empty queue: never block on the queue then
                self._drain(block=not self._any_active() and self._chunking is None)
                if self._stopping:
                    break  # stop() fails active slots + pending
                try:
                    self._tick()
                except Exception as e:  # noqa: BLE001 — never die silently
                    logger.exception("engine tick failed")
                    self._fail_all(e)
                    if self._chan is not None:
                        # the followers may be mid-call: the group stops
                        with self._enqueue_lock:
                            self._stopping = True
                        self._chan.close()
                        self._fail_queued(e)
                        return
            if self._chan is not None:
                if self._kv is not None:
                    try:
                        self._exported = self._export_all()
                    except Exception:  # noqa: BLE001 — the sessions then cold-start
                        logger.exception("tp session export failed")
                self._chan.close()

    def _drain(self, block: bool) -> None:
        """Pull queued requests into the host-side pending list; blocks for
        the first one only when the engine is otherwise idle."""
        while True:
            try:
                item = self._queue.get(block=block and not self._pending and not self._tasks
                                       and not self._stopping)
            except queue.Empty:
                return
            if item is None:                           # stop signal
                self._stopping = True
                return
            (self._tasks if isinstance(item, _Task) else self._pending).append(item)
            block = False

    def _tick(self) -> None:
        """One engine tick: every prefix hit at the queue's front and at
        most one cold admission dispatch (a prefill group, or one chunk of
        the chunked admission), the decode chunk for the lanes already live
        (speculative rounds with ``spec_k``), the inserts, then one read
        back to the host."""
        while self._tasks:
            task = self._tasks.popleft()
            sent = self._sent()
            try:
                task.future.set_result(task.fn())
            except BaseException as e:  # noqa: BLE001 — the future must resolve
                task.future.set_exception(e)
                if not self._local_failure(sent):
                    raise
        active = [i for i, s in enumerate(self._slots) if not s.free]
        pres: list[_Admission] = []
        t0 = time.monotonic()
        taken: set[int] = set()       # slots this tick's admissions claimed
        if self._chunking is not None:
            taken.add(self._chunking.slot)
        # every consecutive prefix hit at the queue's front: each is a cheap
        # one-lane suffix prefill, and a shared-prefix burst must not admit
        # one request a tick
        while (reuse := self._next_reuse(taken)) is not None:
            pre = self._dispatch_reuse(*reuse)
            if pre is not None:
                taken.add(reuse[0])
                pres.append(pre)
        if self._chunking is None:
            self._maybe_start_chunk(taken)
        if self._chunking is not None:
            pre = self._advance_chunk()
        else:
            group = self._next_group(taken)
            pre = self._dispatch_prefill(*group) if group is not None else None
        if pre is not None:
            pres.append(pre)
        if pres and active:
            with self._stats_lock:
                self._prefill_stall_s += time.monotonic() - t0
        # from here to the read, an error leaves admitted requests in no
        # slot, where _fail_all cannot see them: fail them before re-raising
        try:
            dec = counts = None
            if active:
                if self._spec_k:
                    dec, counts, self._toks = self._spec(self._cache, self._draft_cache,
                                                         self._toks)
                else:
                    dec, self._toks = self._step(self._cache, self._toks, self._gen)
            for adm in pres:
                self._insert(adm)
            # the tick's one device-to-host copy: the decode chunk (and the
            # speculative counts) and every admission's first tokens
            parts = [t.reshape(-1) for t in (dec, counts) if t is not None]
            parts += [a.toks for a in pres]
            host = torch.cat(parts).cpu().numpy() if parts else np.zeros(0, np.int32)
        except Exception as e:  # noqa: BLE001
            for adm in pres:
                for req in adm.reqs:
                    req.future.set_exception(e)
            with self._stats_lock:
                self._failed_requests += sum(len(a.reqs) for a in pres)
            raise
        at = 0
        if dec is not None:
            at = dec.numel()
            if counts is not None:
                self._finish_spec(host[:at].reshape(dec.shape),
                                  host[at:at + counts.numel()].reshape(counts.shape), len(active))
                at += counts.numel()
            else:
                self._finish_decode(host[:at].reshape(dec.shape), len(active))
        for adm in pres:
            self._finish_prefill(adm.slots, adm.reqs, host[at:at + len(adm.reqs)])
            at += len(adm.reqs)

    def _fail_all(self, e: Exception) -> None:
        n = 0
        for s in self._slots:
            if s.request is not None:
                s.request.future.set_exception(e)
                s.request = None
                n += 1
        if self._chunking is not None:
            self._chunking.req.future.set_exception(e)
            self._chunking = None
            n += 1
        with self._stats_lock:
            self._failed_requests += n

    def _any_active(self) -> bool:
        return any(not s.free for s in self._slots)

    def _bucket(self, n: int) -> int:
        """Smallest prefill bucket holding an n-token prompt."""
        return next(b for b in self._buckets if n <= b)

    def _next_group(self, taken: set[int]) -> tuple[int, list[int], list[_Request]] | None:
        """The next same-bucket run of pending requests (FIFO) as one
        prefill group, capped by the free slots outside ``taken`` and the
        largest ``PREFILL_KS`` size, cut down to a size on the ladder."""
        if self._stopping or not self._pending:
            return None
        free = [i for i, s in enumerate(self._slots) if s.free and i not in taken]
        if not free:
            return None
        P = self._bucket(len(self._pending[0].ids))
        reqs: list[_Request] = []
        cap = min(len(free), self.PREFILL_KS[0])
        while self._pending and len(reqs) < cap and self._bucket(len(self._pending[0].ids)) == P:
            reqs.append(self._pending.popleft())
        K = next(k for k in self.PREFILL_KS if k <= len(reqs))
        for req in reversed(reqs[K:]):                 # overflow back, FIFO kept
            self._pending.appendleft(req)
        return P, free[:K], reqs[:K]

    def _dispatch_prefill(self, P: int, slots: list[int],
                          reqs: list[_Request]) -> _Admission | None:
        """Dispatch (not read) one prefill group; on an error this group's
        futures fail here and None is returned."""
        K = len(reqs)
        if self._kv is not None:
            self._kv_misses += K
            self._prefill_tokens += sum(len(r.ids) for r in reqs)
        sent = self._sent()
        try:
            ids = np.zeros((K, P), np.int32)
            lens = np.zeros(K, np.int32)
            for i, req in enumerate(reqs):
                ids[i, :len(req.ids)] = req.ids
                lens[i] = len(req.ids)
            slab, toks = self._prefill(ids, lens, self._gen)
            dslab = self._draft_prefill(ids) if self._spec_k else None
            return _Admission(slab, toks, slots, reqs, lens.tolist(), dslab)
        except Exception as e:  # noqa: BLE001 — fail THIS group only
            if not self._local_failure(sent):
                raise
            logger.exception("prefill failed (bucket %d, %d reqs)", P, K)
            for req in reqs:
                req.future.set_exception(e)
            with self._stats_lock:
                self._failed_requests += K
            return None

    # -- chunked prefill (long admissions) -------------------------------------
    def _maybe_start_chunk(self, taken: set[int]) -> None:
        """Claim the front pending request as a chunked admission when its
        prompt exceeds the chunk size.  The last chunk pads to its suffix
        bucket and its cache write is a slab whose start clamps to fit, so
        a prompt whose last chunk would overhang the cache falls back to
        the one-pass prefill, which always fits by submit()'s bound."""
        C = self._chunk_tokens
        if not C or self._stopping or not self._pending:
            return
        n = len(self._pending[0].ids)
        if n <= C:
            return
        off = C * ((n - 1) // C)
        if off + self._bucket(n - off) > self._cache_len:
            return
        slot = next((i for i, s in enumerate(self._slots) if s.free and i not in taken), None)
        if slot is None:
            return
        req = self._pending.popleft()
        if self._kv is not None:
            # one cold admission, counted once at its start
            self._kv_misses += 1
            self._prefill_tokens += len(req.ids)
        self._chunking = _ChunkState(req, slot, self._slab(1), 0)
        with self._stats_lock:
            self._chunked_admissions += 1

    def _advance_chunk(self) -> _Admission | None:
        """Dispatch one chunk of the chunked admission.  A middle chunk
        writes straight into the private slab; the last one samples the
        first token and returns an admission for the shared insert path."""
        st = self._chunking
        assert st is not None
        ids, C = st.req.ids, self._chunk_tokens
        rest = len(ids) - st.offset
        sent = self._sent()
        try:
            if rest > C:
                self._chunk_mid(st.slab, ids[st.offset:st.offset + C], st.offset)
                st.offset += C
                with self._stats_lock:
                    self._prefill_chunks += 1
                return None
            toks = self._chunk_final(st.slab, ids[st.offset:], st.offset, self._gen)
            self._chunking = None
            with self._stats_lock:
                self._prefill_chunks += 1
            dslab = self._draft_slab_for(st.req) if self._spec_k else None
            return _Admission(st.slab, toks, [st.slot], [st.req], [len(ids)], dslab)
        except Exception as e:  # noqa: BLE001 — fail THIS request only
            if not self._local_failure(sent):
                raise
            logger.exception("chunked prefill failed (offset %d of %d)", st.offset, len(ids))
            st.req.future.set_exception(e)
            self._chunking = None
            with self._stats_lock:
                self._failed_requests += 1
            return None

    # -- prefix reuse (paged engines) -----------------------------------------
    def _next_reuse(self, taken: set[int]) -> tuple[int, _Request, list] | None:
        """The front pending request as a one-lane reuse admission when it
        extends a committed chain (FIFO kept: a miss at the front falls
        through to the cold path unchanged)."""
        if self._kv is None or not self._reuse or self._stopping or not self._pending:
            return None
        free = next((i for i, s in enumerate(self._slots) if s.free and i not in taken), None)
        if free is None:
            return None
        req0 = self._pending[0]
        chain = self._kv.match(req0.ids)
        while chain:
            # the suffix pads to its bucket and the cache write clamps its
            # start to fit: an overhanging suffix would slide back over the
            # gathered prefix and poison the pool at commit.  Shorten the
            # chain until prefix + suffix bucket fits (no chain: the cold
            # path, which always fits)
            prefix = len(chain) * self._kv.block
            if prefix + self._bucket(len(req0.ids) - prefix) <= self._cache_len:
                break
            chain.pop()
        if not chain:
            return None
        return free, self._pending.popleft(), chain

    def _dispatch_reuse(self, slot: int, req: _Request, chain: list) -> _Admission | None:
        """Dispatch one prefix hit: gather the chain into a fresh one-lane
        slab and prefill only the suffix, padded to its bucket."""
        prefix_len = len(chain) * self._kv.block
        suffix = req.ids[prefix_len:]
        self._kv_hits += 1
        self._prefill_tokens += len(req.ids)
        self._prefill_tokens_skipped += prefix_len
        sent = self._sent()
        try:
            slab = self._slab(1)
            self._kv.load_prefix_into(slab, [nd.block_id for nd in chain], prefix_len)
            toks = self._chunk_final(slab, suffix, prefix_len, self._gen)
            dslab = self._draft_slab_for(req) if self._spec_k else None
            return _Admission(slab, toks, [slot], [req], [len(req.ids)], dslab)
        except Exception as e:  # noqa: BLE001 — fail THIS request only
            if not self._local_failure(sent):
                raise
            logger.exception("reuse prefill failed (suffix %d, %d blocks)", len(suffix),
                             len(chain))
            req.future.set_exception(e)
            with self._stats_lock:
                self._failed_requests += 1
            return None

    # -- finishing -------------------------------------------------------------
    def _finish_prefill(self, slots: list[int], reqs: list[_Request],
                        toks: np.ndarray) -> None:
        for slot, req, tok in zip(slots, reqs, toks.tolist()):
            s = self._slots[slot]
            s.request = req
            s.emitted = [int(tok)]
            s.remaining = req.max_new - 1
            if s.remaining == 0 or int(tok) == self._eos:
                self._finish(slot)

    def _finish_decode(self, toks: np.ndarray, n_active: int) -> None:
        """Consume one decode chunk ``[slots, T]``.  Runs before this
        tick's prefills finish, so lanes filled this tick are still free
        here and never consume a chunk that predates their insert."""
        with self._stats_lock:
            self._lane_steps += len(self._slots) * self._T
            self._active_lane_steps += n_active * self._T
        for i, s in enumerate(self._slots):
            if s.free:
                continue
            for t in range(self._T):
                if s.remaining <= 0:
                    break
                tok = int(toks[i, t])
                s.emitted.append(tok)
                s.remaining -= 1
                if tok == self._eos or s.remaining == 0:
                    self._finish(i)
                    break

    def _finish_spec(self, toks: np.ndarray, counts: np.ndarray, n_active: int) -> None:
        """Consume one speculative chunk ``toks [R, slots, k+1]``, of which
        ``counts[r, i]`` tokens a round are a lane's (the
        :meth:`_finish_decode` contract, ragged per round)."""
        R = toks.shape[0]
        lane_tokens = R * (self._spec_k + 1)
        with self._stats_lock:
            self._lane_steps += len(self._slots) * lane_tokens
            self._active_lane_steps += n_active * lane_tokens
            self._spec_rounds_run += R
        for i, s in enumerate(self._slots):
            if s.free:
                continue
            with self._stats_lock:
                # counts - 1 drafts accepted of k proposed, a round
                self._spec_proposed += R * self._spec_k
                self._spec_accepted += int(counts[:, i].sum()) - R
            done = False
            for r in range(R):
                for t in range(int(counts[r, i])):
                    if s.remaining <= 0:
                        done = True
                        break
                    tok = int(toks[r, i, t])
                    s.emitted.append(tok)
                    s.remaining -= 1
                    if tok == self._eos or s.remaining == 0:
                        self._finish(i)
                        done = True
                        break
                if done:
                    break

    def _finish(self, slot: int) -> None:
        s = self._slots[slot]
        req = s.request
        assert req is not None
        out = np.asarray(s.emitted, np.int32)
        if self._eos is not None and self._eos in s.emitted:
            out = out[:s.emitted.index(self._eos) + 1]
        if self._kv is not None:
            sent = self._sent()
            try:
                self._kv_commit(slot, req, s.emitted)
            except Exception:  # noqa: BLE001 — the pool is an accelerator
                if not self._local_failure(sent):
                    raise
                logger.exception("kv commit failed for slot %d (request unaffected)", slot)
        with self._stats_lock:
            self._done_requests += 1
            self._emitted_tokens += len(out)
        s.request = None
        s.emitted = []
        req.future.set_result(out)

    def _kv_commit(self, slot: int, req: _Request, emitted: list[int]) -> None:
        """Persist the finished lane's full KV blocks into the pool and pin
        the chain for the request's session.  The lane holds KV for every
        processed token, the prompt and each emitted token fed back, so the
        committed sequence is ``prompt + emitted[:-1]``."""
        seq = np.concatenate([req.ids, np.asarray(emitted[:-1], np.int32)])
        start_block, new_ids, tail = self._kv.commit(seq)
        self._kv.store_blocks(self._cache, slot, start_block, new_ids)
        if req.session is not None and tail is not None:
            self._kv.pin_session(req.session, tail)
