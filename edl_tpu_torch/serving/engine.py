"""Slot-based continuous batching for TransformerLM decode (the port of the
JAX package's ``serving/engine.py:ContinuousBatcher``, without mesh,
paging or speculative decoding).

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

Not ported (ROADMAP.md Queue 1 item 6): the paged KV pool with prefix
reuse and session export/import (``kv_block > 0``), speculative decoding
(``spec_k > 0``), and mesh serving (``mesh``, after item 4c); each raises
``NotImplementedError``.
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

from edl_tpu_torch.models.generate import sample_logits
from edl_tpu_torch.models.transformer import KVCache, TransformerLM, decode_model
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
    __slots__ = ("ids", "max_new", "future")

    def __init__(self, ids: np.ndarray, max_new: int):
        self.ids = ids
        self.max_new = max_new
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
    tokens (on the device), and where they go."""

    slab: KVCache
    toks: torch.Tensor
    slots: list[int]
    reqs: list[_Request]
    lens: list[int]


class ContinuousBatcher:
    """``submit(prompt_1d) -> Future[np.ndarray]`` over a slot pool.

    ``model`` is the trained :class:`TransformerLM` (its decode copy, with
    the weights cast once to the compute dtype, is built here) on the
    device the engine runs on.  ``max_len`` bounds prompt + generation
    per slot (default ``model.cfg.max_len``); the pool cache is ``[slots,
    ..., max_len]``.  ``steps_per_sync`` trades scheduling latency for
    fewer host round trips: a finished slot wastes at most
    ``steps_per_sync - 1`` lane-steps before the host notices.
    """

    def __init__(self, model: TransformerLM, *, slots: int = 8, max_len: int | None = None,
                 prefill_buckets: tuple[int, ...] = DEFAULT_PREFILL_BUCKETS,
                 temperature: float = 1.0, top_k: int = 0, top_p: float = 0.0,
                 eos_id: int | None = None, steps_per_sync: int = 8, rng_seed: int = 20_26,
                 mesh=None, kv_block: int = 0, prefill_chunk: int | None = None,
                 spec_k: int | None = None):
        if mesh is not None:
            raise NotImplementedError("mesh serving is not ported yet (ROADMAP.md Queue 1 "
                                      "item 6, after item 4c)")
        if kv_block > 0:
            raise NotImplementedError("the paged KV cache is not ported yet (ROADMAP.md "
                                      "Queue 1 item 6: serving/kv_cache.py)")
        if (constants.spec_k() if spec_k is None else int(spec_k)) > 0:
            raise NotImplementedError("speculative decoding is not ported yet (ROADMAP.md "
                                      "Queue 1 item 6)")
        cache_len = max_len or model.cfg.max_len
        self.cfg = model.cfg
        self._model = decode_model(model)
        self._mcfg = self._model.cfg
        self._device = self._model.tok_embed.weight.device
        self._cache_len = cache_len
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
        self._T = max(1, steps_per_sync)
        self._gen = torch.Generator(device=self._device).manual_seed(rng_seed)
        self._cache = KVCache.zeros(self._mcfg, slots, cache_len, self._device)
        self._toks = torch.zeros(slots, dtype=torch.int32, device=self._device)
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
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="continuous-batcher")
        self._thread.start()

    # -- public --------------------------------------------------------------
    def submit(self, prompt: np.ndarray, max_new_tokens: int) -> Future:
        """Queue one prompt (1-D int32).  The future resolves to the
        generated tokens (<= max_new_tokens; truncated after eos_id)."""
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
        req = _Request(ids, max_new_tokens)
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

    def _in_flight(self) -> int:
        with self._enqueue_lock, self._stats_lock:
            return self._submitted_requests - self._done_requests - self._failed_requests

    def warm(self, prompt_len: int) -> None:
        """Run, before traffic arrives, every computation that serving
        ``prompt_len``-class prompts reaches: the prefill at each
        ``PREFILL_KS`` sub-batch size, a decode step, and the chunk pair
        when the prompt would be chunked, on scratch caches (the card's
        first call of a shape picks its library kernels and grows the
        allocator's pools).  Only legal while no request is in flight,
        and enforced: a request submitted but not finished raises."""
        in_flight = self._in_flight()
        if in_flight:
            raise RuntimeError(f"ContinuousBatcher.warm() called with {in_flight} request(s) "
                               "in flight; warm() must run before the first submit()")
        enter_device(self._device)
        gen = torch.Generator(device=self._device).manual_seed(0)
        with torch.inference_mode():
            P = self._bucket(prompt_len)
            for K in self.PREFILL_KS:
                self._prefill(np.zeros((K, P), np.int32), np.ones(K, np.int32), gen)
            self._step(KVCache.zeros(self._mcfg, len(self._slots), self._cache_len,
                                     self._device),
                       torch.zeros(len(self._slots), dtype=torch.int32, device=self._device),
                       gen)
            C = self._chunk_tokens
            if C and prompt_len > C:
                off = C * ((prompt_len - 1) // C)
                if off + self._bucket(prompt_len - off) <= self._cache_len:
                    slab = KVCache.zeros(self._mcfg, 1, self._cache_len, self._device)
                    self._chunk_mid(slab, np.zeros(C, np.int32), 0)
                    self._chunk_final(slab, np.ones(prompt_len - off, np.int32), C, gen)
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
            }

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
        self._thread.join(timeout=30.0)
        for s in self._slots:
            if s.request is not None:
                s.request.future.set_exception(RuntimeError("engine stopped mid-generation"))
                s.request = None
        if self._chunking is not None:
            self._chunking.req.future.set_exception(RuntimeError("engine stopped mid-prefill"))
            self._chunking = None
        for pending in (self._pending, self._tasks):
            while pending:
                pending.popleft().future.set_exception(RuntimeError("engine stopped"))
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                item.future.set_exception(RuntimeError("engine stopped"))

    # -- device work -----------------------------------------------------------
    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        # non_blocking: a copy from pageable memory is staged at once, and
        # the stream is not synchronised (the tick's one sync is its read)
        return torch.from_numpy(a).to(self._device, non_blocking=True)

    def _sample(self, hidden: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
        """``[B, D]`` final-norm hidden states -> ``[B]`` tokens, through the
        head on those rows only; :func:`generate`'s sampling recipe."""
        return sample_logits(self._model.head(hidden), gen, temperature=self._temperature,
                             top_k=self._top_k, top_p=self._top_p)

    def _prefill(self, ids: np.ndarray, lens: np.ndarray, gen) -> tuple[KVCache, torch.Tensor]:
        """A fresh K-lane cache holding the padded prompts ``ids [K, P]``,
        and one token per lane sampled at its last real position (the pad
        positions' keys lie past ``lens``, where the insert's index reset
        and the masks keep them unread)."""
        K = ids.shape[0]
        slab = KVCache.zeros(self._mcfg, K, self._cache_len, self._device)
        hidden = self._model(self._to_device(ids), cache=slab, return_hidden=True)
        last = self._to_device(lens.astype(np.int64) - 1)
        rows = torch.arange(K, device=self._device)
        return slab, self._sample(hidden[rows, last], gen)

    def _step(self, cache: KVCache, toks: torch.Tensor, gen) -> tuple[torch.Tensor,
                                                                     torch.Tensor]:
        """Advance every lane of ``cache`` ``steps_per_sync`` tokens from
        ``toks [slots]``, each at the position its cache index holds; returns
        the tokens ``[slots, T]`` and the last ones, on the device."""
        out = []
        for _ in range(self._T):
            hidden = self._model(toks[:, None], positions=cache.index[:, None], cache=cache,
                                 return_hidden=True)
            toks = self._sample(hidden[:, 0], gen)
            out.append(toks)
        return torch.stack(out, dim=1), toks

    def _insert(self, adm: _Admission) -> None:
        """Copy the admitted lanes into their pool slots (never aliasing
        the slab) and set those slots' indices to the true prompt
        lengths and their last tokens to the sampled ones."""
        at = self._to_device(np.asarray(adm.slots, np.int64))
        for big, small in zip(self._cache.keys + self._cache.values,
                              adm.slab.keys + adm.slab.values):
            big.index_copy_(0, at, small)
        self._cache.index.index_copy_(0, at, self._to_device(np.asarray(adm.lens, np.int32)))
        self._toks.index_copy_(0, at, adm.toks)

    def _chunk_mid(self, slab: KVCache, ids: np.ndarray, offset: int) -> None:
        """Advance a one-lane slab by one full chunk of prompt tokens."""
        positions = torch.arange(offset, offset + len(ids), device=self._device)[None]
        self._model(self._to_device(ids[None]), positions=positions, cache=slab,
                    return_hidden=True)

    def _chunk_final(self, slab: KVCache, rest: np.ndarray, offset: int,
                     gen) -> torch.Tensor:
        """The last chunk, padded to its suffix bucket, sampled at the
        prompt's true last position."""
        P = self._bucket(len(rest))
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
                    return  # stop() fails active slots + pending
                try:
                    self._tick()
                except Exception as e:  # noqa: BLE001 — never die silently
                    logger.exception("engine tick failed")
                    self._fail_all(e)

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
        """One engine tick: at most one admission dispatch (a prefill group,
        or one chunk of the chunked admission), the decode chunk for the
        lanes already live, the insert, then one read back to the host."""
        while self._tasks:
            task = self._tasks.popleft()
            try:
                task.future.set_result(task.fn())
            except BaseException as e:  # noqa: BLE001 — the future must resolve
                task.future.set_exception(e)
        active = [i for i, s in enumerate(self._slots) if not s.free]
        pres: list[_Admission] = []
        t0 = time.monotonic()
        taken: set[int] = set()
        if self._chunking is not None:
            taken.add(self._chunking.slot)
        else:
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
            dec = None
            if active:
                dec, self._toks = self._step(self._cache, self._toks, self._gen)
            for adm in pres:
                self._insert(adm)
            # the tick's one device-to-host copy: the decode chunk and every
            # admission's first tokens
            parts = ([dec.reshape(-1)] if dec is not None else []) + [a.toks for a in pres]
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
        try:
            ids = np.zeros((K, P), np.int32)
            lens = np.zeros(K, np.int32)
            for i, req in enumerate(reqs):
                ids[i, :len(req.ids)] = req.ids
                lens[i] = len(req.ids)
            slab, toks = self._prefill(ids, lens, self._gen)
            return _Admission(slab, toks, slots, reqs, lens.tolist())
        except Exception as e:  # noqa: BLE001 — fail THIS group only
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
        self._chunking = _ChunkState(req, slot,
                                     KVCache.zeros(self._mcfg, 1, self._cache_len, self._device),
                                     0)
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
            return _Admission(st.slab, toks, [st.slot], [st.req], [len(ids)])
        except Exception as e:  # noqa: BLE001 — fail THIS request only
            logger.exception("chunked prefill failed (offset %d of %d)", st.offset, len(ids))
            st.req.future.set_exception(e)
            self._chunking = None
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

    def _finish(self, slot: int) -> None:
        s = self._slots[slot]
        req = s.request
        assert req is not None
        out = np.asarray(s.emitted, np.int32)
        if self._eos is not None and self._eos in s.emitted:
            out = out[:s.emitted.index(self._eos) + 1]
        with self._stats_lock:
            self._done_requests += 1
            self._emitted_tokens += len(out)
        s.request = None
        s.emitted = []
        req.future.set_result(out)
