"""Paged KV block pool with a token-exact prefix-reuse index (the port of
the JAX package's ``serving/kv_cache.py``).

KV state, chunked into fixed-size **blocks**, persists across requests
in a device-resident block pool and is found again through a prefix trie,
so an admission whose prompt extends a committed chain prefills only the
suffix.

- **paging at the admission boundary**: decode keeps reading one
  contiguous slab per slot (the :class:`~edl_tpu_torch.models.transformer.
  KVCache` layouts).  A prefix hit gathers its chain into the fresh slot
  slab (:meth:`PagedKVCache.load_prefix_into`); a finished request's full
  blocks scatter back into the pool (:meth:`PagedKVCache.store_blocks`).
  Both are indexing ops on the device with no host read;
- **hash-chain trie**: a block's identity is its token chunk in its
  chain, so a block is reused only at the absolute position (RoPE) it was
  computed at;
- **copy-on-write by immutability**: committed blocks are never written
  again; a reused chain is *copied* into the admitting slot's slab, so a
  diverging continuation commits new blocks under new chain keys;
- **refcount + LRU**: session pins refcount chain tails (a node with
  children is never evictable); allocation evicts the least recently used
  unpinned leaf when the free list runs dry, and a commit that finds no
  block is truncated and counted, never an error;
- **migration-portable**: a pinned chain exports as ``(meta, blob)`` in
  the JAX package's format, byte for byte (per layer in the flax cache's
  name order, ``layer_0, layer_1, layer_10, ...``, the k blocks then the
  v blocks, raw; bf16 travels as its 16-bit words under the name
  ``"bfloat16"``), so a session moves between a JAX and a port replica;
- **tensor-parallel** (``mesh``): each rank of the ``tp`` group holds its
  own pools over its kv heads (``[n_blocks, Hk/tp, ...]``; whole where
  the engine's slot cache keeps them whole, as for MQA), all with the
  same block ids, so the one trie on the leader indexes every rank's
  pools and a block move never leaves its rank.  The leader sends each
  gather, scatter and import to the followers as a command carrying the
  block ids (``serving/spmd.py``); an export gathers every rank's heads
  into the blob of one process, and an import cuts a blob to each rank's
  heads, so a blob does not depend on the mesh.

The host half (trie, heap, free list, pins) is the JAX module's, line for
line; on a mesh only the leader uses it.  Thread model: single writer;
every mutating call runs on the engine thread, and
:meth:`PagedKVCache.export_chain` only after it stopped (on a mesh, on
the engine thread as it stops).
"""

from __future__ import annotations

import heapq
from collections import OrderedDict

import numpy as np
import torch

from edl_tpu_torch.models.transformer import kv_split, local_kv_heads
from edl_tpu_torch.parallel.tp import TP
from edl_tpu_torch.serving.spmd import OP_KV_EXPORT, OP_KV_IMPORT, OP_KV_LOAD, OP_KV_STORE

# the blob's dtype names (numpy's, which the JAX package writes; numpy has
# no bfloat16 here, so those blocks travel as 16-bit words)
_DTYPE_NAMES = {torch.float32: "float32", torch.float16: "float16",
                torch.bfloat16: "bfloat16"}
_WIRE_VIEW = {torch.float32: torch.float32, torch.float16: torch.float16,
              torch.bfloat16: torch.int16}
_NUMPY_OF = {torch.float32: np.float32, torch.float16: np.float16, torch.int16: np.int16}


def layer_names(num_layers: int) -> list[str]:
    """The flax cache's layer names in the order the JAX blob lists them:
    sorted as strings, so ``layer_10`` comes before ``layer_2``."""
    return sorted(f"layer_{i}" for i in range(num_layers))


class _Node:
    """One committed block in the prefix trie."""

    __slots__ = ("chunk", "block_id", "parent", "children", "pins", "last_use")

    def __init__(self, chunk: tuple, block_id: int, parent: "_Node | None"):
        self.chunk = chunk
        self.block_id = block_id
        self.parent = parent
        self.children: dict[tuple, _Node] = {}
        self.pins = 0
        self.last_use = 0


class PagedKVCache:
    """Device block pools (one k and one v tensor per layer, ``k [n_blocks,
    Hk, D, block]`` and ``v [n_blocks, Hk, block, D]``) plus the host-side
    prefix trie, free list, session pins and eviction policy.  ``cfg`` is
    the decode model's config (layers, kv heads, head dim, dtype) and
    ``max_len`` its cache length.  ``mesh``: the pools hold this rank's kv
    heads of the mesh's ``tp`` group, driven through the group's
    ``channel`` (:class:`~edl_tpu_torch.serving.spmd.Channel`; the
    engine's)."""

    def __init__(self, cfg, max_len: int, block: int, n_blocks: int, max_sessions: int,
                 device: torch.device | str | None = None, mesh=None, channel=None):
        self._tp = TP.of(mesh) if mesh is not None else None
        if self._tp is not None and channel is None:
            raise ValueError("a tensor-parallel KV pool is driven through its tp group's "
                             "channel (serving/spmd.py)")
        self._chan = channel if self._tp is not None else None
        # split exactly when the engine splits its slot cache (kv_split)
        self._split = kv_split(cfg, self._tp)
        if block < 1:
            raise ValueError(f"kv block size must be >= 1, got {block}")
        if n_blocks < 1:
            raise ValueError(f"kv pool needs >= 1 block, got {n_blocks}")
        if block > max_len:
            raise ValueError(f"kv block {block} exceeds cache length {max_len}")
        self.block = int(block)
        self.n_blocks = int(n_blocks)
        self.max_len = max_len
        self._layers = layer_names(cfg.num_layers)
        self._index = {name: int(name.split("_")[1]) for name in self._layers}
        self._hk_all, self._d, self._dtype = cfg.kv_heads, cfg.head_dim, cfg.dtype
        self._hk = local_kv_heads(cfg, self._tp)
        if self._dtype not in _DTYPE_NAMES:
            raise ValueError(f"kv pool dtype {self._dtype} has no wire name")
        self._device = torch.device(device) if device is not None else torch.device("cpu")
        # block 0 is a reserved scratch block (never allocated)
        hk, d, bs = self._hk, self._d, self.block
        self.k = [torch.zeros(n_blocks, hk, d, bs, dtype=self._dtype, device=self._device)
                  for _ in range(cfg.num_layers)]
        self.v = [torch.zeros(n_blocks, hk, bs, d, dtype=self._dtype, device=self._device)
                  for _ in range(cfg.num_layers)]
        self._free: list[int] = list(range(n_blocks - 1, 0, -1))
        self._root = _Node((), 0, None)
        self._nodes: set[_Node] = set()         # every live non-root node
        # lazy min-heap of eviction candidates (last_use, seq, node), pushed
        # on every candidate transition and validated on pop
        self._evict_heap: list[tuple[int, int, _Node]] = []
        self._heap_seq = 0
        self._sessions: OrderedDict[str, _Node] = OrderedDict()
        self._max_sessions = max(1, int(max_sessions))
        self._clock = 0
        self.evictions = 0
        self.commit_skips = 0

    # -- host index ----------------------------------------------------------
    def _chunks(self, tokens, n: int):
        bs = self.block
        return [tuple(int(t) for t in tokens[i * bs:(i + 1) * bs]) for i in range(n)]

    def match(self, tokens) -> list[_Node]:
        """Longest committed chain covering full-block prefixes of
        ``tokens``, capped so at least one prompt token is left to prefill
        (the admission needs its logits to sample from)."""
        max_blocks = (len(tokens) - 1) // self.block
        node = self._root
        chain: list[_Node] = []
        for chunk in self._chunks(tokens, max_blocks):
            child = node.children.get(chunk)
            if child is None:
                break
            chain.append(child)
            node = child
        self._clock += 1
        for nd in chain:
            nd.last_use = self._clock
        return chain

    def commit(self, tokens) -> tuple[int, list[int], "_Node | None"]:
        """Extend the trie with every full block of ``tokens`` not yet
        committed.  Returns ``(first_new_block_index, new_block_ids,
        tail_node)``; the caller writes the new blocks' KV
        (:meth:`store_blocks`).  A dry pool truncates the commit (counted
        in ``commit_skips``)."""
        n_full = len(tokens) // self.block
        node = self._root
        chunks = self._chunks(tokens, n_full)
        i = 0
        while i < n_full:
            child = node.children.get(chunks[i])
            if child is None:
                break
            node = child
            i += 1
        start = i
        new_ids: list[int] = []
        for chunk in chunks[start:]:
            child = self._extend(node, chunk)
            if child is None:
                break
            node = child
            new_ids.append(child.block_id)
        tail = node if node is not self._root else None
        return start, new_ids, tail

    def _extend(self, node: _Node, chunk: tuple) -> "_Node | None":
        """Attach one new child block under ``node`` (commit and import
        share it).  The walk tail is pinned across the allocation so that
        eviction cannot take it.  Returns None on a dry pool."""
        node.pins += 1
        bid = self._alloc()
        self._unpin(node)
        if bid is None:
            self.commit_skips += 1
            return None
        child = _Node(chunk, bid, node)
        node.children[chunk] = child
        self._nodes.add(child)
        self._clock += 1
        child.last_use = self._clock
        self._heap_push(child)
        return child

    def _heap_push(self, nd: _Node) -> None:
        """Enter ``nd`` as an eviction candidate if it is one now
        (childless, unpinned, non-root); ``_alloc`` revalidates on pop."""
        if nd is self._root or nd.children or nd.pins:
            return
        self._heap_seq += 1
        heapq.heappush(self._evict_heap, (nd.last_use, self._heap_seq, nd))

    def _unpin(self, nd: _Node) -> None:
        """Drop one pin; a leaf whose last pin leaves re-enters the heap."""
        nd.pins -= 1
        self._heap_push(nd)

    def _alloc(self) -> int | None:
        if self._free:
            return self._free.pop()
        heap = self._evict_heap
        while heap:
            last_use, _, nd = heapq.heappop(heap)
            parent = nd.parent
            if parent is None or parent.children.get(nd.chunk) is not nd:
                continue                      # already evicted
            if nd.children or nd.pins:
                continue  # not a leaf / pinned; transitions re-push it
            if nd.last_use != last_use:
                self._heap_push(nd)           # touched since push: re-rank
                continue
            del parent.children[nd.chunk]
            self._nodes.discard(nd)
            if parent is not self._root and not parent.children:
                self._heap_push(parent)       # newly a leaf
            self.evictions += 1
            return nd.block_id
        return None

    # -- session pins --------------------------------------------------------
    def pin_session(self, session: str, node: _Node) -> None:
        old = self._sessions.pop(session, None)
        if old is not None:
            self._unpin(old)
        node.pins += 1
        self._sessions[session] = node
        while len(self._sessions) > self._max_sessions:
            _, stale = self._sessions.popitem(last=False)
            self._unpin(stale)

    def unpin_session(self, session: str) -> None:
        node = self._sessions.pop(session, None)
        if node is not None:
            self._unpin(node)

    def sessions(self) -> list[str]:
        """Pinned session ids: engine-thread or post-stop callers only
        (iterating races live pinning; other threads go through
        ``ContinuousBatcher.kv_pinned_sessions``)."""
        return list(self._sessions)

    def session_count(self) -> int:
        """A count that is safe to read from another thread."""
        return len(self._sessions)

    def chain_of(self, session: str) -> list[_Node]:
        node = self._sessions.get(session)
        chain: list[_Node] = []
        while node is not None and node is not self._root:
            chain.append(node)
            node = node.parent
        chain.reverse()
        return chain

    @staticmethod
    def chain_tokens(chain: list[_Node]) -> list[int]:
        return [t for nd in chain for t in nd.chunk]

    # -- stats ---------------------------------------------------------------
    def blocks_used(self) -> int:
        return self.n_blocks - 1 - len(self._free)

    def blocks_free(self) -> int:
        return len(self._free)

    # -- device ops ----------------------------------------------------------
    def _ids(self, block_ids: list[int]) -> torch.Tensor:
        # non_blocking: the stream is not synchronised (no host read)
        return torch.as_tensor(block_ids, dtype=torch.int64).to(self._device, non_blocking=True)

    def _leads(self) -> bool:
        return self._chan is not None and self._chan.leader

    def handlers(self) -> dict:
        """A follower's handlers of the pool's commands (``Channel.serve``)."""
        ch = self._chan
        return {OP_KV_LOAD: lambda c: self._load(ch.lookup(c.ints[0]), c.ints[2:], c.ints[1]),
                OP_KV_STORE: lambda c: self._store(ch.lookup(c.ints[0]), c.ints[1], c.ints[2],
                                                   c.ints[3:]),
                OP_KV_IMPORT: lambda c: self._upload(c.ints, c.arrays),
                OP_KV_EXPORT: lambda c: self._gather(c.ints)}

    def load_prefix_into(self, slab, block_ids: list[int], prefix_len: int) -> None:
        """Gather the blocks ``block_ids`` into the front of the one-lane
        cache ``slab`` (a copy: the pool is never aliased) and set its index
        to ``prefix_len``."""
        if self._leads():
            self._chan.send(OP_KV_LOAD, [self._chan.handle(slab), prefix_len, *block_ids])
        self._load(slab, block_ids, prefix_len)

    def _load(self, slab, block_ids: list[int], prefix_len: int) -> None:
        n, bs = len(block_ids), self.block
        ids = self._ids(block_ids)
        for li in range(len(self._layers)):
            k = self.k[li].index_select(0, ids)                  # [n, Hk, D, bs]
            slab.keys[li][0, :, :, :n * bs] = k.permute(1, 2, 0, 3).reshape(
                self._hk, self._d, n * bs)
            v = self.v[li].index_select(0, ids)                  # [n, Hk, bs, D]
            slab.values[li][0, :, :n * bs, :] = v.permute(1, 0, 2, 3).reshape(
                self._hk, n * bs, self._d)
        slab.index.fill_(prefix_len)

    def store_blocks(self, cache, slot: int, start_block: int, block_ids: list[int]) -> None:
        """Write blocks ``[start_block, start_block + len(ids))`` of the
        slot's slab in ``cache`` into the pool at ``block_ids``."""
        if not block_ids:
            return
        if self._leads():
            self._chan.send(OP_KV_STORE, [self._chan.handle(cache), slot, start_block,
                                          *block_ids])
        self._store(cache, slot, start_block, block_ids)

    def _store(self, cache, slot: int, start_block: int, block_ids: list[int]) -> None:
        n, bs = len(block_ids), self.block
        lo, hi = start_block * bs, (start_block + n) * bs
        ids = self._ids(block_ids)
        for li in range(len(self._layers)):
            k = cache.keys[li][slot, :, :, lo:hi].reshape(self._hk, self._d, n, bs)
            self.k[li].index_copy_(0, ids, k.permute(2, 0, 1, 3))
            v = cache.values[li][slot, :, lo:hi, :].reshape(self._hk, n, bs, self._d)
            self.v[li].index_copy_(0, ids, v.permute(1, 0, 2, 3))

    def _upload(self, block_ids: list[int], blocks: list[torch.Tensor]) -> None:
        """Write ``blocks`` (per layer in name order, k then v, every head,
        in the wire's view dtype) into the pools at ``block_ids``: this
        rank's heads of each."""
        ids = self._ids(block_ids)
        h0 = self._tp.rank * self._hk if self._split else 0
        at = 0
        for name in self._layers:
            li = self._index[name]
            for pool in (self.k[li], self.v[li]):
                up = blocks[at].view(self._dtype)[:, h0:h0 + self._hk]
                pool.index_copy_(0, ids, up.to(self._device))
                at += 1

    # -- migration wire format -----------------------------------------------
    def _layout(self) -> list:
        return [self._hk_all, self._d, _DTYPE_NAMES[self._dtype]]

    def _gather(self, block_ids: list[int]) -> list[torch.Tensor] | None:
        """The blocks ``block_ids`` of every pool (per layer in name order,
        k then v) with every rank's heads, on the leader's CPU (None on a
        follower)."""
        ids = self._ids(block_ids)
        out = []
        for name in self._layers:
            li = self._index[name]
            for pool in (self.k[li], self.v[li]):
                local = pool.index_select(0, ids)
                if self._split:
                    parts = self._chan.gather_to_leader(local)
                    local = None if parts is None else torch.cat(parts, dim=1)
                elif self._chan is not None and not self._chan.leader:
                    local = None
                out.append(None if local is None else local.cpu())
        return None if out and out[0] is None else out

    def export_chain(self, chain: list[_Node]) -> tuple[dict, bytes]:
        """``(meta, blob)`` of one chain: per layer (in name order) its k
        blocks then its v blocks, raw bytes concatenated; tokens travel
        beside it (the chain is the token sequence).  On a mesh the blob
        holds every rank's heads: the blob of one process."""
        block_ids = [nd.block_id for nd in chain]
        if self._leads():
            with self._chan.hold():       # the command and its gathers, back to back
                self._chan.send(OP_KV_EXPORT, block_ids)
                blocks = self._gather(block_ids)
        else:
            blocks = self._gather(block_ids)
        view = _WIRE_VIEW[self._dtype]
        parts = [t.view(view).numpy().tobytes() for t in blocks]
        meta = {"block": self.block, "n": len(chain), "layers": list(self._layers),
                "layout": {name: self._layout() for name in self._layers}}
        return meta, b"".join(parts)

    def import_chain(self, session: str, tokens: list[int], meta: dict, blob: bytes) -> int:
        """Adopt a migrated chain: dedup against blocks committed here,
        allocate and upload the rest, pin ``session`` at the tail.  Returns
        the number of blocks newly uploaded.  A pool too full for the whole
        chain truncates the import (the session resumes from the shorter
        prefix); one too full for even the first block raises."""
        n = int(meta["n"])
        if int(meta["block"]) != self.block:
            raise ValueError(f"kv import block size {meta['block']} != local {self.block}")
        if list(meta["layers"]) != self._layers:
            raise ValueError("kv import layer set mismatch")
        for name in self._layers:
            if list(meta["layout"][name]) != self._layout():
                raise ValueError(f"kv import layout mismatch at {name}")
        if len(tokens) < n * self.block:
            raise ValueError(f"kv import: {len(tokens)} tokens cannot cover "
                             f"{n} blocks of {self.block}")
        hk, d, bs = self._hk_all, self._d, self.block
        view = _WIRE_VIEW[self._dtype]
        item = torch.empty((), dtype=view).element_size()
        count = n * hk * d * bs
        arrays: dict[str, tuple[np.ndarray, np.ndarray]] = {}
        off = 0
        for name in self._layers:
            k = np.frombuffer(blob, _NUMPY_OF[view], count=count, offset=off)
            v = np.frombuffer(blob, _NUMPY_OF[view], count=count, offset=off + count * item)
            arrays[name] = (k.reshape(n, hk, d, bs), v.reshape(n, hk, bs, d))
            off += 2 * count * item
        if off != len(blob):
            raise ValueError(f"kv import blob is {len(blob)} bytes, layout needs {off}")
        node = self._root
        fresh: list[tuple[int, int]] = []      # (chain idx, block id)
        for i, chunk in enumerate(self._chunks(tokens, n)):
            child = node.children.get(chunk)
            if child is None:
                child = self._extend(node, chunk)
                if child is None:
                    break
                fresh.append((i, child.block_id))
            else:                       # the dedup walk touches the chain
                self._clock += 1
                child.last_use = self._clock
            node = child
        if fresh:
            idx = [i for i, _ in fresh]
            block_ids = [b for _, b in fresh]
            blocks = [torch.from_numpy(np.ascontiguousarray(arr[idx]))
                      for name in self._layers for arr in arrays[name]]
            if self._leads():
                self._chan.send(OP_KV_IMPORT, block_ids, blocks)
            self._upload(block_ids, blocks)
        if node is self._root:
            raise RuntimeError("kv import adopted zero blocks (pool exhausted by "
                               "pinned/unevictable chains)")
        self.pin_session(session, node)
        return len(fresh)
