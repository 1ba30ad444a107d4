"""Shard naming and the host snapshot of a :class:`TrainState`, shared by
the tee and the delta replicator (producers) and the cache-first restore
(consumer): the torch counterpart of the JAX package's
``memstate/shards.py``, in its manifest schema.

The state's ``state_dict()`` (module, optimizer, step, extra) is flattened
into named leaves: every tensor is a leaf (``model/<name>``,
``optimizer/state/<i>/<name>``, ...), and what is left, the nesting with a
placeholder string where each tensor was and the plain values (the
optimizer's param groups, the step), is one more leaf, ``__struct__``: the
``torch.save`` bytes of that skeleton as uint8.  A shard is one box of one
leaf with its manifest entry (``crc``, ``nbytes``, ``dtype``, ``shape``,
``index``, ``gshape``, ``leaf``).  bfloat16 travels as its 16-bit words
under the name ``"bfloat16"``, as the serving fleet's KV blob does.

Data parallelism replicates the state, so every leaf is one whole-leaf box
and, by the JAX package's ``replica_id == 0`` rule, global rank 0 is the
one process that pushes it; other ranks snapshot nothing unless asked for
their own copy (a live reshard's local source).  A sharded state
(``train/state.py``) snapshots each rank's own pieces as boxes of the global
leaves (``parallel/sharding.py:local_boxes``: a head-split q|k|v piece is
three, an ep-split expert piece lies in its rank's run of experts), pushed
by the first replica of each piece: the rank whose dp and sp coordinates
are 0, whose tp coordinate is 0 for a leaf that tp does not split (a norm
scale), and whose ep coordinate is 0 for one that ep does not; the
replicated leaves and ``__struct__`` come from
global rank 0.  The skeleton is mesh-free, so a restore assembles global
leaves on any mesh.

The device-to-host copy is made here, on the step path, because the next
step updates the parameters and moments in place: on the card it runs on a
side stream into pinned memory and is fenced by an event that
``TrainState.apply_gradients`` waits on before the optimizer writes, so the
copy overlaps the next forward and backward.  Module buffers (which a
forward may update) and other leaves are copied on the current stream.
:func:`finish_manifest` (CRC and bytes) runs off the step path and waits
for the copies first.  Pinned memory is slow to allocate (about a second
for the flagship's 1.95 GB on an H100 host), so a consumer done with a
snapshot hands its buffers back (:meth:`Snapshot.release`) and the next
snapshot reuses them; at most :data:`KEEP` sets are kept.
"""

from __future__ import annotations

import io
import threading
import zlib
from collections import OrderedDict
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

STRUCT_LEAF = "__struct__"
_MARK = "@leaf:"          # a skeleton placeholder: _MARK + leaf name
_SIDE: dict[int, torch.cuda.Stream] = {}   # device index -> the copy stream
KEEP = 2                  # pinned buffer sets kept for reuse
_FREE: list[dict[str, torch.Tensor]] = []  # released sets: leaf name -> pinned tensor
_FREE_LOCK = threading.Lock()


def shard_key(leaf: str, box: list[list[int]]) -> str:
    return leaf + "@" + ",".join(f"{a}:{b}" for a, b in box)


def dtype_name(dtype: torch.dtype) -> str:
    """The manifest's dtype name: numpy's for the types numpy has,
    ``"bfloat16"`` for bf16."""
    return str(dtype).removeprefix("torch.")


def flatten(sd: Any, prefix: str = "") -> tuple[list[tuple[str, torch.Tensor]], Any]:
    """``(leaves, skeleton)`` of a nested state dict: every tensor named by
    its path, and the nesting with ``_MARK + name`` in its place."""
    leaves: list[tuple[str, torch.Tensor]] = []

    def walk(obj, path):
        if isinstance(obj, torch.Tensor):
            leaves.append((path, obj))
            return _MARK + path
        if isinstance(obj, dict):
            out = type(obj)() if isinstance(obj, OrderedDict) else {}
            for k, v in obj.items():
                out[k] = walk(v, f"{path}/{k}" if path else str(k))
            if hasattr(obj, "_metadata"):
                out._metadata = obj._metadata
            return out
        if isinstance(obj, (list, tuple)):
            items = [walk(v, f"{path}/{i}" if path else str(i)) for i, v in enumerate(obj)]
            return type(obj)(items)
        return obj

    return leaves, walk(sd, prefix)


def unflatten(skeleton: Any, tensors: dict[str, torch.Tensor]) -> Any:
    """The state dict :func:`flatten` took apart, from its skeleton and
    ``{leaf name: tensor}``; KeyError when a leaf is missing."""
    def walk(obj):
        if isinstance(obj, str) and obj.startswith(_MARK):
            return tensors[obj[len(_MARK):]]
        if isinstance(obj, dict):
            out = type(obj)() if isinstance(obj, OrderedDict) else {}
            for k, v in obj.items():
                out[k] = walk(v)
            if hasattr(obj, "_metadata"):
                out._metadata = obj._metadata
            return out
        if isinstance(obj, (list, tuple)):
            return type(obj)(walk(v) for v in obj)
        return obj

    return walk(skeleton)


def skeleton_bytes(skeleton: Any) -> bytes:
    buf = io.BytesIO()
    torch.save(skeleton, buf)
    return buf.getvalue()


def load_skeleton(data) -> Any:
    return torch.load(io.BytesIO(bytes(data)), weights_only=True)


def _side_stream(device: torch.device) -> torch.cuda.Stream:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _SIDE:
        _SIDE[idx] = torch.cuda.Stream(device=idx)
    return _SIDE[idx]


class Snapshot:
    """A host copy in flight: ``shards`` ``[(key, host tensor)]``, the
    manifest (CRCs still 0) and the events the copies complete at."""

    def __init__(self):
        self.shards: list[tuple[str, torch.Tensor]] = []
        self.manifest: dict[str, dict] = {}
        self.events: list = []
        self.pinned: dict[str, torch.Tensor] = {}   # reusable once released

    def release(self) -> None:
        """The consumer is done with the bytes: the pinned buffers go back
        for the next snapshot."""
        self.wait()
        pinned, self.pinned, self.shards = self.pinned, {}, []
        with _FREE_LOCK:
            if pinned and len(_FREE) < KEEP:
                _FREE.append(pinned)

    def wait(self) -> None:
        for ev in self.events:
            ev.synchronize()
        self.events = []

    def arrays(self) -> list[tuple[str, np.ndarray]]:
        """Each shard as a numpy array (bf16 as its int16 words), once the
        copies completed."""
        self.wait()
        out = []
        for key, t in self.shards:
            if t.dtype == torch.bfloat16:
                t = t.view(torch.int16)
            out.append((key, t.numpy()))
        return out


def _add(snap: Snapshot, key: str, leaf: str, box: list, gshape: list, host: torch.Tensor,
         dtype: torch.dtype) -> None:
    snap.shards.append((key, host))
    snap.manifest[key] = {"crc": 0, "nbytes": host.numel() * host.element_size(),
                          "dtype": dtype_name(dtype), "shape": [int(d) for d in host.shape],
                          "index": box, "gshape": gshape, "leaf": leaf}


def _coordinate(state) -> dict[str, int]:
    from edl_tpu_torch.parallel.mesh import coordinate
    return coordinate(getattr(state.model, "mesh", None),
                      dist.get_rank() if dist.is_initialized() else 0)


def is_producer(state=None) -> bool:
    """Whether this process pushes any piece of ``state``: global rank 0 for
    a replicated state (``replica_id == 0``), a rank with dp coordinate 0
    for a sharded one."""
    if state is not None and state.sharded:
        return _coordinate(state)["dp"] == 0
    return not dist.is_initialized() or dist.get_rank() == 0


def _pieces(state, own_copy: bool):
    """``([(key, leaf, box, gshape, tensor)], skeleton)``: the pieces of
    ``state`` this process snapshots (every piece it holds with
    ``own_copy``), the whole-leaf box of each replicated leaf."""
    from torch.distributed.tensor import DTensor

    def whole(name, t):
        gshape = [int(d) for d in t.shape]
        box = [[0, d] for d in gshape]
        return shard_key(name, box), name, box, gshape, t

    leaves, skeleton = flatten(state.state_dict())
    if not state.sharded:
        if not (own_copy or is_producer()):
            return [], None
        return [whole(name, t) for name, t in leaves], skeleton
    from edl_tpu_torch.parallel.sharding import local_boxes, model_groups, pushes
    sharded, (tp, ep, pp) = state.leaf_params(), model_groups(state.model)
    coord = _coordinate(state)
    first = not any(coord.values())
    out = []
    for name, t in leaves:
        if name in sharded:
            lay = sharded[name][1]
            if not (own_copy or pushes(t, lay, coord)):
                continue
            local = t.to_local() if isinstance(t, DTensor) else t
            for box, index in local_boxes(t, lay, tp, ep, pp):
                out.append((shard_key(name, box), name, box, list(lay.gshape), local[index]))
        elif own_copy or first:
            out.append(whole(name, t))
    return out, (skeleton if own_copy or first else None)


def snapshot(state, own_copy: bool = False, reuse: Snapshot | None = None) -> Snapshot:
    """Start the host copy of every piece of ``state`` (a TrainState) this
    process pushes (:func:`_pieces`; all it holds with ``own_copy``).  The
    caller's next optimizer step waits on the copy (``state.fences``);
    readers call :meth:`Snapshot.wait` (done by :func:`finish_manifest`).
    ``reuse``: an unread snapshot this one replaces, whose pinned buffers
    it overwrites."""
    snap = Snapshot()
    pieces, skeleton = _pieces(state, own_copy)
    if not pieces:
        return snap
    buffers = {f"model/{name}" for name, _ in state.model.named_buffers()}
    on_card = [(key, leaf, t) for key, leaf, _b, _g, t in pieces if t.device.type == "cuda"]
    hosts = {}
    if on_card:
        device = on_card[0][2].device
        main = torch.cuda.current_stream(device)
        side = _side_stream(device)
        side.wait_stream(main)          # copy the state as of the last queued step
        if reuse is not None:
            bufs, reuse.pinned, reuse.shards = reuse.pinned, {}, []
        else:
            bufs = _take_pinned(on_card)
        for key, leaf, t in on_card:
            host = bufs.get(key)
            if host is None or host.shape != t.shape or host.dtype != t.dtype:
                host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            with torch.cuda.stream(main if leaf in buffers else side):
                host.copy_(t.detach(), non_blocking=True)
            hosts[key] = host
        snap.pinned = hosts
        ev_main, ev_side = main.record_event(), side.record_event()
        snap.events = [ev_main, ev_side]
        state.fences.append(ev_side)    # the optimizer's in-place writes wait on it
    for key, leaf, box, gshape, t in pieces:
        host = hosts[key] if key in hosts else t.detach().clone()
        _add(snap, key, leaf, box, gshape, host, t.dtype)
    if skeleton is not None:
        struct = torch.frombuffer(bytearray(skeleton_bytes(skeleton)), dtype=torch.uint8)
        box = [[0, len(struct)]]
        _add(snap, shard_key(STRUCT_LEAF, box), STRUCT_LEAF, box, [len(struct)], struct,
             torch.uint8)
    return snap


def _take_pinned(on_card) -> dict[str, torch.Tensor]:
    """A released buffer set whose pieces match ``on_card``'s, or {}."""
    want = {key: (t.shape, t.dtype) for key, _leaf, t in on_card}
    with _FREE_LOCK:
        for i, bufs in enumerate(_FREE):
            if {n: (b.shape, b.dtype) for n, b in bufs.items()} == want:
                return _FREE.pop(i)
    return {}


def _bytes(arr: np.ndarray) -> memoryview:
    return memoryview(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))


def local_source(state) -> dict[str, tuple[dict, memoryview]]:
    """This process's own host copy of ``state``, as a restore's local
    source: ``{key: (manifest entry, bytes)}`` (a local source is not
    CRC-checked, so none is computed)."""
    snap = snapshot(state, own_copy=True)
    return {key: (snap.manifest[key], _bytes(arr)) for key, arr in snap.arrays()}


def finish_manifest(snap: Snapshot) -> dict[str, memoryview]:
    """CRC and bytes (the worker-thread half): ``{key: bytes view}``, with
    the manifest's ``crc`` and ``nbytes`` filled in place."""
    blobs: dict[str, memoryview] = {}
    for key, arr in snap.arrays():
        data = _bytes(arr)
        snap.manifest[key]["crc"] = zlib.crc32(data)
        snap.manifest[key]["nbytes"] = len(data)
        blobs[key] = data
    return blobs
