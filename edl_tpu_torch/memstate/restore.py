"""Cache-first restore: rebuild a :class:`TrainState` from the peer
checkpoint cache (a port of the JAX package's ``memstate/restore.py``).

A restarting or resharding trainer calls :func:`try_restore` before it
touches storage.  The answer is a fully verified ``(state, meta_json,
info)`` or None, never a partial result, and every None is logged with its
reason:

- no committed-step record, or one other than storage's latest -> miss
- no live cache adverts and no local source                    -> miss
- a leaf without full coverage, or of another shape or dtype   -> miss
- a shard whose CRC fails on every holder                      -> miss
- no State sidecar                                              -> miss

Sources in order: the local snapshot (a live reshard's own host copy, no
wire), then ``prefer_pod`` (the own pod's cache over loopback), then peers
and ring replicas.  A large shard is fetched striped over every holder
(``rpc/transfer.py``), each holder's bytes as a server-push stream, with
the CRC computed as the bytes land.  ``delta_step`` overlays the intact
delta chains up to exactly that step (``memstate/delta.py``).  The leaves
land on the target state's device in batches bounded by
``EDL_TPU_TRANSFER_BUDGET_BYTES`` of host memory, and the state is loaded
with ``TrainState.load_state_dict``, as a storage restore loads it.

On a mesh (a sharded target, ``train/state.py``) each rank plans only the
shards whose boxes overlap the pieces it holds on the new mesh, from any
holder, as the JAX restore reads by overlap in ``make_array_from_callback``;
it checks coverage of those pieces only, and ``load_state_dict`` places
them.  The cached boxes may come from any earlier mesh.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from edl_tpu_torch.memstate import advert, shards
from edl_tpu_torch.utils import constants
from edl_tpu_torch.utils.exceptions import EdlInternalError

logger = logging.getLogger(__name__)

# the holder name of the in-RAM local source a live reshard passes
LOCAL_POD = "__local__"
_META_LEAF = "__meta__"   # the tee's sidecar patch: not a state leaf


def _miss(reason: str) -> None:
    logger.warning("memstate: cache miss (%s); falling back to storage", reason)


def _torch_dtype(name: str) -> torch.dtype:
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dtype


def _to_tensor(data, ent: dict) -> torch.Tensor:
    """A shard's bytes as a CPU tensor of its manifest dtype and shape."""
    dtype = _torch_dtype(ent["dtype"])
    if not len(data):
        return torch.empty(ent["shape"], dtype=dtype)
    buf = data if isinstance(data, bytearray) else bytearray(data)
    raw = torch.frombuffer(buf, dtype=torch.uint8)
    return raw.view(dtype).reshape(ent["shape"])


def try_restore(store, job_id: str, target, expect_step: int | None = None,
                local: dict | None = None, prefer_pod: str | None = None,
                delta_step: int | None = None):
    """``(target, meta_json, info)`` with ``target`` (a freshly built
    TrainState of the saved structure, on the trainer's device) loaded, or
    None (use storage).  ``expect_step``: storage's latest step; a cached
    set at any other step is stale.  ``local``: ``{key: (entry, bytes)}``
    at the committed step.  ``delta_step``: restore the base plus the
    chains up to exactly this step (agreed across ranks by the caller)."""
    from edl_tpu_torch.rpc.client import RpcChannelPool

    t0 = time.perf_counter()
    committed = advert.read_committed_step(store, job_id)
    if committed is None:
        _miss("no_committed_record")
        return None
    if expect_step is not None and committed != expect_step:
        _miss(f"stale: committed {committed}, storage {expect_step}")
        return None
    endpoints = advert.list_adverts(store, job_id)
    if not endpoints and not local:
        _miss("no_adverts")
        return None
    pools: dict[str, RpcChannelPool] = {}
    try:
        # every holder of each shard of the committed step (owner and
        # replica): one bad holder must not fail the restore
        holders: dict[str, list[tuple[str, dict, str]]] = {}
        meta_holders: list[tuple[str, str]] = []
        local = dict(local or {})
        for key, (ent, _buf) in local.items():
            holders.setdefault(key, []).append((LOCAL_POD, ent, LOCAL_POD))
        for pod, ep in endpoints.items():
            try:
                pools[pod] = RpcChannelPool(ep)
                listing = pools[pod].call("cache_manifest")
            except Exception:  # noqa: BLE001 — a dead peer is not fatal
                logger.warning("memstate: peer %s unreachable", pod[:8])
                continue
            for owner, info in listing.items():
                if info["step"] != committed:
                    continue
                for key, ent in info["shards"].items():
                    holders.setdefault(key, []).append((pod, ent, owner))
                if info.get("has_meta"):
                    meta_holders.append((pod, owner))
        holders.pop(_META_LEAF, None)
        if not holders:
            _miss("empty")
            return None

        restore_step = committed
        if delta_step is not None and int(delta_step) > committed:
            from edl_tpu_torch.memstate import delta as delta_mod
            listings = {}
            for pod, pool in pools.items():
                try:
                    listings[pod] = pool.call("cache_delta_manifest")
                except Exception as e:  # noqa: BLE001 — an old peer has no chains
                    logger.debug("delta manifest from %s failed (%s)", pod[:8], e)
            plan_d = delta_mod.plan_freshest(committed, listings, max_step=int(delta_step))
            if plan_d is None or int(plan_d["step"]) != int(delta_step):
                _miss("delta_unreachable")
                return None
            for key, (_ent, cands) in plan_d["overlay"].items():
                holders[key] = list(cands)
                local.pop(key, None)  # the base step's bytes are stale here
            meta_holders = list(plan_d["meta"])
            restore_step = int(delta_step)

        info = {"step": restore_step, "shards": 0, "bytes": 0, "local_bytes": 0,
                "local_shards": 0, "wire_bytes": 0,
                "peers": sorted({p for hs in holders.values() for p, _, _ in hs
                                 if p != LOCAL_POD})}
        needed = _needed(target)
        leaves = _plan(holders, target, needed)
        if leaves is None:
            return None
        p0 = next(target.model.parameters())
        device = p0.to_local().device if hasattr(p0, "to_local") else p0.device
        budget = constants.transfer_budget_bytes() or float("inf")
        tensors: dict[str, torch.Tensor] = {}
        batch: list = []
        batch_bytes = 0

        def flush() -> bool:
            nonlocal batch, batch_bytes
            jobs = {key: holders[key] for _leaf, keys in batch for key in keys}
            local_served: set = set()
            fetched = _fetch_all(jobs, pools, local, prefer_pod, local_served)
            if fetched is None:
                _miss("shard_unavailable")
                return False
            for key, data in fetched.items():
                info["shards"] += 1
                info["bytes"] += len(data)
                if key in local_served:
                    info["local_shards"] += 1
                    info["local_bytes"] += len(data)
                else:
                    info["wire_bytes"] += len(data)
            for leaf, keys in batch:
                t = _assemble(leaf, keys, holders, fetched, needed.get(leaf))
                if t is None:
                    return False
                tensors[leaf] = t if leaf == shards.STRUCT_LEAF else t.to(device)
            batch, batch_bytes = [], 0
            return True

        for leaf, keys in leaves:
            batch.append((leaf, keys))
            batch_bytes += sum(int(holders[k][0][1]["nbytes"]) for k in keys)
            if batch_bytes >= budget and not flush():
                return None
        if batch and not flush():
            return None
        meta_json = _fetch_meta(meta_holders, pools)
        if meta_json is None:
            _miss("no_meta")
            return None
        skeleton = shards.load_skeleton(tensors.pop(shards.STRUCT_LEAF).numpy().tobytes())
        try:
            sd = shards.unflatten(skeleton, tensors)
        except KeyError as e:
            _miss(f"missing_leaf {e}")
            return None
        del tensors
        target.load_state_dict(sd)
        info["seconds"] = time.perf_counter() - t0
        logger.info("memstate: restored step %d from %s (%d shards, %.1f MB, %.1f MB local, "
                    "%.2fs%s)", restore_step, [p[:8] for p in info["peers"]], info["shards"],
                    info["bytes"] / 1e6, info["local_bytes"] / 1e6, info["seconds"],
                    "" if restore_step == committed else f", base {committed} + delta chains")
        return target, meta_json, info
    finally:
        for p in pools.values():
            p.close()


def _needed(target) -> dict[str, list]:
    """``{leaf: [boxes]}`` of the pieces a sharded target holds on its mesh
    (a parameter's moments share its boxes); leaves absent are needed
    whole."""
    if not target.sharded:
        return {}
    from edl_tpu_torch.parallel.sharding import local_boxes
    tp, ep = target.model.tp, getattr(target.model, "ep", None)
    named = dict(target.model.named_parameters())
    layouts = target.model.param_layouts
    params = [p for g in target.optimizer.param_groups for p in g["params"]]
    name_of = {id(p): n for n, p in named.items()}
    by_param = {n: [box for box, _ in local_boxes(p, layouts[n], tp, ep)] for n, p in named.items()}
    out = {f"model/{n}": boxes for n, boxes in by_param.items()}
    out["optimizer/state/"] = [(i, by_param[name_of[id(p)]]) for i, p in enumerate(params)]
    return out


def _boxes_needed(needed: dict, leaf: str):
    """The boxes of ``leaf`` the target holds, or None when it needs it whole."""
    if leaf in needed:
        return needed[leaf]
    parts = leaf.split("/")
    if len(parts) == 4 and parts[:2] == ["optimizer", "state"] and "optimizer/state/" in needed:
        by_index = dict(needed["optimizer/state/"])
        return by_index.get(int(parts[2]))
    return None


def _overlaps(a, b) -> bool:
    return all(max(int(x0), int(y0)) < min(int(x1), int(y1)) for (x0, x1), (y0, y1) in zip(a, b))


def _plan(holders: dict, target, needed: dict) -> list | None:
    """``[(leaf, [keys])]`` covering every leaf of the cached state (only
    the shards overlapping what a sharded target holds), the struct leaf
    last; None (miss logged) when a leaf's entries disagree or a module
    entry does not match the target module."""
    by_leaf: dict[str, list[str]] = {}
    for key, cands in holders.items():
        by_leaf.setdefault(cands[0][1]["leaf"], []).append(key)
    if shards.STRUCT_LEAF not in by_leaf:
        _miss("missing_leaf __struct__")
        return None
    module = {f"model/{n}": shape for n, shape in target.global_shapes().items()}
    missing = set(module) - set(by_leaf)
    if missing:
        _miss(f"missing_leaf {sorted(missing)[:3]}")
        return None
    for leaf, keys in by_leaf.items():
        ent = holders[keys[0]][0][1]
        if any(holders[k][0][1]["gshape"] != ent["gshape"]
               or holders[k][0][1]["dtype"] != ent["dtype"] for k in keys):
            _miss(f"inconsistent_leaf {leaf}")
            return None
        want = module.get(leaf)
        if want is not None and list(want) != list(ent["gshape"]):
            _miss(f"shape_mismatch {leaf}")
            return None
        boxes = _boxes_needed(needed, leaf)
        if boxes is not None:
            by_leaf[leaf] = [k for k in keys
                             if any(_overlaps(holders[k][0][1]["index"], b) for b in boxes)]
    order = sorted(by_leaf, key=lambda leaf: leaf == shards.STRUCT_LEAF)
    return [(leaf, by_leaf[leaf]) for leaf in order]


def _assemble(leaf: str, keys: list[str], holders: dict, fetched: dict, boxes=None):
    """The leaf's CPU tensor from its boxes, or None (miss logged) when
    they do not cover it (``boxes``: the parts that must be covered; the
    rest of a leaf that a sharded target does not hold stays unwritten)."""
    if not keys:
        _miss(f"incomplete_coverage {leaf}")
        return None
    ent0 = holders[keys[0]][0][1]
    gshape = [int(d) for d in ent0["gshape"]]
    if len(keys) == 1 and [list(b) for b in ent0["index"]] == [[0, d] for d in gshape]:
        return _to_tensor(fetched.pop(keys[0]), ent0)
    out = torch.empty(gshape, dtype=_torch_dtype(ent0["dtype"]))
    cov = np.zeros(gshape, dtype=bool)
    for key in keys:
        ent = holders[key][0][1]
        sel = tuple(slice(int(a), int(b)) for a, b in ent["index"])
        out[sel] = _to_tensor(fetched.pop(key), ent)
        cov[sel] = True
    want = [tuple(slice(int(a), int(b)) for a, b in box) for box in boxes or [[[0, d] for d in gshape]]]
    if not all(cov[sel].all() for sel in want):
        _miss(f"incomplete_coverage {leaf}")
        return None
    return out


def _fetch_all(jobs: dict, pools: dict, local: dict, prefer_pod, local_served: set):
    """Every planned shard's CRC-verified bytes, fetched on a bounded
    worker pool: ``{key: bytes-like}``, or None when a shard has no
    holder that serves it (which aborts the rest)."""
    if not jobs:
        return {}
    import threading
    from concurrent.futures import ThreadPoolExecutor

    items = sorted(jobs.items(), key=lambda kv: -int(kv[1][0][1]["nbytes"]))
    abort = threading.Event()

    def fetch_one(kv):
        key, cands = kv
        if key in local:
            local_served.add(key)
            return local[key][1]
        data = None if abort.is_set() else _fetch_shard(key, cands[0][1], cands, pools, abort,
                                                          prefer_pod)
        if data is None:
            abort.set()
        return data

    workers = min(len(items), max(1, constants.transfer_workers()))
    if workers == 1:
        fetched = [fetch_one(kv) for kv in items]
    else:
        with ThreadPoolExecutor(max_workers=workers, thread_name_prefix="memstate-fetch") as ex:
            fetched = list(ex.map(fetch_one, items))
    if any(d is None for d in fetched):
        return None
    return {key: data for (key, _), data in zip(items, fetched)}


def _fetch_shard(key, ent, candidates, pools, abort, prefer_pod):
    """One shard's bytes, CRC-verified, striped over every live holder when
    large, else (or after a striped failure) one holder at a time; None
    when every holder failed."""
    from edl_tpu_torch.rpc import transfer

    nbytes, want_crc = int(ent["nbytes"]), int(ent["crc"])
    live: list[tuple[str, str]] = []   # (pod, owner), one each
    for pod, _e, owner in candidates:
        if pod in pools and all(pod != p for p, _ in live):
            live.append((pod, owner))
    if not live:
        return None
    if prefer_pod is not None:
        live.sort(key=lambda po: po[0] != prefer_pod)
    owner_of = dict(live)
    if nbytes >= constants.stripe_min_bytes() and len(live) >= 2:
        try:
            buf, crc = transfer.fetch_striped(
                nbytes, [pod for pod, _ in live],
                lambda holder, off, ln: _abortable(
                    _holder_iter(pools[holder], owner_of[holder], key, off, ln), abort),
                chunk_bytes=constants.chunk_bytes())
            if crc == want_crc:
                return buf
            logger.warning("memstate: striped CRC mismatch for %s; trying holders one by one",
                           key)
        except Exception as e:  # noqa: BLE001 — the one-holder path below
            logger.warning("memstate: striped fetch of %s failed (%s); trying holders one "
                           "by one", key, e)
    for pod, owner in live:
        if abort.is_set():
            return None
        try:
            buf, crc = transfer.fetch_sequential(
                nbytes, _abortable(_holder_iter(pools[pod], owner, key, 0, nbytes), abort),
                label=f"{key} from {pod[:8]}")
        except Exception:  # noqa: BLE001 — try the next holder
            logger.warning("memstate: fetch of %s from %s failed", key, pod[:8])
            continue
        if crc == want_crc:
            return buf
        logger.warning("memstate: CRC mismatch for %s from %s", key, pod[:8])
    return None


def _abortable(it, abort):
    """Stop a chunk stream within one chunk once a sibling shard missed."""
    for chunk in it:
        if abort.is_set():
            raise ConnectionError("restore aborted: a sibling shard missed")
        yield chunk


def _holder_iter(pool, owner, key, offset, length):
    """One holder's byte range: the server-push stream, or windowed
    ``cache_fetch`` calls from a peer without it."""
    from edl_tpu_torch.rpc import chunks

    label = f"{key}@{owner[:8]}"
    if not getattr(pool, "_no_stream", False):
        it = chunks.iter_fetch_streaming(pool, "cache_fetch_stream", length, offset=offset,
                                         owner=owner, key=key, label=label)
        try:
            first = next(it, None)
        except EdlInternalError as e:
            if "no such method" not in str(e):
                raise
            pool._no_stream = True
        else:
            if first is not None:
                yield first
            yield from it
            return
    yield from chunks.iter_fetch_pipelined(pool, "cache_fetch", length, offset=offset,
                                           owner=owner, key=key, label=label)


def _fetch_meta(meta_holders, pools) -> str | None:
    for pod, owner in meta_holders:
        pool = pools.get(pod)
        if pool is None:
            continue
        try:
            raw = pool.call("cache_meta", owner=owner)
        except Exception as e:  # noqa: BLE001 — try the next holder
            logger.debug("cache_meta from %s for %s failed (%s)", pod[:8], owner[:8], e)
            continue
        if raw:
            return bytes(raw).decode()
    return None


def assert_bit_identical(cache_state, storage_state) -> None:
    """Every leaf of the two states equal bit for bit, and their plain
    values equal (``EDL_TPU_MEMSTATE_VERIFY=1``)."""
    a_leaves, a_skel = shards.flatten(cache_state.state_dict())
    b_leaves, b_skel = shards.flatten(storage_state.state_dict())
    if [n for n, _ in a_leaves] != [n for n, _ in b_leaves] or a_skel != b_skel:
        raise AssertionError("cache restore's structure diverged from storage's")
    for (name, x), (_, y) in zip(a_leaves, b_leaves):
        x, y = (t.to_local() if hasattr(t, "to_local") else t for t in (x, y))
        if x.dtype != y.dtype or x.shape != y.shape:
            raise AssertionError(f"cache restore diverged from storage at {name}")
        xb = x.detach().cpu().contiguous().reshape(-1).view(torch.uint8)
        yb = y.detach().cpu().contiguous().reshape(-1).view(torch.uint8)
        if not torch.equal(xb, yb):
            raise AssertionError(f"cache restore diverged from storage at {name}")
