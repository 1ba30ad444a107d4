"""Logical-axis sharding rules, and where each rank's piece of a tensor
lies in the whole.

The port of the JAX package's ``parallel/sharding.py``.  Models annotate
parameters with *logical* axis names ("embed", "heads", "vocab", ...); a
:class:`ShardingRules` table maps them to mesh axes, so the same model runs
pure-DP, FSDP, TP or a mix by swapping the rules.  Where JAX resolves a
``PartitionSpec`` and lets XLA place collectives, here:

- :meth:`ShardingRules.spec` gives DTensor placements, one per mesh dim;
- :func:`shard_init` builds a module from its seed (born full), cuts every
  ``tp`` and ``ep`` dim to this rank's slice (the module's forward then
  runs the ``parallel/tp.py`` collectives; an ``ep`` dim is split evenly,
  rank r holding the r-th run of experts), tells the module its ``sp``
  group (each rank then runs its chunk of the sequence,
  :func:`seq_chunk`) and hands the ``fsdp`` dim to FSDP2
  (``fully_shard``, HSDP with ``dp``), whose ``shard_placement_fn`` follows
  the rules' "embed" dim; a leaf with no such dim (a norm scale) is
  sharded on dim 0, where JAX keeps it replicated;
- the JAX module's ``allgather_flag`` is ``train/distributed.py``'s;
- a :class:`LeafLayout` records, per parameter, its global shape and how
  its ``tp`` and ``ep`` dims are cut: a tp dim may hold segments that are
  each split over the ranks (the fused q|k|v weight is split by heads: rank
  r holds its q, k and v rows, three boxes of the global leaf).
  :func:`local_boxes`, :func:`to_full` and :func:`from_full` move between a
  rank's local tensor and the global leaf, for the checkpoint and the peer
  cache, so a checkpoint written at one tp or ep resumes at another.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from edl_tpu_torch.parallel.mesh import AXIS_ORDER, coordinate, mesh_sizes
from edl_tpu_torch.parallel.tp import EP, SP, TP, AxisGroup, shards_of

# Default logical->mesh table.  A logical name may map to a mesh axis, a
# tuple of mesh axes (sharded over both), or None (replicated).
DEFAULT_RULES: dict[str, Any] = {
    "batch": ("dp", "fsdp"),   # global batch split over all data axes
    "seq": "sp",               # sequence/context parallelism
    "embed": "fsdp",           # zero-style param sharding
    "mlp": "tp",               # megatron column/row parallel
    "heads": "tp",
    "kv": None,
    "vocab": "tp",
    "expert": "ep",
    "expert_mlp": "tp",
    "layers": None,            # scanned-layer leading dim (no scan here)
    "stage": "pp",
    "conv_out": None,
    "table": "ep",             # CTR embedding tables
    "norm": None,
}


@dataclass
class ShardingRules:
    """Logical axis name -> mesh axis (or tuple / None)."""

    rules: dict[str, Any] = field(default_factory=lambda: dict(DEFAULT_RULES))

    def updated(self, **kw) -> "ShardingRules":
        r = dict(self.rules)
        r.update(kw)
        return ShardingRules(r)

    def partition(self, logical_axes: tuple[str | None, ...], mesh) -> tuple:
        """The JAX ``PartitionSpec`` of ``logical_axes`` as a tuple: per
        tensor dim a mesh axis, a tuple of them, or None; mesh axes of size
        1 drop out, a mesh axis is used at most once, and trailing Nones
        are dropped."""
        sizes = mesh_sizes(mesh)
        out: list = []
        used: set[str] = set()
        for name in logical_axes:
            axis = self.rules.get(name) if name else None
            if axis is None:
                out.append(None)
                continue
            axes = axis if isinstance(axis, tuple) else (axis,)
            live = tuple(a for a in axes if sizes.get(a, 1) > 1 and a not in used)
            used.update(live)
            out.append(None if not live else live[0] if len(live) == 1 else live)
        while out and out[-1] is None:
            out.pop()
        return tuple(out)

    def spec(self, logical_axes: tuple[str | None, ...], mesh) -> tuple:
        """DTensor placements of ``logical_axes``, one per mesh dim in
        ``AXIS_ORDER``: ``Shard(d)`` where the dim shards tensor dim d,
        else ``Replicate()``."""
        from torch.distributed.tensor import Replicate, Shard

        dim_of: dict[str, int] = {}
        for d, entry in enumerate(self.partition(logical_axes, mesh)):
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                if a is not None:
                    dim_of[a] = d
        return tuple(Shard(dim_of[a]) if a in dim_of else Replicate() for a in AXIS_ORDER)


def logical_sharding(logical_axes, mesh, rules: ShardingRules | None = None) -> tuple:
    return (rules or ShardingRules()).spec(logical_axes, mesh)


def logical_constraint(x, logical_axes, mesh, rules: ShardingRules | None = None):
    """Redistribute a DTensor to the placements of ``logical_axes``; a plain
    tensor (no placement) is returned as it is."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, logical_sharding(logical_axes, mesh, rules))


def tree_shardings(tree_logical: dict, mesh, rules: ShardingRules | None = None) -> dict:
    """``{name: logical axes}`` -> ``{name: placements}``."""
    rules = rules or ShardingRules()
    return {name: rules.spec(axes, mesh) for name, axes in tree_logical.items()}


# -- where a rank's piece lies --------------------------------------------------------

@dataclass(frozen=True)
class LeafLayout:
    """A parameter's global shape, its ``tp`` dim (None: replicated over
    tp) with that dim's segments (global lengths, each split evenly over
    the tp ranks, but for the indices in ``whole``, which every rank holds
    whole), its ``fsdp`` dim (None: the rules give it none), and its ``ep``
    dim (None: replicated over ep; else split evenly over the ep ranks)."""

    gshape: tuple[int, ...]
    tp_dim: int | None = None
    segments: tuple[int, ...] = ()
    fsdp_dim: int | None = None
    whole: tuple[int, ...] = ()
    ep_dim: int | None = None


def _axes(entry) -> tuple:
    return () if entry is None else entry if isinstance(entry, tuple) else (entry,)


def param_layouts(module: torch.nn.Module, logical: dict, mesh,
                  rules: ShardingRules | None = None) -> dict[str, LeafLayout]:
    """The :class:`LeafLayout` of every parameter of the (full) ``module``
    under ``logical`` (``{name: axes}``, ``models/logical.py``).  A module
    whose fused dim holds several tensors names their lengths in
    ``tp_segments(name)``, and those it keeps whole on every rank in
    ``tp_whole(name, tp)``.  Raises when a tp-split segment does not
    divide."""
    rules = rules or ShardingRules()
    tp, ep = mesh_sizes(mesh)["tp"], mesh_sizes(mesh)["ep"]
    out = {}
    for name, p in module.named_parameters():
        axes = logical.get(name, (None,) * p.ndim)
        part = rules.partition(axes, mesh)
        tp_dim = next((d for d, e in enumerate(part) if "tp" in _axes(e)), None)
        ep_dim = next((d for d, e in enumerate(part) if "ep" in _axes(e)), None)
        if ep_dim is not None and p.shape[ep_dim] % ep:
            raise ValueError(f"{name}: dim {ep_dim} of {p.shape[ep_dim]} does not divide "
                             f"over ep = {ep}")
        # the fsdp dim is named whatever the axis's size (FSDP2 may be forced
        # on an fsdp axis of 1)
        fsdp_dim = next((d for d, n in enumerate(axes) if n and "fsdp" in _axes(rules.rules.get(n))),
                        None)
        segments, whole = (), ()
        if tp_dim is not None:
            segments = tuple(getattr(module, "tp_segments", lambda n: None)(name)
                             or (p.shape[tp_dim],))
            whole = tuple(getattr(module, "tp_whole", lambda n, s: ())(name, tp))
            if len(whole) == len(segments):
                tp_dim, segments, whole = None, (), ()
            for i, s in enumerate(segments):
                if i not in whole and s % tp:
                    raise ValueError(f"{name}: dim {tp_dim} segment of {s} does not divide "
                                     f"over tp = {tp}")
        out[name] = LeafLayout(tuple(p.shape), tp_dim, segments, fsdp_dim, whole, ep_dim)
    return out


def tp_ranges(layout: LeafLayout, rank: int, size: int) -> list[tuple[int, int, int]]:
    """``[(global start, local start, length)]`` along the tp dim of the
    rows ``rank`` holds: one range per segment (a whole one entire)."""
    out, g0, l0 = [], 0, 0
    for i, seg in enumerate(layout.segments):
        if i in layout.whole:
            out.append((g0, l0, seg))
            n = seg
        else:
            n = seg // size
            out.append((g0 + rank * n, l0, n))
        g0, l0 = g0 + seg, l0 + n
    return out


def _ep_run(layout: LeafLayout, ep: AxisGroup | None) -> tuple[int, int] | None:
    """``(start, length)`` along the ep dim of the experts ``ep``'s rank
    holds, or None when the leaf is not split over ep."""
    if ep is None or layout is None or layout.ep_dim is None:
        return None
    n = layout.gshape[layout.ep_dim] // ep.size
    return ep.rank * n, n


def tp_slice(full: torch.Tensor, layout: LeafLayout, tp: TP | None,
             ep: AxisGroup | None = None) -> torch.Tensor:
    """This rank's slice of the full leaf: its ``ep`` run of experts and its
    ``tp`` rows (the leaf itself when it is split over neither)."""
    run = _ep_run(layout, ep)
    if run is not None:
        full = full.narrow(layout.ep_dim, *run)
    if tp is None or layout.tp_dim is None:
        return full
    d = layout.tp_dim
    return torch.cat([full.narrow(d, g, n) for g, _, n in tp_ranges(layout, tp.rank, tp.size)],
                     dim=d)


def _fsdp_region(t) -> tuple[torch.Tensor, list[int], list[int]]:
    """``(local tensor, its shape, its offset)`` in the tp-local tensor:
    a DTensor's shard, or a plain tensor whole."""
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
        shape, off = compute_local_shape_and_global_offset(t.shape, t.device_mesh, t.placements)
        return t.to_local(), list(shape), list(off)
    return t, list(t.shape), [0] * t.ndim


def local_boxes(t, layout: LeafLayout | None, tp: TP | None,
                ep: AxisGroup | None = None) -> list[tuple[list, tuple]]:
    """``[(global box, local index)]`` of this rank's piece of a leaf: each
    box ``[[start, end], ...]`` in the global leaf, each index the slices of
    the local tensor that hold it.  A head-split q|k|v weight gives three;
    an ep-split leaf's boxes lie in this rank's run of experts."""
    run = _ep_run(layout, ep)
    boxes = _tp_boxes(t, layout, tp)
    if run is not None:
        for box, _ in boxes:
            box[layout.ep_dim] = [run[0] + box[layout.ep_dim][0], run[0] + box[layout.ep_dim][1]]
    return boxes


def _tp_boxes(t, layout: LeafLayout | None, tp: TP | None) -> list[tuple[list, tuple]]:
    """:func:`local_boxes` in the leaf of this rank's experts."""
    local, shape, off = _fsdp_region(t)
    if any(n == 0 for n in shape):
        return []
    region = [[o, o + n] for o, n in zip(off, shape)]
    full_index = tuple(slice(None) for _ in shape)
    if layout is None or tp is None or layout.tp_dim is None:
        return [(region, full_index)]
    d = layout.tp_dim
    out = []
    for g, lo, n in tp_ranges(layout, tp.rank, tp.size):
        a, b = max(lo, region[d][0]), min(lo + n, region[d][1])
        if a >= b:
            continue
        box = [list(r) for r in region]
        box[d] = [g + a - lo, g + b - lo]
        index = list(full_index)
        index[d] = slice(a - region[d][0], b - region[d][0])
        out.append((box, tuple(index)))
    return out


def to_full(t, layout: LeafLayout | None, tp: TP | None,
            ep: AxisGroup | None = None) -> torch.Tensor:
    """The global leaf of ``t`` on every rank (collective over fsdp for a
    DTensor, over tp for a tp-split leaf and over ep for an ep-split one:
    each rank's rows written into zeros and all-reduced, so tp and ep use
    only all-reduce)."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        t = t.full_tensor()
    if layout is None:
        return t
    run = _ep_run(layout, ep)
    if tp is not None and layout.tp_dim is not None:
        d = layout.tp_dim
        shape = list(layout.gshape)
        if run is not None:
            shape[layout.ep_dim] = run[1]
        full = t.new_zeros(shape)
        for i, (g, lo, n) in enumerate(tp_ranges(layout, tp.rank, tp.size)):
            if i not in layout.whole or tp.rank == 0:     # a whole segment added once
                full.narrow(d, g, n).copy_(t.narrow(d, lo, n))
        dist.all_reduce(full, group=tp.group)
        t = full
    if run is not None:
        full = t.new_zeros(layout.gshape)
        full.narrow(layout.ep_dim, *run).copy_(t)
        dist.all_reduce(full, group=ep.group)
        t = full
    return t


def from_full(full: torch.Tensor, like, layout: LeafLayout | None,
              tp: TP | None, ep: AxisGroup | None = None) -> torch.Tensor:
    """This rank's piece of the global leaf ``full``, placed as ``like``
    (a DTensor of the same spec, or a plain tensor) on ``like``'s device."""
    from torch.distributed.tensor import DTensor

    piece = tp_slice(full, layout, tp, ep) if layout is not None else full
    if isinstance(like, DTensor):
        from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
        shape, off = compute_local_shape_and_global_offset(like.shape, like.device_mesh,
                                                           like.placements)
        index = tuple(slice(o, o + n) for o, n in zip(off, shape))
        local = piece[index].to(like.to_local().device, like.dtype).contiguous()
        return DTensor.from_local(local, like.device_mesh, like.placements, run_check=False,
                                  shape=like.shape, stride=like.stride())
    return piece.to(like.device, like.dtype)


def pushes(t, layout: LeafLayout | None, coord: dict[str, int]) -> bool:
    """Whether the rank at mesh ``coord`` is the one replica that pushes its
    piece of a leaf (JAX's ``replica_id == 0``): dp and sp coordinate 0,
    fsdp 0 unless the leaf is an FSDP2 shard, ep 0 unless it is split over
    ep, tp 0 unless it is split over tp."""
    from torch.distributed.tensor import DTensor

    if coord["dp"] != 0 or coord["sp"] != 0:
        return False
    if coord["fsdp"] != 0 and not isinstance(t, DTensor):
        return False
    if coord["ep"] != 0 and (layout is None or layout.ep_dim is None):
        return False
    return coord["tp"] == 0 or (layout is not None and layout.tp_dim is not None)


# -- building a sharded module ---------------------------------------------------------

def shard_init(init_fn, logical_rules, mesh, rules: ShardingRules | None = None,
               fsdp: bool | None = None) -> torch.nn.Module:
    """``init_fn()`` (a module built from its seed, full) placed on ``mesh``
    under ``logical_rules`` (a model's ``LOGICAL_RULES``): its tp and ep dims
    cut to this rank's rows (the module must offer ``set_tp`` and
    ``set_ep``), its ``sp`` group given to ``set_sp``, then FSDP2 on the
    ``fsdp`` dim when that dim is wider than 1 or ``fsdp`` forces it.  The
    module's ``param_layouts``, ``tp``, ``ep`` and ``sp`` are set."""
    from edl_tpu_torch.models.logical import logical_axes_from_paths

    module = init_fn()
    sizes = mesh_sizes(mesh)
    if sizes["pp"] > 1:
        raise NotImplementedError("the pp mesh axis is not ported to edl_tpu_torch "
                                  "yet (ROADMAP.md Queue 1 item 7)")
    layouts = param_layouts(module, logical_axes_from_paths(module, logical_rules), mesh, rules)
    tp, ep, sp = TP.of(mesh), EP.of(mesh), SP.of(mesh)
    # ep's setter also takes the one group of the tp and ep ranks
    for group, setter, more in ((tp, "set_tp", ()), (ep, "set_ep", (shards_of(mesh),)),
                                (sp, "set_sp", ())):
        if group is not None:
            if not hasattr(module, setter):
                raise NotImplementedError(f"{type(module).__name__} has no {setter}")
            getattr(module, setter)(group, *more)   # validates the widths before any cut
    if tp is not None or ep is not None:
        with torch.no_grad():
            for name, p in module.named_parameters():
                p.data = tp_slice(p.data, layouts[name], tp, ep).contiguous()
    if fsdp or (fsdp is None and sizes["fsdp"] > 1):
        _fully_shard(module, mesh, layouts)
    module.param_layouts = layouts
    module.tp, module.ep, module.sp = tp, ep, sp
    return module


def _fully_shard(module: torch.nn.Module, mesh, layouts: dict[str, LeafLayout]) -> None:
    """FSDP2 over the mesh's (dp, fsdp) dims (HSDP: replicated over dp,
    sharded over fsdp): one unit per child the module lists in
    ``fsdp_units()`` (each decoder block), then the root.  Each parameter
    is sharded on its fsdp dim, or on dim 0 when it has none."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    by_id = {id(p): layouts[name] for name, p in module.named_parameters()}

    def placement(p):
        d = by_id[id(p)].fsdp_dim
        return Shard(0 if d is None else d)

    sub = mesh["dp", "fsdp"]
    for unit in getattr(module, "fsdp_units", lambda: [])():
        fully_shard(unit, mesh=sub, shard_placement_fn=placement)
    fully_shard(module, mesh=sub, shard_placement_fn=placement)


def seq_chunk(x, sp: AxisGroup | None, dim: int = 1):
    """This ``sp`` rank's contiguous chunk of ``x`` (a tensor or an array)
    along the sequence dim ``dim`` (``x`` itself without sp)."""
    if sp is None:
        return x
    n = x.shape[dim]
    if n % sp.size:
        raise ValueError(f"a sequence of {n} does not split {sp.size} ways over sp")
    c = n // sp.size
    index = [slice(None)] * x.ndim
    index[dim] = slice(sp.rank * c, (sp.rank + 1) * c)
    return x[tuple(index)]


def shard_host_batch(batch, mesh, rank: int, rules: ShardingRules | None = None):
    """This rank's rows of a global host batch (``{name: array}``), split
    on the batch axes only: the sp, tp and ep ranks of one data coordinate
    get the same rows (an sp rank then takes its :func:`seq_chunk`)."""
    rules = rules or ShardingRules()
    sizes, coord = mesh_sizes(mesh), coordinate(mesh, rank)
    entry = rules.partition(("batch",), mesh)
    axes = () if not entry or entry[0] is None else (
        entry[0] if isinstance(entry[0], tuple) else (entry[0],))
    ways = math.prod(sizes[a] for a in axes)
    index = 0
    for a in axes:
        index = index * sizes[a] + coord[a]

    def rows(x):
        x = np.asarray(x)
        if x.ndim == 0:
            return x
        if x.shape[0] % ways:
            raise ValueError(f"batch of {x.shape[0]} rows does not split {ways} ways")
        n = x.shape[0] // ways
        return x[index * n:(index + 1) * n]

    return {k: rows(v) for k, v in batch.items()}
