"""Megatron-style tensor parallelism on a mesh's ``tp`` group, and the
groups of the other model axes (``ep``, ``sp``, ``pp``).

A column-parallel layer holds a slice of its output features, a
row-parallel one a slice of its input features; a column-parallel layer
followed by a row-parallel one needs one collective in each direction:

- :func:`copy_to` before a column-parallel input: the identity forward,
  an all-reduce of the input gradient backward (each rank's gradient covers
  only its own output columns);
- :func:`reduce_from` after a row-parallel output: an all-reduce of the
  partial sums forward, the identity backward;
- :func:`gather_from_tp` for a vocab-parallel output read whole (logits):
  the local slab written into zeros at its columns and all-reduced forward,
  the rank's own columns of the gradient backward;
- :func:`gather_seq`, the same along the sequence over an ``sp`` group
  (its backward sums the gradients: a reduce-scatter).

An MoE layer's experts are cut over both ``tp`` and ``ep``
(``ops/moe.py``): :func:`shards_of` gives the one group of ranks that hold
a layer's pieces, so its partial sums take one all-reduce.

Every collective is an all-reduce, in f32 whatever the tensor's dtype (the
partial sums are added once, then rounded to the compute dtype), so a gloo
group that reduces CUDA tensors serves as well as NCCL.  Tensors handed to
these functions are plain local tensors, never DTensors: the attention
kernels receive ``[B, L, H/tp, D]`` with a real data pointer.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, ClassVar

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class AxisGroup:
    """A process group along one mesh axis and this rank's place in it
    (``group`` None: the world)."""

    group: Any
    rank: int
    size: int
    axis: ClassVar[str] = ""

    @classmethod
    def of(cls, mesh):
        """The group of ``cls.axis`` in a ``DeviceMesh``, or None when that
        dim is 1."""
        if mesh is None or mesh[cls.axis].size() == 1:
            return None
        return cls(mesh.get_group(cls.axis), mesh.get_local_rank(cls.axis),
                   mesh[cls.axis].size())


class TP(AxisGroup):
    """A tensor-parallel group."""

    axis = "tp"


class EP(AxisGroup):
    """An expert-parallel group (``ops/moe.py``)."""

    axis = "ep"


class SP(AxisGroup):
    """A sequence-parallel group (``ops/ring.py``, ``seq_chunk``)."""

    axis = "sp"


class PP(AxisGroup):
    """A pipeline group (``ops/pipeline.py``): ``rank`` is this rank's
    stage, of ``size``, along ``AXIS_ORDER``'s pp dim."""

    axis = "pp"

    @property
    def prev(self) -> int | None:
        """The global rank of the stage before this one (None at stage 0)."""
        return None if self.rank == 0 else self.global_rank(self.rank - 1)

    @property
    def next(self) -> int | None:
        """The global rank of the stage after this one (None at the last)."""
        return None if self.rank == self.size - 1 else self.global_rank(self.rank + 1)

    def global_rank(self, stage: int) -> int:
        return stage if self.group is None else dist.get_global_rank(self.group, stage)


def all_reduce_f32(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The all-reduce of ``x`` in f32 over ``group``, back in ``x``'s dtype
    (a new tensor; ``x`` is left as it was)."""
    buf = x.to(torch.float32, copy=True)
    dist.all_reduce(buf, op=op, group=group)
    return buf.to(x.dtype)


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_f32(g, ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_f32(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp: TP):
        n = x.shape[-1]
        ctx.cols = (tp.rank * n, (tp.rank + 1) * n)
        full = x.new_zeros(*x.shape[:-1], n * tp.size, dtype=torch.float32)
        full[..., ctx.cols[0]:ctx.cols[1]] = x
        dist.all_reduce(full, group=tp.group)
        return full.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g[..., ctx.cols[0]:ctx.cols[1]], None


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sp: AxisGroup):
        n = x.shape[1]
        ctx.group, ctx.rows = sp.group, (sp.rank * n, (sp.rank + 1) * n)
        full = x.new_zeros(x.shape[0], n * sp.size, *x.shape[2:], dtype=torch.float32)
        full[:, ctx.rows[0]:ctx.rows[1]] = x
        dist.all_reduce(full, group=sp.group)
        return full.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        # the reduce-scatter: every rank's gradient of the whole summed,
        # this rank's rows kept
        return all_reduce_f32(g, ctx.group)[:, ctx.rows[0]:ctx.rows[1]], None


def gather_seq(x, sp: AxisGroup | None):
    """Dim 1 (the sequence) of every ``sp`` rank's ``x``, concatenated in
    rank order (each rank's chunk written into zeros and all-reduced in
    f32: exact); the backward sums the ranks' gradients and keeps this
    rank's rows."""
    return x if sp is None else _GatherSeq.apply(x, sp)


def copy_to(x, group: AxisGroup | None):
    """The identity forward; the gradient all-reduced over ``group``
    backward (None: the identity both ways)."""
    return x if group is None else _CopyToTP.apply(x, group.group)


def reduce_from(x, group: AxisGroup | None):
    """The partial sums all-reduced over ``group`` forward (None: the
    identity both ways); the identity backward."""
    return x if group is None else _ReduceFromTP.apply(x, group.group)


def shards_of(mesh) -> AxisGroup | None:
    """The ranks of ``mesh`` that hold the pieces of one MoE layer's experts:
    its tp and ep ranks, as one group (None when both dims are 1).  Where
    one of the two dims is 1 that is the other's group; where both are
    wider, a new group for each (tp, ep) block of the mesh, made by every
    rank of the world in the same order (collective)."""
    tp, ep = TP.of(mesh), EP.of(mesh)
    if tp is None or ep is None:
        return tp or ep
    if tuple(mesh.mesh_dim_names[-2:]) != ("tp", "ep"):
        raise ValueError(f"tp and ep are not the mesh's last dims: {mesh.mesh_dim_names}")
    n, me, mine = tp.size * ep.size, dist.get_rank(), None
    for ranks in mesh.mesh.reshape(-1, n).tolist():
        group = dist.new_group(ranks)
        if me in ranks:
            mine = AxisGroup(group, ranks.index(me), n)
    return mine


def gather_from_tp(x, tp: TP | None):
    """The last dim of every tp rank's ``x``, concatenated in rank order."""
    return x if tp is None else _GatherFromTP.apply(x, tp)
