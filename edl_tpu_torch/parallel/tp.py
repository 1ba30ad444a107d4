"""Megatron-style tensor parallelism on a mesh's ``tp`` group.

A column-parallel layer holds a slice of its output features, a
row-parallel one a slice of its input features; a column-parallel layer
followed by a row-parallel one needs one collective in each direction:

- :func:`copy_to_tp` before a column-parallel input: the identity forward,
  an all-reduce of the input gradient backward (each rank's gradient covers
  only its own output columns);
- :func:`reduce_from_tp` after a row-parallel output: an all-reduce of the
  partial sums forward, the identity backward;
- :func:`gather_from_tp` for a vocab-parallel output read whole (logits):
  the local slab written into zeros at its columns and all-reduced forward,
  the rank's own columns of the gradient backward.

Every collective is an all-reduce, in f32 whatever the tensor's dtype (the
partial sums are added once, then rounded to the compute dtype), so a gloo
group that reduces CUDA tensors serves as well as NCCL.  Tensors handed to
these functions are plain local tensors, never DTensors: the attention
kernels receive ``[B, L, H/tp, D]`` with a real data pointer.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class TP:
    """A tensor-parallel group and this rank's place in it."""

    group: Any
    rank: int
    size: int

    @classmethod
    def of(cls, mesh) -> "TP | None":
        """The ``tp`` dim of a ``DeviceMesh``, or None when it is 1."""
        if mesh is None or mesh["tp"].size() == 1:
            return None
        return cls(mesh.get_group("tp"), mesh.get_local_rank("tp"), mesh["tp"].size())


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


def copy_to_tp(x, tp: TP | None):
    return x if tp is None else _CopyToTP.apply(x, tp.group)


def reduce_from_tp(x, tp: TP | None):
    return x if tp is None else _ReduceFromTP.apply(x, tp.group)


def gather_from_tp(x, tp: TP | None):
    """The last dim of every tp rank's ``x``, concatenated in rank order."""
    return x if tp is None else _GatherFromTP.apply(x, tp)
