"""Pipeline parallelism over the ``pp`` mesh axis: GPipe.

The port of the JAX package's ``ops/pipeline.py``.  Stage parameters live
on their pp rank (the stacked layers' leading "stage" dim cut over ``pp``,
``parallel/sharding.py:shard_init``): a rank holds ``n_layers / S``
consecutive layers, a superstage, chained in order.  The batch is cut into
``M`` microbatches; stage 0 injects them, every other stage takes what its
predecessor sent, and the last stage's outputs are sent to every pp rank,
so the result is replicated over ``pp`` as JAX's psum leaves it, and each
rank computes the head and the loss on the same outputs.

JAX runs a statically unrolled schedule of ``M + S - 1`` ticks in lockstep
and lets AD transpose ``ppermute``.  Here each stage runs only its ``M``
active ticks: an idle tick is skipped, since a stage's tp group lies inside
that stage and no collective of another stage waits on it (JAX computes on
garbage there only because a per-shard ``lax.cond`` deadlocks XLA's tp
collectives).  The hand-offs are ``torch.autograd.Function`` s whose
backward sends the gradient the other way (the transpose of a shift is the
reverse shift):

- :class:`_Arrive`: a microbatch's input (stage 0: its slice of ``x``;
  else received from the previous stage); backward, its gradient sent back;
- :class:`_Send`: a microbatch's output to the next stage; backward, its
  gradient received from there;
- :class:`_Emit`: the last stage's outputs broadcast over ``pp``; backward,
  the last stage keeps its own copy's gradient and the others drop theirs
  (every rank computed the same loss on the same outputs, so one copy is
  the gradient, not ``S`` of them);
- :class:`_FromReplicated`: ``x`` (replicated over pp: the embedding's
  output) enters only at stage 0; backward, its gradient is summed over
  ``pp`` (stage 0's, zeros elsewhere), so a leaf before the pipeline gets
  the same gradient on every stage, as psum's transpose gives it in JAX.

Each rank threads a 0-d token through its hand-offs in schedule order, so
autograd runs their backwards in the reverse order on every rank: stage s
sends microbatch m's gradient back only after the stage after it did, and
the point-to-point messages pair up without a deadlock.  The transport is
``ops/ring.py:exchange`` (pinned host buffers on gloo, so two ranks share
one card; NCCL across cards).  The bubble is GPipe's (S-1)/(M+S-1).
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_leaves, tree_map

from edl_tpu_torch.ops.ring import exchange
from edl_tpu_torch.parallel.tp import PP


class _Start(torch.autograd.Function):
    """The token that orders this rank's hand-offs, made from ``x`` so that
    ``x``'s backward runs on every rank (a zero gradient from here)."""

    @staticmethod
    def forward(ctx, x):
        ctx.like = (x.shape, x.dtype, x.device)
        return x.new_zeros(())

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.like
        return torch.zeros(shape, dtype=dtype, device=device)


class _FromReplicated(torch.autograd.Function):
    """The identity forward; the gradient summed over ``pp`` backward."""

    @staticmethod
    def forward(ctx, x, pp: PP):
        ctx.pp = pp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        # one nonzero term (stage 0's), so the sum is exact; f64 stays f64
        buf = g.to(torch.promote_types(g.dtype, torch.float32), copy=True)
        dist.all_reduce(buf, group=ctx.pp.group)
        return buf.to(g.dtype), None


class _Arrive(torch.autograd.Function):
    """Microbatch input of this stage: ``x_m`` itself at stage 0, else a
    tensor like it received from the previous stage."""

    @staticmethod
    def forward(ctx, tok, x_m, pp: PP):
        ctx.pp = pp
        if pp.prev is None:
            h = x_m.view_as(x_m)
        else:
            h = exchange(pp.group, like=x_m, src=pp.prev)
        return h, tok.view_as(tok)

    @staticmethod
    def backward(ctx, g_h, g_tok):
        pp = ctx.pp
        if pp.prev is None:
            return g_tok, g_h, None
        exchange(pp.group, g_h, pp.prev)
        return g_tok, None, None


class _Send(torch.autograd.Function):
    """Microbatch output of this stage, sent to the next."""

    @staticmethod
    def forward(ctx, h, tok, pp: PP):
        ctx.pp, ctx.like = pp, torch.empty(0, dtype=h.dtype, device=h.device)
        ctx.shape = h.shape
        exchange(pp.group, h.detach(), pp.next)
        return tok.view_as(tok)

    @staticmethod
    def backward(ctx, g_tok):
        pp = ctx.pp
        like = ctx.like.new_empty(ctx.shape)
        return exchange(pp.group, like=like, src=pp.next), g_tok, None


class _Emit(torch.autograd.Function):
    """The last stage's outputs on every pp rank (``outs``: the outputs on
    the last stage, a tensor like them elsewhere)."""

    @staticmethod
    def forward(ctx, outs, tok, pp: PP):
        ctx.pp, ctx.tok = pp, (tok.shape, tok.dtype, tok.device)
        buf = outs.detach().clone()
        dist.broadcast(buf, pp.global_rank(pp.size - 1), group=pp.group)
        return buf

    @staticmethod
    def backward(ctx, g):
        pp = ctx.pp
        shape, dtype, device = ctx.tok
        g_tok = torch.zeros(shape, dtype=dtype, device=device)
        return (g if pp.next is None else None), g_tok, None


def pipeline(superstage: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
             pp: PP | None, n_microbatches: int) -> torch.Tensor:
    """``superstage(h) -> h`` (this rank's layers in order; shape and dtype
    kept) over ``x [B, ...]`` in ``n_microbatches`` microbatches pipelined
    over ``pp``'s stages; the last stage's outputs, on every pp rank.
    Collective over ``pp``: every rank of it calls, with ``x`` alike
    (replicated); ``pp`` None runs ``superstage`` on ``x`` whole."""
    if pp is None or pp.size == 1:
        return superstage(x)
    B, M = x.shape[0], n_microbatches
    if B % M:
        raise ValueError(f"global batch {B} not divisible by {M} microbatches")
    x = _FromReplicated.apply(x, pp)
    # the token must take part in autograd on every rank, or a stage whose
    # inputs need no gradient (the last, with an ``x`` that needs none)
    # would never send its gradients back
    tok = _Start.apply(x) if x.requires_grad else x.new_zeros(()).requires_grad_()
    outs = []
    for x_m in x.chunk(M):
        h, tok = _Arrive.apply(tok, x_m, pp)
        out = superstage(h)
        if out.shape != h.shape or out.dtype != h.dtype:
            raise ValueError(f"a stage must keep the activation's shape and dtype: "
                             f"{tuple(h.shape)} {h.dtype} -> {tuple(out.shape)} {out.dtype}")
        if pp.next is None:
            outs.append(out)
        else:
            tok = _Send.apply(out, tok, pp)
    return _Emit.apply(torch.cat(outs) if outs else x, tok, pp)


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor], stage_params,
                   x: torch.Tensor, pp: PP | None, n_microbatches: int) -> torch.Tensor:
    """Run ``x`` through the pipelined stages: the JAX function's contract.

    - ``stage_fn(params_j, h) -> h``: one layer's computation (shape and
      dtype kept);
    - ``stage_params``: a pytree whose leaves have a leading dim, this
      rank's layers (``n_layers / S`` of them; all of them at ``S == 1``),
      chained in order: a superstage;
    - ``x``: ``[B, ...]``, the same on every pp rank; ``B`` must divide by
      ``n_microbatches``.

    Returns ``[B, ...]``, the same on every pp rank.  ``S == 1`` (``pp``
    None) runs the layers in sequence on the whole batch."""
    n = len(tree_leaves(stage_params)[0])

    def superstage(h):
        for j in range(n):
            h = stage_fn(tree_map(lambda a: a[j], stage_params), h)
        return h

    return pipeline(superstage, x, pp, n_microbatches)
