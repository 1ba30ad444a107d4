"""Blockwise fused softmax cross-entropy for large vocabularies.

The port of the JAX package's ``ops/ce.py``: the per-token NLL of
``softmax(hidden @ weight)`` computed from the hidden states and the head
weight directly, one vocabulary block at a time, so the ``[N, V]`` logits
never exist.

- forward: each ``[N, block]`` logits tile is folded into an online
  logsumexp while the target logit is gathered from whichever block holds
  it;
- backward: each block's logits are recomputed, ``softmax - onehot`` is
  formed tile by tile from the saved logsumexp, and ``dhidden`` and the
  block's ``dW`` are accumulated.

The block products are ``torch.matmul`` in f32 (bf16 inputs are widened,
which is what an f32 accumulation of bf16 products gives).  The last
block is padded with ``NEG_INF`` columns, as the JAX version pads it.

Vocab-parallel (``tp``: the weight is this tensor-parallel rank's ``[D,
V / tp]`` columns, the hidden states the same on every rank): each rank
folds its own columns into an online logsumexp; the maxima are
all-reduced (MAX), then the rescaled sums of exponentials, the target
logit (from the one rank whose columns hold it) and the count of ranks
that hold it in one all-reduce (SUM).  The backward forms each rank's
``softmax - onehot`` from the global logsumexp and all-reduces the partial
``dhidden``.  No rank ever holds ``[N, V]`` logits.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30  # finite: keeps exp()=0 without inf-inf NaNs


def _block_logits(hidden_f, wt, start: int, bs: int):
    """f32 [N, bs] logits of vocab block [start, start + bs); the padded
    columns past V are NEG_INF."""
    logits = hidden_f @ wt[start:start + bs].float().t()
    pad = bs - logits.shape[1]
    if pad:
        logits = F.pad(logits, (0, pad), value=NEG_INF)
    return logits


def _target_in_block(targets, start: int, bs: int):
    idx = targets - start
    inside = (idx >= 0) & (idx < bs)
    return inside, idx.clamp(0, bs - 1)


def _ce_fwd(hidden, weight, targets, bs: int, tp=None):
    """``(nll, lse)``; under ``tp`` ``targets`` are already this rank's
    column ids (global id minus the rank's first column)."""
    N = hidden.shape[0]
    V = weight.shape[1]
    wt = weight.t()                       # [V, D]
    hidden_f = hidden.float()
    m = torch.full((N,), NEG_INF, dtype=torch.float32, device=hidden.device)
    l = torch.zeros(N, dtype=torch.float32, device=hidden.device)
    tgt = torch.full((N,), NEG_INF, dtype=torch.float32, device=hidden.device)
    for start in range(0, V, bs):
        logits = _block_logits(hidden_f, wt, start, bs)
        m_new = torch.maximum(m, logits.amax(dim=1))
        l = l * torch.exp(m - m_new) + torch.exp(logits - m_new[:, None]).sum(dim=1)
        m = m_new
        inside, safe = _target_in_block(targets, start, bs)
        val = logits.gather(1, safe[:, None])[:, 0]
        tgt = torch.where(inside, val, tgt)
    if tp is not None:
        import torch.distributed as dist

        m_all = m.clone()
        dist.all_reduce(m_all, op=dist.ReduceOp.MAX, group=tp.group)
        found = (targets >= 0) & (targets < V)
        sums = torch.stack([l * torch.exp(m - m_all), torch.where(found, tgt, 0.0),
                            found.float()])
        dist.all_reduce(sums, group=tp.group)
        m, l = m_all, sums[0]
        tgt = torch.where(sums[2] > 0, sums[1], NEG_INF)
    lse = m + torch.log(l)
    return lse - tgt, lse


class _BlockwiseCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hidden, weight, targets, block_size: int, tp):
        nll, lse = _ce_fwd(hidden, weight, targets, block_size, tp)
        ctx.save_for_backward(hidden, weight, targets, lse)
        ctx.block_size = block_size
        ctx.tp = tp
        return nll

    @staticmethod
    def backward(ctx, g):
        hidden, weight, targets, lse = ctx.saved_tensors
        bs = ctx.block_size
        N, D = hidden.shape
        V = weight.shape[1]
        wt = weight.t()
        hidden_f = hidden.float()
        g = g.float()
        dh = torch.zeros(N, D, dtype=torch.float32, device=hidden.device)
        dwt = torch.empty(V, D, dtype=torch.float32, device=hidden.device)
        cols = torch.arange(bs, device=hidden.device)
        for start in range(0, V, bs):
            logits = _block_logits(hidden_f, wt, start, bs)
            p = torch.exp(logits - lse[:, None])          # softmax tile (pad -> 0)
            inside, onehot_col = _target_in_block(targets, start, bs)
            p = p - (inside[:, None] & (cols[None, :] == onehot_col[:, None])).float()
            dlogits = p * g[:, None]                      # [N, bs] f32
            n = min(bs, V - start)
            wb = wt[start:start + n].float()
            dh += dlogits[:, :n] @ wb
            dwt[start:start + n] = dlogits[:, :n].t() @ hidden_f
        if ctx.tp is not None:
            import torch.distributed as dist
            dist.all_reduce(dh, group=ctx.tp.group)
        return dh.to(hidden.dtype), dwt.t().to(weight.dtype), None, None, None


def blockwise_cross_entropy(hidden, weight, targets, *, block_size: int = 4096, tp=None):
    """Per-token NLL of ``softmax(hidden @ weight)`` against ``targets``
    without materialising the logits.

    ``hidden``: ``[..., D]`` (bf16 or f32), ``weight``: ``[D, V]``,
    ``targets``: ``[...]`` int; returns f32 NLL of ``targets``' shape.
    Differentiable in ``hidden`` and ``weight``.

    Targets must be valid ids in ``[0, V)``: an out-of-range id returns a
    huge (~1e30) NLL instead of raising, as the JAX version does.

    ``tp`` (``parallel/tp.py:TP``): ``weight`` is this rank's ``[D, V /
    tp]`` columns of a vocab-parallel head; every rank returns the NLL
    over the whole vocabulary (collective over the tp group)."""
    if targets.dtype.is_floating_point or targets.dtype == torch.bool:
        raise TypeError(f"targets must be integer ids, got {targets.dtype}")
    lead = targets.shape
    h2 = hidden.reshape(-1, hidden.shape[-1])
    t2 = targets.reshape(-1).long()
    if h2.shape[0] != t2.shape[0]:
        raise ValueError(f"hidden leading dims {tuple(hidden.shape[:-1])} != "
                         f"targets shape {tuple(lead)}")
    if tp is not None:
        t2 = t2 - tp.rank * weight.shape[1]
    nll = _BlockwiseCE.apply(h2, weight, t2, int(block_size), tp)
    return nll.reshape(lead)
