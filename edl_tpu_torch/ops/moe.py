"""Mixture-of-experts MLP with expert parallelism over the ``ep`` axis.

The port of the JAX package's ``ops/moe.py``: a GShard-style top-k routed
expert FFN whose routing is dense dispatch/combine einsums against expert
weights with a leading ``expert`` dim.  Where XLA derives the collectives
from the shardings, here they are written out (``parallel/tp.py``):

- the router is computed whole on every ``ep`` and ``tp`` rank;
- each ``ep`` rank holds ``E / ep`` experts (:meth:`MoEMLP.set_ep`) and each
  ``tp`` rank ``H / tp`` of every expert's hidden columns, so a rank's
  combine is a partial sum, all-reduced forward (the identity backward)
  over ``MoEMLP.shards``: one group of the layer's tp and ep ranks
  (``parallel/tp.py:shards_of``), so the pieces are added once, then
  rounded;
- the backward all-reduce of the routing's gradient runs on the probabilities
  ``[B, S, E]`` that feed the gates (not on ``combine [B, S, E, C]``), and the
  expert input's on ``x [B, S, M]``; the aux loss reads the probabilities
  outside that all-reduce, since every rank computes it whole.

Shapes (one group per batch row): tokens ``[B, S, M]``, experts ``E``, per
expert capacity ``C = ceil(top_k * S * capacity_factor / E)`` from the
static S.  Assignments past an expert's capacity are dropped (combine weight
0), and counted: the forward returns the count beside the output and the
aux loss (the JAX package sows it as ``moe_drops``).  The aux loss is the
Switch form ``E * sum_e f_e * P_e``.

Under sequence parallelism (``MoEMLP.sp``: each rank a chunk of ``S / sp``
tokens of every row) the routing is the whole sequence's, as GSPMD computes
it in JAX: ``C`` from the whole ``S``; a token's slot for choice k at expert
e is its cumsum within the chunk plus every rank's count of choices k' < k
at e plus the lower sp ranks' count of choice k at e (slots are k-major over
the whole sequence), from one all-reduce of the ``[sp, B, K, E]`` counts;
the drop count is the whole sequence's (from the same counts), and ``f``
and ``P`` are summed over sp before the product.  The expert buffer ``[E,
B, C, M]`` needs no reduction over sp: each slot holds at most one token,
and its rank alone writes it and reads it back (the other ranks' copies of
that slot are zero, and the expert MLP maps a zero slot to zero), so each
rank computes the experts on its own tokens' slots; under ``ep`` the
partial sums of one chunk's tokens add up over the layer's tp and ep ranks,
which share an sp coordinate, as before.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from edl_tpu_torch.parallel.tp import AxisGroup, copy_to, reduce_from


def top_k_indices(probs: torch.Tensor, k: int) -> torch.Tensor:
    """The indices of the k largest entries of the last dim, the lower index
    first among equal values (``jax.lax.top_k``'s order; a stable descending
    sort keeps it, where ``torch.topk`` promises none)."""
    return torch.sort(probs, dim=-1, descending=True, stable=True).indices[..., :k]


class _AllReduceData(torch.autograd.Function):
    """The sum over the data group forward; the upstream gradient times the
    group size backward.  The aux loss built on it is the global batch's
    and its gradient is the same on every rank; the trainer then averages
    the ranks' gradients over the data group, and the factor makes that
    average the gradient of the one global term."""

    @staticmethod
    def forward(ctx, x, group: AxisGroup):
        ctx.size = group.size
        out = x.to(torch.float32, copy=True)
        dist.all_reduce(out, group=group.group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g * ctx.size, None


def _slot_offsets(counts, sp: AxisGroup | None):
    """``(offsets [B, K, E], totals [B, K, E])`` of the local k-major choice
    counts ``[B, K, E]``: where this rank's first choice k at expert e
    lands in e's slots, and the whole sequence's counts (over ``sp``'s
    ranks, this rank's chunk last among the lower ones)."""
    if sp is None:
        totals, lower = counts, torch.zeros_like(counts)
    else:
        every = counts.new_zeros((sp.size,) + counts.shape)
        every[sp.rank] = counts
        dist.all_reduce(every, group=sp.group)      # small integers in f32: exact
        totals, lower = every.sum(0), every[:sp.rank].sum(0)
    before_k = torch.cumsum(totals, dim=1) - totals
    return before_k + lower, totals


def compute_routing(probs, top_k: int, capacity: int, valid=None, gate_probs=None,
                    data: AxisGroup | None = None, sp: AxisGroup | None = None):
    """Routing tensors from router probabilities ``[B, S, E]``.

    Returns ``(dispatch [B, S, E, C] in {0, 1}, combine [B, S, E, C] f32,
    aux scalar, drops scalar int32)``.  Slot priority is k-major (every
    token's first choice is placed before any token's second choice), and
    positions within an expert are in sequence order.  ``drops`` counts the
    (token, expert) assignments that overflowed.  ``valid`` ([B, S] bool):
    the real tokens; the others claim no slot, add no combine weight and are
    left out of ``drops`` and the aux loss.

    ``gate_probs``: the probabilities the gates are read from (default
    ``probs``; :class:`MoEMLP` passes them through the backward all-reduce
    of its groups).  ``data``: a group over which ``f`` and ``P`` are the
    global batch's (their sums and the token count all-reduced before the
    product; under sp it holds the sp ranks too, as the trainer's does).
    ``sp``: the group whose ranks hold the other chunks of each row
    (``probs`` is this rank's chunk, ``capacity`` the whole sequence's): the
    slots, drops and, without ``data``, ``f`` and ``P`` are the whole
    sequence's (module docstring)."""
    B, S, E = probs.shape
    K = top_k
    idx = top_k_indices(probs.detach(), K)                   # [B, S, K]
    gates = (probs if gate_probs is None else gate_probs).gather(-1, idx)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    onehot = F.one_hot(idx, E).to(torch.float32)             # [B, S, K, E]
    if valid is not None:
        onehot = onehot * valid[:, :, None, None].to(torch.float32)

    # k-major slot order: [B, K, S, E], each choice k's slots after every
    # choice k' < k of the whole sequence and after the lower sp ranks'
    slots = onehot.transpose(1, 2)
    offsets, totals = _slot_offsets(slots.sum(dim=2), sp)
    pos = ((torch.cumsum(slots, dim=2) + offsets[:, :, None]) * slots).to(torch.int32) - 1
    pos = pos.reshape(B, K * S, E)
    kept = (pos >= 0) & (pos < capacity)
    if sp is None:
        n_real = B * S if valid is None else valid.sum()
        drops = (n_real * K - kept.sum()).to(torch.int32)
    else:
        # the whole sequence's: each (k, e) keeps what fits after its offset
        fits = (capacity - (torch.cumsum(totals, dim=1) - totals)).clamp(min=0)
        drops = (totals.sum() - torch.minimum(totals, fits).sum()).to(torch.int32)
    pos_c = F.one_hot(pos.clamp(0, capacity - 1).long(), capacity).to(torch.float32)
    pos_c = pos_c * kept[..., None]
    # back to token-major [B, S, K, E, C]; merge k (a distinct (e, c) each)
    pos_c = pos_c.reshape(B, K, S, E, capacity).transpose(1, 2)
    dispatch = pos_c.sum(dim=2)                              # [B, S, E, C]
    combine = torch.einsum("bske,bskec->bsec", onehot * gates[..., None], pos_c)

    # Switch aux loss from top-1 assignments (over real tokens only)
    top1 = F.one_hot(idx[..., 0], E).to(torch.float32)
    if valid is None:
        v = torch.ones(B, S, 1, dtype=torch.float32, device=probs.device)
    else:
        v = valid.to(torch.float32)[..., None]
    sums = torch.cat([(top1 * v).sum(dim=(0, 1)), (probs * v).sum(dim=(0, 1)),
                      v.sum().reshape(1)])
    group = data if data is not None and data.size > 1 else sp
    if group is not None:
        sums = _AllReduceData.apply(sums, group)
    n = sums[-1].clamp_min(1.0)
    aux = E * torch.sum((sums[:E] / n) * (sums[E:2 * E] / n))
    return dispatch, combine, aux, drops


def capacity_of(top_k: int, seq: int, capacity_factor: float, experts: int) -> int:
    """The per-expert capacity at a static sequence length."""
    return max(1, math.ceil(top_k * seq * capacity_factor / experts))


class MoEMLP(nn.Module):
    """Top-k routed expert FFN: ``forward(x, token_mask) -> (y [B, S, M],
    aux, drops)``.  Parameters (f32): ``gate [M, E]``, ``w_in [E, M, H]``,
    ``w_out [E, H, M]``, left uninitialised (``TransformerLM`` initialises
    them); an expert is ``silu(x @ w_in[e]) @ w_out[e]`` (not the dense
    block's SwiGLU).  The router runs in f32, the expert products in
    ``dtype``, and the output is cast to ``dtype``.

    ``decode=True`` with S <= 2 (a decode step) reads each token's top-k
    experts with no capacity (no drops, aux 0): every expert's products are
    computed for those few tokens and the chosen ones gathered, so no
    ``[B, S, K, M, H]`` weight copy is made.  A longer decode pass (a
    prefill, a speculative verify) takes the capacity path."""

    def __init__(self, embed_dim: int, num_experts: int, mlp_dim: int, top_k: int = 2,
                 capacity_factor: float = 1.25, dtype=torch.bfloat16, decode: bool = False):
        super().__init__()
        M, E, H = embed_dim, num_experts, mlp_dim
        self.num_experts, self.top_k = E, top_k
        self.capacity_factor, self.dtype, self.decode = capacity_factor, dtype, decode
        self.gate = nn.Parameter(torch.empty(M, E))
        self.w_in = nn.Parameter(torch.empty(E, M, H))
        self.w_out = nn.Parameter(torch.empty(E, H, M))
        self.ep: AxisGroup | None = None     # E / ep experts (set_ep)
        # the ranks that hold pieces of the experts (E / ep of them, H / tp
        # hidden columns of each: tp x ep), whose partial sums add up
        self.shards: AxisGroup | None = None
        # the ranks that hold other rows of the batch: the aux loss's f and
        # P are taken over all of them when the caller asks for the aux
        self.data: AxisGroup | None = None
        # the ranks that hold the other chunks of every row (sequence
        # parallelism): the routing is the whole sequence's
        self.sp: AxisGroup | None = None

    def set_ep(self, ep: AxisGroup | None, shards: AxisGroup | None = None) -> None:
        """Hold experts ``[r E/ep, (r+1) E/ep)`` of ``ep``'s rank r;
        ``shards``: the group of every tp and ep rank of the layer
        (``parallel/tp.py:shards_of``), needed when tp is set too (default
        ``ep``)."""
        if ep is not None and self.num_experts % ep.size:
            raise ValueError(f"{self.num_experts} experts do not divide over ep = {ep.size}")
        if shards is None and ep is not None and self.shards is not None:
            raise ValueError("at tp > 1 the ep layer needs the group of its tp and ep "
                             "ranks (parallel/tp.py:shards_of)")
        self.ep = ep
        self.shards = shards if shards is not None else ep

    def forward(self, x, token_mask=None, global_aux: bool = False):
        """``(y, aux, drops)``: ``drops`` (an int32 scalar) is the capacity
        path's overflow count (under sp, the whole sequence's), 0 on a
        decode step.  ``global_aux``: reduce
        ``f`` and ``P`` over the data group (``self.data``); collective, so
        every rank of it must call."""
        B, S, M = x.shape
        E, K, dtype = self.num_experts, self.top_k, self.dtype
        probs = torch.softmax(x.float() @ self.gate, dim=-1)
        gate_probs = copy_to(probs, self.shards)
        if self.decode and S <= 2:
            zero = torch.zeros((), dtype=torch.float32, device=x.device)
            return self._gather(x, gate_probs), zero, zero.to(torch.int32)
        C = capacity_of(K, S * (1 if self.sp is None else self.sp.size), self.capacity_factor, E)
        dispatch, combine, aux, n_drop = compute_routing(
            probs, K, C, valid=token_mask, gate_probs=gate_probs,
            data=self.data if global_aux else None, sp=self.sp)
        lo, hi = self._experts()
        xe = copy_to(x, self.shards).to(dtype)
        expert_in = torch.einsum("bsec,bsm->ebcm", dispatch[:, :, lo:hi].to(dtype), xe)
        h = F.silu(torch.einsum("ebcm,emh->ebch", expert_in, self.w_in.to(dtype)))
        out = torch.einsum("ebch,ehm->ebcm", h, self.w_out.to(dtype))
        y = torch.einsum("bsec,ebcm->bsm", combine[:, :, lo:hi].to(dtype), out)
        return reduce_from(y, self.shards).to(dtype), aux, n_drop

    def _experts(self) -> tuple[int, int]:
        """The global index range of this rank's experts."""
        if self.ep is None:
            return 0, self.num_experts
        n = self.num_experts // self.ep.size
        return self.ep.rank * n, (self.ep.rank + 1) * n

    def _gather(self, x, probs):
        """The decode step's drop-free form: each token's top-k experts,
        gates renormalised, with no capacity."""
        dtype, (lo, hi) = self.dtype, self._experts()
        idx = top_k_indices(probs.detach(), self.top_k)
        gates = probs.gather(-1, idx)
        gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)      # [B, S, K]
        xe = copy_to(x, self.shards).to(dtype)
        h = F.silu(torch.einsum("bsm,emh->bseh", xe, self.w_in.to(dtype)))
        out = torch.einsum("bseh,ehm->bsem", h, self.w_out.to(dtype))   # this rank's experts
        # a chosen expert held elsewhere adds nothing here (its rank adds it)
        local = (idx >= lo) & (idx < hi)
        at = (idx - lo).clamp(0, hi - lo - 1)
        picked = out.gather(2, at[..., None].expand(*at.shape, out.shape[-1]))
        w = (gates * local).to(dtype)
        y = (picked * w[..., None]).sum(dim=2)
        return reduce_from(y, self.shards).to(dtype)
