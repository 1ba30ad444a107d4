"""Ring attention: exact attention over a sequence split across the ``sp``
group.

The port of the JAX package's ``ops/ring.py``.  Queries stay put; the key
and value blocks rotate to the next rank of the ring on each hop, and each
rank folds every block into an online softmax (the flash recurrence carried
across ranks).  JAX rotates with ``ppermute`` and differentiates through
it; here :class:`_Rotate` sends and receives with point-to-point ops, and
its backward is the reverse rotation; k and v travel as one message, so
every rank posts its sends and receives in one order.  Each hop is plain
torch, as JAX's is plain jnp.

Numerics follow the JAX body: logits and the value product take the input
dtype's values with f32 accumulation (computed on their f32 upcasts, which
hold a bf16 product exactly), the probabilities are cast to the input dtype
before the value product, the running max starts at a finite ``NEG_INF``,
masks are causal by global positions, and each hop folds ``kv_chunk`` keys
at a time with a zero-padded, masked tail.  Hop 0 is the rank's own block,
its chunks folded in order, so a row's first fold always sees its diagonal.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from edl_tpu_torch.parallel.tp import AxisGroup

NEG_INF = -1e30   # large but finite: no inf - inf = nan in the recurrence


def _shift(x: torch.Tensor, group: AxisGroup, step: int) -> torch.Tensor:
    """``x`` sent to the rank ``step`` ahead in the ring, and the block of
    the rank ``step`` behind received (one send and one receive posted
    together, so a two-rank ring cannot deadlock).  A gloo group moves a
    CUDA tensor's bytes through pinned host buffers; any failure raises."""
    n, me = group.size, group.rank
    dst = dist.get_global_rank(group.group, (me + step) % n)
    src = dist.get_global_rank(group.group, (me - step) % n)
    staged = x.device.type == "cuda" and dist.get_backend(group.group) == "gloo"
    send = x.contiguous()
    if staged:
        send = torch.empty(x.shape, dtype=x.dtype, pin_memory=True).copy_(send)
    recv = torch.empty_like(send)
    works = dist.batch_isend_irecv([dist.P2POp(dist.isend, send, dst, group.group),
                                    dist.P2POp(dist.irecv, recv, src, group.group)])
    for w in works:
        w.wait()
    return recv.to(x.device, non_blocking=False) if staged else recv


class _Rotate(torch.autograd.Function):
    """One hop of the ring forward; the reverse hop backward (the transpose
    of a rotation)."""

    @staticmethod
    def forward(ctx, x, group: AxisGroup):
        ctx.group = group
        return _shift(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -1), None


def rotate(x: torch.Tensor, group: AxisGroup) -> torch.Tensor:
    """``x`` of the previous rank of the ring (differentiable)."""
    return _Rotate.apply(x, group)


def _fold(q, kc, vc, mask, state, scale: float):
    """One chunk into the online softmax state ``(m [B, H, Lq], l [B, H,
    Lq], acc [B, Lq, H, D])``; ``mask [Lq, C]`` or None: the keys each
    query may attend to."""
    m, l, acc = state
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kc.float()) * scale
    if mask is not None:
        logits = logits.masked_fill(~mask, NEG_INF)
    m_new = torch.maximum(m, logits.amax(dim=-1))
    p = torch.exp(logits - m_new[..., None])
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype).float(), vc.float())
    acc = acc * corr.transpose(1, 2)[..., None] + pv
    return m_new, l, acc


def ring_attention(q, k, v, group: AxisGroup | None, *, causal: bool = False,
                   sm_scale: float | None = None, kv_chunk: int = 1024):
    """Attention of this rank's queries ``[B, Lq, H, D]`` against the whole
    sequence, whose blocks ``[B, Lk, H, D]`` (the same heads as q: GQA is
    expanded by the caller) lie on the ranks of ``group`` in rank order.
    ``kv_chunk`` bounds the logits tile within a hop (0: the whole block).
    Returns ``[B, Lq, H, D]`` in q's dtype."""
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    n, me = (1, 0) if group is None else (group.size, group.rank)
    scale = float(sm_scale if sm_scale is not None else D ** -0.5)
    dev = q.device
    q_pos = me * Lq + torch.arange(Lq, device=dev)
    chunk = Lk if kv_chunk <= 0 else min(kv_chunk, Lk)
    n_chunks = -(-Lk // chunk)
    pad = n_chunks * chunk - Lk
    state = (torch.full((B, H, Lq), NEG_INF, dtype=torch.float32, device=dev),
             torch.zeros(B, H, Lq, dtype=torch.float32, device=dev),
             torch.zeros(B, Lq, H, D, dtype=torch.float32, device=dev))
    for step in range(n):
        src = (me - step) % n                           # owner of this block
        kp, vp = k, v
        if pad:
            kp = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
            vp = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        for i in range(n_chunks):
            local = i * chunk + torch.arange(chunk, device=dev)
            mask = None
            if pad:
                mask = (local < Lk)[None, :].expand(Lq, chunk)
            if causal:
                c = q_pos[:, None] >= (src * Lk + local)[None, :]
                mask = c if mask is None else mask & c
            state = _fold(q, kp[:, i * chunk:(i + 1) * chunk],
                          vp[:, i * chunk:(i + 1) * chunk], mask, state, scale)
        if step + 1 < n:                # rotate the k/v blocks, as one message
            k, v = rotate(torch.stack([k, v]), group).unbind(0)
    _, l, acc = state
    out = acc / l.transpose(1, 2)[..., None].clamp_min(1e-30)
    return out.to(q.dtype)

