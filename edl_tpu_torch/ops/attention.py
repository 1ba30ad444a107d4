"""Attention implementations on ``[B, L, H, D]`` tensors.

``dot_product_attention(q, k, v)`` dispatches:

- ``dense``: plain PyTorch attention with an f32 softmax; grouped-query
  attention is native (q head h uses kv head h // (H // Hk));
- ``splash``: causal self-attention through the hand-written CUDA kernels
  in ``edl_tpu_torch/csrc/attention.cu`` (forward, and a backward of three
  kernels), the counterpart of the JAX package's splash path;
- ``flash`` and ``ring``: not ported yet (``NotImplementedError``);
- ``auto``: on CUDA tensors, the kernels for causal self-attention with
  no mask and a shape they take; dense, with a once-per-shape warning,
  for a mask or a shape they refuse; ``NotImplementedError`` where the
  JAX package would run its flash kernel.  CPU tensors take dense.

Each kernel has a wrapper with a launch counter (``wrapper.launches``)
and a plain PyTorch version of the same function beside it.  A wrapper
given CPU tensors computes its plain version; given CUDA tensors it
launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
import logging

import torch

logger = logging.getLogger(__name__)

KERNEL_HEAD_DIMS = (64, 128)


# -- the plain versions --------------------------------------------------------

def dense_attention(q, k, v, *, causal: bool = False,
                    sm_scale: float | None = None, mask=None):
    """Plain attention; softmax statistics in f32 whatever the input dtype.

    ``k``/``v`` may carry fewer heads than ``q`` (``Hk`` divides ``H``);
    the causal mask is aligned bottom-right (``tril(k=Lk-Lq)``), and
    ``mask`` broadcasts against ``[B, H, Lq, Lk]``."""
    B, Lq, H, D = q.shape
    Lk, Hk = k.shape[1], k.shape[2]
    scale = sm_scale if sm_scale is not None else D ** -0.5
    if Hk == H:
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    else:
        if H % Hk:
            raise ValueError(f"q heads {H} not divisible by kv heads {Hk}")
        qg = q.reshape(B, Lq, Hk, H // Hk, D)
        logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).float() * scale
        logits = logits.reshape(B, H, Lq, Lk)
    neg = torch.tensor(float("-inf"), device=logits.device)
    if causal:
        keep = torch.ones(Lq, Lk, dtype=torch.bool, device=q.device).tril(Lk - Lq)
        logits = torch.where(keep, logits, neg)
    if mask is not None:
        logits = torch.where(torch.as_tensor(mask, device=q.device), logits, neg)
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    if Hk == H:
        return torch.einsum("bhqk,bkhd->bqhd", weights, v)
    wg = weights.reshape(B, Hk, H // Hk, Lq, Lk)
    out = torch.einsum("bhgqk,bkhd->bqhgd", wg, v)
    return out.reshape(B, Lq, H, D)


def _causal_scores(q, k, scale):
    """f32 scaled causal scores [B, H, L, L] of self-attention."""
    L = q.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    keep = torch.ones(L, L, dtype=torch.bool, device=q.device).tril()
    return s.masked_fill(~keep, float("-inf"))


def attention_fwd_plain(q, k, v, scale: float):
    """Causal self-attention in f32: ``(o [B, L, H, D] in q's dtype,
    lse [B, H, L] f32)``, the logsumexp of the scaled scores."""
    s = _causal_scores(q, k, scale)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return o.to(q.dtype), lse


def attention_bwd_delta_plain(o, do):
    """``delta[b, h, l] = sum_d dO * O`` in f32, [B, H, L]."""
    return (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()


def _probs_and_dscores(q, k, v, do, lse, delta, scale):
    p = torch.exp(_causal_scores(q, k, scale) - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return p, p * (dp - delta[..., None])


def attention_bwd_dkdv_plain(q, k, v, do, lse, delta, scale: float):
    """``(dk, dv)`` of causal self-attention from the saved logsumexp."""
    p, ds = _probs_and_dscores(q, k, v, do, lse, delta, scale)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def attention_bwd_dq_plain(q, k, v, do, lse, delta, scale: float):
    """``dq`` of causal self-attention from the saved logsumexp."""
    _, ds = _probs_and_dscores(q, k, v, do, lse, delta, scale)
    return (torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale).to(q.dtype)


# -- the kernels -----------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # q k v o lse strides B H L D scale stream
    "edl_attn_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    # o dout delta strides B H L D stream
    "edl_attn_bwd_delta": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    # q k v dout lse delta dk dv strides B H L D scale stream
    "edl_attn_bwd_dkdv": [_P] * 9 + [_I, _I, _I, _I, _F, _P],
    # q k v dout lse delta dq strides B H L D scale stream
    "edl_attn_bwd_dq": [_P] * 8 + [_I, _I, _I, _I, _F, _P],
}
_lib = None


def _kernels():
    global _lib
    if _lib is None:
        from edl_tpu_torch.ops import _build
        lib = _build.load("attn")
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _on_cpu(*ts) -> bool:
    devs = {t.device.type for t in ts}
    if devs == {"cpu"}:
        return True
    if devs != {"cuda"}:
        raise ValueError(f"attention kernels take CPU or CUDA tensors, all on "
                         f"one device; got {sorted(devs)}")
    return False


def _operand(t: torch.Tensor, name: str, shape) -> torch.Tensor:
    """Check a bf16 [B, L, H, D] operand; copy it only if its innermost
    dim is not contiguous or its rows are not 16-byte aligned."""
    if t.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the attention kernels take bfloat16, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
    if (t.stride(3) != 1 or t.data_ptr() % 16
            or any(s % 8 for s in t.stride()[:3])):
        t = t.contiguous()
    return t


def _strides(*ts) -> ctypes.Array:
    vals = [s for t in ts for s in (t.stride(0), t.stride(1), t.stride(2))]
    return (ctypes.c_longlong * len(vals))(*vals)


def _check_shape(q):
    B, L, H, D = q.shape
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"attention kernels take head_dim in {KERNEL_HEAD_DIMS}, got {D}")
    if L < 1 or B * H > 65535:
        raise ValueError(f"attention kernels need L >= 1 and B*H <= 65535; got {q.shape}")
    return B, L, H, D


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} failed with CUDA error {err}")


def _stream(t) -> _P:
    return _P(torch.cuda.current_stream(t.device).cuda_stream)


def attention_fwd(q, k, v, scale: float):
    """Causal self-attention forward: ``(o, lse)`` as
    :func:`attention_fwd_plain`.  Launches ``edl_attn_fwd`` on CUDA."""
    if _on_cpu(q, k, v):
        return attention_fwd_plain(q, k, v, scale)
    B, L, H, D = _check_shape(q)
    q, k, v = (_operand(t, n, q.shape) for t, n in ((q, "q"), (k, "k"), (v, "v")))
    o = torch.empty(B, L, H, D, dtype=q.dtype, device=q.device)
    lse = torch.empty(B, H, L, dtype=torch.float32, device=q.device)
    err = _kernels().edl_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        _strides(q, k, v, o), B, H, L, D, float(scale), _stream(q))
    _raise_on(err, "edl_attn_fwd")
    attention_fwd.launches += 1
    return o, lse


def attention_bwd_delta(o, do):
    """``rowsum(dO * O)`` as :func:`attention_bwd_delta_plain`.  Launches
    ``edl_attn_bwd_delta`` on CUDA."""
    if _on_cpu(o, do):
        return attention_bwd_delta_plain(o, do)
    B, L, H, D = _check_shape(o)
    o, do = _operand(o, "o", o.shape), _operand(do, "do", o.shape)
    delta = torch.empty(B, H, L, dtype=torch.float32, device=o.device)
    err = _kernels().edl_attn_bwd_delta(
        o.data_ptr(), do.data_ptr(), delta.data_ptr(), _strides(o, do),
        B, H, L, D, _stream(o))
    _raise_on(err, "edl_attn_bwd_delta")
    attention_bwd_delta.launches += 1
    return delta


def _stats(lse, delta, B, H, L):
    for name, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or tuple(t.shape) != (B, H, L):
            raise ValueError(f"{name}: want f32 [{B}, {H}, {L}], got "
                             f"{t.dtype} {tuple(t.shape)}")
    return lse.contiguous(), delta.contiguous()


def attention_bwd_dkdv(q, k, v, do, lse, delta, scale: float):
    """``(dk, dv)`` as :func:`attention_bwd_dkdv_plain`.  Launches
    ``edl_attn_bwd_dkdv`` on CUDA."""
    if _on_cpu(q, k, v, do, lse, delta):
        return attention_bwd_dkdv_plain(q, k, v, do, lse, delta, scale)
    B, L, H, D = _check_shape(q)
    q, k, v, do = (_operand(t, n, q.shape) for t, n in
                   ((q, "q"), (k, "k"), (v, "v"), (do, "do")))
    lse, delta = _stats(lse, delta, B, H, L)
    dk = torch.empty(B, L, H, D, dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    err = _kernels().edl_attn_bwd_dkdv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        _strides(q, k, v, do, dk, dv), B, H, L, D, float(scale), _stream(q))
    _raise_on(err, "edl_attn_bwd_dkdv")
    attention_bwd_dkdv.launches += 1
    return dk, dv


def attention_bwd_dq(q, k, v, do, lse, delta, scale: float):
    """``dq`` as :func:`attention_bwd_dq_plain`.  Launches
    ``edl_attn_bwd_dq`` on CUDA."""
    if _on_cpu(q, k, v, do, lse, delta):
        return attention_bwd_dq_plain(q, k, v, do, lse, delta, scale)
    B, L, H, D = _check_shape(q)
    q, k, v, do = (_operand(t, n, q.shape) for t, n in
                   ((q, "q"), (k, "k"), (v, "v"), (do, "do")))
    lse, delta = _stats(lse, delta, B, H, L)
    dq = torch.empty(B, L, H, D, dtype=q.dtype, device=q.device)
    err = _kernels().edl_attn_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        _strides(q, k, v, do, dq), B, H, L, D, float(scale), _stream(q))
    _raise_on(err, "edl_attn_bwd_dq")
    attention_bwd_dq.launches += 1
    return dq


KERNEL_WRAPPERS = (attention_fwd, attention_bwd_delta, attention_bwd_dkdv,
                   attention_bwd_dq)
for _w in KERNEL_WRAPPERS:
    _w.launches = 0


def reset_launch_counts() -> None:
    for w in KERNEL_WRAPPERS:
        w.launches = 0


def launch_counts() -> dict[str, int]:
    return {w.__name__: w.launches for w in KERNEL_WRAPPERS}


class SplashAttention(torch.autograd.Function):
    """Causal self-attention whose forward and backward are the kernels
    (their plain versions for CPU tensors)."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float):
        o, lse = attention_fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        delta = attention_bwd_delta(o, do)
        dk, dv = attention_bwd_dkdv(q, k, v, do, lse, delta, ctx.scale)
        dq = attention_bwd_dq(q, k, v, do, lse, delta, ctx.scale)
        return dq, dk, dv, None


# -- dispatch ----------------------------------------------------------------------

FLASH_TODO = ("the non-causal / cross-length flash attention kernels are not "
              "ported yet (ROADMAP.md, Queue 2, item 1)")


def _splash_ok(q, k, causal: bool) -> bool:
    """Shapes and types the kernels take: causal self-attention, D in
    {64, 128}, bf16 (the JAX gate also wants L % 128 == 0; these kernels
    mask a ragged last tile)."""
    return (causal and q.shape[1] == k.shape[1] and q.shape[3] in KERNEL_HEAD_DIMS
            and q.dtype == k.dtype == torch.bfloat16)


def _flash_ok(q, k) -> bool:
    """Shapes the JAX package hands to its flash kernel."""
    return q.shape[1] % 128 == 0 and k.shape[1] % 128 == 0 and q.shape[3] % 64 == 0


_warned_shapes: set[tuple] = set()


def _warn_downgrade(q, k, why: str) -> None:
    key = (q.shape[1], k.shape[1], q.shape[3], str(q.dtype), why)
    if key in _warned_shapes:
        return
    _warned_shapes.add(key)
    logger.warning("attention auto: L=%d/%d D=%d %s: %s; using dense",
                   q.shape[1], k.shape[1], q.shape[3], q.dtype, why)


def dot_product_attention(q, k, v, *, causal: bool = False,
                          sm_scale: float | None = None, mask=None,
                          impl: str = "auto"):
    """``[B, L, H, D]`` attention with implementation dispatch (see the
    module docstring).  ``mask`` (dense only) broadcasts against
    ``[B, H, Lq, Lk]``."""
    if impl == "auto":
        if q.device.type != "cuda":
            impl = "dense"
        elif mask is not None:
            _warn_downgrade(q, k, "a mask is not taken by the kernels")
            impl = "dense"
        elif _splash_ok(q, k, causal):
            impl = "splash"
        elif _flash_ok(q, k) and q.dtype == torch.bfloat16:
            raise NotImplementedError(FLASH_TODO)
        else:
            _warn_downgrade(q, k, "shape or dtype not taken by the kernels")
            impl = "dense"
    if impl == "dense":
        return dense_attention(q, k, v, causal=causal, sm_scale=sm_scale, mask=mask)
    if impl == "splash":
        if not causal:
            raise ValueError("impl='splash' is causal-only; use flash/dense")
        if mask is not None:
            raise ValueError("impl='splash' takes no mask")
        if q.shape[1] != k.shape[1]:
            raise ValueError(f"impl='splash' needs self-attention; got "
                             f"Lq={q.shape[1]}, Lk={k.shape[1]}")
        if k.shape[2] != q.shape[2]:
            # grouped-query attention: the kernels take MHA shapes, so the
            # K/V groups are expanded here, as the JAX dispatch does
            groups = q.shape[2] // k.shape[2]
            k = k.repeat_interleave(groups, dim=2)
            v = v.repeat_interleave(groups, dim=2)
        scale = sm_scale if sm_scale is not None else q.shape[3] ** -0.5
        return SplashAttention.apply(q, k, v, float(scale))
    if impl == "flash":
        raise NotImplementedError(FLASH_TODO)
    if impl == "ring":
        raise NotImplementedError("ring attention is not ported yet "
                                  "(ROADMAP.md, Queue 1, item 7)")
    raise ValueError(f"unknown attention impl {impl!r}")
