"""Attention implementations on ``[B, L, H, D]`` tensors.

``dot_product_attention(q, k, v)`` dispatches:

- ``dense``: plain PyTorch attention with an f32 softmax; grouped-query
  attention is native (q head h uses kv head h // (H // Hk)); a causal
  mask is aligned bottom-right, as the JAX package's ``dense_attention``;
- ``splash``: causal self-attention through the hand-written CUDA kernels
  behind ``edl_tpu_torch/csrc/attention.cu``'s entry points (forward, and a
  backward of two kernels: dQ, which also computes ``delta = rowsum(dO *
  O)``, then dK/dV), the counterpart of the JAX package's splash path: q
  is scaled in its own dtype before the kernels, as the JAX package's
  ``_splash`` scales it (:func:`splash_fwd`);
- ``flash``: attention with ``Lq`` and ``Lk`` free, causal or not, through
  the same kernels' ``edl_flash_*`` entry points, the counterpart of the
  JAX package's Pallas flash kernel; its causal mask is aligned top-left
  (key j is visible to query i iff j <= i), as that kernel's is;
- ``splash`` and ``flash`` on CUDA tensors the kernels do not take (not
  bf16) compute the same function through ``dense_attention`` with the
  top-left mask given explicitly (:func:`dense_topleft_attention`);
- ``ring``: the sequence split over an ``sp`` group, its k/v blocks
  rotated around the ring (``ops/ring.py``, plain torch per hop, as the
  JAX ring is jnp); with ``sp`` and another impl the whole sequence is
  gathered over the group first;
- ``auto``: the choice the JAX package makes on its accelerator
  (:func:`choose_impl`), for CUDA tensors; CPU tensors take dense.

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



def kernel_takes_head_dim(d: int) -> bool:
    """Head dims the kernels take: every multiple of 64, as the JAX gates
    (see :func:`device_kernels` for which kernel runs which)."""
    return d >= 64 and d % 64 == 0


def device_kernels(d: int) -> tuple[str, ...]:
    """The device kernels one layer's attention launches at head dim ``d``
    (forward, dQ, dK/dV), by name, as the C entry points route them
    (``csrc/attention.cu``: ``fwd``, ``dq``, ``dkdv``): up to 256 the
    Hopper kernels of ``attention_sm90.cu`` (dK/dV above 128 the one whose
    consumers split dK and dV); above it the forward of
    ``attention_wide_sm90.cu`` whose consumers split the output columns (up
    to 512; above, the same on chunks of the columns), dQ with delta folded
    in on a thread block cluster that splits D
    (``attention_bwd_cluster_sm90.cu``), and dK/dV split across blocks by
    output columns (``attention_sm90.cu``, up to 384) or on a cluster
    (above).  Past the largest cluster (D > 2048) dQ and dK/dV are the
    ``mma.sync`` kernels of ``attention_wide.cu``."""
    if d <= 256:
        return ("attn_fwd_sm90_kernel", "attn_dq_sm90_kernel",
                "attn_dkdv_sm90_kernel" if d <= 128 else "attn_dkdv_split_sm90_kernel")
    if d <= 512:
        return ("attn_fwd_split_sm90_kernel", "attn_dq_cluster_sm90_kernel",
                "attn_dkdv_chunk_sm90_kernel" if d <= 384 else "attn_dkdv_cluster_sm90_kernel")
    if d <= 2048:
        return ("attn_fwd_chunk_sm90_kernel", "attn_dq_cluster_sm90_kernel",
                "attn_dkdv_cluster_sm90_kernel")
    return ("attn_fwd_chunk_sm90_kernel", "attn_bwd_dq_wide_kernel", "attn_bwd_dkdv_wide_kernel")


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


def _topleft(lq: int, lk: int, device) -> torch.Tensor:
    """The [Lq, Lk] top-left causal visibility: key j is seen by query i
    iff j <= i."""
    return torch.ones(lq, lk, dtype=torch.bool, device=device).tril()


def dense_topleft_attention(q, k, v, *, causal: bool, sm_scale: float | None = None):
    """The kernels' function through :func:`dense_attention`, causal masked
    top-left as the Pallas flash kernel masks it (for ``Lq == Lk`` the same
    as dense's bottom-right), or not masked: what ``impl="flash"`` and
    ``"splash"`` compute for CUDA tensors the kernels do not take."""
    keep = _topleft(q.shape[1], k.shape[1], q.device) if causal else None
    return dense_attention(q, k, v, sm_scale=sm_scale, mask=keep)


def _scores(q, k, scale, causal):
    """f32 scaled scores [B, H, Lq, Lk]; causal masks top-left (j > i)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if not causal:
        return s
    return s.masked_fill(~_topleft(q.shape[1], k.shape[1], q.device), float("-inf"))


def flash_fwd_plain(q, k, v, scale: float, causal: bool):
    """Attention in f32, top-left causal or not: ``(o [B, Lq, H, D] in q's
    dtype, lse [B, H, Lq] f32)``, the logsumexp of the scaled scores."""
    s = _scores(q, k, scale, causal)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return o.to(q.dtype), lse


def attention_bwd_delta_plain(o, do):
    """``delta[b, h, l] = sum_d dO * O`` in f32, [B, H, L]."""
    return (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()


def _probs_and_dscores(q, k, v, do, lse, delta, scale, causal):
    p = torch.exp(_scores(q, k, scale, causal) - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return p, p * (dp - delta[..., None])


def flash_bwd_dkdv_plain(q, k, v, do, lse, delta, scale: float, causal: bool):
    """``(dk, dv)`` from the saved logsumexp; keys no query sees get 0."""
    p, ds = _probs_and_dscores(q, k, v, do, lse, delta, scale, causal)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_dq_plain(q, k, v, o, do, lse, scale: float, causal: bool):
    """``(dq, delta)`` from the saved logsumexp: ``delta`` is
    :func:`attention_bwd_delta_plain` of ``o`` and ``do``, which dq uses
    and dK/dV then takes."""
    delta = attention_bwd_delta_plain(o, do)
    _, ds = _probs_and_dscores(q, k, v, do, lse, delta, scale, causal)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale
    return dq.to(q.dtype), delta


# causal self-attention: the flash functions at Lq == Lk, where top-left
# and bottom-right alignment agree
def attention_fwd_plain(q, k, v, scale: float):
    """Causal self-attention in f32: ``(o, lse)`` as :func:`flash_fwd_plain`."""
    return flash_fwd_plain(q, k, v, scale, True)


def attention_bwd_dkdv_plain(q, k, v, do, lse, delta, scale: float):
    """``(dk, dv)`` of causal self-attention from the saved logsumexp."""
    return flash_bwd_dkdv_plain(q, k, v, do, lse, delta, scale, True)


def attention_bwd_dq_plain(q, k, v, o, do, lse, scale: float):
    """``(dq, delta)`` of causal self-attention, as :func:`flash_bwd_dq_plain`."""
    return flash_bwd_dq_plain(q, k, v, o, do, lse, scale, True)


# -- the kernels -----------------------------------------------------------------

_P = ctypes.c_void_p
_lib = None


def _kernels():
    """The kernels' library, its entry points declared as the ``extern
    "C"`` block of ``csrc/attention.cu`` declares them."""
    global _lib
    if _lib is None:
        from edl_tpu_torch.ops import _build
        _lib = _build.bind(_build.load("attn"), (_build.CSRC / "attention.cu").read_text())
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
    dim is not contiguous or its rows are not 16-byte aligned (the TMA
    tensor maps and cp.async both need that, and take any stride order)."""
    if t.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the attention kernels take bfloat16, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
    if (t.stride(3) != 1 or t.data_ptr() % 16
            or any(s % 8 for s in t.stride()[:3])):
        # a fresh, packed copy (contiguous() would keep a misaligned base)
        t = t.clone(memory_format=torch.contiguous_format)
    return t


def _strides(*ts) -> ctypes.Array:
    vals = [s for t in ts for s in (t.stride(0), t.stride(1), t.stride(2))]
    return (ctypes.c_longlong * len(vals))(*vals)


def _check_head_dim(D: int) -> None:
    if not kernel_takes_head_dim(D):
        raise ValueError(f"attention kernels take head dims that are multiples of 64, "
                         f"got {D}")


def _operands(q, k, v, do=None):
    """Check the operands of one launch: q (and do) of ``[B, Lq, H, D]``, k
    and v of ``[B, Lk, H, D]``.  Returns ``(B, H, Lq, Lk, D)`` and the
    operands, each copied only if the kernels cannot read it as is."""
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    _check_head_dim(D)
    if min(Lq, Lk) < 1:
        raise ValueError(f"attention kernels need Lq, Lk >= 1; "
                         f"got q {tuple(q.shape)}, k {tuple(k.shape)}")
    kv = (B, Lk, H, D)
    ts = [_operand(q, "q", q.shape), _operand(k, "k", kv), _operand(v, "v", kv)]
    if do is not None:
        ts.append(_operand(do, "do", q.shape))
    return (B, H, Lq, Lk, D), ts


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} failed with CUDA error {err}")


def _stream(t) -> _P:
    return _P(torch.cuda.current_stream(t.device).cuda_stream)


def _stat(t, name, B, H, L):
    """Check an f32 [B, H, L] statistic (lse, delta); contiguous."""
    if t.dtype != torch.float32 or tuple(t.shape) != (B, H, L):
        raise ValueError(f"{name}: want f32 [{B}, {H}, {L}], got "
                         f"{t.dtype} {tuple(t.shape)}")
    return t.contiguous()


def _sizes(dims, causal):
    """The size arguments of an entry point: ``B H L D`` for the causal
    self-attention ``edl_attn_*`` ones (``causal is None``), ``B H Lq Lk D
    causal`` for the ``edl_flash_*`` ones."""
    B, H, Lq, Lk, D = dims
    if causal is None:
        if Lq != Lk:
            raise ValueError(f"the splash kernels need Lq == Lk; got {Lq}, {Lk}")
        return (B, H, Lq, D)
    return (B, H, Lq, Lk, D, int(bool(causal)))


def _run_fwd(entry, q, k, v, scale, causal, lib=None):
    """``(o, lse)`` from one launch of a forward entry point (of ``lib``,
    or of the package's library)."""
    dims, (q, k, v) = _operands(q, k, v)
    B, H, Lq, _, D = dims
    o = torch.empty(B, Lq, H, D, dtype=q.dtype, device=q.device)
    lse = torch.empty(B, H, Lq, dtype=torch.float32, device=q.device)
    err = getattr(lib or _kernels(), entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        _strides(q, k, v, o), *_sizes(dims, causal), float(scale), _stream(q))
    _raise_on(err, entry)
    return o, lse


def _run_dkdv(entry, q, k, v, do, lse, delta, scale, causal, lib=None):
    """``(dk, dv)`` from one launch of a dK/dV entry point (of ``lib``, or
    of the package's library)."""
    dims, (q, k, v, do) = _operands(q, k, v, do)
    B, H, Lq, _, _ = dims
    lse, delta = _stat(lse, "lse", B, H, Lq), _stat(delta, "delta", B, H, Lq)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty_like(dk)
    err = getattr(lib or _kernels(), entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        _strides(q, k, v, do, dk, dv), *_sizes(dims, causal), float(scale), _stream(q))
    _raise_on(err, entry)
    return dk, dv


def _run_dq(entry, q, k, v, o, do, lse, scale, causal, lib=None):
    """``(dq, delta)`` from one launch of a dQ entry point (of ``lib``, or
    of the package's library)."""
    dims, (q, k, v, do) = _operands(q, k, v, do)
    B, H, Lq, _, _ = dims
    o = _operand(o, "o", q.shape)
    lse = _stat(lse, "lse", B, H, Lq)
    delta = torch.empty(B, H, Lq, dtype=torch.float32, device=q.device)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    err = getattr(lib or _kernels(), entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        _strides(q, k, v, o, do, dq), *_sizes(dims, causal), float(scale), _stream(q))
    _raise_on(err, entry)
    return dq, delta


def bwd_cluster_smem(bpr: int, dq: bool, lib=None) -> int:
    """Bytes of dynamic shared memory a launch of the cluster dQ (``dq``)
    or dK/dV kernel with ``bpr`` 64-column boxes a block takes, from
    ``lib``'s (or the package library's) ``edl_attn_bwd_smem``; 0 where no
    such instantiation exists."""
    return (lib or _kernels()).edl_attn_bwd_smem(bpr, int(dq))


def attention_fwd(q, k, v, scale: float):
    """Causal self-attention forward: ``(o, lse)`` as
    :func:`attention_fwd_plain`.  Launches ``edl_attn_fwd`` on CUDA."""
    if _on_cpu(q, k, v):
        return attention_fwd_plain(q, k, v, scale)
    out = _run_fwd("edl_attn_fwd", q, k, v, scale, None)
    attention_fwd.launches += 1
    return out


def attention_bwd_dkdv(q, k, v, do, lse, delta, scale: float):
    """``(dk, dv)`` as :func:`attention_bwd_dkdv_plain`.  Launches
    ``edl_attn_bwd_dkdv`` on CUDA."""
    if _on_cpu(q, k, v, do, lse, delta):
        return attention_bwd_dkdv_plain(q, k, v, do, lse, delta, scale)
    out = _run_dkdv("edl_attn_bwd_dkdv", q, k, v, do, lse, delta, scale, None)
    attention_bwd_dkdv.launches += 1
    return out


def attention_bwd_dq(q, k, v, o, do, lse, scale: float):
    """``(dq, delta)`` as :func:`attention_bwd_dq_plain`.  Launches
    ``edl_attn_bwd_dq`` on CUDA."""
    if _on_cpu(q, k, v, o, do, lse):
        return attention_bwd_dq_plain(q, k, v, o, do, lse, scale)
    out = _run_dq("edl_attn_bwd_dq", q, k, v, o, do, lse, scale, None)
    attention_bwd_dq.launches += 1
    return out


def flash_fwd(q, k, v, scale: float, causal: bool):
    """Forward, top-left causal or not, ``Lq != Lk`` allowed: ``(o, lse)``
    as :func:`flash_fwd_plain`.  Launches ``edl_flash_fwd`` on CUDA."""
    if _on_cpu(q, k, v):
        return flash_fwd_plain(q, k, v, scale, causal)
    out = _run_fwd("edl_flash_fwd", q, k, v, scale, causal)
    flash_fwd.launches += 1
    return out


def flash_bwd_dkdv(q, k, v, do, lse, delta, scale: float, causal: bool):
    """``(dk, dv)`` as :func:`flash_bwd_dkdv_plain`.  Launches
    ``edl_flash_bwd_dkdv`` on CUDA."""
    if _on_cpu(q, k, v, do, lse, delta):
        return flash_bwd_dkdv_plain(q, k, v, do, lse, delta, scale, causal)
    out = _run_dkdv("edl_flash_bwd_dkdv", q, k, v, do, lse, delta, scale, causal)
    flash_bwd_dkdv.launches += 1
    return out


def flash_bwd_dq(q, k, v, o, do, lse, scale: float, causal: bool):
    """``(dq, delta)`` as :func:`flash_bwd_dq_plain`.  Launches
    ``edl_flash_bwd_dq`` on CUDA."""
    if _on_cpu(q, k, v, o, do, lse):
        return flash_bwd_dq_plain(q, k, v, o, do, lse, scale, causal)
    out = _run_dq("edl_flash_bwd_dq", q, k, v, o, do, lse, scale, causal)
    flash_bwd_dq.launches += 1
    return out


KERNEL_WRAPPERS = (attention_fwd, attention_bwd_dkdv, attention_bwd_dq, flash_fwd,
                   flash_bwd_dkdv, flash_bwd_dq)
for _w in KERNEL_WRAPPERS:
    _w.launches = 0


def reset_launch_counts() -> None:
    for w in KERNEL_WRAPPERS:
        w.launches = 0


def launch_counts() -> dict[str, int]:
    return {w.__name__: w.launches for w in KERNEL_WRAPPERS}


def splash_fwd(q, k, v, scale: float):
    """The splash path's forward: ``(o, lse, q_s, s_b)``.  As the JAX
    package's ``_splash`` (``(qt * scale).astype(q.dtype)``), q is scaled in
    its own dtype first, by ``s_b``, the scale rounded to that dtype, and
    the kernels run on ``q_s`` with scale 1; ``lse`` is the logsumexp of
    ``q_s k^T``, as the splash kernel's residual."""
    # a JAX multiply by a Python float rounds it to the array's dtype (a
    # weakly typed scalar); q * s_b then rounds the product to that dtype
    s_b = float(torch.tensor(scale, dtype=q.dtype))
    q_s = q * s_b
    o, lse = attention_fwd(q_s, k, v, 1.0)
    return o, lse, q_s, s_b


class SplashAttention(torch.autograd.Function):
    """Causal self-attention whose forward and backward are the kernels
    (their plain versions for CPU tensors), on q pre-scaled in its dtype
    (:func:`splash_fwd`); dq is the pre-scaled q's gradient times ``s_b``
    in q's dtype, the VJP of the JAX package's multiply."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float):
        o, lse, q_s, ctx.s_b = splash_fwd(q, k, v, scale)
        ctx.save_for_backward(q_s, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q_s, k, v, o, lse = ctx.saved_tensors
        dq_s, delta = attention_bwd_dq(q_s, k, v, o, do, lse, 1.0)
        dk, dv = attention_bwd_dkdv(q_s, k, v, do, lse, delta, 1.0)
        return dq_s * ctx.s_b, dk, dv, None


class FlashAttention(torch.autograd.Function):
    """Attention with ``Lq``, ``Lk`` free, top-left causal or not, whose
    forward and backward are the ``edl_flash_*`` kernels (their plain
    versions for CPU tensors); K/V carry q's heads."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, causal: bool):
        o, lse = flash_fwd(q, k, v, scale, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale, ctx.causal = scale, causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, delta = flash_bwd_dq(q, k, v, o, do, lse, ctx.scale, ctx.causal)
        dk, dv = flash_bwd_dkdv(q, k, v, do, lse, delta, ctx.scale, ctx.causal)
        return dq, dk, dv, None, None


# -- dispatch ----------------------------------------------------------------------

def _jax_flash_ok(lq: int, lk: int, d: int) -> bool:
    """The JAX package's flash gate: the shapes it hands its flash kernel."""
    return lq % 128 == 0 and lk % 128 == 0 and d % 64 == 0


def _splash_takes(lq: int, lk: int, d: int, dtype: torch.dtype, causal: bool) -> bool:
    """Shapes and types the splash kernels take: causal self-attention, D
    a multiple of 64, bf16 (the JAX gate also wants L % 128 == 0; these
    kernels mask a ragged last tile)."""
    return causal and lq == lk and kernel_takes_head_dim(d) and dtype == torch.bfloat16


def _splash_ok(q, k, causal: bool) -> bool:
    return (q.dtype == k.dtype
            and _splash_takes(q.shape[1], k.shape[1], q.shape[3], q.dtype, causal))


def choose_impl(lq: int, lk: int, d: int, dtype: torch.dtype, causal: bool,
                has_mask: bool, device_type: str) -> str:
    """The implementation ``impl="auto"`` runs: ``"splash"``, ``"flash"``
    or ``"dense"``.

    For CUDA tensors it computes the function the JAX package computes on
    its accelerator, where the choice matters: for causal ``Lq != Lk`` its
    flash kernel masks top-left and its dense path bottom-right.  So:
    causal self-attention the splash kernels take runs splash; otherwise
    a mask-free call that passes the JAX flash gate runs flash, in bf16
    on the kernels; in another dtype dense where dense computes the same
    function (non-causal, or ``Lq == Lk``), and causal ``Lq != Lk`` flash,
    which on tensors the kernels do not take is dense with the top-left
    mask (:func:`dense_topleft_attention`); every other call runs dense.
    The kernels take every head dim the JAX gates take (``D % 64 == 0``).
    Other devices take dense, as the JAX package does off its
    accelerator."""
    if device_type != "cuda" or has_mask:
        return "dense"
    if _splash_takes(lq, lk, d, dtype, causal):
        return "splash"
    if _jax_flash_ok(lq, lk, d) and (dtype == torch.bfloat16 or (causal and lq != lk)):
        return "flash"
    return "dense"


_warned_shapes: set[tuple] = set()


def _warn_downgrade(q, k, why: str) -> None:
    key = (q.shape[1], k.shape[1], q.shape[3], str(q.dtype), why)
    if key in _warned_shapes:
        return
    _warned_shapes.add(key)
    logger.warning("attention: L=%d/%d D=%d %s: %s; using dense",
                   q.shape[1], k.shape[1], q.shape[3], q.dtype, why)


def dot_product_attention(q, k, v, *, causal: bool = False,
                          sm_scale: float | None = None, mask=None,
                          impl: str = "auto", sp=None, ring_kv_chunk: int = 1024):
    """``[B, L, H, D]`` attention with implementation dispatch (see the
    module docstring).  ``mask`` (dense only) broadcasts against
    ``[B, H, Lq, Lk]``.

    ``sp`` (a ``parallel/tp.py:SP`` group, or None): q, k and v are this
    rank's chunk of a sequence split over it.  ``impl="ring"`` runs
    ``ops/ring.py`` over it (the GQA groups expanded first, as the JAX
    dispatch does; ``ring_kv_chunk`` keys a fold); every other impl
    gathers the whole sequence's q, k and v over it, attends, and keeps
    this rank's query rows, so it computes what it computes unsplit."""
    if impl == "ring":
        if mask is not None:
            raise ValueError("impl='ring' takes no mask")
        if k.shape[2] != q.shape[2]:
            groups = q.shape[2] // k.shape[2]
            k = k.repeat_interleave(groups, dim=2)
            v = v.repeat_interleave(groups, dim=2)
        from edl_tpu_torch.ops.ring import ring_attention
        return ring_attention(q, k, v, sp, causal=causal, sm_scale=sm_scale,
                              kv_chunk=ring_kv_chunk)
    if sp is not None:
        if mask is not None:
            raise ValueError("a mask is not taken over a sequence split by sp")
        from edl_tpu_torch.parallel.tp import gather_seq
        L, H, Hk = q.shape[1], q.shape[2], k.shape[2]
        qf, kf, vf = gather_seq(torch.cat([q, k, v], dim=2), sp).split([H, Hk, Hk], dim=2)
        out = dot_product_attention(qf, kf, vf, causal=causal, sm_scale=sm_scale, impl=impl)
        return out[:, sp.rank * L:(sp.rank + 1) * L]
    if impl == "auto":
        impl = choose_impl(q.shape[1], k.shape[1], q.shape[3], q.dtype, causal,
                           mask is not None, q.device.type)
        if impl == "dense" and q.device.type == "cuda":
            _warn_downgrade(q, k, "a mask is not taken by the kernels" if mask is not None
                            else "shape or dtype not taken by the kernels")
    if impl == "dense":
        return dense_attention(q, k, v, causal=causal, sm_scale=sm_scale, mask=mask)
    if impl not in ("splash", "flash"):
        raise ValueError(f"unknown attention impl {impl!r}")
    if mask is not None:
        raise ValueError(f"impl={impl!r} takes no mask")
    if impl == "splash":
        if not causal:
            raise ValueError("impl='splash' is causal-only; use flash/dense")
        if q.shape[1] != k.shape[1]:
            raise ValueError(f"impl='splash' needs self-attention; got "
                             f"Lq={q.shape[1]}, Lk={k.shape[1]}")
    if q.device.type == "cuda" and any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        _warn_downgrade(q, k, "the kernels take bf16 (the top-left mask given explicitly)")
        return dense_topleft_attention(q, k, v, causal=causal, sm_scale=sm_scale)
    if k.shape[2] != q.shape[2]:
        # grouped-query attention: the kernels take MHA shapes, so the
        # K/V groups are expanded here, as the JAX dispatch does
        groups = q.shape[2] // k.shape[2]
        k = k.repeat_interleave(groups, dim=2)
        v = v.repeat_interleave(groups, dim=2)
    scale = float(sm_scale if sm_scale is not None else q.shape[3] ** -0.5)
    if impl == "splash":
        return SplashAttention.apply(q, k, v, scale)
    return FlashAttention.apply(q, k, v, scale, bool(causal))
