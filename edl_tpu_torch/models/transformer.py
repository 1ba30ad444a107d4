"""The flagship decoder-only transformer LM, in PyTorch.

The port of the JAX package's ``models/transformer.py`` in training mode:
RoPE positions (interleaved pairs), RMSNorm, SwiGLU MLP, grouped-query
attention, optional tied embeddings, bf16 compute over f32 parameters.
Attention goes through :func:`edl_tpu_torch.ops.attention.dot_product_attention`,
so on the card every layer's causal attention runs the CUDA kernels.

The dtype flow follows the reference exactly, including its quirk: RMSNorm
normalises in f32, casts to the compute dtype, then multiplies by the f32
scale, so its output is f32; each dense layer casts its input and its f32
weight to the compute dtype.  ``return_hidden`` therefore yields f32 hidden
states, and the fused loss runs its vocabulary products in f32.

The parameters are named after the flax tree (``tok_embed``, ``layers.i.
attn_qkv``, ...); :mod:`edl_tpu_torch.models.convert` maps one onto the
other.  Layers are a Python loop: there is no scan, and ``scan_layers`` is
kept only so that configs read the same in both packages.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Any

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from edl_tpu_torch.ops.attention import dot_product_attention


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32_000
    num_layers: int = 12
    embed_dim: int = 768
    num_heads: int = 6
    mlp_dim: int = 3072
    max_len: int = 2048
    # grouped-query attention: number of K/V heads (0 = num_heads, MHA)
    num_kv_heads: int = 0
    dtype: Any = torch.bfloat16
    attention_impl: str = "auto"      # auto | dense | splash | flash (ring: not ported)
    mesh: Any = None                  # for attention_impl="ring" (not ported)
    remat: bool = True                # recompute each layer in the backward
    scan_layers: bool = True          # no effect: layers are a Python loop
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    moe_experts: int = 0              # > 0 is not ported (NotImplementedError)
    moe_top_k: int = 2
    moe_capacity: float = 1.25
    decode: bool = False              # KV-cache decoding: not ported
    decode_scatter: bool = False

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads


def param_count(cfg: TransformerConfig) -> int:
    """Parameter count of the config (embedding table included)."""
    L, D, M, V = cfg.num_layers, cfg.embed_dim, cfg.mlp_dim, cfg.vocab_size
    H, Hk, Dh = cfg.num_heads, cfg.kv_heads, cfg.head_dim
    attn = D * (H + 2 * Hk) * Dh + H * Dh * D
    if cfg.moe_experts:
        mlp = cfg.moe_experts * 2 * D * M + D * cfg.moe_experts
    else:
        mlp = 3 * D * M
    head = 0 if cfg.tie_embeddings else D * V
    return V * D + L * (attn + mlp + 2 * D) + head + D


# bf16-equivalent activation values kept per token x layer x embed for the
# backward: the JAX package's estimate, not yet calibrated on an NVIDIA card
_ACT_VALS_PER_TOK_LAYER_EMBED = 48


def auto_layout(cfg: TransformerConfig, per_device_batch: int,
                seq: int | None = None, hbm_bytes: float | None = None,
                device: torch.device | str | None = None) -> TransformerConfig:
    """Resolve ``remat`` from an estimate of the train footprint: on
    whenever f32 params + Adam moments + grads + activations + the head's
    f32 logits exceed 90% of the device memory (``hbm_bytes``, default the
    card's total memory, 16e9 for a CPU).  ``scan_layers`` follows the
    JAX rule (``num_layers > 16``) and has no effect here."""
    if hbm_bytes is None:
        dev = torch.device(device) if device is not None else None
        if dev is not None and dev.type == "cuda":
            hbm_bytes = float(torch.cuda.get_device_properties(dev).total_memory)
        else:
            hbm_bytes = 16e9
    seq = seq or cfg.max_len
    state_bytes = 16 * param_count(cfg)     # f32 params + adam m/v + grads
    act_bytes = (2 * per_device_batch * seq * cfg.num_layers * cfg.embed_dim
                 * _ACT_VALS_PER_TOK_LAYER_EMBED)
    # the head's [B, S, V] f32 logits and their gradient: the fused loss
    # never builds them, but the layout cannot know which loss is used
    logits_bytes = 2 * 4 * per_device_batch * seq * cfg.vocab_size
    remat = state_bytes + act_bytes + logits_bytes > 0.9 * hbm_bytes
    return replace(cfg, remat=remat, scan_layers=cfg.num_layers > 16)


def rope(x, positions, theta: float):
    """Rotary position embedding over the last dim of [B, L, H, D],
    rotating interleaved pairs (x[..., 0::2], x[..., 1::2]); angles in f32."""
    D = x.shape[-1]
    freqs = theta ** (-torch.arange(0, D, 2, dtype=torch.float32, device=x.device) / D)
    angles = positions[..., None].float() * freqs              # [B, L, D/2]
    cos, sin = torch.cos(angles)[:, :, None], torch.sin(angles)[:, :, None]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


def _lecun_normal_(w: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    """flax's default kernel init: a normal truncated at two standard
    deviations, scaled so the variance is 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=gen)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        var = x.float().square().mean(-1, keepdim=True)
        return (x * torch.rsqrt(var + 1e-6)).to(self.dtype) * self.scale


class Dense(nn.Module):
    """A bias-free linear layer with an f32 weight ``[out, in]`` whose
    input and weight are both cast to the compute dtype."""

    def __init__(self, in_dim: int, out_dim: int, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim))

    def forward(self, x):
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype))


class Block(nn.Module):
    """One decoder layer (training mode)."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        H, Hk, Dh, D = cfg.num_heads, cfg.kv_heads, cfg.head_dim, cfg.embed_dim
        if H % Hk:
            raise ValueError(f"num_heads {H} not divisible by kv heads {Hk}")
        self.attn_norm = RMSNorm(D, cfg.dtype)
        self.attn_qkv = Dense(D, (H + 2 * Hk) * Dh, cfg.dtype)
        self.attn_out = Dense(H * Dh, D, cfg.dtype)
        self.mlp_norm = RMSNorm(D, cfg.dtype)
        self.mlp_gate = Dense(D, cfg.mlp_dim, cfg.dtype)
        self.mlp_in = Dense(D, cfg.mlp_dim, cfg.dtype)
        self.mlp_out = Dense(cfg.mlp_dim, D, cfg.dtype)

    def forward(self, x, positions):
        cfg = self.cfg
        H, Hk, Dh = cfg.num_heads, cfg.kv_heads, cfg.head_dim
        B, L = x.shape[:2]
        y = self.attn_norm(x)
        q, k, v = self.attn_qkv(y).split([H * Dh, Hk * Dh, Hk * Dh], dim=-1)
        q = rope(q.reshape(B, L, H, Dh), positions, cfg.rope_theta)
        k = rope(k.reshape(B, L, Hk, Dh), positions, cfg.rope_theta)
        v = v.reshape(B, L, Hk, Dh)
        attn = dot_product_attention(q, k, v, causal=True, impl=cfg.attention_impl)
        x = x + self.attn_out(attn.reshape(B, L, H * Dh))
        y = self.mlp_norm(x)
        y = F.silu(self.mlp_gate(y)) * self.mlp_in(y)
        return x + self.mlp_out(y)


class TransformerLM(nn.Module):
    """Decoder-only LM.  Parameters are f32 and initialised on the CPU from
    ``generator`` (default: seed 0) with flax's default families
    (lecun-normal kernels, fan-in normal embedding, unit norm scales);
    move the module with ``.to(device)``."""

    def __init__(self, cfg: TransformerConfig, generator: torch.Generator | None = None):
        super().__init__()
        if cfg.decode:
            raise NotImplementedError("KV-cache decoding is not ported yet "
                                      "(ROADMAP.md, Queue 1, item 6)")
        if cfg.moe_experts:
            raise NotImplementedError("the mixture-of-experts MLP is not ported "
                                      "yet (ROADMAP.md, Queue 1, item 7)")
        self.cfg = cfg
        D, V = cfg.embed_dim, cfg.vocab_size
        self.tok_embed = nn.Embedding(V, D, _weight=torch.empty(V, D))
        self.layers = nn.ModuleList(Block(cfg) for _ in range(cfg.num_layers))
        self.final_norm = RMSNorm(D, cfg.dtype)
        self.lm_head = None if cfg.tie_embeddings else Dense(D, V, cfg.dtype)
        self.reset_parameters(generator or torch.Generator().manual_seed(0))

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        self.tok_embed.weight.normal_(0.0, self.cfg.embed_dim ** -0.5, generator=gen)
        for mod in self.modules():
            if isinstance(mod, Dense):
                _lecun_normal_(mod.weight, mod.weight.shape[1], gen)
            elif isinstance(mod, RMSNorm):
                mod.scale.fill_(1.0)

    def forward(self, ids, positions=None, return_hidden: bool = False,
                with_aux: bool = False):
        """Logits [B, L, V] f32, or with ``return_hidden`` the final-norm
        hidden states [B, L, D] for :func:`lm_loss_fused`.  ``with_aux``
        also returns the auxiliary loss (0: no MoE)."""
        cfg = self.cfg
        ids = ids.long()
        if positions is None:
            positions = torch.arange(ids.shape[1], device=ids.device).expand(ids.shape)
        x = F.embedding(ids, self.tok_embed.weight).to(cfg.dtype)
        for layer in self.layers:
            if cfg.remat and torch.is_grad_enabled():
                x = checkpoint(layer, x, positions, use_reentrant=False)
            else:
                x = layer(x, positions)
        x = self.final_norm(x)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if return_hidden:
            return (x, aux) if with_aux else x
        if cfg.tie_embeddings:
            w = self.tok_embed.weight.to(cfg.dtype)
            w = w.to(torch.promote_types(x.dtype, w.dtype))
            logits = x @ w.t()
        else:
            logits = self.lm_head(x)
        logits = logits.float()
        return (logits, aux) if with_aux else logits

    def head_weight(self) -> torch.Tensor:
        """The output projection as ``[D, V]`` (the flax kernel layout)."""
        w = self.tok_embed.weight if self.cfg.tie_embeddings else self.lm_head.weight
        return w.t()


def _masked_mean(nll, mask):
    if mask is not None:
        mask = mask.to(nll.dtype)
        return (nll * mask).sum() / mask.sum().clamp_min(1)
    return nll.mean()


def lm_loss(logits, targets, mask=None):
    """Next-token cross entropy; ``targets`` already shifted."""
    logp = F.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, targets.long()[..., None])[..., 0]
    return _masked_mean(nll, mask)


def lm_loss_fused(model: TransformerLM, hidden, targets, mask=None,
                  block_size: int = 4096):
    """Next-token CE from ``model(..., return_hidden=True)`` hidden states
    through the blockwise fused CE (``ops/ce.py``): the [B, L, V] logits
    are never built.  The head weight is cast to the hidden states' dtype
    (f32 under the reference's dtype flow)."""
    from edl_tpu_torch.ops.ce import blockwise_cross_entropy

    w = model.head_weight()
    nll = blockwise_cross_entropy(hidden, w.to(hidden.dtype), targets,
                                  block_size=block_size)
    return _masked_mean(nll, mask)
