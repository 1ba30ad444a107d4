"""The flagship decoder-only transformer LM, in PyTorch.

The port of the JAX package's ``models/transformer.py``: RoPE positions
(interleaved pairs), RMSNorm, SwiGLU MLP, grouped-query attention,
optional tied embeddings, bf16 compute over f32 parameters.  In training
mode attention goes through
:func:`edl_tpu_torch.ops.attention.dot_product_attention`, so on the card
every layer's causal attention runs the CUDA kernels.  In decode mode
(``cfg.decode``) every attention call, prefill included, reads and writes
an explicit :class:`KVCache` and is computed densely, as the JAX package's
``Block._decode_attention`` computes it (:func:`decode_model` builds such a
model from a trained one).

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

import functools
import math
from dataclasses import dataclass, replace
from typing import Any

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

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
    remat: bool = True                # recompute each layer in the backward, but its projections
    scan_layers: bool = True          # no effect: layers are a Python loop
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    moe_experts: int = 0              # > 0 is not ported (NotImplementedError)
    moe_top_k: int = 2
    moe_capacity: float = 1.25
    # KV-cache decoding: attention reads and writes the KVCache passed to
    # forward (models/generate.py and serving/engine.py drive this)
    decode: bool = False
    # multi-token decode calls write K/V at per-example cache indices,
    # dropping rows past the cache's end, instead of one contiguous slab
    # at a batch-uniform index
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


@dataclass
class KVCache:
    """The decode-mode cache of every layer: keys ``[B, Hk, D, length]``
    and values ``[B, Hk, length, D]`` in the compute dtype (the JAX
    package's layouts: each attention product reads its operand with no
    transpose), and one per-example write index ``[B]`` int32 that every
    layer shares (the JAX package keeps one per layer, always equal).
    ``forward`` writes the new keys and values in place and advances
    ``index`` by the number of tokens it was given."""

    keys: list[torch.Tensor]
    values: list[torch.Tensor]
    index: torch.Tensor

    @classmethod
    def zeros(cls, cfg: TransformerConfig, batch: int, length: int,
              device: torch.device | str | None = None) -> "KVCache":
        Hk, Dh = cfg.kv_heads, cfg.head_dim
        return cls(
            [torch.zeros(batch, Hk, Dh, length, dtype=cfg.dtype, device=device)
             for _ in range(cfg.num_layers)],
            [torch.zeros(batch, Hk, length, Dh, dtype=cfg.dtype, device=device)
             for _ in range(cfg.num_layers)],
            torch.zeros(batch, dtype=torch.int32, device=device))

    @property
    def length(self) -> int:
        return self.keys[0].shape[-1]

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.keys + self.values)


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


def _save_projections(ctx, func, *args, **kwargs):
    """The remat policy: keep the outputs of the products with no batch
    dims (``aten.mm``/``addmm``: the ``Dense`` layers), recompute the rest
    (norms, RoPE, activations, attention and its kernels), as the JAX
    package's ``dots_with_no_batch_dims_saveable``."""
    if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


_REMAT_CONTEXTS = functools.partial(create_selective_checkpoint_contexts, _save_projections)


def rope_tables(positions, D: int, theta: float):
    """RoPE's ``(cos, sin)`` ``[B, L, 1, D/2]`` at ``positions [B, L]``
    (angles in f32); a decode forward computes them once for every layer."""
    freqs = theta ** (-torch.arange(0, D, 2, dtype=torch.float32, device=positions.device) / D)
    angles = positions[..., None].float() * freqs              # [B, L, D/2]
    return torch.cos(angles)[:, :, None], torch.sin(angles)[:, :, None]


def rope(x, positions, theta: float, tables=None):
    """Rotary position embedding over the last dim of [B, L, H, D],
    rotating interleaved pairs (x[..., 0::2], x[..., 1::2]); angles in f32.
    ``tables``: :func:`rope_tables` of ``positions``, when already made."""
    cos, sin = tables if tables is not None else rope_tables(positions, x.shape[-1], theta)
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


def _write_cache(cfg: TransformerConfig, ck, cv, k, v, idx) -> None:
    """Write the new keys and values ``[B, L, Hk, D]`` into one layer's
    cache at the per-example index ``idx [B]``, in place.  L == 1 writes
    each example at its own index, and a lane at or past the cache's end
    writes nothing (the JAX scatter drops out-of-range updates); with
    ``cfg.decode_scatter`` each example's L rows land at its own index,
    rows past the end dropped; otherwise one contiguous slab lands at the
    batch-uniform ``idx[0]``, its start clamped so that the slab fits (as
    ``lax.dynamic_update_slice`` clamps)."""
    B, L = k.shape[:2]
    M = ck.shape[-1]
    k, v = k.to(ck.dtype), v.to(cv.dtype)
    if L == 1:
        # the advanced indices (dims 0 and 3, or 0 and 2) are not adjacent,
        # so the indexed shape is [B, Hk, D]: k[:, 0]'s own
        b = torch.arange(B, device=idx.device)
        inside = (idx < M)[:, None, None]
        at = idx.clamp(0, M - 1)
        ck[b, :, :, at] = torch.where(inside, k[:, 0], ck[b, :, :, at])
        cv[b, :, at, :] = torch.where(inside, v[:, 0], cv[b, :, at, :])
    elif cfg.decode_scatter:
        # the row filter reads the device (a host sync on the card); its
        # caller, speculative decoding, is not ported yet
        pos = idx[:, None] + torch.arange(L, device=idx.device)       # [B, L]
        b, j = (pos < M).nonzero(as_tuple=True)
        ck[b, :, :, pos[b, j]] = k[b, j]
        cv[b, :, pos[b, j], :] = v[b, j]
    else:
        cols = idx[0].clamp(0, M - L) + torch.arange(L, device=idx.device)
        ck.index_copy_(3, cols, k.permute(0, 2, 3, 1))
        cv.index_copy_(2, cols, v.permute(0, 2, 1, 3))


def future_mask(idx, L: int, M: int):
    """``[B, 1, 1, L, M]``: True where cache position m lies past the
    position ``idx[b] + l`` of query l (what decode attention hides)."""
    q_pos = idx[:, None] + torch.arange(L, device=idx.device)      # [B, L]
    return (torch.arange(M, device=idx.device) > q_pos[:, :, None])[:, None, None]


def decode_attention(q, ck, cv, idx, hidden=None):
    """Attention of the queries ``q [B, L, H, D]``, at positions ``idx[b]
    + l``, against one layer's whole cache (the new keys already written):
    the JAX package's ``Block._decode_attention`` after its write.  Its
    precision recipe: products in the input dtype, then ``.float() *
    scale``, ``-inf`` where the key's position exceeds the query's, an f32
    softmax cast back to the input dtype, and the second product.  Query
    head h attends kv head ``h // (H // Hk)``.  ``hidden``: the
    :func:`future_mask`, when already made."""
    B, L, H, Dh = q.shape
    Hk, M = ck.shape[1], ck.shape[-1]
    G = H // Hk
    if hidden is None:
        hidden = future_mask(idx, L, M)
    qg = q.reshape(B, L, Hk, G, Dh).permute(0, 2, 3, 1, 4).reshape(B, Hk, G * L, Dh)
    logits = torch.matmul(qg, ck).float() * Dh ** -0.5            # [B, Hk, G L, M]
    logits = logits.view(B, Hk, G, L, M).masked_fill(hidden, -math.inf)
    weights = torch.softmax(logits, dim=-1).to(q.dtype).view(B, Hk, G * L, M)
    out = torch.matmul(weights, cv)                                # [B, Hk, G L, D]
    return out.view(B, Hk, G, L, Dh).permute(0, 3, 1, 2, 4).reshape(B, L, H, Dh)


class Block(nn.Module):
    """One decoder layer."""

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

    def forward(self, x, positions, kv=None):
        """``kv``: in decode mode, this layer's ``(keys, values)`` cache
        buffers, the shared write index, and the RoPE tables and future
        mask that every layer of the forward shares."""
        cfg = self.cfg
        H, Hk, Dh = cfg.num_heads, cfg.kv_heads, cfg.head_dim
        B, L = x.shape[:2]
        tables = kv[3] if kv is not None else None
        y = self.attn_norm(x)
        q, k, v = self.attn_qkv(y).split([H * Dh, Hk * Dh, Hk * Dh], dim=-1)
        q = rope(q.reshape(B, L, H, Dh), positions, cfg.rope_theta, tables)
        k = rope(k.reshape(B, L, Hk, Dh), positions, cfg.rope_theta, tables)
        v = v.reshape(B, L, Hk, Dh)
        if kv is not None:
            ck, cv, idx, _, hidden = kv
            _write_cache(cfg, ck, cv, k, v, idx)
            attn = decode_attention(q, ck, cv, idx, hidden)
        else:
            attn = dot_product_attention(q, k, v, causal=True, impl=cfg.attention_impl)
        x = x + self.attn_out(attn.reshape(B, L, H * Dh))
        y = self.mlp_norm(x)
        y = F.silu(self.mlp_gate(y)) * self.mlp_in(y)
        return x + self.mlp_out(y)


class TransformerLM(nn.Module):
    """Decoder-only LM.  Parameters are f32 and initialised on the CPU from
    ``generator`` (default: seed 0) with flax's default families
    (lecun-normal kernels, fan-in normal embedding, unit norm scales);
    move the module with ``.to(device)``.  ``init=False`` leaves them
    uninitialised (for a module whose weights are loaded next)."""

    def __init__(self, cfg: TransformerConfig, generator: torch.Generator | None = None,
                 init: bool = True):
        super().__init__()
        if cfg.moe_experts:
            raise NotImplementedError("the mixture-of-experts MLP is not ported "
                                      "yet (ROADMAP.md, Queue 1, item 7)")
        self.cfg = cfg
        D, V = cfg.embed_dim, cfg.vocab_size
        self.tok_embed = nn.Embedding(V, D, _weight=torch.empty(V, D))
        self.layers = nn.ModuleList(Block(cfg) for _ in range(cfg.num_layers))
        self.final_norm = RMSNorm(D, cfg.dtype)
        self.lm_head = None if cfg.tie_embeddings else Dense(D, V, cfg.dtype)
        if init:
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
                with_aux: bool = False, cache: KVCache | None = None, token_mask=None):
        """Logits [B, L, V] f32, or with ``return_hidden`` the final-norm
        hidden states [B, L, D] for :func:`lm_loss_fused` (or for
        :meth:`head` on the rows a sampler reads).  ``with_aux`` also
        returns the auxiliary loss (0: no MoE).  In decode mode ``cache``
        is required: the ids' keys and values are written at
        ``cache.index``, which then advances by L.  ``token_mask`` marks
        the real tokens of a padded batch; it steers only MoE routing, so
        it has no effect here."""
        cfg = self.cfg
        del token_mask
        if cfg.decode != (cache is not None):
            raise ValueError("a KVCache is passed exactly in decode mode "
                             f"(cfg.decode={cfg.decode})")
        ids = ids.long()
        if positions is None:
            positions = torch.arange(ids.shape[1], device=ids.device).expand(ids.shape)
        x = F.embedding(ids, self.tok_embed.weight).to(cfg.dtype)
        if cache is not None:
            shared = (rope_tables(positions, cfg.head_dim, cfg.rope_theta),
                      future_mask(cache.index, ids.shape[1], cache.length))
        for i, layer in enumerate(self.layers):
            if cache is not None:
                x = layer(x, positions, (cache.keys[i], cache.values[i], cache.index, *shared))
            elif cfg.remat and torch.is_grad_enabled():
                x = checkpoint(layer, x, positions, use_reentrant=False,
                               context_fn=_REMAT_CONTEXTS)
            else:
                x = layer(x, positions)
        if cache is not None:
            cache.index += ids.shape[1]
        x = self.final_norm(x)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if return_hidden:
            return (x, aux) if with_aux else x
        logits = self.head(x)
        return (logits, aux) if with_aux else logits

    def head(self, x):
        """f32 logits of final-norm hidden states ``[..., D]``."""
        cfg = self.cfg
        if cfg.tie_embeddings:
            w = self.tok_embed.weight.to(cfg.dtype)
            w = w.to(torch.promote_types(x.dtype, w.dtype))
            return (x @ w.t()).float()
        return self.lm_head(x).float()

    def head_weight(self) -> torch.Tensor:
        """The output projection as ``[D, V]`` (the flax kernel layout)."""
        w = self.tok_embed.weight if self.cfg.tie_embeddings else self.lm_head.weight
        return w.t()


@torch.no_grad()
def decode_model(model: TransformerLM) -> TransformerLM:
    """``model`` in decode mode with dense attention, for inference: its
    weight matrices and embedding cast once to the compute dtype (each
    use casts them to that dtype anyway, so the numbers are the same,
    and a decode step no longer converts every weight), the norm scales
    shared with ``model``.  A model already in decode mode is returned as
    it is."""
    if model.cfg.decode:
        return model
    cfg = replace(model.cfg, decode=True, attention_impl="dense", mesh=None, remat=False)
    with torch.device("meta"):
        out = TransformerLM(cfg, init=False)
    sd = {name: t.detach().to(cfg.dtype) if name.endswith(".weight") else t.detach()
          for name, t in model.state_dict().items()}
    out.load_state_dict(sd, assign=True)
    return out.requires_grad_(False).eval()


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
