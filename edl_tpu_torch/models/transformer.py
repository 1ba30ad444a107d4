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

Tensor parallelism (:meth:`TransformerLM.set_tp`, after
``parallel/sharding.py:shard_init`` cut the weights): ``attn_qkv`` and
``mlp_gate``/``mlp_in`` are column-parallel, ``attn_out`` and ``mlp_out``
row-parallel, so a layer's forward all-reduces its two row-parallel outputs
and its backward the inputs of its two column-parallel groups.  The fused
q|k|v weight is split by heads (rank r holds query heads ``[r H/tp, (r+1)
H/tp)`` and the matching key and value heads), so the attention kernels
see plain local ``[B, L, H/tp, D]`` tensors.  The embedding is
vocab-parallel (each rank looks up its rows, the others' are masked, one
all-reduce), the head column-parallel on vocab, and the fused loss folds
each rank's vocab shard into one logsumexp (``ops/ce.py``).  A decode
model runs tensor-parallel too (the serving engine's tp group): its cache
holds this rank's kv heads, or all of them where they do not divide over
tp (MQA), and a vocabulary that does not divide stays whole on each rank.

Mixture of experts (``cfg.moe_experts > 0``): each block's MLP is
``ops/moe.py:MoEMLP`` (top-k routed experts, not SwiGLU), and a block
returns its aux loss and drop count beside its output; the model's aux is
their mean over layers and its drop count their sum (``drops=``).
:meth:`TransformerLM.set_ep` keeps this rank's ``E / ep`` experts, and
``set_tp`` cuts every expert's hidden columns.  Sequence parallelism
(:meth:`TransformerLM.set_sp`): each ``sp`` rank holds a contiguous chunk
of every sequence (``parallel/sharding.py:seq_chunk``); RoPE takes global
positions ``sp_rank * L + i``, and attention is the ring over the ``sp``
group (``attention_impl="ring"``) or, for the other impls, the full
sequence's q, k and v gathered over it (``ops/attention.py``).
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
from edl_tpu_torch.ops.moe import MoEMLP
from edl_tpu_torch.parallel.tp import TP, AxisGroup, copy_to, gather_from_tp, reduce_from

# parameter-name regex -> logical axes (``parallel/sharding.py:shard_init``
# consumes them), in each torch tensor's own dim order: the JAX package's
# rules with every kernel transposed and no stacked "layers" dim
LOGICAL_RULES = [
    (r"tok_embed\.weight", ("vocab", "embed")),
    (r"attn_qkv\.weight", ("heads", "embed")),
    (r"attn_out\.weight", ("embed", "heads")),
    (r"mlp_in\.weight", ("mlp", "embed")),
    (r"mlp_gate\.weight", ("mlp", "embed")),
    (r"mlp_out\.weight", ("embed", "mlp")),
    (r"moe\.gate", ("embed", None)),
    (r"moe\.w_in", ("expert", "embed", "expert_mlp")),
    (r"moe\.w_out", ("expert", "expert_mlp", "embed")),
    (r"norm\.scale", ("norm",)),
    (r"lm_head\.weight", ("vocab", "embed")),
]


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
    attention_impl: str = "auto"      # auto | dense | splash | flash | ring
    mesh: Any = None                  # unused: the sp group is set by set_sp
    remat: bool = True                # recompute each layer in the backward, but its projections
    scan_layers: bool = True          # no effect: layers are a Python loop
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    moe_experts: int = 0              # > 0: every block's MLP is ops/moe.py's MoEMLP
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
              device: torch.device | str | None = None, tp: TP | None = None) -> "KVCache":
        """An empty cache; under ``tp``, of this rank's kv heads
        (:func:`local_kv_heads`)."""
        Hk, Dh = local_kv_heads(cfg, tp), cfg.head_dim
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


def kv_split(cfg: TransformerConfig, tp: TP | None) -> bool:
    """Whether the kv heads are split over ``tp``: when they divide.  A
    decode model whose kv heads do not (MQA: one kv head) keeps k and v
    whole on every rank, and only q is split by heads, as the JAX engine
    replicates such a cache."""
    return tp is not None and cfg.kv_heads % tp.size == 0


def local_kv_heads(cfg: TransformerConfig, tp: TP | None) -> int:
    """The kv heads one rank holds under ``tp`` (all of them without)."""
    return cfg.kv_heads // tp.size if kv_split(cfg, tp) else cfg.kv_heads


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
        # rows past the end are dropped without a host read: each row is
        # aimed at column pos mod M, and a dropped row writes back what its
        # column holds.  An example's L <= M columns are then all distinct
        # (its kept ones run from idx to M-1, its dropped ones from 0 up to
        # below idx), so no two writes of one call share a target
        if L > M:
            raise ValueError(f"decode_scatter writes {L} rows into a cache of {M}")
        pos = idx[:, None] + torch.arange(L, device=idx.device)       # [B, L]
        kept = (pos < M)[..., None, None]
        at = pos % M
        b = torch.arange(B, device=idx.device)[:, None].expand(B, L)
        ck[b, :, :, at] = torch.where(kept, k, ck[b, :, :, at])
        cv[b, :, at, :] = torch.where(kept, v, cv[b, :, at, :])
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
    """One decoder layer.  A dense layer returns its output; an MoE layer
    returns ``(output, aux, drops)``."""

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
        if cfg.moe_experts:
            self.moe = MoEMLP(D, cfg.moe_experts, cfg.mlp_dim, cfg.moe_top_k,
                              cfg.moe_capacity, cfg.dtype, cfg.decode)
        else:
            self.mlp_gate = Dense(D, cfg.mlp_dim, cfg.dtype)
            self.mlp_in = Dense(D, cfg.mlp_dim, cfg.dtype)
            self.mlp_out = Dense(cfg.mlp_dim, D, cfg.dtype)
        self.tp: TP | None = None
        self.sp: AxisGroup | None = None
        self._kv_of: torch.Tensor | None = None

    def set_tp(self, tp: TP) -> None:
        """Run this layer's heads and MLP columns of ``tp``'s rank."""
        self.tp = tp
        cfg = self.cfg
        if cfg.moe_experts:
            self.moe.shards = tp        # set_ep widens it to the tp and ep ranks
        H, Hk = cfg.num_heads // tp.size, cfg.kv_heads
        self._kv_of = None
        if not kv_split(cfg, tp) and Hk > 1:
            # whole k and v, and this rank's query heads straddle kv groups:
            # each local query head reads its own global kv head
            self._kv_of = (tp.rank * H + torch.arange(H)) // (cfg.num_heads // Hk)

    def forward(self, x, positions, kv=None, token_mask=None, global_aux: bool = False):
        """``kv``: in decode mode, this layer's ``(keys, values)`` cache
        buffers, the shared write index, and the RoPE tables and future
        mask that every layer of the forward shares.  ``token_mask`` and
        ``global_aux``: the MoE layer's (``MoEMLP.forward``)."""
        cfg, tp = self.cfg, self.tp
        ways = 1 if tp is None else tp.size
        H, Hk, Dh = cfg.num_heads // ways, local_kv_heads(cfg, tp), cfg.head_dim
        B, L = x.shape[:2]
        tables = kv[3] if kv is not None else None
        y = copy_to(self.attn_norm(x), tp)
        q, k, v = self.attn_qkv(y).split([H * Dh, Hk * Dh, Hk * Dh], dim=-1)
        q = rope(q.reshape(B, L, H, Dh), positions, cfg.rope_theta, tables)
        k = rope(k.reshape(B, L, Hk, Dh), positions, cfg.rope_theta, tables)
        v = v.reshape(B, L, Hk, Dh)
        if kv is not None:
            ck, cv, idx, _, hidden = kv
            _write_cache(cfg, ck, cv, k, v, idx)
            if self._kv_of is not None:
                at = self._kv_of.to(ck.device)
                ck, cv = ck.index_select(1, at), cv.index_select(1, at)
            attn = decode_attention(q, ck, cv, idx, hidden)
        else:
            attn = dot_product_attention(q, k, v, causal=True, impl=cfg.attention_impl,
                                         sp=self.sp)
        x = x + reduce_from(self.attn_out(attn.reshape(B, L, H * Dh)), tp)
        if cfg.moe_experts:
            # the router reads the norm whole on every rank: the MoE layer
            # puts its own backward all-reduce on the expert path only
            y, aux, drops = self.moe(self.mlp_norm(x), token_mask, global_aux)
            return x + y, aux, drops
        y = copy_to(self.mlp_norm(x), tp)
        y = F.silu(self.mlp_gate(y)) * self.mlp_in(y)
        return x + reduce_from(self.mlp_out(y), tp)


class TransformerLM(nn.Module):
    """Decoder-only LM.  Parameters are f32 and initialised on the CPU from
    ``generator`` (default: seed 0) with flax's default families
    (lecun-normal kernels, fan-in normal embedding, unit norm scales);
    move the module with ``.to(device)``.  ``init=False`` leaves them
    uninitialised (for a module whose weights are loaded next)."""

    def __init__(self, cfg: TransformerConfig, generator: torch.Generator | None = None,
                 init: bool = True):
        super().__init__()
        self.cfg = cfg
        D, V = cfg.embed_dim, cfg.vocab_size
        self.tok_embed = nn.Embedding(V, D, _weight=torch.empty(V, D))
        self.layers = nn.ModuleList(Block(cfg) for _ in range(cfg.num_layers))
        self.final_norm = RMSNorm(D, cfg.dtype)
        self.lm_head = None if cfg.tie_embeddings else Dense(D, V, cfg.dtype)
        self.tp: TP | None = None
        self.ep: AxisGroup | None = None
        self.sp: AxisGroup | None = None
        self.vocab_split = False
        if init:
            self.reset_parameters(generator or torch.Generator().manual_seed(0))

    def tp_segments(self, name: str):
        """The fused q|k|v weight's dim 0 holds three tensors, each split
        over the tp ranks by heads."""
        if name.endswith("attn_qkv.weight"):
            H, Hk, Dh = self.cfg.num_heads, self.cfg.kv_heads, self.cfg.head_dim
            return (H * Dh, Hk * Dh, Hk * Dh)
        return None

    def tp_whole(self, name: str, size: int) -> tuple[int, ...]:
        """The segments of ``name``'s tp dim that every rank holds whole at
        tp = ``size``: in decode mode, k and v of the fused weight when the
        kv heads do not divide, and the embedding and head when the
        vocabulary does not (the JAX serving layout replicates what does
        not divide).  Training splits everything or raises."""
        cfg = self.cfg
        if not cfg.decode:
            return ()
        if name.endswith("attn_qkv.weight") and cfg.kv_heads % size:
            return (1, 2)
        if name in ("tok_embed.weight", "lm_head.weight") and cfg.vocab_size % size:
            return (0,)
        return ()

    def set_tp(self, tp: TP) -> None:
        """Run the forward tensor-parallel over ``tp`` (the weights already
        cut to this rank's rows by ``shard_init``).  Query heads and the MLP
        must divide; in training the kv heads and the vocabulary must too,
        where a decode model keeps what does not divide whole
        (:meth:`tp_whole`)."""
        cfg = self.cfg
        sizes = [("num_heads", cfg.num_heads), ("mlp_dim", cfg.mlp_dim)]
        if not cfg.decode:
            sizes += [("kv heads", cfg.kv_heads), ("vocab_size", cfg.vocab_size)]
        for what, n in sizes:
            if n % tp.size:
                raise ValueError(f"{what} {n} does not divide over tp = {tp.size}")
        self.tp = tp
        self.vocab_split = cfg.vocab_size % tp.size == 0
        for layer in self.layers:
            layer.set_tp(tp)

    def set_ep(self, ep: AxisGroup, shards: AxisGroup | None = None) -> None:
        """Run each MoE layer on this rank's ``E / ep`` experts (the weights
        already cut by ``shard_init``); ``shards``: the group of the tp and
        ep ranks (``parallel/tp.py:shards_of``; needed after ``set_tp``).
        A dense model has none to split."""
        if not self.cfg.moe_experts:
            raise ValueError("the ep axis needs an MoE model (moe_experts > 0)")
        self.ep = ep
        for layer in self.layers:
            layer.moe.set_ep(ep, shards)

    def set_sp(self, sp: AxisGroup) -> None:
        """Run on this ``sp`` rank's chunk of every sequence.  Not with MoE:
        its capacity counts run over each row's whole sequence (ROADMAP.md,
        Queue 1, MoE x sp)."""
        if self.cfg.moe_experts:
            raise NotImplementedError("MoE with sp > 1 is not ported (ROADMAP.md, Queue 1: "
                                      "MoE x sp)")
        self.sp = sp
        for layer in self.layers:
            layer.sp = sp

    def set_data(self, data: AxisGroup | None) -> None:
        """The ranks that hold other rows of the batch: an MoE model's aux
        loss, when asked for, is the global batch's over them."""
        if self.cfg.moe_experts:
            for layer in self.layers:
                layer.moe.data = data

    def fsdp_units(self) -> list[nn.Module]:
        """FSDP2's units below the root: one per decoder layer."""
        return list(self.layers)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        self.tok_embed.weight.normal_(0.0, self.cfg.embed_dim ** -0.5, generator=gen)
        for mod in self.modules():
            if isinstance(mod, Dense):
                _lecun_normal_(mod.weight, mod.weight.shape[1], gen)
            elif isinstance(mod, RMSNorm):
                mod.scale.fill_(1.0)
            elif isinstance(mod, MoEMLP):
                # a [E, in, out] kernel's fan-in is E * in (flax's receptive field)
                E = mod.num_experts
                _lecun_normal_(mod.gate, mod.gate.shape[0], gen)
                _lecun_normal_(mod.w_in, E * mod.w_in.shape[1], gen)
                _lecun_normal_(mod.w_out, E * mod.w_out.shape[1], gen)

    def forward(self, ids, positions=None, return_hidden: bool = False,
                with_aux: bool = False, cache: KVCache | None = None, token_mask=None,
                targets=None, ce_block: int = 4096, drops: torch.Tensor | None = None):
        """Logits [B, L, V] f32, or with ``return_hidden`` the final-norm
        hidden states [B, L, D] for :func:`lm_loss_fused` (or for
        :meth:`head` on the rows a sampler reads).  ``with_aux`` also
        returns the auxiliary loss: the mean over layers of the MoE layers'
        (0 for a dense model), the global batch's over the data group
        (:meth:`set_data`).  In decode mode ``cache`` is required: the ids'
        keys and values are written at ``cache.index``, which then advances
        by L.  ``token_mask`` ([B, L] bool) marks the real tokens of a
        padded batch: pad tokens take no part in MoE routing.  ``drops``:
        an int32 device scalar the MoE layers' overflow count is added to.
        ``targets`` (``[B, L]`` ids): the per-token NLL of the fused loss
        instead (:func:`lm_loss_fused`, ``ce_block`` wide), computed inside
        the forward, where FSDP2 has gathered the head's weight (with
        ``with_aux``: ``(nll, aux)``).  Under sp, ``ids`` is this rank's
        chunk and the positions default to its global ones."""
        cfg = self.cfg
        if cfg.decode != (cache is not None):
            raise ValueError("a KVCache is passed exactly in decode mode "
                             f"(cfg.decode={cfg.decode})")
        ids = ids.long()
        if positions is None:
            first = 0 if self.sp is None else self.sp.rank * ids.shape[1]
            positions = torch.arange(first, first + ids.shape[1],
                                     device=ids.device).expand(ids.shape)
        x = self._embed(ids)
        if cache is not None:
            shared = (rope_tables(positions, cfg.head_dim, cfg.rope_theta),
                      future_mask(cache.index, ids.shape[1], cache.length))
        auxes, counts = [], []
        for i, layer in enumerate(self.layers):
            kv = None if cache is None else (cache.keys[i], cache.values[i], cache.index,
                                             *shared)
            if cache is None and cfg.remat and torch.is_grad_enabled():
                # the recompute routes the same tokens: the same inputs
                out = checkpoint(layer, x, positions, None, token_mask, with_aux,
                                 use_reentrant=False, context_fn=_REMAT_CONTEXTS)
            else:
                out = layer(x, positions, kv, token_mask, with_aux)
            if cfg.moe_experts:
                x, aux_i, drops_i = out
                auxes.append(aux_i)
                counts.append(drops_i)
            else:
                x = out
        if cache is not None:
            cache.index += ids.shape[1]
        if drops is not None and counts:
            drops += torch.stack(counts).sum().to(drops.dtype)
        x = self.final_norm(x)
        aux = (torch.stack(auxes).mean() if auxes
               else torch.zeros((), dtype=torch.float32, device=x.device))
        if targets is not None:
            nll = self.fused_nll(x, targets, ce_block)
            return (nll, aux) if with_aux else nll
        if return_hidden:
            return (x, aux) if with_aux else x
        logits = self.head(x)
        return (logits, aux) if with_aux else logits

    def _embed(self, ids):
        """The token embeddings in the compute dtype; vocab-parallel under
        tp: this rank's rows looked up, the others' zero, then all-reduced
        (one nonzero term per token: exact)."""
        w, tp = self.tok_embed.weight, self.tp
        if tp is None or not self.vocab_split:
            return F.embedding(ids, w).to(self.cfg.dtype)
        local = ids - tp.rank * w.shape[0]
        inside = (local >= 0) & (local < w.shape[0])
        x = F.embedding(local.clamp(0, w.shape[0] - 1), w) * inside[..., None].to(w.dtype)
        return reduce_from(x, tp).to(self.cfg.dtype)

    def head(self, x):
        """f32 logits of final-norm hidden states ``[..., D]`` (under tp,
        every rank's vocab columns gathered by an all-reduce)."""
        cfg = self.cfg
        x = copy_to(x, self.tp)
        if cfg.tie_embeddings:
            w = self.tok_embed.weight.to(cfg.dtype)
            w = w.to(torch.promote_types(x.dtype, w.dtype))
            logits = (x @ w.t()).float()
        else:
            logits = self.lm_head(x).float()
        return gather_from_tp(logits, self.tp if self.vocab_split else None)

    def fused_nll(self, hidden, targets, block_size: int = 4096):
        """Per-token NLL of final-norm hidden states through the blockwise
        fused CE (``ops/ce.py``), vocab-parallel under tp.  The head weight
        is cast to the hidden states' dtype (f32 under the reference's
        dtype flow)."""
        from edl_tpu_torch.ops.ce import blockwise_cross_entropy

        return blockwise_cross_entropy(hidden, self.head_weight().to(hidden.dtype), targets,
                                       block_size=block_size,
                                       tp=self.tp if self.vocab_split else None)

    def head_weight(self) -> torch.Tensor:
        """The output projection as ``[D, V]`` (the flax kernel layout);
        under tp this rank's ``[D, V / tp]`` columns."""
        w = self.tok_embed.weight if self.cfg.tie_embeddings else self.lm_head.weight
        return w.t()


@torch.no_grad()
def decode_model(model: TransformerLM, decode_scatter: bool = False) -> TransformerLM:
    """``model`` in decode mode with dense attention, for inference: its
    weight matrices and embedding cast once to the compute dtype (each
    use casts them to that dtype anyway, so the numbers are the same,
    and a decode step no longer converts every weight), the norm scales
    shared with ``model``.  ``decode_scatter``: multi-token calls write
    at per-example indices (speculative decoding's verify model).  A model
    already in that mode is returned as it is; a decode model in the other
    mode shares its tensors with the one returned."""
    if model.cfg.decode and model.cfg.decode_scatter == decode_scatter:
        return model
    return rebuilt(model, replace(model.cfg, decode=True, attention_impl="dense", mesh=None,
                                  remat=False, decode_scatter=decode_scatter))


@torch.no_grad()
def rebuilt(model: TransformerLM, cfg: TransformerConfig) -> TransformerLM:
    """A new module of ``cfg`` over ``model``'s tensors, its weight matrices,
    experts and embedding cast to the compute dtype (shared where the dtype
    is already that; an MoE router stays f32).  A tensor-parallel model's
    pieces, its tp and its layouts carry over."""
    with torch.device("meta"):
        out = TransformerLM(cfg, init=False)
    sd = {name: t.detach().to(cfg.dtype) if name.endswith((".weight", ".w_in", ".w_out"))
          else t.detach() for name, t in model.state_dict().items()}
    if model.tp is None:
        out.load_state_dict(sd, assign=True)
    else:
        out.set_tp(model.tp)
        for name, t in sd.items():          # the pieces' shapes are not the module's
            owner, _, leaf = name.rpartition(".")
            out.get_submodule(owner)._parameters[leaf] = nn.Parameter(t, requires_grad=False)
        out.param_layouts = getattr(model, "param_layouts", None)
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
    are never built (:meth:`TransformerLM.fused_nll`)."""
    return _masked_mean(model.fused_nll(hidden, targets, block_size), mask)
