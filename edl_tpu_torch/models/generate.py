"""Autoregressive generation for :class:`TransformerLM` with a KV cache.

The port of the JAX package's ``models/generate.py``: one prefill pass
writes the prompt's keys and values into an explicit
:class:`~edl_tpu_torch.models.transformer.KVCache`, then each decode step
feeds one token per example and attends against the cache.  The decode
steps are a Python loop with no host synchronisation inside it: tokens
stay on the device until the caller reads the result.

Sampling (:func:`sample_logits`, shared with the serving engine): greedy
at ``temperature <= 0``, else temperature, an optional top-k threshold,
an optional top-p nucleus and a categorical draw from the caller's
``torch.Generator``, so a fixed generator gives fixed tokens.

Tensor-parallel serving (the JAX ``shard_split_params``):
:func:`shard_decode_model` cuts a whole model to one rank's piece of a
mesh's ``tp`` group; every rank of the group then runs :func:`generate`
on its piece with the same prompt, and the rank at tp 0 samples each
token and broadcasts it (:func:`sample_on_leader`), so every rank feeds
the same ids whatever its generator.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from edl_tpu_torch.models.transformer import (
    LOGICAL_RULES,
    KVCache,
    TransformerLM,
    decode_model,
    rebuilt,
)
from edl_tpu_torch.parallel.tp import TP


def sample_logits(logits: torch.Tensor, generator: torch.Generator | None = None, *,
                  temperature: float = 1.0, top_k: int = 0,
                  top_p: float = 0.0) -> torch.Tensor:
    """``[B, V]`` f32 logits -> ``[B]`` int32 token ids.  Greedy at
    ``temperature <= 0``; else the logits over ``temperature``, truncated
    to those not below the k-th largest (``top_k``; the JAX package's
    ``approx_max_k`` threshold is exact off the TPU, as ``torch.topk``
    is, and ties with the k-th survive), then to the nucleus (``top_p``:
    the smallest prefix by descending probability whose mass before each
    token is below p, so the top token always survives), then a
    categorical draw (Gumbel-max) from ``generator``."""
    if temperature <= 0:
        return logits.argmax(-1).to(torch.int32)
    scaled = logits / temperature
    if top_k:
        kth = torch.topk(scaled, top_k, dim=-1).values[..., -1:]
        scaled = scaled.masked_fill(scaled < kth, -math.inf)
    if top_p and top_p < 1.0:
        sorted_ = torch.sort(scaled, dim=-1, descending=True).values
        probs = torch.softmax(sorted_, dim=-1)
        before = torch.cumsum(probs, dim=-1) - probs
        cutoff = torch.where(before < top_p, sorted_, math.inf).amin(-1, keepdim=True)
        scaled = scaled.masked_fill(scaled < cutoff, -math.inf)
    u = torch.rand(scaled.shape, generator=generator, device=scaled.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    return (scaled + gumbel).argmax(-1).to(torch.int32)


def sample_on_leader(logits: torch.Tensor, tp: TP | None,
                     generator: torch.Generator | None = None, **kw) -> torch.Tensor:
    """:func:`sample_logits` on the rank at tp 0, broadcast over the ``tp``
    group (every rank holds the gathered logits; only the leader's
    generator draws).  Without ``tp``, :func:`sample_logits` itself."""
    if tp is None:
        return sample_logits(logits, generator, **kw)
    if tp.rank == 0:
        tok = sample_logits(logits, generator, **kw)
    else:
        tok = torch.empty(logits.shape[:-1], dtype=torch.int32, device=logits.device)
    dist.broadcast(tok, dist.get_global_rank(tp.group, 0), group=tp.group)
    return tok


def shard_decode_model(model: TransformerLM, mesh) -> TransformerLM:
    """The decode model of ``model`` cut to this rank's piece of ``mesh``'s
    ``tp`` group (the JAX ``shard_split_params``): its query heads and
    matching kv heads, MLP columns and rows and vocabulary rows
    (``parallel/sharding.py:tp_slice`` by ``LOGICAL_RULES``), ``set_tp``
    called.  What does not divide over tp stays whole (the kv heads of
    MQA, an odd vocabulary), as the JAX serving layout replicates it.
    ``model`` is whole and is left as it is; a model already cut (a tp
    checkpoint's restore) only gets its decode copy; without a tp dim
    wider than 1 this is :func:`decode_model`."""
    from dataclasses import replace

    from edl_tpu_torch.parallel.sharding import shard_init

    if TP.of(mesh) is None or model.tp is not None:
        return decode_model(model)
    cfg = replace(model.cfg, decode=True, attention_impl="dense", mesh=None, remat=False,
                  decode_scatter=False)
    return shard_init(lambda: rebuilt(model, cfg), LOGICAL_RULES, mesh, fsdp=False)


def cache_length(max_len: int, prompt_len: int, max_new_tokens: int) -> int:
    """The cache a request needs: prompt plus new tokens rounded up to 128,
    at most ``max_len`` (every decode step reads the whole cache, so a
    right-sized cache is a smaller read; RoPE positions are absolute, so
    the size moves no embedding)."""
    return min(max_len, -(-(prompt_len + max_new_tokens) // 128) * 128)


@torch.inference_mode()
def generate(model: TransformerLM, prompt: torch.Tensor, max_new_tokens: int, *,
             generator: torch.Generator | None = None, temperature: float = 1.0,
             top_k: int = 0, top_p: float = 0.0, return_drops: bool = False):
    """``[B, max_new_tokens]`` int32 continuations of ``prompt [B, P]``.

    ``model`` is the trained model (its config's ``max_len`` bounds P +
    new) or one already built by :func:`decode_model`, which a caller
    that generates repeatedly builds once; the tokens are computed on its
    device.  ``generator`` (on that device; default: seeded 0) draws the
    samples; greedy (``temperature <= 0``) ignores it.  A tensor-parallel
    model (:func:`shard_decode_model`) is called by every rank of its group
    with the same prompt; the leader's generator draws.

    ``return_drops``: ``(tokens, drops)``, drops the MoE prefill's capacity
    overflow (an int32 device scalar; 0 for a dense model, and the decode
    steps, whose per-token gather has no capacity, never drop)."""
    if prompt.ndim != 2:
        raise ValueError(f"prompt must be [B, P], got {tuple(prompt.shape)}")
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    B, P = prompt.shape
    cfg = model.cfg
    if P + max_new_tokens > cfg.max_len:
        raise ValueError(f"prompt {P} + new {max_new_tokens} exceeds max_len "
                         f"{cfg.max_len} (the KV cache size)")
    if not 0.0 <= top_p <= 1.0:
        raise ValueError(f"top_p must be in [0, 1], got {top_p}")
    dmodel = decode_model(model)
    device = dmodel.tok_embed.weight.device
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    cache = KVCache.zeros(dmodel.cfg, B, cache_length(cfg.max_len, P, max_new_tokens), device,
                          dmodel.tp)
    prompt = prompt.to(device, non_blocking=True)

    def sample(hidden_last):
        return sample_on_leader(dmodel.head(hidden_last), dmodel.tp, generator,
                                temperature=temperature, top_k=top_k, top_p=top_p)

    drops = torch.zeros((), dtype=torch.int32, device=device) if return_drops else None
    # prefill: the head only on the last position, the row that is sampled
    hidden = dmodel(prompt, cache=cache, return_hidden=True, drops=drops)
    tok = sample(hidden[:, -1])
    out = [tok]
    for _ in range(max_new_tokens - 1):
        hidden = dmodel(tok[:, None], positions=cache.index[:, None], cache=cache,
                        return_hidden=True)
        tok = sample(hidden[:, 0])
        out.append(tok)
    toks = torch.stack(out, dim=1)
    return (toks, drops) if return_drops else toks
