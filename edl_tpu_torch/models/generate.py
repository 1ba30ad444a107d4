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
"""

from __future__ import annotations

import math

import torch

from edl_tpu_torch.models.transformer import KVCache, TransformerLM, decode_model


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


def cache_length(max_len: int, prompt_len: int, max_new_tokens: int) -> int:
    """The cache a request needs: prompt plus new tokens rounded up to 128,
    at most ``max_len`` (every decode step reads the whole cache, so a
    right-sized cache is a smaller read; RoPE positions are absolute, so
    the size moves no embedding)."""
    return min(max_len, -(-(prompt_len + max_new_tokens) // 128) * 128)


@torch.inference_mode()
def generate(model: TransformerLM, prompt: torch.Tensor, max_new_tokens: int, *,
             generator: torch.Generator | None = None, temperature: float = 1.0,
             top_k: int = 0, top_p: float = 0.0) -> torch.Tensor:
    """``[B, max_new_tokens]`` int32 continuations of ``prompt [B, P]``.

    ``model`` is the trained model (its config's ``max_len`` bounds P +
    new) or one already built by :func:`decode_model`, which a caller
    that generates repeatedly builds once; the tokens are computed on its
    device.  ``generator`` (on that device; default: seeded 0) draws the
    samples; greedy (``temperature <= 0``) ignores it."""
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
    cache = KVCache.zeros(dmodel.cfg, B, cache_length(cfg.max_len, P, max_new_tokens), device)
    prompt = prompt.to(device, non_blocking=True)

    def sample(hidden_last):
        return sample_logits(dmodel.head(hidden_last), generator, temperature=temperature,
                             top_k=top_k, top_p=top_p)

    # prefill: the head only on the last position, the row that is sampled
    hidden = dmodel(prompt, cache=cache, return_hidden=True)
    tok = sample(hidden[:, -1])
    out = [tok]
    for _ in range(max_new_tokens - 1):
        hidden = dmodel(tok[:, None], positions=cache.index[:, None], cache=cache,
                        return_hidden=True)
        tok = sample(hidden[:, 0])
        out.append(tok)
    return torch.stack(out, dim=1)
