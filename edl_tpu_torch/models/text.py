"""Text classifiers for the NLP distillation flow: the port of the JAX
package's ``models/text.py`` (reference example/distill/nlp/model.py:135,
BOW and CNN students distilled from a BERT teacher with a KL-temperature
loss, distill.py:208).  The teacher is :class:`TextTransformer`, a compact
encoder classifier.

Every model takes ``ids [B, L]`` (int) and an optional ``mask [B, L]`` (1
for a token, 0 for padding), computes in ``dtype`` (bf16 by default) on f32
weights, and returns f32 logits ``[B, num_classes]``.  The flax numerics
kept:

- ``nn.Embed(dtype=...)`` casts its table to the compute dtype before the
  take (a take commutes with the cast, so the rows are looked up, then
  cast: ``models/transformer.py:embed_tokens``).
- :class:`CnnClassifier`'s 1-D conv (kernel 5, SAME) has a bias, and its
  ReLU'd max runs over **all** positions, the padded ones included.
- ``nn.LayerNorm``: ``eps`` 1e-6, f32 statistics with the fast variance
  (``layers.LayerNorm``).
- ``nn.gelu`` is the tanh approximation (``F.gelu(approximate="tanh")``).
- The attention is flax's ``MultiHeadDotProductAttention`` (XLA, no Pallas):
  q, k and v from ``DenseGeneral`` kernels ``[D, H, Dh]`` with biases
  ``[H, Dh]`` (here ``Dense`` weights ``[H Dh, D]``, ``models/convert.py``
  reshapes), v from the same input as k; q divided by ``sqrt(Dh)`` rounded
  to the compute dtype before the product; the mask ``mask & maskᵀ``;
  masked logits filled with ``finfo(dtype).min``, **not** ``-inf``, and
  the softmax in the compute dtype; the output kernel ``[H, Dh, D]`` with
  bias ``[D]``.  So a padded query row, which sees no key, averages every
  key and stays finite, where a ``-inf`` fill (the port's
  ``ops/attention.py:dense_attention``, and the Hopper kernels) makes it NaN
  and the masked mean then NaN for the whole sequence.  That is why this
  model does not go through ``ops/attention.py``.
- The classifier head reads the masked mean ``Σ x·m / max(Σ m, 1)``, in the
  compute dtype.

Init as flax's defaults: embeddings a normal of variance 1 / features,
kernels ``lecun_normal``, zero biases, unit norm scales.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from edl_tpu_torch.models.layers import Conv, LayerNorm, embed_init_
from edl_tpu_torch.models.resnet import Dense
from edl_tpu_torch.models.transformer import embed_tokens


def _embedding(vocab: int, features: int, g: torch.Generator) -> nn.Embedding:
    table = nn.Embedding(vocab, features, _weight=torch.empty(vocab, features))
    embed_init_(table.weight, g)
    return table


def _masked(x, mask, dtype):
    return x if mask is None else x * mask[..., None].to(dtype)


class BowClassifier(nn.Module):
    """Bag-of-words student (model.py BOW): the masked sum of the
    embeddings, tanh, ``fc1`` and tanh, ``head``."""

    def __init__(self, vocab_size: int, embed_dim: int = 128, hidden: int = 128,
                 num_classes: int = 2, dtype: torch.dtype = torch.bfloat16,
                 generator: torch.Generator | None = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        self.dtype = dtype
        self.embed = _embedding(vocab_size, embed_dim, g)
        self.fc1 = Dense(embed_dim, hidden, g)
        self.head = Dense(hidden, num_classes, g)

    def forward(self, ids, mask=None):
        x = _masked(embed_tokens(ids, self.embed.weight, None, self.dtype), mask, self.dtype)
        x = torch.tanh(x.sum(1))
        x = torch.tanh(self.fc1(x))
        return self.head(x).float()


class CnnClassifier(nn.Module):
    """1-D conv student (model.py CNN): masked embeddings, a SAME conv of
    ``kernel`` with bias, ReLU, the max over every position, ``fc1`` (96)
    and tanh, ``head``."""

    def __init__(self, vocab_size: int, embed_dim: int = 128, filters: int = 128,
                 kernel: int = 5, num_classes: int = 2, dtype: torch.dtype = torch.bfloat16,
                 generator: torch.Generator | None = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        self.dtype = dtype
        self.embed = _embedding(vocab_size, embed_dim, g)
        self.conv = Conv(embed_dim, filters, kernel, ndim=1, generator=g)
        self.fc1 = Dense(filters, 96, g)
        self.head = Dense(96, num_classes, g)

    def forward(self, ids, mask=None):
        x = _masked(embed_tokens(ids, self.embed.weight, None, self.dtype), mask, self.dtype)
        x = F.relu(self.conv(x.transpose(1, 2))).amax(-1)
        x = torch.tanh(self.fc1(x))
        return self.head(x).float()


class SelfAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention(num_heads, dtype)(y, y, mask)``
    without dropout: ``query``, ``key``, ``value`` and ``out`` Dense layers
    (see the module docstring)."""

    def __init__(self, features: int, num_heads: int, generator: torch.Generator):
        super().__init__()
        if features % num_heads:
            raise ValueError(f"{features} features do not split into {num_heads} heads")
        self.num_heads = num_heads
        for name in ("query", "key", "value", "out"):
            setattr(self, name, Dense(features, features, generator))

    def forward(self, y, mask=None):
        B, L, D = y.shape
        H = self.num_heads
        Dh = D // H
        q, k, v = (getattr(self, n)(y).view(B, L, H, Dh) for n in ("query", "key", "value"))
        q = q / torch.tensor(math.sqrt(Dh), dtype=torch.float32).to(q.dtype)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
        if mask is not None:
            logits = logits.masked_fill(~mask, torch.finfo(logits.dtype).min)
        weights = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", weights, v)
        return self.out(out.reshape(B, L, D))


class TextTransformer(nn.Module):
    """Compact pre-norm encoder classifier, the distillation teacher
    (standing in for the reference's fine-tuned BERT, fine_tune.py:201)."""

    def __init__(self, vocab_size: int, num_layers: int = 4, embed_dim: int = 256,
                 num_heads: int = 4, mlp_dim: int = 1024, max_len: int = 512,
                 num_classes: int = 2, dtype: torch.dtype = torch.bfloat16,
                 generator: torch.Generator | None = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        self.dtype, self.num_layers = dtype, num_layers
        self.tok_embed = _embedding(vocab_size, embed_dim, g)
        self.pos_embed = _embedding(max_len, embed_dim, g)
        for i in range(num_layers):
            setattr(self, f"ln1_{i}", LayerNorm(embed_dim, dtype))
            setattr(self, f"attn_{i}", SelfAttention(embed_dim, num_heads, g))
            setattr(self, f"ln2_{i}", LayerNorm(embed_dim, dtype))
            setattr(self, f"mlp_in_{i}", Dense(embed_dim, mlp_dim, g))
            setattr(self, f"mlp_out_{i}", Dense(mlp_dim, embed_dim, g))
        self.ln_f = LayerNorm(embed_dim, dtype)
        self.head = Dense(embed_dim, num_classes, g)

    def forward(self, ids, mask=None):
        L = ids.shape[1]
        x = embed_tokens(ids, self.tok_embed.weight, None, self.dtype)
        x = x + embed_tokens(torch.arange(L, device=ids.device), self.pos_embed.weight, None,
                             self.dtype)[None]
        attn_mask = None
        if mask is not None:
            m = mask.bool()
            attn_mask = m[:, None, None, :] & m[:, None, :, None]
        for i in range(self.num_layers):
            y = getattr(self, f"ln1_{i}")(x)
            x = x + getattr(self, f"attn_{i}")(y, attn_mask)
            y = getattr(self, f"ln2_{i}")(x)
            y = F.gelu(getattr(self, f"mlp_in_{i}")(y), approximate="tanh")
            x = x + getattr(self, f"mlp_out_{i}")(y)
        x = self.ln_f(x)
        if mask is not None:
            w = mask.to(self.dtype)
            x = (x * w[..., None]).sum(1) / w.sum(1, keepdim=True).clamp_min(1)
        else:
            x = x.mean(1)
        return self.head(x).float()


def kl_distill_loss(student_logits, teacher_logits, temperature: float = 1.0):
    """KL(teacher ∥ student) with temperature (reference distill.py KL
    loss), times ``T²``, the batch mean."""
    t = temperature
    p = F.log_softmax(teacher_logits / t, dim=-1)
    q = F.log_softmax(student_logits / t, dim=-1)
    return (p.exp() * (p - q)).sum(-1).mean() * t * t
