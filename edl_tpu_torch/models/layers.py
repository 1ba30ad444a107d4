"""flax layers whose PyTorch defaults compute something else, shared by the
small models (``linear``, ``wide_deep``, ``mnist``, ``text``, ``vgg``).

- :class:`Conv`: flax ``nn.Conv`` with its default ``use_bias=True`` and
  ``padding="SAME"`` at stride 1, 1-D or 2-D (ResNet's ``Conv`` has no
  bias).  An even kernel pads the odd pixel at the end, as XLA does.
- :class:`LayerNorm`: flax ``nn.LayerNorm``: ``epsilon`` 1e-6 (PyTorch's
  1e-5), the statistics in f32 whatever the input dtype, with flax's fast
  variance ``max(E[x²] - E[x]², 0)``, and the output in the compute dtype.
- :func:`flatten_nhwc`: a flax model flattens NHWC activations, so a
  ``Dense`` after a conv stack takes its input in ``(H, W, C)`` order;
  flattening the NCHW tensor would feed the head scrambled features.
- :func:`embed_init_`: flax's default ``nn.Embed`` init,
  ``variance_scaling(1, "fan_in", "normal", out_axis=0)``: a normal of
  variance 1 / features.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from edl_tpu_torch.models.resnet import lecun_normal_, same_padding

LN_EPS = 1e-6   # flax nn.LayerNorm's epsilon


class Conv(nn.Module):
    """flax ``nn.Conv(features, kernel, padding="SAME")`` at stride 1 with
    its bias, on ``[N, C, L]`` (``ndim=1``) or ``[N, C, H, W]``: f32 weight
    (OIHW / OIL) and bias, computed in the input's dtype.  Init: flax's
    ``lecun_normal`` kernel, zero bias."""

    def __init__(self, cin: int, cout: int, k: int, ndim: int = 2,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.k, self.ndim = k, ndim
        self.weight = nn.Parameter(torch.empty(cout, cin, *(k,) * ndim))
        self.bias = nn.Parameter(torch.zeros(cout))
        lecun_normal_(self.weight, cin * k ** ndim, generator)

    def forward(self, x):
        lo, hi = same_padding(x.shape[-1], self.k, 1)
        w, b = self.weight.to(x.dtype), self.bias.to(x.dtype)
        conv = F.conv1d if self.ndim == 1 else F.conv2d
        if lo == hi:
            return conv(x, w, b, padding=lo)
        return conv(F.pad(x, (lo, hi) * self.ndim), w, b)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=dtype)`` over the last dim: f32 statistics
    (flax's fast variance), ``eps`` 1e-6, f32 scale and bias, out in
    ``dtype``."""

    def __init__(self, features: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        x = x.float()
        mean = x.mean(-1, keepdim=True)
        var = (x.square().mean(-1, keepdim=True) - mean.square()).clamp_min(0.0)
        y = (x - mean) * (torch.rsqrt(var + LN_EPS) * self.weight)
        return (y + self.bias).to(self.dtype)


def embed_init_(w: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """flax's default embedding init on ``w [vocab, features]``."""
    with torch.no_grad():
        return w.normal_(0.0, 1.0 / math.sqrt(w.shape[1]), generator=generator)


def flatten_nhwc(x: torch.Tensor) -> torch.Tensor:
    """``x [N, C, H, W]`` flattened in flax's ``(H, W, C)`` order."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
