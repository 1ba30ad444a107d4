"""VGG with batch norm: the port of the JAX package's ``models/vgg.py``
(reference example/collective/resnet50/models/vgg.py:133, VGG11/13/16/19).

Each stage is ``n`` times (3x3 SAME conv with bias, BN, ReLU), then a 2x2/2
VALID max pool; then ``fc0`` and ``fc1`` (4096, ReLU) and ``head``.  The
flax numerics kept:

- the convs have a bias (flax's ``nn.Conv`` default; ``models/layers.py:
  Conv``), unlike ResNet's;
- BN is ResNet's (``models/resnet.py:BatchNorm``): flax's momentum 0.9 and
  ``eps`` 1e-5, batch statistics in f32, the running variance updated with
  the biased batch variance, and in a process group of two or more one BN
  over the world's batch;
- ``fc0``'s kernel reads the NHWC flatten ``(H, W, C)``
  (``layers.flatten_nhwc``);
- inputs arrive NHWC and are permuted to NCHW in ``channels_last`` memory
  order (the same bytes); compute in ``dtype`` (bf16 by default), f32
  weights, f32 logits.

flax infers ``fc0``'s input width at init; here ``image_size`` fixes it
(512 x (image_size / 32)²).  ``train()``/``eval()`` select batch or running
statistics (flax's ``train=True``/``False``).
"""

from __future__ import annotations

from functools import partial

import torch
import torch.nn.functional as F
from torch import nn

from edl_tpu_torch.models.layers import Conv, flatten_nhwc
from edl_tpu_torch.models.resnet import BatchNorm, Dense

_CFG = {
    11: (1, 1, 2, 2, 2),
    13: (2, 2, 2, 2, 2),
    16: (2, 2, 3, 3, 3),
    19: (2, 2, 4, 4, 4),
}
FILTERS = (64, 128, 256, 512, 512)


class VGG(nn.Module):
    """``forward(x [N, H, W, 3]) -> f32 logits [N, num_classes]``."""

    def __init__(self, depth: int = 16, num_classes: int = 1000, image_size: int = 224,
                 channels: int = 3, dtype: torch.dtype = torch.bfloat16,
                 generator: torch.Generator | None = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        self.dtype, self.stages = dtype, _CFG[depth]
        cin = channels
        for i, n_convs in enumerate(self.stages):
            for j in range(n_convs):
                setattr(self, f"conv{i}_{j}", Conv(cin, FILTERS[i], 3, generator=g))
                setattr(self, f"bn{i}_{j}", BatchNorm(FILTERS[i]))
                cin = FILTERS[i]
        side = image_size // 2 ** len(self.stages)
        self.fc0 = Dense(side * side * cin, 4096, g)
        self.fc1 = Dense(4096, 4096, g)
        self.head = Dense(4096, num_classes, g)
        self.to(memory_format=torch.channels_last)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2).to(self.dtype)   # NHWC bytes = NCHW channels_last
        for i, n_convs in enumerate(self.stages):
            for j in range(n_convs):
                x = F.relu(getattr(self, f"bn{i}_{j}")(getattr(self, f"conv{i}_{j}")(x)))
            x = F.max_pool2d(x, 2, 2)
        x = F.relu(self.fc0(flatten_nhwc(x)))
        x = F.relu(self.fc1(x))
        return self.head(x).float()


VGG16 = partial(VGG, depth=16)
