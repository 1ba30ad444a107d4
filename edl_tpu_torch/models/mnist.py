"""The MNIST CNN, the minimal distillation student: the port of the JAX
package's ``models/mnist.py`` (reference example/distill/mnist_distill/
train_with_fleet.py:300).

conv1 (20 filters, 5x5, SAME, with bias), a 2x2/2 VALID max pool, ReLU;
conv2 (50 filters) the same; then ``fc``.  The flax numerics kept:

- the convs have a bias (flax's ``nn.Conv`` default; ``models/layers.py:
  Conv``), unlike ResNet's;
- ``fc``'s kernel reads the NHWC flatten ``(H, W, C)``: the activations are
  permuted to NHWC before the flatten (``layers.flatten_nhwc``), so the
  converted flax kernel is used as it is;
- inputs arrive NHWC ``[N, H, W, C]`` and compute in ``dtype`` (bf16 by
  default); f32 weights; logits come out f32.

flax infers the input size at init; here ``image_size`` (28 for MNIST, the
distill example's 16) and ``channels`` fix ``fc``'s width.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from edl_tpu_torch.models.layers import Conv, flatten_nhwc
from edl_tpu_torch.models.resnet import Dense


class MnistCNN(nn.Module):
    """``forward(x [N, H, W, C]) -> f32 logits [N, num_classes]``."""

    def __init__(self, num_classes: int = 10, image_size: int = 28, channels: int = 1,
                 dtype: torch.dtype = torch.bfloat16, generator: torch.Generator | None = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        self.dtype = dtype
        self.conv1 = Conv(channels, 20, 5, generator=g)
        self.conv2 = Conv(20, 50, 5, generator=g)
        side = image_size // 2 // 2
        self.fc = Dense(side * side * 50, num_classes, g)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        x = F.relu(F.max_pool2d(self.conv1(x), 2, 2))
        x = F.relu(F.max_pool2d(self.conv2(x), 2, 2))
        return self.fc(flatten_nhwc(x)).float()
