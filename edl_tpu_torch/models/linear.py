"""Linear regression, the fit_a_line smoke workload: the port of the JAX
package's ``models/linear.py`` (reference example/fit_a_line/train_ft.py,
a 13-feature UCI-housing regressor that demos fault tolerance).

One flax ``Dense`` named ``fc`` (ResNet's :class:`Dense`: an ``[out, in]``
f32 weight, the flax kernel transposed, and a zero bias, computed in the
input's dtype).  flax infers the input width at init; here it is
``in_features``.
"""

from __future__ import annotations

import torch
from torch import nn

from edl_tpu_torch.models.resnet import Dense


class LinearRegression(nn.Module):
    def __init__(self, in_features: int = 13, features: int = 1,
                 generator: torch.Generator | None = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        self.fc = Dense(in_features, features, g)

    def forward(self, x):
        return self.fc(x)


def mse_loss(pred, target):
    return ((pred - target) ** 2).mean()
