"""The ResNet family (a port of the JAX package's ``models/resnet.py``):
ResNet18/34/50/101/152 with basic or bottleneck blocks, and the ``vd``
variant (a deep stem of three 3x3 convs, and average-pool shortcuts).

The flax model's numerics, kept where a PyTorch default differs:

- **Layout and dtypes.** Inputs arrive NHWC, as the JAX model takes them,
  and are permuted to NCHW in ``channels_last`` memory order, which is the
  same bytes (a view, no copy).  Weights are f32; convs, BN outputs and the
  head compute in ``dtype`` (bf16 by default); logits come out f32.
- **SAME padding.** flax convs and the max pool pad as XLA does: total
  ``max((ceil(n / s) - 1) * s + k - n, 0)``, split ``lo = total // 2``, ``hi
  = total - lo``.  At stride 2 that is asymmetric: the 7x7/2 stem on 224
  pads (2, 3) and a 3x3/2 on an even size pads (0, 1), where PyTorch's
  symmetric ``k // 2`` would shift every output by a pixel.  Asymmetric
  pads are explicit (``F.pad``; ``-inf`` for the max pool).
- **BatchNorm** (``momentum=0.9``, ``eps=1e-5`` in flax, 0.1 in PyTorch's
  convention).  Train mode normalises with the batch statistics in f32 and
  updates the running variance with the *biased* batch variance, as flax
  does (``F.batch_norm`` would take the unbiased one).  The running stats
  are module buffers, so ``state_dict`` carries them.  ``ResNet.stat_gate``
  holds or gates their update: a forward that is recomputed for the
  backward (``--remat``) must not update them twice, and a padded
  data-service batch keeps the previous stats (``where(all_real, new,
  old)`` in the JAX example), its gate a 0-d tensor decided on the card.
- **One batch over the world.**  The JAX example jits its step over a
  global mesh, so flax takes the statistics over the global batch, padded
  rows included.  In a process group of two or more, train mode does the
  same (:class:`_WorldBatchNorm`): one all-reduce of the per-channel sum,
  sum of squares and row count in the forward, flax's fast variance
  ``max(E[x²] - E[x]², 0)``, and one all-reduce of ``Σdy`` and ``Σdy·x̂`` in
  the backward, so every rank holds the same running stats.  With no group,
  or a group of one, the op is ``native_batch_norm`` with no collective.
  The group is read at each forward, so a world re-formed in place is
  followed.
- **Init.** Conv and head kernels are flax's ``lecun_normal`` (a normal
  truncated at two standard deviations, variance 1 / fan_in), drawn from
  an explicit ``torch.Generator``; the head bias is 0; BN scales are 1,
  except the last BN of each residual branch (``bn3`` of a bottleneck,
  ``bn2`` of a basic block), which starts at 0.

Module names follow flax's (``stem``, ``stage{i}_block{j}.conv1``,
``bn_shortcut``, ``head``, ...), so ``models/convert.py`` maps the two
trees name for name.
"""

from __future__ import annotations

import contextlib
import math
from functools import partial
from typing import Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

BN_MOMENTUM = 0.1   # flax momentum 0.9: running = 0.9 * running + 0.1 * batch
BN_EPS = 1e-5


def same_padding(n: int, k: int, s: int) -> tuple[int, int]:
    """XLA's ``SAME`` padding of a length-``n`` axis for window ``k``,
    stride ``s``: ``(lo, hi)``, with the odd pixel at the end."""
    total = max((math.ceil(n / s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, k: int, s: int, value: float = 0.0):
    """``x`` [N, C, H, W] padded for a ``SAME`` window when the padding is
    asymmetric (returned with padding 0), else untouched with the
    symmetric padding for the op to apply itself."""
    (ht, hb), (wl, wr) = same_padding(x.shape[2], k, s), same_padding(x.shape[3], k, s)
    if ht == hb and wl == wr:
        return x, (ht, wl)
    x = F.pad(x, (wl, wr, ht, hb), value=value)
    return x.contiguous(memory_format=torch.channels_last), (0, 0)


def lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator) -> torch.Tensor:
    """flax's ``lecun_normal``: a normal truncated to [-2, 2] standard
    deviations, scaled so its variance is 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def max_pool_same(x: torch.Tensor, k: int = 3, s: int = 2) -> torch.Tensor:
    """flax ``nn.max_pool(x, (k, k), strides=(s, s), padding="SAME")`` on
    [N, C, H, W]: the padding counts as ``-inf``."""
    x, pad = _pad_same(x, k, s, value=-math.inf)
    return F.max_pool2d(x, k, s, padding=pad)


class Conv(nn.Module):
    """flax ``nn.Conv(use_bias=False, padding="SAME")`` with an OIHW f32
    kernel, computed in the input's dtype."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.k, self.stride = k, stride
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        lecun_normal_(self.weight, cin * k * k, generator)

    def forward(self, x):
        x, pad = _pad_same(x, self.k, self.stride)
        return F.conv2d(x, self.weight.to(x.dtype), stride=self.stride, padding=pad)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the channels of [N, C, H, W]: batch
    statistics in f32 in train mode (the running variance takes the biased
    batch variance), the running ones in eval mode; out in the input's
    dtype."""

    def __init__(self, channels: int, zero_scale: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(channels) if zero_scale else torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        # the running-stat update's gate: 1.0 updates, 0.0 skips, a 0-d f32
        # tensor of 1 or 0 decides on the device (set by ResNet.stat_gate)
        self.stat_gate: float | torch.Tensor = 1.0

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                                training=False, eps=BN_EPS)
        if _world() > 1:
            out, mean, var = _WorldBatchNorm.apply(x, self.weight, self.bias)
        else:
            # with no running stats the op only normalises; it returns the
            # batch mean and 1 / sqrt(biased var + eps), from which the
            # update is made
            out, mean, invstd = torch.native_batch_norm(x, self.weight, self.bias, None, None,
                                                        True, 0.0, BN_EPS)
            var = None
        gate = self.stat_gate
        if isinstance(gate, torch.Tensor) or gate:
            # a gate of 0 makes the lerp's weight 0: the stats come back as
            # they were, to the bit
            weight = BN_MOMENTUM * gate
            with torch.no_grad():
                if var is None:
                    var = (invstd.to(self.running_var.dtype).pow(-2) - BN_EPS).clamp_min(0.0)
                self.running_mean.lerp_(mean.to(self.running_mean.dtype), weight)
                self.running_var.lerp_(var.to(self.running_var.dtype), weight)
        return out


def _world() -> int:
    """The default process group's size, read now (a world re-formed in
    place has a new one); 1 with no group."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


class _WorldBatchNorm(torch.autograd.Function):
    """Train-mode batch norm of [N, C, H, W] over the global batch of the
    default process group, as flax computes it on a global mesh: the
    statistics in at least f32, the mean and flax's fast (biased) variance
    ``max(E[x²] - E[x]², 0)`` over every rank's rows, padding included.
    ``apply(x, weight, bias) -> (out in x's dtype, mean, var)``; mean and var
    are not differentiable.

    The backward all-reduces ``Σdy`` and ``Σdy·(x - mean)``, so each rank's
    input gradient is that of the sum of every rank's loss through the
    global statistics; the scale and bias gradients stay local, and the
    trainer's world mean of gradients averages them as it does every other.

    The sums read ``x`` in its own dtype, accumulating in f32 with no copy of
    it; on the card the normalisation and the backward are PyTorch's fused
    sync-BN element-wise and reduction ops (``batch_norm_elemt``,
    ``batch_norm_backward_reduce``, ``batch_norm_backward_elemt``), which
    have no CPU kernel, so the CPU computes the same formulas in tensors."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        acc = torch.promote_types(x.dtype, torch.float32)
        channels, dims = x.shape[1], (0, 2, 3)
        rows = torch.full((1,), x.numel() // channels, dtype=acc, device=x.device)
        packed = torch.cat([x.sum(dims, dtype=acc),
                            torch.linalg.vector_norm(x, 2, dims, dtype=acc).square(), rows])
        dist.all_reduce(packed)
        n = packed[2 * channels:]
        mean = packed[:channels] / n
        var = (packed[channels:2 * channels] / n - mean.square()).clamp_min(0.0)
        invstd = torch.rsqrt(var + BN_EPS)
        ctx.param_dtype = weight.dtype
        weight, bias = weight.to(acc), bias.to(acc)
        if x.is_cuda:
            out = torch.batch_norm_elemt(x, weight, bias, mean, invstd, BN_EPS)
        else:
            scale = weight * invstd
            out = ((x.to(acc) - mean[:, None, None]) * scale[:, None, None]
                   + bias[:, None, None]).to(x.dtype)
        ctx.save_for_backward(x, weight, mean, invstd, n)
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, mean, invstd, n = ctx.saved_tensors
        channels, dims = x.shape[1], (0, 2, 3)
        if x.is_cuda:
            dy = dy.contiguous(memory_format=torch.channels_last
                               if x.is_contiguous(memory_format=torch.channels_last)
                               else torch.contiguous_format)
            sum_dy, sum_dy_xmu, dweight, dbias = torch.batch_norm_backward_reduce(
                dy, x, mean, invstd, weight, True, True, True)
            total = torch.cat([sum_dy, sum_dy_xmu])
            dist.all_reduce(total)
            dx = torch.batch_norm_backward_elemt(dy, x, mean, invstd, weight, total[:channels],
                                                 total[channels:], n.to(torch.int32))
            return dx, dweight.to(ctx.param_dtype), dbias.to(ctx.param_dtype)
        dyf = dy.to(mean.dtype)
        xmu = x.to(mean.dtype) - mean[:, None, None]
        local = torch.cat([dyf.sum(dims), (dyf * xmu).sum(dims)])
        dbias, dweight = local[:channels], local[channels:] * invstd
        total = local.clone()
        dist.all_reduce(total)
        mean_dy, mean_dy_xmu = total[:channels] / n, total[channels:] / n
        dx = (dyf - mean_dy[:, None, None]
              - xmu * (invstd.square() * mean_dy_xmu)[:, None, None]) \
            * (weight * invstd)[:, None, None]
        return dx.to(x.dtype), dweight.to(ctx.param_dtype), dbias.to(ctx.param_dtype)


class Dense(nn.Module):
    """flax ``nn.Dense``: a ``[out, in]`` f32 weight (flax's ``[in, out]``
    kernel transposed) and a zero bias, computed in the input's dtype."""

    def __init__(self, cin: int, cout: int, generator: torch.Generator | None = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout))
        lecun_normal_(self.weight, cin, generator)

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class BottleneckBlock(nn.Module):
    expansion = 4

    def __init__(self, cin: int, filters: int, strides: int, vd: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        conv = partial(Conv, generator=generator)
        self.conv1, self.bn1 = conv(cin, filters, 1), BatchNorm(filters)
        self.conv2, self.bn2 = conv(filters, filters, 3, strides), BatchNorm(filters)
        self.conv3 = conv(filters, filters * 4, 1)
        self.bn3 = BatchNorm(filters * 4, zero_scale=True)
        self.strides, self.vd = strides, vd
        if cin != filters * 4 or strides != 1:
            # vd: a 2x2/2 VALID average pool, then a 1x1 at stride 1
            self.conv_shortcut = conv(cin, filters * 4, 1, 1 if vd and strides != 1 else strides)
            self.bn_shortcut = BatchNorm(filters * 4)
        else:
            self.conv_shortcut = None

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x
        if self.conv_shortcut is not None:
            if self.vd and self.strides != 1:
                residual = F.avg_pool2d(residual, 2, 2)
            residual = self.bn_shortcut(self.conv_shortcut(residual))
        return F.relu(residual + y)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, filters: int, strides: int, vd: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        conv = partial(Conv, generator=generator)
        self.conv1, self.bn1 = conv(cin, filters, 3, strides), BatchNorm(filters)
        self.conv2, self.bn2 = conv(filters, filters, 3), BatchNorm(filters, zero_scale=True)
        if cin != filters or strides != 1:
            # no average-pool shortcut here, vd or not (as in the JAX model)
            self.conv_shortcut = conv(cin, filters, 1, strides)
            self.bn_shortcut = BatchNorm(filters)
        else:
            self.conv_shortcut = None

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x
        if self.conv_shortcut is not None:
            residual = self.bn_shortcut(self.conv_shortcut(residual))
        return F.relu(residual + y)


class ResNet(nn.Module):
    """``forward(x [N, H, W, 3], any float dtype) -> f32 logits [N,
    num_classes]``; ``train()``/``eval()`` select batch or running BN
    statistics (flax's ``train=True``/``False``)."""

    def __init__(self, stage_sizes: Sequence[int], block: type = BottleneckBlock,
                 num_classes: int = 1000, width: int = 64, vd: bool = False,
                 dtype: torch.dtype = torch.bfloat16, generator: torch.Generator | None = None):
        super().__init__()
        self.stage_sizes, self.dtype, self.vd = tuple(stage_sizes), dtype, vd
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        if vd:
            self.stem1, self.stem_bn1 = Conv(3, width // 2, 3, 2, g), BatchNorm(width // 2)
            self.stem2, self.stem_bn2 = Conv(width // 2, width // 2, 3, 1, g), BatchNorm(width // 2)
            self.stem3, self.stem_bn3 = Conv(width // 2, width, 3, 1, g), BatchNorm(width)
        else:
            self.stem, self.stem_bn = Conv(3, width, 7, 2, g), BatchNorm(width)
        cin = width
        for i, n_blocks in enumerate(self.stage_sizes):
            for j in range(n_blocks):
                strides = 2 if i > 0 and j == 0 else 1
                setattr(self, f"stage{i}_block{j}",
                        block(cin, width * 2 ** i, strides, vd=vd, generator=g))
                cin = width * 2 ** i * block.expansion
        self.head = Dense(cin, num_classes, g)
        self.to(memory_format=torch.channels_last)

    @contextlib.contextmanager
    def stat_gate(self, gate: float | torch.Tensor):
        """Within the block, every BN's running-stat update is gated by
        ``gate`` (see ``BatchNorm.stat_gate``); the previous gates come back
        after it."""
        bns = [m for m in self.modules() if isinstance(m, BatchNorm)]
        prev = [m.stat_gate for m in bns]
        for m in bns:
            m.stat_gate = gate
        try:
            yield self
        finally:
            for m, g in zip(bns, prev):
                m.stat_gate = g

    def blocks(self):
        for i, n_blocks in enumerate(self.stage_sizes):
            for j in range(n_blocks):
                yield getattr(self, f"stage{i}_block{j}")

    def forward(self, x):
        x = x.permute(0, 3, 1, 2).to(self.dtype)   # NHWC bytes = NCHW channels_last
        if self.vd:
            x = F.relu(self.stem_bn1(self.stem1(x)))
            x = F.relu(self.stem_bn2(self.stem2(x)))
            x = F.relu(self.stem_bn3(self.stem3(x)))
        else:
            x = F.relu(self.stem_bn(self.stem(x)))
        x = max_pool_same(x)
        for block in self.blocks():
            x = block(x)
        x = x.mean((2, 3))
        return self.head(x).float()


ResNet18 = partial(ResNet, stage_sizes=(2, 2, 2, 2), block=BasicBlock)
ResNet18vd = partial(ResNet, stage_sizes=(2, 2, 2, 2), block=BasicBlock, vd=True)
ResNet34 = partial(ResNet, stage_sizes=(3, 4, 6, 3), block=BasicBlock)
ResNet50 = partial(ResNet, stage_sizes=(3, 4, 6, 3))
ResNet50vd = partial(ResNet, stage_sizes=(3, 4, 6, 3), vd=True)
ResNet101 = partial(ResNet, stage_sizes=(3, 4, 23, 3))
ResNet152 = partial(ResNet, stage_sizes=(3, 8, 36, 3))
