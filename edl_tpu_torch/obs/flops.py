"""FLOP accounting for MFU.

``analytic_lm_flops_per_token`` is a copy of the JAX package's
``obs/flops.py`` formula; ``analytic_resnet_flops_per_image`` counts a
ResNet's convolutions and head from its own layers; the peak table holds
the cards this port has run on, keyed by ``torch.cuda.get_device_name()``,
and ``EDL_TPU_PEAK_TFLOPS`` overrides it (as in the JAX package: the only
way to an MFU on the CPU or an unknown card).

The trainer's live ``edl_mfu`` takes its FLOPs from these analytic counts,
as the JAX bench does (``edl_tpu/bench.py:_bench_lm``), not from a compiled
program's cost analysis (the JAX trainer's ``xla_cost_flops``): the port has
no XLA, and a FLOP counter over PyTorch's dispatcher cannot see the
attention kernels launched through ctypes.
"""

from __future__ import annotations

import math
import os

# bf16 dense tensor-core peak, TFLOP/s, from NVIDIA's data sheet (SXM
# part, at its full 700 W power limit)
PEAK_TFLOPS = {
    "NVIDIA H100 80GB HBM3": 989.0,
}


def peak_tflops(device_name: str) -> float | None:
    """Known bf16 peak for a device name (longest match wins), or None.
    ``EDL_TPU_PEAK_TFLOPS`` overrides unconditionally; a malformed value
    gives None (no MFU), never a crash."""
    env = os.environ.get("EDL_TPU_PEAK_TFLOPS")
    if env:
        try:
            return float(env)
        except ValueError:
            return None
    best = None
    for name, peak in PEAK_TFLOPS.items():
        if name in device_name and (best is None or len(name) > len(best[0])):
            best = (name, peak)
    return best[1] if best else None


def analytic_lm_flops_per_token(num_layers: int, embed_dim: int,
                                mlp_dim: int, vocab_size: int,
                                seq: int) -> float:
    """Analytic train FLOPs per token for the decoder-only transformer:
    6·N for the matmul params (embed table excluded — lookup, not
    matmul; lm_head kept — it IS a matmul) + causal-attention
    6·layers·seq·d_model."""
    n_matmul = (num_layers * (4 * embed_dim ** 2           # qkv + out proj
                              + 3 * embed_dim * mlp_dim)   # swiglu mlp
                + embed_dim * vocab_size)                  # lm head
    return float(6 * n_matmul + 6 * num_layers * seq * embed_dim)


def analytic_resnet_flops_per_image(model, image_size: int) -> float:
    """Analytic train FLOPs per ``image_size``² image of a
    ``models.resnet.ResNet``: 3 x the forward, which is the sum over every
    conv and the head of ``2 * Ho * Wo * Cin * Cout * k²`` (SAME convs give
    ``ceil(n / stride)``; the max pool halves, rounding up; a vd shortcut's
    average pool halves, rounding down).  BN, ReLU, pooling and the residual
    adds are not counted.  ResNet50 (width 64, 1000 classes) at 224:
    4,089,184,256 multiply-adds a forward, 24,535,105,536 train FLOPs."""
    from edl_tpu_torch.models.resnet import BottleneckBlock

    def conv(layer, n: int) -> tuple[int, int]:
        cout, cin, k, _ = layer.weight.shape
        out = math.ceil(n / layer.stride)
        return 2 * out * out * cin * cout * k * k, out

    total, n = 0, image_size
    for stem in (("stem1", "stem2", "stem3") if model.vd else ("stem",)):
        flops, n = conv(getattr(model, stem), n)
        total += flops
    n = math.ceil(n / 2)
    for block in model.blocks():
        convs = (("conv1", "conv2", "conv3") if isinstance(block, BottleneckBlock)
                 else ("conv1", "conv2"))
        m = n
        for name in convs:
            flops, m = conv(getattr(block, name), m)
            total += flops
        if block.conv_shortcut is not None:
            pooled = getattr(block, "vd", False) and block.strides != 1
            total += conv(block.conv_shortcut, n // 2 if pooled else n)[0]
        n = m
    total += 2 * model.head.weight.numel()
    return float(3 * total)
