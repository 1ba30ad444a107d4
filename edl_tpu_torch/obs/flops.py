"""FLOP accounting for MFU.

``analytic_lm_flops_per_token`` is a copy of the JAX package's
``obs/flops.py`` formula; the peak table holds the cards this port has
run on, keyed by ``torch.cuda.get_device_name()``.
"""

from __future__ import annotations

# bf16 dense tensor-core peak, TFLOP/s, from NVIDIA's data sheet (SXM
# part, at its full 700 W power limit)
PEAK_TFLOPS = {
    "NVIDIA H100 80GB HBM3": 989.0,
}


def peak_tflops(device_name: str) -> float | None:
    """Known bf16 peak for a device name (longest match wins), or None."""
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
