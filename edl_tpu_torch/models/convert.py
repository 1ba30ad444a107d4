"""Carry ``TransformerLM`` weights between the flax tree and the PyTorch
state dict.

The flax tree follows the JAX package's ``LOGICAL_RULES`` paths:
``tok_embed/embedding`` ``[V, D]``; per layer ``attn_norm/scale``,
``attn_qkv/kernel`` ``[D, (H + 2Hk) Dh]`` (one fused kernel, columns
q | k | v), ``attn_out/kernel`` ``[H Dh, D]``, ``mlp_norm/scale``,
``mlp_gate/kernel`` and ``mlp_in/kernel`` ``[D, M]``, ``mlp_out/kernel``
``[M, D]``; ``final_norm/scale``; ``lm_head/kernel`` ``[D, V]`` unless the
embeddings are tied.  The layers come either stacked (``layers/...`` with
a leading ``num_layers`` dim, as training writes them) or split
(``layer_<i>/...``, as generation uses them).  A flax ``Dense`` kernel is
``[in, out]`` and a PyTorch weight ``[out, in]``, so kernels are
transposed; the fused q|k|v kernel keeps its column order as the row order
of ``attn_qkv.weight``, and the model splits its output the same way.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from edl_tpu_torch.models.transformer import TransformerConfig

# per-layer flax module -> (param name, transposed?)
_LAYER_PARAMS = {
    "attn_norm": ("scale", False),
    "attn_qkv": ("kernel", True),
    "attn_out": ("kernel", True),
    "mlp_norm": ("scale", False),
    "mlp_gate": ("kernel", True),
    "mlp_in": ("kernel", True),
    "mlp_out": ("kernel", True),
}


def _torch_name(param: str) -> str:
    return "scale" if param == "scale" else "weight"


def _tensor(a, transpose: bool) -> torch.Tensor:
    a = np.asarray(a, dtype=np.float32)
    return torch.from_numpy(np.array(a.T if transpose else a, order="C"))


def params_from_jax(tree: dict[str, Any], cfg: TransformerConfig) -> dict[str, torch.Tensor]:
    """A ``TransformerLM`` state dict (f32 CPU tensors) from a flax params
    tree of numpy arrays, stacked or split."""
    if cfg.moe_experts:
        raise NotImplementedError("MoE weights are not ported yet "
                                  "(ROADMAP.md, Queue 1, item 7)")
    if set(tree) == {"params"}:
        tree = tree["params"]
    sd = {"tok_embed.weight": _tensor(tree["tok_embed"]["embedding"], False)}
    stacked = "layers" in tree
    for i in range(cfg.num_layers):
        for mod, (param, transpose) in _LAYER_PARAMS.items():
            leaf = tree["layers"][mod][param][i] if stacked else tree[f"layer_{i}"][mod][param]
            sd[f"layers.{i}.{mod}.{_torch_name(param)}"] = _tensor(leaf, transpose)
    sd["final_norm.scale"] = _tensor(tree["final_norm"]["scale"], False)
    if not cfg.tie_embeddings:
        sd["lm_head.weight"] = _tensor(tree["lm_head"]["kernel"], True)
    return sd


def params_to_jax(state_dict: dict[str, torch.Tensor], cfg: TransformerConfig,
                  stacked: bool = True) -> dict[str, Any]:
    """The flax params tree (numpy f32) of a ``TransformerLM`` state dict:
    ``layers/...`` stacked over a leading ``num_layers`` dim, or
    ``layer_<i>/...`` with ``stacked=False``."""
    if cfg.moe_experts:
        raise NotImplementedError("MoE weights are not ported yet "
                                  "(ROADMAP.md, Queue 1, item 7)")

    def arr(name: str, transpose: bool) -> np.ndarray:
        a = state_dict[name].detach().to("cpu", torch.float32).numpy()
        return np.ascontiguousarray(a.T if transpose else a)

    tree: dict[str, Any] = {"tok_embed": {"embedding": arr("tok_embed.weight", False)}}
    per_layer = [
        {mod: {param: arr(f"layers.{i}.{mod}.{_torch_name(param)}", transpose)}
         for mod, (param, transpose) in _LAYER_PARAMS.items()}
        for i in range(cfg.num_layers)]
    if stacked:
        tree["layers"] = {mod: {param: np.stack([layer[mod][param] for layer in per_layer])}
                          for mod, (param, _) in _LAYER_PARAMS.items()}
    else:
        for i, layer in enumerate(per_layer):
            tree[f"layer_{i}"] = layer
    tree["final_norm"] = {"scale": arr("final_norm.scale", False)}
    if not cfg.tie_embeddings:
        tree["lm_head"] = {"kernel": arr("lm_head.weight", True)}
    return tree
