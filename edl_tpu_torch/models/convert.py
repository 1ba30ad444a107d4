"""Carry ``TransformerLM`` and ``ResNet`` weights between the flax tree and
the PyTorch state dict.

The flax tree follows the JAX package's ``LOGICAL_RULES`` paths:
``tok_embed/embedding`` ``[V, D]``; per layer ``attn_norm/scale``,
``attn_qkv/kernel`` ``[D, (H + 2Hk) Dh]`` (one fused kernel, columns
q | k | v), ``attn_out/kernel`` ``[H Dh, D]``, ``mlp_norm/scale``,
``mlp_gate/kernel`` and ``mlp_in/kernel`` ``[D, M]``, ``mlp_out/kernel``
``[M, D]`` (an MoE layer has instead ``moe/gate`` ``[D, E]``, ``moe/w_in``
``[E, D, M]`` and ``moe/w_out`` ``[E, M, D]``, the torch layouts too, so
they are not transposed); ``final_norm/scale``; ``lm_head/kernel`` ``[D, V]`` unless the
embeddings are tied.  The layers come either stacked (``layers/...`` with
a leading ``num_layers`` dim, as training writes them) or split
(``layer_<i>/...``, as generation uses them).  A flax ``Dense`` kernel is
``[in, out]`` and a PyTorch weight ``[out, in]``, so kernels are
transposed; the fused q|k|v kernel keeps its column order as the row order
of ``attn_qkv.weight``, and the model splits its output the same way.

A ResNet's names are flax's module paths joined by dots (``stem``,
``stage{i}_block{j}/conv1``, ``bn_shortcut``, ``head``, ...).  flax conv
kernels are HWIO and PyTorch's OIHW (``transpose(3, 2, 0, 1)``); the head's
``[in, out]`` kernel is transposed; a BN's ``scale`` and ``bias`` are the
module's ``weight`` and ``bias``, and its ``batch_stats`` ``mean`` and
``var`` the ``running_mean`` and ``running_var`` buffers.  Both directions
only permute, so a round trip is bit-identical.
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


# an MoE layer's FFN: flax leaf under "moe" -> torch name (same layout)
_MOE_PARAMS = ("gate", "w_in", "w_out")


def _layer_params(cfg: TransformerConfig) -> dict[str, tuple[str, bool]]:
    """The per-layer flax modules of ``cfg`` (the MLP's three, or none for
    an MoE layer, whose leaves are :data:`_MOE_PARAMS`)."""
    if not cfg.moe_experts:
        return _LAYER_PARAMS
    return {m: v for m, v in _LAYER_PARAMS.items() if not m.startswith("mlp_") or m == "mlp_norm"}


def _torch_name(param: str) -> str:
    return "scale" if param == "scale" else "weight"


def _tensor(a, transpose: bool) -> torch.Tensor:
    a = np.asarray(a, dtype=np.float32)
    return torch.from_numpy(np.array(a.T if transpose else a, order="C"))


def params_from_jax(tree: dict[str, Any], cfg: TransformerConfig) -> dict[str, torch.Tensor]:
    """A ``TransformerLM`` state dict (f32 CPU tensors) from a flax params
    tree of numpy arrays, stacked or split."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    sd = {"tok_embed.weight": _tensor(tree["tok_embed"]["embedding"], False)}
    stacked = "layers" in tree
    for i in range(cfg.num_layers):
        layer = tree["layers"] if stacked else tree[f"layer_{i}"]
        pick = (lambda a: a[i]) if stacked else (lambda a: a)
        for mod, (param, transpose) in _layer_params(cfg).items():
            sd[f"layers.{i}.{mod}.{_torch_name(param)}"] = _tensor(pick(layer[mod][param]),
                                                                  transpose)
        if cfg.moe_experts:
            for param in _MOE_PARAMS:
                sd[f"layers.{i}.moe.{param}"] = _tensor(pick(layer["moe"][param]), False)
    sd["final_norm.scale"] = _tensor(tree["final_norm"]["scale"], False)
    if not cfg.tie_embeddings:
        sd["lm_head.weight"] = _tensor(tree["lm_head"]["kernel"], True)
    return sd


def params_to_jax(state_dict: dict[str, torch.Tensor], cfg: TransformerConfig,
                  stacked: bool = True) -> dict[str, Any]:
    """The flax params tree (numpy f32) of a ``TransformerLM`` state dict:
    ``layers/...`` stacked over a leading ``num_layers`` dim, or
    ``layer_<i>/...`` with ``stacked=False``."""
    def arr(name: str, transpose: bool) -> np.ndarray:
        a = state_dict[name].detach().to("cpu", torch.float32).numpy()
        return np.ascontiguousarray(a.T if transpose else a)

    tree: dict[str, Any] = {"tok_embed": {"embedding": arr("tok_embed.weight", False)}}
    per_layer = [
        {mod: {param: arr(f"layers.{i}.{mod}.{_torch_name(param)}", transpose)}
         for mod, (param, transpose) in _layer_params(cfg).items()}
        for i in range(cfg.num_layers)]
    if cfg.moe_experts:
        for i, layer in enumerate(per_layer):
            layer["moe"] = {p: arr(f"layers.{i}.moe.{p}", False) for p in _MOE_PARAMS}
    if stacked:
        tree["layers"] = {mod: {param: np.stack([layer[mod][param] for layer in per_layer])
                                for param in leaves}
                          for mod, leaves in per_layer[0].items()}
    else:
        for i, layer in enumerate(per_layer):
            tree[f"layer_{i}"] = layer
    tree["final_norm"] = {"scale": arr("final_norm.scale", False)}
    if not cfg.tie_embeddings:
        tree["lm_head"] = {"kernel": arr("lm_head.weight", True)}
    return tree


# ResNet: flax leaf name -> PyTorch name, by collection
_RESNET_PARAMS = {"kernel": "weight", "scale": "weight", "bias": "bias"}
_RESNET_STATS = {"mean": "running_mean", "var": "running_var"}


def _flat(tree: dict[str, Any], prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def resnet_from_jax(params: dict[str, Any], batch_stats: dict[str, Any]
                    ) -> dict[str, torch.Tensor]:
    """A ``ResNet`` state dict (f32 CPU tensors) from the flax ``params``
    and ``batch_stats`` trees."""
    sd = {}
    for path, leaf in _flat(params):
        mod, name = path.rsplit(".", 1)
        a = np.asarray(leaf, dtype=np.float32)
        if name == "kernel":
            a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
        sd[f"{mod}.{_RESNET_PARAMS[name]}"] = torch.from_numpy(np.array(a, order="C"))
    for path, leaf in _flat(batch_stats):
        mod, name = path.rsplit(".", 1)
        sd[f"{mod}.{_RESNET_STATS[name]}"] = torch.from_numpy(
            np.array(np.asarray(leaf, dtype=np.float32), order="C"))
    return sd


def resnet_to_jax(state_dict: dict[str, torch.Tensor]) -> tuple[dict[str, Any], dict[str, Any]]:
    """``(params, batch_stats)``, flax trees of numpy f32 arrays, of a
    ``ResNet`` state dict."""
    params: dict[str, Any] = {}
    stats: dict[str, Any] = {}
    for key, t in state_dict.items():
        mod, name = key.rsplit(".", 1)
        a = t.detach().to("cpu", torch.float32).numpy()
        if name in ("running_mean", "running_var"):
            tree, leaf = stats, "mean" if name == "running_mean" else "var"
        elif name == "bias":
            tree, leaf = params, "bias"
        elif a.ndim == 1:
            tree, leaf = params, "scale"
        else:
            tree, leaf = params, "kernel"
            a = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T
        node = tree
        for part in mod.split("."):
            node = node.setdefault(part, {})
        node[leaf] = np.ascontiguousarray(a)
    return params, stats
