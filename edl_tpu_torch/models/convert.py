"""Carry model weights between the flax tree and the PyTorch state dict:
``TransformerLM``, ``PipelinedLM``, ``ResNet`` and the small models
(``LinearRegression``, ``WideDeep``, ``MnistCNN``, the text models,
``VGG``).

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

The pipelined LM (``train_lm.PipelinedLM``, the JAX example's
``_PipelinedLM``): ``embed/embedding`` ``[V, D]`` is ``embed.weight``; the
stacked ``layers/<module>/<param>`` ``[N, ...]`` are ``layers.<module>.
<weight|scale>`` with the same leading dim, each kernel's last two dims
transposed; ``norm/scale`` is ``norm.scale``; ``head/kernel`` ``[D, V]`` is
``head.weight`` transposed.

A ResNet's names are flax's module paths joined by dots (``stem``,
``stage{i}_block{j}/conv1``, ``bn_shortcut``, ``head``, ...).  flax conv
kernels are HWIO and PyTorch's OIHW (``transpose(3, 2, 0, 1)``); the head's
``[in, out]`` kernel is transposed; a BN's ``scale`` and ``bias`` are the
module's ``weight`` and ``bias``, and its ``batch_stats`` ``mean`` and
``var`` the ``running_mean`` and ``running_var`` buffers.  The small
models name their modules as flax does too (``fc``, ``embed_{i}``,
``conv{i}_{j}``, ``attn_{i}.query``, ...) and map the same way
(:func:`module_from_jax`, :func:`module_to_jax`): a 1-D conv's LIO kernel
is the OIL weight, an ``embedding`` the ``weight`` as it is; a text
attention's ``DenseGeneral`` kernels are reshaped (:func:`text_from_jax`).
Every direction only permutes and reshapes, so a round trip is
bit-identical.
"""

from __future__ import annotations

import re
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


def pipelined_from_jax(tree: dict[str, Any], cfg: TransformerConfig) -> dict[str, torch.Tensor]:
    """A ``PipelinedLM`` state dict (f32 CPU tensors) from the JAX
    ``_PipelinedLM``'s flax params tree of numpy arrays."""
    if set(tree) == {"params"}:
        tree = tree["params"]

    def stacked(a, transpose):
        a = np.asarray(a, dtype=np.float32)
        return torch.from_numpy(np.array(np.swapaxes(a, -1, -2) if transpose else a, order="C"))

    sd = {"embed.weight": _tensor(tree["embed"]["embedding"], False)}
    for mod, (param, transpose) in _layer_params(cfg).items():
        sd[f"layers.{mod}.{_torch_name(param)}"] = stacked(tree["layers"][mod][param], transpose)
    sd["norm.scale"] = _tensor(tree["norm"]["scale"], False)
    sd["head.weight"] = _tensor(tree["head"]["kernel"], True)
    return sd


def pipelined_to_jax(state_dict: dict[str, torch.Tensor], cfg: TransformerConfig
                     ) -> dict[str, Any]:
    """The JAX ``_PipelinedLM``'s flax params tree (numpy f32) of a
    ``PipelinedLM`` state dict."""
    def arr(name: str, transpose: bool) -> np.ndarray:
        a = state_dict[name].detach().to("cpu", torch.float32).numpy()
        return np.ascontiguousarray(np.swapaxes(a, -1, -2) if transpose else a)

    return {"embed": {"embedding": arr("embed.weight", False)},
            "layers": {mod: {param: arr(f"layers.{mod}.{_torch_name(param)}", transpose)}
                       for mod, (param, transpose) in _layer_params(cfg).items()},
            "norm": {"scale": arr("norm.scale", False)},
            "head": {"kernel": arr("head.weight", True)}}


# flax leaf name -> PyTorch name, by collection
_PARAMS = {"kernel": "weight", "scale": "weight", "bias": "bias", "embedding": "weight"}
_STATS = {"mean": "running_mean", "var": "running_var"}
# a flax kernel's dims -> the PyTorch weight's: Dense [in, out] -> [out, in],
# a 1-D conv's LIO -> OIL, a 2-D conv's HWIO -> OIHW
_KERNEL_TO_TORCH = {2: (1, 0), 3: (2, 1, 0), 4: (3, 2, 0, 1)}
_KERNEL_TO_FLAX = {2: (1, 0), 3: (2, 1, 0), 4: (2, 3, 1, 0)}


def _flat(tree: dict[str, Any], prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def module_from_jax(params: dict[str, Any], batch_stats: dict[str, Any] | None = None
                    ) -> dict[str, torch.Tensor]:
    """A state dict (f32 CPU tensors) from flax ``params`` (and
    ``batch_stats``) trees of modules named as the PyTorch ones: a kernel is
    the ``weight`` with its dims permuted (``_KERNEL_TO_TORCH``), a
    ``scale`` or an ``embedding`` the ``weight`` as it is, a BN's ``mean``
    and ``var`` the ``running_mean`` and ``running_var`` buffers."""
    if set(params) == {"params"}:
        params = params["params"]
    sd = {}
    for path, leaf in _flat(params):
        mod, name = path.rsplit(".", 1)
        a = np.asarray(leaf, dtype=np.float32)
        if name == "kernel":
            a = a.transpose(_KERNEL_TO_TORCH[a.ndim])
        sd[f"{mod}.{_PARAMS[name]}"] = torch.from_numpy(np.array(a, order="C"))
    for path, leaf in _flat(batch_stats or {}):
        mod, name = path.rsplit(".", 1)
        sd[f"{mod}.{_STATS[name]}"] = torch.from_numpy(
            np.array(np.asarray(leaf, dtype=np.float32), order="C"))
    return sd


def module_to_jax(state_dict: dict[str, torch.Tensor], embeds: str = r"$^"
                  ) -> tuple[dict[str, Any], dict[str, Any]]:
    """``(params, batch_stats)``, flax trees of numpy f32 arrays, of a state
    dict (or any dict of its names: gradients, buffers): a ``weight`` is a
    ``scale`` when 1-D, an ``embedding`` when its module's name matches
    ``embeds`` (a regex), else a kernel."""
    params: dict[str, Any] = {}
    stats: dict[str, Any] = {}
    for key, t in state_dict.items():
        mod, name = key.rsplit(".", 1)
        a = t.detach().to("cpu", torch.float32).numpy()
        if name in ("running_mean", "running_var"):
            tree, leaf = stats, "mean" if name == "running_mean" else "var"
        elif name == "bias":
            tree, leaf = params, "bias"
        elif re.search(embeds, mod):
            tree, leaf = params, "embedding"
        elif a.ndim == 1:
            tree, leaf = params, "scale"
        else:
            tree, leaf = params, "kernel"
            a = a.transpose(_KERNEL_TO_FLAX[a.ndim])
        node = tree
        for part in mod.split("."):
            node = node.setdefault(part, {})
        node[leaf] = np.array(a, order="C")    # a copy: never a view of the module's memory
    return params, stats


def resnet_from_jax(params: dict[str, Any], batch_stats: dict[str, Any]
                    ) -> dict[str, torch.Tensor]:
    """A ``ResNet`` state dict (f32 CPU tensors) from the flax ``params``
    and ``batch_stats`` trees."""
    return module_from_jax(params, batch_stats)


def resnet_to_jax(state_dict: dict[str, torch.Tensor]) -> tuple[dict[str, Any], dict[str, Any]]:
    """``(params, batch_stats)``, flax trees of numpy f32 arrays, of a
    ``ResNet`` state dict."""
    return module_to_jax(state_dict)


# the small models (``models/{linear,wide_deep,mnist,text,vgg}.py``): module
# names are flax's, so each map is the generic one; the tables and
# embeddings are named here
_WIDE_DEEP_TABLES = r"^(embed|wide)_\d+$"
_TEXT_EMBEDS = r"^(embed|tok_embed|pos_embed)$"
_ATTENTION_IN = r"^attn_\d+\.(query|key|value)$"
_ATTENTION_OUT = r"^attn_\d+\.out$"


def linear_from_jax(params: dict[str, Any]) -> dict[str, torch.Tensor]:
    """A ``LinearRegression`` state dict from its flax params."""
    return module_from_jax(params)


def linear_to_jax(state_dict: dict[str, torch.Tensor]) -> dict[str, Any]:
    """The flax params of a ``LinearRegression`` state dict."""
    return module_to_jax(state_dict)[0]


def wide_deep_from_jax(params: dict[str, Any]) -> dict[str, torch.Tensor]:
    """A ``WideDeep`` state dict from its flax params (global tables)."""
    return module_from_jax(params)


def wide_deep_to_jax(state_dict: dict[str, torch.Tensor]) -> dict[str, Any]:
    """The flax params of a ``WideDeep`` state dict of global tables."""
    return module_to_jax(state_dict, _WIDE_DEEP_TABLES)[0]


def mnist_from_jax(params: dict[str, Any]) -> dict[str, torch.Tensor]:
    """An ``MnistCNN`` state dict from its flax params (``fc``'s kernel keeps
    its NHWC-flatten rows: the port flattens NHWC)."""
    return module_from_jax(params)


def mnist_to_jax(state_dict: dict[str, torch.Tensor]) -> dict[str, Any]:
    """The flax params of an ``MnistCNN`` state dict."""
    return module_to_jax(state_dict)[0]


def vgg_from_jax(params: dict[str, Any], batch_stats: dict[str, Any]
                 ) -> dict[str, torch.Tensor]:
    """A ``VGG`` state dict from its flax ``params`` and ``batch_stats``."""
    return module_from_jax(params, batch_stats)


def vgg_to_jax(state_dict: dict[str, torch.Tensor]) -> tuple[dict[str, Any], dict[str, Any]]:
    """``(params, batch_stats)`` of a ``VGG`` state dict."""
    return module_to_jax(state_dict)


def text_from_jax(params: dict[str, Any]) -> dict[str, torch.Tensor]:
    """A ``BowClassifier``, ``CnnClassifier`` or ``TextTransformer`` state
    dict from its flax params.  An attention's q, k and v ``DenseGeneral``
    kernels ``[D, H, Dh]`` become ``[H Dh, D]`` weights (biases ``[H, Dh]``
    flattened), its output kernel ``[H, Dh, D]`` a ``[D, H Dh]`` weight."""
    if set(params) == {"params"}:
        params = params["params"]
    flat = {}
    for path, leaf in _flat(params):
        mod, name = path.rsplit(".", 1)
        a = np.asarray(leaf, dtype=np.float32)
        if re.search(_ATTENTION_IN, mod):
            a = a.reshape(a.shape[0], -1) if name == "kernel" else a.reshape(-1)
        elif re.search(_ATTENTION_OUT, mod) and name == "kernel":
            a = a.reshape(-1, a.shape[-1])
        flat[path] = a
    tree: dict[str, Any] = {}
    for path, a in flat.items():
        node = tree
        *mods, leaf = path.split(".")
        for part in mods:
            node = node.setdefault(part, {})
        node[leaf] = a
    return module_from_jax(tree)


def text_to_jax(state_dict: dict[str, torch.Tensor], num_heads: int = 1) -> dict[str, Any]:
    """The flax params of a text model's state dict; ``num_heads``: a
    ``TextTransformer``'s, whose attention kernels get back their ``[D, H,
    Dh]`` and ``[H, Dh, D]`` shapes."""
    params = module_to_jax(state_dict, _TEXT_EMBEDS)[0]
    for path, a in list(_flat(params)):
        mod, name = path.rsplit(".", 1)
        if re.search(_ATTENTION_IN, mod):
            shape = (a.shape[0], num_heads, -1) if name == "kernel" else (num_heads, -1)
        elif re.search(_ATTENTION_OUT, mod) and name == "kernel":
            shape = (num_heads, -1, a.shape[-1])
        else:
            continue
        node = params
        for part in mod.split("."):
            node = node[part]
        node[name] = np.ascontiguousarray(a.reshape(shape))
    return params
