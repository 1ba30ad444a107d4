"""Logical axes of a module's parameters.

The port of the JAX package's ``models/logical.py``: given regex rules
over a parameter's name (``"layers.3.attn_qkv.weight"``), give the logical
axes tuple that :func:`edl_tpu_torch.parallel.sharding.shard_init` consumes.
A rule's tuple is in the torch tensor's own dim order: a torch weight is
``[out, in]``, the transpose of a flax kernel.  Layers are not stacked, so
no rule carries a ``"layers"`` axis.
"""

from __future__ import annotations

import re

import torch


def logical_axes_from_paths(module: torch.nn.Module, rules: list[tuple[str, tuple]],
                            default: tuple | None = None) -> dict[str, tuple]:
    """``{parameter name: axes}``: the axes of the first rule whose regex
    matches the name; unmatched parameters get ``default`` (None: fully
    replicated).  A rule's axes tuple must have one entry per tensor dim."""
    compiled = [(re.compile(pat), axes) for pat, axes in rules]
    out = {}
    for name, p in module.named_parameters():
        for pat, axes in compiled:
            if pat.search(name):
                if len(axes) != p.ndim:
                    raise ValueError(f"rule {pat.pattern} gives {len(axes)} axes for "
                                     f"{name} with ndim {p.ndim}")
                out[name] = axes
                break
        else:
            out[name] = default if default is not None else (None,) * p.ndim
    return out
