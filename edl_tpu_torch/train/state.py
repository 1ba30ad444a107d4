"""TrainState: the module, its optimizer, the step counter and any extra
state a step carries.

The port of the JAX package's ``train/state.py``.  JAX's state is an
immutable pytree that each step replaces; here the module's parameters
and the optimizer's moments are updated in place by ``optimizer.step()``
(no second copy of either is ever held), and ``step`` counts the applied
updates.  Step-level resume metadata (epochs, data checkpoint, world
size) is not here: it is :class:`edl_tpu_torch.cluster.state.State`, the
checkpoint's JSON sidecar.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Iterable

import torch

# the resume-metadata types, so train code has one import home
from edl_tpu_torch.cluster.state import (  # noqa: F401
    AdjustRegistry, DataCheckpoint, EpochAttr, State,
)

# builds an optimizer over the given parameters (the role of an optax
# GradientTransformation)
OptimizerFactory = Callable[[Iterable[torch.nn.Parameter]], torch.optim.Optimizer]


def adamw(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 1e-4) -> OptimizerFactory:
    """AdamW with ``optax.adamw``'s defaults, decaying every parameter.
    (``torch.optim.AdamW`` itself defaults to ``weight_decay=1e-2``.)"""
    def make(params):
        return torch.optim.AdamW(params, lr=lr, betas=(b1, b2), eps=eps,
                                 weight_decay=weight_decay)
    return make


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    extra: Any = None            # state a step threads through (None for the LM)

    @classmethod
    def create(cls, model: torch.nn.Module, tx: OptimizerFactory,
               extra: Any = None) -> "TrainState":
        return cls(model=model, optimizer=tx(model.parameters()), extra=extra)

    def apply_gradients(self, extra: Any = None) -> "TrainState":
        """Apply the gradients held in the parameters' ``.grad``."""
        self.optimizer.step()
        self.step += 1
        if extra is not None:
            self.extra = extra
        return self

    def state_dict(self) -> dict[str, Any]:
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "step": self.step, "extra": self.extra}

    def load_state_dict(self, sd: dict[str, Any]) -> None:
        self.model.load_state_dict(sd["model"])
        self.optimizer.load_state_dict(sd["optimizer"])
        self.step = int(sd["step"])
        self.extra = sd["extra"]
