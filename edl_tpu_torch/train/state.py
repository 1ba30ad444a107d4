"""TrainState: the module, its optimizer, the step counter and any extra
state a step carries.

The port of the JAX package's ``train/state.py``.  JAX's state is an
immutable pytree that each step replaces; here the module's parameters
and the optimizer's moments are updated in place by ``optimizer.step()``
(no second copy of either is ever held), and ``step`` counts the applied
updates.  Step-level resume metadata (epochs, data checkpoint, world
size) is not here: it is :class:`edl_tpu_torch.cluster.state.State`, the
checkpoint's JSON sidecar.

A state whose module was placed on a mesh (``parallel/sharding.py:
shard_init``: ``param_layouts`` set) is sharded: each parameter is this
rank's piece (tp rows, an FSDP2 shard), and AdamW's two moments live with
it, built by the optimizer in the parameter's own placement.
:meth:`TrainState.full_state_dict` gathers the global leaves (collective)
and :meth:`TrainState.load_state_dict` takes global leaves and places them
on the current mesh, so a checkpoint does not depend on the mesh it was
written on.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Iterable

import torch

# the resume-metadata types, so train code has one import home
from edl_tpu_torch.cluster.state import (  # noqa: F401
    AdjustRegistry, DataCheckpoint, EpochAttr, State,
)

# builds an optimizer over the given parameters (the role of an optax
# GradientTransformation)
OptimizerFactory = Callable[[Iterable[torch.nn.Parameter]], torch.optim.Optimizer]


def adamw(lr: float | Callable[[int], float], b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4) -> OptimizerFactory:
    """AdamW with ``optax.adamw``'s defaults, decaying every parameter.
    (``torch.optim.AdamW`` itself defaults to ``weight_decay=1e-2``.)
    ``lr`` may be a schedule, ``count -> lr`` (``train/lr.py``), read
    before each step at the number of steps already taken, as optax does;
    that count is AdamW's own, so it rides the optimizer's state."""
    def make(params):
        opt = torch.optim.AdamW(params, lr=lr(0) if callable(lr) else lr, betas=(b1, b2),
                                eps=eps, weight_decay=weight_decay)
        if callable(lr):
            def schedule(*_):
                first = opt.state.get(opt.param_groups[0]["params"][0], {})
                count = int(first["step"]) if "step" in first else 0
                for group in opt.param_groups:
                    group["lr"] = float(lr(count))
            opt.register_step_pre_hook(schedule)
        return opt
    return make


def sgd(lr: float | Callable[[int], float], momentum: float = 0.9, nesterov: bool = True,
        weight_decay: float = 0.0) -> OptimizerFactory:
    """SGD with (Nesterov) momentum and coupled L2 weight decay: the JAX
    examples' ``optax.chain(add_decayed_weights(wd), sgd(lr, momentum,
    nesterov=True))``.  That chain adds ``wd * p`` to the gradient before
    the momentum trace, which is what ``torch.optim.SGD(weight_decay=wd)``
    computes, including the first step (torch's buffer starts at the
    decayed gradient, optax's trace at 0 plus it); a decoupled decay would
    compute something else.  ``lr`` may be a schedule, read before each
    step at the number of steps already taken, as optax does; the count
    lives in the param groups, so it rides the optimizer's state."""
    def make(params):
        opt = torch.optim.SGD(params, lr=lr(0) if callable(lr) else lr, momentum=momentum,
                              nesterov=nesterov, weight_decay=weight_decay)
        if callable(lr):
            for group in opt.param_groups:
                group["count"] = 0

            def schedule(*_):
                for group in opt.param_groups:
                    group["lr"] = float(lr(group["count"]))

            def count(*_):
                for group in opt.param_groups:
                    group["count"] += 1

            opt.register_step_pre_hook(schedule)
            opt.register_step_post_hook(count)
        return opt
    return make


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    extra: Any = None            # state a step threads through (None for the LM)
    # events of host copies in flight (memstate/shards.py) that the next
    # in-place optimizer update must wait for
    fences: list = field(default_factory=list, repr=False, compare=False)

    @classmethod
    def create(cls, model: torch.nn.Module, tx: OptimizerFactory,
               extra: Any = None) -> "TrainState":
        return cls(model=model, optimizer=tx(model.parameters()), extra=extra)

    def apply_gradients(self, extra: Any = None) -> "TrainState":
        """Apply the gradients held in the parameters' ``.grad``, once every
        host copy of the state in flight has read it."""
        for ev in self.fences:
            ev.wait()               # the current stream waits; the host does not
        self.fences.clear()
        self.optimizer.step()
        self.step += 1
        if extra is not None:
            self.extra = extra
        return self

    def state_dict(self) -> dict[str, Any]:
        """This rank's state (its own pieces when sharded)."""
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "step": self.step, "extra": self.extra}

    @property
    def sharded(self) -> bool:
        return getattr(self.model, "param_layouts", None) is not None

    def leaf_params(self) -> dict[str, tuple[torch.nn.Parameter, Any]]:
        """``{leaf path: (parameter, its LeafLayout)}`` of every sharded
        leaf, in :meth:`state_dict`'s paths (``model/<name>``,
        ``optimizer/state/<i>/<moment>``): the parameters and their
        moments (any optimizer state shaped like its parameter).  Empty
        when the state is not sharded."""
        if not self.sharded:
            return {}
        layouts = self.model.param_layouts
        named = dict(self.model.named_parameters())
        out = {f"model/{n}": (p, layouts[n]) for n, p in named.items()}
        name_of = {id(p): n for n, p in named.items()}
        params = [p for g in self.optimizer.param_groups for p in g["params"]]
        for i, p in enumerate(params):
            for k, v in self.optimizer.state.get(p, {}).items():
                if isinstance(v, torch.Tensor) and v.shape == p.shape and v.ndim:
                    out[f"optimizer/state/{i}/{k}"] = (p, layouts[name_of[id(p)]])
        return out

    def _map_sharded(self, sd: dict[str, Any], fn) -> dict[str, Any]:
        """``sd`` with ``fn(tensor, parameter, layout)`` applied to every
        sharded leaf (model parameters and their moments)."""
        layouts = self.model.param_layouts
        named = dict(self.model.named_parameters())
        model = {k: fn(v, named[k], layouts[k]) if k in named else v
                 for k, v in sd["model"].items()}
        params = [p for g in self.optimizer.param_groups for p in g["params"]]
        name_of = {id(p): n for n, p in named.items()}
        opt = dict(sd["optimizer"])
        opt["state"] = {}
        for i, st in sd["optimizer"]["state"].items():
            p = params[int(i)]
            lay = layouts[name_of[id(p)]]
            opt["state"][i] = {k: fn(v, p, lay) if isinstance(v, torch.Tensor) and v.ndim
                               and tuple(v.shape) in (tuple(p.shape), lay.gshape) else v
                               for k, v in st.items()}
        return {**sd, "model": model, "optimizer": opt}

    def full_state_dict(self) -> dict[str, Any]:
        """:meth:`state_dict` with every leaf global: collective over the
        mesh when the state is sharded (each rank then holds the whole)."""
        sd = self.state_dict()
        if not self.sharded:
            return sd
        from edl_tpu_torch.parallel.sharding import to_full
        tp, ep = self.model.tp, getattr(self.model, "ep", None)
        return self._map_sharded(sd, lambda t, _p, lay: to_full(t, lay, tp, ep))

    def global_shapes(self) -> dict[str, tuple[int, ...]]:
        """``{model state name: global shape}``."""
        if not self.sharded:
            return {n: tuple(t.shape) for n, t in self.model.state_dict().items()}
        layouts = self.model.param_layouts
        return {n: layouts[n].gshape if n in layouts else tuple(t.shape)
                for n, t in self.model.state_dict().items()}

    def load_state_dict(self, sd: dict[str, Any]) -> None:
        """Load a state dict of global leaves (a local one when the state is
        not sharded), placing each leaf on the current mesh."""
        if self.sharded:
            from edl_tpu_torch.parallel.sharding import from_full
            tp, ep = self.model.tp, getattr(self.model, "ep", None)
            sd = self._map_sharded(sd, lambda t, p, lay: from_full(t, p, lay, tp, ep))
        self.model.load_state_dict(sd["model"])
        self.optimizer.load_state_dict(sd["optimizer"])
        self.step = int(sd["step"])
        self.extra = sd["extra"]
