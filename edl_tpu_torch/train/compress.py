"""Deep Gradient Compression (DGC) in the port's optimizer idiom.

The port of the JAX package's ``train/compress.py``, where DGC is an optax
gradient transformation chained as ``add_decayed_weights(wd)``, ``dgc``,
then a momentum-free ``sgd`` (``examples/collective/train_resnet.py``);
here the chain is one ``torch.optim.Optimizer`` (:class:`DGC`, built by the
:func:`dgc` factory), whose per-parameter state holds ``residual`` (the
unsent accumulation) and ``momentum`` (the local momentum-correction
buffer), and whose param groups hold the step count, so the whole rides
``optimizer.state_dict()`` into checkpoints and the peer cache.

Per parameter, each step, JAX's arithmetic line for line (Lin et al.
2018):

- the gradient takes the coupled weight decay first, ``g + wd * p``, so the
  decay enters the accumulation;
- momentum correction: ``vel = m * mom + g``, ``acc = res + vel``;
- a static ``k = max(1, int(size * (1 - sparsity)))`` per leaf, ``kth`` the
  k-th largest ``|acc|``; the rampup (``rampup_steps``: the sparsity
  annealed linearly from 0) scales the threshold, ``thr = kth * eff /
  sparsity``, not ``k``;
- sent where ``|acc| >= thr`` (every tie at ``kth`` is sent); the residual
  is the rest, and the momentum is zeroed where sent;
- a leaf under ``min_size`` entries passes dense, momentum applied;
- then SGD without momentum: ``p - lr(count) * sent``.

The threshold is computed in f32 in JAX's order (``(kth * eff) / sparsity``
with ``eff = f32(sparsity) * f32(frac)``), so the set sent is JAX's.  The
sent update stays dense: the gradient all-reduce before it is the
trainer's, as in JAX.
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch


class DGC(torch.optim.Optimizer):
    """Coupled weight decay, DGC and momentum-free SGD (see the module
    docstring).  ``lr`` is the rate of the current step; :func:`dgc` sets
    it from a schedule before each step.  ``count`` in each param group is
    the number of steps applied."""

    def __init__(self, params: Iterable[torch.nn.Parameter], lr: float, sparsity: float = 0.99,
                 momentum: float = 0.9, rampup_steps: int = 0, min_size: int = 129,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, sparsity=sparsity, momentum=momentum,
                                      rampup_steps=rampup_steps, min_size=min_size,
                                      weight_decay=weight_decay, count=0))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            sparsity = group["sparsity"]
            eff = _effective_sparsity(sparsity, group["rampup_steps"], group["count"] + 1)
            ratio = (eff, torch.tensor(max(sparsity, 1e-9), dtype=torch.float32))
            on = {}
            for p in group["params"]:
                if p.grad is None:
                    continue
                if p.device not in on:
                    on[p.device] = tuple(t.to(p.device) for t in ratio)
                sent = self._compress(p, group, *on[p.device])
                p.add_(sent.mul(-group["lr"]))
            group["count"] += 1
        return loss

    def _compress(self, p, group, eff: torch.Tensor, denom: torch.Tensor) -> torch.Tensor:
        """This step's sent update of ``p``; its residual and momentum
        updated in place (``eff`` and ``denom``: the annealed and the full
        sparsity, 0-d f32 on ``p``'s device)."""
        g = p.grad
        wd = group["weight_decay"]
        if wd:
            g = g + p.mul(wd)
        st = self.state[p]
        if not st:
            st["residual"] = torch.zeros_like(p)
            st["momentum"] = torch.zeros_like(p)
        vel = st["momentum"].mul(group["momentum"]).add_(g)
        if g.numel() < group["min_size"]:
            st["residual"].zero_()
            st["momentum"].copy_(vel)
            return vel
        sparsity = group["sparsity"]
        acc = st["residual"].add(vel)
        mag = acc.abs()
        k = max(1, int(g.numel() * (1.0 - sparsity)))
        kth = torch.topk(mag.reshape(-1), k, sorted=True).values[-1]
        thr = kth * eff / denom
        mask = (mag >= thr).to(g.dtype)
        keep = 1 - mask
        st["residual"].copy_(acc * keep)
        st["momentum"].copy_(vel * keep)
        return acc * mask


def _effective_sparsity(sparsity: float, rampup_steps: int, step: int) -> torch.Tensor:
    """The step's annealed sparsity as a 0-d f32 tensor, JAX's rounding:
    ``f32(sparsity) * min(f32(step) / f32(rampup_steps), 1)``."""
    s = torch.tensor(sparsity, dtype=torch.float32)
    if rampup_steps <= 0:
        return s
    frac = torch.tensor(step, dtype=torch.float32) / torch.tensor(rampup_steps,
                                                                  dtype=torch.float32)
    return s * torch.minimum(frac, torch.ones((), dtype=torch.float32))


def dgc(lr: float | Callable[[int], float], sparsity: float = 0.99, momentum: float = 0.9,
        rampup_steps: int = 0, min_size: int = 129, weight_decay: float = 0.0):
    """The factory (``train/state.py:OptimizerFactory``) of the JAX chain
    ``optax.chain(add_decayed_weights(weight_decay), dgc(sparsity,
    momentum, rampup_steps, min_size), sgd(lr))``.  ``lr`` may be a
    schedule, ``count -> lr``, read before each step at the number of steps
    already taken, as optax does."""
    def make(params):
        opt = DGC(params, lr=lr(0) if callable(lr) else lr, sparsity=sparsity,
                  momentum=momentum, rampup_steps=rampup_steps, min_size=min_size,
                  weight_decay=weight_decay)
        if callable(lr):
            def schedule(*_):
                for group in opt.param_groups:
                    group["lr"] = float(lr(group["count"]))
            opt.register_step_pre_hook(schedule)
        return opt
    return make
