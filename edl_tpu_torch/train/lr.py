"""Learning-rate schedules and the world-derived LR rescale (the port of
the JAX package's ``train/lr.py``).

- :func:`world_scaled` / :func:`rescale_state`: one scalar ``lr_scale``
  that multiplies the effective learning rate, kept in the optimizer's
  param groups, so it is in ``optimizer.state_dict()``: it rides every
  checkpoint, and repeated resizes compound (4 -> 8 -> 4 pods lands on
  1.0).  JAX multiplies optax's final update by the scale; torch's
  AdamW (and SGD, Adam) scale decay and step by ``lr`` alike, so scaling
  ``lr`` for the step is the same function.
- :func:`scale_lr_for_batch`: the linear rule ``lr = base * batch / 256``.
- :func:`cosine_warmup` / :func:`piecewise_decay`: ``step -> lr``
  functions, numerically optax's schedules; the port's
  :func:`edl_tpu_torch.train.state.adamw` takes one as its ``lr``.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from edl_tpu_torch.train.state import OptimizerFactory

Schedule = Callable[[int], float]

# the param-group key of the world scale
SCALE_KEY = "lr_scale"


def world_scaled(tx: OptimizerFactory) -> OptimizerFactory:
    """Wrap the factory ``tx`` so the effective learning rate can be
    rescaled on a world-size change without rebuilding the optimizer
    (``EDL_TPU_LR_RESCALE``).  Each step runs at ``lr * lr_scale``; the
    groups' ``lr`` (a schedule's, say) is restored after it."""
    def make(params):
        opt = tx(params)
        for group in opt.param_groups:
            group.setdefault(SCALE_KEY, 1.0)
        unscaled: list[float] = []

        def restore(*_):
            for group, lr in zip(opt.param_groups, unscaled):
                group["lr"] = lr
            unscaled.clear()

        def scale(*_):
            restore()          # a step that raised left its scaled lr behind
            unscaled.extend(group["lr"] for group in opt.param_groups)
            for group in opt.param_groups:
                group["lr"] = group["lr"] * group.get(SCALE_KEY, 1.0)

        opt.register_step_pre_hook(scale)
        opt.register_step_post_hook(restore)
        return opt

    return make


def _optimizer(state) -> torch.optim.Optimizer:
    return state if isinstance(state, torch.optim.Optimizer) else state.optimizer


def rescale_state(state, factor: float):
    """Multiply the world scale of ``state`` (a TrainState or an
    optimizer) by ``factor``, in place; returns ``state``.  Called at
    restore with ``new_world / old_world``.  A no-op for an optimizer
    not built through :func:`world_scaled`."""
    for group in _optimizer(state).param_groups:
        if SCALE_KEY in group:
            group[SCALE_KEY] = group[SCALE_KEY] * float(factor)
    return state


def lr_scale(state) -> float:
    """The world scale of ``state`` (1.0 for an unwrapped optimizer)."""
    return float(_optimizer(state).param_groups[0].get(SCALE_KEY, 1.0))


def scale_lr_for_batch(base_lr: float, global_batch: int,
                       base_batch: int = 256) -> float:
    """Linear-scaling rule: ``lr = base_lr * global_batch / base_batch``,
    so adding pods speeds training up without retuning; on a resize,
    recompute it with the new global batch."""
    return base_lr * global_batch / base_batch


def _cosine_decay(init_value: float, decay_steps: int, alpha: float) -> Schedule:
    """optax.cosine_decay_schedule."""
    def schedule(count: int) -> float:
        frac = min(count, decay_steps) / decay_steps
        return init_value * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * frac)) + alpha)
    return schedule


def _linear(init_value: float, end_value: float, steps: int) -> Schedule:
    """optax.linear_schedule."""
    def schedule(count: int) -> float:
        frac = 1 - min(max(count, 0), steps) / steps
        return (init_value - end_value) * frac + end_value
    return schedule


def _join(schedules: list[Schedule], boundaries: list[int]) -> Schedule:
    """optax.join_schedules: each later schedule restarts its count."""
    def schedule(count: int) -> float:
        out = schedules[0](count)
        for boundary, later in zip(boundaries, schedules[1:]):
            if count >= boundary:
                out = later(count - boundary)
        return out
    return schedule


def _piecewise_constant(init_value: float, scales: dict[int, float]) -> Schedule:
    """optax.piecewise_constant_schedule."""
    def schedule(count: int) -> float:
        v = init_value
        for boundary, s in scales.items():
            if count >= boundary:
                v *= s
        return v
    return schedule


def cosine_warmup(base_lr: float, total_steps: int, warmup_steps: int = 0,
                  end_lr: float = 0.0) -> Schedule:
    """Cosine decay with linear warmup."""
    if warmup_steps <= 0:
        return _cosine_decay(base_lr, max(1, total_steps), end_lr / max(base_lr, 1e-12))
    decay_steps = max(total_steps, warmup_steps + 1)
    return _join([_linear(0.0, base_lr, warmup_steps),
                  _cosine_decay(base_lr, decay_steps - warmup_steps, end_lr / base_lr)],
                 [warmup_steps])


def piecewise_decay(base_lr: float, boundaries: list[int], gamma: float = 0.1,
                    warmup_steps: int = 0) -> Schedule:
    """Step decay by ``gamma`` at global-step ``boundaries``, optional
    linear warmup.  The post-warmup schedule's count restarts at zero,
    so its boundaries are pre-shifted to stay global."""
    if warmup_steps <= 0:
        return _piecewise_constant(base_lr, {b: gamma for b in boundaries})
    sched = _piecewise_constant(base_lr, {max(1, b - warmup_steps): gamma for b in boundaries})
    return _join([_linear(0.0, base_lr, warmup_steps), sched], [warmup_steps])
