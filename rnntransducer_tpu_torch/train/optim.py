"""Optimizer and LR schedules (port of ``rnntransducer_tpu/train/optim.py``).

The schedules are plain functions of the optimizer's update count that
reproduce optax's formulas (``cosine_onecycle_schedule``,
``warmup_cosine_decay_schedule``, ``join_schedules`` of
``linear_schedule``s), including the ``(warmup + 0.5) / steps`` pct_start
that pins OneCycle's warmup to a whole number of steps.  optax evaluates a
schedule at the count BEFORE the update, so ``TrainState`` sets the lr to
``schedule(count)`` before ``optimizer.step()``.

``torch.optim.AdamW`` computes what ``optax.adamw`` does: the same moments
and bias corrections, eps 1e-8 added outside the square root, and decoupled
decay of every param by lr * weight_decay (torch decays before the Adam
step, optax adds wd * p to the update: the same p - lr (u + wd p)).
``torch.optim.SGD(momentum=0.9)`` is ``optax.sgd(momentum=0.9)``: both start
the trace at the first gradient.  adafactor and lion are not ported yet.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, List, Optional, Sequence

import torch

Schedule = Callable[[int], float]


def _warmup_steps(cfg) -> tuple:
    steps = max(cfg.max_steps, 2)
    return steps, min(max(int(steps * cfg.warmup_ratio), 1), steps - 1)


def _linear(init: float, end: float, transition: int) -> Schedule:
    """optax.linear_schedule."""
    if transition <= 0:
        return lambda count: init

    def schedule(count):
        frac = 1.0 - min(max(count, 0), transition) / transition
        return (init - end) * frac + end
    return schedule


def _join(schedules: Sequence[Schedule], boundaries: Sequence[int]) -> Schedule:
    """optax.join_schedules: each later schedule sees the steps since its
    boundary."""
    def schedule(count):
        out = schedules[0](count)
        for boundary, sched in zip(boundaries, schedules[1:]):
            if count >= boundary:
                out = sched(count - boundary)
        return out
    return schedule


def onecycle_schedule(cfg) -> Schedule:
    """optax.cosine_onecycle_schedule with the warmup pinned to a whole
    number of steps >= 1 (``optim.py:17-32`` of the JAX package)."""
    steps, warmup = _warmup_steps(cfg)
    init = cfg.learning_rate / cfg.div_factor
    bounds = [0, int((warmup + 0.5) / steps * steps), int(steps)]
    values = [init, init * cfg.div_factor,
              init * cfg.div_factor / (cfg.div_factor * cfg.final_div_factor)]

    def schedule(count):
        if count >= bounds[-1]:
            return values[-1]
        i = 0 if count < bounds[1] else 1
        pct = (count - bounds[i]) / (bounds[i + 1] - bounds[i])
        start, end = values[i], values[i + 1]
        return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1.0)
    return schedule


def make_schedule(cfg) -> Schedule:
    """LR schedule per ``cfg.lr_schedule``: onecycle | cosine | linear |
    constant, all warming up for ``warmup_ratio`` of the run."""
    kind = cfg.lr_schedule.lower()
    if kind == "onecycle":
        return onecycle_schedule(cfg)
    steps, warmup = _warmup_steps(cfg)
    lr = cfg.learning_rate
    ramp = _linear(lr / cfg.div_factor, lr, warmup)
    if kind == "cosine":
        decay = steps - warmup

        def cosine(count):
            count = min(count, decay)
            return lr * 0.5 * (1.0 + math.cos(math.pi * count / decay))
        return _join([ramp, cosine], [warmup])
    if kind == "linear":
        return _join([ramp, _linear(lr, 0.0, steps - warmup)], [warmup])
    if kind == "constant":
        return _join([ramp, lambda count: lr], [warmup])
    raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r} "
                     "(onecycle | cosine | linear | constant)")


def make_optimizer(cfg, params: Iterable[torch.nn.Parameter]) -> torch.optim.Optimizer:
    """The optimizer of ``cfg.optimizer`` over ``params``; its lr is set from
    the schedule before every step (see module docstring)."""
    kind = getattr(cfg, "optimizer", "adamw").lower()
    if kind == "adamw":
        return torch.optim.AdamW(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=cfg.weight_decay)
    if kind == "sgd":
        return torch.optim.SGD(params, lr=0.0, momentum=0.9)
    if kind in ("adafactor", "lion"):
        raise NotImplementedError(f"optimizer {kind!r} is not ported yet "
                                  "(adamw | sgd)")
    raise ValueError(f"unknown optimizer {cfg.optimizer!r} "
                     "(adamw | adafactor | lion | sgd)")


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float,
                        norm: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
    """optax.clip_by_global_norm: unchanged when the global norm is below
    ``max_norm``, else each tensor times max_norm / norm (no epsilon, unlike
    ``torch.nn.utils.clip_grad_norm_``)."""
    norm = global_norm(grads) if norm is None else norm
    keep = norm < max_norm
    return [torch.where(keep, g, g / norm.to(g.dtype) * max_norm) for g in grads]
