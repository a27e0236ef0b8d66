"""Learning-rate schedules, keyed by the reference's scheduler names.

Port of the JAX package's ``train/schedulers.py`` (optax schedules) as plain
functions of the optimizer-update count. A schedule takes the count as a
Python number or as a tensor (then it computes on the tensor's device, with
no host synchronisation) and returns a 0-dim fp32 tensor.
"""

from __future__ import annotations

import math
from typing import Callable, List, Sequence

import torch

Schedule = Callable[[object], torch.Tensor]


def _count(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def _cosine_decay(lr: float, decay_steps: int) -> Schedule:
    """optax.cosine_decay_schedule with alpha 0, exponent 1."""
    if decay_steps <= 0:
        raise ValueError(f"cosine decay needs a positive horizon, got {decay_steps}")

    def sched(step):
        frac = _count(step).clamp(max=decay_steps) / decay_steps
        return lr * 0.5 * (1.0 + torch.cos(math.pi * frac))
    return sched


def _linear(init: float, end: float, steps: int) -> Schedule:
    """optax.linear_schedule (polynomial, power 1)."""
    def sched(step):
        frac = 1.0 - _count(step).clamp(0, steps) / steps
        return (init - end) * frac + end
    return sched


def _join(schedules: Sequence[Schedule], boundaries: Sequence[int]) -> Schedule:
    """optax.join_schedules: schedule i runs from boundary i-1, on the count
    less that boundary."""
    def sched(step):
        c = _count(step)
        out = schedules[0](c)
        for bound, s in zip(boundaries, schedules[1:]):
            out = torch.where(c < bound, out, s(c - bound))
        return out
    return sched


def get_scheduler(
    name: str,
    lr: float,
    steps_per_epoch: int,
    epochs: int,
    *,
    num_warmup_percent: float = 0.1,
    factor: float = 0.3,
    lr_step_period: int = 20,
    num_hard_restarts_cycles: float = 1.0,
    warm_restart_tmult: int = 2,
    gradient_accumulation_steps: int = 1,
    num_restarts: int = 10,
) -> Schedule:
    # every schedule is evaluated at the optimizer-update count (one per
    # accumulation window), so horizon and epoch length are in updates
    accum = max(1, gradient_accumulation_steps)
    updates_per_epoch = max(1, steps_per_epoch // accum)
    total = max(1, updates_per_epoch * epochs)
    warmup = max(1, int(total * num_warmup_percent))
    name = (name or "cosine").lower()

    if name == "cosine":
        return _cosine_decay(lr, total)

    if name == "step":
        def sched(step):
            epoch = torch.floor(_count(step) / updates_per_epoch)
            return lr * factor ** torch.floor(epoch / lr_step_period)
        return sched

    if name == "cosine_warm_restart":
        t0 = (max(1, total // max(1, num_restarts))
              if total > num_restarts else total)
        schedules: List[Schedule] = []
        boundaries: List[int] = []
        t, start = t0, 0
        while start < total:
            schedules.append(_cosine_decay(lr, t))
            start += t
            boundaries.append(start)
            t *= warm_restart_tmult
        return _join(schedules, boundaries[:-1])

    if name == "linear_warmup":
        return _join([_linear(0.0, lr, warmup),
                      _linear(lr, 0.0, max(1, total - warmup))], [warmup])

    if name == "cosine_with_warmup":
        # optax.warmup_cosine_decay_schedule: decay_steps counts the warm-up
        return _join([_linear(0.0, lr, warmup),
                      _cosine_decay(lr, total - warmup)], [warmup])

    if name == "cosine_with_hard_restarts_with_warmup":
        cycles = max(1, int(num_hard_restarts_cycles))
        body = max(1, total - warmup)
        per = max(1, body // cycles)
        cyc = [_cosine_decay(lr, per) for _ in range(cycles)]
        bounds = [warmup + per * (i + 1) for i in range(cycles - 1)]
        return _join([_linear(0.0, lr, warmup)] + cyc, [warmup] + bounds)

    raise ValueError(f"unknown scheduler_name {name!r}")
