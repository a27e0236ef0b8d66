"""Epoch-level schedules: temperature and encoder freeze ratios.

The port's copy of the JAX package's ``train/run_schedules.py`` (pure
Python): the temperature for an epoch (constant, linear, cosine or
exponential between ``temp_start`` and ``temp_end``, or -1.0 for the
learnable one) and the video/text freeze ratio for an epoch. Both feed the
train step as plain numbers.
"""

from __future__ import annotations

import math
from typing import Optional


def temperature_at(
    epoch: int,
    epochs: int,
    schedule: str = "learnable",
    temperature: float = 0.07,
    temp_start: Optional[float] = None,
    temp_end: Optional[float] = None,
) -> float:
    """Returns the pinned temperature for this epoch, or -1.0 for
    "learnable" (the train step treats <=0 as 'use the learnable param')."""
    if schedule in (None, "", "learnable"):
        return -1.0
    start = temp_start if temp_start is not None else temperature
    end = temp_end if temp_end is not None else temperature
    t = epoch / max(epochs - 1, 1)
    if schedule == "constant":
        return float(temperature)
    if schedule == "linear":
        return float(start + (end - start) * t)
    if schedule == "cosine":
        return float(end + (start - end) * 0.5 * (1 + math.cos(math.pi * t)))
    if schedule == "exponential":
        start = max(start, 1e-8)
        end = max(end, 1e-8)
        return float(start * (end / start) ** t)
    raise ValueError(f"unknown temperature schedule {schedule!r}")


def freeze_ratio_at(
    epoch: int,
    epochs: int,
    base_ratio: float,
    schedule: Optional[str] = None,
) -> float:
    """Freeze-ratio schedule: None/'constant' keeps the configured ratio;
    'linear_unfreeze' decays it to 0 over the run; 'linear_freeze' grows it
    from 0 (reference update_freeze_ratio, models/video_encoder.py:471-491)."""
    if schedule in (None, "", "constant"):
        return float(base_ratio)
    t = epoch / max(epochs - 1, 1)
    if schedule == "linear_unfreeze":
        return float(base_ratio * (1 - t))
    if schedule == "linear_freeze":
        return float(base_ratio * t)
    raise ValueError(f"unknown freeze schedule {schedule!r}")
