"""Seeding of the host generators and torch's.

The port's counterpart of the JAX package's ``utils/seed.py``: Python's
``random``, numpy's global generator and torch's (every device's). The
dropout masks of a run are drawn from a ``torch.Generator`` of their own,
seeded by the runner.
"""

from __future__ import annotations

import random

import numpy as np
import torch


def set_seed(seed: int) -> None:
    random.seed(seed)
    np.random.seed(seed % (2**32))
    torch.manual_seed(seed)

