"""Train state of the port (the JAX package's ``train/state.TrainState``
without its sharding helpers)."""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch


@dataclasses.dataclass
class TrainState:
    """``params`` is the flat training dict (``video_encoder.*``,
    ``text_encoder.*``, ``log_temp``, ``logit_bias``) whose tensors are the
    models' own parameters; a train step updates them, and ``opt_state``,
    in place."""

    step: int
    params: Dict[str, torch.Tensor]
    opt_state: dict
    # scalars tracked across the run (kept in checkpoints)
    best_val_loss: float = float("inf")
    best_epoch: int = -1

    def replace(self, **changes) -> "TrainState":
        return dataclasses.replace(self, **changes)
