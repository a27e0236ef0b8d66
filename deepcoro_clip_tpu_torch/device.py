"""Device choice for the port's entry points: CUDA unless asked otherwise."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means the card. A CUDA device without CUDA raises: the
    entry points never fall back to the CPU on their own; pass
    ``device="cpu"`` to run there."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
