"""The ``ClipConfig`` fields that the ported slices read.

A copy of the JAX package's ``configs/clip.py`` and ``configs/base.py``
restricted to what the towers, the server and the contrastive train step
use, with the same
names and defaults so a config dict means the same thing on both sides.
Keys this class does not know are kept in ``extra()``, as there. YAML
parsing is not part of the port yet.
"""

from __future__ import annotations

import dataclasses
import typing
from dataclasses import dataclass, field, fields
from typing import Any, Dict, List, Optional


def _coerce(value: Any, ftype: Any) -> Any:
    """Best-effort coercion of dict/CLI values to the dataclass field type."""
    if value is None:
        return None
    origin = typing.get_origin(ftype)
    if origin is typing.Union:  # Optional[...]
        args = [a for a in typing.get_args(ftype) if a is not type(None)]
        return _coerce(value, args[0]) if len(args) == 1 else value
    if origin in (list, typing.List):
        (inner,) = typing.get_args(ftype) or (str,)
        if isinstance(value, str):
            value = [v for v in value.strip("[]").split(",") if v != ""]
        return [_coerce(v, inner) for v in value]
    if ftype is bool:
        if isinstance(value, bool):
            return value
        return str(value).lower() in ("1", "true", "t", "yes", "y")
    if ftype in (int, float, str):
        return ftype(value)
    return value


@dataclass
class ClipConfig:
    # ---- run ----
    epochs: int = 10
    # ---- data ----
    frames: int = 16
    resize: int = 224
    batch_size: int = 8
    multi_video: bool = False
    num_videos: int = 1
    max_text_length: int = 512
    data_mean: Optional[List[float]] = None
    data_std: Optional[List[float]] = None
    dataset_mean: Optional[List[float]] = None
    dataset_std: Optional[List[float]] = None
    # ---- model ----
    model_name: str = "mvit"
    aggregate_videos_tokens: bool = True
    per_video_pool: bool = False
    num_heads: int = 8
    aggregator_depth: int = 2
    dropout: float = 0.1
    use_cls_token: bool = False
    pooling_mode: str = "mean"  # mean | attention | cls_token
    embedding_dim: int = 512
    # ---- optimization ----
    optimizer: str = "AdamW"
    scheduler_name: str = "cosine"
    lr: float = 1e-4
    text_lr: float = 2e-5
    lr_step_period: int = 20
    factor: float = 0.3
    loss_name: str = "contrastive"
    video_weight_decay: float = 1e-5
    text_weight_decay: float = 1e-7
    gradient_accumulation_steps: int = 1
    num_warmup_percent: float = 0.1
    num_hard_restarts_cycles: float = 1.0
    warm_restart_tmult: int = 2
    max_grad_norm: float = 1.0
    video_max_grad_norm: Optional[float] = None
    text_max_grad_norm: Optional[float] = None
    temperature: float = 0.07
    label_smoothing: float = 0.0
    siglip_bias_init: float = -10.0
    # ---- accelerator knobs ----
    precision: str = "bf16"  # bf16 | fp32 compute (params always fp32)
    use_pallas_attention: bool = True  # here: the hand-written CUDA kernels
    vit_dim: int = 512
    vit_depth: int = 12
    vit_heads: int = 4
    vit_patch: List[int] = field(default_factory=lambda: [2, 16, 16])
    vit_pool_stages: List[int] = field(default_factory=list)
    rope_temporal_scale: float = 1.0
    text_vocab_size: int = 30522
    text_dim: int = 768
    text_depth: int = 12
    text_heads: int = 12

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ClipConfig":
        hints = typing.get_type_hints(cls)
        known = {f.name for f in fields(cls)}
        obj = cls(**{k: _coerce(v, hints[k]) for k, v in d.items() if k in known})
        object.__setattr__(obj, "_extra",
                           {k: v for k, v in d.items() if k not in known})
        return obj

    def extra(self) -> Dict[str, Any]:
        if not hasattr(self, "_extra"):
            object.__setattr__(self, "_extra", {})
        return self._extra

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d.update(self.extra())
        return d
