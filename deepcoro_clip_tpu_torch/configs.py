"""Configuration classes of the ported slices, and the YAML/CLI reader.

``ClipConfig`` is a copy of the JAX package's ``configs/clip.py`` and
``configs/base.py`` restricted to what the towers, the server and the
contrastive train step use. ``LinearProbingConfig`` and ``MultiviewConfig``
have every field of the JAX package's ``configs/linear_probing.py``,
``BaseConfig``'s included. Names and defaults are the same, so a config dict
or a shipped YAML means the same thing on both sides; keys a class does not
know are kept in ``extra()``, as there.

``parse_config`` reads ``--base_config file.yaml`` plus ``--field value``
overrides with the rules of the JAX package's ``configs/parser.py``: the
YAML's ``pipeline_project`` picks the class, every field is an optional
override, list overrides come as ``[a,b]`` or ``a,b``, dict overrides as a
YAML string. ``yaml`` is imported only there.
"""

from __future__ import annotations

import dataclasses
import typing
from dataclasses import dataclass, field, fields
from typing import Any, Dict, List, Optional, Sequence


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
    if origin in (dict, typing.Dict):
        return dict(value)
    if ftype is bool:
        if isinstance(value, bool):
            return value
        return str(value).lower() in ("1", "true", "t", "yes", "y")
    if ftype in (int, float, str):
        return ftype(value)
    return value


class _ConfigMethods:
    """``from_dict`` / ``update_with_args`` / ``extra`` / ``to_dict`` of the
    JAX package's ``BaseConfig``."""

    @classmethod
    def from_dict(cls, d: Dict[str, Any]):
        hints = typing.get_type_hints(cls)
        known = {f.name for f in fields(cls)}
        obj = cls(**{k: _coerce(v, hints[k]) for k, v in d.items() if k in known})
        object.__setattr__(obj, "_extra",
                           {k: v for k, v in d.items() if k not in known})
        return obj

    def update_with_args(self, overrides: Dict[str, Any]):
        """Apply overrides in place; None means "not given"."""
        hints = typing.get_type_hints(type(self))
        known = {f.name for f in fields(self)}
        for k, v in overrides.items():
            if v is None:
                continue
            if k in known:
                setattr(self, k, _coerce(v, hints[k]))
            else:
                self.extra()[k] = v
        return self

    def extra(self) -> Dict[str, Any]:
        if not hasattr(self, "_extra"):
            object.__setattr__(self, "_extra", {})
        return self._extra

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d.update(self.extra())
        return d


@dataclass
class ClipConfig(_ConfigMethods):
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
    # the (data, model) mesh the ring runs over (parallel/mesh.py)
    mesh_data: int = -1  # -1 = all devices / mesh_model
    mesh_model: int = 1
    # sequence parallelism: ring attention over the token axis in the video
    # backbone (parallel/ring_attention.py; active where the token count
    # divides by the ring-axis size)
    use_ring_attention: bool = False
    ring_axis: str = "model"


@dataclass
class BaseConfig(_ConfigMethods):
    """Fields shared by every pipeline (the JAX package's ``BaseConfig``)."""

    pipeline_project: str = "DeepCORO_clip"
    run_mode: str = "train"  # train | val | test | inference
    seed: int = 42
    epochs: int = 10
    num_workers: int = 2
    loader_backend: str = "thread"
    debug: bool = False
    period: int = 1
    log_layer_grad_norms: bool = False
    use_amp: bool = True
    output_dir: str = "outputs"
    base_checkpoint_path: str = "outputs"
    checkpoint: Optional[str] = None
    resume_training: bool = False
    init_from_checkpoint: Optional[str] = None
    name: str = "deepcoro_clip_tpu"
    project: str = "deepcoro_clip_tpu"
    entity: str = ""
    tag: str = ""
    use_wandb: bool = False
    mesh_data: int = -1
    mesh_model: int = 1
    wire_dtype: str = "uint8"
    patch_wire: bool = False
    mono_wire: bool = False
    is_ref_device: bool = True
    process_index: int = 0
    process_count: int = 1
    world_size: int = 1


@dataclass
class LinearProbingConfig(BaseConfig):
    # ---- data ----
    data_filename: str = "data/labels.csv"
    root: str = "."
    datapoint_loc_label: str = "FileName"
    split_column: str = "Split"
    frames: int = 16
    stride: int = 2
    resize: int = 224
    rand_augment: bool = False
    batch_size: int = 8
    multi_video: bool = True
    num_videos: int = 4
    groupby_column: str = "StudyInstanceUID"
    shuffle_videos: bool = True
    dataset_mean: Optional[List[float]] = None
    dataset_std: Optional[List[float]] = None
    # ---- heads ----
    head_structure: Dict[str, int] = field(default_factory=dict)  # head -> n_outputs
    loss_structure: Dict[str, str] = field(default_factory=dict)  # head -> loss name
    head_task: Dict[str, str] = field(default_factory=dict)
    head_lr: Dict[str, float] = field(default_factory=dict)
    head_weight_decay: Dict[str, float] = field(default_factory=dict)
    head_weights: Dict[str, float] = field(default_factory=dict)
    head_dropout: Dict[str, float] = field(default_factory=dict)
    labels_map: Dict[str, Dict[str, int]] = field(default_factory=dict)
    target_labels: List[str] = field(default_factory=list)
    # ---- MIL pooling ----
    pooling_mode: str = "attention"
    attention_hidden: int = 256
    dropout_attention: float = 0.0
    use_cls_token: bool = False
    normalization_strategy: str = "post_norm"  # pre_norm | post_norm
    separate_video_attention: bool = True
    attention_lr: Optional[float] = None
    attention_weight_decay: Optional[float] = None
    attention_within_lr: Optional[float] = None
    attention_across_lr: Optional[float] = None
    attention_within_weight_decay: Optional[float] = None
    attention_across_weight_decay: Optional[float] = None
    # ---- view embeddings ----
    use_view_embeddings: bool = False
    view_column: Optional[str] = None
    num_view_classes: int = 0
    view_embedding_lr: Optional[float] = None
    view_labels_map: Dict[str, int] = field(default_factory=dict)
    # ---- encoder ----
    model_name: str = "mvit"
    aggregate_videos_tokens: bool = False
    per_video_pool: bool = False
    video_encoder_checkpoint_path: Optional[str] = None
    video_freeze_ratio: float = 1.0
    dropout: float = 0.1
    num_heads: int = 8
    aggregator_depth: int = 2
    embedding_dim: int = 512
    hierarchical_tokens: bool = False  # [B, N, L, D] two-level pooling
    # ---- optimization ----
    optimizer: str = "AdamW"
    scheduler_name: str = "cosine"
    lr: float = 1e-3
    lr_step_period: int = 4
    factor: float = 0.3
    weight_decay: float = 1e-5
    gradient_accumulation_steps: int = 1
    num_warmup_percent: float = 0.1
    num_hard_restarts_cycles: float = 1.0
    warm_restart_tmult: int = 2
    max_grad_norm: float = 1.0
    # ---- eval ----
    ci_confidence_level: float = 0.95
    ci_n_bootstrap: int = 1000
    save_best: str = "loss"
    early_stopping_patience: Optional[int] = None
    # ---- inference ----
    inference_model_path: Optional[str] = None
    save_embeddings: bool = False
    split_filter: Optional[str] = None
    embedding_output_file: Optional[str] = None
    # ---- accelerator knobs ----
    precision: str = "bf16"
    use_pallas_attention: bool = True  # here: the hand-written CUDA kernels
    vit_dim: int = 512
    vit_depth: int = 12
    vit_heads: int = 4
    vit_patch: List[int] = field(default_factory=lambda: [2, 16, 16])
    vit_pool_stages: List[int] = field(default_factory=list)


@dataclass
class MultiviewConfig(LinearProbingConfig):
    """The legacy multiview YAMLs: the linear-probing pipeline under the old
    field names."""

    task: str = "classification"
    linear_probing_head: str = "linear"
    video_encoder_lr: Optional[float] = None  # legacy: the one encoder rate

    def __post_init__(self):
        if self.video_encoder_lr is not None:
            self.lr = float(self.video_encoder_lr)
        if self.pipeline_project.startswith("DeepCORO_Multiview"):
            self.pipeline_project = "DeepCORO_video_linear_probing"


# pipeline_project -> config class, for the pipelines that are ported
CONFIG_CLASSES = {
    "DeepCORO_clip": ClipConfig,
    "DeepCORO_video_linear_probing": LinearProbingConfig,
    "DeepCORO_Multiview": MultiviewConfig,
    "DeepCORO_Multiview_test": MultiviewConfig,
}


def _cli_type(ftype: Any):
    origin = typing.get_origin(ftype)
    if origin is typing.Union:
        args = [a for a in typing.get_args(ftype) if a is not type(None)]
        return _cli_type(args[0]) if len(args) == 1 else str
    if ftype in (int, float):
        return ftype
    return str  # bools, lists and dicts are coerced from their text later


def parse_config(argv: Optional[Sequence[str]] = None):
    """``--base_config file.yaml`` plus per-field overrides -> the config
    object of the YAML's pipeline."""
    import argparse

    import yaml

    boot = argparse.ArgumentParser(add_help=False)
    boot.add_argument("--base_config", "--config", dest="base_config", required=True)
    known, _ = boot.parse_known_args(argv)
    with open(known.base_config) as f:
        raw = yaml.safe_load(f) or {}
    pipeline = raw.get("pipeline_project", "DeepCORO_clip")
    if pipeline not in CONFIG_CLASSES:
        raise NotImplementedError(
            f"pipeline_project {pipeline!r} is not ported yet "
            f"(ported: {sorted(CONFIG_CLASSES)})")
    cfg_cls = CONFIG_CLASSES[pipeline]
    hints = typing.get_type_hints(cfg_cls)

    parser = argparse.ArgumentParser(prog="deepcoro_clip_tpu_torch", parents=[boot],
                                     description=f"pipeline={pipeline}")
    for f in fields(cfg_cls):
        parser.add_argument(f"--{f.name}", type=_cli_type(hints[f.name]), default=None)
    ns = parser.parse_args(argv)

    config = cfg_cls.from_dict(raw)
    overrides = {k: v for k, v in vars(ns).items()
                 if k != "base_config" and v is not None}
    for k, v in list(overrides.items()):  # dict overrides arrive as YAML text
        if typing.get_origin(hints.get(k)) in (dict, typing.Dict) and isinstance(v, str):
            overrides[k] = yaml.safe_load(v)
    return config.update_with_args(overrides)
