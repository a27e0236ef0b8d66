"""Configuration classes of the ported slices, and the YAML/CLI reader.

``BaseConfig``, ``ClipConfig``, ``MultitaskConfig``, ``LinearProbingConfig``
and ``MultiviewConfig`` have every field of the JAX package's
``configs/base.py``, ``configs/clip.py``, ``configs/multitask.py`` and
``configs/linear_probing.py``. Names and defaults
are the same, so a config dict or a shipped YAML means the same thing on
both sides; keys a class does not know are kept in ``extra()``, as there.
The port adds one field, ``device`` (``PORT_FIELDS``): None runs on the
card, ``"cpu"`` on the CPU.
``set_device_info_in_place`` fills the device fields from the process
group and arranges its ranks as the ``(data, model)`` grid
(``parallel/distributed.py``; one rank without a group), and ``save_json`` writes the
resolved config as JSON, which a YAML reader also reads.

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

    def set_device_info_in_place(self) -> None:
        """The process grid (``parallel/distributed.py``; one rank without a
        group) and this rank's place in it. The ranks are the devices of the
        JAX run's ``(data, model)`` mesh, not its hosts: with ``mesh_model``
        M, rank r is cell ``(r // M, r % M)`` of a ``(world / M, M)`` grid
        (``distributed.init_grid``, which this call makes); every rank reads
        the same global batches, so the samplers stay at process 0 of 1, and
        keeps the rows of its data index. ``is_ref_device`` is rank 0, which
        alone writes files.

        A ``mesh_model`` above 1 must divide the world; it runs the ring
        over each model group with ``use_ring_attention``, and tensor
        parallelism without (every attention's heads and every MLP's hidden
        width cut over the model group, as the JAX runner shards its Dense
        kernels), which needs ``mesh_model`` processes at least: at world 1
        it raises, naming the launch command. A ``mesh_data`` other than -1
        must be ``world / mesh_model``; the data size must divide ``batch_size`` (the
        JAX runner shrinks its data axis to ``gcd(devices, batch_size)`` and
        leaves the other devices idle; an idle rank is an error here)."""
        from deepcoro_clip_tpu_torch.parallel.distributed import init_grid, rank, world_size

        model = max(1, int(self.mesh_model))
        world = world_size()
        self.process_index, self.process_count = 0, 1
        self.is_ref_device = rank() == 0
        self.world_size = world
        if world == 1:
            if model > 1 and not getattr(self, "use_ring_attention", False):
                raise ValueError(
                    f"mesh_model={model} without use_ring_attention cuts the attention "
                    f"and MLP layers over {model} ranks (tensor parallelism), and this "
                    "run is one process: launch it as python -m torch.distributed.run "
                    f"--nproc_per_node {model} -m deepcoro_clip_tpu_torch.main "
                    "--base_config <yaml> (or a multiple of it), or set mesh_model: 1")
            return
        if world % model:
            raise ValueError(f"mesh_model={model} does not divide the {world} ranks of "
                             "the process group")
        data = world // model
        if self.mesh_data not in (-1, data):
            raise ValueError(f"mesh_data={self.mesh_data} but the process group has "
                             f"{world} ranks and mesh_model={model}; set -1 or {data}")
        batch = getattr(self, "batch_size", None)
        if batch is not None and batch % data:
            raise ValueError(
                f"batch_size={batch} is not divisible by the data axis of {data} "
                f"ranks: the JAX runner would train on gcd({data}, {batch}) devices "
                "and leave the rest idle; launch a world size that divides batch_size")
        init_grid(model)

    def save_json(self, path) -> None:
        """The resolved config, keys sorted; JSON is YAML too."""
        import json
        from pathlib import Path

        Path(path).parent.mkdir(parents=True, exist_ok=True)
        Path(path).write_text(json.dumps(self.to_dict(), indent=1, sort_keys=True,
                                         default=str) + "\n")


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
    # the port's own: where the run goes, None = the card ("cpu" to ask for
    # the CPU); not a field of the JAX package
    device: Optional[str] = None



@dataclass
class ClipConfig(BaseConfig):
    """Every field of the JAX package's ``ClipConfig``, with its default.
    The contrastive runner runs every one of them: the SigLIP and
    multi-positive fields, the single-head sampler and the LocCa head."""

    # ---- data ----
    data_filename: str = "data/reports.csv"
    root: str = "."
    target_label: Optional[str] = "Report"
    datapoint_loc_label: str = "FileName"
    split_column: str = "Split"
    frames: int = 16
    stride: int = 2
    resize: int = 224
    rand_augment: bool = False
    apply_mask: bool = False
    batch_size: int = 8
    multi_video: bool = False
    num_videos: int = 1
    groupby_column: str = "StudyInstanceUID"
    shuffle_videos: bool = True
    data_mean: Optional[List[float]] = None
    data_std: Optional[List[float]] = None
    dataset_mean: Optional[List[float]] = None
    dataset_std: Optional[List[float]] = None
    max_text_length: int = 512
    # tokenize each batch to the smallest bucket that fits its longest
    # report; empty = always max_text_length
    text_length_buckets: List[int] = field(default_factory=list)
    # ---- model ----
    model_name: str = "mvit"
    pretrained: bool = False
    aggregate_videos_tokens: bool = True
    per_video_pool: bool = False
    num_heads: int = 8
    aggregator_depth: int = 2
    dropout: float = 0.1
    video_freeze_ratio: float = 0.0
    text_freeze_ratio: float = 0.0
    use_cls_token: bool = False
    pooling_mode: str = "mean"  # mean | attention | cls_token
    embedding_dim: int = 512
    text_model_name: str = "pubmedbert"
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
    temp_schedule: str = "learnable"  # learnable|constant|linear|cosine|exponential
    temp_start: Optional[float] = None
    temp_end: Optional[float] = None
    video_freeze_schedule: Optional[str] = None
    text_freeze_schedule: Optional[str] = None
    # ---- checkpoint policy ----
    save_best: str = "loss"  # loss | alignment
    # ---- metrics ----
    recall_k: List[int] = field(default_factory=lambda: [1, 5, 10, 50])
    ndcg_k: List[int] = field(default_factory=lambda: [5])
    # ---- SigLIP multi-positive (the single-head sampler is not ported yet) ----
    siglip_texts_path: Optional[str] = None
    siglip_edges_path: Optional[str] = None
    siglip_max_positive_per_video: int = 8
    siglip_negatives_per_video: int = 0
    siglip_round_robin_sampling: bool = True
    siglip_max_segments_per_video: int = 15
    siglip_positive_severity_weights: Optional[Dict[str, float]] = None
    siglip_enable_severity_weighting: bool = False
    siglip_positive_loss_weight: float = 1.0
    siglip_negative_loss_weight: float = 1.0
    siglip_use_class_aware_sampler: bool = False
    siglip_contradiction_boost: float = 0.0
    siglip_contradiction_min_severity: str = "moderate"
    siglip_sampler: str = "pairs"
    siglip_base_negative_weight: float = 0.04
    siglip_min_pos_weight: float = 0.0
    siglip_abnormal_ratio: float = 0.5
    siglip_use_weighted_loss: bool = False
    # read by the contrastive bundle too: the initial logit_bias
    siglip_bias_init: float = -10.0
    siglip_entropy_reg_weight: float = 0.0
    siglip_auto_balance: bool = False
    siglip_logit_clamp: float = 30.0
    siglip_debug_batches: int = 0
    siglip_debug_every: int = 1
    siglip_debug_sample_count: int = 4
    # ---- LocCa: a decoder over the video tokens, trained beside the
    # contrastive loss (train/clip.py) or the multitask losses ----
    locca_enabled: bool = False
    locca_weight: float = 0.5
    locca_num_layers: int = 4
    locca_d_model: int = 512
    locca_num_heads: int = 8
    locca_max_seq_len: int = 256
    locca_task_weights: Optional[Dict[str, float]] = None
    # ---- inference ----
    topk: int = 5
    text_embeddings_path: Optional[str] = None
    metadata_path: Optional[str] = None
    inference_results_path: str = "outputs/inference"
    # ---- early stopping ----
    early_stopping_patience: Optional[int] = None
    # ---- accelerator knobs ----
    precision: str = "bf16"  # bf16 | fp32 compute (params always fp32)
    use_pallas_attention: bool = True  # here: the hand-written CUDA kernels
    # sequence parallelism: ring attention over the token axis in the video
    # backbone (parallel/ring_attention.py; active where the token count
    # divides by the ring-axis size)
    use_ring_attention: bool = False
    ring_axis: str = "model"
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


# the roadmap item of each field family the port does not run yet, and of
# each field it runs at its default value only: none is left
_UNPORTED: tuple = ()
_DEFAULT_ONLY: Dict[str, str] = {}


def unported_settings(config) -> List[str]:
    """``"field=value (what brings it)"`` for every field of a path the port
    does not run yet that ``config`` sets away from its default."""
    out = []
    for f in fields(config):
        item = _DEFAULT_ONLY.get(f.name)
        for prefix, what in _UNPORTED:
            if f.name.startswith(prefix):
                item = what
        if item is None:
            continue
        default = (f.default if f.default is not dataclasses.MISSING
                   else f.default_factory())
        value = getattr(config, f.name)
        if value != default:
            out.append(f"{f.name}={value!r} ({item})")
    return out


@dataclass
class MultitaskConfig(ClipConfig):
    """Contrastive + captioning + masked video modeling: every field of the
    JAX package's ``MultitaskConfig``, with its default."""

    # task loss weights
    loss_weights: Dict[str, float] = field(
        default_factory=lambda: {"contrastive": 1.0, "captioning": 1.0, "mvm": 1.0}
    )
    loss_weight_schedule: Optional[Dict[str, List[float]]] = None
    # captioning decoder
    captioning_lr: float = 1e-4
    decoder_dim: int = 512
    decoder_depth: int = 4
    decoder_heads: int = 8
    decoder_max_length: int = 128
    caption_label_smoothing: float = 0.1
    # masked video modeling
    mvm_lr: float = 1e-4
    mask_ratio: float = 0.75
    mvm_decoder_dim: int = 256
    mvm_decoder_depth: int = 2
    mvm_norm_targets: bool = True
    # multi-view consistency
    consistency_weight: float = 0.0
    # scheduled sampling for caption training: with probability p the
    # decoder's inputs at t > 0 are its own first-pass predictions; p ramps
    # linearly from 0 over ``scheduled_sampling_warmup_steps``; 0.0 = off
    scheduled_sampling_prob: float = 0.0
    scheduled_sampling_warmup_steps: int = 0


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


# the fields the port adds to the JAX package's
PORT_FIELDS = ("device",)

# pipeline_project -> config class, for the pipelines that are ported
CONFIG_CLASSES = {
    "DeepCORO_clip": ClipConfig,
    "DeepCORO_clip_simple": ClipConfig,
    "DeepCORO_multitask": MultitaskConfig,
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
    config.update_with_args(overrides)
    config.set_device_info_in_place()
    return config
