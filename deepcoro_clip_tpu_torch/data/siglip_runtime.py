"""SigLIP runtime settings: every ``siglip_*`` knob of a config resolved
once into typed settings.

The port's copy of the JAX package's ``data/siglip_runtime.py``, field for
field, with its defaults, clamps and per-severity ladders: ``debug`` gates
the per-sample dumps of ``utils/siglip_logging.py``, ``sampling`` feeds
``data/siglip.SiglipVideoDataset`` and the class-aware batch sampler,
``retrieval`` the validation knobs; the focal, bag and phase settings are
resolved so that a config carrying them reads the same, and nothing
consumes them, as in the JAX package.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Dict, Optional


def _normalize_key(value: Optional[str]) -> str:
    return str(value or "").strip().lower()


def _merge_ladder(defaults: Dict[str, float], override: Any) -> Dict[str, float]:
    """Reference semantics: config dicts overlay the built-in severity
    ladder key-by-key, silently skipping unparseable values
    (runtime_settings.py:104-146)."""
    out = dict(defaults)
    if isinstance(override, dict):
        for key, value in override.items():
            try:
                out[_normalize_key(key)] = float(value)
            except (TypeError, ValueError):
                continue
    return out


# Built-in per-severity ladders (runtime_settings.py:102-139). The bag
# regularizer targets grow monotonically with severity; "cto" sits at the
# critical end of the scale.
BAG_TARGETS_SUM = {
    "normal": 0.0, "mild": 0.6, "moderate": 1.2,
    "severe": 1.8, "critical": 2.0, "cto": 2.0,
}
BAG_TARGETS_MEAN = {
    "normal": 0.02, "mild": 0.08, "moderate": 0.16,
    "severe": 0.22, "critical": 0.26, "cto": 0.30,
}
BAG_LAMBDA_BY_SEVERITY = {
    "normal": 0.0, "mild": 0.001, "moderate": 0.003,
    "severe": 0.006, "critical": 0.008, "cto": 0.008,
}


@dataclass
class SiglipDebugSettings:
    """Per-sample logit/grad dump gates (read by
    ``runners/contrastive.py``'s debug dump)."""

    batches_per_epoch: int = 0
    every: int = 1
    sample_count: int = 4
    sync: bool = False
    barrier_debug: bool = False

    @property
    def enabled(self) -> bool:
        return self.batches_per_epoch > 0

    def fires(self, epoch: int, batch_index: int) -> bool:
        return (
            self.enabled
            and epoch % max(1, self.every) == 0
            and batch_index < self.batches_per_epoch
        )


@dataclass
class SiglipBagSettings:
    """Bag-level severity regularizer schedule (runtime_settings.py:23-35).
    Inert in the reference (no consumer) and inert here; resolved for config
    round-trip parity."""

    lambda_start: float = 0.0
    lambda_end: float = 0.0
    start_epoch: int = 0
    warmup_epochs: int = 0
    reduce: str = "sum"
    topk: int = 3
    loss_type: str = "mse"
    huber_delta: float = 0.25
    targets_sum: Dict[str, float] = field(default_factory=dict)
    targets_mean: Dict[str, float] = field(default_factory=dict)
    lambda_by_severity: Dict[str, float] = field(default_factory=dict)


@dataclass
class SiglipRetrievalSettings:
    """Validation-retrieval knobs (runtime_settings.py:38-44)."""

    fp16: bool = False
    use_logit_bias_eval: bool = False
    logit_bias_scale_eval: float = 0.0
    use_textbank_cache: bool = True
    textbank_cache_dir: str = "textbank_cache"


@dataclass
class SiglipSamplingSettings:
    """Positive/negative pack assembly knobs — this build's addition: the
    reference reads these straight off the config inside
    VideoClipDataset (video_clip_dataset.py:546-595,766-841); here they
    resolve once and feed SiglipVideoDataset."""

    max_positive_per_video: int = 8
    negatives_per_video: int = 0
    round_robin: bool = True
    max_segments_per_video: int = 15
    contradiction_boost: float = 0.0
    contradiction_min_severity: str = "moderate"
    use_class_aware_sampler: bool = False
    abnormal_ratio: float = 0.5


@dataclass
class SiglipRuntimeSettings:
    """All SigLIP runtime knobs, resolved once from a ClipConfig."""

    eps: float = 1e-6
    abnormal_margin: float = 0.0
    negative_weight: float = 1.0
    infonce_weight: float = 0.25
    focal_infonce: bool = True
    focal_gamma_pos: float = 2.0
    focal_gamma_neg: float = 0.0
    focal_alpha_default: float = 1.0
    focal_alpha_clip_min: float = 0.5
    focal_alpha_clip_max: float = 8.0
    focal_detach_weights: bool = True
    hard_neg_topk: int = 0
    hard_neg_boost: float = 0.0
    use_weighted_loss: bool = False
    use_logit_bias_train: bool = False
    logit_bias_scale_train: float = 0.0
    phase_default: str = "A"
    phase_transition_epoch: Optional[int] = None
    debug: SiglipDebugSettings = field(default_factory=SiglipDebugSettings)
    bag: SiglipBagSettings = field(default_factory=SiglipBagSettings)
    retrieval: SiglipRetrievalSettings = field(
        default_factory=SiglipRetrievalSettings)
    sampling: SiglipSamplingSettings = field(
        default_factory=SiglipSamplingSettings)

    def phase_for_epoch(self, epoch: int) -> str:
        """'A' until the transition epoch, 'B' from it on (reference
        phase_default/phase_transition_epoch contract,
        runtime_settings.py:64-65,195-196)."""
        if (self.phase_transition_epoch is not None
                and epoch >= int(self.phase_transition_epoch)):
            return "B" if self.phase_default == "A" else "A"
        return self.phase_default

    @classmethod
    def from_config(cls, config: Any,
                    output_dir: Optional[str] = None) -> "SiglipRuntimeSettings":
        """Resolve every knob with the reference's defaults and clamps
        (runtime_settings.py:70-199). Works on any object carrying the
        (optional) ``siglip_*`` attributes — ClipConfig or a test namespace."""
        g = lambda k, d: getattr(config, k, d)  # noqa: E731

        infonce_weight = min(float(g("siglip_infonce_weight", 0.25)), 0.5)
        focal_alpha_clip_min = float(g("siglip_focal_alpha_clip_min", 0.5))
        focal_alpha_clip_max = float(g("siglip_focal_alpha_clip_max", 8.0))
        if focal_alpha_clip_max < focal_alpha_clip_min:
            focal_alpha_clip_max = focal_alpha_clip_min

        debug = SiglipDebugSettings(
            # this build's config spells the gate siglip_debug_batches; the
            # reference's resolver reads siglip_debug_batch_per_epoch — accept
            # both so reference YAMLs resolve identically
            batches_per_epoch=max(0, int(
                g("siglip_debug_batches", g("siglip_debug_batch_per_epoch", 0))
            )),
            every=max(0, int(g("siglip_debug_every", 0))),
            sample_count=max(0, int(g("siglip_debug_sample_count", 0))),
            sync=bool(g("siglip_debug_sync", False)),
            barrier_debug=bool(g("siglip_barrier_debug", False)),
        )

        bag = SiglipBagSettings(
            lambda_start=float(g("siglip_bag_lambda_start", 0.0)),
            lambda_end=float(g("siglip_bag_lambda_end",
                               g("siglip_bag_lambda", 0.0))),
            start_epoch=int(g("siglip_bag_start_epoch", 0)),
            warmup_epochs=int(g("siglip_bag_warmup_epochs", 0)),
            reduce=str(g("siglip_bag_reduce", "sum")).lower(),
            topk=max(1, int(g("siglip_bag_topk", 3))),
            loss_type=str(g("siglip_bag_loss_type", "mse")).lower(),
            huber_delta=float(g("siglip_bag_huber_delta", 0.25)),
            targets_sum=_merge_ladder(BAG_TARGETS_SUM,
                                      g("siglip_bag_targets", None)),
            targets_mean=_merge_ladder(BAG_TARGETS_MEAN,
                                       g("siglip_bag_targets_mean", None)),
            lambda_by_severity=_merge_ladder(
                BAG_LAMBDA_BY_SEVERITY,
                g("siglip_bag_lambda_by_severity", None)),
        )

        retrieval = SiglipRetrievalSettings(
            fp16=bool(g("retrieval_fp16", False)),
            use_logit_bias_eval=bool(g("use_logit_bias_eval", False)),
            logit_bias_scale_eval=float(g("logit_bias_scale_eval", 0.0)),
            use_textbank_cache=bool(g("use_textbank_cache", True)),
            textbank_cache_dir=str(g(
                "textbank_cache_dir",
                os.path.join(output_dir or ".", "textbank_cache"))),
        )

        sampling = SiglipSamplingSettings(
            max_positive_per_video=int(g("siglip_max_positive_per_video", 8)),
            negatives_per_video=int(g("siglip_negatives_per_video", 0)),
            round_robin=bool(g("siglip_round_robin_sampling", True)),
            max_segments_per_video=int(g("siglip_max_segments_per_video", 15)),
            contradiction_boost=float(g("siglip_contradiction_boost", 0.0)),
            contradiction_min_severity=str(
                g("siglip_contradiction_min_severity", "moderate")),
            use_class_aware_sampler=bool(
                g("siglip_use_class_aware_sampler", False)),
            abnormal_ratio=float(g("siglip_abnormal_ratio", 0.5)),
        )

        return cls(
            eps=float(g("siglip_loss_eps", 1e-6)),
            abnormal_margin=float(g("siglip_abnormal_margin", 0.0)),
            negative_weight=float(g("siglip_negative_weight", 1.0)),
            infonce_weight=infonce_weight,
            focal_infonce=bool(g("siglip_focal_infonce", True)),
            focal_gamma_pos=float(g("siglip_focal_gamma_pos", 2.0)),
            focal_gamma_neg=float(g("siglip_focal_gamma_neg", 0.0)),
            focal_alpha_default=float(g("siglip_focal_alpha_default", 1.0)),
            focal_alpha_clip_min=focal_alpha_clip_min,
            focal_alpha_clip_max=focal_alpha_clip_max,
            focal_detach_weights=bool(g("siglip_focal_detach_weights", True)),
            hard_neg_topk=int(g("siglip_hard_neg_topk", 0)),
            hard_neg_boost=float(g("siglip_hard_neg_boost", 0.0)),
            use_weighted_loss=bool(g("siglip_use_weighted_loss", False)),
            use_logit_bias_train=bool(g("use_logit_bias_train", False)),
            logit_bias_scale_train=float(g("logit_bias_scale_train", 0.0)),
            phase_default=str(g("siglip_phase_default", "A")).upper(),
            phase_transition_epoch=g("siglip_phase_transition_epoch", None),
            debug=debug,
            bag=bag,
            retrieval=retrieval,
            sampling=sampling,
        )
