"""LocCa (location-aware captioning) losses.

Port of the JAX package's ``losses/locca.py``. The three tasks share one
decoder and differ in which target positions are scored:

- captioning: every text token;
- referring expression: only location tokens (given the text, predict
  where), the positions ``location_mask`` flags, without label smoothing;
- grounded captioning: only the other tokens (given the locations, predict
  the description).

All three are shift-by-one CE over the decoder's logits. ``locca_combined_loss``
normalizes the logits once (``losses/multitask.token_nll``) and scores the
three masks from it.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from deepcoro_clip_tpu_torch.losses.multitask import (
    captioning_loss,
    masked_token_mean,
    token_nll,
)


def locca_captioning_loss(logits, target_ids, attention_mask,
                          label_smoothing: float = 0.1, sample_weights=None):
    """Plain captioning CE over all real tokens."""
    return captioning_loss(logits, target_ids, attention_mask, label_smoothing,
                           sample_weights=sample_weights)


def locca_referring_expression_loss(logits, target_ids, attention_mask, location_mask,
                                    label_smoothing: float = 0.0, sample_weights=None):
    """Score only location tokens (``location_mask`` ``[B, L]``, 1 = a
    location token)."""
    return captioning_loss(logits, target_ids, attention_mask * location_mask,
                           label_smoothing, sample_weights=sample_weights)


def locca_grounded_captioning_loss(logits, target_ids, attention_mask, location_mask,
                                   label_smoothing: float = 0.1, sample_weights=None):
    """Score only non-location tokens."""
    return captioning_loss(logits, target_ids, attention_mask * (1 - location_mask),
                           label_smoothing, sample_weights=sample_weights)


def locca_combined_loss(
    logits,
    target_ids,
    attention_mask,
    location_mask: Optional[torch.Tensor] = None,
    weights: Optional[Dict[str, float]] = None,
    label_smoothing: float = 0.1,
    sample_weights=None,
) -> Dict[str, torch.Tensor]:
    """Weighted sum of the three LocCa tasks. Without a location mask this
    is plain captioning."""
    weights = weights or {"captioning": 1.0, "referring": 1.0, "grounded": 1.0}
    nll, mean_logp = token_nll(logits, target_ids)
    out: Dict[str, torch.Tensor] = {}
    out["captioning"] = masked_token_mean(nll, mean_logp, attention_mask,
                                          label_smoothing, sample_weights)
    total = weights.get("captioning", 1.0) * out["captioning"]
    if location_mask is not None:
        out["referring"] = masked_token_mean(
            nll, mean_logp, attention_mask * location_mask, 0.0, sample_weights)
        out["grounded"] = masked_token_mean(
            nll, mean_logp, attention_mask * (1 - location_mask), label_smoothing,
            sample_weights)
        total = (total + weights.get("referring", 1.0) * out["referring"]
                 + weights.get("grounded", 1.0) * out["grounded"])
    out["total"] = total
    return out
