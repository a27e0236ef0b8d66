"""Per-head regression and classification losses, and ``multi_head_loss``.

Port of the JAX package's ``losses/heads.py``: mse / mae / rmse / huber for
regression, bce_logit / ce / the focal variants for classification, and the
weighted sum over a dict of heads. Every function takes raw predictions or
logits and reduces in fp32; ``sample_mask`` drops the padding rows of a
fixed-shape batch from the mean.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F


def _masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    x = x.float()
    if mask is None:
        return x.mean()
    m = mask.float()
    while m.dim() < x.dim():
        m = m[..., None]
    m = m.expand_as(x)
    return (x * m).sum() / m.sum().clamp_min(1.0)


def _bce(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return x.clamp_min(0) - x * t + torch.log1p(torch.exp(-x.abs()))


def mse_loss(pred, target, sample_mask=None, **kw):
    return _masked_mean((pred.float() - target) ** 2, sample_mask)


def mae_loss(pred, target, sample_mask=None, **kw):
    return _masked_mean((pred.float() - target).abs(), sample_mask)


def rmse_loss(pred, target, sample_mask=None, **kw):
    return torch.sqrt(mse_loss(pred, target, sample_mask) + 1e-12)


def huber_loss(pred, target, delta: float = 0.1, sample_mask=None, **kw):
    abs_err = (pred.float() - target).abs()
    quad = abs_err.clamp_max(delta)
    return _masked_mean(0.5 * quad ** 2 + delta * (abs_err - quad), sample_mask)


def bce_logit_loss(pred, target, pos_weight: Optional[float] = None,
                   sample_mask=None, **kw):
    t = target.float()
    per = _bce(pred.float(), t)
    if pos_weight is not None:
        per = per * (t * (pos_weight - 1.0) + 1.0)
    return _masked_mean(per, sample_mask)


def ce_loss(pred, target, label_smoothing: float = 0.0, sample_mask=None, **kw):
    """pred: ``[B, C]`` logits; target: ``[B]`` integer labels."""
    logp = F.log_softmax(pred.float(), dim=-1)
    nll = -logp.gather(-1, target[..., None].long())[..., 0]
    if label_smoothing > 0:
        nll = (1 - label_smoothing) * nll - label_smoothing * logp.mean(-1)
    return _masked_mean(nll, sample_mask)


def binary_focal_loss(pred, target, gamma: float = 2.0, alpha: float = 0.25,
                      sample_mask=None, **kw):
    x, t = pred.float(), target.float()
    p = torch.sigmoid(x)
    p_t = p * t + (1 - p) * (1 - t)
    a_t = alpha * t + (1 - alpha) * (1 - t)
    return _masked_mean(a_t * (1 - p_t) ** gamma * _bce(x, t), sample_mask)


def multiclass_focal_loss(pred, target, gamma: float = 2.0, sample_mask=None, **kw):
    logp = F.log_softmax(pred.float(), dim=-1)
    logp_t = logp.gather(-1, target[..., None].long())[..., 0]
    return _masked_mean(-((1 - logp_t.exp()) ** gamma) * logp_t, sample_mask)


# name -> loss, with the JAX registry's aliases
LOSSES: Dict[str, Callable] = {
    "mse": mse_loss,
    "mae": mae_loss,
    "rmse": rmse_loss,
    "huber": huber_loss,
    "bce_logit": bce_logit_loss,
    "bce_with_logits": bce_logit_loss,
    "bce": bce_logit_loss,
    "ce": ce_loss,
    "cross_entropy": ce_loss,
    "binary_focal": binary_focal_loss,
    "multiclass_focal": multiclass_focal_loss,
}


def multi_head_loss(outputs: Dict[str, torch.Tensor], targets: Dict[str, torch.Tensor],
                    loss_structure: Dict[str, str],
                    head_weights: Optional[Dict[str, float]] = None,
                    sample_mask: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """Weighted sum of the per-head losses: ``{"main": total, <head>: loss}``."""
    losses: Dict[str, torch.Tensor] = {}
    total = None
    for head, loss_name in loss_structure.items():
        if loss_name not in LOSSES:
            raise KeyError(f"unknown loss {loss_name!r}; have {sorted(LOSSES)}")
        pred, tgt = outputs[head], targets[head]
        # a single-output head emits [B, 1]: align it with [B] targets, so the
        # elementwise losses do not broadcast to [B, B]
        if pred.dim() == tgt.dim() + 1 and pred.shape[-1] == 1:
            pred = pred[..., 0]
        lh = LOSSES[loss_name](pred, tgt, sample_mask=sample_mask)
        losses[head] = lh
        w = (head_weights or {}).get(head, 1.0)
        total = w * lh if total is None else total + w * lh
    losses["main"] = total if total is not None else torch.zeros((), dtype=torch.float32)
    return losses
