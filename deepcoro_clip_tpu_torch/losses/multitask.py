"""Multitask loss: contrastive + captioning CE + MVM MSE with scheduled
weights.

Port of the JAX package's ``losses/multitask.py``: the label-smoothed
captioning cross-entropy on shift-by-one targets with per-sample weights,
the weighted task sum and the step-scheduled task weights. The per-sample
stenosis-severity weights come from the host
(``utils/stenosis_extractor.StenosisExtractor.max_severity_weight``).

``token_nll`` takes one fp32 log-softmax over the vocabulary; the LocCa
losses (``losses/locca.py``) score three position masks from it, so the
``[B, L, V]`` logits are normalized once, not three times.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from deepcoro_clip_tpu_torch.parallel.distributed import global_ratio


def token_nll(logits: torch.Tensor, target_ids: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``logits[:, :-1]`` predict ``target_ids[:, 1:]``: (the negative
    log-likelihood of each target, the mean log-probability over the
    vocabulary), both ``[B, L-1]`` fp32."""
    logp = F.log_softmax(logits[:, :-1].float(), dim=-1)
    nll = -logp.gather(-1, target_ids[:, 1:].long()[..., None])[..., 0]
    return nll, logp.mean(-1)


def masked_token_mean(nll: torch.Tensor, mean_logp: torch.Tensor,
                      attention_mask: torch.Tensor, label_smoothing: float = 0.1,
                      sample_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The smoothed CE of ``token_nll``'s output, averaged over the
    positions where ``attention_mask[:, 1:]`` (times ``sample_weights``) is
    nonzero: those of the global batch, under data parallelism (the sum and
    the count are summed over the ranks before the division)."""
    mask = attention_mask[:, 1:].float()
    if label_smoothing > 0:
        nll = (1 - label_smoothing) * nll - label_smoothing * mean_logp
    if sample_weights is not None:
        mask = mask * sample_weights[:, None].float()
    return global_ratio((nll * mask).sum(), mask.sum())


def captioning_loss(
    logits: torch.Tensor,          # [B, L, V] (predicts the token at position + 1)
    target_ids: torch.Tensor,      # [B, L]
    attention_mask: torch.Tensor,  # [B, L] 1 = real token
    label_smoothing: float = 0.1,
    sample_weights: Optional[torch.Tensor] = None,  # [B]
) -> torch.Tensor:
    """Shift-by-one CE: ``logits[:, :-1]`` predict ``target_ids[:, 1:]``."""
    nll, mean_logp = token_nll(logits, target_ids)
    return masked_token_mean(nll, mean_logp, attention_mask, label_smoothing,
                             sample_weights)


def multitask_loss(task_losses: Dict[str, torch.Tensor],
                   weights: Dict[str, float]) -> Dict[str, torch.Tensor]:
    total = torch.zeros((), dtype=torch.float32)
    out = dict(task_losses)
    for name, loss in task_losses.items():
        total = total + float(weights.get(name, 1.0)) * loss
    out["total"] = total
    return out


class LossWeightScheduler:
    """Step-scheduled task weights.

    schedule: {task: [[step, weight], ...]}: piecewise-constant from the
    last breakpoint <= the current step; tasks absent keep their base
    weights.
    """

    def __init__(self, base: Dict[str, float],
                 schedule: Optional[Dict[str, List[List[float]]]] = None):
        self.base = dict(base)
        self.schedule = schedule or {}

    def at(self, step: int) -> Dict[str, float]:
        out = dict(self.base)
        for task, points in self.schedule.items():
            w = out.get(task, 1.0)
            for s, v in sorted(points):
                if step >= s:
                    w = float(v)
            out[task] = w
        return out
