"""The CLIP contrastive loss, the port of ``clip_loss`` in the JAX package's
``losses/contrastive.py``.

Everything reduces in fp32. The SigLIP family and the multi-positive losses
of that module are not ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

NEG_LOGIT = -1e30


def l2_normalize(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    x = x.float()
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(eps)


def _ce_with_smoothing(logits: torch.Tensor, labels: torch.Tensor, smoothing: float,
                       row_weights: Optional[torch.Tensor] = None,
                       col_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Cross entropy with label smoothing; ``col_mask`` ``[C]`` marks the
    valid columns, so the uniform smoothing term never averages over
    ``NEG_LOGIT``-masked padding."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(1, labels[:, None])[:, 0]
    if smoothing > 0.0:
        if col_mask is not None:
            m = col_mask.float()[None, :]
            uniform = -(logp * m).sum(dim=-1) / m.sum().clamp_min(1.0)
        else:
            uniform = -logp.mean(dim=-1)
        nll = (1.0 - smoothing) * nll + smoothing * uniform
    if row_weights is None:
        return nll.mean()
    w = row_weights.float()
    return (nll * w).sum() / w.sum().clamp_min(1.0)


def clip_loss(
    video_emb: torch.Tensor,
    text_emb: torch.Tensor,
    log_temp: torch.Tensor,
    label_smoothing: float = 0.0,
    sample_mask: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Bidirectional InfoNCE over the batch.

    video_emb/text_emb: ``[B, D]``; log_temp: scalar; sample_mask: optional
    ``[B]`` (nonzero = real row): padded rows are excluded both as anchors
    and as negatives. Returns ``loss``, ``similarity`` and ``temperature``
    (``exp(log_temp)`` clamped below at 1e-4).
    """
    v = l2_normalize(video_emb)
    t = l2_normalize(text_emb)
    temp = torch.exp(log_temp.float()).clamp_min(1e-4)
    sim = (v @ t.T) / temp
    labels = torch.arange(sim.shape[0], device=sim.device)
    if sample_mask is not None:
        valid = sample_mask.float() > 0
        sim_v = sim.masked_fill(~valid[None, :], NEG_LOGIT)
        sim_t = sim.T.masked_fill(~valid[None, :], NEG_LOGIT)
        loss_v = _ce_with_smoothing(sim_v, labels, label_smoothing, valid, col_mask=valid)
        loss_t = _ce_with_smoothing(sim_t, labels, label_smoothing, valid, col_mask=valid)
    else:
        loss_v = _ce_with_smoothing(sim, labels, label_smoothing)
        loss_t = _ce_with_smoothing(sim.T, labels, label_smoothing)
    return {"loss": 0.5 * (loss_v + loss_t), "similarity": sim, "temperature": temp}
