"""The contrastive losses, the port of the JAX package's
``losses/contrastive.py``.

- ``clip_loss``: bidirectional InfoNCE over the batch;
- ``siglip_pairwise_loss``: the square pairwise sigmoid loss, diagonal
  positives (``loss_name: siglip``);
- ``siglip_multi_positive_loss``: sigmoid BCE of each video against a
  bank of unique texts, with per-pair weights, padded bank slots
  (``text_valid``), auto-balance and the entropy regularizer;
- ``siglip_single_head_loss``, ``weighted_siglip_loss`` and
  ``multi_positive_infonce_loss``.

Each is registered in ``registry.LossRegistry`` under the JAX package's
``loss_name`` strings. Everything reduces in fp32; softplus is
``logaddexp(x, 0)``, as ``jax.nn.softplus``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from deepcoro_clip_tpu_torch.registry import LossRegistry

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


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros_like(x))


def _logits(video_emb, text_emb, log_temp):
    """(sim / temp, temp) of the l2-normalized embeddings, fp32; ``temp`` is
    ``exp(log_temp)`` clamped below at 1e-4."""
    v = l2_normalize(video_emb)
    t = l2_normalize(text_emb)
    temp = torch.exp(log_temp.float()).clamp_min(1e-4)
    return (v @ t.T) / temp, temp


@LossRegistry.register("contrastive", "clip", "contrastive_ddp", "infonce_loss",
                       "infonce_loss_ddp", "infonce")
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
    and as negatives. Returns ``loss``, ``similarity`` and ``temperature``.
    """
    sim, temp = _logits(video_emb, text_emb, log_temp)
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


@LossRegistry.register("siglip", "siglip_ddp")
def siglip_pairwise_loss(
    video_emb: torch.Tensor,
    text_emb: torch.Tensor,
    log_temp: torch.Tensor,
    bias: torch.Tensor,
    logit_clamp: float = 30.0,
    sample_mask: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Square pairwise sigmoid loss over ``[B, B]``: +1 on the diagonal, -1
    elsewhere; ``sample_mask`` drops padded rows and columns."""
    sim, temp = _logits(video_emb, text_emb, log_temp)
    logits = (sim + bias.float()).clamp(-logit_clamp, logit_clamp)
    B = logits.shape[0]
    labels = 2.0 * torch.eye(B, device=logits.device) - 1.0
    per_pair = _softplus(-labels * logits)
    if sample_mask is not None:
        m = sample_mask.float()
        w = m[:, None] * m[None, :]
        loss = (per_pair * w).sum() / w.sum().clamp_min(1.0)
    else:
        loss = per_pair.mean()
    return {"loss": loss, "similarity": logits, "temperature": temp}


def entropy_regularization(
    sim: torch.Tensor,
    weight: float,
    min_entropy_threshold: float = 2.0,
    col_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``weight * relu(threshold - mean row entropy)`` of ``softmax(sim)``:
    zero once the mean entropy clears the threshold; ``col_mask`` ``[M]``
    keeps padded bank columns out of the softmax."""
    if weight == 0.0:
        return torch.zeros((), dtype=torch.float32, device=sim.device)
    if col_mask is not None:
        sim = sim.masked_fill(~(col_mask.float()[None, :] > 0), NEG_LOGIT)
    p = torch.softmax(sim, dim=-1)
    ent = -(p * torch.log(p + 1e-10)).sum(dim=-1).mean()
    return weight * torch.relu(min_entropy_threshold - ent)


@LossRegistry.register("siglip_pairwise", "siglip2_bce", "siglip2_bce_ddp",
                       "siglip2_multi_positive", "siglip_pairwise_ddp")
def siglip_multi_positive_loss(
    video_emb: torch.Tensor,
    text_emb: torch.Tensor,
    positive_mask: torch.Tensor,
    log_temp: torch.Tensor,
    bias: torch.Tensor,
    positive_weights: Optional[torch.Tensor] = None,
    text_valid: Optional[torch.Tensor] = None,
    positive_loss_weight: float = 1.0,
    negative_loss_weight: float = 1.0,
    logit_clamp: float = 30.0,
    entropy_reg_weight: float = 0.0,
    auto_balance: bool = False,
    sample_mask: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Multi-positive sigmoid BCE against a bank of unique texts.

    video_emb ``[B, D]``; text_emb ``[M, D]``; positive_mask ``[B, M]`` (1 =
    positive pair); positive_weights ``[B, M]`` per-pair weights (of the
    positive term on positives, of the negative term on sampled negatives);
    text_valid ``[M]`` (0 = padded slot). The sum is over valid pairs and is
    divided by their count; with ``auto_balance`` each row's positives are
    weighted by its negative-to-positive ratio (at least 1, counted over
    the valid columns) in place of their weights.
    """
    sim, temp = _logits(video_emb, text_emb, log_temp)
    logits = (sim + bias.float()).clamp(-logit_clamp, logit_clamp)

    pos = positive_mask.float()
    labels = 2.0 * pos - 1.0
    per_pair = _softplus(-labels * logits)

    is_pos = pos > 0
    w = torch.where(is_pos, torch.full_like(pos, positive_loss_weight),
                    torch.full_like(pos, negative_loss_weight))
    if positive_weights is not None:
        w = w * torch.where(is_pos, positive_weights.float(), torch.ones_like(pos))
    if auto_balance:
        n_pos = pos.sum(dim=1, keepdim=True).clamp_min(1.0)
        n_cols = (text_valid.float().sum() if text_valid is not None
                  else torch.tensor(float(pos.shape[1]), device=pos.device))
        n_neg = (n_cols - n_pos).clamp_min(0.0)
        ratio = (n_neg / n_pos).clamp_min(1.0)
        w = torch.where(is_pos, ratio.expand_as(w), torch.full_like(w, negative_loss_weight))

    valid = torch.ones_like(per_pair)
    if text_valid is not None:
        valid = valid * text_valid.float()[None, :]
    if sample_mask is not None:
        valid = valid * sample_mask.float()[:, None]

    loss = (per_pair * w * valid).sum() / valid.sum().clamp_min(1.0)
    loss = loss + entropy_regularization(logits, entropy_reg_weight, col_mask=text_valid)
    return {"loss": loss, "similarity": logits, "temperature": temp}


@LossRegistry.register("siglip_single_head")
def siglip_single_head_loss(
    video_emb: torch.Tensor,
    text_emb: torch.Tensor,
    positive_mask: torch.Tensor,
    log_temp: torch.Tensor,
    bias: torch.Tensor,
    positive_weights: Optional[torch.Tensor] = None,
    text_valid: Optional[torch.Tensor] = None,
    logit_clamp: float = 30.0,
    entropy_reg_weight: float = 0.0,
    sample_mask: Optional[torch.Tensor] = None,
    **kw,
) -> Dict[str, torch.Tensor]:
    """Sigmoid loss over a dense weight matrix: ``positive_weights`` weighs
    every pair, positive or negative, and 0 leaves a pair out; the sum is
    divided by the weights' sum."""
    sim, temp = _logits(video_emb, text_emb, log_temp)
    logits = (sim + bias.float()).clamp(-logit_clamp, logit_clamp)

    pos = positive_mask.float()
    labels = 2.0 * pos - 1.0
    per_pair = _softplus(-labels * logits)

    w = (positive_weights.float().clamp_min(0.0) if positive_weights is not None
         else torch.ones_like(per_pair))
    if text_valid is not None:
        w = w * text_valid.float()[None, :]
    if sample_mask is not None:
        w = w * sample_mask.float()[:, None]
    loss = (per_pair * w).sum() / w.sum().clamp_min(1e-6)
    loss = loss + entropy_regularization(logits, entropy_reg_weight, col_mask=text_valid)
    return {"loss": loss, "similarity": logits, "temperature": temp}


@LossRegistry.register("weighted_siglip")
def weighted_siglip_loss(video_emb, text_emb, positive_mask, log_temp, bias=None,
                         positive_weights=None, text_valid=None, sample_mask=None,
                         eps=1e-6, **kw):
    """Bidirectional weighted multi-positive softmax cross entropy over
    ``sim / temp`` (no bias), the targets ``positive_mask`` times the
    per-pair weights; row means over the valid rows and columns."""
    logits, temp = _logits(video_emb, text_emb, log_temp)

    pos = positive_mask.float()
    if positive_weights is not None:
        pos = pos * positive_weights.float().clamp_min(0.0)
    col_ok = (text_valid.float() if text_valid is not None
              else torch.ones(logits.shape[1], device=logits.device))
    row_ok = (sample_mask.float() if sample_mask is not None
              else torch.ones(logits.shape[0], device=logits.device))
    pos = pos * col_ok[None, :] * row_ok[:, None]
    masked = logits.masked_fill(~(col_ok[None, :] > 0), NEG_LOGIT)

    logp_v2t = torch.log_softmax(masked, dim=1)
    loss_v2t = -(pos * logp_v2t).sum(dim=1) / pos.sum(dim=1).clamp_min(eps)
    logp_t2v = torch.log_softmax(logits.T.masked_fill(~(row_ok[None, :] > 0), NEG_LOGIT),
                                 dim=1)
    loss_t2v = -(pos.T * logp_t2v).sum(dim=1) / pos.T.sum(dim=1).clamp_min(eps)

    lv = (loss_v2t * row_ok).sum() / row_ok.sum().clamp_min(1.0)
    lt = (loss_t2v * col_ok).sum() / col_ok.sum().clamp_min(1.0)
    return {"loss": 0.5 * (lv + lt), "similarity": logits, "temperature": temp}


@LossRegistry.register("multi_positive_infonce")
def multi_positive_infonce_loss(video_emb, text_emb, positive_mask, log_temp,
                                positive_weights=None, text_valid=None, sample_mask=None,
                                **kw) -> Dict[str, torch.Tensor]:
    """Softmax cross entropy spread over each row's (weighted) positives;
    rows without a positive, and padded rows, are left out of the mean."""
    sim, temp = _logits(video_emb, text_emb, log_temp)
    if text_valid is not None:
        sim = sim.masked_fill(~(text_valid[None, :] > 0), NEG_LOGIT)
    logp = torch.log_softmax(sim, dim=-1)
    pos = positive_mask.float()
    if positive_weights is not None:
        pos = pos * positive_weights.float()
    row_pos = pos.sum(dim=-1).clamp_min(1e-6)
    loss = -((pos * logp).sum(dim=-1) / row_pos)
    has_pos = (positive_mask.sum(dim=-1) > 0).float()
    if sample_mask is not None:
        has_pos = has_pos * sample_mask.float()
    loss = (loss * has_pos).sum() / has_pos.sum().clamp_min(1.0)
    return {"loss": loss, "similarity": sim, "temperature": temp}
