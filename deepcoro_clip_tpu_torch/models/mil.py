"""Multi-instance linear probing heads over frozen embeddings.

Port of the JAX package's ``models/mil.py``:

- pooling over instances: ``mean`` / ``max`` / ``attention`` (gated
  tanh * sigmoid attention) / ``cls_token`` (learnable CLS + transformer) and
  the hybrids ``mean+cls_token`` and ``attention+cls_token`` (parts
  concatenated, so the heads read ``2 D``);
- hierarchical ``[B, N, L, D]`` input: tokens are pooled within each video,
  then videos across the study; a hybrid's ``2 D`` goes back to ``D``
  through ``hier_proj``;
- view embeddings ``Embedding(num_view_classes + 1, D)`` whose last row is
  the PAD id;
- one fp32 linear head per task.

The pools of the two levels are separate (``within_*``, ``across_*``) or one
set (``shared_*``). A flax module creates a pool's parameters at its first
use; here the constructor builds what the configuration can reach: the
``within`` pools exist only with ``hierarchical``. What the JAX module sows
(``pooled``, ``within_attention``, ``across_attention``) is returned when
``return_intermediates`` is set.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from deepcoro_clip_tpu_torch.models.attention_pool import prepend_cls
from deepcoro_clip_tpu_torch.models.layers import (
    Dense,
    LayerNorm,
    TransformerBlock,
    _dropout,
)

NEG = -1e30
POOLING_MODES = ("mean", "max", "attention", "cls_token", "mean+cls_token",
                 "attention+cls_token")


class GatedAttentionPool(nn.Module):
    """Gated attention pooling (Ilse et al.): softmax over instances of
    ``w(tanh(V x) * sigmoid(U x))``, fp32 scores."""

    def __init__(self, dim: int, hidden: int = 256, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dropout = dropout
        self.V = Dense(dim, hidden, dtype)
        self.U = Dense(dim, hidden, dtype)
        self.w = Dense(hidden, 1, dtype)

    def forward(self, x, mask=None, deterministic: bool = True, generator=None):
        """x: ``[B, N, D]``; mask: ``[B, N]`` -> (``[B, D]``, attention
        ``[B, N]``). A bag with no valid instance gets uniform weights."""
        scores = self.w(torch.tanh(self.V(x)) * torch.sigmoid(self.U(x)))[..., 0].float()
        if mask is not None:
            mask = mask.bool()
            scores = torch.where(mask, scores, torch.full_like(scores, NEG))
        att = torch.softmax(scores, dim=-1)
        if mask is not None:
            any_valid = mask.any(dim=-1, keepdim=True)
            att = torch.where(any_valid, att, torch.full_like(att, 1.0 / att.shape[-1]))
        att = _dropout(att, self.dropout, deterministic, generator)
        pooled = torch.einsum("bn,bnd->bd", att.to(x.dtype), x)
        return pooled, att


class CLSPool(nn.Module):
    """Learnable CLS token + transformer over the instances; returns the CLS
    position (through a LayerNorm with ``pre_norm``)."""

    def __init__(self, dim: int, num_heads: int = 8, depth: int = 1,
                 dropout: float = 0.0, pre_norm: bool = True,
                 dtype: torch.dtype = torch.float32, use_flash: bool = False):
        super().__init__()
        self.depth = depth
        self.cls = nn.Parameter(torch.zeros(1, 1, dim))
        for i in range(depth):
            self.add_module(f"block{i}", TransformerBlock(
                dim, num_heads, dropout=dropout, dtype=dtype, use_flash=use_flash))
        if pre_norm:
            self.norm = LayerNorm(dim)

    def forward(self, x, mask=None, deterministic: bool = True, generator=None):
        x, mask = prepend_cls(self.cls, x, mask)
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x, kv_mask=mask, deterministic=deterministic,
                                           generator=generator)
        out = x[:, 0]
        return self.norm(out).to(x.dtype) if hasattr(self, "norm") else out


class MultiInstanceLinearProbing(nn.Module):
    def __init__(self, embedding_dim: int = 512,
                 head_structure: Optional[Dict[str, int]] = None,
                 pooling_mode: str = "attention", attention_hidden: int = 256,
                 dropout: float = 0.0, dropout_attention: float = 0.0,
                 num_heads: int = 8, cls_depth: int = 1,
                 separate_video_attention: bool = True,
                 normalization_strategy: str = "pre_norm",
                 use_view_embeddings: bool = False, num_view_classes: int = 0,
                 hierarchical: bool = False, dtype: torch.dtype = torch.float32,
                 use_flash: bool = False):
        super().__init__()
        if pooling_mode not in POOLING_MODES:
            raise ValueError(f"unknown pooling_mode {pooling_mode!r}")
        self.embedding_dim = embedding_dim
        self.head_structure = dict(head_structure or {})
        self.pooling_mode = pooling_mode
        self.dropout = dropout
        self.separate = separate_video_attention
        self.hierarchical = hierarchical
        self.num_view_classes = num_view_classes
        self.dtype = dtype

        def add_pools(scope: str) -> None:
            if "attention" in pooling_mode:
                self.add_module(f"{scope}_gated", GatedAttentionPool(
                    embedding_dim, attention_hidden, dropout_attention, dtype))
            if "cls_token" in pooling_mode:
                self.add_module(f"{scope}_cls", CLSPool(
                    embedding_dim, num_heads, cls_depth, dropout_attention,
                    pre_norm=normalization_strategy == "pre_norm", dtype=dtype,
                    use_flash=use_flash))

        if self.separate:
            if hierarchical:
                add_pools("within")
            add_pools("across")
        else:
            add_pools("shared")
        pooled_dim = embedding_dim * (2 if "+" in pooling_mode else 1)
        if hierarchical and pooled_dim != embedding_dim:
            self.hier_proj = Dense(pooled_dim, embedding_dim, dtype)
        if use_view_embeddings:
            self.view_embeddings = nn.Embedding(num_view_classes + 1, embedding_dim)
        for head, n_out in self.head_structure.items():
            self.add_module(f"head_{head}", Dense(pooled_dim, n_out, torch.float32))

    def _pool(self, scope: str, x, mask, deterministic, generator, sown: dict):
        """``[B, N, D]`` -> ``[B, D or 2D]`` by ``pooling_mode``; ``scope`` is
        the level (``within`` / ``across``)."""
        mode = self.pooling_mode
        prefix = scope if self.separate else "shared"
        parts = []
        if mode in ("mean", "mean+cls_token"):
            if mask is not None:
                m = mask.to(x.dtype)[..., None]
                parts.append((x * m).sum(1) / m.sum(1).clamp_min(1.0))
            else:
                parts.append(x.mean(1))
        if mode == "max":
            masked = x if mask is None else torch.where(
                mask.bool()[..., None], x, torch.full_like(x, NEG))
            parts.append(masked.max(dim=1).values)
        if "attention" in mode:
            pooled, att = getattr(self, f"{prefix}_gated")(x, mask, deterministic, generator)
            sown[f"{scope}_attention"] = att
            parts.append(pooled)
        if "cls_token" in mode:
            parts.append(getattr(self, f"{prefix}_cls")(x, mask, deterministic, generator))
        return torch.cat(parts, dim=-1) if len(parts) > 1 else parts[0]

    def forward(self, x, mask: Optional[torch.Tensor] = None,
                view_ids: Optional[torch.Tensor] = None, deterministic: bool = True,
                generator=None, return_intermediates: bool = False):
        """x: ``[B, N, D]`` per-video embeddings or ``[B, N, L, D]`` tokens
        (``hierarchical``); mask: ``[B, N]``; view_ids: ``[B, N]`` integers
        (PAD = ``num_view_classes``). Returns ``{head: [B, n_outputs]}`` in
        fp32, and with ``return_intermediates`` also the dict of ``pooled``
        (the heads' input) and the gated pools' attention weights."""
        sown: dict = {}
        if x.dim() == 4:
            if not self.hierarchical:
                raise ValueError("[B, N, L, D] input needs hierarchical=True")
            B, N, L, D = x.shape
            pooled = self._pool("within", x.reshape(B * N, L, D), None, deterministic,
                                generator, sown)
            if pooled.shape[-1] != D:  # a hybrid doubles the width: back to D
                pooled = self.hier_proj(pooled)
            x = pooled.reshape(B, N, D)
        if hasattr(self, "view_embeddings") and view_ids is not None:
            emb = self.view_embeddings(view_ids.long().clamp(0, self.num_view_classes))
            x = x + emb.to(x.dtype)
        pooled = self._pool("across", x, mask, deterministic, generator, sown)
        sown["pooled"] = pooled
        pooled = _dropout(pooled, self.dropout, deterministic, generator)
        out = {head: getattr(self, f"head_{head}")(pooled.float())
               for head in self.head_structure}
        return (out, sown) if return_intermediates else out
