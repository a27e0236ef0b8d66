"""Study-level aggregation over per-video embeddings.

Port of the JAX package's ``models/video_aggregator.py``: learnable
positions over up to ``max_segments`` videos, ``depth`` pre-LN blocks whose
attention is masked by the study's video mask, a final fp32 LayerNorm, then
a learnable-query softmax (fp32) over the videos that falls back to
uniform weights when every video of a study is masked.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn

from deepcoro_clip_tpu_torch.models.layers import LayerNorm, TransformerBlock
from deepcoro_clip_tpu_torch.ops.attention import NEG


class EnhancedVideoAggregator(nn.Module):
    def __init__(self, dim: int, num_heads: int = 8, depth: int = 2,
                 dropout: float = 0.0, max_segments: int = 1024,
                 dtype: torch.dtype = torch.bfloat16, use_flash: bool = True):
        super().__init__()
        self.dim, self.depth, self.dtype = dim, depth, dtype
        self.pos_embedding = nn.Parameter(torch.zeros(1, max_segments, dim))
        for i in range(depth):
            self.add_module(f"block{i}", TransformerBlock(
                dim, num_heads, dropout=dropout, dtype=dtype, use_flash=use_flash))
        self.norm = LayerNorm(dim)
        self.query = nn.Parameter(torch.zeros(dim))

    def forward(self, x, mask: Optional[torch.Tensor] = None,
                deterministic: bool = True, generator=None):
        """x: [B, N, D] per-video embeddings; mask: [B, N], True = real
        video. Returns the [B, D] study embedding."""
        B, N, D = x.shape
        x = x + self.pos_embedding[:, :N].to(x.dtype)
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x, kv_mask=mask,
                                           deterministic=deterministic,
                                           generator=generator)
        x = self.norm(x)  # fp32
        scores = torch.einsum("bnd,d->bn", x, self.query) / math.sqrt(float(self.dim))
        if mask is not None:
            mask = mask.bool()
            scores = scores.masked_fill(~mask, NEG)
        weights = torch.softmax(scores, dim=-1)
        if mask is not None:
            any_valid = mask.any(dim=-1, keepdim=True)
            weights = torch.where(any_valid, weights, torch.full_like(weights, 1.0 / N))
        return torch.einsum("bn,bnd->bd", weights, x).to(self.dtype)
