"""Token pooling heads, the port of the JAX package's ``models/attention_pool.py``.

- ``AttentionPool``: a learnable query attends over the tokens (the
  cross-attention path of ``Attention``), then LayerNorm (eps 1e-5) and an
  optional projection when the output width differs: ``[B, L, D] -> [B, D]``.
- ``AttentionPoolWithCLS``: a learnable CLS token is prepended, transformer
  blocks run over the sequence, and the CLS position is normalised and
  returned.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from deepcoro_clip_tpu_torch.models.layers import (
    Attention,
    Dense,
    LayerNorm,
    TransformerBlock,
)


def prepend_cls(cls: torch.Tensor, x: torch.Tensor, mask: Optional[torch.Tensor]):
    """``cls`` ``[1, 1, D]`` in front of ``x`` ``[B, N, D]`` (in x's type),
    and an always-valid slot in front of ``mask`` ``[B, N]``."""
    B = x.shape[0]
    x = torch.cat([cls.to(x.dtype).expand(B, 1, x.shape[2]), x], dim=1)
    if mask is not None:
        mask = torch.cat([torch.ones((B, 1), dtype=mask.dtype, device=mask.device),
                          mask], dim=1)
    return x, mask


class AttentionPool(nn.Module):
    def __init__(self, dim: int, num_heads: int = 8, dropout: float = 0.0,
                 dtype: torch.dtype = torch.bfloat16, use_flash: bool = True,
                 output_dim: Optional[int] = None):
        super().__init__()
        self.dim, self.dtype = dim, dtype
        self.query = nn.Parameter(torch.zeros(1, 1, dim))
        self.attn = Attention(dim, num_heads, dropout, dtype, use_flash, cross=True)
        self.norm = LayerNorm(dim, eps=1e-5)
        if output_dim is not None and output_dim != dim:
            self.out_proj = Dense(dim, output_dim, dtype)

    def forward(self, x, mask: Optional[torch.Tensor] = None,
                deterministic: bool = True, generator=None):
        """x: ``[B, L, D]``; mask: ``[B, L]`` (True = keep) ->
        ``[B, output_dim or D]``."""
        q = self.query.expand(x.shape[0], 1, self.dim).to(self.dtype)
        out = self.attn(q, context=x, kv_mask=mask, deterministic=deterministic,
                        generator=generator)[:, 0, :]
        out = self.norm(out).to(self.dtype)
        return self.out_proj(out) if hasattr(self, "out_proj") else out


class AttentionPoolWithCLS(nn.Module):
    def __init__(self, dim: int, num_heads: int = 8, depth: int = 1,
                 dropout: float = 0.0, dtype: torch.dtype = torch.bfloat16,
                 use_flash: bool = True, output_dim: Optional[int] = None):
        super().__init__()
        self.dim, self.depth = dim, depth
        self.cls = nn.Parameter(torch.zeros(1, 1, dim))
        for i in range(depth):
            self.add_module(f"block{i}", TransformerBlock(
                dim, num_heads, dropout=dropout, dtype=dtype, use_flash=use_flash))
        self.norm = LayerNorm(dim, eps=1e-5)
        if output_dim is not None and output_dim != dim:
            self.out_proj = Dense(dim, output_dim, dtype)

    def forward(self, x, mask: Optional[torch.Tensor] = None,
                deterministic: bool = True, generator=None):
        """x: ``[B, L, D]`` -> ``[B, output_dim or D]`` (the CLS position)."""
        x, mask = prepend_cls(self.cls, x, mask)
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x, kv_mask=mask, deterministic=deterministic,
                                           generator=generator)
        out = self.norm(x[:, 0, :]).to(x.dtype)
        return self.out_proj(out) if hasattr(self, "out_proj") else out
