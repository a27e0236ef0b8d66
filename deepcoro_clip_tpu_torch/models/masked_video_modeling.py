"""Masked video modeling (MAE-style) auxiliary task.

Port of the JAX package's ``models/masked_video_modeling.py``: a random
token mask at ``mask_ratio``, a learnable mask token, a light transformer
decoder, and the MSE to the (normalized) encoder tokens over the masked
positions only.

The mask comes from an explicit ``torch.Generator``. The JAX package draws
it from ``jax.random``, which torch cannot reproduce, so the two packages'
masks differ while the count per row (``round(L * ratio)``) and everything
computed from a given mask agree; tests hand both the same mask.

The decoder's blocks run the plain attention (``use_flash=False``, as the
JAX multitask bundle builds them: Dh 32 at the multitask widths), so no
kernel is involved here.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from deepcoro_clip_tpu_torch.models.layers import Dense, LayerNorm, TransformerBlock
from deepcoro_clip_tpu_torch.parallel.distributed import global_ratio


def random_token_mask(generator: Optional[torch.Generator], B: int, L: int,
                      mask_ratio: float, device=None) -> torch.Tensor:
    """``[B, L]`` bool, True = masked: exactly ``round(L * mask_ratio)`` per
    row, the rows' lowest ranks of uniform noise drawn from ``generator``
    (which must live on ``device``)."""
    n_mask = int(round(L * mask_ratio))
    noise = torch.rand((B, L), generator=generator, device=device)
    ranks = noise.argsort(dim=1).argsort(dim=1)
    return ranks < n_mask


class MaskedVideoModeling(nn.Module):
    def __init__(self, dim: int = 512, num_tokens: int = 393, decoder_dim: int = 256,
                 decoder_depth: int = 2, num_heads: int = 8, mask_ratio: float = 0.75,
                 norm_targets: bool = True, dtype: torch.dtype = torch.bfloat16,
                 use_flash: bool = False):
        """``num_tokens``: the encoder's tokens per clip (the length of the
        learned positions, which a flax module sizes at its first call)."""
        super().__init__()
        self.decoder_dim, self.decoder_depth = decoder_dim, decoder_depth
        self.mask_ratio, self.norm_targets, self.dtype = mask_ratio, norm_targets, dtype
        self.enc_proj = Dense(dim, decoder_dim, dtype)
        self.mask_token = nn.Parameter(torch.zeros(1, 1, decoder_dim))
        self.pos_emb = nn.Parameter(torch.zeros(1, num_tokens, decoder_dim))
        for i in range(decoder_depth):
            self.add_module(f"block{i}", TransformerBlock(
                decoder_dim, num_heads, dtype=dtype, use_flash=use_flash))
        self.norm = LayerNorm(decoder_dim)
        self.pred = Dense(decoder_dim, dim, torch.float32)

    def forward(self, tokens, mask, deterministic: bool = True,
                generator=None) -> Dict[str, torch.Tensor]:
        """tokens: ``[B, L, dim]`` encoder tokens (the targets); mask:
        ``[B, L]`` bool, True = masked. Returns {"loss", "pred", "mask"}."""
        x = self.enc_proj(tokens)
        x = torch.where(mask[..., None], self.mask_token.to(x.dtype), x)
        x = x + self.pos_emb.to(x.dtype)
        for i in range(self.decoder_depth):
            x = getattr(self, f"block{i}")(x, deterministic=deterministic,
                                           generator=generator)
        pred = self.pred(self.norm(x).to(self.dtype))  # [B, L, dim] fp32

        target = tokens.float()
        if self.norm_targets:
            mu = target.mean(-1, keepdim=True)
            var = target.var(-1, keepdim=True, unbiased=False)
            target = (target - mu) / torch.sqrt(var + 1e-6)
        per_tok = ((pred - target) ** 2).mean(-1)  # [B, L]
        m = mask.float()
        # the masked patches of the global batch, under data parallelism
        loss = global_ratio((per_tok * m).sum(), m.sum())
        return {"loss": loss, "pred": pred, "mask": mask}
