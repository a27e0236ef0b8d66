"""Plain multi-head attention with fused rotate-half RoPE.

The port's counterpart of the JAX package's ``ops/attention.py`` and the
plain version that both CUDA attention kernels are held against. Softmax
statistics are fp32 whatever the compute dtype; masked logits take
``finfo(float32).min`` (a finite value), so a query row with no valid
key comes out as the uniform mean of ``v`` over the real keys.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG = torch.finfo(torch.float32).min


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """x: [..., L, Dh]; sin/cos: [L, Dh], cast to x's dtype first."""
    sin = sin.to(x.dtype)
    cos = cos.to(x.dtype)
    return x * cos + rotate_half(x) * sin


def multi_head_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    sin: Optional[torch.Tensor] = None,
    cos: Optional[torch.Tensor] = None,
    kv_mask: Optional[torch.Tensor] = None,
    causal: bool = False,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """q, k, v: ``[B, H, L, Dh]`` (k/v may have another length Lk);
    sin/cos: ``[L, Dh]`` for q and k; kv_mask: bool ``[B, Lk]``, True =
    attend; returns ``[B, H, Lq, Dh]`` in q's dtype."""
    if sin is not None:
        q = apply_rope(q, sin, cos)
        k = apply_rope(k, sin, cos)
    dh = q.shape[-1]
    scale = scale if scale is not None else dh ** -0.5
    # fp32 logits from the (possibly bf16) operands: products of bf16 values
    # are exact in fp32, so this is the JAX oracle's
    # preferred_element_type=float32 contraction
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if kv_mask is not None:
        logits = logits.masked_fill(~kv_mask.bool()[:, None, None, :], NEG)
    if causal:
        lq, lk = logits.shape[-2], logits.shape[-1]
        keep = (torch.arange(lq, device=q.device)[:, None]
                >= torch.arange(lk, device=q.device)[None, :])
        logits = logits.masked_fill(~keep, NEG)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)
