"""Flash attention over packed ``[B, L, H*Dh]`` activations (K1).

Counterpart of the JAX package's
``ops/flash_attention_packed.flash_attention_packed``, whose Pallas
``_fwd_kernel`` it replaces on the card with the hand-written CUDA kernel
of ``csrc/flash_fwd.cu`` (that file's note says what bounds it and how it
is laid out). Heads stay column blocks of the packed feature axis, and a
fused ``qkv`` ``[B, L, 3D]`` is read through strided views at column
offsets 0, D and 2D: no q/k/v slice and no transpose is copied on either
side of the kernel. On a CPU tensor it runs the plain version; on a CUDA
tensor it launches the kernel or raises.

The fused output projection (``wo``) of the JAX function is off by default
there and not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from deepcoro_clip_tpu_torch.ops._flash_cuda import flash_fwd
from deepcoro_clip_tpu_torch.ops.attention import multi_head_attention

LANE = 128


def _heads(t: torch.Tensor, H: int) -> torch.Tensor:
    """[B, L, H*Dh] (any row stride) -> [B, H, L, Dh] view, no copy."""
    B, L, D = t.shape
    return t.unflatten(2, (H, D // H)).permute(0, 2, 1, 3)


def flash_attention_packed(
    q: Optional[torch.Tensor] = None,
    k: Optional[torch.Tensor] = None,
    v: Optional[torch.Tensor] = None,
    *,
    qkv: Optional[torch.Tensor] = None,
    num_heads: int,
    sin: Optional[torch.Tensor] = None,
    cos: Optional[torch.Tensor] = None,
    kv_mask: Optional[torch.Tensor] = None,
    causal: bool = False,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Either ``q``/``k``/``v`` (each ``[B, L, D]``) or one fused ``qkv``
    ``[B, L, 3D]`` (self-attention, split q|k|v). Requires
    ``Dh % 128 == 0``. Returns ``[B, Lq, D]``."""
    if qkv is not None:
        B, Lq, D3 = qkv.shape
        D = D3 // 3
        q, k, v = qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]
    else:
        B, Lq, D = q.shape
    Lk = k.shape[1]
    H = num_heads
    dh = D // H
    if dh % LANE != 0:
        raise ValueError(f"packed attention requires Dh%128==0, got Dh={dh}")
    if sin is not None and Lq != Lk:
        raise ValueError("RoPE packed attention requires self-attention")
    scale_v = float(scale if scale is not None else dh ** -0.5)
    qh, kh, vh = _heads(q, H), _heads(k, H), _heads(v, H)
    if q.device.type == "cpu":
        m = None if kv_mask is None else kv_mask != 0
        out = multi_head_attention(qh, kh, vh, sin=sin, cos=cos, kv_mask=m,
                                   causal=causal, scale=scale_v)
        return out.permute(0, 2, 1, 3).reshape(B, Lq, D)
    out = torch.empty((B, Lq, D), dtype=q.dtype, device=q.device)
    flash_fwd(qh, kh, vh, _heads(out, H), sin=sin, cos=cos, kv_mask=kv_mask,
              causal=causal, scale=scale_v)
    flash_attention_packed.launches += 1
    return out


flash_attention_packed.launches = 0  # kernel launches, for checks that the path ran it
