"""The attention kernels' ``torch.library`` boundary (forward only).

Two operators in the ``deepcoro`` namespace carry the forward launchers
that inference reaches, so that ``torch.export`` keeps each call as one
opaque node whose body launches the hand-written kernel:

- ``deepcoro::attention``: ``attention_forward`` of ``ops/_flash_cuda.py``
  without row statistics. The ``"packed"`` and ``"fused"`` layouts are K1
  (``csrc/flash_fwd.cu``: the Hopper kernels in bf16 at Dh 128 and at 256
  to 512, the CUDA-core kernels in fp32; RoPE, key mask, causal); the
  ``"heads"`` layout is K3 (``csrc/flash_short.cu`` at Lq, Lk <= 64 and Dh
  <= 128, else the long bf16 Hopper kernel at Dh 64 / 128, the wide one at
  256 to 512, or an fp32 kernel of ``csrc/flash_fwd.cu``; bf16 or fp32, Dh
  64 to 512, the caller having padded any other Dh);
- ``deepcoro::attention_proj``: ``attention_proj_forward`` without
  residuals, K5 (``csrc/flash_fwd_proj.cu``, packed or fused, bf16 or fp32,
  the output projection ``wo`` inside the kernel).

The fake kernels give the output in the inputs' type, so a model built at
``precision: fp32`` exports as one at bf16 does.

Each has a kernel per device: on the CPU the plain versions
(``ops/attention.multi_head_attention``, ``project_plain``), on CUDA the
launcher, which launches or raises; a fake kernel gives the output's shape
and type without touching data, which is all ``torch.export`` runs. The
launch counters are attributes of the entry points and cannot cross the
schema, so the CUDA kernel counts on the entry point of its layout:
``flash_attention`` for ``"heads"``, ``flash_attention_packed`` for the
packed layouts. A program loaded from disk therefore counts its launches as
the eager modules do.

The gradient path (``FlashAttention``, ``FlashAttentionProj``,
``ShortAttention``) does not go through these operators: a call that wants
a gradient is no operator call, and the backward kernels (K2, K4, K6) have
none.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor

from deepcoro_clip_tpu_torch.ops import _flash_cuda


def _counter(layout: str):
    """The entry point whose attributes count a layout's launches."""
    if layout == "heads":
        from deepcoro_clip_tpu_torch.ops.flash_attention import flash_attention
        return flash_attention
    from deepcoro_clip_tpu_torch.ops.flash_attention_packed import flash_attention_packed
    return flash_attention_packed


@torch.library.custom_op("deepcoro::attention", mutates_args=(), device_types="cpu")
def attention(a: Tensor, b: Optional[Tensor], c: Optional[Tensor], sin: Optional[Tensor],
              cos: Optional[Tensor], kv_mask: Optional[Tensor], causal: bool, scale: float,
              layout: str, H: int) -> Tensor:
    """Attention of q, k, v given in ``layout`` (``b``, ``c`` None for
    ``"fused"``); the output in that layout. CPU: the plain version."""
    out, _ = _flash_cuda.attention_forward(a, b, c, sin, cos, kv_mask, causal, scale,
                                           layout, H, _counter(layout), stats=False)
    return out.contiguous()


@attention.register_kernel("cuda")
def _attention_cuda(a, b, c, sin, cos, kv_mask, causal, scale, layout, H):
    out, _ = _flash_cuda.attention_forward(a, b, c, sin, cos, kv_mask, causal, scale,
                                           layout, H, _counter(layout), stats=False)
    return out


@attention.register_fake
def _attention_fake(a, b, c, sin, cos, kv_mask, causal, scale, layout, H):
    # the output has q's shape: a's, or a third of a fused q|k|v's width
    if layout == "fused":
        return a.new_empty((a.shape[0], a.shape[1], a.shape[2] // 3))
    return a.new_empty(a.shape)


@torch.library.custom_op("deepcoro::attention_proj", mutates_args=(), device_types="cpu")
def attention_proj(a: Tensor, b: Optional[Tensor], c: Optional[Tensor], wo: Tensor,
                   sin: Optional[Tensor], cos: Optional[Tensor], kv_mask: Optional[Tensor],
                   causal: bool, scale: float, layout: str, H: int) -> Tensor:
    """Packed attention followed by ``@ wo`` (``[D, Dout]``, q's type):
    ``[B, Lq, Dout]``. CPU: the plain versions."""
    y, _, _ = _flash_cuda.attention_proj_forward(a, b, c, wo, sin, cos, kv_mask, causal,
                                                 scale, layout, H, _counter(layout),
                                                 residuals=False)
    return y


@attention_proj.register_kernel("cuda")
def _attention_proj_cuda(a, b, c, wo, sin, cos, kv_mask, causal, scale, layout, H):
    y, _, _ = _flash_cuda.attention_proj_forward(a, b, c, wo, sin, cos, kv_mask, causal,
                                                 scale, layout, H, _counter(layout),
                                                 residuals=False)
    return y


@attention_proj.register_fake
def _attention_proj_fake(a, b, c, wo, sin, cos, kv_mask, causal, scale, layout, H):
    return a.new_empty((a.shape[0], a.shape[1], wo.shape[1]))
