"""Flash attention on the ``[B, H, L, Dh]`` layout (K3, K4 of the TPU kernels).

Counterpart of the JAX package's ``ops/flash_attention.flash_attention``,
whose Pallas ``_fwd_kernel`` and ``_bwd_kernel`` it replaces on the card
with hand-written CUDA kernels: at Lq, Lk <= 64 (every call of the main
paths: the multi-video aggregator, the probing head's CLS block) the
one-launch forward and backward of ``csrc/flash_short.cu``, above that the
64-row tile kernels of ``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu``
(those files' notes say what bounds them and how they are laid out). On a CPU tensor it runs the plain versions
(``ops/attention.py``); on a CUDA tensor it launches the kernels or raises.
``launches`` and ``bwd_launches`` count the forward and backward kernel
launches.
"""

from __future__ import annotations

from typing import Optional

import torch

from deepcoro_clip_tpu_torch.ops._flash_cuda import attention


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    sin: Optional[torch.Tensor] = None,
    cos: Optional[torch.Tensor] = None,
    kv_mask: Optional[torch.Tensor] = None,
    causal: bool = False,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """q: ``[B, H, Lq, Dh]``, k/v: ``[B, H, Lk, Dh]`` (Lq may differ from
    Lk without RoPE); sin/cos: ``[L, Dh]`` RoPE tables (self-attention);
    kv_mask: ``[B, Lk]``, nonzero = attend. Returns ``[B, H, Lq, Dh]``.

    On CUDA the kernel takes bf16 and Dh 64 or 128; anything else raises.
    """
    B, H, Lq, Dh = q.shape
    Lk = k.shape[2]
    if Dh % 2:
        raise ValueError(f"head dim must be even, got {Dh}")
    if sin is not None and Lq != Lk:
        raise ValueError("RoPE flash attention requires self-attention (Lq == Lk)")
    scale_v = float(scale if scale is not None else Dh ** -0.5)
    return attention(q, k, v, sin=sin, cos=cos, kv_mask=kv_mask, causal=causal,
                     scale=scale_v, layout="heads", H=H,
                     counter=flash_attention)


# kernel launches, for checks that the path ran them
flash_attention.launches = 0
flash_attention.bwd_launches = 0
