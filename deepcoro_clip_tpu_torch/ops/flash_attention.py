"""Flash attention on the ``[B, H, L, Dh]`` layout (K3, K4 of the TPU kernels).

Counterpart of the JAX package's ``ops/flash_attention.flash_attention``,
whose Pallas ``_fwd_kernel`` and ``_bwd_kernel`` it replaces on the card
with hand-written CUDA kernels: at Lq, Lk <= 64 (the multi-video
aggregator, the probing head's CLS block) the one-launch forward and
backward of ``csrc/flash_short.cu``; above that (the text tower, the
SigLIP bank, the captioning decoder) in bf16 the Hopper kernels of
``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu`` (wgmma, TMA, mbarriers; key
tiles past each q tile's last real key skipped, exactly), in fp32 the plain
fp32 kernels there (those files' notes say what bounds them and how they
are laid out). On a CPU tensor it runs the plain versions
(``ops/attention.py``); on a CUDA tensor it launches the kernels or raises.
A head dim under 64 (Dh 32: the single-video aggregator of
``siglip_multi_positive_config.yaml``, 16 heads of 512) is zero-padded to
64, as the JAX wrapper pads every head dim to 128 for the Pallas kernels:
zero columns add nothing to q·k, and the padded output columns are cut
off. ``launches`` and ``bwd_launches``
count the forward and backward kernel launches; ``long_launches`` and
``long_bwd_launches`` those of them that ran the long bf16 Hopper kernels.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from deepcoro_clip_tpu_torch.ops._flash_cuda import HEAD_DIMS, attention


def kernel_head_dim(Dh: int, rope: bool) -> int:
    """The head dim a CUDA call at ``Dh`` runs at: ``Dh`` itself if the
    kernels take it, 64 for a smaller one without RoPE (the rotated halves
    would have to move apart); anything else raises."""
    if Dh in HEAD_DIMS:
        return Dh
    if Dh < HEAD_DIMS[0] and not rope:
        return HEAD_DIMS[0]
    raise ValueError(f"the CUDA flash kernel takes Dh in {HEAD_DIMS}, got {Dh}"
                     + (" with RoPE" if rope and Dh < HEAD_DIMS[0] else ""))


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

    On CUDA the kernel takes bf16 or fp32 at Dh 64 or 128 (a Dh under 64
    without RoPE is padded, see above); anything else raises.
    """
    B, H, Lq, Dh = q.shape
    Lk = k.shape[2]
    if Dh % 2:
        raise ValueError(f"head dim must be even, got {Dh}")
    if sin is not None and Lq != Lk:
        raise ValueError("RoPE flash attention requires self-attention (Lq == Lk)")
    scale_v = float(scale if scale is not None else Dh ** -0.5)
    dk = kernel_head_dim(Dh, sin is not None) if q.is_cuda else Dh
    if dk != Dh:
        q, k, v = (F.pad(t, (0, dk - Dh)) for t in (q, k, v))
    out = attention(q, k, v, sin=sin, cos=cos, kv_mask=kv_mask, causal=causal,
                    scale=scale_v, layout="heads", H=H, counter=flash_attention)
    return out if dk == Dh else out[..., :Dh]


# kernel launches, for checks that the path ran them
flash_attention.launches = 0
flash_attention.bwd_launches = 0
flash_attention.long_launches = 0
flash_attention.long_bwd_launches = 0
