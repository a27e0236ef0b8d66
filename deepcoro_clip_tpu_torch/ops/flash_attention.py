"""Flash attention on the ``[B, H, L, Dh]`` layout (K3, K4 of the TPU kernels).

Counterpart of the JAX package's ``ops/flash_attention.flash_attention``,
whose Pallas ``_fwd_kernel`` and ``_bwd_kernel`` it replaces on the card
with hand-written CUDA kernels: at Lq, Lk <= 64 (the multi-video
aggregator, the probing head's CLS block) the one-launch forward and
backward of ``csrc/flash_short.cu``; above that (the text tower, the
SigLIP bank, the captioning decoder) in bf16 the Hopper kernels of
``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu`` (wgmma, TMA, mbarriers; key
tiles past each q tile's last real key skipped, exactly) at Dh 64 and 128,
the wide Hopper forward and backward at the padded widths 256 to 512, the
CUDA-core kernels in fp32
(those files' notes say what bounds them and how they are laid out). On a CPU tensor it runs the plain versions
(``ops/attention.py``); on a CUDA tensor it launches the kernels or raises.
Every even head dim is padded up to the next width a kernel takes
(``HEAD_DIMS``: 64, 128, 256, 384, 512; ``pad_head_dim``), as the JAX
wrapper pads every head dim up to a multiple of 128 for the Pallas kernels
(``_repack_halves``): zero columns add nothing to q·k, with RoPE each
rotate-half half is padded apart (sin 0, cos 1 in the pad, so the pad stays
0 and the pairs stay aligned), the scale stays the original
``Dh ** -0.5``, and the padded output columns are cut off. Dh 32 (the
single-video aggregator of ``siglip_multi_positive_config.yaml``, 16 heads
of 512, and the JAX tests' 3D-RoPE case) runs at 64; Dh 96 at 128; Dh 192
at 256; above 512 it raises. ``launches`` and ``bwd_launches``
count the forward and backward kernel launches; ``long_launches`` and
``long_bwd_launches`` those of them that ran the long bf16 Hopper kernels.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from deepcoro_clip_tpu_torch.ops._flash_cuda import HEAD_DIMS, attention, kernel_head_dim


def pad_head_dim(q, k, v, sin, cos, width: int):
    """q, k, v (``[..., Dh]``) and the RoPE tables (``[L, Dh]`` or None)
    zero-padded to ``width`` columns, as the JAX wrapper's ``_repack_halves``
    pads them: without RoPE every tensor at its end; with RoPE q, k and the
    tables half by half (``[x1, pad, x2, pad]``: the rotate-half partner of
    column i stays i + width / 2), sin padded with 0 and cos with 1, v at
    its end. The output's first Dh columns are the unpadded call's."""
    Dh = q.shape[-1]
    if width == Dh:
        return q, k, v, sin, cos
    if sin is None:
        q, k, v = (F.pad(t, (0, width - Dh)) for t in (q, k, v))
        return q, k, v, None, None
    half, pad = Dh // 2, (width - Dh) // 2

    def halves(t, fill):
        z = torch.full(t.shape[:-1] + (pad,), fill, dtype=t.dtype, device=t.device)
        return torch.cat([t[..., :half], z, t[..., half:], z], dim=-1)

    return (halves(q, 0.0), halves(k, 0.0), F.pad(v, (0, width - Dh)),
            halves(sin, 0.0), halves(cos, 1.0))


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

    On CUDA the kernels take bf16 or fp32 at every even Dh up to 512
    (padded, see above); anything else raises.
    """
    B, H, Lq, Dh = q.shape
    Lk = k.shape[2]
    if Dh % 2:
        raise ValueError(f"head dim must be even, got {Dh}")
    if sin is not None and Lq != Lk:
        raise ValueError("RoPE flash attention requires self-attention (Lq == Lk)")
    scale_v = float(scale if scale is not None else Dh ** -0.5)
    dk = kernel_head_dim(Dh) if q.is_cuda else Dh
    q, k, v, sin, cos = pad_head_dim(q, k, v, sin, cos, dk)
    out = attention(q, k, v, sin=sin, cos=cos, kv_mask=kv_mask, causal=causal,
                    scale=scale_v, layout="heads", H=H, counter=flash_attention)
    return out if dk == Dh else out[..., :Dh]


# kernel launches, for checks that the path ran them
flash_attention.launches = 0
flash_attention.bwd_launches = 0
flash_attention.long_launches = 0
flash_attention.long_bwd_launches = 0
