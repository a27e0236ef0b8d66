"""Flash attention over packed ``[B, L, H*Dh]`` activations (K1, K2, K5).

Counterpart of the JAX package's
``ops/flash_attention_packed.flash_attention_packed``, whose Pallas
``_fwd_kernel`` and ``_bwd_kernel`` it replaces on the card with the
hand-written CUDA kernels of ``csrc/flash_fwd.cu`` and
``csrc/flash_bwd.cu`` (those files' notes say what bounds them and how they
are laid out). Heads stay column blocks of the packed feature axis, and a
fused ``qkv`` ``[B, L, 3D]`` is read through strided views at column
offsets 0, D and 2D: no q/k/v slice and no transpose is copied on either
side of the kernels, and the backward writes dq|dk|dv straight into one
``[B, L, 3D]`` gradient. On a CPU tensor it runs the plain versions; on a
CUDA tensor it launches the kernels or raises. ``launches`` and
``bwd_launches`` count the forward and backward kernel launches.

With ``wo`` the output projection rides in the forward kernel
(``csrc/flash_fwd_proj.cu``, replacing the Pallas ``_fwd_proj_kernel``): the
attention output never makes its round trip through device memory unless a
gradient is wanted, when it is the backward's residual. Such a forward
counts on ``proj_launches``, not on ``launches``; its backward is two
matrix products and the same backward kernels (``bwd_launches``). The JAX
wrapper's silent fall-backs to "kernel, then dot" have no counterpart here.
On the card the kernels of this entry take what the JAX wrapper takes at
Dh up to 512: bf16 or fp32 at any ``Dh % 128 == 0``. bf16 at Dh 128 runs
the Hopper kernels (K1, K2, K5), bf16 at Dh 256 to 512 the wide Hopper
kernels (K1, K5 and the backward K2); fp32 runs the CUDA-core
kernels of the same files (``_flash_cuda.fwd_symbol``, ``bwd_symbol``,
``proj_symbol`` name them). With ``wo``, ``H*Dh`` is at most 1024 (the
fused kernels' shared output tile) and, on the Hopper kernel at Dh 128,
``Dout % 128 == 0``; a call past those, at Dh above 512, or in another
type raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from deepcoro_clip_tpu_torch.ops._flash_cuda import attention, attention_proj

LANE = 128


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
    wo: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Either ``q``/``k``/``v`` (each ``[B, L, D]``) or one fused ``qkv``
    ``[B, L, 3D]`` (self-attention, split q|k|v). Requires
    ``Dh % 128 == 0`` (on the card also Dh <= 512). Returns ``[B, Lq, D]``.

    ``wo`` (``[D, Dout]``, cast to the operands' type): apply the output
    projection inside the kernel and return the projected ``[B, Lq, Dout]``
    (the bias stays with the caller)."""
    if qkv is not None:
        (B, Lq, D3), Lk = qkv.shape, qkv.shape[1]
        D = D3 // 3
    else:
        (B, Lq, D), Lk = q.shape, k.shape[1]
    H = num_heads
    dh = D // H
    if dh % LANE != 0:
        raise ValueError(f"packed attention requires Dh%128==0, got Dh={dh}")
    if sin is not None and Lq != Lk:
        raise ValueError("RoPE packed attention requires self-attention")
    scale_v = float(scale if scale is not None else dh ** -0.5)
    kw = dict(sin=sin, cos=cos, kv_mask=kv_mask, causal=causal, scale=scale_v,
              H=H, counter=flash_attention_packed)
    a, b, c, layout = (qkv, None, None, "fused") if qkv is not None else (
        q, k, v, "packed")
    if wo is None:
        return attention(a, b, c, layout=layout, **kw)
    if wo.dim() != 2 or wo.shape[0] != D:
        raise ValueError(f"wo must be [{D}, Dout], got {tuple(wo.shape)}")
    # one cast and one copy of the [D, Dout] weights per call
    wo = wo.to(a.dtype).contiguous()
    return attention_proj(a, b, c, wo, layout=layout, **kw)


# kernel launches, for checks that the path ran them
flash_attention_packed.launches = 0
flash_attention_packed.bwd_launches = 0
flash_attention_packed.proj_launches = 0  # forwards with the projection fused in
