"""Plain multi-head attention with fused rotate-half RoPE, and its backward.

The port's counterpart of the JAX package's ``ops/attention.py`` and the
plain version that the CUDA attention kernels are held against. Softmax
statistics are fp32 whatever the compute dtype (float64 for float64
inputs); masked logits take ``finfo(float32).min`` (a finite value), so a
query row with no valid key comes out as the uniform mean of ``v`` over
the real keys.

``project_plain`` is the output projection as the fused-projection kernel
rounds it. ``flash_bwd_plain`` is the backward written out on tensors (Dao's formula
with the rounding points of the JAX package's Pallas ``_bwd_kernel``s): the
plain version of the CUDA backward kernels, and what the attention
``autograd.Function`` runs for a CPU tensor.
"""

from __future__ import annotations

from typing import Optional, Tuple

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


def unapply_rope(g: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """Transpose of ``apply_rope``: ``g * cos - rotate_half(g * sin)``."""
    return g * cos - rotate_half(g * sin)


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def _masked(B, Lq, Lk, kv_mask, causal, device) -> Optional[torch.Tensor]:
    """bool [B or 1, 1, Lq or 1, Lk], True where the score is masked."""
    masked = None
    if kv_mask is not None:
        masked = ~kv_mask.bool()[:, None, None, :]
    if causal:
        future = (torch.arange(Lq, device=device)[:, None]
                  < torch.arange(Lk, device=device)[None, :])[None, None]
        masked = future if masked is None else masked | future
    return masked


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
    acc = _acc_dtype(q.dtype)
    logits = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)) * scale
    masked = _masked(q.shape[0], q.shape[2], k.shape[2], kv_mask, causal, q.device)
    if masked is not None:
        logits = logits.masked_fill(masked, NEG)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


def project_plain(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """``out @ wo`` as the fused-projection kernel computes it: ``out``
    ``[B, L, D]`` is the attention output already rounded to the operand
    type, ``wo`` ``[D, Dout]`` has that type too, the products are summed in
    fp32 (fp64 for fp64 operands) and the sum is rounded once."""
    acc = _acc_dtype(out.dtype)
    return torch.matmul(out.to(acc), wo.to(acc)).to(out.dtype)


def flash_bwd_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    do: torch.Tensor,
    out: torch.Tensor,
    sin: Optional[torch.Tensor] = None,
    cos: Optional[torch.Tensor] = None,
    kv_mask: Optional[torch.Tensor] = None,
    causal: bool = False,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients ``(dq, dk, dv)`` of ``multi_head_attention`` for the output
    gradient ``do``, given the forward's ``out`` (all ``[B, H, L, Dh]``).

    With ``acc`` = fp32 (fp64 for fp64 inputs) and ``dt`` the inputs' type:
    P is the forward's softmax in ``acc`` and is rounded to ``dt`` before
    ``P^T do``; ``delta = rowsum(do * out)`` in ``acc`` from the ``dt``
    ``out``; ``ds = P * (dP - delta) * scale`` is rounded to ``dt`` before
    both of its products and is 0 wherever the score was masked (no
    gradient flows through a masked score, also on a row with no valid
    key, whose uniform P still feeds ``dv``); every product sums in
    ``acc``; ``dq`` and ``dk`` go through the transpose of RoPE in ``acc``,
    with the tables rounded to ``dt`` as the forward used them, before the
    cast to ``dt``.
    """
    dt, acc = q.dtype, _acc_dtype(q.dtype)
    if sin is not None:
        q = apply_rope(q, sin, cos)
        k = apply_rope(k, sin, cos)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    qa, ka, va, ga = q.to(acc), k.to(acc), v.to(acc), do.to(acc)
    logits = torch.matmul(qa, ka.transpose(-1, -2)) * scale
    masked = _masked(q.shape[0], q.shape[2], k.shape[2], kv_mask, causal, q.device)
    if masked is not None:
        logits = logits.masked_fill(masked, NEG)
    p = torch.softmax(logits, dim=-1)
    dv = torch.matmul(p.to(dt).to(acc).transpose(-1, -2), ga)
    dp = torch.matmul(ga, va.transpose(-1, -2))
    delta = (ga * out.to(acc)).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta) * scale
    if masked is not None:
        ds = ds.masked_fill(masked, 0.0)
    ds = ds.to(dt).to(acc)
    dq = torch.matmul(ds, ka)
    dk = torch.matmul(ds.transpose(-1, -2), qa)
    if sin is not None:
        s, c = sin.to(dt).to(acc), cos.to(dt).to(acc)
        dq, dk = unapply_rope(dq, s, c), unapply_rope(dk, s, c)
    return dq.to(dt), dk.to(dt), dv.to(dt)
