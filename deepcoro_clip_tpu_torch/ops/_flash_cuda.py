"""ctypes launcher of the CUDA flash-attention forward (``csrc/flash_fwd.cu``).

Shared by ``flash_attention`` and ``flash_attention_packed``: both hand it
``[B, H, L, Dh]`` views (any batch/head/row strides, head dim contiguous)
of their operands and of an output they allocated. It checks what the
kernel takes, launches on PyTorch's current stream, and raises if the
launch failed. It counts nothing: each entry point counts its own
launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from deepcoro_clip_tpu_torch.ops import _build

HEAD_DIMS = (64, 128)
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _fn():
    lib = _build.load("flash_fwd")
    fn = lib.deepcoro_flash_fwd_bf16
    if fn.argtypes is None:
        fn.argtypes = ([_P] * 8 + [_I] * 5 + [_LL] * 12
                       + [ctypes.c_float, _I, _P])
        fn.restype = ctypes.c_int
    return fn


def _check_operand(name: str, t: torch.Tensor, device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.bfloat16:
        raise TypeError(
            f"the CUDA flash kernel takes bfloat16, got {name} {t.dtype}")
    if t.stride(-1) != 1:
        raise ValueError(f"{name}: the head dim must be contiguous")
    if t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3]):
        raise ValueError(
            f"{name}: base and strides must allow 16-byte loads "
            f"(ptr % 16 == 0, strides % 8 == 0), got strides {t.stride()}")


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              out: torch.Tensor, *, sin: Optional[torch.Tensor],
              cos: Optional[torch.Tensor], kv_mask: Optional[torch.Tensor],
              causal: bool, scale: float) -> None:
    """Write attention of ``q`` over ``k``/``v`` into ``out`` (all views
    ``[B, H, L, Dh]`` on one CUDA device, bf16)."""
    device = q.device
    if device.type != "cuda":
        raise ValueError(f"flash_fwd needs CUDA tensors, got {device}")
    B, H, Lq, Dh = q.shape
    Lk = k.shape[2]
    if Dh not in HEAD_DIMS:
        raise ValueError(f"the CUDA flash kernel takes Dh in {HEAD_DIMS}, got {Dh}")
    if k.shape != (B, H, Lk, Dh) or v.shape != (B, H, Lk, Dh):
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if out.shape != q.shape:
        raise ValueError(f"out shape {tuple(out.shape)} != q {tuple(q.shape)}")
    if Lq < 1 or Lk < 1 or B * H > 65535:
        raise ValueError(f"unsupported sizes B*H={B * H}, Lq={Lq}, Lk={Lk}")
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        _check_operand(name, t, device)
    if sin is not None:
        if Lq != Lk:
            raise ValueError("RoPE flash attention requires Lq == Lk")
        for name, t in (("sin", sin), ("cos", cos)):
            if (t is None or t.shape != (Lq, Dh) or t.dtype != torch.float32
                    or t.device != device or not t.is_contiguous()):
                raise ValueError(
                    f"{name} must be a contiguous float32 [{Lq}, {Dh}] tensor "
                    f"on {device}")
    # RoPE of K is applied once, by a pre-pass, into this scratch copy
    k_rot = None if sin is None else torch.empty(
        (B, H, Lk, Dh), dtype=torch.bfloat16, device=device)
    mask = None
    if kv_mask is not None:
        if kv_mask.shape != (B, Lk) or kv_mask.device != device:
            raise ValueError(f"kv_mask must be [{B}, {Lk}] on {device}, "
                             f"got {tuple(kv_mask.shape)} on {kv_mask.device}")
        mask = (kv_mask != 0).to(torch.uint8).contiguous()

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = _fn()(
        ptr(q), ptr(k), ptr(v), ptr(out), ptr(sin), ptr(cos), ptr(mask), ptr(k_rot),
        B, H, Lq, Lk, Dh,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        float(scale), int(bool(causal)),
        torch.cuda.current_stream(device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_fwd launch failed: CUDA error {err}")
