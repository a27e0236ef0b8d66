"""3D axial rotary position tables (numpy), the port's own copy.

Same tables as the JAX package's ``ops/rope3d.build_rope3d_tables``: the
head dim is laid out so that ONE global rotate-half applies the whole 3D
rotation, ``rope(x) = x * cos + rotate_half(x) * sin`` with per-dim
tables ``[L, head_dim]``; special (CLS) rows at the front are the
identity (sin 0, cos 1), and lanes left over after the three axes are
unrotated.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Rope3DTables:
    """sin/cos: float32 ``[n_special + T*H*W, head_dim]``."""

    sin: np.ndarray
    cos: np.ndarray
    head_dim: int
    thw: Tuple[int, int, int]
    n_special: int

    @property
    def length(self) -> int:
        return self.sin.shape[0]


def _axis_freqs(n_pairs: int, base: float = 10000.0) -> np.ndarray:
    return 1.0 / (base ** (np.arange(n_pairs, dtype=np.float64) / max(n_pairs, 1)))


def build_rope3d_tables(
    head_dim: int,
    T: int,
    H: int,
    W: int,
    n_special: int = 0,
    temporal_scale: float = 1.0,
    base: float = 10000.0,
) -> Rope3DTables:
    if head_dim % 2:
        raise ValueError(f"head_dim must be even, got {head_dim}")
    per_axis = head_dim // 6
    half = head_dim // 2
    L = T * H * W

    # per-token (t, h, w) coordinates, flattened T-major like the patchify
    tt, hh, ww = np.meshgrid(
        np.arange(T, dtype=np.float64) * temporal_scale,
        np.arange(H, dtype=np.float64),
        np.arange(W, dtype=np.float64),
        indexing="ij",
    )
    sin_half = np.zeros((L, half), dtype=np.float32)
    cos_half = np.ones((L, half), dtype=np.float32)
    off = 0
    for pos in (tt.reshape(L), hh.reshape(L), ww.reshape(L)):
        if per_axis == 0:
            continue
        ang = pos[:, None] * _axis_freqs(per_axis, base)[None, :]
        sin_half[:, off:off + per_axis] = np.sin(ang)
        cos_half[:, off:off + per_axis] = np.cos(ang)
        off += per_axis

    sin = np.concatenate([sin_half, sin_half], axis=1)
    cos = np.concatenate([cos_half, cos_half], axis=1)
    if n_special:
        sin = np.concatenate([np.zeros((n_special, head_dim), np.float32), sin], 0)
        cos = np.concatenate([np.ones((n_special, head_dim), np.float32), cos], 0)
    return Rope3DTables(sin=sin, cos=cos, head_dim=head_dim, thw=(T, H, W),
                        n_special=n_special)
