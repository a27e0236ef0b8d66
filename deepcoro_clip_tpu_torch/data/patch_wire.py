"""Patch-major uint8 wire: host-side space-to-depth (numpy).

The port's copy of the JAX package's ``data/patch_wire.py`` without its
native binding: videos travel as ``[B, N, L, K]`` uint8 with
``L = T'·H'·W'`` tokens and ``K = pt·ph·pw·C`` bytes per patch, in the K
order ``((dt*ph + dh)*pw + dw)*C + c`` that the patchify weights use.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def patch_grid(frames: int, height: int, width: int,
               patch: Tuple[int, int, int]) -> Tuple[int, int, int]:
    """Token-grid dims (T', H', W') for a clip shape under ``patch``."""
    pt, ph, pw = patch
    if frames % pt or height % ph or width % pw:
        raise ValueError(
            f"patch wire requires whole patches: clip {frames}x{height}x"
            f"{width} vs patch {patch}"
        )
    return frames // pt, height // ph, width // pw


def space_to_depth(clip: np.ndarray,
                   patch: Tuple[int, int, int]) -> np.ndarray:
    """[T, H, W, C] uint8 -> [L, K] uint8."""
    return patchify_videos(clip, patch)


def patchify_videos(videos: np.ndarray,
                    patch: Tuple[int, int, int]) -> np.ndarray:
    """[..., T, H, W, C] uint8 -> [..., L, K] uint8, any leading dims."""
    if videos.dtype != np.uint8:
        raise TypeError(f"patch wire is uint8-only, got {videos.dtype}")
    pt, ph, pw = patch
    lead = videos.shape[:-4]
    T, H, W, C = videos.shape[-4:]
    Tn, Hn, Wn = patch_grid(T, H, W, patch)
    n = len(lead)
    p = videos.reshape(lead + (Tn, pt, Hn, ph, Wn, pw, C))
    order = tuple(range(n)) + tuple(n + a for a in (0, 2, 4, 1, 3, 5, 6))
    return np.ascontiguousarray(
        p.transpose(order).reshape(lead + (Tn * Hn * Wn, pt * ph * pw * C)))
