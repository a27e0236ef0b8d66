"""RandAugment for video clips, numpy only.

The port's copy of the JAX package's ``data/randaugment.py`` without its
native backend: one sampled (op, magnitude sign) pair transforms every frame
of a ``[T, H, W, C]`` uint8 clip alike, with torchvision's magnitude scaling
(magnitude/30 of each op's maximum). The numpy ops are the ones the JAX
package holds its native ops to, and the sampling of ops and signs is the
same, so the two give the same clip from the same generator.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np

_MAX_LEVEL = 30.0


# --------------------------------------------------------------------- #
# geometry: one inverse-mapped bilinear affine warp serves rotate/shear/
# translate (replicate-pad sampling)
# --------------------------------------------------------------------- #


def _affine(clip: np.ndarray, matrix: np.ndarray) -> np.ndarray:
    """clip [T, H, W, C] uint8; matrix: 2x3 INVERSE map (out -> in)."""
    T, H, W, C = clip.shape
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    cx, cy = (W - 1) / 2.0, (H - 1) / 2.0
    x = xs - cx
    y = ys - cy
    sx = matrix[0, 0] * x + matrix[0, 1] * y + matrix[0, 2] + cx
    sy = matrix[1, 0] * x + matrix[1, 1] * y + matrix[1, 2] + cy
    x0 = np.clip(np.floor(sx).astype(int), 0, W - 1)
    y0 = np.clip(np.floor(sy).astype(int), 0, H - 1)
    x1 = np.clip(x0 + 1, 0, W - 1)
    y1 = np.clip(y0 + 1, 0, H - 1)
    wx = np.clip(sx, 0, W - 1) - x0
    wy = np.clip(sy, 0, H - 1) - y0
    f = clip.astype(np.float32)
    out = (
        f[:, y0, x0] * ((1 - wx) * (1 - wy))[None, :, :, None]
        + f[:, y0, x1] * (wx * (1 - wy))[None, :, :, None]
        + f[:, y1, x0] * ((1 - wx) * wy)[None, :, :, None]
        + f[:, y1, x1] * (wx * wy)[None, :, :, None]
    )
    return np.clip(out, 0, 255).astype(np.uint8)


def _rotate(clip, level, sign):
    theta = np.deg2rad(30.0 * level / _MAX_LEVEL) * sign
    c, s = np.cos(theta), np.sin(theta)
    return _affine(clip, np.array([[c, -s, 0.0], [s, c, 0.0]]))


def _shear_x(clip, level, sign):
    k = 0.3 * level / _MAX_LEVEL * sign
    return _affine(clip, np.array([[1.0, k, 0.0], [0.0, 1.0, 0.0]]))


def _shear_y(clip, level, sign):
    k = 0.3 * level / _MAX_LEVEL * sign
    return _affine(clip, np.array([[1.0, 0.0, 0.0], [k, 1.0, 0.0]]))


def _translate_x(clip, level, sign):
    t = clip.shape[2] * 0.45 * level / _MAX_LEVEL * sign
    return _affine(clip, np.array([[1.0, 0.0, -t], [0.0, 1.0, 0.0]]))


def _translate_y(clip, level, sign):
    t = clip.shape[1] * 0.45 * level / _MAX_LEVEL * sign
    return _affine(clip, np.array([[1.0, 0.0, 0.0], [0.0, 1.0, -t]]))


# --------------------------------------------------------------------- #
# photometric ops
# --------------------------------------------------------------------- #


def _blend(a: np.ndarray, b: np.ndarray, factor: float) -> np.ndarray:
    out = b.astype(np.float32) + factor * (
        a.astype(np.float32) - b.astype(np.float32))
    return np.clip(out, 0, 255).astype(np.uint8)


def _brightness(clip, level, sign):
    factor = 1.0 + 0.9 * level / _MAX_LEVEL * sign
    return _blend(clip, np.zeros_like(clip), factor)


def _contrast(clip, level, sign):
    factor = 1.0 + 0.9 * level / _MAX_LEVEL * sign
    mean = np.full_like(clip, int(clip.astype(np.float32).mean()))
    return _blend(clip, mean, factor)


def _color(clip, level, sign):
    factor = 1.0 + 0.9 * level / _MAX_LEVEL * sign
    gray = clip.astype(np.float32).mean(axis=-1, keepdims=True)
    gray = np.repeat(gray, clip.shape[-1], axis=-1).astype(np.uint8)
    return _blend(clip, gray, factor)


def _sharpness(clip, level, sign):
    factor = 1.0 + 0.9 * level / _MAX_LEVEL * sign
    f = clip.astype(np.float32)
    # 3x3 smoothing kernel ([[1,1,1],[1,5,1],[1,1,1]]/13, PIL's SMOOTH)
    pad = np.pad(f, ((0, 0), (1, 1), (1, 1), (0, 0)), mode="edge")
    smooth = (
        pad[:, :-2, :-2] + pad[:, :-2, 1:-1] + pad[:, :-2, 2:]
        + pad[:, 1:-1, :-2] + 5 * pad[:, 1:-1, 1:-1] + pad[:, 1:-1, 2:]
        + pad[:, 2:, :-2] + pad[:, 2:, 1:-1] + pad[:, 2:, 2:]
    ) / 13.0
    return _blend(clip, np.clip(smooth, 0, 255).astype(np.uint8), factor)


def _posterize(clip, level, sign):
    bits = 8 - int(4 * level / _MAX_LEVEL)
    mask = np.uint8(256 - (1 << (8 - bits)))
    return clip & mask


def _solarize(clip, level, sign):
    threshold = np.uint8(255 - int(255 * level / _MAX_LEVEL))
    return np.where(clip >= threshold, 255 - clip, clip)


def _autocontrast(clip, level, sign):
    f = clip.astype(np.float32)
    lo = f.min(axis=(0, 1, 2), keepdims=True)
    hi = f.max(axis=(0, 1, 2), keepdims=True)
    scale = 255.0 / np.maximum(hi - lo, 1.0)
    return np.clip((f - lo) * scale, 0, 255).astype(np.uint8)


def _equalize(clip, level, sign):
    out = np.empty_like(clip)
    for c in range(clip.shape[-1]):
        channel = clip[..., c]
        hist = np.bincount(channel.reshape(-1), minlength=256)
        nonzero = hist[hist > 0]
        if len(nonzero) <= 1:
            out[..., c] = channel
            continue
        step = (hist.sum() - nonzero[-1]) // 255
        if step == 0:
            out[..., c] = channel
            continue
        lut = np.clip((np.cumsum(hist) - hist) // step, 0, 255).astype(np.uint8)
        out[..., c] = lut[channel]
    return out


def _identity(clip, level, sign):
    return clip


OPS: Dict[str, Callable] = {
    "identity": _identity,
    "autocontrast": _autocontrast,
    "equalize": _equalize,
    "rotate": _rotate,
    "solarize": _solarize,
    "color": _color,
    "posterize": _posterize,
    "contrast": _contrast,
    "brightness": _brightness,
    "sharpness": _sharpness,
    "shear_x": _shear_x,
    "shear_y": _shear_y,
    "translate_x": _translate_x,
    "translate_y": _translate_y,
}


def rand_augment_clip(
    clip: np.ndarray,
    rng: np.random.Generator,
    magnitude: int = 9,
    num_ops: int = 2,
) -> np.ndarray:
    """Apply ``num_ops`` randomly chosen ops at ``magnitude`` to the whole
    clip [T, H, W, C] uint8 (the same parameters for every frame)."""
    assert clip.dtype == np.uint8, "RandAugment operates on uint8 pixels"
    names = list(OPS)
    for _ in range(num_ops):
        op_id = int(rng.integers(len(names)))
        sign = 1.0 if rng.random() < 0.5 else -1.0
        clip = OPS[names[op_id]](clip, float(magnitude), sign)
    return clip
