"""Host-side clip load -> frame sample -> bilinear resize (numpy only).

The port's copy of the parts of the JAX package's ``data/video_io.py`` that
serving uses: ``.npy``/``.npz`` clips to uint8 frames for the patch wire.
Container decoding (cv2), host normalization to float32, the mono wire and
RandAugment are not part of the port yet.

The resize follows the half-pixel-centre convention
(``src = (dst + 0.5) * in / out - 0.5``, clamped; vertical blend, then
horizontal, in float32) with round-half-up to uint8. That is what the JAX
package runs wherever its native library or cv2 is present, so the two
agree to within one uint8 level; the JAX package's last-resort numpy
fallback (corner-aligned) is not copied.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np


def _load_raw(path: str) -> np.ndarray:
    """[F, H, W, C] from a .npy/.npz clip; grayscale becomes 3 channels."""
    suffix = Path(path).suffix.lower()
    if suffix == ".npy":
        arr = np.load(path)
    elif suffix == ".npz":
        with np.load(path) as z:
            arr = z[list(z.keys())[0]]
    else:
        raise ValueError(f"only .npy/.npz clips are supported, got {path}")
    arr = np.asarray(arr)
    if arr.ndim == 3:  # [F, H, W] grayscale
        arr = arr[..., None]
    if arr.shape[-1] == 1:
        arr = np.repeat(arr, 3, axis=-1)
    return arr


def sample_frame_indices(
    total: int, n_frames: int, stride: int, rng: Optional[np.random.Generator]
) -> np.ndarray:
    """Stride subsample (random phase when ``rng`` is given), then pad with
    the last index or pick ``n_frames`` evenly spaced ones."""
    idx = np.arange(0, total, max(1, stride))
    if rng is not None and stride > 1 and total > stride:
        phase = int(rng.integers(0, stride))
        idx = np.arange(phase, total, stride)
    if len(idx) >= n_frames:
        if rng is not None and len(idx) > n_frames:
            start = int(rng.integers(0, len(idx) - n_frames + 1))
            idx = idx[start:start + n_frames]
        else:
            idx = idx[np.linspace(0, len(idx) - 1, n_frames).round().astype(int)]
    else:
        pad = np.full(n_frames - len(idx), idx[-1] if len(idx) else 0)
        idx = np.concatenate([idx, pad])
    return idx.astype(np.int64)


def _axis_plan(n_in: int, n_out: int):
    f = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) \
        * (np.float32(n_in) / np.float32(n_out)) - np.float32(0.5)
    f = np.maximum(f, np.float32(0.0))
    i0 = np.minimum(f.astype(np.int64), n_in - 1)
    i1 = np.minimum(i0 + 1, n_in - 1)
    return i0, i1, (f - i0).astype(np.float32)


def _resize_frames(frames: np.ndarray, size: int) -> np.ndarray:
    """[F, H, W, C] -> [F, size, size, C] float32, bilinear."""
    F, H, W, C = frames.shape
    y0, y1, wy = _axis_plan(H, size)
    x0, x1, wx = _axis_plan(W, size)
    f = frames.astype(np.float32)
    a, b = f[:, y0], f[:, y1]
    rows = a + (b - a) * wy[None, :, None, None]
    a, b = rows[:, :, x0], rows[:, :, x1]
    return a + (b - a) * wx[None, None, :, None]


def load_video(path: str, n_frames: int = 16, resize: int = 224) -> np.ndarray:
    """[n_frames, resize, resize, 3] uint8: raw [0, 255] pixels for the uint8
    wire (the device folds normalization into the patchify weights); frames
    sampled with stride 1, as the JAX server samples them."""
    raw = _load_raw(path)
    frames = raw[sample_frame_indices(raw.shape[0], n_frames, 1, None)]
    if frames.shape[1:3] != (resize, resize):
        # round half up, as the native resize stores
        frames = np.floor(np.clip(_resize_frames(frames, resize), 0, 255)
                          + np.float32(0.5))
    elif frames.dtype != np.uint8:
        frames = np.clip(frames, 0, 255).round()
    return np.ascontiguousarray(frames, dtype=np.uint8)
