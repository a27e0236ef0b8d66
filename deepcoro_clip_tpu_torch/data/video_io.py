"""Host-side clip load -> frame sample -> resize -> augment -> normalize.

The port's copy of the JAX package's ``data/video_io.py``, numpy only:
``.npy``/``.npz`` clips, or a video container decoded through cv2 (imported
inside ``_decode_container``; without cv2 a container raises, it does not
fall back); stride subsampling with a random phase in training; RandAugment
and the horizontal flip (``augment_frames``); raw uint8 frames for the
uint8 wire (the device folds the normalization into the patchify weights),
or host-normalized float32 ones; the one-channel mono wire. The native
``fastvideo`` library of the JAX package is not used.

The resize follows the half-pixel-centre convention
(``src = (dst + 0.5) * in / out - 0.5``, clamped; vertical blend, then
horizontal, in float32) with round-half-up to uint8. That is what the JAX
package runs wherever its native library or cv2 is present, so the two
agree to within one uint8 level; the JAX package's last-resort numpy
fallback (corner-aligned) is not copied.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

import numpy as np


def _decode_container(path: str, max_frames: int = 1024) -> np.ndarray:
    """A video container to [F, H, W, 3] uint8 (RGB), through cv2."""
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError(
            f"decoding {path} needs cv2 (opencv-python), which is not installed; "
            "only .npy/.npz clips load without it") from e
    cap = cv2.VideoCapture(path, cv2.CAP_FFMPEG)
    if not cap.isOpened():
        cap = cv2.VideoCapture(path)
    frames = []
    try:
        while len(frames) < max_frames:
            ok, frame = cap.read()
            if not ok:
                break
            if frame.ndim == 2:
                frame = frame[:, :, None]
            if frame.shape[2] == 1:
                frame = np.repeat(frame, 3, axis=2)
            else:
                frame = frame[:, :, ::-1]  # BGR -> RGB
            frames.append(frame)
    finally:
        cap.release()
    if not frames:
        raise ValueError(f"no frames decoded from {path}")
    return np.stack(frames)


def _load_raw(path: str) -> np.ndarray:
    """[F, H, W, C] from a .npy/.npz clip or a container; grayscale becomes
    3 channels."""
    suffix = Path(path).suffix.lower()
    if suffix == ".npy":
        arr = np.load(path)
    elif suffix == ".npz":
        with np.load(path) as z:
            arr = z[list(z.keys())[0]]
    else:
        arr = _decode_container(path)
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


def _resize_u8(frames: np.ndarray, size: int) -> np.ndarray:
    """Bilinear to ``size`` and round half up to uint8, as the native resize
    stores."""
    return np.floor(np.clip(_resize_frames(frames, size), 0, 255)
                    + np.float32(0.5)).astype(np.uint8)


def augment_frames(frames: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """The 50% horizontal flip, then RandAugment(magnitude=9, num_ops=2) on
    the uint8 clip (float clips are clipped to [0, 255] first)."""
    from deepcoro_clip_tpu_torch.data.randaugment import rand_augment_clip

    u8 = frames if frames.dtype == np.uint8 else np.clip(frames, 0, 255).astype(np.uint8)
    if rng.random() < 0.5:
        u8 = u8[:, :, ::-1, :]
    return rand_augment_clip(np.ascontiguousarray(u8), rng, magnitude=9, num_ops=2)


def load_video(
    path: str,
    n_frames: int = 16,
    resize: int = 224,
    stride: int = 1,
    mean: Optional[Sequence[float]] = None,
    std: Optional[Sequence[float]] = None,
    rand_augment: bool = False,
    rng: Optional[np.random.Generator] = None,
    output_dtype: str = "uint8",
    mono: bool = False,
) -> np.ndarray:
    """``[n_frames, resize, resize, 3]`` (``[..., 1]`` with ``mono``).

    ``output_dtype="uint8"`` (the default here; the JAX function's is
    float32): raw [0, 255] pixels for the uint8 wire, where the device
    folds the normalization into the patchify weights. ``"float32"``:
    ``(frames - mean) / std`` on the host (mean 0, std 1 where not given).
    ``rng`` draws the stride phase, the start frame and the augmentation
    (training); without it the frames are evenly spaced."""
    raw = _load_raw(path)
    if mono and raw.shape[-1] > 1:
        raw = np.ascontiguousarray(raw[..., :1])
    frames = raw[sample_frame_indices(raw.shape[0], n_frames, stride, rng)]
    if frames.shape[1:3] != (resize, resize):
        frames = (_resize_u8(frames, resize) if frames.dtype == np.uint8
                  or output_dtype == "uint8" else _resize_frames(frames, resize))
    if rand_augment and rng is not None:
        frames = augment_frames(frames, rng)
    if output_dtype == "uint8":
        if frames.dtype != np.uint8:
            frames = np.clip(frames, 0, 255).round()
        return np.ascontiguousarray(frames, dtype=np.uint8)
    frames = frames.astype(np.float32)
    m = np.asarray(mean if mean is not None else [0.0] * 3, np.float32)
    s = np.asarray(std if std is not None else [1.0] * 3, np.float32)
    if m.shape[0] > frames.shape[-1]:  # mono: channel-uniform stats
        m, s = m[: frames.shape[-1]], s[: frames.shape[-1]]
    frames = (frames - m) / np.maximum(s, 1e-6)
    return np.ascontiguousarray(frames, dtype=np.float32)
