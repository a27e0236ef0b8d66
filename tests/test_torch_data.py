"""The port's host-side data path (numpy) against the JAX package's.

The JAX package lays out the patch wire and resizes with its native
library when it is built (round-half-up to uint8), else with cv2; the
port's numpy copies use the same half-pixel-centre bilinear. The patch
wire and unresized clips must match exactly; resized uint8 frames to
within one level.
"""

import numpy as np
import pytest

from deepcoro_clip_tpu.data import patch_wire as jpw
from deepcoro_clip_tpu.data import video_io as jvio

from deepcoro_clip_tpu_torch.data import patch_wire, video_io


@pytest.mark.parametrize("shape,patch", [((2, 3, 4, 32, 32, 3), (2, 16, 16)),
                                         ((4, 16, 24, 1), (2, 8, 8)),
                                         ((3, 6, 16, 16, 3), (3, 8, 4))])
def test_patchify_matches_jax_exactly(shape, patch):
    x = np.random.default_rng(0).integers(0, 256, size=shape, dtype=np.uint8)
    np.testing.assert_array_equal(patch_wire.patchify_videos(x, patch),
                                  jpw.patchify_videos(x, patch))
    clip = x.reshape((-1,) + shape[-4:])[0]
    np.testing.assert_array_equal(patch_wire.space_to_depth(clip, patch),
                                  jpw.space_to_depth(clip, patch))


def test_patch_wire_rejects_partial_patches_and_floats():
    with pytest.raises(ValueError, match="whole patches"):
        patch_wire.patchify_videos(np.zeros((3, 16, 16, 3), np.uint8), (2, 16, 16))
    with pytest.raises(TypeError, match="uint8"):
        patch_wire.patchify_videos(np.zeros((2, 16, 16, 3), np.float32), (2, 16, 16))


@pytest.mark.parametrize("total,n,stride,seed", [(40, 16, 1, None), (10, 16, 2, None),
                                                 (64, 16, 2, 3), (5, 8, 1, 4)])
def test_sample_frame_indices_match_jax(total, n, stride, seed):
    rng_a = None if seed is None else np.random.default_rng(seed)
    rng_b = None if seed is None else np.random.default_rng(seed)
    np.testing.assert_array_equal(
        video_io.sample_frame_indices(total, n, stride, rng_a),
        jvio.sample_frame_indices(total, n, stride, rng_b))


@pytest.mark.parametrize("raw_shape,suffix", [((20, 32, 32, 3), ".npy"),
                                              ((20, 32, 32), ".npz"),
                                              ((9, 48, 40, 3), ".npy"),
                                              ((30, 256, 256, 3), ".npy")])
def test_load_video_uint8_matches_jax(tmp_path, raw_shape, suffix):
    raw = np.random.default_rng(1).integers(0, 256, size=raw_shape, dtype=np.uint8)
    path = tmp_path / f"clip{suffix}"
    if suffix == ".npy":
        np.save(path, raw)
    else:
        np.savez(path, frames=raw)
    size = 32 if raw_shape[1] <= 48 else 224
    got = video_io.load_video(str(path), n_frames=8, resize=size)
    ref = jvio.load_video(str(path), n_frames=8, resize=size, output_dtype="uint8")
    assert got.dtype == np.uint8 and got.shape == ref.shape == (8, size, size, 3)
    diff = np.abs(got.astype(np.int16) - ref.astype(np.int16))
    if raw_shape[1:3] == (size, size):
        assert diff.max() == 0  # no resize: the sampled frames themselves
    else:
        assert diff.max() <= 1


@pytest.mark.parametrize("resize", [32, 24])
def test_load_video_float_clip_matches_jax(tmp_path, resize):
    """A float-valued clip is clipped to [0, 255] and rounded to uint8."""
    raw = np.random.default_rng(2).uniform(-20, 280, size=(12, 32, 32, 3))
    path = tmp_path / "c.npy"
    np.save(path, raw.astype(np.float32))
    got = video_io.load_video(str(path), n_frames=6, resize=resize)
    ref = jvio.load_video(str(path), n_frames=6, resize=resize, output_dtype="uint8")
    diff = np.abs(got.astype(np.int16) - ref.astype(np.int16))
    assert got.dtype == np.uint8 and diff.max() <= (0 if resize == 32 else 1)
