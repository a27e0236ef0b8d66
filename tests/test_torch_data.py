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


# --------------------------------------------------------------------------- #
# the data loop of the contrastive run: module for module against the JAX
# package, on the same seeded inputs

from deepcoro_clip_tpu.data import collate as jcollate  # noqa: E402
from deepcoro_clip_tpu.data import csv_utils as jcsv  # noqa: E402
from deepcoro_clip_tpu.data import datasets as jds  # noqa: E402
from deepcoro_clip_tpu.data import loader as jloader  # noqa: E402
from deepcoro_clip_tpu.data import randaugment as jra  # noqa: E402
from deepcoro_clip_tpu.data import sampler as jsampler  # noqa: E402
from deepcoro_clip_tpu.data import synthetic_angio as jsa  # noqa: E402
from deepcoro_clip_tpu.data import tokenizer as jtok  # noqa: E402
from deepcoro_clip_tpu.train import run_schedules as jsched  # noqa: E402
from deepcoro_clip_tpu.utils import retrieval_metrics as jrm  # noqa: E402

from deepcoro_clip_tpu_torch.data import collate, csv_utils, datasets, loader  # noqa: E402
from deepcoro_clip_tpu_torch.data import randaugment, sampler, synthetic_angio  # noqa: E402
from deepcoro_clip_tpu_torch.data import tokenizer  # noqa: E402
from deepcoro_clip_tpu_torch.train import run_schedules  # noqa: E402
from deepcoro_clip_tpu_torch.utils import retrieval_metrics  # noqa: E402

REPORTS = [synthetic_angio.report_text(synthetic_angio.sample_findings(i, 0), i, 0)
           for i in range(24)]
OOV = ["zzqx flurbowitz 12345 ünïcode lad-ostial 99.5% !!", "", "a " * 200,
       "LEFT MAIN 50%", "pneumonoultramicroscopicsilicovolcanoconiosis"]


@pytest.mark.parametrize("vocab_size,max_length", [(30522, 128), (30522, 16), (512, 32)],
                         ids=["wordpiece128", "wordpiece16", "hash512"])
def test_tokenizer_matches_jax(vocab_size, max_length):
    """Ids and masks on the corpus reports and on words outside the
    vocabulary, exactly; the same kind of tokenizer is picked."""
    t = tokenizer.get_tokenizer(vocab_size=vocab_size, max_length=max_length)
    j = jtok.get_tokenizer(vocab_size=vocab_size, max_length=max_length)
    assert type(t).__name__ == type(j).__name__
    got, want = t(REPORTS + OOV), j(REPORTS + OOV)
    for key in ("input_ids", "attention_mask"):
        np.testing.assert_array_equal(got[key], want[key])
    if hasattr(t, "decode"):
        assert t.decode(got["input_ids"][0]) == j.decode(want["input_ids"][0])
        if max_length >= 64:  # an out-of-vocabulary character, not cut off
            assert (got["input_ids"] == t.unk_id).any()


def test_tokenizer_finds_the_vocabulary(monkeypatch, tmp_path):
    """$DEEPCORO_VOCAB first, then assets/vocab.txt (30522 lines)."""
    assert tokenizer.find_local_vocab().endswith("assets/vocab.txt")
    v = tmp_path / "vocab.txt"
    v.write_text("\n".join(["[PAD]"] + [f"[unused{i}]" for i in range(99)]
                           + ["[UNK]", "[CLS]", "[SEP]", "left", "main"]) + "\n")
    monkeypatch.setenv("DEEPCORO_VOCAB", str(v))
    assert tokenizer.find_local_vocab() == str(v)
    tok = tokenizer.get_tokenizer(vocab_size=30522, max_length=6)
    assert tok.vocab_size == 105
    np.testing.assert_array_equal(tok("left main x")["input_ids"][0], [101, 103, 104, 100, 102, 0])


@pytest.mark.parametrize("n,bs,shuffle,drop_last,rank,nprocs", [
    (48, 16, True, True, 0, 1), (50, 16, True, False, 0, 1), (13, 4, False, False, 0, 1),
    (64, 8, True, True, 1, 3)])
def test_sharded_batch_sampler_matches_jax(n, bs, shuffle, drop_last, rank, nprocs):
    """The batch order, epoch by epoch."""
    t = sampler.ShardedBatchSampler(n, bs, shuffle=shuffle, seed=7, drop_last=drop_last,
                                    process_index=rank, process_count=nprocs)
    j = jsampler.ShardedBatchSampler(n, bs, shuffle=shuffle, seed=7, drop_last=drop_last,
                                     process_index=rank, process_count=nprocs)
    for epoch in range(3):
        t.set_epoch(epoch)
        j.set_epoch(epoch)
        assert len(t) == len(j)
        got, want = list(t), list(j)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The same corpus rendered by both packages (8 train, 4 val clips of
    4 x 32 x 32), in two directories."""
    root = tmp_path_factory.mktemp("corpus")
    t = synthetic_angio.generate_corpus(root / "port", n_train=8, n_val=4, size=32,
                                        frames=4, seed=3)
    j = jsa.generate_corpus(root / "jax", n_train=8, n_val=4, size=32, frames=4, seed=3)
    return t, j


def test_synthetic_corpus_is_bit_equal(corpus):
    """Clips, reports and the manifest file, byte for byte (paths aside);
    the probe-label and study manifests too."""
    t, j = corpus
    for i in range(12):
        np.testing.assert_array_equal(np.load(t.parent / f"clip_{i:06d}.npy"),
                                      np.load(j.parent / f"clip_{i:06d}.npy"))
    assert t.read_text().replace(str(t.parent), "D") == j.read_text().replace(str(j.parent), "D")
    for fn in ("write_probe_labels", "write_study_manifest"):
        a, b = getattr(synthetic_angio, fn)(t.parent, 3), getattr(jsa, fn)(j.parent, 3)
        assert a.read_text().replace(str(t.parent), "D") == \
            b.read_text().replace(str(j.parent), "D"), fn


@pytest.mark.parametrize("vid", [0, 5, 17])
def test_synthetic_clip_and_report_match_jax(vid):
    np.testing.assert_array_equal(synthetic_angio.render_clip(vid, 1, 48, 6),
                                  jsa.render_clip(vid, 1, 48, 6))
    f, jf = (synthetic_angio.sample_findings(vid, 1, 3, True),
             jsa.sample_findings(vid, 1, 3, True))
    assert [(x.segment, x.severity, x.pct) for x in f] == \
        [(x.segment, x.severity, x.pct) for x in jf]
    assert synthetic_angio.report_text(f, vid, 1) == jsa.report_text(jf, vid, 1)
    assert synthetic_angio.probe_labels_for(vid, 1) == jsa.probe_labels_for(vid, 1)


@pytest.mark.parametrize("sep", ["α", ",", "\t", ";"])
def test_csv_reader_matches_pandas(tmp_path, sep):
    """Columns and values as the JAX reader (pandas) gives them, for each
    separator the fallback tries (";" through the sniffer)."""
    import pandas as pd

    df = pd.DataFrame({"FileName": ["a.npy", "b dir/c.npy", "d.npy"],
                       "Report": ["x, y", "", 'say "z"'], "n": [1, 2, 3],
                       "f": [0.5, None, 2.0], "Split": ["train", "val", "TRAIN"]})
    path = tmp_path / "m.csv"
    df.to_csv(path, sep=sep, index=False)
    got = csv_utils.read_csv_with_fallback(path)
    want = jcsv.read_csv_with_fallback(path)
    assert got.columns == list(want.columns)
    for c in got.columns:
        for a, b in zip(got.column(c), want[c].tolist()):
            assert (a is None and pd.isna(b)) or a == b, (c, a, b)
            assert a is None or type(a) is type(b) or isinstance(b, str), (c, a, b)


def _ds_kwargs(manifest, **over):
    kw = dict(data_filename=str(manifest), split="train", frames=4, stride=1, resize=32,
              seed=5, wire_dtype="uint8")
    kw.update(over)
    return kw


@pytest.mark.parametrize("over", [
    {}, dict(split="val"), dict(wire_dtype="float32", mean=[10.0, 20.0, 30.0],
                                std=[50.0, 60.0, 70.0]),
    dict(multi_video=True, num_videos=3, groupby_column="Group"),
    dict(multi_video=True, num_videos=2, groupby_column="Group", split="val"),
    dict(resize=16, stride=2), dict(mono_wire=True)],
    ids=["train", "val", "float32", "multi", "multi_val", "resize_stride", "mono"])
def test_video_clip_dataset_matches_jax(corpus, tmp_path, over):
    """VideoClipDataset items: uint8 videos exactly (resized: within one
    level), float32 to 1e-6, masks, texts, paths and selected rows."""
    manifest = corpus[0]
    table = csv_utils.read_csv_with_fallback(manifest)
    rows = [dict(r, Group=f"G{i // 3}") for i, r in enumerate(table.rows)]
    grouped = tmp_path / "grouped.csv"
    csv_utils.write_csv(grouped, table.columns + ["Group"], rows)
    t = datasets.VideoClipDataset(**_ds_kwargs(grouped, **over))
    j = jds.VideoClipDataset(**_ds_kwargs(grouped, **over))
    assert len(t) == len(j) > 0
    for epoch in (0, 1):
        t.set_epoch(epoch)
        j.set_epoch(epoch)
        for i in range(len(t)):
            a, b = t[i], j[i]
            for key in ("text", "paths", "study_id", "selected_rows"):
                assert a[key] == b[key], key
            np.testing.assert_array_equal(a["video_mask"], b["video_mask"])
            assert a["videos"].dtype == b["videos"].dtype
            d = np.abs(a["videos"].astype(np.float64) - b["videos"].astype(np.float64))
            tol = 1e-5 if a["videos"].dtype == np.float32 else (1 if "resize" in str(over)
                                                              and over.get("resize") != 32
                                                              else 0)
            assert d.max() <= tol


def test_augmented_items_match_jax(corpus, monkeypatch):
    """rand_augment: the flip and RandAugment draw the same ops from the
    same item generator. The JAX side runs its numpy ops, which the port
    copies (its native ops, where built, round some pixels one level
    otherwise)."""
    from deepcoro_clip_tpu.data import fastvideo_binding

    monkeypatch.setattr(fastvideo_binding, "augment_available", lambda: False)
    kw = _ds_kwargs(corpus[0], rand_augment=True)
    t, j = datasets.VideoClipDataset(**kw), jds.VideoClipDataset(**kw)
    for i in range(len(t)):
        np.testing.assert_array_equal(t[i]["videos"], j[i]["videos"])


@pytest.mark.parametrize("seed", range(6))
def test_rand_augment_matches_jax_numpy_ops(seed):
    clip = np.random.default_rng(seed).integers(0, 256, size=(3, 20, 24, 3), dtype=np.uint8)
    got = randaugment.rand_augment_clip(clip.copy(), np.random.default_rng(seed), 9, 3)
    want = jra.rand_augment_clip(clip.copy(), np.random.default_rng(seed), 9, 3,
                                 backend="numpy")
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mono", [False, True])
def test_stats_dataset_matches_jax(corpus, mono):
    kw = _ds_kwargs(corpus[0], mono_wire=mono)
    got = datasets.StatsDataset(datasets.VideoClipDataset(**kw)).compute()
    want = jds.StatsDataset(jds.VideoClipDataset(**kw)).compute()
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("buckets,patch", [(None, None), ([8, 16, 32], None),
                                           (None, (2, 16, 16))])
def test_collate_clip_matches_jax(corpus, buckets, patch):
    ds = datasets.VideoClipDataset(**_ds_kwargs(corpus[0]))
    items = [ds[i] for i in range(4)]
    tok = tokenizer.get_tokenizer(max_length=64)
    got = collate.collate_clip(items, tok, max_text_length=64, length_buckets=buckets,
                               patch=patch)
    want = jcollate.collate_clip(items, jtok.get_tokenizer(max_length=64),
                                 max_text_length=64, length_buckets=buckets, patch=patch)
    assert got.keys() == want.keys()
    for k in got:
        if isinstance(got[k], np.ndarray):
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
            np.testing.assert_array_equal(got[k], want[k])
        else:
            assert got[k] == want[k], k
    if buckets:
        assert got["input_ids"].shape[1] == 32


def test_wire_patch_matches_jax():
    from deepcoro_clip_tpu.flagship import tiny_config as jtiny

    from deepcoro_clip_tpu_torch.flagship import tiny_config

    for over in ({}, dict(patch_wire=True), dict(patch_wire=True, wire_dtype="float32"),
                 dict(patch_wire=True, model_name="vit")):
        assert collate.wire_patch(tiny_config(**over)) == jcollate.wire_patch(jtiny(**over))


@pytest.mark.parametrize("backend", ["thread", "process"])
def test_prefetch_loader_matches_jax(corpus, backend):
    """The same collated batches, in order, from both loaders."""
    kw = _ds_kwargs(corpus[0])
    tok = tokenizer.get_tokenizer(max_length=32)

    def coll(items):
        return collate.collate_clip(items, tok, max_text_length=32)

    t = loader.PrefetchLoader(datasets.VideoClipDataset(**kw),
                              sampler.ShardedBatchSampler(8, 3, seed=1, drop_last=False),
                              coll, num_workers=2, backend=backend)
    j = jloader.PrefetchLoader(jds.VideoClipDataset(**kw),
                               jsampler.ShardedBatchSampler(8, 3, seed=1, drop_last=False),
                               coll, num_workers=2)
    for epoch in (0, 1):
        t.set_epoch(epoch)
        j.set_epoch(epoch)
        got, want = list(t), list(j)
        assert len(got) == len(want) == len(t) == 3
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a["videos"], b["videos"])
            np.testing.assert_array_equal(a["input_ids"], b["input_ids"])
            assert a["paths"] == b["paths"]


@pytest.mark.parametrize("seed", range(3))
def test_retrieval_metrics_match_jax(seed):
    r = np.random.default_rng(seed)
    sim = r.normal(size=(9, 7))
    text_ids = r.integers(0, 7, size=9)
    gt = jrm.gt_matrix_from_text_ids(text_ids, 7)
    gt[0, 3] = True  # a second positive
    np.testing.assert_array_equal(retrieval_metrics.gt_matrix_from_text_ids(text_ids, 7)
                                  | gt, gt)
    got = retrieval_metrics.compute_retrieval_metrics(sim, gt, (1, 5, 10), (3, 5), "val_")
    want = jrm.compute_retrieval_metrics(sim, gt, (1, 5, 10), (3, 5), "val_")
    assert got == want and "val_Recall@10" not in got
    v, t = r.normal(size=(9, 4)), r.normal(size=(9, 4))
    assert retrieval_metrics.compute_alignment_score(v, t) == jrm.compute_alignment_score(v, t)
    assert retrieval_metrics.compute_embedding_norms(v, t) == jrm.compute_embedding_norms(v, t)


@pytest.mark.parametrize("schedule", ["learnable", "constant", "linear", "cosine",
                                      "exponential"])
def test_temperature_schedule_matches_jax(schedule):
    for epoch in range(5):
        args = (epoch, 5, schedule, 0.07, 0.1, 0.01)
        assert run_schedules.temperature_at(*args) == jsched.temperature_at(*args)


@pytest.mark.parametrize("schedule", [None, "constant", "linear_unfreeze", "linear_freeze"])
def test_freeze_schedule_matches_jax(schedule):
    for epoch in range(4):
        assert (run_schedules.freeze_ratio_at(epoch, 4, 0.8, schedule)
                == jsched.freeze_ratio_at(epoch, 4, 0.8, schedule))
    with pytest.raises(ValueError):
        run_schedules.freeze_ratio_at(0, 4, 0.8, "nope")


@pytest.mark.parametrize("suffix", [".mp4", ".avi"])
def test_container_decoding(tmp_path, suffix):
    """A container through cv2, where cv2 is installed (it is not needed on
    the card's machine: without it a container raises, with no fallback)."""
    try:
        import cv2
    except ImportError:
        with pytest.raises(RuntimeError, match="cv2"):
            video_io.load_video(str(tmp_path / f"x{suffix}"), n_frames=2, resize=8)
        return
    path = str(tmp_path / f"clip{suffix}")
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*("mp4v" if suffix == ".mp4" else "MJPG")),
                        10, (32, 32))
    frames = np.random.default_rng(0).integers(0, 256, size=(6, 32, 32, 3), dtype=np.uint8)
    for f in frames:
        w.write(f)
    w.release()
    got = video_io.load_video(path, n_frames=4, resize=32)
    want = jvio.load_video(path, n_frames=4, resize=32, output_dtype="uint8")
    np.testing.assert_array_equal(got, want)
