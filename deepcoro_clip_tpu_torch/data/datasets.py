"""Datasets over a CSV manifest: video(-text) samples in single- and
multi-video (study) modes, and the dataset statistics.

The port's copy of the JAX package's ``VideoClipDataset`` and
``StatsDataset`` (``data/datasets.py``), on ``data/csv_utils.Table``
instead of a pandas frame:

- single video: one sample per row, rows filtered by split and by the
  existence of their file;
- multi video: rows grouped by ``groupby_column`` (keys sorted, as pandas'
  ``groupby`` sorts them; rows without a key dropped), one report per study
  (the group's first filled one), ``num_videos`` clips a study (shuffled in
  training with ``shuffle_videos``), zero-padded, with ``video_mask``;
- a clip that fails to load becomes a zero clip, with a warning.

Items are pure functions of (seed, epoch, index), so any worker of the
prefetch loader may build any of them. ``VideoDataset`` (linear probing)
adds one target a head column and the clips' view ids.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from deepcoro_clip_tpu_torch.data.csv_utils import read_csv_with_fallback
from deepcoro_clip_tpu_torch.data.video_io import load_video

log = logging.getLogger(__name__)


class VideoClipDataset:
    """Video(+text) dataset over a CSV manifest."""

    def __init__(
        self,
        data_filename: str,
        root: str = ".",
        split: Optional[str] = "train",
        split_column: str = "Split",
        datapoint_loc_label: str = "FileName",
        target_label: Optional[str] = "Report",
        multi_video: bool = False,
        num_videos: int = 1,
        groupby_column: str = "StudyInstanceUID",
        shuffle_videos: bool = True,
        frames: int = 16,
        stride: int = 1,
        resize: int = 224,
        mean: Optional[Sequence[float]] = None,
        std: Optional[Sequence[float]] = None,
        rand_augment: bool = False,
        seed: int = 42,
        check_files: bool = True,
        wire_dtype: str = "float32",
        mono_wire: bool = False,
    ):
        self.root = Path(root)
        self.path_col = datapoint_loc_label
        self.target_label = target_label
        self.multi_video = multi_video
        self.num_videos = num_videos
        self.groupby_column = groupby_column
        self.shuffle_videos = shuffle_videos
        self.frames = frames
        self.stride = stride
        self.resize = resize
        self.mean = list(mean) if mean is not None else None
        self.std = list(std) if std is not None else None
        self.rand_augment = rand_augment and (split == "train")
        self.training = split == "train"
        self.wire_dtype = wire_dtype
        self.mono_wire = mono_wire
        self.channels = 1 if mono_wire else 3
        self._seed = seed

        table = read_csv_with_fallback(data_filename)
        rows = table.rows
        if split_column in table.columns and split is not None and split != "all":
            rows = [r for r in rows
                    if str(r[split_column]).lower() == str(split).lower()]
        rows = [dict(r, __path=self._resolve(r[self.path_col])) for r in rows]
        if check_files:
            kept = [r for r in rows if Path(r["__path"]).exists()]
            if len(kept) < len(rows):
                log.warning("dropping %d rows with missing files", len(rows) - len(kept))
            rows = kept
        self.rows: List[Dict[str, Any]] = rows

        self.epoch = 0
        if multi_video:
            self._init_multi_video()
        else:
            self.samples = [
                {
                    "paths": [row["__path"]],
                    "text": self._clean_text(
                        row.get(target_label) if target_label else ""
                    ),
                    "row_indices": [i],
                }
                for i, row in enumerate(self.rows)
            ]

    def _resolve(self, p) -> str:
        p = str(p)
        return p if Path(p).is_absolute() else str(self.root / p)

    @staticmethod
    def _clean_text(value) -> str:
        """Missing report cells become ''."""
        return value if isinstance(value, str) else ""

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _item_rng(self, i: int) -> np.random.Generator:
        """Per-item, per-epoch generator: deterministic and thread-safe."""
        if not self.training:
            return np.random.default_rng((42, i))
        return np.random.default_rng((self._seed, self.epoch, i))

    def _init_multi_video(self):
        """Group clips into studies, one report per study."""
        groups: Dict[Any, List[int]] = {}
        for i, row in enumerate(self.rows):
            key = row.get(self.groupby_column)
            if key is not None:
                groups.setdefault(key, []).append(i)
        self.samples = []
        for sid in sorted(groups):
            idx = groups[sid]
            texts = [self.rows[i].get(self.target_label) for i in idx
                     if self.target_label and self.rows[i].get(self.target_label) is not None]
            self.samples.append(
                {
                    "paths": [self.rows[i]["__path"] for i in idx],
                    "text": str(texts[0]) if texts else "",
                    "study_id": sid,
                    "row_indices": idx,
                }
            )

    def __len__(self) -> int:
        return len(self.samples)

    def _load_one(self, path: str, rng) -> np.ndarray:
        try:
            return load_video(
                path,
                n_frames=self.frames,
                resize=self.resize,
                stride=self.stride,
                mean=self.mean,
                std=self.std,
                rand_augment=self.rand_augment,
                rng=rng if self.training else None,
                output_dtype=self.wire_dtype,
                mono=self.mono_wire,
            )
        except Exception as e:
            log.warning("failed to load %s: %s", path, e)
            return np.zeros((self.frames, self.resize, self.resize,
                             self.channels), np.dtype(self.wire_dtype))

    def _select_clips(self, sample, rng) -> list[int]:
        """Indices into the sample's clips used this epoch."""
        n_avail = len(sample["paths"])
        N = self.num_videos if self.multi_video else 1
        sel = list(range(n_avail))
        if self.multi_video and n_avail > N:
            if self.shuffle_videos and self.training:
                sel = list(rng.permutation(n_avail)[:N])
            else:
                sel = sel[:N]
        return sel[:N]

    def __getitem__(self, i: int) -> Dict[str, Any]:
        return self.get(i)

    def get(self, i: int, load: bool = True) -> Dict[str, Any]:
        """Item ``i``; with ``load=False`` its videos stay zeros (a row of
        the global batch that another rank holds: only its metadata is
        read)."""
        sample = self.samples[i]
        rng = self._item_rng(i)
        N = self.num_videos if self.multi_video else 1
        sel = self._select_clips(sample, rng)
        paths = [sample["paths"][j] for j in sel]
        videos = np.zeros((N, self.frames, self.resize, self.resize,
                           self.channels), np.dtype(self.wire_dtype))
        mask = np.zeros((N,), bool)
        for j, p in enumerate(paths):
            if load:
                videos[j] = self._load_one(p, rng)
            mask[j] = True
        out = {
            "videos": videos,
            "video_mask": mask,
            "text": sample["text"],
            "paths": paths + [""] * (N - len(paths)),
            "study_id": sample.get("study_id", paths[0] if paths else ""),
            "selected_rows": [sample["row_indices"][j] for j in sel],
        }
        return out


class VideoDataset(VideoClipDataset):
    """Label-targeted studies for linear probing: the port's copy of the JAX
    package's ``VideoDataset``.

    - ``targets``: one float32 a column of ``target_labels``, read from the
      study's first row; a string goes through ``labels_map[column]`` (-1
      when it is not there), an empty cell becomes 0;
    - ``view_ids`` (with ``view_column``): each selected clip's view, in the
      selected (possibly shuffled) clip order, a name through
      ``view_labels_map``, a number as it is, anything else and the padded
      slots the PAD id ``num_view_classes``.
    """

    def __init__(
        self,
        *args,
        target_labels: Sequence[str] = (),
        labels_map: Optional[Dict[str, Dict[str, int]]] = None,
        view_column: Optional[str] = None,
        num_view_classes: int = 0,
        view_labels_map: Optional[Dict[str, int]] = None,
        **kwargs,
    ):
        super().__init__(*args, target_label=None, **kwargs)
        self.target_labels = list(target_labels)
        self.labels_map = labels_map or {}
        self.view_column = view_column
        self.view_labels_map = view_labels_map or {}
        self.pad_view_id = num_view_classes

    def get(self, i: int, load: bool = True) -> Dict[str, Any]:
        out = super().get(i, load)
        first = self.rows[self.samples[i]["row_indices"][0]]
        targets: Dict[str, np.ndarray] = {}
        for col in self.target_labels:
            v = first.get(col)
            if v is None:
                v = np.nan
            if col in self.labels_map and isinstance(v, str):
                v = self.labels_map[col].get(v, -1)
            targets[col] = np.float32(np.nan_to_num(np.float32(v)))
        out["targets"] = targets

        if self.view_column:
            N = self.num_videos
            view_ids = np.full((N,), self.pad_view_id, np.int32)
            views = [self.rows[r].get(self.view_column) for r in out["selected_rows"]]
            for j, v in enumerate(views[:N]):
                if isinstance(v, str) and v in self.view_labels_map:
                    view_ids[j] = int(self.view_labels_map[v])
                    continue
                try:
                    view_ids[j] = int(v)
                except (TypeError, ValueError):
                    view_ids[j] = self.pad_view_id
            out["view_ids"] = view_ids
        return out


class StatsDataset:
    """Per-channel mean/std over raw pixels of up to ``max_samples``
    evenly spaced samples."""

    def __init__(self, dataset: VideoClipDataset, max_samples: int = 128):
        self.dataset = dataset
        n = min(len(dataset), max_samples)
        self.indices = np.linspace(0, len(dataset) - 1, n).astype(int) if n else []

    def compute(self) -> tuple[np.ndarray, np.ndarray]:
        """(mean, std) over raw (unnormalized, unaugmented) pixels; one
        channel on the mono wire."""
        C = getattr(self.dataset, "channels", 3)
        s = np.zeros(C, np.float64)
        ss = np.zeros(C, np.float64)
        count = 0
        saved_mean, saved_std = self.dataset.mean, self.dataset.std
        saved_aug = self.dataset.rand_augment
        self.dataset.mean = self.dataset.std = None
        self.dataset.rand_augment = False
        try:
            for i in self.indices:
                item = self.dataset[int(i)]
                v = item["videos"][item["video_mask"]]
                flat = v.reshape(-1, C).astype(np.float64)
                s += flat.sum(axis=0)
                ss += (flat**2).sum(axis=0)
                count += flat.shape[0]
        finally:
            self.dataset.mean, self.dataset.std = saved_mean, saved_std
            self.dataset.rand_augment = saved_aug
        count = max(count, 1)
        mean = s / count
        std = np.sqrt(np.maximum(ss / count - mean**2, 1e-12))
        return mean.astype(np.float32), std.astype(np.float32)
