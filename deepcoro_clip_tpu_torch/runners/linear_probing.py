"""Linear-probing (multi-instance) runner: task heads on a video encoder,
epochs of train steps, per-head metrics with bootstrap intervals, the
prediction and embedding artifacts, resume.

The port's ``LinearProbingRunner`` (the JAX package's
``runners/linear_probing.py``) on one card or over a process group (as the
contrastive runner: each rank runs its rows of the global batch, the head
outputs are gathered without the padding rows, rank 0 writes):

- the encoder's weights come from ``video_encoder_checkpoint_path``: a
  port checkpoint (a ``.pt``, or a checkpoints directory, whose
  ``checkpoint.pt`` is read) or an ``.npz`` of the JAX training tree
  (``convert.save_params_npz``); its ``video_encoder`` leaves go into
  ``build_probe_bundle(encoder_params=)``, transplanted where the path and
  the shape match (``merge_encoder_params``). The head starts from the
  seed: like the JAX runner, no ``run_mode`` reads ``checkpoint`` into it;
- datasets: ``VideoDataset`` a split, one target a head (the head's name is
  its label column); outside training the split is ``split_filter`` when
  set (``"all"`` takes every row). A split without studies is left out;
  any other error in building one propagates (the JAX runner maps every
  exception to a missing split);
- ``train``: a pipelined step loop (``runners/common.run_pipelined_epoch``:
  step i's metrics are read after step i+1 is enqueued; a non-finite loss
  saves a ``nan_debug`` snapshot and raises), validation, the latest and
  best-loss checkpoints with the dataset statistics in the meta, early
  stopping on the validation loss;
- ``validate``: ``{split}/predictions_epoch_{e}.csv`` and
  ``{split}/metrics_epoch_{e}.json``, the intervals only for ``run_mode``
  ``val`` / ``test``;
- ``inference``: ``inference/predictions.csv`` and, with
  ``save_embeddings``, each study's pooled embedding (the MIL head's
  ``pooled``, before its dropout and heads) into ``embedding_output_file``
  or ``study_embeddings.npz``;
- ``maybe_resume``: parameters, optimizer, step, dropout generator and the
  best loss so far.

Dropout masks come from one ``torch.Generator`` a rank on the run's device,
seeded from ``(config.seed, data index)`` and kept in every checkpoint. The JAX runner's
end-of-run plots (``utils/plot_metrics.plot_run_summary``, an offline tool)
are left out.
"""

from __future__ import annotations

import functools
import json
import math
import time
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch

from deepcoro_clip_tpu_torch import convert
from deepcoro_clip_tpu_torch.data.collate import collate_mil, wire_patch
from deepcoro_clip_tpu_torch.data.csv_utils import write_csv
from deepcoro_clip_tpu_torch.data.datasets import VideoDataset
from deepcoro_clip_tpu_torch.device import resolve_device
from deepcoro_clip_tpu_torch.parallel import distributed
from deepcoro_clip_tpu_torch.parallel.distributed import gather_rows, rank_seed
from deepcoro_clip_tpu_torch.registry import RunnerRegistry
from deepcoro_clip_tpu_torch.runners.common import (  # noqa: F401 (the error train raises)
    NonFiniteLossError,
    batch_to_device,
    make_loader,
    resolve_dataset_stats,
    run_pipelined_epoch,
    unpad,
)
from deepcoro_clip_tpu_torch.train import linear_probe as probe_train
from deepcoro_clip_tpu_torch.train.checkpoint import CheckpointManager
from deepcoro_clip_tpu_torch.utils.logging_utils import MetricsLogger
from deepcoro_clip_tpu_torch.utils.metrics import compute_head_metrics, normalize_head_task


def load_encoder_checkpoint(path: str) -> Mapping:
    """The video-encoder weights of a run's checkpoint: the JAX tree of an
    ``.npz`` (its ``video_encoder`` subtree), or the ``video_encoder.*``
    tensors of a port ``.pt`` (a directory: its ``checkpoint.pt``) under
    the encoder's own names."""
    p = Path(path)
    if p.suffix == ".npz":
        tree = convert.load_params_npz(p)
        if set(tree) == {"params"}:
            tree = tree["params"]
        return tree.get("video_encoder", tree)
    if p.is_dir():
        p = p / "checkpoint.pt"
    saved = torch.load(p, map_location="cpu", weights_only=True)
    params = saved.get("params", saved)
    pre = "video_encoder."
    return {k[len(pre):]: v for k, v in params.items() if k.startswith(pre)} or params


@RunnerRegistry.register("DeepCORO_video_linear_probing")
class LinearProbingRunner:
    def __init__(self, config, output_dir: Optional[str] = None,
                 encoder_params: Optional[Mapping] = None,
                 datasets: Optional[Dict[str, Any]] = None):
        self.config = config
        self.output_dir = Path(output_dir or config.output_dir)
        self.device = resolve_device(config.device)
        if encoder_params is None and config.video_encoder_checkpoint_path:
            encoder_params = load_encoder_checkpoint(config.video_encoder_checkpoint_path)
        self.datasets = datasets if datasets is not None else self._build_datasets()
        # before the bundle: the uint8 wire's patchify folds the stats in
        self.stats = resolve_dataset_stats(config, self.datasets)
        self.loaders = {s: self._make_loader(d, s == "train")
                        for s, d in self.datasets.items() if d is not None}
        steps = max(1, len(self.loaders.get("train", [])) or 1)
        self.bundle, self.state = probe_train.build_probe_bundle(
            config, seed=config.seed, steps_per_epoch=steps,
            encoder_params=encoder_params, device=self.device)
        # (paths of the encoder's leaves the checkpoint replaced, all leaves)
        self.encoder_loaded = ([], 0)
        if encoder_params is not None:
            self.encoder_loaded = (
                probe_train.loaded_encoder_leaves(self.bundle.video_model, encoder_params),
                len(list(self.bundle.video_model.parameters())))
            if config.is_ref_device:
                print(f"[linear probing] video encoder: {len(self.encoder_loaded[0])} of "
                      f"{self.encoder_loaded[1]} leaves from the checkpoint", flush=True)
        self.train_step = probe_train.make_probe_train_step(self.bundle)
        self.eval_step = probe_train.make_probe_eval_step(self.bundle)
        # the dropout masks, one generator a data index
        self.generator = torch.Generator(device=self.device).manual_seed(
            rank_seed(config.seed, distributed.data_rank()))
        self.ckpt = CheckpointManager(self.output_dir / "checkpoints")
        self.logger = MetricsLogger(
            self.output_dir, use_wandb=config.use_wandb, config=config,
            is_ref_device=config.is_ref_device,
        )
        self.best_val_loss = math.inf
        self.best_epoch = -1

    # ------------------------------------------------------------------ #
    # setup
    # ------------------------------------------------------------------ #

    def _build_datasets(self) -> Dict[str, Any]:
        cfg = self.config
        common = dict(
            data_filename=cfg.data_filename, root=cfg.root, split_column=cfg.split_column,
            datapoint_loc_label=cfg.datapoint_loc_label, multi_video=cfg.multi_video,
            num_videos=cfg.num_videos, groupby_column=cfg.groupby_column,
            shuffle_videos=cfg.shuffle_videos, frames=cfg.frames, stride=cfg.stride,
            resize=cfg.resize, seed=cfg.seed,
            # the head's name is its label column
            target_labels=sorted(cfg.head_structure), labels_map=cfg.labels_map,
            view_column=cfg.view_column, num_view_classes=cfg.num_view_classes,
            view_labels_map=cfg.view_labels_map, wire_dtype=cfg.wire_dtype,
            mono_wire=cfg.mono_wire,
        )
        splits = ["train", "val"] if cfg.run_mode == "train" else [cfg.run_mode]
        out = {}
        for s in splits:
            # outside training split_filter names the rows (e.g. diagnostic /
            # POST_PCI of one manifest; "all" takes every row)
            split = s if cfg.run_mode == "train" else (cfg.split_filter or s)
            ds = VideoDataset(split=split, rand_augment=cfg.rand_augment and s == "train",
                              **common)
            out[s] = ds if len(ds) else None
        return out

    def _make_loader(self, dataset, training: bool):
        collate = functools.partial(collate_mil, head_names=list(self.config.head_structure),
                                    patch=wire_patch(self.config))
        return make_loader(self.config, dataset, collate, training)

    # ------------------------------------------------------------------ #
    # training
    # ------------------------------------------------------------------ #

    def train(self, start_epoch: int = 0, end_epoch: Optional[int] = None) -> Dict:
        cfg = self.config
        end_epoch = end_epoch if end_epoch is not None else cfg.epochs
        patience_left = cfg.early_stopping_patience or math.inf
        history = []

        def step(batch):
            self.state, metrics = self.train_step(self.state, batch, self.generator,
                                                  cfg.video_freeze_ratio)
            return metrics

        for epoch in range(start_epoch, end_epoch):
            t0 = time.perf_counter()
            train_metrics = run_pipelined_epoch(self, epoch, step)
            train_metrics["epoch_seconds"] = time.perf_counter() - t0
            self.logger.log({f"train/{k}": v for k, v in train_metrics.items()}, step=epoch)

            val_metrics: Dict[str, Any] = {}
            if self.loaders.get("val") is not None:
                val_metrics = self.validate(split="val", epoch=epoch)
            val_scalars = {k: v for k, v in val_metrics.items() if isinstance(v, (int, float))}
            self.logger.log({f"val/{k}": v for k, v in val_scalars.items()}, step=epoch)
            history.append({"epoch": epoch, **train_metrics,
                            **{f"val_{k}": v for k, v in val_scalars.items()}})

            meta = {"epoch": epoch, "train_loss": train_metrics.get("loss"),
                    "val_loss": val_metrics.get("loss"),
                    "dataset_mean": self.stats[0], "dataset_std": self.stats[1]}
            vl = val_metrics.get("loss", train_metrics.get("loss"))
            improved = vl is not None and vl < self.best_val_loss
            if improved:
                self.best_val_loss = float(vl)
                self.best_epoch = epoch
                patience_left = cfg.early_stopping_patience or math.inf
            else:
                patience_left -= 1
            meta["best_val_loss"] = self.best_val_loss
            meta["best_epoch"] = self.best_epoch
            # every rank (rank 0 writes)
            self.ckpt.save_latest(self.state, meta, self.generator)
            if improved:
                self.ckpt.save_best(self.state, epoch, meta, self.generator)
            if patience_left <= 0:
                break
        return {"history": history, "best_epoch": self.best_epoch,
                "best_val_loss": self.best_val_loss, "output_dir": str(self.output_dir)}

    # ------------------------------------------------------------------ #
    # validation with per-head metrics
    # ------------------------------------------------------------------ #

    def validate(self, split: str = "val", epoch: int = 0,
                 save_predictions: bool = True) -> Dict[str, Any]:
        """The loss and every head's metrics (with the bootstrap intervals
        in ``run_mode`` val / test), and the artifacts; ``seconds`` is the
        pass's wall time, ``metrics_seconds`` the host's time in the
        per-head metrics (the bootstrap included). Neither is written to
        the metrics JSON."""
        cfg = self.config
        loader = self.loaders.get(split)
        if loader is None:
            return {}
        t0 = time.perf_counter()
        heads = list(cfg.head_structure)
        preds: Dict[str, List[np.ndarray]] = {h: [] for h in heads}
        targets: Dict[str, List[np.ndarray]] = {h: [] for h in heads}
        study_ids: List[Any] = []
        losses = []
        for batch in loader:
            out = self.eval_step(self.state.params, batch_to_device(batch, self.device))
            losses.append(float(out["loss"]))
            n = len(batch["study_ids"])  # (the gathered padding rows are the last)
            for h in heads:
                preds[h].append(unpad(out["outputs"][h], n))
                targets[h].append(np.asarray(batch["targets"][h]))
            study_ids.extend(batch["study_ids"])

        t_metrics = time.perf_counter()
        metrics: Dict[str, Any] = {"loss": float(np.mean(losses)) if losses else 0.0}
        rows: Dict[str, Any] = {"study_id": study_ids}
        for h in heads:
            p = np.concatenate(preds[h])
            t = np.concatenate(targets[h])
            task = normalize_head_task(cfg.head_task.get(h, "binary"))
            p_flat = p.argmax(-1) if task == "multiclass" else p.reshape(len(p), -1)[:, 0]
            rows[f"{h}_pred"] = p_flat.tolist()
            rows[f"{h}_target"] = t.reshape(len(t)).tolist()
            hm = compute_head_metrics(
                p if task == "multiclass" else p_flat, t, task,
                with_ci=cfg.run_mode in ("val", "test"),
                n_bootstrap=cfg.ci_n_bootstrap, confidence=cfg.ci_confidence_level)
            for k, v in hm.items():
                metrics[f"{h}/{k}"] = v
        metrics_seconds = time.perf_counter() - t_metrics

        if cfg.is_ref_device and save_predictions:
            art = self.output_dir / split
            art.mkdir(parents=True, exist_ok=True)
            columns = list(rows)
            write_csv(art / f"predictions_epoch_{epoch}.csv", columns,
                      [dict(zip(columns, r)) for r in zip(*rows.values())], sep=",")
            with open(art / f"metrics_epoch_{epoch}.json", "w") as f:
                json.dump(metrics, f, default=float, indent=2)
        metrics["metrics_seconds"] = metrics_seconds
        metrics["seconds"] = time.perf_counter() - t0
        return metrics

    # ------------------------------------------------------------------ #
    # inference with the study embeddings
    # ------------------------------------------------------------------ #

    def _mil_inputs(self, batch):
        """The encoder's per-video embeddings ``[B, N, D]`` (the patch tokens
        ``[B, N, L, D]`` with ``hierarchical_tokens``) and the head's
        keyword arguments."""
        videos = batch["videos"]
        emb = self.bundle.video_model(videos, deterministic=True)
        if self.config.hierarchical_tokens:
            B, N = videos.shape[:2]
            emb = emb.reshape(B, N, emb.shape[1] // N, emb.shape[-1])
        return emb, {"mask": batch.get("video_mask"), "view_ids": batch.get("view_ids")}

    @torch.no_grad()
    def inference(self, split: Optional[str] = None) -> List[Dict[str, Any]]:
        """Each study's head outputs (``inference/predictions.csv``) and,
        with ``save_embeddings``, its pooled embedding; returns the rows."""
        cfg = self.config
        split = split or cfg.run_mode
        loader = self.loaders.get(split) or next(
            l for l in self.loaders.values() if l is not None)
        heads = list(cfg.head_structure)
        rows: List[Dict[str, Any]] = []
        embeddings: List[np.ndarray] = []
        study_ids: List[Any] = []
        for batch in loader:
            device_batch = batch_to_device(batch, self.device)
            emb, kw = self._mil_inputs(device_batch)
            outputs, sown = self.bundle.mil_model(emb, deterministic=True,
                                                  return_intermediates=True, **kw)
            # each rank's rows, gathered, without the padding rows
            n = len(batch["study_ids"])
            embeddings.append(unpad(gather_rows(sown["pooled"]), n))
            study_ids.extend(batch["study_ids"])
            host = {h: unpad(gather_rows(outputs[h]), n) for h in heads}
            for i, sid in enumerate(batch["study_ids"]):
                rows.append({"study_id": sid,
                             **{h: float(host[h][i].reshape(-1)[0]) for h in heads}})

        if cfg.is_ref_device:
            out = self.output_dir / "inference"
            out.mkdir(parents=True, exist_ok=True)
            write_csv(out / "predictions.csv", ["study_id"] + heads, rows, sep=",")
            if cfg.save_embeddings and embeddings:
                np.savez(out / (cfg.embedding_output_file or "study_embeddings.npz"),
                         embeddings=np.concatenate(embeddings),
                         study_ids=np.asarray(study_ids))
        return rows

    # ------------------------------------------------------------------ #
    # resume
    # ------------------------------------------------------------------ #

    def maybe_resume(self) -> int:
        """With ``resume_training`` and a latest checkpoint in this run's
        directory: its parameters, optimizer state, step, dropout generator
        and the best loss so far (not the last epoch's); returns the epoch
        to start from."""
        if self.config.resume_training and self.ckpt.latest_exists():
            self.state = self.ckpt.restore(self.state, "checkpoint", self.generator)
            meta = self.ckpt.load_meta("checkpoint") or {}
            bvl = meta.get("best_val_loss", meta.get("val_loss"))
            self.best_val_loss = float(bvl) if bvl is not None else math.inf
            self.best_epoch = int(meta.get("best_epoch", -1))
            return int(meta.get("epoch", -1)) + 1
        return 0
