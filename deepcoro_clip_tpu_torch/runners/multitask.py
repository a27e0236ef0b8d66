"""Multitask runner: joint contrastive + captioning + MVM training.

The port's ``MultitaskRunner`` (the JAX package's ``runners/multitask.py``)
on one card or over a process group (as the contrastive runner: every
rank collates the global batch and runs its rows; captions are generated
on each rank's rows and gathered; rank 0 writes):

- ``train``: per epoch the temperature and freeze-ratio schedules, the
  step-scheduled task weights (``LossWeightScheduler``), a train epoch
  whose step loop is pipelined as the contrastive runner's (step i's
  metrics are read after step i+1 is enqueued), a validation epoch, the
  latest and best-loss checkpoints, and early stopping; a non-finite loss
  saves a ``nan_debug`` snapshot and raises;
- batches carry the decoder's targets (``caption_ids``, ``caption_mask``,
  tokenized to ``decoder_max_length``), the LocCa ``location_mask`` under
  ``locca_enabled``, and the stenosis-aware ``caption_weights``;
- ``validate``: the task losses under the current task weights, greedy
  captions of the whole split with the K/V cache
  (``greedy_generate_kv``, ``min(32, decoder_max_length)`` tokens) from
  the video tokens of the same forward, BLEU-1..4, ROUGE-L and METEOR, and
  the captions written to ``{run dir}/val/captions_epoch_{e}.csv``;
- ``maybe_resume``.

Random draws come from one ``torch.Generator`` a rank on the run's device,
seeded from ``(config.seed, data index)`` and kept in every checkpoint, so a resumed run
repeats an uninterrupted one bit for bit. The JAX runner derives a key per
step; its dropout and MVM masks differ from the port's (a deliberate
divergence), the arithmetic on given masks does not. The end-of-run plots
of the JAX runner are left out (offline tools).
"""

from __future__ import annotations

import csv
import math
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from deepcoro_clip_tpu_torch.configs import unported_settings
from deepcoro_clip_tpu_torch.data.collate import collate_clip, wire_patch
from deepcoro_clip_tpu_torch.data.datasets import VideoClipDataset
from deepcoro_clip_tpu_torch.data.locca import location_token_mask
from deepcoro_clip_tpu_torch.data.tokenizer import CLS_ID, SEP_ID, get_tokenizer
from deepcoro_clip_tpu_torch.device import resolve_device
from deepcoro_clip_tpu_torch.losses.multitask import LossWeightScheduler
from deepcoro_clip_tpu_torch.models.captioning_decoder import greedy_generate_kv
from deepcoro_clip_tpu_torch.parallel import distributed
from deepcoro_clip_tpu_torch.parallel.distributed import gather_rows, rank_seed
from deepcoro_clip_tpu_torch.registry import RunnerRegistry
from deepcoro_clip_tpu_torch.runners.common import (  # noqa: F401 (the error train raises)
    NonFiniteLossError,
    batch_to_device,
    dataset_kwargs,
    make_loader,
    resolve_dataset_stats,
    run_pipelined_epoch,
)
from deepcoro_clip_tpu_torch.train import multitask as mt_train
from deepcoro_clip_tpu_torch.train.checkpoint import CheckpointManager
from deepcoro_clip_tpu_torch.train.run_schedules import freeze_ratio_at, temperature_at
from deepcoro_clip_tpu_torch.utils.caption_metrics import captioning_metrics
from deepcoro_clip_tpu_torch.utils.logging_utils import MetricsLogger
from deepcoro_clip_tpu_torch.utils.stenosis_extractor import StenosisExtractor


@RunnerRegistry.register("DeepCORO_multitask")
class MultitaskRunner:
    def __init__(self, config, output_dir: Optional[str] = None):
        unported = unported_settings(config)
        if unported:
            raise NotImplementedError("not ported yet: " + ", ".join(unported))
        self.config = config
        self.output_dir = Path(output_dir or config.output_dir)
        self.device = resolve_device(config.device)
        self.tokenizer = get_tokenizer(
            vocab_size=config.text_vocab_size, max_length=config.max_text_length
        )
        self.extractor = StenosisExtractor()
        self.datasets = self._build_datasets()
        # before the bundle: the uint8 wire's patchify folds the stats in
        self.stats = resolve_dataset_stats(config, self.datasets)
        self.loaders = {
            split: make_loader(config, ds, self._collate, split == "train")
            for split, ds in self.datasets.items() if ds is not None
        }
        steps = max(1, len(self.loaders.get("train", [])) or 1)
        self.bundle, self.state = mt_train.build_multitask_bundle(
            config, seed=config.seed, steps_per_epoch=steps, device=self.device)
        self.train_step = mt_train.make_multitask_train_step(self.bundle)
        self.eval_step = mt_train.make_multitask_eval_step(self.bundle)
        self.weight_sched = LossWeightScheduler(dict(config.loss_weights),
                                                config.loss_weight_schedule)
        # the random draws of the whole run, one generator a data index
        self.generator = torch.Generator(device=self.device).manual_seed(
            rank_seed(config.seed, distributed.data_rank()))
        self.ckpt = CheckpointManager(self.output_dir / "checkpoints")
        self.logger = MetricsLogger(
            self.output_dir, use_wandb=config.use_wandb, config=config,
            is_ref_device=config.is_ref_device,
        )
        self.best_val_loss = math.inf
        self.best_epoch = -1
        self.global_step = 0
        self.start_epoch = 0

    # ------------------------------------------------------------------ #
    # setup
    # ------------------------------------------------------------------ #

    def _build_datasets(self) -> Dict[str, Any]:
        cfg = self.config
        common = dataset_kwargs(cfg)
        out: Dict[str, Any] = {"train": VideoClipDataset(
            split="train", rand_augment=cfg.rand_augment, **common)}
        try:
            val = VideoClipDataset(split="val", **common)
            out["val"] = val if len(val) else None
        except Exception:
            out["val"] = None
        return out

    def _collate(self, items):
        cfg = self.config
        # (the global batch's bucket on every rank: each collates all of it)
        buckets = cfg.text_length_buckets if cfg.process_count == 1 else []
        batch = collate_clip(items, self.tokenizer, max_text_length=cfg.max_text_length,
                             length_buckets=buckets, patch=wire_patch(cfg))
        cap = self.tokenizer(batch["texts"], max_length=cfg.decoder_max_length,
                             padding="max_length", truncation=True, return_tensors="np")
        batch["caption_ids"] = np.asarray(cap["input_ids"], np.int32)
        batch["caption_mask"] = np.asarray(cap["attention_mask"], np.int32)
        if cfg.locca_enabled:
            batch["location_mask"] = location_token_mask(
                batch["texts"], self.tokenizer, cfg.decoder_max_length)
        # stenosis-aware per-sample caption weights
        batch["caption_weights"] = np.asarray(
            [self.extractor.max_severity_weight(t) for t in batch["texts"]], np.float32)
        return batch

    # ------------------------------------------------------------------ #
    # training
    # ------------------------------------------------------------------ #

    def maybe_resume(self) -> int:
        """With ``resume_training`` and a latest checkpoint in this run's
        directory: its parameters, optimizer state, step, generator, global
        step and best-so-far trackers; returns the epoch to start from."""
        if self.config.resume_training and self.ckpt.latest_exists():
            self.state = self.ckpt.restore(self.state, "checkpoint", self.generator)
            meta = self.ckpt.load_meta("checkpoint") or {}
            self.best_val_loss = float(meta.get("best_val_loss", math.inf))
            self.best_epoch = int(meta.get("best_epoch", -1))
            self.global_step = int(meta.get("global_step", 0))
            self.start_epoch = int(meta.get("epoch", -1)) + 1
        return self.start_epoch

    def train(self, start_epoch: int = 0, end_epoch: Optional[int] = None) -> Dict:
        cfg = self.config
        end_epoch = end_epoch if end_epoch is not None else cfg.epochs
        patience_left = cfg.early_stopping_patience or math.inf
        history = []
        for epoch in range(start_epoch, end_epoch):
            vfr = freeze_ratio_at(epoch, cfg.epochs, cfg.video_freeze_ratio,
                                  cfg.video_freeze_schedule)
            tfr = freeze_ratio_at(epoch, cfg.epochs, cfg.text_freeze_ratio,
                                  cfg.text_freeze_schedule)
            temp = temperature_at(epoch, cfg.epochs, cfg.temp_schedule, cfg.temperature,
                                  cfg.temp_start, cfg.temp_end)
            t_epoch = time.perf_counter()
            train_metrics = self._run_train_epoch(epoch, vfr, tfr, temp)
            train_metrics["epoch_seconds"] = time.perf_counter() - t_epoch
            self.logger.log({f"train/{k}": v for k, v in train_metrics.items()},
                            step=epoch)

            val_metrics: Dict[str, float] = {}
            if self.loaders.get("val") is not None:
                val_metrics = self.validate(epoch)
                self.logger.log({f"val/{k}": v for k, v in val_metrics.items()},
                                step=epoch)
            history.append({"epoch": epoch, **train_metrics,
                            **{f"val_{k}": v for k, v in val_metrics.items()}})

            vl = val_metrics.get("loss", train_metrics.get("loss"))
            improved = vl is not None and vl < self.best_val_loss
            if improved:
                self.best_val_loss = float(vl)
                self.best_epoch = epoch
                patience_left = cfg.early_stopping_patience or math.inf
            else:
                patience_left -= 1
            # every rank (rank 0 writes)
            meta = {"epoch": epoch, "best_val_loss": self.best_val_loss,
                    "best_epoch": self.best_epoch, "global_step": self.global_step,
                    **train_metrics}
            self.ckpt.save_latest(self.state, meta, self.generator)
            if improved:
                self.ckpt.save_best(self.state, epoch, meta, self.generator)
            if patience_left <= 0:
                break
        return {"history": history, "best_epoch": self.best_epoch,
                "best_val_loss": self.best_val_loss, "output_dir": str(self.output_dir)}

    def _run_train_epoch(self, epoch: int, vfr: float, tfr: float, temp: float):
        """The pipelined step loop (``run_pipelined_epoch``) under the task
        weights of each step."""

        def step(batch):
            w = self.weight_sched.at(self.global_step)
            self.state, metrics = self.train_step(
                self.state, batch, self.generator, w.get("contrastive", 1.0),
                w.get("captioning", 1.0), w.get("mvm", 1.0), vfr, tfr, temp)
            self.global_step += 1
            return metrics

        return run_pipelined_epoch(self, epoch, step)

    # ------------------------------------------------------------------ #
    # validation with captions
    # ------------------------------------------------------------------ #

    def _decode_ids(self, ids) -> str:
        """Ids -> text by the tokenizer's ``decode`` where it has one, else
        the ids as a string (the hash tokenizer)."""
        ids = [int(t) for t in ids if int(t) > 0]
        if hasattr(self.tokenizer, "decode"):
            return self.tokenizer.decode(ids, skip_special_tokens=True)
        return " ".join(map(str, ids))

    def validate(self, epoch: int = 0) -> Dict[str, float]:
        """The weighted validation loss, greedy captions of the whole split
        and their metrics; ``seconds`` is the pass's wall time."""
        cfg = self.config
        loader = self.loaders.get("val")
        if loader is None:
            return {}
        t0 = time.perf_counter()
        losses: List[float] = []
        gen_texts: List[str] = []
        ref_texts: List[str] = []
        gen_len = min(32, cfg.decoder_max_length)
        # the same task weights as training at this step, so the best
        # checkpoint and early stopping track the trained objective
        w = self.weight_sched.at(self.global_step)
        for batch in loader:
            out = self.eval_step(self.state.params, batch_to_device(batch, self.device))
            # this rank's rows, gathered (the padding rows are the last)
            ids = gather_rows(greedy_generate_kv(
                self.bundle.decoder, out["video_tokens"], bos_id=CLS_ID, eos_id=SEP_ID,
                max_length=gen_len))
            terms = torch.stack([out[k].float() for k in ("contrastive", "captioning",
                                                          "mvm")]).cpu().tolist()
            losses.append(w.get("contrastive", 1.0) * terms[0]
                          + w.get("captioning", 1.0) * terms[1]
                          + w.get("mvm", 1.0) * terms[2])
            ids = ids.cpu().numpy()
            for i in range(len(batch["texts"])):
                gen_texts.append(self._decode_ids(ids[i]))
                ref_texts.append(self._decode_ids(batch["caption_ids"][i]))
        metrics = {"loss": float(np.mean(losses)) if losses else 0.0}
        if gen_texts:
            metrics.update(captioning_metrics(gen_texts, ref_texts))
            if cfg.is_ref_device:
                art = self.output_dir / "val"
                art.mkdir(parents=True, exist_ok=True)
                with open(art / f"captions_epoch_{epoch}.csv", "w", newline="") as f:
                    wr = csv.writer(f, lineterminator="\n")
                    wr.writerow(["generated", "reference"])
                    wr.writerows(zip(gen_texts, ref_texts))
        metrics["seconds"] = time.perf_counter() - t0
        return metrics
