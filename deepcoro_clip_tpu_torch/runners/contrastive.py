"""Contrastive (CLIP / SigLIP) runner: epochs of train steps, validation
with retrieval metrics, checkpoints, early stopping, resume.

The port's ``VideoContrastiveLearningRunner`` (the JAX package's
``runners/contrastive.py``) on one card or over a process group:

- ``train``: per epoch the temperature and freeze-ratio schedules, the
  epoch-seeded batch order, a train epoch, a validation epoch, then the
  latest, best-loss and highest-alignment checkpoints, and early stopping;
  a non-finite loss saves a ``nan_debug`` snapshot and raises;
- the step loop is pipelined: step i's metrics are read (one copy to the
  host) only after step i+1 has been enqueued, so the card is not left
  idle while the host reads;
- SigLIP: with ``siglip_texts_path`` the datasets are
  ``data/siglip.SiglipVideoDataset`` over the texts/edges manifests (each
  item a pack of positive and negative texts), with
  ``siglip_use_class_aware_sampler`` the training batches come from
  ``ClassAwareBatchSampler``, and a multi-positive loss collates each batch
  with ``collate_multi_positive`` (a bank of ``batch_size x
  (siglip_max_positive_per_video + siglip_negatives_per_video)`` texts);
  with ``siglip_sampler: single_head`` the bank and its (Y, W) matrices
  come from one ``SingleHeadRetrievalSampler`` a run instead
  (``collate_single_head``), whose round-robin and generator state every
  checkpoint keeps; the ``siglip_debug_*`` settings gate per-sample logit
  dumps;
- LocCa: with ``locca_enabled`` each batch carries the decoder's targets
  (``locca_caption_batch`` over each item's ``locca_report``, its
  reconstructed report, or its own report), and ``locca_loss`` joins the
  train and validation history;
- ``validate``: embeddings of every validation sample, the reports (with a
  multi-positive loss: every video's positives) deduplicated into a bank
  re-encoded in batches of 64, the similarity matrix, Recall@k, NDCG@k,
  MRR, MAP, median rank and the alignment score, scored against each
  video's full positive set, and with the SigLIP resources the
  tree/segment/severity panel; the bank, the embeddings and a per-video
  retrieval table are written under ``{run dir}/{split}/``;
- ``maybe_resume`` / ``restore_best``;
- ``init_from_checkpoint``: a warm start of the parameters from a port
  checkpoint (``.pt``) or from an ``.npz`` of the JAX training tree
  (``convert.save_params_npz``), leaf by leaf where paths and shapes match.

Dropout masks are drawn from one ``torch.Generator`` a rank on the run's
device, seeded from ``(config.seed, data index)`` and kept in every checkpoint.
Under ``torch.distributed.run`` (``parallel/distributed.py``) every rank
collates the same global batch, decodes and runs its own rows, and sees
the same losses, validation outputs (gathered, the padding rows of a short
last batch dropped) and decisions (early stopping, checkpoints, the
non-finite raise); rank 0 alone writes files. The JAX runner
derives a key per step with ``fold_in``/``split``; the masks differ (a
deliberate divergence), the arithmetic does not. The qualitative HTML
panels and the end-of-run plots of the JAX runner are left out (offline
tools).

``inference`` (``run_mode: inference``) ranks a precomputed text bank
(``python -m deepcoro_clip_tpu_torch.generate_embeddings`` writes one) for
each study and averages the metadata of its top-k texts by pandas' rules
(``read_metadata``, ``average_metadata``). As in the JAX runner, the
weights come from ``init_from_checkpoint``; ``checkpoint`` is not read.
Where the config names no bank, it writes the study embeddings instead
(the JAX runner fails there).
"""

from __future__ import annotations

import csv
import math
import time
from collections import Counter
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from deepcoro_clip_tpu_torch import convert
from deepcoro_clip_tpu_torch.configs import unported_settings
from deepcoro_clip_tpu_torch.data.collate import (
    collate_clip,
    collate_multi_positive,
    collate_single_head,
    wire_patch,
)
from deepcoro_clip_tpu_torch.data.csv_utils import write_csv
from deepcoro_clip_tpu_torch.data.datasets import VideoClipDataset
from deepcoro_clip_tpu_torch.data.loader import PrefetchLoader
from deepcoro_clip_tpu_torch.data.locca import locca_caption_batch
from deepcoro_clip_tpu_torch.data.sampler import ClassAwareBatchSampler
from deepcoro_clip_tpu_torch.data.siglip import SiglipResources, SiglipVideoDataset
from deepcoro_clip_tpu_torch.data.siglip_runtime import SiglipRuntimeSettings
from deepcoro_clip_tpu_torch.data.tokenizer import get_tokenizer
from deepcoro_clip_tpu_torch.device import resolve_device
from deepcoro_clip_tpu_torch.parallel import distributed
from deepcoro_clip_tpu_torch.parallel.distributed import gather_rows, rank_seed
from deepcoro_clip_tpu_torch.parallel.mesh import MODEL_AXIS
from deepcoro_clip_tpu_torch.registry import RunnerRegistry
from deepcoro_clip_tpu_torch.runners.common import (  # noqa: F401 (the error train raises)
    NonFiniteLossError,
    batch_to_device,
    data_shard,
    dataset_kwargs,
    make_loader,
    resolve_dataset_stats,
    run_pipelined_epoch,
    unpad,
)
from deepcoro_clip_tpu_torch.train import clip as clip_train
from deepcoro_clip_tpu_torch.train.checkpoint import CheckpointManager
from deepcoro_clip_tpu_torch.train.run_schedules import freeze_ratio_at, temperature_at
from deepcoro_clip_tpu_torch.train.state import model_splits, take_shard
from deepcoro_clip_tpu_torch.utils.logging_utils import MetricsLogger
from deepcoro_clip_tpu_torch.utils import siglip_logging
from deepcoro_clip_tpu_torch.utils.retrieval_metrics import (
    compute_alignment_score,
    compute_retrieval_metrics,
)
from deepcoro_clip_tpu_torch.utils.semantic_metrics import compute_semantic_metrics


def check_ported(config) -> None:
    """Raise ``NotImplementedError`` for what this runner does not run yet."""
    unported = unported_settings(config)
    if unported:
        raise NotImplementedError("not ported yet: " + ", ".join(unported))


# the cells pandas' CSV reader takes for a missing value (read_csv's na_values)
_NA_CELLS = {"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
             "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null"}
_BOOL_CELLS = {"True": 1.0, "TRUE": 1.0, "true": 1.0,
               "False": 0.0, "FALSE": 0.0, "false": 0.0}


def _number(cell: str):
    try:
        return float(cell)
    except ValueError:
        return None


def read_metadata(path) -> Tuple[List[str], Dict[str, List[Any]], Dict[str, bool]]:
    """The bank's metadata table: ``(columns, values by column, numeric by
    column)``, a missing value as None. A CSV (comma-separated) is read by
    pandas' rules: a column is numeric when every filled cell is a number,
    or when every cell is a boolean; the rest are strings. A ``.parquet``
    goes through ``pyarrow`` (imported here; it raises without it), where
    the column's type says."""
    path = str(path)
    if path.endswith("parquet"):
        try:
            import pyarrow as pa
            import pyarrow.parquet as pq
        except ImportError as e:  # pragma: no cover - depends on the machine
            raise ImportError("reading a parquet metadata table needs pyarrow") from e
        table = pq.read_table(path)
        columns = list(table.column_names)
        numeric = {c: (pa.types.is_integer(t) or pa.types.is_floating(t)
                       or pa.types.is_boolean(t))
                   for c, t in zip(columns, table.schema.types)}
        values = {c: table.column(c).to_pylist() for c in columns}
        return columns, values, numeric
    with open(path, newline="", encoding="utf-8") as f:
        lines = [r for r in csv.reader(f) if r]
    columns, body = lines[0], lines[1:]
    values: Dict[str, List[Any]] = {}
    numeric: Dict[str, bool] = {}
    for i, c in enumerate(columns):
        cells = [r[i] if i < len(r) else "" for r in body]
        filled = [x for x in cells if x not in _NA_CELLS]
        if cells and all(x in _BOOL_CELLS for x in cells):
            numeric[c], values[c] = True, [_BOOL_CELLS[x] for x in cells]
        elif all(_number(x) is not None for x in filled):
            numeric[c] = True
            values[c] = [None if x in _NA_CELLS else float(x) for x in cells]
        else:
            numeric[c] = False
            values[c] = [None if x in _NA_CELLS else x for x in cells]
    return columns, values, numeric


def average_metadata(values: List[Any], numeric: bool):
    """pandas' ``mean`` of a numeric column's values (missing ones skipped;
    NaN when none is left), else its ``mode`` (missing ones ignored, the
    smallest of the tied values; "" when none is left)."""
    present = [v for v in values
               if v is not None and not (isinstance(v, float) and math.isnan(v))]
    if numeric:
        return float(np.asarray(present, np.float64).mean()) if present else float("nan")
    if not present:
        return ""
    counts = Counter(present)
    top = max(counts.values())
    return min(v for v, n in counts.items() if n == top)


def _merge_params_by_path(new, old):
    """Leaf-for-leaf transplant where key paths and shapes match; ``new``
    elsewhere (the JAX runner's ``_merge_params_by_path``)."""
    if isinstance(new, dict) and isinstance(old, dict):
        return {k: (_merge_params_by_path(v, old[k]) if k in old else v)
                for k, v in new.items()}
    if isinstance(new, dict) or isinstance(old, dict):
        return new
    new_arr = np.asarray(new)
    arr = np.asarray(old)
    return arr.astype(new_arr.dtype) if arr.shape == new_arr.shape else new


@RunnerRegistry.register("DeepCORO_clip", "DeepCORO_clip_simple")
class VideoContrastiveLearningRunner:
    def __init__(
        self,
        config,
        output_dir: Optional[str] = None,
        datasets: Optional[Dict[str, Any]] = None,
    ):
        check_ported(config)
        self.config = config
        self.output_dir = Path(output_dir or config.output_dir)
        self.device = resolve_device(config.device)
        self.tokenizer = get_tokenizer(
            vocab_size=config.text_vocab_size, max_length=config.max_text_length
        )
        self.multi_positive = clip_train.is_multi_positive(config)
        self.siglip_runtime = SiglipRuntimeSettings.from_config(config, str(self.output_dir))
        self.siglip_resources = None  # set with the texts/edges manifests
        self.datasets = datasets if datasets is not None else self._build_datasets()
        # the batch-level sampler of siglip_sampler: single_head, built at
        # its first batch (single_head_sampler); one a run
        self.single_head = (self.multi_positive and config.siglip_sampler == "single_head"
                            and self.siglip_resources is not None)
        self._single_head_sampler = None
        # before the bundle: the uint8 wire's patchify folds the stats in
        self.stats = resolve_dataset_stats(config, self.datasets)
        self.loaders = {
            split: self._make_loader(ds, split == "train")
            for split, ds in self.datasets.items()
            if ds is not None
        }
        steps_per_epoch = max(1, len(self.loaders.get("train", [])) or 1)
        self.bundle, self.state = clip_train.build_clip_bundle(
            config, seed=config.seed, steps_per_epoch=steps_per_epoch,
            device=self.device,
        )
        if getattr(config, "init_from_checkpoint", None):
            self.init_from_checkpoint(config.init_from_checkpoint)
        self.train_step = clip_train.make_train_step(self.bundle)
        self.eval_step = clip_train.make_eval_step(self.bundle)
        # the batch keys every rank holds whole (the multi-positive bank)
        self.replicated_keys = clip_train.replicated_keys(config)
        # the dropout masks of the whole run, one generator a data index
        self.generator = torch.Generator(device=self.device).manual_seed(
            rank_seed(config.seed, distributed.data_rank()))
        self.ckpt = CheckpointManager(self.output_dir / "checkpoints")
        self.logger = MetricsLogger(
            self.output_dir, use_wandb=config.use_wandb, config=config,
            is_ref_device=config.is_ref_device,
        )
        self.best_val_loss = math.inf
        self.best_epoch = -1
        self.highest_alignment = -math.inf
        self.start_epoch = 0
        self.siglip_debug = None  # the dump's logger, made at its first batch

    # ------------------------------------------------------------------ #
    # setup
    # ------------------------------------------------------------------ #

    def _build_datasets(self) -> Dict[str, Any]:
        cfg = self.config
        common = dataset_kwargs(cfg)

        if not cfg.siglip_texts_path:
            def make(split, augment=False):
                return VideoClipDataset(split=split, rand_augment=augment, **common)
        else:
            edges = cfg.siglip_edges_path or str(Path(cfg.siglip_texts_path).parent
                                                 / "edges.csv")
            resources = SiglipResources(
                cfg.siglip_texts_path, edges,
                severity_weights=cfg.siglip_positive_severity_weights,
                enable_severity_weighting=cfg.siglip_enable_severity_weighting)
            self.siglip_resources = resources
            sampling = self.siglip_runtime.sampling

            def make(split, augment=False):
                return SiglipVideoDataset(
                    split=split, rand_augment=augment, siglip=resources,
                    max_positive_per_video=sampling.max_positive_per_video,
                    negatives_per_video=sampling.negatives_per_video,
                    round_robin=sampling.round_robin,
                    max_segments_per_video=sampling.max_segments_per_video,
                    contradiction_boost=sampling.contradiction_boost,
                    contradiction_min_severity=sampling.contradiction_min_severity,
                    **common)

        out: Dict[str, Any] = {}
        if cfg.run_mode == "train":
            out["train"] = make("train", cfg.rand_augment)
            try:
                val = make("val")
                out["val"] = val if len(val) else None
            except Exception:
                out["val"] = None
        else:
            out[cfg.run_mode] = make(cfg.run_mode)
        return out

    def single_head_sampler(self):
        """The run's ``SingleHeadRetrievalSampler`` (seeded ``config.seed``),
        built at the first call."""
        if self._single_head_sampler is None:
            self._single_head_sampler = self.siglip_resources.make_single_head_sampler(
                self.config, seed=self.config.seed)
        return self._single_head_sampler

    def _collate(self, items):
        cfg = self.config
        # room for every video's positives and negatives
        max_texts = cfg.batch_size * (cfg.siglip_max_positive_per_video
                                      + cfg.siglip_negatives_per_video)
        if self.single_head:
            # The sampler's round-robin state runs from batch to batch, so it
            # must be called once a batch, in batch order: the loader
            # collates in its one producer thread (process workers only
            # build items; collation stays in this process). Validation
            # batches go through here too and advance it, as in the JAX
            # runner, whose validation calls the same collate.
            res = self.siglip_resources
            batch = collate_single_head(
                items, self.tokenizer, self.single_head_sampler(), res.text_by_id,
                res.video_to_positives,
                epoch=getattr(self.datasets.get("train"), "epoch", 0),
                max_text_length=cfg.max_text_length, max_texts=max_texts,
                patch=wire_patch(cfg))
        elif self.multi_positive:
            batch = collate_multi_positive(items, self.tokenizer,
                                           max_text_length=cfg.max_text_length,
                                           max_texts=max_texts, patch=wire_patch(cfg))
        else:
            # length buckets are per-host batch content (one process only);
            # every rank collates the global batch, so its bucket is the
            # one-process run's
            buckets = cfg.text_length_buckets if cfg.process_count == 1 else []
            batch = collate_clip(items, self.tokenizer,
                                 max_text_length=cfg.max_text_length,
                                 length_buckets=buckets, patch=wire_patch(cfg))
        if cfg.locca_enabled:
            # the LocCa targets: the report rebuilt from the positives (SigLIP
            # items), else the sample's own report
            texts = [it.get("locca_report") or it.get("text", "") for it in items]
            batch.update(locca_caption_batch(texts, self.tokenizer, cfg.locca_max_seq_len))
        return batch

    def _make_loader(self, dataset, training: bool):
        """The training batches of the class-aware sampler when the SigLIP
        settings ask for it and the dataset labels its samples; else the
        epoch-seeded order of ``make_loader``."""
        cfg = self.config
        sampling = self.siglip_runtime.sampling
        if not (training and sampling.use_class_aware_sampler
                and hasattr(dataset, "abnormal_labels")):
            return make_loader(cfg, dataset, self._collate, training)
        sampler = ClassAwareBatchSampler(
            dataset.abnormal_labels(), cfg.batch_size,
            abnormal_ratio=sampling.abnormal_ratio, seed=cfg.seed,
            process_index=cfg.process_index, process_count=cfg.process_count)
        return PrefetchLoader(dataset, sampler, self._collate,
                              num_workers=max(1, cfg.num_workers),
                              backend=cfg.loader_backend, shard=data_shard())

    def init_from_checkpoint(self, path: str) -> None:
        """Warm start of the parameters (optimizer and step stay fresh) from
        a port checkpoint ``.pt`` or an ``.npz`` of the JAX training tree,
        leaf by leaf where the path and the shape match."""
        p = self.state.params
        if str(path).endswith(".npz"):
            tree = convert.load_params_npz(path)
            if set(tree) == {"params"}:
                tree = tree["params"]
            b = self.bundle
            current = convert.training_tree(b.video_model, b.text_model,
                                            p["log_temp"], p["logit_bias"], b.locca_decoder)
            convert.load_training_tree(_merge_params_by_path(current, tree),
                                       b.video_model, b.text_model,
                                       p["log_temp"], p["logit_bias"], b.locca_decoder)
            return
        saved = torch.load(path, map_location="cpu", weights_only=True)
        splits = model_splits(p)  # (a checkpoint holds whole leaves)
        g = distributed.grid()
        n, i = g.shape[MODEL_AXIS], g.index[MODEL_AXIS]
        with torch.no_grad():
            for k, v in saved.get("params", saved).items():
                if k in splits and v.shape[splits[k].dim] == p[k].shape[splits[k].dim] * n:
                    v = take_shard(v, splits[k], n, i)
                if k in p and p[k].shape == v.shape:
                    p[k].copy_(v)

    # ------------------------------------------------------------------ #
    # training
    # ------------------------------------------------------------------ #

    def train(self, start_epoch: int = 0, end_epoch: Optional[int] = None) -> Dict:
        cfg = self.config
        end_epoch = end_epoch if end_epoch is not None else cfg.epochs
        patience_left = cfg.early_stopping_patience or math.inf
        history = []

        for epoch in range(start_epoch, end_epoch):
            temp = temperature_at(
                epoch, cfg.epochs, cfg.temp_schedule, cfg.temperature,
                cfg.temp_start, cfg.temp_end,
            )
            vfr = freeze_ratio_at(
                epoch, cfg.epochs, cfg.video_freeze_ratio, cfg.video_freeze_schedule
            )
            tfr = freeze_ratio_at(
                epoch, cfg.epochs, cfg.text_freeze_ratio, cfg.text_freeze_schedule
            )

            t_epoch = time.perf_counter()
            train_metrics = self._run_train_epoch(epoch, temp, vfr, tfr)
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

            meta = {
                "epoch": epoch,
                "train_loss": train_metrics.get("loss"),
                "val_loss": val_metrics.get("loss"),
                "alignment": val_metrics.get("alignment"),
                "temperature": train_metrics.get("temperature"),
                "best_val_loss": self.best_val_loss,
                "best_epoch": self.best_epoch,
                "highest_alignment": self.highest_alignment,
                "dataset_mean": self.stats[0],
                "dataset_std": self.stats[1],
            }
            val_loss = val_metrics.get("loss", train_metrics.get("loss"))
            improved = val_loss is not None and val_loss < self.best_val_loss
            if improved:
                self.best_val_loss = float(val_loss)
                self.best_epoch = epoch
                meta["best_val_loss"] = self.best_val_loss
                meta["best_epoch"] = self.best_epoch
                patience_left = cfg.early_stopping_patience or math.inf
            else:
                patience_left -= 1
            align = val_metrics.get("alignment")
            new_alignment = align is not None and align > self.highest_alignment
            if new_alignment:
                self.highest_alignment = float(align)
                meta["highest_alignment"] = self.highest_alignment

            # every rank (rank 0 writes)
            host = (self.generator, self._single_head_sampler)
            self.ckpt.save_latest(self.state, meta, *host)
            if improved:
                self.ckpt.save_best(self.state, epoch, meta, *host)
            if new_alignment:
                self.ckpt.save_alignment(self.state, epoch, meta, *host)

            if patience_left <= 0:
                break
        return {"history": history, "best_epoch": self.best_epoch,
                "best_val_loss": self.best_val_loss,
                "output_dir": str(self.output_dir)}

    def _run_train_epoch(self, epoch: int, temp: float, vfr: float, tfr: float):
        """The pipelined step loop (``run_pipelined_epoch``), with the step
        metrics logged every ``period * 10`` steps."""

        def step(batch):
            self.state, metrics = self.train_step(self.state, batch, self.generator,
                                                  vfr, tfr, temp)
            return metrics

        def after_step(i, batch, device_batch, metrics):
            if self.siglip_runtime.debug.fires(epoch, i):
                # every rank runs the forward (its gathers); rank 0 writes
                self._siglip_debug_dump(epoch, batch, device_batch, metrics)

        return run_pipelined_epoch(
            self, epoch, step, log_every=max(1, self.config.period * 10),
            after_step=after_step if self.multi_positive else None)

    def _siglip_debug_dump(self, epoch, batch, device_batch, metrics):
        """One deterministic forward on the current parameters (one step
        past the step whose metrics these are), then each sampled video's
        logits against the batch's bank, with the step's metrics, into
        ``siglip_debug/epoch_{e}.jsonl``."""
        params = self.state.params
        out = self.eval_step(params, device_batch)
        bias = params["logit_bias"].item()
        logits = siglip_logging.siglip_logits(
            out["video_emb"].float().cpu().numpy(), out["text_emb"].float().cpu().numpy(),
            params["log_temp"].item(), bias, self.config.siglip_logit_clamp)
        records = siglip_logging.build_debug_records(
            [p[0] for p in batch["paths"]], batch.get("unique_texts", []),
            np.asarray(batch["positive_mask"]), logits,
            positive_weights=batch.get("positive_weights"),
            sample_count=self.config.siglip_debug_sample_count)
        if not self.config.is_ref_device:
            return
        if self.siglip_debug is None:
            self.siglip_debug = siglip_logging.SiglipDebugLogger(self.output_dir)
        step = int(self.state.step)
        self.siglip_debug.log_batch(epoch, step, records, header={
            "params_step": step, "metrics_step": step - 1,
            "loss": metrics["loss"], "temperature": metrics["temperature"],
            "logit_bias": bias, "grad_norm": metrics["grad_norm"],
            "grad_norm_video": metrics.get("grad_norm_video_encoder", 0.0),
            "grad_norm_text": metrics.get("grad_norm_text_encoder", 0.0)})

    # ------------------------------------------------------------------ #
    # validation with retrieval metrics
    # ------------------------------------------------------------------ #

    def validate(self, epoch: int = 0, split: str = "val") -> Dict[str, float]:
        """Validation loss and the retrieval panel; ``seconds`` is the
        pass's wall time, bank encoding and metrics included."""
        loader = self.loaders.get(split)
        if loader is None:
            return {}
        t0 = time.perf_counter()
        losses: List[float] = []
        locca_losses: List[float] = []
        v_embs: List[np.ndarray] = []
        texts: List[List[str]] = []
        paths: List[str] = []

        def consume(batch, out):
            losses.append(float(out["loss"]))
            if "locca_loss" in out:
                locca_losses.append(float(out["locca_loss"]))
            n_real = len(batch["paths"])  # (the gathered padding rows are the last)
            v_embs.append(unpad(out["video_emb"], n_real))
            if self.multi_positive:
                # every positive of a video, not its first only
                texts.extend([t or [""] for t in self._positives_of_batch(batch)])
            else:
                texts.extend([[t] for t in batch["texts"]])
            paths.extend([p[0] for p in batch["paths"]])

        pending = None
        for batch in loader:
            out = self.eval_step(self.state.params,
                                 batch_to_device(batch, self.device, self.replicated_keys))
            if pending is not None:
                consume(*pending)
            pending = (batch, out)
        if pending is not None:
            consume(*pending)

        if not v_embs:
            return {}
        v_emb = np.concatenate(v_embs)
        metrics = {"loss": float(np.mean(losses))}
        if locca_losses:
            metrics["locca_loss"] = float(np.mean(locca_losses))
        metrics.update(self._retrieval_eval(v_emb, texts, epoch, split, paths=paths))
        metrics["seconds"] = time.perf_counter() - t0
        return metrics

    @staticmethod
    def _positives_of_batch(batch) -> List[List[str]]:
        """Each video's positive texts, from the batch's bank."""
        uniq = batch.get("unique_texts", [])
        return [[uniq[j] for j in np.flatnonzero(row) if j < len(uniq)]
                for row in np.asarray(batch["positive_mask"])]

    @torch.no_grad()
    def _encode_texts(self, unique_texts: List[str], batch_size: int = 64):
        """The deduplicated reports, encoded in fixed-size batches."""
        embs = []
        for i in range(0, len(unique_texts), batch_size):
            chunk = unique_texts[i: i + batch_size]
            pad = batch_size - len(chunk)
            enc = self.tokenizer(
                chunk + [""] * pad, max_length=self.config.max_text_length,
                padding="max_length", truncation=True, return_tensors="np",
            )
            e = self.bundle.text_model(
                torch.from_numpy(enc["input_ids"]).long().to(self.device),
                attention_mask=torch.from_numpy(enc["attention_mask"]).to(self.device),
                deterministic=True,
            )
            embs.append(e.float().cpu().numpy()[: len(chunk)])
        return np.concatenate(embs) if embs else np.zeros((0, 1), np.float32)

    def _retrieval_eval(self, v_emb, texts, epoch, split,
                        paths: Optional[List[str]] = None) -> Dict[str, float]:
        """Dedup -> encode -> N x M similarity -> metrics -> artifacts.
        ``texts``: each video's positive texts (its report alone in CLIP
        mode); the ground truth marks every positive, the alignment and the
        artifacts read the first."""
        cfg = self.config
        uniq: Dict[str, int] = {}
        pos_ids: List[List[int]] = []
        for tl in texts:
            ids = []
            for t in tl:
                if t not in uniq:
                    uniq[t] = len(uniq)
                ids.append(uniq[t])
            pos_ids.append(ids)
        unique_texts = list(uniq)
        if not unique_texts or len(v_emb) == 0:
            return {}
        text_ids = [ids[0] for ids in pos_ids]
        t_emb = self._encode_texts(unique_texts)

        vn = v_emb / np.maximum(np.linalg.norm(v_emb, axis=1, keepdims=True), 1e-8)
        tn = t_emb / np.maximum(np.linalg.norm(t_emb, axis=1, keepdims=True), 1e-8)
        sim = vn @ tn.T
        gt = np.zeros((len(v_emb), len(unique_texts)), dtype=bool)
        for i, ids in enumerate(pos_ids):
            gt[i, ids] = True
        metrics = compute_retrieval_metrics(sim, gt, recall_k=cfg.recall_k,
                                            ndcg_k=cfg.ndcg_k)
        metrics["alignment"] = compute_alignment_score(v_emb, t_emb[np.asarray(text_ids)])
        if self.multi_positive and self.siglip_resources is not None:
            # the tree/segment/severity panel, keyed by text through the
            # SigLIP text catalog
            res = self.siglip_resources
            meta_by_text: Dict[str, Dict] = {}
            for tid, meta in res.meta_by_id.items():
                meta_by_text.setdefault(res.text_by_id.get(tid, ""), meta)
            metrics.update(compute_semantic_metrics(sim, texts, meta_by_text, unique_texts))

        if cfg.is_ref_device:
            art = self.output_dir / split
            art.mkdir(parents=True, exist_ok=True)
            with open(art / f"unique_texts_epoch_{epoch}.csv", "w", newline="") as f:
                w = csv.writer(f, lineterminator="\n")
                w.writerow(["text"])
                w.writerows([t] for t in unique_texts)
            np.savez(art / f"text_embeddings_epoch_{epoch}.npz",
                     text_embeddings=t_emb, video_embeddings=v_emb)
            k = min(5, sim.shape[1])
            topk = np.argsort(-sim, axis=1)[:, :k]
            header = (["path", "gt_text", "gt_rank"]
                      + [f"top{j + 1}_text" for j in range(k)]
                      + [f"top{j + 1}_score" for j in range(k)])
            with open(art / f"retrieval_results_epoch_{epoch}.csv", "w",
                      newline="") as f:
                w = csv.writer(f, lineterminator="\n")
                w.writerow(header)
                for i in range(len(v_emb)):
                    # best rank over the positive set
                    gt_rank = int(1 + min(np.sum(sim[i] > sim[i, j]) for j in pos_ids[i]))
                    w.writerow([paths[i] if paths and i < len(paths) else "",
                                unique_texts[text_ids[i]], gt_rank]
                               + [unique_texts[t] for t in topk[i]]
                               + [float(sim[i, t]) for t in topk[i]])
        return metrics

    # ------------------------------------------------------------------ #
    # inference: a text bank's top-k, and their averaged metadata
    # ------------------------------------------------------------------ #

    @torch.no_grad()
    def video_embeddings(self, batch) -> np.ndarray:
        """The study (or clip) embeddings of a host batch, as the eval step
        computes them (the video tower alone): each rank encodes its rows,
        and every rank gets the batch's, gathered."""
        db = batch_to_device(batch, self.device, self.replicated_keys)
        v = self.bundle.video_model(db["videos"], video_mask=db.get("video_mask"),
                                    deterministic=True)
        return unpad(gather_rows(torch.nan_to_num(v)), len(batch["paths"]))

    def inference(self) -> List[Dict[str, Any]]:
        """Each sample's embedding against the text bank of
        ``text_embeddings_path`` (``text_embeddings`` of an ``.npz``, or a
        bare array): cosine similarity, the ``topk`` best texts, and over
        their rows of the ``metadata_path`` table each numeric column's
        mean and each other column's mode (``average_metadata``), written
        to ``{inference_results_path}/averaged_metadata.csv``; returns the
        rows. Without a bank (the embedding-extraction configs) the
        embeddings are written instead, as ``video_embeddings`` / ``paths``
        of ``{inference_results_path}/video_embeddings.npz``."""
        cfg = self.config
        loader = self.loaders.get(cfg.run_mode) or next(iter(self.loaders.values()))
        out_dir = Path(cfg.inference_results_path)
        if not cfg.text_embeddings_path:
            embs, paths = [], []
            for batch in loader:
                embs.append(self.video_embeddings(batch))
                paths.extend(p[0] for p in batch["paths"])
            if cfg.is_ref_device:
                out_dir.mkdir(parents=True, exist_ok=True)
                np.savez(out_dir / "video_embeddings.npz",
                         video_embeddings=np.concatenate(embs), paths=np.asarray(paths))
            return [{"path": p} for p in paths]

        bank = np.load(cfg.text_embeddings_path)
        t_emb = bank["text_embeddings"] if hasattr(bank, "files") else np.asarray(bank)
        columns, values, numeric = read_metadata(cfg.metadata_path)
        tn = t_emb / np.maximum(np.linalg.norm(t_emb, axis=1, keepdims=True), 1e-8)
        rows: List[Dict[str, Any]] = []
        for batch in loader:
            v = self.video_embeddings(batch)
            v = v / np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-8)
            sim = v @ tn.T
            topk = np.argsort(-sim, axis=1)[:, : cfg.topk]
            for b, idxs in enumerate(topk):
                row: Dict[str, Any] = {
                    "path": batch["paths"][b][0] if batch.get("paths") else "",
                    "topk_indices": list(map(int, idxs)),
                    "topk_scores": [float(sim[b, j]) for j in idxs],
                }
                for col in columns:
                    row[col] = average_metadata([values[col][j] for j in idxs], numeric[col])
                rows.append(row)
        if cfg.is_ref_device:
            out_dir.mkdir(parents=True, exist_ok=True)
            write_csv(out_dir / "averaged_metadata.csv",
                      list(dict.fromkeys(["path", "topk_indices", "topk_scores"] + columns)),
                      rows, sep=",")
        return rows

    # ------------------------------------------------------------------ #
    # resume
    # ------------------------------------------------------------------ #

    def restore_best(self, fallback_latest: bool = True) -> bool:
        """Load the best-val-loss checkpoint, else the latest."""
        name = self.ckpt.find_best()
        if name is None and fallback_latest and self.ckpt.latest_exists():
            name = "checkpoint"
        if name is None:
            return False
        self.state = self.ckpt.restore(self.state, name, self.generator)
        return True

    def maybe_resume(self) -> int:
        """With ``resume_training`` and a latest checkpoint in this run's
        directory: its parameters, optimizer state, step, dropout generator,
        single-head sampler and best-so-far trackers; returns the epoch to
        start from."""
        if self.config.resume_training and self.ckpt.latest_exists():
            sampler = self.single_head_sampler() if self.single_head else None
            self.state = self.ckpt.restore(self.state, "checkpoint", self.generator, sampler)
            meta = self.ckpt.load_meta("checkpoint") or {}
            self.best_val_loss = float(meta.get("best_val_loss", math.inf))
            self.best_epoch = int(meta.get("best_epoch", -1))
            self.highest_alignment = float(meta.get("highest_alignment", -math.inf))
            self.start_epoch = int(meta.get("epoch", -1)) + 1
        return self.start_epoch
