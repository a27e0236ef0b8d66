"""Runner plumbing shared by the pipelines: the dataset statistics, the
loader, a batch onto the device, a step's metrics onto the host, and the
pipelined train epoch.

``resolve_dataset_stats`` is the port's copy of the JAX package's
``runners/common.py`` function. The data axis is the rows of the process
grid (``parallel/distributed.py``): the loaders yield global batches,
``batch_to_device`` keeps the rows of this rank's data index (the same
bits on every rank of its model group), and an epoch's metrics are the
global batch's on every rank.
"""

from __future__ import annotations

import math
import time
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from deepcoro_clip_tpu_torch.data.datasets import StatsDataset
from deepcoro_clip_tpu_torch.data.loader import PrefetchLoader
from deepcoro_clip_tpu_torch.data.sampler import ShardedBatchSampler
from deepcoro_clip_tpu_torch.parallel import distributed
from deepcoro_clip_tpu_torch.parallel.batching import make_batch_sharding_fn


class NonFiniteLossError(RuntimeError):
    """A train step's loss was not finite."""


def dataset_kwargs(config) -> Dict[str, Any]:
    """The ``VideoClipDataset`` arguments a config gives every split."""
    c = config
    return dict(
        data_filename=c.data_filename, root=c.root, split_column=c.split_column,
        datapoint_loc_label=c.datapoint_loc_label, target_label=c.target_label,
        multi_video=c.multi_video, num_videos=c.num_videos,
        groupby_column=c.groupby_column, shuffle_videos=c.shuffle_videos,
        frames=c.frames, stride=c.stride, resize=c.resize, seed=c.seed,
        wire_dtype=c.wire_dtype, mono_wire=c.mono_wire,
    )


def make_loader(config, dataset, collate: Callable, training: bool) -> PrefetchLoader:
    """The epoch-seeded batch order (shuffled and whole batches only when
    training) behind the prefetch loader; every rank draws the same global
    batches and builds its own rows' items in full."""
    sampler = ShardedBatchSampler(
        len(dataset), config.batch_size, shuffle=training, seed=config.seed,
        drop_last=training, process_index=config.process_index,
        process_count=config.process_count,
    )
    return PrefetchLoader(dataset, sampler, collate, num_workers=max(1, config.num_workers),
                          backend=config.loader_backend, shard=data_shard())


def data_shard() -> Tuple[int, int]:
    """``(size, this rank's index)`` of the grid's data axis."""
    return distributed.data_size(), distributed.data_rank()


def batch_to_device(batch: Dict[str, Any], device: torch.device,
                    replicated_keys: Sequence[str] = ()) -> Dict[str, Any]:
    """This rank's rows of a global host batch's arrays (and dicts of
    arrays, such as the probing ``targets``) with their ``sample_mask``, on
    ``device``, by ``parallel/batching.make_batch_sharding_fn``: with one
    rank every row, and a mask of ones. On the card the copies leave from
    pinned memory without a host wait, so the next batch's copy queues
    behind the running step. The ranks of a model group take its first
    rank's tensors (``distributed.share_over_model``)."""
    return distributed.share_over_model(
        make_batch_sharding_fn(*data_shard(), replicated_keys)(batch, device))


def unpad(x, n: int) -> np.ndarray:
    """The first ``n`` rows of a gathered global output, on the host: the
    real rows (the padding rows are the last)."""
    return x[:n].float().cpu().numpy()


def read_metrics(metrics: Dict[str, Any]) -> Dict[str, float]:
    """A step's metrics on the host, with one device-to-host copy."""
    keys = [k for k, v in metrics.items() if isinstance(v, torch.Tensor)]
    out = {k: float(v) for k, v in metrics.items() if k not in keys}
    if keys:
        dev = metrics[keys[0]].device  # (a scalar may live on the host)
        vals = torch.stack([metrics[k].detach().float().reshape(()).to(dev)
                            for k in keys])
        out.update(zip(keys, vals.cpu().tolist()))
    return {k: out[k] for k in metrics}


def run_pipelined_epoch(runner, epoch: int, step: Callable[[Dict[str, torch.Tensor]], Dict],
                        log_every: Optional[int] = None,
                        after_step: Optional[Callable] = None) -> Dict[str, float]:
    """One train epoch of ``runner`` (its ``loaders["train"]``, ``device``,
    ``state``, ``ckpt``, ``generator``, ``config`` and ``logger``):
    ``step(device_batch)`` runs one train step, sets ``runner.state`` and
    returns the step's metrics.

    Step i's metrics are read (one copy to the host) only after step i+1
    has been enqueued, so the card is not left idle while the host reads,
    and a non-finite loss is seen one step late: the ``nan_debug`` snapshot
    holds the state one step past the failing one (whose update the step's
    non-finite guard withheld), and ``NonFiniteLossError`` is raised. With
    ``log_every`` every such step's metrics are logged under ``step/``;
    ``after_step(i, host batch, device batch, metrics read)`` runs for each
    step once its metrics are read.
    Returns the mean of every step metric and ``loader_wait_ms``, the
    host's mean wait for the next batch a step."""
    loader = runner.loaders["train"]
    loader.set_epoch(epoch)
    agg: Dict[str, float] = {}
    n = 0
    wait = 0.0
    pending = None  # (i, metrics, host batch, device batch) of the step before

    def consume(entry):
        nonlocal n
        i, metrics, batch, device_batch = entry
        values = read_metrics(metrics)
        loss = values["loss"]
        if not math.isfinite(loss):
            # every rank (the loss is the global batch's); rank 0 writes
            runner.ckpt.save_debug(
                "nan_debug", runner.state,
                {"epoch": epoch, "nan_loss_at_step": i, "state_steps_past_failure": 1,
                 "nonfinite_update_guard": True},
                runner.generator)
            raise NonFiniteLossError(
                f"non-finite loss {loss} at epoch {epoch} step {i} (the nan_debug "
                "snapshot is one step past the failure, finite updates only; resume "
                "uses the last epoch checkpoint)")
        for k, v in values.items():
            agg[k] = agg.get(k, 0.0) + v
        n += 1
        if log_every and i % log_every == 0:
            runner.logger.log({f"step/{k}": v for k, v in values.items()},
                              step=int(runner.state.step))
        if after_step is not None:
            after_step(i, batch, device_batch, values)

    batches = iter(loader)
    i = 0
    while True:
        t0 = time.perf_counter()
        batch = next(batches, None)
        wait += time.perf_counter() - t0
        if batch is None:
            break
        device_batch = batch_to_device(batch, runner.device,
                                       getattr(runner, "replicated_keys", ()))
        metrics = step(device_batch)
        if pending is not None:
            consume(pending)
        pending = (i, metrics, batch if after_step else None,
                   device_batch if after_step else None)
        i += 1
    if pending is not None:
        consume(pending)
    out = {k: v / max(n, 1) for k, v in agg.items()}
    out["loader_wait_ms"] = wait * 1e3 / max(n, 1)
    return out


def resolve_dataset_stats(config, datasets: Dict[str, Optional[Any]]):
    """Dataset mean/std: the config's (``dataset_mean``/``dataset_std``, or
    the legacy ``data_mean``/``data_std``), else computed from the train
    split; outside training they must be given.

    Returns ``(mean, std)`` as float lists and writes them back to
    ``config.dataset_mean/std``, where the uint8 wire's patchify reads them
    when the bundle is built; on the float32 wire it pushes them into every
    dataset for host normalization."""
    mean = config.dataset_mean or getattr(config, "data_mean", None)
    std = config.dataset_std or getattr(config, "data_std", None)
    if mean is None:
        train = datasets.get("train")
        if train is None:
            raise ValueError(
                "dataset_mean/dataset_std must be provided for "
                f"run_mode={getattr(config, 'run_mode', None)!r} (statistics "
                "are computed from the train split only)"
            )
        mean, std = StatsDataset(train).compute()
        mean, std = mean.tolist(), std.tolist()
    stats = (list(map(float, mean)), list(map(float, std)))
    config.dataset_mean, config.dataset_std = stats
    if config.wire_dtype == "float32":
        for ds in datasets.values():
            if ds is not None:
                ds.mean, ds.std = stats
    return stats
