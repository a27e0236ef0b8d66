"""Runner plumbing shared by the pipelines: the dataset statistics.

The port's copy of ``resolve_dataset_stats`` from the JAX package's
``runners/common.py``. There is no mesh to size: one process drives one
card.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from deepcoro_clip_tpu_torch.data.datasets import StatsDataset


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
