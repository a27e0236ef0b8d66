"""Dataset pixel statistics from a config (counterpart of ``ops/pixels.py``)."""

from __future__ import annotations


def config_stats(config):
    """(mean, std) from a pipeline config; ``dataset_*`` before ``data_*``."""
    mean = getattr(config, "dataset_mean", None) or getattr(config, "data_mean", None)
    std = getattr(config, "dataset_std", None) or getattr(config, "data_std", None)
    return mean, std
