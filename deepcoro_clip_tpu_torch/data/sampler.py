"""Deterministic epoch-seeded batch sampler (numpy).

The port's copy of the JAX package's ``ShardedBatchSampler``: a permutation
from ``np.random.default_rng(seed + epoch)``, fixed-size batches, then the
batches of this process (``batches[rank::nprocs]``). The same seed gives
the same batch order as in the JAX package. The class-aware and
severity-bucket samplers come with the SigLIP slice.
"""

from __future__ import annotations

from typing import Iterator, List

import numpy as np


class ShardedBatchSampler:
    """Epoch-seeded permutation -> fixed-size batches -> host shard."""

    def __init__(
        self,
        n_items: int,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 42,
        drop_last: bool = True,
        process_index: int = 0,
        process_count: int = 1,
    ):
        self.n = n_items
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.rank = process_index
        self.nprocs = process_count
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _batches(self) -> List[np.ndarray]:
        idx = np.arange(self.n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            idx = rng.permutation(idx)
        nb = len(idx) // self.batch_size
        batches = [
            idx[i * self.batch_size : (i + 1) * self.batch_size]
            for i in range(nb)
        ]
        if not self.drop_last and len(idx) % self.batch_size:
            batches.append(idx[nb * self.batch_size :])
        return batches

    def __iter__(self) -> Iterator[np.ndarray]:
        yield from self._batches()[self.rank :: self.nprocs]

    def __len__(self) -> int:
        nb = self.n // self.batch_size
        if not self.drop_last and self.n % self.batch_size:
            nb += 1
        return len(range(self.rank, nb, self.nprocs))
