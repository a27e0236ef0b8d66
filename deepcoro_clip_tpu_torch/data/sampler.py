"""Deterministic epoch-seeded batch samplers (numpy).

The port's copies of the JAX package's ``ShardedBatchSampler`` (a
permutation from ``np.random.default_rng(seed + epoch)``, fixed-size
batches, then the batches of this process, ``batches[rank::nprocs]``) and
``ClassAwareBatchSampler`` (a fixed abnormal:normal ratio a batch, drawn
with replacement from the same generator). The same seed gives the same
batches as in the JAX package. The severity-bucket sampler of the
single-head path is not ported yet.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence

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


class ClassAwareBatchSampler(ShardedBatchSampler):
    """Fixed abnormal:normal ratio per batch, sampled with replacement;
    ``len(labels) // batch_size`` batches an epoch unless ``n_batches``."""

    def __init__(
        self,
        labels: Sequence[int],
        batch_size: int,
        abnormal_ratio: float = 0.5,
        seed: int = 42,
        process_index: int = 0,
        process_count: int = 1,
        n_batches: Optional[int] = None,
    ):
        labels = np.asarray(labels)
        super().__init__(
            len(labels), batch_size, shuffle=True, seed=seed,
            process_index=process_index, process_count=process_count,
        )
        self.pos_idx = np.flatnonzero(labels > 0)
        self.neg_idx = np.flatnonzero(labels <= 0)
        self.abnormal_ratio = abnormal_ratio
        self.n_batches = n_batches or max(1, len(labels) // batch_size)

    def _batches(self) -> List[np.ndarray]:
        rng = np.random.default_rng(self.seed + self.epoch)
        n_pos = max(1, int(round(self.batch_size * self.abnormal_ratio)))
        n_neg = self.batch_size - n_pos
        # a class with no sample lends its draws to the other
        pos_pool = self.pos_idx if len(self.pos_idx) else self.neg_idx
        neg_pool = self.neg_idx if len(self.neg_idx) else self.pos_idx
        batches = []
        for _ in range(self.n_batches):
            batch = np.concatenate([rng.choice(pos_pool, n_pos, replace=True),
                                    rng.choice(neg_pool, n_neg, replace=True)])
            rng.shuffle(batch)
            batches.append(batch)
        return batches

    def __len__(self) -> int:
        return len(range(self.rank, self.n_batches, self.nprocs))
