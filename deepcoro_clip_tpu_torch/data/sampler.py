"""Deterministic epoch-seeded batch samplers (numpy).

The port's copies of the JAX package's ``ShardedBatchSampler`` (a
permutation from ``np.random.default_rng(seed + epoch)``, fixed-size
batches, then the batches of this process, ``batches[rank::nprocs]``) and
``ClassAwareBatchSampler`` (a fixed abnormal:normal ratio a batch, drawn
with replacement from the same generator), and ``SeverityBucketBatchSampler``
(a quota a severity bucket, with an optional warmup toward the easy
buckets). The same seed gives the same batches as in the JAX package.
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


class SeverityBucketBatchSampler(ShardedBatchSampler):
    """Batches with a quota from each severity bucket.

    Each batch draws ``round(batch_size * quota)`` indices from every bucket
    (with replacement), fills the rest from quota-weighted bucket draws, and
    is shuffled before it is cut to ``batch_size``. ``exam_priors`` multiply
    the quotas; during the first ``warmup_epochs`` the easy buckets (normal,
    minimal, mild) weigh 1.5x and the others 0.5x. The quotas are
    renormalized after both."""

    def __init__(
        self,
        severities: Sequence[str],
        batch_size: int,
        bucket_quotas: Optional[dict] = None,  # severity -> fraction of batch
        exam_priors: Optional[dict] = None,  # severity -> prior multiplier
        warmup_epochs: int = 0,
        seed: int = 42,
        process_index: int = 0,
        process_count: int = 1,
        n_batches: Optional[int] = None,
    ):
        severities = [str(s).lower() for s in severities]
        super().__init__(
            len(severities), batch_size, shuffle=True, seed=seed,
            process_index=process_index, process_count=process_count,
        )
        self.buckets: dict = {}
        for i, s in enumerate(severities):
            self.buckets.setdefault(s, []).append(i)
        if bucket_quotas:
            self.quotas = {str(k).lower(): v for k, v in bucket_quotas.items()}
            if not set(self.quotas) & set(self.buckets):
                raise ValueError(
                    f"bucket_quotas keys {sorted(self.quotas)} match none of "
                    f"the data's severities {sorted(self.buckets)}"
                )
        else:
            self.quotas = {s: 1.0 / len(self.buckets) for s in self.buckets}
        self.exam_priors = {str(k).lower(): float(v)
                            for k, v in (exam_priors or {}).items()}
        self.warmup_epochs = warmup_epochs
        self.n_batches = n_batches or max(1, len(severities) // batch_size)
        self._easy = {"normal", "minimal", "mild"}

    def _effective_quotas(self) -> dict:
        q = dict(self.quotas)
        if self.exam_priors:
            q = {s: v * self.exam_priors.get(s, 1.0) for s, v in q.items()}
        if self.epoch < self.warmup_epochs:
            q = {s: v * (1.5 if s in self._easy else 0.5) for s, v in q.items()}
        total = sum(q.values()) or 1.0
        return {s: v / total for s, v in q.items()}

    def _batches(self) -> List[np.ndarray]:
        rng = np.random.default_rng(self.seed + self.epoch)
        quotas = self._effective_quotas()
        names = [s for s in quotas if self.buckets.get(s)]
        if not names:
            return super()._batches()
        probs = np.asarray([quotas[s] for s in names], np.float64)
        probs = probs / probs.sum()
        batches = []
        for _ in range(self.n_batches):
            batch = []
            for s in names:
                n = int(round(self.batch_size * quotas[s]))
                if n and self.buckets[s]:
                    batch.extend(rng.choice(self.buckets[s], n, replace=True))
            # shuffled before the cut, so that the round-off overflow does
            # not always cost the last-listed bucket
            while len(batch) < self.batch_size:
                s = names[int(rng.choice(len(names), p=probs))]
                batch.append(int(rng.choice(self.buckets[s])))
            batch = np.asarray(batch)
            rng.shuffle(batch)
            batches.append(batch[: self.batch_size])
        return batches

    def __len__(self) -> int:
        return len(range(self.rank, self.n_batches, self.nprocs))
