"""Prefetching data loader (thread or process workers).

The port's copy of the JAX package's ``data/loader.py``: a worker pool
builds the items of the batches ahead of the step, and a bounded queue
holds collated host batches, so batch i+1 is ready while the card runs
step i.

- ``thread`` (default): a thread pool; numpy releases the GIL in its bulk
  work, Python-side item assembly stays serialized.
- ``process``: spawned workers, each with a pickled copy of the dataset
  (items are pure functions of (seed, epoch, index), so any worker may
  build any of them); collation stays in this process. The workers are
  spawned with ``CUDA_VISIBLE_DEVICES`` empty, so none of them can open the
  card, and re-import ``__main__``: the launching script must be
  import-safe.

With ``shard=(world, rank)`` (data parallelism) the sampler still yields
the global batches; the items of the rows this rank holds
(``parallel/batching.owned_rows``) are built in full and the others without
their videos, so every rank collates the same global batch (the same text
bucket, bank and single-head sampler state) and decodes its own clips only.
"""

from __future__ import annotations

import functools
import os
import queue
import threading
from collections import deque
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterator, List, Tuple

from deepcoro_clip_tpu_torch.parallel.batching import owned_rows

_PROC_DATASET = None


def _proc_init(dataset) -> None:
    global _PROC_DATASET
    _PROC_DATASET = dataset


def _item(dataset, i, load: bool):
    """Item ``i`` in full, or (a row another rank holds) without its videos."""
    return dataset[i] if load else dataset.get(i, load=False)


def _proc_items(idxs, loads):
    return [_item(_PROC_DATASET, i, load) for i, load in zip(idxs, loads)]


class PrefetchLoader:
    def __init__(
        self,
        dataset,
        sampler,
        collate_fn: Callable,
        num_workers: int = 2,
        prefetch_batches: int = 2,
        backend: str = "thread",
        shard: Tuple[int, int] = (1, 0),
    ):
        if backend not in ("thread", "process"):
            raise ValueError(f"unknown loader backend {backend!r}")
        self.dataset = dataset
        self.sampler = sampler
        self.collate_fn = collate_fn
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch_batches)
        self.backend = backend
        self.shard = shard

    def _loads(self, n: int) -> List[bool]:
        """Which rows of an ``n``-row global batch this rank loads in full."""
        world, rank = self.shard
        if world == 1:
            return [True] * n
        own = owned_rows(n, world, rank)
        return [j in own for j in range(n)]

    def __len__(self) -> int:
        return len(self.sampler)

    def set_epoch(self, epoch: int) -> None:
        if hasattr(self.sampler, "set_epoch"):
            self.sampler.set_epoch(epoch)
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)  # round-robin positive rotation

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        batches = list(self.sampler)
        if not batches:
            return
        if self.backend == "process":
            yield from self._iter_process(batches)
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def produce():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for idxs in batches:
                        if stop.is_set():
                            return
                        items = list(pool.map(functools.partial(_item, self.dataset),
                                              idxs, self._loads(len(idxs))))
                        q.put(self.collate_fn(items))
            except Exception as e:  # surface worker errors to the consumer
                q.put(e)
            finally:
                q.put(None)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()

    def _iter_process(self, batches) -> Iterator[Dict[str, Any]]:
        """Spawned worker processes decode items; collation (and therefore
        any non-picklable collate_fn) stays in this process. Bounded
        lookahead (num_workers + prefetch in flight) gives backpressure."""
        import multiprocessing as mp

        prev = os.environ.get("CUDA_VISIBLE_DEVICES")
        os.environ["CUDA_VISIBLE_DEVICES"] = ""  # workers must never open the card
        try:
            ctx = mp.get_context("spawn")
            with ProcessPoolExecutor(
                self.num_workers, mp_context=ctx,
                initializer=_proc_init, initargs=(self.dataset,),
            ) as pool:
                pending: deque = deque()
                it = iter(batches)

                def top_up():
                    while len(pending) < self.num_workers + self.prefetch:
                        idxs = next(it, None)
                        if idxs is None:
                            return
                        pending.append(pool.submit(_proc_items, list(idxs),
                                                   self._loads(len(idxs))))

                top_up()
                while pending:
                    items = pending.popleft().result()
                    top_up()  # keep the pipeline full before collating
                    yield self.collate_fn(items)
        finally:
            if prev is None:
                os.environ.pop("CUDA_VISIBLE_DEVICES", None)
            else:
                os.environ["CUDA_VISIBLE_DEVICES"] = prev
