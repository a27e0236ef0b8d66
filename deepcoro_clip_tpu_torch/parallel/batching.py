"""Host batch -> this rank's device batch: the port of the JAX package's
``parallel/batching.py``.

The rule is the JAX one: the leading (batch) axis of the global batch is
padded to a multiple of the data axis (here the world size) by repeating
its last row, ``sample_mask`` gets zeros for the padding rows, and every
array is sharded over the data axis except the keys in ``replicated_keys``
(the SigLIP bank, which every rank encodes whole). This rank keeps its rows
(``parallel/mesh.batch_sharding``) and puts them on the device. At world
1 nothing is padded or cut: ``sample_mask`` is all ones.

``owned_rows`` names the rows of a global batch whose data a rank needs
(the padding repeats the last row, so a rank past the real rows needs
that one): the loaders build only those items in full.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Sequence, Set

import numpy as np
import torch

from deepcoro_clip_tpu_torch.parallel.mesh import (
    batch_sharding,
    local_batch_slice,
    pad_to_multiple,
)


def owned_rows(n: int, world: int, rank: int) -> Set[int]:
    """The rows of an ``n``-row global batch that rank ``rank`` holds after
    the padding."""
    rows = local_batch_slice(pad_to_multiple(n, world), world, rank)
    return {min(p, n - 1) for p in range(rows.start, rows.stop)}


def _put(v, device: torch.device):
    """A host array (or a dict of them) onto ``device``; on the card the
    copy leaves from pinned memory without a host wait."""
    if isinstance(v, dict):
        return {k: _put(x, device) for k, x in v.items()}
    t = torch.from_numpy(np.ascontiguousarray(v))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def make_batch_sharding_fn(world: int, rank: int, replicated_keys: Sequence[str] = ()
                           ) -> Callable[[Dict[str, Any], torch.device], Dict[str, Any]]:
    """``fn(host batch, device)``: the batch's arrays (and dicts of arrays,
    such as the probing ``targets``) padded, cut to this rank's rows and on
    ``device``, with ``sample_mask``."""
    replicated = frozenset(replicated_keys)

    def pad_rows(x, n, pad):
        if isinstance(x, dict):
            return {k: pad_rows(v, n, pad) for k, v in x.items()}
        if x.ndim >= 1 and x.shape[0] == n:
            return np.concatenate([x, np.repeat(x[-1:], pad, axis=0)])
        return x

    shard = batch_sharding(world, rank)

    def local(x, target):
        if isinstance(x, dict):
            return {k: local(v, target) for k, v in x.items()}
        return shard(x) if x.ndim >= 1 and x.shape[0] == target else x

    def fn(batch: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
        arrays = {k: v for k, v in batch.items() if isinstance(v, (np.ndarray, dict))}
        n = int(arrays["videos"].shape[0])
        mask = np.asarray(arrays.get("sample_mask", np.ones((n,), np.float32)))
        target = pad_to_multiple(n, world)
        if target != n:
            pad = target - n
            arrays = {k: (v if k in replicated else pad_rows(v, n, pad))
                      for k, v in arrays.items()}
            mask = np.concatenate([mask, np.zeros((pad,), np.float32)])
        arrays["sample_mask"] = mask
        if world > 1:
            arrays = {k: (v if k in replicated else local(v, target))
                      for k, v in arrays.items()}
        return {k: _put(v, device) for k, v in arrays.items()}

    return fn
