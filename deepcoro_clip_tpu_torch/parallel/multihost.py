"""Host-side metadata across the ranks: the port of the JAX package's
``parallel/multihost.py`` on ``torch.distributed``'s object collectives.

Metadata (Python objects, generator states, host arrays) never rides the
device here either: ``all_gather_object`` and ``broadcast_object_list``
pickle it. With one rank (no process group) each function is the
identity, as the JAX ones are with one process.
"""

from __future__ import annotations

from typing import Any, List

import numpy as np
import torch.distributed as dist

from deepcoro_clip_tpu_torch.parallel.distributed import is_active


def gather_objects(objs: List[Any]) -> List[Any]:
    """All-gather a per-rank list of picklable objects; the concatenated
    global list, in rank order, on every rank."""
    if not is_active():
        return list(objs)
    out: List[Any] = [None] * dist.get_world_size()
    dist.all_gather_object(out, list(objs))
    return [o for part in out for o in part]


def gather_arrays(x: np.ndarray) -> np.ndarray:
    """Concatenate a per-rank numpy array across the ranks along axis 0."""
    if not is_active():
        return np.asarray(x)
    out: List[Any] = [None] * dist.get_world_size()
    dist.all_gather_object(out, np.asarray(x))
    return np.concatenate(out)


def broadcast_from_host0(obj: Any) -> Any:
    """Rank 0's ``obj`` on every rank."""
    if not is_active():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]
