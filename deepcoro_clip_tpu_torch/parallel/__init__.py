"""Meshes and sequence parallelism (the JAX package's ``parallel/``).

Ported: ``mesh`` (``MeshSpec``, ``make_mesh`` and the batch helpers),
``ring_attention``, ``batching`` (``make_batch_sharding_fn``) and
``multihost`` (``gather_objects``, ``gather_arrays``,
``broadcast_from_host0``); ``distributed`` holds the process group, its
``(data, model)`` grid of ranks (``mesh.ProcessMesh``) and the collectives
of data and sequence parallelism over ``torch.distributed``.
"""

from deepcoro_clip_tpu_torch.parallel.batching import make_batch_sharding_fn
from deepcoro_clip_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    MeshSpec,
    ProcessMesh,
    batch_sharding,
    local_batch_slice,
    make_mesh,
    pad_to_multiple,
    shard_batch,
)
from deepcoro_clip_tpu_torch.parallel.multihost import (
    broadcast_from_host0,
    gather_arrays,
    gather_objects,
)
from deepcoro_clip_tpu_torch.parallel.ring_attention import ring_attention

__all__ = ["DATA_AXIS", "MODEL_AXIS", "Mesh", "MeshSpec", "ProcessMesh", "batch_sharding",
           "broadcast_from_host0", "gather_arrays", "gather_objects",
           "local_batch_slice", "make_batch_sharding_fn", "make_mesh",
           "pad_to_multiple", "ring_attention", "shard_batch"]
