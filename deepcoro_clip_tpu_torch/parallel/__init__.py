"""Meshes and sequence parallelism (the JAX package's ``parallel/``).

Ported: ``mesh`` (``MeshSpec``, ``make_mesh``) and ``ring_attention``.
The batch sharding helpers come with data parallelism.
"""

from deepcoro_clip_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    MeshSpec,
    make_mesh,
)
from deepcoro_clip_tpu_torch.parallel.ring_attention import ring_attention

__all__ = ["DATA_AXIS", "MODEL_AXIS", "Mesh", "MeshSpec", "make_mesh",
           "ring_attention"]
