"""Device meshes for the port: a ``(data, model)`` grid of ``torch.device``s
in one process, or of ranks across processes.

Port of the JAX package's ``parallel/mesh.py`` (``DATA_AXIS``,
``MODEL_AXIS``, ``MeshSpec``, ``make_mesh``). The JAX mesh is a grid of
devices that ``shard_map`` runs one program over. The port has two kinds:

- ``Mesh``: a plain grid of devices that one process walks:
  ``ring_attention`` sends the token chunks of a tensor to the devices along
  one axis and gathers the result back. A device may appear more than once,
  the counterpart of the JAX tests' virtual CPU devices:
  ``make_mesh(MeshSpec(1, 4), devices=["cpu"] * 4)`` is a ring of four
  shards on the CPU, ``devices=["cuda:0"] * 4`` a ring of four shards on one
  card, each shard with buffers and streams of its own.
- ``ProcessMesh``: the grid of the ranks of a ``torch.distributed`` group,
  seen from one rank (``parallel/distributed.init_grid`` builds it). Rank
  ``r`` of a ``(data=D, model=M)`` grid is cell ``(r // M, r % M)``, the
  JAX layout ``devices[:D*M].reshape(D, M)``; each axis has the process
  group of this rank's line along it. Every rank runs its own program:
  ``ring_attention`` over it takes this rank's token chunk.

The batch helpers (``batch_sharding``, ``shard_batch``, ``local_batch_slice``,
``pad_to_multiple``) carry the JAX file's rules over to data parallelism
across processes (``parallel/distributed.py``): the data axis is the rows
of the grid, and a rank holds the rows that the JAX run's data device of
its row index holds.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Union

import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"
AXES = (DATA_AXIS, MODEL_AXIS)


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """How to carve the device list. ``data * model`` must not exceed the
    device count (remaining devices are dropped only if sizes are explicit)."""

    data: int = -1  # -1: all remaining devices
    model: int = 1

    def resolve(self, n_devices: int) -> tuple[int, int]:
        model = max(1, self.model)
        data = self.data if self.data > 0 else n_devices // model
        if data * model > n_devices:
            raise ValueError(
                f"MeshSpec(data={data}, model={model}) needs {data * model} "
                f"devices, have {n_devices}"
            )
        return data, model


class Mesh:
    """A ``[data, model]`` grid of devices. ``shape`` maps each axis name to
    its size, as ``jax.sharding.Mesh.shape`` does."""

    def __init__(self, grid: Sequence[Sequence[torch.device]]):
        self.grid: List[List[torch.device]] = [list(row) for row in grid]
        self.shape: Dict[str, int] = {DATA_AXIS: len(self.grid),
                                      MODEL_AXIS: len(self.grid[0])}

    def devices_along(self, axis: str) -> List[torch.device]:
        """The devices of the first line of the grid along ``axis``: the
        shards of a tensor sharded over ``axis`` and replicated over the
        other axis (one replica is all a single process computes)."""
        if axis == MODEL_AXIS:
            return list(self.grid[0])
        if axis == DATA_AXIS:
            return [row[0] for row in self.grid]
        raise ValueError(f"unknown mesh axis {axis!r}; the axes are {AXES}")


class ProcessMesh:
    """This rank's view of a ``(data, model)`` grid of the process group's
    ranks: ``shape`` (axis -> size, as ``Mesh.shape``), ``index`` (axis ->
    this rank's coordinate), ``ranks`` (axis -> the global ranks of this
    rank's line along the axis, in order) and ``groups`` (axis -> the process
    group of that line; None where the line is this rank alone)."""

    def __init__(self, data: int, model: int, rank: int,
                 groups: Mapping[str, Any]):
        d, m = divmod(rank, model)
        self.shape: Dict[str, int] = {DATA_AXIS: data, MODEL_AXIS: model}
        self.index: Dict[str, int] = {DATA_AXIS: d, MODEL_AXIS: m}
        self.ranks: Dict[str, List[int]] = {
            DATA_AXIS: [i * model + m for i in range(data)],
            MODEL_AXIS: [d * model + j for j in range(model)]}
        self.groups: Dict[str, Any] = dict(groups)
        self.world = data * model

    def __repr__(self) -> str:
        return (f"ProcessMesh(data={self.shape[DATA_AXIS]}, model="
                f"{self.shape[MODEL_AXIS]}, at {self.index})")


def _device(d: Union[str, torch.device]) -> torch.device:
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(spec: Optional[MeshSpec] = None,
              devices: Optional[Sequence[Union[str, torch.device]]] = None) -> Mesh:
    """A ``(data, model)`` mesh over ``devices`` (every visible CUDA device
    when None; a list may repeat a device)."""
    spec = spec or MeshSpec()
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = [_device(d) for d in devices]
    data, model = spec.resolve(len(devs))
    if data < 1:
        raise ValueError(f"MeshSpec(data={spec.data}, model={model}) needs at least "
                         f"{model} devices, have {len(devs)}")
    return Mesh([devs[r * model:(r + 1) * model] for r in range(data)])


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def local_batch_slice(global_batch: int, world: int, rank: int) -> slice:
    """The rows of a global batch that rank ``rank`` of ``world`` holds; the
    batch must divide evenly (``make_batch_sharding_fn`` pads it first)."""
    if global_batch % world:
        raise ValueError(
            f"global batch {global_batch} not divisible by data axis {world}")
    per = global_batch // world
    return slice(rank * per, (rank + 1) * per)


def batch_sharding(world: int, rank: int) -> Callable[[Any], Any]:
    """The sharding of an array whose leading axis is the global batch: a
    function that keeps this rank's rows of it."""

    def shard(x):
        return x[local_batch_slice(len(x), world, rank)]

    return shard


def shard_batch(batch: Mapping[str, Any] | Any, world: int, rank: int):
    """This rank's rows of every array leaf (dicts are walked)."""
    shard = batch_sharding(world, rank)

    def walk(x):
        if isinstance(x, Mapping):
            return {k: walk(v) for k, v in x.items()}
        return shard(x)

    return walk(batch)
