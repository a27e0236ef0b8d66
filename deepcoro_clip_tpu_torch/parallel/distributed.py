"""Data and sequence parallelism over a ``torch.distributed`` process group,
one rank a card.

The JAX package runs one program over a ``("data", "model")`` mesh: the
global batch is sharded over ``data``, the token axis of the ring
attention over ``model``, and XLA inserts the collectives. The port runs
one process a rank instead, launched by ``torch.distributed.run``, and
arranges the ranks as the same grid (``init_grid``, ``mesh.ProcessMesh``):
with ``mesh_model = M`` rank ``r`` is cell ``(r // M, r % M)`` of a
``(world / M, M)`` grid, and each rank is one device of the JAX mesh (not
one of its hosts). A rank holds the rows of the global batch that its data
index ``r // M`` holds (``batch_size / (world / M)`` of them); the ranks of
one model group hold the same rows and every activation outside the ring
attention replicated, and each takes its chunk of the tokens in the ring
(``parallel/ring_attention.py``). Without ``init_grid`` the grid is
``(world, 1)``: data parallelism alone.

The collectives of data parallelism go over this rank's data group (the
ranks of its model index), so that each row of the global batch counts once:

- ``gather_rows``: the differentiable all-gather of ``[b, ...]`` into
  ``[D*b, ...]`` (the reference's ``GatherLayer``). It writes the local
  rows into a zero buffer and all-reduces it, so it needs only
  ``all_reduce`` on every backend; its backward sums the incoming gradient
  over the data group (an all-reduce again) and keeps the local rows;
- ``all_reduce_sum``: the differentiable sum over the data group, backward
  the same sum: a loss that divides by a count (tokens under a caption
  mask, masked patches) sums numerator and count before it divides;
- ``all_reduce_grads``: the gradients of a step, flattened into one buffer,
  summed in one call over the data group and divided by its size. The
  model ranks of a data index hold the same bits of every gradient (the
  ring's gather and cut below make them so), so the average over the data
  group is the average over the grid, without summing equal copies.

The model group's two collectives serve the ring attention's cut of the
replicated q/k/v: ``take_chunk`` (forward: this rank's chunk of an axis;
backward: the chunks' gradients all-gathered, every model rank with the
whole) and ``gather_chunks`` (forward: the all-gather of every rank's chunk
into zeros by an all-reduce; backward: this rank's chunk of the gradient,
summed with nothing).

Tensor parallelism (``models/layers.py``: a Dense cut over the model
axis) has the two conjugate collectives of Megatron-style layers, over the
model group: ``copy_to_model`` (forward: the identity; backward: the
gradient summed over the group) before every column-parallel product, and
``reduce_from_model`` (forward: the partial products summed over the group,
in fp32 for the half types; backward: the identity) after every
row-parallel one. ``gather_shard`` all-gathers the parts of a cut tensor
into the whole (no gradient; checkpoints and whole trees). The gradient of
a cut parameter is this rank's part of the whole gradient, that of a
replicated one the whole gradient on every model rank, so
``all_reduce_grads`` stays an average over the data group alone.

Every rank so evaluates the same global loss; the backward of each data
collective hands each rank ``D`` times the gradient of its own rows, and
the average over the data group is the gradient of the global loss. Terms
on replicated inputs (the temperature, the SigLIP bank) get the same
gradient on every rank, which the average keeps.

Without a process group (or with one rank) every function here is the
identity and a run is the one-process run.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from deepcoro_clip_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, ProcessMesh
from deepcoro_clip_tpu_torch.train.state import Split, join_shards

_GRID: Optional[ProcessMesh] = None  # the process grid of the running group


def is_active() -> bool:
    """A process group of more than one rank is running."""
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def rank_seed(seed: int, rank_: int) -> int:
    """The seed of a data index's own generator (dropout masks): ``seed``
    at index 0, as in a one-process run, and apart from every other
    index's. The model ranks of one data index share it: their activations
    are replicated, so they draw the same masks."""
    return int(seed) + (int(rank_) << 32)


def init_grid(model: int = 1) -> ProcessMesh:
    """Arrange the running group's ranks as a ``(world / model, model)``
    grid and make it the grid of the collectives here; returns it. Every
    rank must call it, in the same order, with the same ``model``
    (``dist.new_group`` is collective): one model group per data index and
    one data group per model index, beside the world group (used where a
    line is the whole world; a line of one rank has no group). Without a
    group, one rank: the grid ``(1, 1)``. Asking again for the grid in place
    returns it."""
    global _GRID
    world, r = world_size(), rank()
    model = max(1, int(model))
    if world % model:
        raise ValueError(f"mesh_model={model} does not divide the {world} ranks of the "
                         f"process group")
    if _GRID is not None and _GRID.world == world and _GRID.shape[MODEL_AXIS] == model:
        return _GRID
    data = world // model
    d, m = divmod(r, model)
    groups: Dict[str, object] = {DATA_AXIS: None, MODEL_AXIS: None}
    for axis, n_lines, size, line, mine in (
            (MODEL_AXIS, data, model, lambda i: [i * model + j for j in range(model)], d),
            (DATA_AXIS, model, data, lambda j: [i * model + j for i in range(data)], m)):
        if size == world and world > 1:
            groups[axis] = dist.group.WORLD
        elif size > 1:
            for i in range(n_lines):  # every rank makes every group
                g = dist.new_group(line(i))
                if i == mine:
                    groups[axis] = g
    _GRID = ProcessMesh(data, model, r, groups)
    if r == 0 and model > 1:
        print(f"[deepcoro_clip_tpu_torch] process grid: data {data} x model {model} "
              f"(rank r is cell (r // {model}, r % {model}))", flush=True)
    return _GRID


def tensor_parallel_grid(mesh_model: int, ring: bool = False) -> Optional[ProcessMesh]:
    """The grid whose model axis the attention and MLP layers are cut over
    (``models/layers.shard_layers``): ``init_grid(mesh_model)`` for a
    ``mesh_model`` above 1 without the ring, else None (the ring keeps
    every Dense whole)."""
    if int(mesh_model) <= 1 or ring:
        return None
    return init_grid(mesh_model)


def grid() -> ProcessMesh:
    """The grid of the running group: ``init_grid``'s, else ``(world, 1)``."""
    if _GRID is not None and _GRID.world == world_size():
        return _GRID
    return init_grid(1)


def data_size() -> int:
    """The data axis of the grid: the ranks that hold different rows."""
    return grid().shape[DATA_AXIS]


def data_rank() -> int:
    """This rank's data index: which rows of a global batch it holds."""
    return grid().index[DATA_AXIS]


def _backend_for(device: Optional[str], local_world: int) -> Tuple[str, str]:
    """(backend, topology) for this node's ranks: NCCL with one rank a card;
    gloo where ranks share a card (NCCL refuses two ranks on one device)
    and on the CPU."""
    if device == "cpu":
        return "gloo", f"{local_world} ranks on the CPU"
    n = torch.cuda.device_count()
    if local_world <= n:
        return "nccl", f"{local_world} ranks on {n} cards, one a card"
    return "gloo", f"{local_world} ranks sharing {n} card(s)"


def init_from_env(device: Optional[str] = None, init_method: str = "env://"
                  ) -> Tuple[int, int, torch.device]:
    """Start the process group ``torch.distributed.run`` describes in
    ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` (``LOCAL_WORLD_SIZE``: the
    ranks of this node); returns ``(rank, world size, device)``.

    ``device`` is the config's: None for the card, ``"cpu"`` for the CPU.
    Without ``WORLD_SIZE``, or with one rank, nothing is started. On the
    card rank r takes ``cuda:LOCAL_RANK`` (modulo the visible cards when the
    ranks outnumber them) and the backend follows the topology; the choice
    is printed on rank 0. A group that is already running is returned as
    it is."""
    from deepcoro_clip_tpu_torch.device import resolve_device

    running = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if running else int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1 and not running:
        # (the device is checked where the run first uses it, as without a group)
        return 0, 1, torch.device("cpu" if device == "cpu" else "cuda")
    dev = resolve_device(device)
    if running:
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
        return dist.get_rank(), world, dev
    rank_ = int(os.environ["RANK"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank_))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    backend, topology = _backend_for("cpu" if dev.type == "cpu" else None, local_world)
    if dev.type == "cuda":
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
        dev = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group(backend, init_method=init_method, rank=rank_,
                            world_size=world)
    if rank_ == 0:
        print(f"[deepcoro_clip_tpu_torch] data parallel: world {world}, backend "
              f"{backend}, {topology}", flush=True)
    return rank_, world, dev


def shutdown() -> None:
    """Tear the process group down, where one runs, and forget its grid."""
    global _GRID
    _GRID = None
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def barrier() -> None:
    if is_active():
        dist.barrier()


def _wide(dtype: torch.dtype) -> torch.dtype:
    """The dtype a collective sums in: fp32 for the half types (exact for
    the gather, whose other summands are zeros)."""
    return torch.float32 if dtype in (torch.bfloat16, torch.float16) else dtype


def _axis(axis: str) -> Tuple[object, int, int]:
    """(group, size, this rank's index) of the grid's ``axis``."""
    g = grid()
    return g.groups[axis], g.shape[axis], g.index[axis]


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis):
        group, n, i = _axis(axis)
        b = x.shape[dim]
        ctx.rows, ctx.dim, ctx.axis = (i * b, b), dim, axis
        shape = list(x.shape)
        shape[dim] = n * b
        out = x.new_zeros(shape, dtype=_wide(x.dtype))
        out.narrow(dim, i * b, b).copy_(x)
        dist.all_reduce(out, group=group)
        return out.to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        start, b = ctx.rows
        dtype = grad.dtype
        if ctx.axis == DATA_AXIS:  # the rows' gradient, summed over the group
            grad = grad.to(_wide(dtype), copy=True).contiguous()
            dist.all_reduce(grad, group=_axis(ctx.axis)[0])
        # (on the model axis every rank holds the whole gradient of the
        # replicated output: this rank's chunk is its part, summed with nothing)
        part = grad.narrow(ctx.dim, start, b)
        return part.to(dtype, memory_format=torch.contiguous_format, copy=True), None, None


class _TakeChunk(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim):
        _, n, i = _axis(MODEL_AXIS)
        c = x.shape[dim] // n
        ctx.dim = dim
        return x.narrow(dim, i * c, c).clone(memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, grad):
        return _GatherRows.apply(grad.contiguous(), ctx.dim, MODEL_AXIS), None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        out = x.detach().clone()
        dist.all_reduce(out, group=_axis(DATA_AXIS)[0])
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=_axis(DATA_AXIS)[0])
        return grad


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        dtype = grad.dtype
        grad = grad.to(_wide(dtype), memory_format=torch.contiguous_format, copy=True)
        dist.all_reduce(grad, group=_axis(MODEL_AXIS)[0])
        return grad.to(dtype)


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.dtype = x.dtype
        out = x.to(_wide(x.dtype), memory_format=torch.contiguous_format, copy=True)
        dist.all_reduce(out, group=_axis(MODEL_AXIS)[0])
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad.to(ctx.dtype)


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """``x``, replicated over the model group, as the input of a
    column-parallel product: the backward sums its gradient over the group
    (each rank's product reaches only its part of the columns)."""
    if grid().shape[MODEL_AXIS] == 1:
        return x
    return _CopyToModel.apply(x)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """The sum over the model group of the partial products ``x`` of a
    row-parallel product, on every rank, in fp32 for the half types (``M``
    bf16 partials are not summed in bf16); the backward hands each rank the
    whole gradient."""
    if grid().shape[MODEL_AXIS] == 1:
        return x.to(_wide(x.dtype))
    return _ReduceFromModel.apply(x)


@torch.no_grad()
def sum_over_model(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the model group, on every rank (no gradient)."""
    group, n, _ = _axis(MODEL_AXIS)
    if n == 1:
        return x
    out = x.detach().clone()
    dist.all_reduce(out, group=group)
    return out


@torch.no_grad()
def share_over_model(batch: Dict[str, object]) -> Dict[str, object]:
    """``batch`` (tensors, and dicts of them) as the first rank of the model
    group holds it, on every rank of the group, in place: the ranks of a
    model group compute on the same rows, and host data that a process
    draws in an order of its own (Python's string hashing orders the SigLIP
    sampler's sets) must not make them differ. One broadcast a tensor, of
    its bytes; other values stay as each rank has them."""
    group, n, _ = _axis(MODEL_AXIS)
    if n == 1:
        return batch
    src = grid().ranks[MODEL_AXIS][0]
    for v in batch.values():
        for t in (v.values() if isinstance(v, dict) else (v,)):
            if isinstance(t, torch.Tensor):
                dist.broadcast(t.view(-1).view(torch.uint8), src=src, group=group)
    return batch


@torch.no_grad()
def gather_shard(t: torch.Tensor, split: Split) -> torch.Tensor:
    """The whole tensor from every model rank's part ``t`` of it (cut by
    ``split``, ``state.take_shard``); collective over the model group."""
    group, n, _ = _axis(MODEL_AXIS)
    if n == 1:
        return t
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return join_shards(parts, split)


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """``[b, ...]`` of every data index -> ``[D*b, ...]`` in data order, on
    every rank (every rank holds the same ``b``); differentiable."""
    if data_size() == 1:
        return x
    return _GatherRows.apply(x, 0, DATA_AXIS)


def take_chunk(x: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's chunk of axis ``dim`` of ``x``, replicated over the model
    group (chunk ``m`` of ``M`` equal ones); the backward all-gathers the
    chunks' gradients, so every model rank holds the gradient of the whole
    ``x``, bit for bit the same."""
    if grid().shape[MODEL_AXIS] == 1:
        return x
    return _TakeChunk.apply(x, dim)


def gather_chunks(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Every model rank's chunk of axis ``dim``, concatenated in model order
    on every rank (zeros and one all-reduce: exact); the backward keeps this
    rank's chunk of the gradient and sums nothing."""
    if grid().shape[MODEL_AXIS] == 1:
        return x
    return _GatherRows.apply(x, dim, MODEL_AXIS)


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the data group, on every rank; differentiable."""
    if data_size() == 1:
        return x
    return _AllReduceSum.apply(x)


def global_ratio(num: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """``sum(num) / max(sum(count), 1)`` over the data group: a masked mean
    of the global batch from each rank's sums, in one all-reduce."""
    if data_size() == 1:
        return num / count.clamp_min(1.0)
    s = all_reduce_sum(torch.stack([num.float(), count.float().detach()]))
    return s[0] / s[1].clamp_min(1.0)


def all_reduce_grads(grads: Dict[str, torch.Tensor]) -> None:
    """Average ``grads`` over the data group in place: one all-reduce over
    the flattened gradients (one bucket a dtype), then a division by the
    group's size. Every rank ends with the same bits."""
    group, n, _ = _axis(DATA_AXIS)
    if n == 1:
        return
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for g in grads.values():
        by_dtype.setdefault(g.dtype, []).append(g)
    for tensors in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat, group=group)
        flat.div_(n)
        offset = 0
        for t in tensors:
            k = t.numel()
            t.copy_(flat[offset:offset + k].view_as(t))
            offset += k
