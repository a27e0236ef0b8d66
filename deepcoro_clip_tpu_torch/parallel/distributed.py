"""Data parallelism over a ``torch.distributed`` process group, one rank a card.

The JAX package runs one program over a ``("data", "model")`` mesh: the
global batch is sharded over ``data`` and XLA inserts the collectives. The
port runs one process a rank instead, launched by ``torch.distributed.run``;
each rank is one device of the JAX run's data axis (not one of its hosts),
holds ``batch_size / world`` rows of every global batch and computes the
loss of the whole batch through the collectives below:

- ``gather_rows``: the differentiable all-gather of ``[b, ...]`` into
  ``[world*b, ...]`` (the reference's ``GatherLayer``). It writes the local
  rows into a zero buffer and all-reduces it, so it needs only
  ``all_reduce`` on every backend; its backward sums the incoming gradient
  over the ranks (an all-reduce again) and keeps the local rows;
- ``all_reduce_sum``: the differentiable sum over the ranks, backward the
  same sum: a loss that divides by a count (tokens under a caption mask,
  masked patches) sums numerator and count over the ranks before it divides;
- ``all_reduce_grads``: the gradients of a step, flattened into one buffer,
  summed in one call and divided by the world size.

Every rank so evaluates the same global loss; the backward of each
collective hands each rank ``world`` times the gradient of its own rows, and
the average over the ranks is the gradient of the global loss. Terms on
replicated inputs (the temperature, the SigLIP bank) get the same gradient
on every rank, which the average keeps.

Without a process group (or with one rank) every function here is the
identity and a run is the one-process run.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist


def is_active() -> bool:
    """A process group of more than one rank is running."""
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def rank_seed(seed: int, rank_: int) -> int:
    """The seed of a rank's own generator (dropout masks): ``seed`` on rank
    0, as in a one-process run, and apart from every other rank's."""
    return int(seed) + (int(rank_) << 32)


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
    """Tear the process group down, where one runs."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def barrier() -> None:
    if is_active():
        dist.barrier()


def _wide(dtype: torch.dtype) -> torch.dtype:
    """The dtype a collective sums in: fp32 for the half types (exact for
    the gather, whose other summands are zeros)."""
    return torch.float32 if dtype in (torch.bfloat16, torch.float16) else dtype


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        world, r = dist.get_world_size(), dist.get_rank()
        b = x.shape[0]
        ctx.rows = (r * b, (r + 1) * b)
        out = x.new_zeros((world * b,) + tuple(x.shape[1:]), dtype=_wide(x.dtype))
        out[r * b:(r + 1) * b] = x
        dist.all_reduce(out)
        return out.to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        full = grad.to(_wide(grad.dtype), copy=True).contiguous()
        dist.all_reduce(full)
        lo, hi = ctx.rows
        return full[lo:hi].to(grad.dtype)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        out = x.detach().clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad)
        return grad


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """``[b, ...]`` of every rank -> ``[world*b, ...]`` in rank order, on
    every rank (every rank holds the same ``b``); differentiable."""
    if not is_active():
        return x
    return _GatherRows.apply(x)


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks, on every rank; differentiable."""
    if not is_active():
        return x
    return _AllReduceSum.apply(x)


def global_ratio(num: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """``sum(num) / max(sum(count), 1)`` over the ranks: a masked mean of the
    global batch from each rank's sums, in one all-reduce."""
    if not is_active():
        return num / count.clamp_min(1.0)
    s = all_reduce_sum(torch.stack([num.float(), count.float().detach()]))
    return s[0] / s[1].clamp_min(1.0)


def all_reduce_grads(grads: Dict[str, torch.Tensor]) -> None:
    """Average ``grads`` over the ranks in place: one all-reduce over the
    flattened gradients (one bucket a dtype), then a division by the world
    size. Every rank ends with the same bits."""
    if not is_active():
        return
    world = dist.get_world_size()
    by_dtype: Dict[torch.dtype, list] = {}
    for g in grads.values():
        by_dtype.setdefault(g.dtype, []).append(g)
    for tensors in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat)
        flat.div_(world)
        offset = 0
        for t in tensors:
            n = t.numel()
            t.copy_(flat[offset:offset + n].view_as(t))
            offset += n
