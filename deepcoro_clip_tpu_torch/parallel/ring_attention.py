"""Ring attention: exact attention with the token axis sharded over a mesh axis.

Port of the JAX package's ``parallel/ring_attention.py``. The token axis
of ``[B, H, L, Dh]`` is cut into n equal chunks, n the size of the mesh
axis; chunk i goes to the i-th device along it. Every shard keeps its
query chunk and passes its K/V chunk round the ring to its right
neighbour, folding each chunk it holds into its queries' online softmax;
after n steps each shard has seen every key. The outputs are gathered
back on q's device.

Backends, as in the JAX package:

- ``"xla"``: the port of ``_ring_body``, plain PyTorch: the local chunk is
  folded in first, then n - 1 rotations (``.to`` of each chunk to the next
  shard's device: the ``ppermute``). Autograd differentiates it; the model
  calls it. It keeps the JAX rounding points: scores in fp32 times the
  scale, ``p = exp(s - m_new)`` in fp32, ``p`` cast to v's type for the
  ``p @ v`` product summed in fp32, ``acc / max(l, 1e-30)`` cast to q's type.
- ``"rdma"``: the forward is K6. On CUDA tensors it runs the hand-written
  kernel (``csrc/ring_attention.cu`` through ``ops/_ring_cuda.ring_fwd``):
  two K/V slots per shard, the copy of slot ``cur`` into the right
  neighbour's slot ``nxt`` enqueued before the step's kernel, CUDA events in
  place of the TPU kernel's semaphores. On CPU tensors it runs K6's plain
  version, ``ring_rdma_plain``: the same slot protocol with the per-step
  update in torch. The backward re-runs the ``"xla"`` ring and returns its
  gradients, as the JAX ``custom_vjp`` does; K6 has no backward kernel.
- ``"rdma_interpret"``: K6's plain version on any device (the JAX name of
  the kernel under the Pallas interpreter).

``ring_attention.launches`` counts the K6 kernel launches (n x n a call:
one per shard per ring step).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from deepcoro_clip_tpu_torch.ops import _ring_cuda
from deepcoro_clip_tpu_torch.ops.attention import _acc_dtype
from deepcoro_clip_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh

BACKENDS = ("xla", "rdma", "rdma_interpret")
State = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def ring_update(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                state: Optional[State], scale: float) -> State:
    """Fold one K/V chunk into the online softmax ``(m, l, acc)`` of ``q``
    (``None``: the empty state). The JAX ring's ``accumulate``."""
    acc_t = _acc_dtype(q.dtype)
    s = torch.matmul(q.to(acc_t), k.to(acc_t).transpose(-1, -2)) * scale
    if state is None:
        m = torch.full(q.shape[:-1] + (1,), float("-inf"), dtype=acc_t, device=q.device)
        l = torch.zeros(q.shape[:-1] + (1,), dtype=acc_t, device=q.device)
        acc = torch.zeros(q.shape, dtype=acc_t, device=q.device)
    else:
        m, l, acc = state
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    p = torch.exp(s - m_new)
    alpha = torch.exp(m - m_new)
    l = l * alpha + p.sum(dim=-1, keepdim=True)
    acc = acc * alpha + torch.matmul(p.to(v.dtype).to(acc_t), v.to(acc_t))
    return m_new, l, acc


def ring_finish(state: State, dtype: torch.dtype) -> torch.Tensor:
    _, l, acc = state
    return (acc / torch.clamp(l, min=1e-30)).to(dtype)


def ring_xla(qs: Sequence[torch.Tensor], ks: Sequence[torch.Tensor],
             vs: Sequence[torch.Tensor], scale: float) -> List[torch.Tensor]:
    """The ``"xla"`` ring over shards: ``qs[i]`` etc. are shard i's chunks
    on its device; returns each shard's output there. Differentiable."""
    n = len(qs)
    states = [ring_update(qs[i], ks[i], vs[i], None, scale) for i in range(n)]
    k_cur, v_cur = list(ks), list(vs)
    for _ in range(n - 1):
        # every shard passes its chunk to the right: shard i now holds its
        # left neighbour's
        k_cur = [k_cur[i - 1].to(qs[i].device) for i in range(n)]
        v_cur = [v_cur[i - 1].to(qs[i].device) for i in range(n)]
        states = [ring_update(qs[i], k_cur[i], v_cur[i], states[i], scale)
                  for i in range(n)]
    return [ring_finish(st, q.dtype) for st, q in zip(states, qs)]


def ring_rdma_plain(qs: Sequence[torch.Tensor], ks: Sequence[torch.Tensor],
                    vs: Sequence[torch.Tensor], scale: float) -> List[torch.Tensor]:
    """K6's plain version: the TPU kernel's protocol written out. Each shard
    has two K/V slots; slot 0 takes the local chunk; at step r every shard
    sends slot ``r % 2`` into its right neighbour's other slot and folds
    slot ``r % 2`` into its state (``ring_update``)."""
    n = len(qs)
    slots = [[(ks[i].clone(), vs[i].clone()), None] for i in range(n)]
    states: List[Optional[State]] = [None] * n
    for r in range(n):
        cur, nxt = r % 2, (r + 1) % 2
        if r < n - 1:
            for i in range(n):
                right = (i + 1) % n
                dev = qs[right].device
                slots[right][nxt] = tuple(t.to(dev, copy=True) for t in slots[i][cur])
        for i in range(n):
            states[i] = ring_update(qs[i], *slots[i][cur], states[i], scale)
    return [ring_finish(st, q.dtype) for st, q in zip(states, qs)]


def _shard(t: torch.Tensor, devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """Chunk i of the token axis onto ``devices[i]`` (a view where the
    device is t's own)."""
    n = len(devices)
    Lc = t.shape[2] // n
    return [t[:, :, i * Lc:(i + 1) * Lc].to(d) for i, d in enumerate(devices)]


def _gather(outs: Sequence[torch.Tensor], device: torch.device) -> torch.Tensor:
    return torch.cat([o.to(device) for o in outs], dim=2)


def _xla(q, k, v, devices, scale) -> torch.Tensor:
    return _gather(ring_xla(_shard(q, devices), _shard(k, devices),
                            _shard(v, devices), scale), q.device)


def _rdma_forward(q, k, v, devices, scale, plain: bool) -> torch.Tensor:
    qs, ks, vs = _shard(q, devices), _shard(k, devices), _shard(v, devices)
    if plain or devices[0].type == "cpu":
        return _gather(ring_rdma_plain(qs, ks, vs, scale), q.device)
    # K6 writes the outputs of shards on q's device straight into the result
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    views = _shard(out, [q.device] * len(devices))
    outs = [view if d == q.device else torch.empty_like(view, device=d)
            for view, d in zip(views, devices)]
    _ring_cuda.ring_fwd(qs, ks, vs, outs, scale, counter=ring_attention)
    for view, o in zip(views, outs):
        if o.device != q.device:
            view.copy_(o)
    return out


class _RdmaRing(torch.autograd.Function):
    """K6 forward; the gradients of the ``"xla"`` ring (the JAX custom_vjp)."""

    @staticmethod
    def forward(ctx, q, k, v, devices, scale, plain):
        ctx.save_for_backward(q, k, v)
        ctx.args = (devices, scale)
        return _rdma_forward(q, k, v, devices, scale, plain)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v = ctx.saved_tensors
        devices, scale = ctx.args
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            out = _xla(*leaves, devices, scale)
            grads = torch.autograd.grad(out, leaves, grad_out)
        return grads + (None, None, None)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh: Mesh,
                   axis: str = MODEL_AXIS, scale: Optional[float] = None,
                   backend: str = "xla") -> torch.Tensor:
    """Exact attention with the token axis sharded over ``mesh``'s ``axis``.

    q/k/v: ``[B, H, L, Dh]`` with L divisible by the axis size; returns
    ``[B, H, L, Dh]`` on q's device in q's dtype. Numerically the plain
    attention of ``ops/attention.py`` (the online softmax is exact).

    ``backend="rdma"`` on CUDA takes bf16 operands with Dh 64 or 128 and
    raises on anything else; it never falls back to the plain version."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown ring attention backend {backend!r}")
    devices = mesh.devices_along(axis)
    n = len(devices)
    if q.shape[2] % n:
        raise ValueError(f"ring attention: the token count {q.shape[2]} does not "
                         f"divide by the {axis!r} axis size {n}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"ring attention is self-attention: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if len({d.type for d in devices}) != 1:
        raise ValueError(f"the ring's devices mix types: {devices}")
    scale_v = float(scale if scale is not None else q.shape[-1] ** -0.5)
    if backend == "xla":
        return _xla(q, k, v, devices, scale_v)
    return _RdmaRing.apply(q, k, v, tuple(devices), scale_v, backend == "rdma_interpret")


# K6 kernel launches, for checks that the path ran them
ring_attention.launches = 0
