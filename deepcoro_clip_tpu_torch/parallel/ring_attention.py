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

Over a ``ProcessMesh`` (``parallel/mesh.py``: the ranks of a process
group, one program each) the shards are the ranks of this rank's group
along ``axis``: ``ring_attention`` takes this rank's ``[B, H, Lc, Dh]``
chunk of q, k and v and returns its output chunk. The chunks travel over
the group by point-to-point messages (``_Link``: a send to the right and a
receive from the left posted together, ``dist.batch_isend_irecv``, so no
ring of any size deadlocks):

- ``"xla"``: the same updates as ``ring_xla``, one shard a rank, the
  exchange standing for the ``.to``. Autograd does not go through
  ``send``/``recv``, so it is an ``autograd.Function``: the forward keeps
  the row statistics; the backward passes the K/V chunks the other way
  round the ring, each with its dK/dV accumulator, every rank adding its
  queries' part to the chunk it holds (the transpose of the JAX
  ``ppermute``, which ``jax.vjp`` of ``_ring_body`` computes); after n
  steps each accumulator is back with its chunk's rank.
- ``"rdma"``: the forward is K6 on CUDA tensors, one rank's pass
  (``_ring_cuda.ring_fwd_rank``: two slots and the state on the rank's
  card, each exchange posted before the step kernel that reads the slot
  it sends); on CPU tensors K6's plain version, the same slot protocol with
  the update in torch. The backward is the ``"xla"`` ring's, from the
  statistics of an ``"xla"`` forward, as the JAX ``custom_vjp`` does.
- ``"rdma_interpret"``: K6's plain version on any device.

NCCL carries the card's tensors where each rank of the group has a card of
its own. Where ranks share a card the group runs on gloo, whose
point-to-point calls take host tensors: the chunk goes through pinned host
memory there (a copy off the card, the message, a copy onto it). That is
the transport; the step kernel still runs on the card on every rank.

``ring_attention.launches`` counts the K6 kernel launches (n x n a call
in one process: one per shard per ring step; n a call on each rank of a
process group).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from deepcoro_clip_tpu_torch.ops import _ring_cuda
from deepcoro_clip_tpu_torch.ops.attention import _acc_dtype
from deepcoro_clip_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh, ProcessMesh

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


# --------------------------------------------------------------------------- #
# the ring across the ranks of a process group


def _pack(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """The tensors' bytes, one after another, in one uint8 buffer."""
    return torch.cat([t.contiguous().reshape(-1).view(torch.uint8) for t in tensors])


def _unpack(flat: torch.Tensor, like: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    out, offset = [], 0
    for t in like:
        n = t.numel() * t.element_size()
        out.append(flat[offset:offset + n].view(t.dtype).view(t.shape))
        offset += n
    return out


class _Link:
    """This rank's place on the ring of its group along one axis of a
    ``ProcessMesh``: the rank it sends to and the rank it receives from
    (``reverse``: the other way round). Under gloo a card's tensors go
    through host memory: pinned buffers, kept by the link, for K6's slots."""

    def __init__(self, mesh: ProcessMesh, axis: str, reverse: bool = False):
        n, i = mesh.shape[axis], mesh.index[axis]
        ranks = mesh.ranks[axis]
        step = -1 if reverse else 1
        self.group = mesh.groups[axis]
        self.dst, self.src = ranks[(i + step) % n], ranks[(i - step) % n]
        self.gloo = dist.get_backend(self.group) == "gloo"
        self._host: dict = {}

    def _host_buffers(self, like: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        key = (like.numel(), like.dtype)
        if key not in self._host:
            self._host[key] = tuple(torch.empty(like.shape, dtype=like.dtype,
                                                pin_memory=True) for _ in range(2))
        return self._host[key]

    def _start(self, send: torch.Tensor, recv: torch.Tensor):
        return dist.batch_isend_irecv([
            dist.P2POp(dist.isend, send, self.dst, self.group),
            dist.P2POp(dist.irecv, recv, self.src, self.group)])

    def shift(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Send ``tensors`` to the right and return the left neighbour's
        (same shapes and dtypes); blocks until they are here."""
        flat = _pack(tensors)
        staged = self.gloo and flat.is_cuda
        send = flat.cpu() if staged else flat
        recv = torch.empty_like(send)
        for work in self._start(send, recv):
            work.wait()
        if staged:
            recv = recv.to(flat.device)
        return _unpack(recv, tensors)

    def post(self, send: torch.Tensor, recv: torch.Tensor, free, stream) -> "_Posted":
        """K6's exchange (``_ring_cuda.ring_fwd_rank``): ``send`` to the right
        and the left neighbour's into ``recv`` (card tensors), behind
        ``stream``'s work; the write into ``recv`` waits for the event
        ``free``."""
        if not self.gloo:
            if free is not None:
                stream.wait_event(free)
            with torch.cuda.stream(stream):
                return _Posted(self._start(send, recv), stream)
        host_send, host_recv = self._host_buffers(send)
        with torch.cuda.stream(stream):
            host_send.copy_(send, non_blocking=True)
        stream.synchronize()  # (the copy off the card; earlier copies onto it too)
        return _Posted(self._start(host_send, host_recv), stream, host_recv, recv, free)


class _Posted:
    """An exchange in flight: ``finish()`` returns a CUDA event recorded on
    the side stream once the chunk is in its slot."""

    def __init__(self, works, stream, host=None, slot=None, free=None):
        self.works, self.stream = works, stream
        self.host, self.slot, self.free = host, slot, free

    def finish(self):
        with torch.cuda.stream(self.stream):
            for work in self.works:  # (NCCL: the stream waits; gloo: the host)
                work.wait()
            if self.host is not None:
                if self.free is not None:
                    self.stream.wait_event(self.free)
                self.slot.copy_(self.host, non_blocking=True)
            return self.stream.record_event()


def _process_stats(q, k, v, link: _Link, n: int, scale: float) -> State:
    """The ``"xla"`` forward on this rank: ``ring_update`` over its own chunk,
    then over each chunk from the left, as ``ring_xla`` does a shard."""
    state = ring_update(q, k, v, None, scale)
    k_cur, v_cur = k, v
    for _ in range(n - 1):
        k_cur, v_cur = link.shift([k_cur, v_cur])
        state = ring_update(q, k_cur, v_cur, state, scale)
    return state


def _process_grads(q, k, v, do, state: State, back: _Link, n: int, scale: float):
    """dq, dk, dv of this rank's chunk from the forward's row statistics:
    the K/V chunks go round the ring the other way with their dK/dV
    accumulators (in the statistics' dtype), and each rank adds its
    queries' part: ``P = exp(s - m) / l``, ``dV += P^T dO``, ``dS = P (dO
    V^T - rowsum(dO * O))``, ``dQ += dS K``, ``dK += dS^T Q`` (times the
    scale)."""
    m, l, acc = state
    acc_t = acc.dtype
    q32, do32 = q.to(acc_t), do.to(acc_t)
    o32 = acc / torch.clamp(l, min=1e-30)
    delta = (do32 * o32).sum(dim=-1, keepdim=True)
    inv_l = 1.0 / torch.clamp(l, min=1e-30)
    dq = torch.zeros_like(q32)
    k_cur, v_cur = k, v
    dk, dv = torch.zeros_like(q32), torch.zeros_like(q32)
    for s in range(n):
        if s > 0:
            k_cur, v_cur, dk, dv = back.shift([k_cur, v_cur, dk, dv])
        k32, v32 = k_cur.to(acc_t), v_cur.to(acc_t)
        p = torch.exp(torch.matmul(q32, k32.transpose(-1, -2)) * scale - m) * inv_l
        dv = dv + torch.matmul(p.transpose(-1, -2), do32)
        ds = p * (torch.matmul(do32, v32.transpose(-1, -2)) - delta)
        dq = dq + torch.matmul(ds, k32) * scale
        dk = dk + torch.matmul(ds.transpose(-1, -2), q32) * scale
    if n > 1:  # each accumulator home to its chunk's rank
        dk, dv = back.shift([dk, dv])
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _process_rdma(q, k, v, mesh: ProcessMesh, axis: str, scale: float,
                  plain: bool) -> torch.Tensor:
    """K6 forward on this rank's chunk: the kernel's pass on CUDA tensors,
    its plain version (the slot protocol in torch) on the CPU or with
    ``plain``."""
    n = mesh.shape[axis]
    link = _Link(mesh, axis)
    if not plain and q.is_cuda:
        out = torch.empty_like(q, memory_format=torch.contiguous_format)
        _ring_cuda.ring_fwd_rank(q, k, v, out, scale, n, link, counter=ring_attention)
        return out
    slots: List[Optional[Tuple[torch.Tensor, torch.Tensor]]] = [(k.clone(), v.clone()),
                                                                None]
    state: Optional[State] = None
    for r in range(n):
        cur, nxt = r % 2, (r + 1) % 2
        if r < n - 1:
            slots[nxt] = tuple(link.shift(slots[cur]))
        state = ring_update(q, *slots[cur], state, scale)
    return ring_finish(state, q.dtype)


class _ProcessRing(torch.autograd.Function):
    """The ring over a process group on this rank's chunk: ``"xla"`` or K6
    forward, the ``"xla"`` ring's backward."""

    @staticmethod
    def forward(ctx, q, k, v, mesh, axis, scale, backend):
        n = mesh.shape[axis]
        if backend == "xla":
            state = _process_stats(q, k, v, _Link(mesh, axis), n, scale)
            out = ring_finish(state, q.dtype)
            ctx.save_for_backward(q, k, v, *state)
        else:
            out = _process_rdma(q, k, v, mesh, axis, scale, backend == "rdma_interpret")
            ctx.save_for_backward(q, k, v)
        ctx.args = (mesh, axis, scale)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, *state = ctx.saved_tensors
        mesh, axis, scale = ctx.args
        n = mesh.shape[axis]
        if not state:  # (K6 keeps no statistics: the "xla" forward's)
            state = _process_stats(q, k, v, _Link(mesh, axis), n, scale)
        grads = _process_grads(q, k, v, grad_out, tuple(state),
                               _Link(mesh, axis, reverse=True), n, scale)
        return grads + (None, None, None, None)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh: Union[Mesh, ProcessMesh], axis: str = MODEL_AXIS,
                   scale: Optional[float] = None, backend: str = "xla") -> torch.Tensor:
    """Exact attention with the token axis sharded over ``mesh``'s ``axis``.

    On a ``Mesh`` (one process): q/k/v ``[B, H, L, Dh]`` with L divisible
    by the axis size; returns ``[B, H, L, Dh]`` on q's device in q's dtype.
    On a ``ProcessMesh``: this rank's chunk ``[B, H, Lc, Dh]`` of q, k and v
    (chunk i of the token axis on the i-th rank along ``axis``); returns
    this rank's output chunk; every rank of the axis's group must call it.
    Numerically the plain attention of ``ops/attention.py`` (the online
    softmax is exact).

    ``backend="rdma"`` on CUDA takes bf16 or fp32 operands at any Dh up to
    512 (a Dh no kernel takes is zero-padded to the next that one does and
    the output cut back, ``_flash_cuda.kernel_head_dim``) and raises on
    anything else; it never falls back to the plain version."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown ring attention backend {backend!r}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"ring attention is self-attention: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    scale_v = float(scale if scale is not None else q.shape[-1] ** -0.5)
    if isinstance(mesh, ProcessMesh):
        return _ProcessRing.apply(q, k, v, mesh, axis, scale_v, backend)
    devices = mesh.devices_along(axis)
    n = len(devices)
    if q.shape[2] % n:
        raise ValueError(f"ring attention: the token count {q.shape[2]} does not "
                         f"divide by the {axis!r} axis size {n}")
    if len({d.type for d in devices}) != 1:
        raise ValueError(f"the ring's devices mix types: {devices}")
    if backend == "xla":
        return _xla(q, k, v, devices, scale_v)
    return _RdmaRing.apply(q, k, v, tuple(devices), scale_v, backend == "rdma_interpret")


# K6 kernel launches, for checks that the path ran them
ring_attention.launches = 0
