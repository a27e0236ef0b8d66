"""ctypes launcher of the ring-attention kernel (K6), and the ring pass that drives it.

``csrc/ring_attention.cu`` holds the step kernel (one shard's queries over
the K/V chunk in one of its slots, from a carried online-softmax state) and
the slot copy. ``ring_fwd`` runs one whole ring pass of n shards with the
TPU kernel's protocol:

- every shard has two K/V slots on its device (``[2 slots, 2 (k|v), B, H,
  Lc, Dh]`` of the operands' type), its row state (``m``, ``l``: ``[B*H, Lc]``, ``acc``:
  ``[B*H, Lc, Dh]``, fp32) and a compute and a copy stream of its own, so
  that shards that share a card can overlap;
- slot 0 takes the shard's own chunk; at step r, shard i's copy stream
  copies slot ``r % 2`` into shard i+1's slot ``(r+1) % 2`` (a
  device-to-device copy on one card, a peer copy across cards) before
  shard i's step-r kernel is launched on its compute stream;
- CUDA events take the place of the semaphores: the copy into shard i+1's
  slot waits for shard i+1's step r-1 and its send of step r-1, which both
  read that slot (the backpressure of the TPU kernel's neighbour barrier);
  a step waits for the arrival of its chunk.

The streams start after, and the callers' streams of every device involved
wait for, all work of the pass, so the result is ordered like any other
operation on the current stream. The step takes bf16 or fp32 at the head
dims of ``HEAD_DIMS`` (64 to 512); any other Dh up to 512 is zero-padded to
the next of them before the pass (``kernel_head_dim``: RoPE, where a model
has it, is applied before the ring, so zero columns add nothing to q·k)
and the output is cut back; the scale is the caller's. fp16 and Dh above
512 raise. ``step_symbol`` names the kernel a step runs:
``ring_step_sm90_kernel`` (wgmma, TMA, mbarriers) in bf16 at 128, every
bf16 path of the repository, the ``mma.sync`` ``ring_step_kernel`` at 64,
the SIMT ``ring_step_wide_bf16_kernel`` at 256 to 512, and the SIMT
``ring_step_f32_kernel`` for fp32 at every width.
``peer_access`` records, per pair of cards, whether the copy goes card to
card.

``ring_fwd_rank`` is one rank's part of the same pass when the shards are
the ranks of a process group (``parallel/ring_attention.py`` drives it):
the rank's two slots and its ``(m, l, acc)`` state on its card, a compute
and a side stream; at step r the send of slot ``r % 2`` to the right
neighbour and the receive into slot ``(r+1) % 2`` from the left are posted
(by the caller's ``link``) before the step kernel is launched on slot
``r % 2``, and step r+1 waits for the arrival: the receive stands where the
TPU kernel waits on its semaphores, and the receive into a slot waits for
the step that last read it.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from deepcoro_clip_tpu_torch.ops._flash_cuda import HEAD_DIMS, _aligned, _c_fn, kernel_head_dim

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# (device, peer) -> True where the slot copy goes card to card
peer_access: Dict[Tuple[int, int], bool] = {}


_TYPES = (torch.bfloat16, torch.float32)


def step_symbol(dh: int, dtype: torch.dtype = torch.bfloat16) -> str:
    """The C entry of ``csrc/ring_attention.cu`` that runs a ring step at
    head dim ``dh`` (one of ``HEAD_DIMS``) on operands of ``dtype``: in
    bf16 the Hopper kernel at 128, the ``mma.sync`` one at 64, the SIMT one
    at 256 to 512; in fp32 the SIMT one."""
    if dtype not in _TYPES:
        raise TypeError(f"the CUDA ring kernels take bfloat16 or float32, got {dtype}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"the CUDA ring kernel takes Dh in {HEAD_DIMS}, got {dh}")
    if dtype == torch.float32:
        return "deepcoro_ring_step_f32"
    if dh > 128:
        return "deepcoro_ring_step_wide_bf16"
    return "deepcoro_ring_step_sm90_bf16" if dh == 128 else "deepcoro_ring_step_bf16"


def _step_fn(dh: int, dtype: torch.dtype):
    return _c_fn("ring_attention", step_symbol(dh, dtype),
                 [_P] * 7 + [_I] * 4 + [_LL] * 6 + [ctypes.c_float, _I, _I, _P])


def step_kernel_attrs() -> dict:
    """Registers per thread (at entry, before ``setmaxnreg``) and dynamic
    shared memory per block of ``ring_step_sm90_kernel``: what
    ``chip_smoke.py`` reports beside ptxas. Builds the library if need be."""
    regs, smem = ctypes.c_int(), ctypes.c_int()
    ip = ctypes.POINTER(ctypes.c_int)
    fn = _c_fn("ring_attention", "deepcoro_ring_step_sm90_attrs", [ip, ip])
    if fn(ctypes.byref(regs), ctypes.byref(smem)) != 0:
        raise RuntimeError("cudaFuncGetAttributes failed on the K6 kernel")
    return {"kernel": "ring_step_sm90_kernel", "registers": regs.value,
            "smem_bytes": smem.value, "consumers": 2, "setmaxnreg": True}


def _copy_fn():
    return _c_fn("ring_attention", "deepcoro_ring_copy", [_P, _I, _P, _I, _LL, _P])


def _peer_fn():
    return _c_fn("ring_attention", "deepcoro_ring_enable_peer", [_I, _I])


def _check(qs, ks, vs, outs) -> None:
    shape = qs[0].shape
    B, H, Lc, Dh = shape
    dtype = qs[0].dtype
    step_symbol(Dh, dtype)  # raises for what no kernel takes
    if Lc < 1 or B * H > 65535:
        raise ValueError(f"unsupported sizes B*H={B * H}, Lc={Lc}")
    for i, group in enumerate(zip(qs, ks, vs, outs)):
        dev = group[0].device
        if dev.type != "cuda":
            raise ValueError(f"the ring kernel needs CUDA tensors, shard {i} is on {dev}")
        for name, t in zip(("q", "k", "v", "out"), group):
            if t.device != dev or t.shape != shape:
                raise ValueError(f"shard {i}: {name} is {tuple(t.shape)} on {t.device}, "
                                 f"expected {tuple(shape)} on {dev}")
            if t.dtype != dtype:
                raise TypeError(f"the CUDA ring kernel takes one type, got {name} "
                                f"{t.dtype} beside q's {dtype}")
            if t.stride(-1) != 1:
                raise ValueError(f"shard {i}: {name}: the head dim must be contiguous")
        for name, t in (("q", group[0]), ("out", group[3])):
            if dtype == torch.bfloat16 and not _aligned(t):
                raise ValueError(f"shard {i}: {name} must allow 16-byte loads "
                                 f"(head dim contiguous, ptr % 16 == 0, strides % 8 == 0)")


def _pad_operands(qs, ks, vs, outs):
    """The operands at the head dim a kernel takes: ``(qs, ks, vs, outs,
    cut)``; where Dh is no kernel's, q, k and v zero-padded to
    ``kernel_head_dim`` and fresh padded outputs, with ``cut`` the callers'
    outputs to copy the first Dh columns into after the pass (None when
    nothing was padded)."""
    dh = qs[0].shape[-1]
    width = kernel_head_dim(dh)
    if width == dh:
        return qs, ks, vs, outs, None
    pad = [[F.pad(t, (0, width - dh)) for t in group] for group in (qs, ks, vs)]
    padded_outs = [torch.empty(o.shape[:-1] + (width,), dtype=o.dtype, device=o.device)
                   for o in outs]
    return (*pad, padded_outs, outs)


def _cut(padded_outs, outs) -> None:
    """The first Dh columns of each padded output into the caller's, on
    the current stream of the output's card."""
    for p, o in zip(padded_outs, outs):
        with torch.cuda.device(o.device):
            o.copy_(p[..., :o.shape[-1]])


def _enable_peer(src: int, dst: int) -> None:
    if (src, dst) in peer_access:
        return
    ok = torch.cuda.can_device_access_peer(src, dst) and _peer_fn()(src, dst) == 0
    peer_access[(src, dst)] = ok


def ring_fwd_rank(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                  scale: float, n: int, link, counter) -> None:
    """This rank's part of a ring pass over the ``n`` ranks of a process
    group: its queries ``q`` over every rank's K/V chunk, written into
    ``out`` (``[B, H, Lc, Dh]`` bf16 or fp32 on this rank's card; q and out
    with any batch/head/row strides; a Dh no kernel takes is padded, see
    the module's note). ``link.post(send, recv, free, stream)`` posts
    the exchange of slot ``send`` (to the right) and ``recv`` (from the
    left) behind ``stream``'s work, the receive's write behind the event
    ``free`` (None: nothing to wait for), and returns a handle whose
    ``finish()`` returns an event recorded once the chunk is in ``recv``.
    Launches the step kernel n times, counted on ``counter.launches``."""
    (q,), (k,), (v,), (out,), cut = _pad_operands([q], [k], [v], [out])
    _check([q], [k], [v], [out])
    B, H, Lc, Dh = q.shape
    dev = q.device
    step = _step_fn(Dh, q.dtype)
    caller = torch.cuda.current_stream(dev)
    comp, side = torch.cuda.Stream(dev), torch.cuda.Stream(dev)
    comp.wait_stream(caller)
    slots = torch.empty((2, 2, B, H, Lc, Dh), dtype=q.dtype, device=dev)
    m, l, acc = (None, None, None) if n == 1 else (
        torch.empty((B * H, Lc), dtype=torch.float32, device=dev),
        torch.empty((B * H, Lc), dtype=torch.float32, device=dev),
        torch.empty((B * H, Lc, Dh), dtype=torch.float32, device=dev))
    with torch.cuda.stream(comp):
        slots[0, 0].copy_(k)
        slots[0, 1].copy_(v)
    side.wait_stream(comp)  # slot 0 is filled
    handle, done = None, None
    for r in range(n):
        cur, nxt = r % 2, (r + 1) % 2
        if r > 0:  # the chunk of this step has arrived (on the side stream)
            comp.wait_event(handle.finish())
        if r < n - 1:
            handle = link.post(slots[cur], slots[nxt], done, side)
        with torch.cuda.device(dev):
            err = step(q.data_ptr(), slots[cur, 0].data_ptr(), slots[cur, 1].data_ptr(),
                       out.data_ptr(),
                       None if m is None else m.data_ptr(),
                       None if l is None else l.data_ptr(),
                       None if acc is None else acc.data_ptr(),
                       B, H, Lc, Dh, *q.stride()[:3], *out.stride()[:3],
                       float(scale), int(r == 0), int(r == n - 1), comp.cuda_stream)
        if err != 0:
            raise RuntimeError(f"ring attention step launch failed: CUDA error {err}")
        counter.launches += 1
        done = comp.record_event()  # step r has read slot cur
    caller.wait_stream(comp)
    caller.wait_stream(side)
    if cut is not None:
        _cut([out], cut)


def ring_fwd(qs: Sequence[torch.Tensor], ks: Sequence[torch.Tensor],
             vs: Sequence[torch.Tensor], outs: Sequence[torch.Tensor], scale: float,
             counter) -> None:
    """One ring pass: shard i's queries ``qs[i]`` over every shard's K/V
    chunk, written into ``outs[i]`` (all ``[B, H, Lc, Dh]`` bf16 or fp32 on
    shard i's device; q and out with any batch/head/row strides; a Dh no
    kernel takes is padded, see the module's note). Launches the step
    kernel n x n times, counted on ``counter.launches``."""
    qs, ks, vs, outs, cut = _pad_operands(qs, ks, vs, outs)
    _check(qs, ks, vs, outs)
    n = len(qs)
    B, H, Lc, Dh = qs[0].shape
    dtype = qs[0].dtype
    devs = [q.device for q in qs]
    step, copy = _step_fn(Dh, dtype), _copy_fn()
    for i in range(n):
        if devs[i] != devs[(i + 1) % n]:
            _enable_peer(devs[i].index, devs[(i + 1) % n].index)

    callers = {d: torch.cuda.current_stream(d) for d in devs}
    started = [s.record_event() for s in callers.values()]
    comp = [torch.cuda.Stream(d) for d in devs]
    side = [torch.cuda.Stream(d) for d in devs]
    for s in comp + side:
        for e in started:
            s.wait_event(e)
    # per shard: the slots, and the state a step hands to the next (none
    # for a ring of one, whose single step is first and last)
    slots, state = [], []
    for i, d in enumerate(devs):
        slots.append(torch.empty((2, 2, B, H, Lc, Dh), dtype=dtype, device=d))
        state.append((None, None, None) if n == 1 else (
            torch.empty((B * H, Lc), dtype=torch.float32, device=d),
            torch.empty((B * H, Lc), dtype=torch.float32, device=d),
            torch.empty((B * H, Lc, Dh), dtype=torch.float32, device=d)))
    slot_bytes = 2 * B * H * Lc * Dh * qs[0].element_size()  # k and v of one slot

    filled = []
    for i in range(n):
        with torch.cuda.stream(comp[i]):
            slots[i][0, 0].copy_(ks[i])
            slots[i][0, 1].copy_(vs[i])
        filled.append(comp[i].record_event())
    done: List[List[torch.cuda.Event]] = [[] for _ in range(n)]    # step r ended
    sent: List[List[torch.cuda.Event]] = [[] for _ in range(n)]    # send of step r ended
    arrived: List[Dict[int, torch.cuda.Event]] = [{} for _ in range(n)]  # chunk of step r in
    for r in range(n):
        cur, nxt = r % 2, (r + 1) % 2
        if r < n - 1:
            for i in range(n):
                right = (i + 1) % n
                side[i].wait_event(filled[i] if r == 0 else arrived[i][r])
                if r > 0:  # the neighbour is done with the slot this copy fills
                    side[i].wait_event(done[right][r - 1])
                    side[i].wait_event(sent[right][r - 1])
                with torch.cuda.device(devs[i]):
                    err = copy(slots[right][nxt].data_ptr(), devs[right].index,
                               slots[i][cur].data_ptr(), devs[i].index, slot_bytes,
                               side[i].cuda_stream)
                if err != 0:
                    raise RuntimeError(f"ring slot copy failed: CUDA error {err}")
                sent[i].append(side[i].record_event())
                arrived[right][r + 1] = sent[i][r]
        for i in range(n):
            if r > 0:
                comp[i].wait_event(arrived[i][r])
            q, o = qs[i], outs[i]
            m, l, acc = state[i]
            with torch.cuda.device(devs[i]):
                err = step(q.data_ptr(), slots[i][cur, 0].data_ptr(),
                           slots[i][cur, 1].data_ptr(), o.data_ptr(),
                           None if m is None else m.data_ptr(),
                           None if l is None else l.data_ptr(),
                           None if acc is None else acc.data_ptr(),
                           B, H, Lc, Dh, *q.stride()[:3], *o.stride()[:3],
                           float(scale), int(r == 0), int(r == n - 1),
                           comp[i].cuda_stream)
            if err != 0:
                raise RuntimeError(f"ring attention step launch failed: CUDA error {err}")
            counter.launches += 1
            done[i].append(comp[i].record_event())
    for caller in callers.values():
        for s in comp + side:
            caller.wait_stream(s)
    if cut is not None:
        _cut(outs, cut)
