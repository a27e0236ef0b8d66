"""ctypes launchers of the CUDA flash-attention kernels, and their autograd glue.

``flash_fwd`` (``csrc/flash_fwd.cu``) and ``flash_bwd``
(``csrc/flash_bwd.cu``) are shared by ``flash_attention`` and
``flash_attention_packed``: both hand them ``[B, H, L, Dh]`` views (any
batch/head/row strides, head dim contiguous) of their operands and of the
outputs they allocated, in bf16 or fp32 (nothing is cast on the way), at a
head dim of ``HEAD_DIMS`` (64 to 512; the packed layouts at multiples of
128). In bf16 at Dh 64 and 128 both entries run the Hopper kernels of
``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu`` (wgmma, TMA, mbarriers):
the packed entry's forward (K1) and backward (K2) at Dh 128, the ``[B, H,
L, Dh]`` entry's (K3, K4) at Dh 64 and 128 under the kernels' ``long``
names, each skipping the key tiles past a q tile's key extent
(``visit_keys`` mirrors the rule). In bf16 at Dh 256 to 512
(``WIDE_DIMS``) the forward of both entries runs the wide Hopper kernel
``flash_fwd_wide_sm90_kernel<Dh>`` on the same body (``WIDE_FWD_TILES``,
``wide_smem_bytes``), the backward ``flash_bwd_dkv_wide_sm90_kernel<Dh>``
and ``flash_bwd_dq_wide_sm90_kernel<Dh>`` (``WIDE_BWD_TILES``,
``wide_bwd_smem_bytes``). At Lq, Lk <= ``SHORT_MAX`` (and Dh <=
128) the ``[B, H, L, Dh]`` entry takes ``short_forward`` and
``short_backward`` instead (behind ``ShortAttention`` when a gradient is
wanted): the one-kernel forward and backward of ``csrc/flash_short.cu``
through a lean host path (one packed argument block, no row statistics, no
scratch, the caller's bool or uint8 key mask as it is). Every other call
runs the CUDA-core kernels of the same files: fp32 operands of every layout
at every head dim (``*_f32``: the forward and the backward at Dh 64 and
128, and K5 at 128, on the register-tiled kernels of
``csrc/fwd_f32_regtile.cuh`` and ``csrc/bwd_f32_regtile.cuh``, the rest on
the SIMT ones).
``fwd_symbol``, ``bwd_symbol`` and ``proj_symbol`` name the C entry a call
runs, ``fwd_kernel_name``, ``bwd_kernel_names`` and ``proj_kernel_name``
the kernels that entry launches; a call no kernel takes raises there. ``flash_fwd_proj``
(``csrc/flash_fwd_proj.cu``) is the packed forward with the output
projection fused in: the Hopper kernels in bf16 (at Dh 128, and the wide
one at Dh 256 to 512: ``WIDE_PROJ_TILES``, ``wide_proj_smem_bytes``), the
CUDA-core kernels for fp32. The launchers check what the
kernels take, launch on PyTorch's current stream, and raise if a launch
failed. They count nothing: each entry point counts its own launches.

``FlashAttention`` is the ``torch.autograd.Function`` both entry points go
through when a gradient is wanted, ``FlashAttentionProj`` the one of the
fused projection (its backward is two matrix products and the same
backward kernels). On a CUDA tensor their forward and backward launch the
kernels or raise; on a CPU tensor they run the plain versions
(``ops/attention.py``). Without a gradient, ``attention`` and
``attention_proj`` call the operators of ``ops/library.py``
(``deepcoro::attention``, ``deepcoro::attention_proj``), whose kernels are
``attention_forward`` and ``attention_proj_forward`` below.
"""

from __future__ import annotations

import ctypes
import struct
from typing import Optional

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from deepcoro_clip_tpu_torch.ops import _build
from deepcoro_clip_tpu_torch.ops.attention import (
    flash_bwd_plain,
    multi_head_attention,
    project_plain,
)

HEAD_DIMS = (64, 128, 256, 384, 512)  # the head dims a kernel takes
HOPPER_DIMS = (64, 128)  # bf16 on the Hopper kernels of every entry, forward and backward
# bf16 at these head dims runs the wide Hopper kernels: the forwards K1, K3
# (csrc/flash_fwd.cu flash_fwd_wide_sm90_kernel) and K5 (csrc/flash_fwd_proj.cu
# flash_fwd_proj_wide_sm90_kernel), the backward K2, K4 (csrc/flash_bwd.cu
# flash_bwd_dkv_wide_sm90_kernel, flash_bwd_dq_wide_sm90_kernel)
WIDE_DIMS = (256, 384, 512)
# the wide K1/K3 kernel's tiles by head dim (FwdCfg in csrc/flash_fwd.cu): q
# rows an item, keys a K/V tile, stages of the K/V ring, and the consumer
# warpgroups that share 64 rows, splitting O's columns
WIDE_FWD_TILES = {256: (128, 64, 2, 1), 384: (64, 32, 3, 2), 512: (64, 32, 2, 2)}
# the wide K5 kernel's (ProjCfg in csrc/flash_fwd_proj.cu): keys a K/V tile,
# stages of the ring
WIDE_PROJ_TILES = {256: (32, 3), 384: (32, 2), 512: (16, 3)}
# the wide backward's (BwdWideCfg in csrc/flash_bwd.cu): rows of the streamed
# tile (q rows of the dK/dV kernel, keys of the dQ kernel) and its stages;
# both kernels hold WIDE_BWD_ROWS resident rows (keys, q rows) a block, and
# a dK/dV block at most WIDE_BWD_SLAB rotate-half pairs of boxes of dK and dV
# (so D / 128 / WIDE_BWD_SLAB blocks, rounded up, share a key block)
WIDE_BWD_TILES = {256: (64, 2), 384: (32, 2), 512: (16, 2)}
WIDE_BWD_ROWS, WIDE_BWD_SLAB = 64, 2
PROJ_MAX = 1024  # H * Dh of the fused-projection kernels' shared output tile
TILE = 64  # rows per tile of the kernels; the backward pads its row values to it
SHORT_MAX = 64  # Lq and Lk up to this run csrc/flash_short.cu ([B, H, L, Dh] entry)
# (q rows, keys) of a tile pair of the Hopper kernels: the forward's items and
# key tiles, the dK/dV kernel's streamed q tiles and key blocks (64 keys at
# the main paths' Dh 64; 128 at Dh 128), the dQ kernel's q blocks and
# streamed key tiles (csrc/flash_fwd.cu, flash_bwd.cu)
FWD_TILES = (128, 128)
DKV_TILES = (64, 64)
DQ_TILES = (128, 64)
# the fp32 forward's register-tiled kernels (csrc/fwd_f32_regtile.cuh): head
# dims, q rows a block, keys a streamed tile (K1 / K3, K5), row padding in
# floats
REGTILE_DIMS = (64, 128)
REGTILE_PROJ_DIM = 128
REGTILE_ROWS, REGTILE_KEYS, REGTILE_PROJ_KEYS, REGTILE_PAD = 64, 64, 32, 4
# the fp32 backward's register-tiled kernels (csrc/bwd_f32_regtile.cuh), at
# REGTILE_DIMS: keys a dK/dV block (and a streamed dQ tile), q rows a
# streamed dK/dV tile (and a dQ block), row padding in floats
REGTILE_BWD_KEYS, REGTILE_BWD_ROWS, REGTILE_BWD_PAD = 64, 64, 4
SMEM_MAX = 232_448  # dynamic shared memory a block may take on an H100
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}
# slots of the argument block of csrc/flash_short.cu (its enum ShortArg)
(A_Q, A_K, A_V, A_O, A_DO, A_DQ, A_DK, A_DV, A_MASK, A_SIN, A_COS, A_STREAM,
 A_QS) = range(13)
A_KS, A_VS, A_DOS = A_QS + 3, A_QS + 6, A_QS + 9
A_MASK_SB, A_B, A_H, A_LQ, A_LK, A_DH, A_CAUSAL, A_COUNT = range(A_QS + 12, A_QS + 20)
_ARGS = struct.Struct(f"{A_COUNT}q")


def _c_fn(lib: str, symbol: str, argtypes):
    fn = getattr(_build.load(lib), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def kernel_head_dim(Dh: int) -> int:
    """The head dim a CUDA call at ``Dh`` runs at: the smallest of
    ``HEAD_DIMS`` that holds it (the ``[B, H, L, Dh]`` entry and the ring
    pad to it); above 512 it raises, naming the width."""
    for width in HEAD_DIMS:
        if Dh <= width:
            return width
    raise ValueError(f"the CUDA flash kernels take Dh up to {HEAD_DIMS[-1]}, got {Dh}")


def is_short(packed: bool, Lq: int, Lk: int, Dh: int) -> bool:
    """Whether a call runs the short kernels of ``csrc/flash_short.cu``:
    the ``[B, H, L, Dh]`` entry with both lengths at most ``SHORT_MAX`` and
    Dh at most 128 (a wider head runs the wide Hopper kernels at every
    length)."""
    return (not packed and Lq <= SHORT_MAX and Lk <= SHORT_MAX
            and Dh <= HOPPER_DIMS[-1])


def key_extent(kv_mask, B: int, Lk: int):
    """The key extent of each batch row as the Hopper kernels read it from
    the mask (``key_extent`` in ``csrc/sm90_common.cuh``): ``(e, f)``, int
    arrays ``[B]``, ``e`` 1 + the index of the row's last nonzero mask byte
    (0: none), ``f`` the index of its first (Lk: none). ``kv_mask``
    ``[B, Lk]`` (nonzero = attend; a tensor or an array), or None: every
    key, e = Lk and f = 0."""
    if kv_mask is None:
        return np.full(B, Lk, np.int64), np.zeros(B, np.int64)
    m = np.asarray(kv_mask.detach().cpu() if torch.is_tensor(kv_mask) else kv_mask) != 0
    any_ = m.any(axis=1)
    e = np.where(any_, Lk - np.argmax(m[:, ::-1], axis=1), 0)
    f = np.where(any_, np.argmax(m, axis=1), Lk)
    return e.astype(np.int64), f.astype(np.int64)


def visit_keys(e: int, f: int, Lq: int, Lk: int, q0: int, rows: int, causal: bool) -> int:
    """The keys ``[0, n)`` that the q rows ``[q0, q0 + rows)`` (those below
    Lq) of a batch row with key extent ``(e, f)`` visit in the Hopper
    kernels (``visit_keys`` in ``csrc/sm90_common.cuh``): ``min(Lk, e,
    last row + 1 under causal masking)`` when every row has a real key (e
    > 0 and, under causal masking, f <= q0), else all Lk: a row with no
    real key attends every key uniformly. Past the extent every key of
    every row scores -FLT_MAX against a finite running maximum, so a tile
    there adds exactly nothing; the kernels skip it."""
    if e == 0 or (causal and f > q0):
        return Lk
    last = min(q0 + rows, Lq) - 1
    return min(Lk, e, last + 1) if causal else min(Lk, e)


def visited_key_tiles(kv_mask, B: int, Lq: int, Lk: int, causal: bool,
                      tiles=FWD_TILES) -> np.ndarray:
    """Key tiles visited by each q tile, ``[B, ceil(Lq / rows)]`` for
    ``tiles = (rows, keys)``: the forward's items (``FWD_TILES``) or the dQ
    kernel's blocks (``DQ_TILES``); the dK/dV kernel's block of key tile
    ``kt`` visits the q tiles (of ``DKV_TILES[0]`` rows) whose extent
    passes ``kt * DKV_TILES[1]``."""
    rows, keys = tiles
    e, f = key_extent(kv_mask, B, Lk)
    nq = -(-Lq // rows)
    return np.array([[-(-visit_keys(int(e[b]), int(f[b]), Lq, Lk, j * rows, rows, causal)
                       // keys) for j in range(nq)] for b in range(B)], np.int64)


def key_cut(kv_mask, B: int, Lk: int) -> int:
    """Without causal masking, the keys past which no kernel of a call
    looks: the largest extent over the batch rows rounded up to the
    forward's 128-key tiles (a multiple of the dK/dV and dQ kernels' 64 and
    of the dK/dV kernel's 128 at Dh 128), at most Lk. A call whose K, V and mask are cut to these
    keys computes the same forward and dQ bit for bit, and dK, dV past the
    cut are exactly 0."""
    e, _ = key_extent(kv_mask, B, Lk)
    ext = int(max(int(x) if x > 0 else Lk for x in e))
    return min(Lk, -(-ext // FWD_TILES[1]) * FWD_TILES[1])


def _check_choice(dtype: torch.dtype, packed: bool, Dh: int) -> None:
    """Raise for what no kernel takes: a type other than bf16 and fp32, a
    head dim outside ``HEAD_DIMS``, a packed head dim that is not a multiple
    of 128 (as the JAX packed wrapper requires)."""
    if dtype not in _SUFFIX:
        raise TypeError(f"the CUDA flash kernels take bfloat16 or float32, got {dtype}")
    if Dh not in HEAD_DIMS:
        raise ValueError(f"the CUDA flash kernels take Dh in {HEAD_DIMS}, got {Dh}")
    if packed and Dh % 128:
        raise ValueError(f"the packed CUDA kernels take Dh % 128 == 0, got Dh {Dh}")


def fwd_symbol(dtype: torch.dtype, packed: bool, Lq: int, Lk: int, Dh: int) -> str:
    """The C entry that runs a forward: the short kernel of
    ``csrc/flash_short.cu`` for the ``[B, H, L, Dh]`` entry at Lq, Lk <=
    ``SHORT_MAX`` and Dh <= 128; else a kernel of ``csrc/flash_fwd.cu``:
    in bf16 at Dh 128 K1's Hopper kernel for the packed and fused layouts,
    at Dh 64 and 128 K3's Hopper kernel for ``[B, H, L, Dh]``, at Dh 256 to
    512 the wide Hopper kernel for both; in fp32 the fp32 entry for every
    layout and head dim (``fwd_kernel_name``: the register-tiled kernel at
    Dh 64 and 128, the SIMT one above)."""
    _check_choice(dtype, packed, Dh)
    if is_short(packed, Lq, Lk, Dh):
        return f"deepcoro_flash_short_fwd_{_SUFFIX[dtype]}"
    return _tile_symbol("fwd", dtype, packed, Dh)


def bwd_symbol(dtype: torch.dtype, packed: bool, Lq: int, Lk: int, Dh: int) -> str:
    """The C entry that runs a backward, by the forward's rule: the
    one-launch short backward of ``csrc/flash_short.cu`` (``[B, H, L,
    Dh]``, Lq, Lk <= ``SHORT_MAX``, Dh <= 128), else the kernels of
    ``csrc/flash_bwd.cu``: K2's Hopper kernels (packed, bf16, Dh 128), K4's
    (``[B, H, L, Dh]``, bf16, Dh 64 and 128), the wide Hopper kernels (bf16,
    Dh 256 to 512, both layouts) or the fp32 entry for every layout and head dim
    (``bwd_kernel_names``: the register-tiled kernels at Dh 64 and 128, the
    SIMT ones above)."""
    _check_choice(dtype, packed, Dh)
    if is_short(packed, Lq, Lk, Dh):
        return f"deepcoro_flash_short_bwd_{_SUFFIX[dtype]}"
    return _tile_symbol("bwd", dtype, packed, Dh)


def _tile_symbol(direction: str, dtype: torch.dtype, packed: bool, Dh: int) -> str:
    """The entry of ``csrc/flash_{direction}.cu``: the fp32 CUDA-core kernels
    for fp32, the wide entries for bf16 above Dh 128 (the wide Hopper
    forward and backward), else K1's or K2's Hopper kernels for the
    packed layouts and K3's or K4's for ``[B, H, L, Dh]``."""
    if dtype == torch.float32:
        return f"deepcoro_flash_{direction}_f32"
    if Dh > HOPPER_DIMS[-1]:
        return f"deepcoro_flash_wide_{direction}_bf16"
    if packed:
        return f"deepcoro_flash_{direction}_sm90_bf16"
    return f"deepcoro_flash_long_{direction}_bf16"


def proj_symbol(dtype: torch.dtype, Dh: int, H: int, Dout: int) -> str:
    """The C entry of ``csrc/flash_fwd_proj.cu`` that runs a forward with
    the fused projection (K5): the Hopper kernel in bf16 at Dh 128 (``Dout
    % 128 == 0``), the fp32 entry at Dh 128 to 512 (``proj_kernel_name``:
    the register-tiled kernel at 128, the SIMT one above) and the wide
    Hopper kernel for bf16 at Dh 256 to 512 (any Dout); every one at ``H *
    Dh <= PROJ_MAX``."""
    _check_choice(dtype, True, Dh)
    if H * Dh > PROJ_MAX:
        raise ValueError(f"the fused-projection kernels take H*Dh <= {PROJ_MAX}, "
                         f"got H={H}, Dh={Dh}")
    if dtype == torch.float32:
        return "deepcoro_flash_fwd_proj_f32"
    if Dh > HOPPER_DIMS[-1]:
        return "deepcoro_flash_fwd_proj_wide_bf16"
    if Dout % 128:
        raise ValueError(f"the Hopper fused-projection kernel takes Dout % 128 == 0, "
                         f"got {Dout}")
    return "deepcoro_flash_fwd_proj_bf16"


def fwd_kernel_name(dtype: torch.dtype, packed: bool, Lq: int, Lk: int, Dh: int) -> str:
    """The kernel that ``fwd_symbol``'s entry launches for a call, as a
    profiler names it: in fp32 ``flash_fwd_f32_regtile_kernel<Dh>`` at Dh
    64 and 128 (K1, K3) and ``flash_fwd_f32_kernel<Dh>`` above; in bf16
    the Hopper, long or short kernels, and at Dh 256 to 512
    ``flash_fwd_wide_sm90_kernel<Dh>`` (K1 and K3)."""
    symbol = fwd_symbol(dtype, packed, Lq, Lk, Dh)
    if symbol.startswith("deepcoro_flash_short"):
        return f"flash_short_fwd_{_SUFFIX[dtype]}_kernel"
    if dtype == torch.float32:
        if Dh in REGTILE_DIMS:
            return f"flash_fwd_f32_regtile_kernel<{Dh}>"
        return f"flash_fwd_f32_kernel<{Dh}>"
    if symbol == "deepcoro_flash_wide_fwd_bf16":
        return f"flash_fwd_wide_sm90_kernel<{Dh}>"
    if packed:
        return "flash_fwd_sm90_kernel"
    return f"flash_long_fwd_kernel<{Dh}>"


def proj_kernel_name(dtype: torch.dtype, Dh: int, H: int, Dout: int) -> str:
    """The kernel that ``proj_symbol``'s entry launches: in fp32
    ``flash_fwd_proj_f32_regtile_kernel`` at Dh 128 and
    ``flash_fwd_proj_f32_kernel<Dh>`` above; in bf16 the Hopper kernel
    (``flash_fwd_proj_kernel<NWG>``, two consumer warpgroups up to H * 128
    = 512) or, at Dh 256 to 512, the wide one
    (``flash_fwd_proj_wide_sm90_kernel<Dh>``)."""
    proj_symbol(dtype, Dh, H, Dout)  # raises for what no kernel takes
    if dtype == torch.float32:
        if Dh == REGTILE_PROJ_DIM:
            return "flash_fwd_proj_f32_regtile_kernel"
        return f"flash_fwd_proj_f32_kernel<{Dh}>"
    if Dh > HOPPER_DIMS[-1]:
        return f"flash_fwd_proj_wide_sm90_kernel<{Dh}>"
    return f"flash_fwd_proj_kernel<{2 if H * Dh <= 512 else 1}>"


def _ring_stage(Dh: int, keys: int) -> int:
    """Bytes of a stage of the Hopper kernels' K/V ring (``KVRing``): K's
    and V's ``Dh / 64`` boxes of ``keys`` rows of 128 bytes."""
    return 2 * (Dh // 64) * keys * 128


def wide_smem_bytes(Dh: int) -> int:
    """Dynamic shared memory a block of ``flash_fwd_wide_sm90_kernel<Dh>``
    takes (``Sm90Smem`` in ``csrc/flash_fwd.cu``): the q tile (``Dh / 64``
    boxes of ``rows x 128`` bytes), the K/V ring, at split 2 the two
    warpgroups' partial S of two key tiles (fp32), a mask byte a key a
    stage, the barriers (full and empty a stage, loaded and free a q tile),
    the q tile's key-tile count and 1 KB to align the base."""
    rows, keys, stages, split = WIDE_FWD_TILES[Dh]
    q = (Dh // 64) * rows * 128
    partial_s = 2 * 2 * 128 * (keys // 2) * 4 if split == 2 else 0
    bars = q + stages * _ring_stage(Dh, keys) + partial_s + stages * keys
    return bars + (2 * stages + 2) * 8 + 16 + 1024


def wide_proj_smem_bytes(Dh: int, H: int) -> int:
    """Dynamic shared memory a block of the wide K5 kernel takes at ``H``
    heads (``ProjSmem`` in ``csrc/flash_fwd_proj.cu``): the output tile
    ``[64, H*Dh]`` bf16 (the two consumer warpgroups share its rows), the
    K/V ring, a mask byte a key a stage, the barriers (full and empty a
    stage, a q tile's a head) and 1 KB to align the base."""
    keys, stages = WIDE_PROJ_TILES[Dh]
    mask = H * Dh * 64 * 2 + stages * _ring_stage(Dh, keys)
    return mask + stages * keys + (2 * stages + H) * 8 + 1024


def wide_bwd_smem_bytes(Dh: int) -> tuple:
    """Dynamic shared memory a block of the wide backward kernels takes
    (``DkvWideSmem`` and ``DqWideSmem`` in ``csrc/flash_bwd.cu``), as (dK/dV,
    dQ). The dK/dV block: K and V of its 64 keys (``Dh / 64`` boxes of ``64
    x 128`` bytes each), the ring of Q and dO tiles, a stage's row values (m,
    1/l, delta: ``3 x rows`` fp32), P^T of two tiles in fp32 (``64 x rows``
    each). The dQ block: Q and dO of its 64 rows, the K/V ring, P in fp32 and
    dS in bf16 (``64 x keys`` each). Both: the barriers (full and empty a
    stage, the resident tile loaded) and 1 KB to align the base."""
    rows, stages = WIDE_BWD_TILES[Dh]
    resident = 2 * (Dh // 64) * WIDE_BWD_ROWS * 128
    bars = (2 * stages + 1) * 8 + 1024
    dkv = (resident + stages * _ring_stage(Dh, rows) + stages * 3 * rows * 4
           + 2 * WIDE_BWD_ROWS * rows * 4)
    dq = resident + stages * _ring_stage(Dh, rows) + WIDE_BWD_ROWS * rows * (4 + 2)
    return dkv + bars, dq + bars


def bwd_kernel_names(dtype: torch.dtype, packed: bool, Lq: int, Lk: int, Dh: int) -> tuple:
    """The dK/dV and dQ kernels that ``bwd_symbol``'s entry launches for a
    call (after its row pre-pass), as a profiler names them: in fp32
    ``flash_bwd_dkv_f32_regtile_kernel<Dh>`` and
    ``flash_bwd_dq_f32_regtile_kernel<Dh>`` at Dh 64 and 128 (K2, K4) and
    the SIMT ``flash_bwd_{dkv,dq}_f32_kernel<Dh>`` above; in bf16 the
    Hopper or long kernels, and at Dh 256 to 512
    ``flash_bwd_{dkv,dq}_wide_sm90_kernel<Dh>`` (K2 and K4). A short call's
    one kernel alone."""
    symbol = bwd_symbol(dtype, packed, Lq, Lk, Dh)
    if symbol.startswith("deepcoro_flash_short"):
        return (f"flash_short_bwd_{_SUFFIX[dtype]}_kernel",)
    if dtype == torch.float32:
        kind = "f32_regtile" if Dh in REGTILE_DIMS else "f32"
        return (f"flash_bwd_dkv_{kind}_kernel<{Dh}>", f"flash_bwd_dq_{kind}_kernel<{Dh}>")
    if symbol == "deepcoro_flash_wide_bwd_bf16":
        return (f"flash_bwd_dkv_wide_sm90_kernel<{Dh}>", f"flash_bwd_dq_wide_sm90_kernel<{Dh}>")
    if packed:
        return ("flash_bwd_dkv_sm90_kernel", "flash_bwd_dq_sm90_kernel")
    return (f"flash_long_bwd_dkv_kernel<{Dh}>", f"flash_long_bwd_dq_kernel<{Dh}>")


def regtile_bwd_smem_bytes(Dh: int) -> tuple:
    """Dynamic shared memory a block of the register-tiled fp32 backward
    kernels takes (``RbDkvTiles`` and ``RbDqTiles`` in
    ``csrc/bwd_f32_regtile.cuh``), as (dK/dV, dQ): the dK/dV block's K and
    V ``[64][Dh + 4]``, Q and dO ``[2][64][Dh + 4]`` (double-buffered) and
    its exchange tile ``[64][64]`` floats; the dQ block's dS^T ``[2][64][64
    + 4]`` and K ``[2][64][Dh + 4]``."""
    ld, pad = Dh + REGTILE_BWD_PAD, REGTILE_BWD_PAD
    keys, rows = REGTILE_BWD_KEYS, REGTILE_BWD_ROWS
    dkv = 2 * keys * ld + 4 * rows * ld + keys * rows
    dq = 2 * keys * (rows + pad) + 2 * keys * ld
    return 4 * dkv, 4 * dq


def regtile_smem_bytes(Dh: int, keys: int = REGTILE_KEYS) -> int:
    """Dynamic shared memory a block of the register-tiled fp32 kernels
    takes (``RtTiles`` in ``csrc/fwd_f32_regtile.cuh``) at ``keys`` a key
    tile (``REGTILE_KEYS`` for K1 and K3, ``REGTILE_PROJ_KEYS`` for K5): the
    Q tile ``[64][Dh + 4]``, the K tile ``[keys][Dh + 4]`` and the V tile
    ``[keys][Dh]`` floats. K5 takes no more at any H and Dout: its ``wo``
    slabs use the K and V tiles' place, the head's output the Q tile's,
    and y's running sum waits in y."""
    ld = Dh + REGTILE_PAD
    return 4 * (REGTILE_ROWS * ld + keys * (ld + Dh))


def _fwd_fn(symbol: str):
    return _c_fn("flash_fwd", symbol,
                 [_P] * 9 + [_I] * 5 + [_LL] * 12 + [ctypes.c_float, _I, _P])


# the arguments of csrc/flash_bwd.cu's C entries (its BWD_ARGS): 16 pointers
# (operands, outputs, statistics, tables, mask, scratch), B, H, Lq, Lk, Dh,
# 24 strides, the scale, causal, the stream
BWD_ARGTYPES = [_P] * 16 + [_I] * 5 + [_LL] * 24 + [ctypes.c_float, _I, _P]


def _bwd_fn(symbol: str):
    return _c_fn("flash_bwd", symbol, BWD_ARGTYPES)


_short_fns: dict = {}  # symbol -> the loaded C entry of csrc/flash_short.cu


def _short_fn(symbol: str):
    """An entry of ``csrc/flash_short.cu``: ``(argument block, scale)``."""
    fn = _short_fns.get(symbol)
    if fn is None:
        lib = _build.load("flash_short")
        if lib.deepcoro_flash_short_arg_count() != A_COUNT:
            raise RuntimeError("csrc/flash_short.cu and ops/_flash_cuda.py disagree on "
                               "the argument block")
        fn = _c_fn("flash_short", symbol, [ctypes.c_char_p, ctypes.c_float])
        _short_fns[symbol] = fn
    return fn


def _fwd_proj_fn(symbol: str):
    return _c_fn("flash_fwd_proj", symbol,
                 [_P] * 11 + [_I] * 6 + [_LL] * 12 + [ctypes.c_float, _I, _P])


def hopper_kernel_attrs(heads=(4, 6)) -> dict:
    """Registers per thread (at the kernel's entry, before ``setmaxnreg``
    moves them between warpgroups, where ``"setmaxnreg"`` says so), dynamic
    shared memory per block and consumer warpgroups of K1's Hopper kernel,
    of K5's for each head count in ``heads``, of K2's two (whose blocks are
    their two warpgroups alone) and of K3's and K4's long kernels at Dh 64
    and 128: what ``chip_smoke.py`` reports beside ptxas. Builds the
    libraries if need be."""
    regs, smem = ctypes.c_int(), ctypes.c_int()
    ip = ctypes.POINTER(ctypes.c_int)
    fn = _c_fn("flash_fwd", "deepcoro_flash_fwd_sm90_attrs", [ip, ip])
    if fn(ctypes.byref(regs), ctypes.byref(smem)) != 0:
        raise RuntimeError("cudaFuncGetAttributes failed on the K1 kernel")
    out = {"K1": {"kernel": "flash_fwd_sm90_kernel", "registers": regs.value,
                  "smem_bytes": smem.value, "consumers": 2, "setmaxnreg": True}}
    fn = _c_fn("flash_fwd_proj", "deepcoro_flash_fwd_proj_attrs", [_I, ip, ip])
    for h in heads:
        if fn(h, ctypes.byref(regs), ctypes.byref(smem)) != 0:
            raise RuntimeError(f"cudaFuncGetAttributes failed on the K5 kernel, H {h}")
        two = h * 128 <= 512
        out[f"K5 H{h}"] = {"kernel": "flash_fwd_proj_kernel", "registers": regs.value,
                           "smem_bytes": smem.value, "consumers": 2 if two else 1,
                           "setmaxnreg": two}
    fn = _c_fn("flash_fwd", "deepcoro_flash_long_fwd_attrs", [_I, ip, ip])
    for dh in HOPPER_DIMS:
        if fn(dh, ctypes.byref(regs), ctypes.byref(smem)) != 0:
            raise RuntimeError(f"cudaFuncGetAttributes failed on the K3 kernel, Dh {dh}")
        out[f"K3 Dh {dh}"] = {"kernel": f"flash_long_fwd_kernel<{dh}>",
                              "registers": regs.value, "smem_bytes": smem.value,
                              "consumers": 2, "setmaxnreg": True}
    fn = _c_fn("flash_bwd", "deepcoro_flash_bwd_sm90_attrs", [_I, _I, ip, ip])
    kernels = [("K2 dK/dV", "flash_bwd_dkv_sm90_kernel", 0, 0),
               ("K2 dQ", "flash_bwd_dq_sm90_kernel", 1, 0)]
    kernels += [(f"K4 {w} Dh {dh}", f"flash_long_bwd_{n}_kernel<{dh}>", which, dh)
                for dh in HOPPER_DIMS for which, (w, n) in enumerate((("dK/dV", "dkv"),
                                                                    ("dQ", "dq")))]
    for key, kernel, which, dh in kernels:
        if fn(which, dh, ctypes.byref(regs), ctypes.byref(smem)) != 0:
            raise RuntimeError(f"cudaFuncGetAttributes failed on {kernel}")
        out[key] = {"kernel": kernel, "registers": regs.value, "smem_bytes": smem.value,
                    "consumers": 1 if (which, dh) == (0, 64) else 2, "setmaxnreg": False}
    return out


def wide_kernel_attrs() -> dict:
    """Registers per thread (at entry; ``setmaxnreg`` gives a consumer
    warpgroup 232) and local memory (spilled) bytes per thread of the wide
    Hopper forwards, as the runtime reads them from the built libraries
    (``cudaFuncGetAttributes``): ``flash_fwd_wide_sm90_kernel<Dh>`` and
    ``flash_fwd_proj_wide_sm90_kernel<Dh>`` at each of ``WIDE_DIMS``. What
    ``chip_smoke.py`` reports beside ptxas."""
    regs, local = ctypes.c_int(), ctypes.c_int()
    ip = ctypes.POINTER(ctypes.c_int)
    out = {}
    for key, lib, entry, kernel in (
            ("K1/K3", "flash_fwd", "deepcoro_flash_wide_fwd_attrs", "flash_fwd_wide_sm90_kernel"),
            ("K5", "flash_fwd_proj", "deepcoro_flash_fwd_proj_wide_attrs",
             "flash_fwd_proj_wide_sm90_kernel")):
        fn = _c_fn(lib, entry, [_I, ip, ip])
        for dh in WIDE_DIMS:
            if fn(dh, ctypes.byref(regs), ctypes.byref(local)) != 0:
                raise RuntimeError(f"cudaFuncGetAttributes failed on {kernel}<{dh}>")
            out[f"{key} wide Dh {dh}"] = {"kernel": f"{kernel}<{dh}>", "registers": regs.value,
                                          "local_bytes": local.value, "dh": dh}
    return out


def wide_bwd_kernel_attrs() -> dict:
    """Registers and local memory (spilled) bytes per thread, and dynamic
    shared memory per block, of the wide Hopper backward kernels
    (``flash_bwd_dkv_wide_sm90_kernel<Dh>``, ``flash_bwd_dq_wide_sm90_kernel<Dh>``
    at each of ``WIDE_DIMS``; blocks of two warpgroups, no ``setmaxnreg``), as
    the runtime reads them from the built library: what ``chip_smoke.py``
    reports beside ptxas and holds against ``wide_bwd_smem_bytes``."""
    regs, local, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    ip = ctypes.POINTER(ctypes.c_int)
    fn = _c_fn("flash_bwd", "deepcoro_flash_wide_bwd_attrs", [_I, _I, ip, ip, ip])
    out = {}
    for dh in WIDE_DIMS:
        for which, (label, name) in enumerate((("dK/dV", "dkv"), ("dQ", "dq"))):
            kernel = f"flash_bwd_{name}_wide_sm90_kernel<{dh}>"
            if fn(which, dh, ctypes.byref(regs), ctypes.byref(local), ctypes.byref(smem)) != 0:
                raise RuntimeError(f"cudaFuncGetAttributes failed on {kernel}")
            out[f"K2/K4 {label} wide Dh {dh}"] = {
                "kernel": kernel, "registers": regs.value, "local_bytes": local.value,
                "smem_bytes": smem.value, "dh": dh}
    return out


def regtile_kernel_attrs() -> dict:
    """Registers per thread and dynamic shared memory per block of the
    register-tiled fp32 kernels, from the built libraries: the forward at
    Dh 64 and 128, and K5. What ``chip_smoke.py`` reports beside ptxas and
    holds against ``regtile_smem_bytes``."""
    regs, smem = ctypes.c_int(), ctypes.c_int()
    ip = ctypes.POINTER(ctypes.c_int)
    out = {}
    fn = _c_fn("flash_fwd", "deepcoro_flash_fwd_f32_regtile_attrs", [_I, ip, ip])
    for dh in REGTILE_DIMS:
        if fn(dh, ctypes.byref(regs), ctypes.byref(smem)) != 0:
            raise RuntimeError(f"cudaFuncGetAttributes failed on the fp32 forward, Dh {dh}")
        out[f"K1/K3 fp32 Dh {dh}"] = {"kernel": f"flash_fwd_f32_regtile_kernel<{dh}>",
                                      "registers": regs.value, "smem_bytes": smem.value}
    fn = _c_fn("flash_fwd_proj", "deepcoro_flash_fwd_proj_f32_regtile_attrs", [ip, ip])
    if fn(ctypes.byref(regs), ctypes.byref(smem)) != 0:
        raise RuntimeError("cudaFuncGetAttributes failed on the fp32 K5")
    out["K5 fp32 Dh 128"] = {"kernel": "flash_fwd_proj_f32_regtile_kernel",
                             "registers": regs.value, "smem_bytes": smem.value}
    return out


def regtile_bwd_kernel_attrs() -> dict:
    """Registers per thread and dynamic shared memory per block of the
    register-tiled fp32 backward kernels (dK/dV and dQ at Dh 64 and 128),
    from the built library: what ``chip_smoke.py`` reports beside ptxas and
    holds against ``regtile_bwd_smem_bytes``."""
    regs, smem = ctypes.c_int(), ctypes.c_int()
    ip = ctypes.POINTER(ctypes.c_int)
    fn = _c_fn("flash_bwd", "deepcoro_flash_bwd_f32_regtile_attrs", [_I, _I, ip, ip])
    out = {}
    for dh in REGTILE_DIMS:
        for which, (label, name) in enumerate((("dK/dV", "dkv"), ("dQ", "dq"))):
            kernel = f"flash_bwd_{name}_f32_regtile_kernel<{dh}>"
            if fn(which, dh, ctypes.byref(regs), ctypes.byref(smem)) != 0:
                raise RuntimeError(f"cudaFuncGetAttributes failed on {kernel}")
            out[f"K2/K4 {label} fp32 Dh {dh}"] = {"kernel": kernel, "registers": regs.value,
                                                  "smem_bytes": smem.value}
    return out


def _raw_stream(device: torch.device) -> int:
    """The handle of the current stream on ``device``, read without building
    a ``torch.cuda.Stream`` (which took a measurable share of a short call's
    host time, ``chip_smoke.py`` phase 21)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _aligned(t: torch.Tensor) -> bool:
    """Head dim contiguous, base and strides fit for 16-byte loads."""
    e = 16 // t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and not any(s % e for s in t.stride()[:3]))


def _check_operand(name: str, t: torch.Tensor, device: torch.device,
                   dtype: torch.dtype) -> None:
    """``dtype`` is the type of q, which every operand shares: bf16 or
    fp32. bf16 operands must allow 16-byte loads (the Hopper kernels' TMA,
    the bf16 RoPE pre-pass); fp32 ones are read a value (4 bytes) at a
    time, which any fp32 tensor allows."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if dtype not in _SUFFIX:
        raise TypeError(
            f"the CUDA flash kernels take bfloat16 or float32, got {dtype}")
    if t.dtype != dtype:
        raise TypeError(f"{name} is {t.dtype}, expected q's {dtype}")
    if t.stride(-1) != 1:
        raise ValueError(f"{name}: the head dim must be contiguous")
    # the bf16 kernels load 16 bytes at a time, the fp32 ones single values
    if dtype == torch.float32 and t.data_ptr() % 4:
        raise ValueError(f"{name}: an fp32 operand must start on a 4-byte boundary")
    if dtype == torch.bfloat16 and not _aligned(t):
        raise ValueError(
            f"{name}: base and strides must allow 16-byte loads "
            f"(ptr % 16 == 0, strides % 8 == 0), got strides {t.stride()}")


def mask_arg(kv_mask: Optional[torch.Tensor], strided: bool) -> Optional[torch.Tensor]:
    """The key mask ``[B, Lk]`` as the kernels read it: one byte a key,
    nonzero = attend, the keys contiguous; the short kernels also take any
    batch stride (``strided``), the tile kernels a contiguous mask. A bool
    or uint8 mask that is so already goes as it is, without a kernel; any
    other is converted once."""
    if kv_mask is None:
        return None
    if kv_mask.dtype in (torch.bool, torch.uint8) and (
            (strided and (kv_mask.stride(1) == 1 or kv_mask.shape[1] == 1))
            or kv_mask.is_contiguous()):
        return kv_mask
    return (kv_mask != 0).to(torch.uint8).contiguous()


def _check_problem(q, k, v, sin, cos, kv_mask):
    """Shapes, sizes, tables and the mask's shape and device."""
    device = q.device
    if device.type != "cuda":
        raise ValueError(f"the flash kernels need CUDA tensors, got {device}")
    B, H, Lq, Dh = q.shape
    Lk = k.shape[2]
    if Dh not in HEAD_DIMS:
        raise ValueError(f"the CUDA flash kernel takes Dh in {HEAD_DIMS}, got {Dh}")
    if k.shape != (B, H, Lk, Dh) or v.shape != (B, H, Lk, Dh):
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if Lq < 1 or Lk < 1 or B * H > 65535:
        raise ValueError(f"unsupported sizes B*H={B * H}, Lq={Lq}, Lk={Lk}")
    if sin is not None:
        if Lq != Lk:
            raise ValueError("RoPE flash attention requires Lq == Lk")
        for name, t in (("sin", sin), ("cos", cos)):
            if (t is None or t.shape != (Lq, Dh) or t.dtype != torch.float32
                    or t.device != device or not t.is_contiguous()):
                raise ValueError(
                    f"{name} must be a contiguous float32 [{Lq}, {Dh}] tensor "
                    f"on {device}")
            # the bf16 RoPE pre-pass and the Hopper kernels read 16 bytes at a time
            if t.data_ptr() % 16:
                raise ValueError(f"{name} must start on a 16-byte boundary")
    if kv_mask is not None and (kv_mask.shape != (B, Lk) or kv_mask.device != device):
        raise ValueError(f"kv_mask must be [{B}, {Lk}] on {device}, "
                         f"got {tuple(kv_mask.shape)} on {kv_mask.device}")


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              out: torch.Tensor, *, sin: Optional[torch.Tensor],
              cos: Optional[torch.Tensor], kv_mask: Optional[torch.Tensor],
              causal: bool, scale: float,
              stats: Optional[torch.Tensor] = None, packed: bool = False) -> None:
    """Write attention of ``q`` over ``k``/``v`` into ``out`` (all views
    ``[B, H, L, Dh]`` on one CUDA device, all bf16 or all fp32). ``stats``,
    a contiguous fp32 ``[2, B, H, Lq]`` buffer, receives each row's softmax
    maximum and sum for the backward; without it nothing extra is written.
    ``packed``: the views are heads of packed ``[B, L, H*Dh]`` operands
    (K1), whose Dh is a multiple of 128; otherwise (K3, any lengths). The
    kernel is ``_tile_symbol``'s: bf16 at Dh 128 packed
    ``flash_fwd_sm90_kernel``, bf16 at Dh 64 / 128 otherwise
    ``flash_long_fwd_kernel<Dh>``, bf16 at Dh 256 to 512
    ``flash_fwd_wide_sm90_kernel<Dh>``, fp32 ``flash_fwd_f32_regtile_kernel<Dh>``
    at Dh 64 / 128 and ``flash_fwd_f32_kernel<Dh>`` above
    (``fwd_kernel_name``)."""
    _check_problem(q, k, v, sin, cos, kv_mask)
    mask = mask_arg(kv_mask, strided=False)
    device = q.device
    B, H, Lq, Dh = q.shape
    Lk = k.shape[2]
    _check_choice(q.dtype, packed, Dh)
    if out.shape != q.shape:
        raise ValueError(f"out shape {tuple(out.shape)} != q {tuple(q.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        _check_operand(name, t, device, q.dtype)
    if stats is not None and (
            stats.shape != (2, B, H, Lq) or stats.dtype != torch.float32
            or stats.device != device or not stats.is_contiguous()):
        raise ValueError(f"stats must be a contiguous float32 [2, {B}, {H}, {Lq}] "
                         f"tensor on {device}")
    # RoPE of K is applied once, by a pre-pass, into this scratch copy
    k_rot = None if sin is None else torch.empty(
        (B, H, Lk, Dh), dtype=q.dtype, device=device)
    err = _fwd_fn(_tile_symbol("fwd", q.dtype, packed, Dh))(
        _ptr(q), _ptr(k), _ptr(v), _ptr(out), _ptr(sin), _ptr(cos), _ptr(mask),
        _ptr(k_rot), _ptr(stats),
        B, H, Lq, Lk, Dh,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        float(scale), int(bool(causal)),
        _raw_stream(device),
    )
    if err != 0:
        raise RuntimeError(f"flash_fwd launch failed: CUDA error {err}")


def flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              out: torch.Tensor, do: torch.Tensor, stats: torch.Tensor,
              dq: torch.Tensor, dk: torch.Tensor, dv: torch.Tensor, *,
              sin: Optional[torch.Tensor], cos: Optional[torch.Tensor],
              kv_mask: Optional[torch.Tensor], causal: bool,
              scale: float, packed: bool = False) -> None:
    """Write the gradients of ``flash_fwd`` into ``dq``, ``dk``, ``dv``
    (views shaped like ``q``, ``k``, ``v``), from the output gradient
    ``do``, the forward's ``out`` and its ``stats``. ``packed``: the views
    are heads of packed ``[B, L, H*Dh]`` operands (K2); otherwise (K4, any
    lengths). The kernels are ``_tile_symbol``'s, as for ``flash_fwd``:
    the Hopper ones in bf16 at Dh 128 (packed) or 64 / 128, the wide
    Hopper ones in bf16 at Dh 256 to 512, for fp32 the register-tiled ones
    at Dh 64 / 128 and the fp32 SIMT ones above (``bwd_kernel_names``)."""
    _check_problem(q, k, v, sin, cos, kv_mask)
    mask = mask_arg(kv_mask, strided=False)
    device = q.device
    B, H, Lq, Dh = q.shape
    Lk = k.shape[2]
    _check_choice(q.dtype, packed, Dh)
    for name, t, like in (("out", out, q), ("do", do, q), ("dq", dq, q),
                          ("dk", dk, k), ("dv", dv, v)):
        if t.shape != like.shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {tuple(like.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out), ("do", do),
                    ("dq", dq), ("dk", dk), ("dv", dv)):
        _check_operand(name, t, device, q.dtype)
    if (stats.shape != (2, B, H, Lq) or stats.dtype != torch.float32
            or stats.device != device or not stats.is_contiguous()):
        raise ValueError(f"stats must be a contiguous float32 [2, {B}, {H}, {Lq}] "
                         f"tensor on {device}")
    lq_pad = -(-Lq // TILE) * TILE
    rows = torch.empty((3, B, H, lq_pad), dtype=torch.float32, device=device)
    q_rot = k_rot = ds_t = None
    if sin is not None:  # q and k are rotated once, by a pre-pass, into these
        q_rot = torch.empty((B, H, Lq, Dh), dtype=q.dtype, device=device)
        k_rot = torch.empty((B, H, Lk, Dh), dtype=q.dtype, device=device)
    if q.dtype == torch.float32 and Dh in REGTILE_DIMS:  # dS^T, dK/dV kernel -> dQ kernel
        ds_t = torch.empty((B, H, Lk, lq_pad), dtype=torch.float32, device=device)
    err = _bwd_fn(_tile_symbol("bwd", q.dtype, packed, Dh))(
        _ptr(q), _ptr(k), _ptr(v), _ptr(out), _ptr(do), _ptr(stats), _ptr(sin),
        _ptr(cos), _ptr(mask), _ptr(dq), _ptr(dk), _ptr(dv), _ptr(rows),
        _ptr(q_rot), _ptr(k_rot), _ptr(ds_t),
        B, H, Lq, Lk, Dh,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        *do.stride()[:3], *dq.stride()[:3], *dk.stride()[:3], *dv.stride()[:3],
        float(scale), int(bool(causal)),
        _raw_stream(device),
    )
    if err != 0:
        raise RuntimeError(f"flash_bwd launch failed: CUDA error {err}")


def flash_fwd_proj(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   wo: torch.Tensor, y: torch.Tensor, *,
                   out: Optional[torch.Tensor], stats: Optional[torch.Tensor],
                   sin: Optional[torch.Tensor], cos: Optional[torch.Tensor],
                   kv_mask: Optional[torch.Tensor], causal: bool,
                   scale: float) -> None:
    """Write ``concat_h(attention_h) @ wo`` into ``y`` ``[B, Lq, Dout]``
    (contiguous). ``q``/``k``/``v`` are ``[B, H, L, Dh]`` views of packed
    operands (bf16 or fp32, Dh a multiple of 128, ``H*Dh <= PROJ_MAX``),
    ``wo`` is ``[H*Dh, Dout]`` of their type, contiguous; the kernel is
    ``proj_symbol``'s. ``out`` (a ``[B, H, Lq, Dh]`` view) and ``stats``
    (fp32 ``[2, B, H, Lq]``) receive the attention output and the row
    statistics for the backward; both or neither are given. The wide bf16
    kernel reads ``wo`` padded to a multiple of 8 columns (a copy, where
    Dout is not one)."""
    _check_problem(q, k, v, sin, cos, kv_mask)
    mask = mask_arg(kv_mask, strided=False)
    device = q.device
    B, H, Lq, Dh = q.shape
    Lk = k.shape[2]
    D = H * Dh
    if wo.dim() != 2 or wo.shape[0] != D:
        raise ValueError(f"wo must be [{D}, Dout], got {tuple(wo.shape)}")
    Dout = wo.shape[1]
    symbol = proj_symbol(q.dtype, Dh, H, Dout)
    if (wo.dtype != q.dtype or wo.device != device or not wo.is_contiguous()
            or wo.data_ptr() % 16):
        raise ValueError(f"wo must be a contiguous {q.dtype} tensor on q's device")
    if (y.shape != (B, Lq, Dout) or y.dtype != q.dtype or y.device != device
            or not y.is_contiguous()):
        raise ValueError(f"y must be a contiguous {q.dtype} [{B}, {Lq}, {Dout}] tensor")
    if (out is None) != (stats is None):
        raise ValueError("out and stats are written together: give both or neither")
    operands = [("q", q), ("k", k), ("v", v)]
    if out is not None:
        if out.shape != q.shape:
            raise ValueError(f"out shape {tuple(out.shape)} != q {tuple(q.shape)}")
        operands.append(("out", out))
        if (stats.shape != (2, B, H, Lq) or stats.dtype != torch.float32
                or stats.device != device or not stats.is_contiguous()):
            raise ValueError(f"stats must be a contiguous float32 [2, {B}, {H}, {Lq}] "
                             f"tensor on {device}")
    for name, t in operands:
        _check_operand(name, t, device, q.dtype)
    if symbol == "deepcoro_flash_fwd_proj_wide_bf16" and Dout % 8:
        # TMA reads wo by rows of a multiple of 16 bytes: the entry takes it
        # padded to a multiple of 8 columns
        wo = torch.nn.functional.pad(wo, (0, 8 - Dout % 8))
    k_rot = None if sin is None else torch.empty(
        (B, H, Lk, Dh), dtype=q.dtype, device=device)
    err = _fwd_proj_fn(symbol)(
        _ptr(q), _ptr(k), _ptr(v), _ptr(wo), _ptr(y), _ptr(out), _ptr(sin),
        _ptr(cos), _ptr(mask), _ptr(k_rot), _ptr(stats),
        B, H, Lq, Lk, Dh, Dout,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *(out.stride()[:3] if out is not None else (0, 0, 0)),
        float(scale), int(bool(causal)),
        _raw_stream(device),
    )
    if err != 0:
        raise RuntimeError(f"flash_fwd_proj launch failed: CUDA error {err}")


def short_args(q, k, v, o, *, sin, cos, mask, causal: bool, stream: int,
               do=None, dq=None, dk=None, dv=None) -> bytes:
    """The argument block of ``csrc/flash_short.cu`` for one call: 64-bit
    integers in the order of its ``ShortArg`` (``A_*`` here). ``q``, ``k``,
    ``v`` and ``do`` go with their (batch, head, row) strides; ``o``,
    ``dq``, ``dk``, ``dv`` are contiguous ``[B, H, L, Dh]`` tensors; ``mask``
    is what ``mask_arg(..., strided=True)`` returned, passed with its batch
    stride."""
    B, H, Lq, Dh = q.shape
    none = (0, 0, 0)
    return _ARGS.pack(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        0 if do is None else do.data_ptr(), 0 if dq is None else dq.data_ptr(),
        0 if dk is None else dk.data_ptr(), 0 if dv is None else dv.data_ptr(),
        0 if mask is None else mask.data_ptr(), 0 if sin is None else sin.data_ptr(),
        0 if cos is None else cos.data_ptr(), stream,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *(none if do is None else do.stride()[:3]),
        0 if mask is None else mask.stride(0), B, H, Lq, k.shape[2], Dh, int(causal))


def _short_operand(name: str, t: torch.Tensor, device, dtype) -> torch.Tensor:
    """An input of the short kernels, which copy 16 bytes at a time: bf16
    ones must allow it, as ``_check_operand`` holds them; an fp32 one that
    does not is copied once."""
    if t.device != device or t.dtype != dtype or not _aligned(t):
        _check_operand(name, t, device, dtype)  # raises where the kernel cannot read t
        return torch.empty(t.shape, dtype=dtype, device=device).copy_(t)
    return t


def _short_launch(symbol: str, args: bytes, scale: float) -> None:
    err = _short_fn(symbol)(args, scale)
    if err != 0:
        raise RuntimeError(f"{symbol} launch failed: CUDA error {err}")


def short_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  sin: Optional[torch.Tensor], cos: Optional[torch.Tensor],
                  kv_mask: Optional[torch.Tensor], causal: bool, scale: float):
    """The ``[B, H, L, Dh]`` forward at Lq, Lk <= ``SHORT_MAX``: one launch
    of ``csrc/flash_short.cu``. Returns the output (contiguous ``[B, H, Lq,
    Dh]``) and, for ``short_backward``, the mask and q, k, v as the kernel
    read them. Writes no row statistics: the short backward rebuilds them."""
    _check_problem(q, k, v, sin, cos, kv_mask)
    B, H, Lq, Dh = q.shape
    symbol = fwd_symbol(q.dtype, False, Lq, k.shape[2], Dh)
    if not symbol.startswith("deepcoro_flash_short"):
        raise ValueError(f"the short kernels take Lq, Lk <= {SHORT_MAX} and Dh <= "
                         f"{HOPPER_DIMS[-1]}, got {Lq}, {k.shape[2]}, Dh {Dh}")
    device, dtype = q.device, q.dtype
    q, k, v = (_short_operand(n, t, device, dtype) for n, t in (("q", q), ("k", k), ("v", v)))
    mask = mask_arg(kv_mask, strided=True)
    out = torch.empty((B, H, Lq, Dh), dtype=dtype, device=device)
    _short_launch(symbol, short_args(q, k, v, out, sin=sin, cos=cos, mask=mask,
                                     causal=causal, stream=_raw_stream(device)), float(scale))
    return out, mask, q, k, v


def short_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                   do: torch.Tensor, sin: Optional[torch.Tensor],
                   cos: Optional[torch.Tensor], mask: Optional[torch.Tensor],
                   causal: bool, scale: float):
    """The gradients ``(dq, dk, dv)`` (contiguous) of ``short_forward``'s
    call with the same ``sin``, ``cos``, from the ``out``, ``mask``, ``q``,
    ``k``, ``v`` it returned, for the output gradient ``do``, in one launch
    of ``csrc/flash_short.cu``: no row statistics, no scratch. Only ``do``
    is checked: the rest passed the forward's checks, and autograd keeps
    saved tensors from changing."""
    device, dtype = q.device, q.dtype
    if do.shape != out.shape:
        raise ValueError(f"do shape {tuple(do.shape)} != out {tuple(out.shape)}")
    if do.device != device or do.dtype != dtype or not _aligned(do):
        # the gradient arrives with any strides (and type)
        do = torch.empty(do.shape, dtype=dtype, device=device).copy_(do)
    grads = tuple(torch.empty_like(t, memory_format=torch.contiguous_format)
                  for t in (q, k, v))
    dq, dk, dv = grads
    _short_launch(bwd_symbol(dtype, False, q.shape[2], k.shape[2], q.shape[3]), short_args(
        q, k, v, out, sin=sin, cos=cos, mask=mask, causal=causal,
        stream=_raw_stream(device), do=do, dq=dq, dk=dk, dv=dv), float(scale))
    return grads


class ShortAttention(torch.autograd.Function):
    """The ``[B, H, L, Dh]`` entry at Lq, Lk <= ``SHORT_MAX`` on the card,
    when a gradient is wanted: ``short_forward`` and ``short_backward``,
    one launch each, with less glue than ``FlashAttention`` (no layouts, no
    statistics; measured by ``chip_smoke.py`` phase 21). ``counter`` counts
    the launches as in ``FlashAttention``."""

    @staticmethod
    def forward(ctx, q, k, v, sin, cos, kv_mask, causal, scale, counter):
        out, mask, q, k, v = short_forward(q, k, v, sin, cos, kv_mask, causal, scale)
        counter.launches += 1
        ctx.save_for_backward(q, k, v, out, sin, cos, mask)
        ctx.args = (causal, scale, counter)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        q, k, v, out, sin, cos, mask = ctx.saved_tensors
        causal, scale, counter = ctx.args
        need = ctx.needs_input_grad[:3]
        if not any(need):
            return (None,) * 9
        grads = short_backward(q, k, v, out, grad_out, sin, cos, mask, causal, scale)
        counter.bwd_launches += 1
        return tuple(g if n else None for g, n in zip(grads, need)) + (None,) * 6


def _heads(t: torch.Tensor, H: int) -> torch.Tensor:
    """[B, L, H*Dh] (any row stride) -> [B, H, L, Dh] view, no copy."""
    return t.unflatten(2, (H, t.shape[2] // H)).permute(0, 2, 1, 3)


def _packed(t: torch.Tensor) -> torch.Tensor:
    """[B, H, L, Dh] -> [B, L, H*Dh]."""
    return t.permute(0, 2, 1, 3).flatten(2)


def head_views(a, b, c, layout: str, H: int):
    """The ``[B, H, L, Dh]`` views of the operands of one layout:
    ``"heads"`` (already so), ``"packed"`` (``[B, L, H*Dh]`` each) or
    ``"fused"`` (``a`` is one ``[B, L, 3*H*Dh]`` q|k|v tensor)."""
    if layout == "heads":
        return a, b, c
    if layout == "fused":
        D = a.shape[2] // 3
        a, b, c = a[..., :D], a[..., D:2 * D], a[..., 2 * D:]
    return _heads(a, H), _heads(b, H), _heads(c, H)


def _is_long(layout: str, dtype: torch.dtype, Dh: int) -> bool:
    """Whether a ``[B, H, L, Dh]`` call past the short lengths runs K3's or
    K4's long Hopper kernels (bf16 at Dh 64 / 128)."""
    return layout == "heads" and dtype == torch.bfloat16 and Dh in HOPPER_DIMS


def attention_forward(a, b, c, sin, cos, kv_mask, causal, scale, layout, H,
                      counter, stats: bool):
    """Forward of one layout: returns ``(out, stats or None)`` with ``out``
    in the layout of the inputs. Launches the kernel on a CUDA tensor and
    counts it on ``counter.launches`` (a long bf16 ``[B, H, L, Dh]`` call
    at Dh 64 / 128, K3's Hopper kernel, on ``counter.long_launches`` too);
    runs the plain version on a CPU tensor."""
    qh, kh, vh = head_views(a, b, c, layout, H)
    B, _, Lq, Dh = qh.shape
    if qh.device.type == "cpu":
        m = None if kv_mask is None else kv_mask != 0
        out = multi_head_attention(qh, kh, vh, sin=sin, cos=cos, kv_mask=m,
                                   causal=causal, scale=scale)
        return (out if layout == "heads" else _packed(out)), None
    if layout == "heads":
        if is_short(False, Lq, kh.shape[2], Dh):  # no statistics: the backward rebuilds them
            out = short_forward(qh, kh, vh, sin, cos, kv_mask, causal, scale)[0]
            counter.launches += 1
            return out, None
        out = torch.empty((B, H, Lq, Dh), dtype=qh.dtype, device=qh.device)
        oh = out
    else:
        out = torch.empty((B, Lq, H * Dh), dtype=qh.dtype, device=qh.device)
        oh = _heads(out, H)
    st = torch.empty((2, B, H, Lq), dtype=torch.float32,
                     device=qh.device) if stats else None
    flash_fwd(qh, kh, vh, oh, sin=sin, cos=cos, kv_mask=kv_mask, causal=causal,
              scale=scale, stats=st, packed=layout != "heads")
    counter.launches += 1
    if _is_long(layout, qh.dtype, Dh):
        counter.long_launches += 1
    return out, st


def attention_backward(a, b, c, out, stats, grad_out, sin, cos, kv_mask, causal,
                       scale, layout, H, counter):
    """Gradients of the attention for the gradient ``grad_out`` of its
    output ``out`` (both in the layout of the inputs): ``(da, db, dc)`` in
    that layout, ``(dqkv, None, None)`` for ``"fused"``. Launches the
    backward kernels on a CUDA tensor and counts them on
    ``counter.bwd_launches`` (a long bf16 ``[B, H, L, Dh]`` call at Dh 64 /
    128, K4's Hopper kernels, on ``counter.long_bwd_launches`` too); runs
    the plain version on a CPU tensor."""
    def to_heads(t):
        return t if layout == "heads" else _heads(t, H)

    qh, kh, vh = head_views(a, b, c, layout, H)
    oh = to_heads(out)
    gh = to_heads(grad_out.to(out.dtype))
    if a.device.type == "cpu":
        m = None if kv_mask is None else kv_mask != 0
        dq, dk, dv = flash_bwd_plain(qh, kh, vh, gh, oh, sin=sin, cos=cos,
                                     kv_mask=m, causal=causal, scale=scale)
        if layout == "heads":
            return dq, dk, dv
        flat = [_packed(g) for g in (dq, dk, dv)]
        return ((torch.cat(flat, dim=-1), None, None)
                if layout == "fused" else tuple(flat))
    if not _aligned(gh):  # the gradient arrives with any strides
        gh = to_heads(grad_out.to(out.dtype).contiguous())
    if layout == "fused":
        # one [B, L, 3D] gradient; the kernels write q|k|v's parts
        # through strided views, nothing is concatenated
        da = torch.empty_like(a, memory_format=torch.contiguous_format)
        grads = (da, None, None)
        dviews = head_views(da, None, None, layout, H)
    else:
        grads = tuple(torch.empty_like(
            t, memory_format=torch.contiguous_format) for t in (a, b, c))
        dviews = head_views(*grads, layout, H)
    flash_bwd(qh, kh, vh, oh, gh, stats, *dviews, sin=sin, cos=cos,
              kv_mask=kv_mask, causal=causal, scale=scale, packed=layout != "heads")
    counter.bwd_launches += 1
    if _is_long(layout, qh.dtype, qh.shape[3]):
        counter.long_bwd_launches += 1
    return grads


class FlashAttention(torch.autograd.Function):
    """Attention with the CUDA kernels (or, on the CPU, the plain versions)
    as forward and backward. Inputs ``a, b, c`` are q, k, v in ``layout``
    (``b`` and ``c`` are None for ``"fused"``); ``counter`` is the entry
    point whose ``launches`` / ``bwd_launches`` count the kernel launches."""

    @staticmethod
    def forward(ctx, a, b, c, sin, cos, kv_mask, causal, scale, layout, H, counter):
        out, stats = attention_forward(a, b, c, sin, cos, kv_mask, causal, scale,
                                       layout, H, counter, stats=True)
        ctx.save_for_backward(a, b, c, out, stats, sin, cos, kv_mask)
        ctx.args = (causal, scale, layout, H, counter)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        a, b, c, out, stats, sin, cos, kv_mask = ctx.saved_tensors
        need = ctx.needs_input_grad[:3]
        if not any(need):
            return (None,) * 11
        grads = attention_backward(a, b, c, out, stats, grad_out, sin, cos, kv_mask,
                                   *ctx.args)
        grads = tuple(g if n else None for g, n in zip(grads, need))
        return grads + (None,) * 8


def attention_proj_forward(a, b, c, wo, sin, cos, kv_mask, causal, scale, layout, H,
                           counter, residuals: bool):
    """Forward of the fused projection for a packed layout: returns
    ``(y, out or None, stats or None)`` with ``y`` ``[B, Lq, Dout]``.
    Launches the kernel on a CUDA tensor and counts it on
    ``counter.proj_launches``; runs the plain versions on a CPU tensor.
    ``out`` (the attention output, the backward's residual) and ``stats``
    are produced only with ``residuals``."""
    qh, kh, vh = head_views(a, b, c, layout, H)
    B, _, Lq, Dh = qh.shape
    if qh.device.type == "cpu":
        m = None if kv_mask is None else kv_mask != 0
        out = _packed(multi_head_attention(qh, kh, vh, sin=sin, cos=cos, kv_mask=m,
                                           causal=causal, scale=scale))
        return project_plain(out, wo), (out if residuals else None), None
    y = torch.empty((B, Lq, wo.shape[1]), dtype=qh.dtype, device=qh.device)
    out = st = oh = None
    if residuals:
        out = torch.empty((B, Lq, H * Dh), dtype=qh.dtype, device=qh.device)
        oh = _heads(out, H)
        st = torch.empty((2, B, H, Lq), dtype=torch.float32, device=qh.device)
    flash_fwd_proj(qh, kh, vh, wo, y, out=oh, stats=st, sin=sin, cos=cos,
                   kv_mask=kv_mask, causal=causal, scale=scale)
    counter.proj_launches += 1
    return y, out, st


class FlashAttentionProj(torch.autograd.Function):
    """Packed attention with the output projection ``wo`` ``[D, Dout]`` fused
    into the forward kernel. The backward un-projects the gradient
    (``do = gy @ wo^T``) and forms ``dwo = out^T gy`` with two matrix
    products, as the JAX package leaves them to XLA, and hands ``do`` to the
    backward kernels of the unfused attention."""

    @staticmethod
    def forward(ctx, a, b, c, wo, sin, cos, kv_mask, causal, scale, layout, H, counter):
        y, out, stats = attention_proj_forward(a, b, c, wo, sin, cos, kv_mask, causal,
                                               scale, layout, H, counter, residuals=True)
        ctx.save_for_backward(a, b, c, wo, out, stats, sin, cos, kv_mask)
        ctx.args = (causal, scale, layout, H, counter)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_y):
        a, b, c, wo, out, stats, sin, cos, kv_mask = ctx.saved_tensors
        need = ctx.needs_input_grad[:4]
        gy = grad_y.to(out.dtype)
        dwo = None
        if need[3]:  # summed in fp32 by the product, rounded once to wo's type
            dwo = torch.matmul(out.flatten(0, 1).t(), gy.flatten(0, 1))
        grads = (None, None, None)
        if any(need[:3]):
            do = torch.matmul(gy, wo.t())
            grads = attention_backward(a, b, c, out, stats, do, sin, cos, kv_mask,
                                       *ctx.args)
            grads = tuple(g if n else None for g, n in zip(grads, need))
        return grads + (dwo,) + (None,) * 8


def attention(a, b, c, *, sin, cos, kv_mask, causal, scale, layout, H, counter):
    """Attention of one layout, through ``FlashAttention`` (or, for a short
    ``[B, H, L, Dh]`` call on the card, ``ShortAttention``) when a gradient
    is wanted, and otherwise through the operator ``deepcoro::attention``
    (``ops/library.py``: the forward without row statistics, which counts
    on the layout's entry point; ``torch.export`` keeps it whole)."""
    wants_grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (a, b, c))
    if not wants_grad:
        return library.attention(a, b, c, sin, cos, kv_mask, causal, scale, layout, H)
    if layout == "heads" and a.is_cuda and is_short(False, a.shape[2], b.shape[2], a.shape[3]):
        return ShortAttention.apply(a, b, c, sin, cos, kv_mask, causal, scale, counter)
    return FlashAttention.apply(a, b, c, sin, cos, kv_mask, causal, scale,
                                layout, H, counter)


def attention_proj(a, b, c, wo, *, sin, cos, kv_mask, causal, scale, layout, H,
                   counter):
    """Packed attention followed by the projection ``wo`` ``[D, Dout]``, in
    one kernel on the card: through ``FlashAttentionProj`` when a gradient
    is wanted, otherwise through the operator ``deepcoro::attention_proj``
    (then neither the attention output nor the row statistics are
    written)."""
    wants_grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (a, b, c, wo))
    if wants_grad:
        return FlashAttentionProj.apply(a, b, c, wo, sin, cos, kv_mask, causal,
                                        scale, layout, H, counter)
    return library.attention_proj(a, b, c, wo, sin, cos, kv_mask, causal, scale, layout, H)


# the operators of the no-grad calls; imported last, as ops/library.py
# builds them on this module's forwards
from deepcoro_clip_tpu_torch.ops import library  # noqa: E402
