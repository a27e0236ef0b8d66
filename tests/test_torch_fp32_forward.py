"""The register-tiled fp32 forward kernels (``csrc/fwd_f32_regtile.cuh``) on
the CPU: which calls reach them, and whether their shared memory fits.

fp32 K1 and K3 at Dh 64 and 128 run ``flash_fwd_f32_regtile_kernel<Dh>``
behind the C entry ``deepcoro_flash_fwd_f32`` (which routes by Dh), fp32 K5
at Dh 128 ``flash_fwd_proj_f32_regtile_kernel`` behind
``deepcoro_flash_fwd_proj_f32``. Wider fp32 heads, the wide-bf16 routes,
the bf16 Hopper kernels, the backward and the ring keep their kernels.
``_flash_cuda.fwd_kernel_name`` / ``proj_kernel_name`` mirror the routing,
``regtile_smem_bytes`` the kernels' dynamic shared memory, which must stay
within ``SMEM_MAX`` (232,448 bytes a block on an H100: a launch above it is
refused on the card) at every ``(Dh, H*Dh, Dout)`` the routes take. The
mirrors are held against the constants and the switch of the CUDA sources,
so the two cannot drift apart unnoticed. The
kernels themselves run only on the card: ``tests/test_torch_cuda.py``
(``test_regtile_*``) and ``chip_smoke.py`` phases 39 to 41.
"""

import re
from pathlib import Path

import pytest
import torch

import chip_smoke
from deepcoro_clip_tpu_torch.ops import _flash_cuda, _ring_cuda
from deepcoro_clip_tpu_torch.ops._flash_cuda import (
    PROJ_MAX,
    REGTILE_DIMS,
    SMEM_MAX,
    fwd_kernel_name,
    fwd_symbol,
    proj_kernel_name,
    proj_symbol,
    regtile_smem_bytes,
)

F32, BF16 = torch.float32, torch.bfloat16
CSRC = Path(_flash_cuda.__file__).resolve().parents[1] / "csrc"


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("L", [1569, 393, 128, 65])
@pytest.mark.parametrize("dh", REGTILE_DIMS)
def test_fp32_forward_runs_the_register_tiled_kernel(packed, L, dh):
    """fp32 K1 (packed, Dh 128) and K3 (``[B, H, L, Dh]`` past the short
    lengths) at Dh 64 and 128, Lq = Lk and not."""
    if packed and dh % 128:
        with pytest.raises(ValueError, match="Dh % 128"):
            fwd_symbol(F32, packed, L, L, dh)
        return
    for lk in (L, 77):
        assert fwd_symbol(F32, packed, L, lk, dh) == "deepcoro_flash_fwd_f32"
        assert fwd_kernel_name(F32, packed, L, lk, dh) == f"flash_fwd_f32_regtile_kernel<{dh}>"


@pytest.mark.parametrize("dtype,packed,L,dh,kernel", [
    (F32, False, 64, 64, "flash_short_fwd_f32_kernel"),    # short: one launch of flash_short.cu
    (F32, False, 1, 128, "flash_short_fwd_f32_kernel"),
    (F32, True, 1, 128, "flash_fwd_f32_regtile_kernel<128>"),  # packed: never short
    (F32, True, 393, 256, "flash_fwd_f32_kernel<256>"),
    (F32, False, 512, 384, "flash_fwd_f32_kernel<384>"),
    (F32, True, 1569, 512, "flash_fwd_f32_kernel<512>"),
    (BF16, True, 1569, 128, "flash_fwd_sm90_kernel"),
    (BF16, False, 512, 64, "flash_long_fwd_kernel<64>"),
    (BF16, False, 10, 64, "flash_short_fwd_bf16_kernel"),
    (BF16, True, 393, 256, "flash_fwd_wide_sm90_kernel<256>"),
    (BF16, False, 10, 512, "flash_fwd_wide_sm90_kernel<512>"),
])
def test_other_forward_routes_keep_their_kernels(dtype, packed, L, dh, kernel):
    """Short calls, fp32 past Dh 128, the bf16 Hopper, long and wide
    kernels: as before the register-tiled kernels came (the wide bf16
    forward on its Hopper kernel since)."""
    assert fwd_kernel_name(dtype, packed, L, L, dh) == kernel


@pytest.mark.parametrize("dtype,packed,dh,symbol", [
    (F32, True, 128, "deepcoro_flash_bwd_f32"), (F32, False, 64, "deepcoro_flash_bwd_f32"),
    (F32, True, 512, "deepcoro_flash_bwd_f32"),
    (BF16, True, 128, "deepcoro_flash_bwd_sm90_bf16"),
    (BF16, False, 128, "deepcoro_flash_long_bwd_bf16"),
    (BF16, True, 256, "deepcoro_flash_wide_bwd_bf16"),
])
def test_backward_routes_unchanged(dtype, packed, dh, symbol):
    """The backward (K2, K4) reads the new forward's statistics but keeps
    its kernels."""
    assert _flash_cuda.bwd_symbol(dtype, packed, 393, 393, dh) == symbol


@pytest.mark.parametrize("dh", [64, 128, 256, 384, 512])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_ring_step_unchanged(dh, dtype):
    """K6 keeps its step kernels (the fp32 one on ``simt_attend_tiles``,
    whose carried state has the old accumulator layout)."""
    want = ("deepcoro_ring_step_f32" if dtype == F32 else
            "deepcoro_ring_step_wide_bf16" if dh > 128 else
            "deepcoro_ring_step_sm90_bf16" if dh == 128 else "deepcoro_ring_step_bf16")
    assert _ring_cuda.step_symbol(dh, dtype) == want


@pytest.mark.parametrize("dtype,dh,H,dout,kernel", [
    (F32, 128, 4, 512, "flash_fwd_proj_f32_regtile_kernel"),   # the probing encoder
    (F32, 128, 8, 512, "flash_fwd_proj_f32_regtile_kernel"),   # H*Dh 1024
    (F32, 128, 2, 300, "flash_fwd_proj_f32_regtile_kernel"),   # a ragged Dout
    (F32, 128, 6, 768, "flash_fwd_proj_f32_regtile_kernel"),   # H*Dh 768, Dout 768
    (F32, 128, 1, 1, "flash_fwd_proj_f32_regtile_kernel"),
    (F32, 256, 2, 512, "flash_fwd_proj_f32_kernel<256>"),
    (F32, 512, 2, 300, "flash_fwd_proj_f32_kernel<512>"),
    (BF16, 128, 4, 512, "flash_fwd_proj_kernel<2>"),
    (BF16, 128, 6, 768, "flash_fwd_proj_kernel<1>"),
    (BF16, 256, 2, 512, "flash_fwd_proj_wide_sm90_kernel<256>"),
])
def test_fused_projection_kernel_by_route(dtype, dh, H, dout, kernel):
    """K5 in fp32 at Dh 128 on the register-tiled kernel at any H*Dh up to
    1024 and any Dout; the other routes as they were."""
    assert proj_kernel_name(dtype, dh, H, dout) == kernel
    want = ("deepcoro_flash_fwd_proj_f32" if dtype == F32 else
            "deepcoro_flash_fwd_proj_wide_bf16" if dh > 128 else "deepcoro_flash_fwd_proj_bf16")
    assert proj_symbol(dtype, dh, H, dout) == want


def test_fused_projection_still_raises_past_its_width():
    with pytest.raises(ValueError, match="H\\*Dh <= 1024"):
        proj_kernel_name(F32, 128, PROJ_MAX // 128 + 1, 512)


@pytest.mark.parametrize("dh,want", [(64, 51_200), (128, 100_352)])
def test_forward_shared_memory(dh, want):
    """The Q, K and V tiles: two blocks an SM at Dh 128 (228 KB an SM, 1 KB
    of it reserved a block), four at 64."""
    got = regtile_smem_bytes(dh)
    assert got == want <= SMEM_MAX
    assert (got + 1024) * (2 if dh == 128 else 4) <= 228 * 1024


@pytest.mark.parametrize("dout", [1, 7, 128, 129, 300, 384, 500, 512, 513, 768, 1000, 2048,
                                  4096])
@pytest.mark.parametrize("H", list(range(1, PROJ_MAX // 128 + 1)))
def test_fused_projection_shared_memory_fits(H, dout):
    """K5 at every H*Dh the route takes (128 to 1024) and every Dout runs
    the register-tiled kernel in the body's 66 KB at 32 keys a tile: its wo
    slabs take the K and V tiles' place, the head's output the Q tile's,
    and y's running sum waits in y, so nothing grows with H or Dout."""
    assert proj_kernel_name(F32, 128, H, dout) == "flash_fwd_proj_f32_regtile_kernel"
    got = regtile_smem_bytes(128, _flash_cuda.REGTILE_PROJ_KEYS)
    assert got == 67_072 <= SMEM_MAX
    assert 2 * (got + 1024) <= 228 * 1024  # two blocks an SM
    # two [32, 128] fp32 slabs of wo fit where K [32][132] and V [32][128] were
    assert 2 * 32 * 128 * 4 <= 4 * 32 * (132 + 128)


def _constants(text: str) -> dict:
    return {k: int(v) for k, v in re.findall(r"constexpr int (RT_\w+) = (\d+);", text)}


def test_mirror_matches_the_cuda_sources():
    """The Python mirror's tile constants are the header's, and the fp32 C
    entries route Dh 64 / 128 (K1, K3) and 128 (K5) to the new kernels."""
    head = (CSRC / "fwd_f32_regtile.cuh").read_text()
    proj = (CSRC / "flash_fwd_proj.cu").read_text()
    fwd = (CSRC / "flash_fwd.cu").read_text()
    c = {**_constants(head), **_constants(proj)}
    assert c["RT_BQ"] == _flash_cuda.REGTILE_ROWS
    assert c["RT_BK"] == _flash_cuda.REGTILE_KEYS
    assert c["RT_PAD"] == _flash_cuda.REGTILE_PAD
    assert c["RT_PROJ_BK"] == _flash_cuda.REGTILE_PROJ_KEYS
    assert c["RT_WCOLS"] == 128 and c["RT_WROWS"] == 32
    entry = fwd[fwd.index("int deepcoro_flash_fwd_f32(FWD_ARGS)"):]
    entry = entry[:entry.index("\n}\n")]
    for dh in REGTILE_DIMS:
        assert f"case {dh}: return static_cast<int>(launch_regtile<{dh}>" in entry
    for dh in (256, 384, 512):
        assert f"launch_simt<float, {dh}>" in entry
    simt = proj[proj.index("int proj_simt(PROJ_ARGS)"):]
    case = simt[simt.index("case 128:"):simt.index("case 256:")]
    assert "launch_proj_regtile(p, st)" in case


def test_chip_smoke_names_the_new_kernels():
    """The traces of phases 39 to 41 look the kernels up by these names."""
    assert chip_smoke.REGTILE_FWD == ("flash_fwd_f32_regtile_kernel",)
    assert chip_smoke.REGTILE_PROJ == ("flash_fwd_proj_f32_regtile_kernel",)
    for dh in REGTILE_DIMS:
        assert chip_smoke.REGTILE_FWD[0] in fwd_kernel_name(F32, False, 393, 393, dh)
    assert chip_smoke.REGTILE_PROJ[0] in proj_kernel_name(F32, 128, 4, 512)
    # the old SIMT names are not substrings of the new ones (a trace lookup
    # by substring keeps them apart)
    assert chip_smoke.SIMT_FWD["float32"][0] not in chip_smoke.REGTILE_FWD[0]
    assert chip_smoke.SIMT_PROJ["float32"][0] not in chip_smoke.REGTILE_PROJ[0]
