"""The wide bf16 forward on the tensor cores, on the CPU: which calls reach
its kernels, whether their shared memory fits, and the plain versions they
are held to on the card against the JAX package.

bf16 K1 (packed and fused) and K3 (``[B, H, L, Dh]``, the widths a head
dim is padded to above 128) at Dh 256, 384 and 512 run
``flash_fwd_wide_sm90_kernel<Dh>`` behind the C entry
``deepcoro_flash_wide_fwd_bf16``; bf16 K5 there runs
``flash_fwd_proj_wide_sm90_kernel<Dh>`` behind
``deepcoro_flash_fwd_proj_wide_bf16``, at every ``H*Dh <= 1024`` and every
Dout. The fp32 routes, the bf16 Hopper kernels at Dh 64 and 128 and the
ring keep their kernels; the wide backward runs its own Hopper kernels
(``tests/test_torch_wide_backward.py``). ``_flash_cuda.fwd_kernel_name``
/ ``proj_kernel_name`` mirror the routing, ``wide_smem_bytes`` /
``wide_proj_smem_bytes`` the kernels' dynamic shared memory, which must
stay within ``SMEM_MAX`` (232,448 bytes a block on an H100) at every
shape the routes take; the mirrors are held against the CUDA sources. The
kernels run only on the card: ``tests/test_torch_cuda.py``
(``test_wide_*``) and ``chip_smoke.py`` phases 39 and 42.

Tolerance of the plain bf16 versions against the JAX functions in
interpret mode: atol 2e-2, rtol 2e-2 (both round q, k, v, P and the
output to bf16, at other places: ``tests/test_torch_ops.py``'s bf16 bar).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from deepcoro_clip_tpu.ops import flash_attention_packed as jfap
from deepcoro_clip_tpu_torch.ops import _flash_cuda, _ring_cuda
from deepcoro_clip_tpu_torch.ops._flash_cuda import (
    PROJ_MAX,
    SMEM_MAX,
    WIDE_DIMS,
    WIDE_FWD_TILES,
    WIDE_PROJ_TILES,
    bwd_kernel_names,
    fwd_kernel_name,
    fwd_symbol,
    proj_kernel_name,
    proj_symbol,
    wide_proj_smem_bytes,
    wide_smem_bytes,
)
from deepcoro_clip_tpu_torch.ops.flash_attention import kernel_head_dim
from deepcoro_clip_tpu_torch.ops.flash_attention_packed import flash_attention_packed
from deepcoro_clip_tpu_torch.ops.rope3d import build_rope3d_tables

F32, BF16 = torch.float32, torch.bfloat16
CSRC = Path(_flash_cuda.__file__).resolve().parents[1] / "csrc"
OLD_FWD, OLD_PROJ = "flash_fwd_wide_bf16_kernel", "flash_fwd_proj_wide_bf16_kernel"
JAX_TOL = dict(atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("Lq,Lk", [(1569, 1569), (393, 393), (65, 65), (1, 1), (1, 393),
                                   (130, 70), (10, 10)])
@pytest.mark.parametrize("dh", WIDE_DIMS)
def test_wide_bf16_forward_runs_the_hopper_kernel(dh, Lq, Lk, packed):
    """bf16 K1 (packed, fused: the same views) and K3 at Dh 256 to 512, at
    every length (a short ``[B, H, L, Dh]`` call at these widths too: the
    short kernels take Dh <= 128), Lq = Lk and not."""
    assert fwd_symbol(BF16, packed, Lq, Lk, dh) == "deepcoro_flash_wide_fwd_bf16"
    assert fwd_kernel_name(BF16, packed, Lq, Lk, dh) == f"flash_fwd_wide_sm90_kernel<{dh}>"


@pytest.mark.parametrize("dh,width", [(136, 256), (192, 256), (256, 256), (320, 384),
                                      (384, 384), (448, 512), (500, 512)])
def test_padded_k3_widths_run_the_wide_kernel(dh, width):
    """K3 at a head dim padded above 128 (``pad_head_dim`` to
    ``kernel_head_dim``) runs the wide kernel at the padded width."""
    assert kernel_head_dim(dh) == width
    assert fwd_kernel_name(BF16, False, 512, 512, width) == f"flash_fwd_wide_sm90_kernel<{width}>"


PROJ_CASES = [(dh, h) for dh in WIDE_DIMS for h in range(1, PROJ_MAX // dh + 1)]


@pytest.mark.parametrize("dout", [1, 7, 96, 100, 128, 320, 512, 513, 1000])
@pytest.mark.parametrize("dh,H", PROJ_CASES)
def test_wide_fused_projection_runs_the_hopper_kernel(dh, H, dout):
    """bf16 K5 at every ``H*Dh <= 1024`` of Dh 256 to 512 and any Dout, on
    and off the 128 grid: the wide kernel of Dh, whatever H and Dout."""
    assert proj_symbol(BF16, dh, H, dout) == "deepcoro_flash_fwd_proj_wide_bf16"
    assert proj_kernel_name(BF16, dh, H, dout) == f"flash_fwd_proj_wide_sm90_kernel<{dh}>"


@pytest.mark.parametrize("dh", WIDE_DIMS)
def test_wide_fused_projection_still_raises_past_its_width(dh):
    with pytest.raises(ValueError, match="H\\*Dh <= 1024"):
        proj_kernel_name(BF16, dh, PROJ_MAX // dh + 1, 512)


@pytest.mark.parametrize("dtype,packed,L,dh,kernel", [
    (F32, True, 393, 128, "flash_fwd_f32_regtile_kernel<128>"),
    (F32, False, 393, 64, "flash_fwd_f32_regtile_kernel<64>"),
    (F32, True, 1569, 256, "flash_fwd_f32_kernel<256>"),
    (F32, False, 512, 384, "flash_fwd_f32_kernel<384>"),
    (F32, True, 393, 512, "flash_fwd_f32_kernel<512>"),
    (F32, False, 10, 64, "flash_short_fwd_f32_kernel"),
    (BF16, True, 1569, 128, "flash_fwd_sm90_kernel"),
    (BF16, False, 512, 64, "flash_long_fwd_kernel<64>"),
    (BF16, False, 393, 128, "flash_long_fwd_kernel<128>"),
    (BF16, False, 10, 64, "flash_short_fwd_bf16_kernel"),
    (BF16, False, 64, 128, "flash_short_fwd_bf16_kernel"),
])
def test_other_forward_routes_keep_their_kernels(dtype, packed, L, dh, kernel):
    """fp32 at every head dim, bf16 at Dh 64 and 128 and the short calls:
    as before."""
    assert fwd_kernel_name(dtype, packed, L, L, dh) == kernel


@pytest.mark.parametrize("dtype,dh,H,dout,kernel", [
    (BF16, 128, 4, 512, "flash_fwd_proj_kernel<2>"),
    (BF16, 128, 8, 512, "flash_fwd_proj_kernel<1>"),
    (F32, 128, 4, 512, "flash_fwd_proj_f32_regtile_kernel"),
    (F32, 256, 2, 512, "flash_fwd_proj_f32_kernel<256>"),
    (F32, 512, 2, 300, "flash_fwd_proj_f32_kernel<512>"),
])
def test_other_projection_routes_keep_their_kernels(dtype, dh, H, dout, kernel):
    assert proj_kernel_name(dtype, dh, H, dout) == kernel


def test_hopper_projection_at_dh_128_still_takes_the_128_grid():
    with pytest.raises(ValueError, match="Dout % 128 == 0"):
        proj_symbol(BF16, 128, 4, 96)


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("dh", WIDE_DIMS)
def test_wide_backward_keeps_its_kernels(dh, packed):
    """The backward at Dh 256 to 512 reads the new forward's statistics and
    runs the wide Hopper backward (``tests/test_torch_wide_backward.py``)."""
    assert _flash_cuda.bwd_symbol(BF16, packed, 393, 393, dh) == "deepcoro_flash_wide_bwd_bf16"
    assert bwd_kernel_names(BF16, packed, 393, 393, dh) == (
        f"flash_bwd_dkv_wide_sm90_kernel<{dh}>", f"flash_bwd_dq_wide_sm90_kernel<{dh}>")


@pytest.mark.parametrize("dh", [64, 128, 256, 384, 512])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_ring_step_keeps_its_kernels(dh, dtype):
    want = ("deepcoro_ring_step_f32" if dtype == F32 else
            "deepcoro_ring_step_wide_bf16" if dh > 128 else
            "deepcoro_ring_step_sm90_bf16" if dh == 128 else "deepcoro_ring_step_bf16")
    assert _ring_cuda.step_symbol(dh, dtype) == want


@pytest.mark.parametrize("dh,want", [(256, 197_824), (384, 230_576), (512, 230_528)])
def test_wide_forward_shared_memory(dh, want):
    """The q tile, the K/V ring, the mask bytes and the barriers: 192 KB of
    tiles at every width (a 128-row q tile and two stages of 64 keys at
    256; a 64-row tile and three / two stages of 32 keys at 384 / 512, and
    there 32 KB of the two warpgroups' partial S)."""
    rows, keys, stages, split = WIDE_FWD_TILES[dh]
    assert rows * split == 128  # 64 rows a warpgroup, or shared by two
    assert (dh // 64) * rows * 128 + stages * 4 * keys * dh == 192 * 1024
    assert wide_smem_bytes(dh) == want <= SMEM_MAX


@pytest.mark.parametrize("dh,H", PROJ_CASES)
def test_wide_fused_projection_shared_memory_fits(dh, H):
    """K5's output tile ``[64, H*Dh]`` (at most 128 KB), the ring and the
    barriers fit a block at every ``H*Dh`` the route takes, and a stage
    holds one ``[128, 128]`` tile of ``wo``."""
    keys, stages = WIDE_PROJ_TILES[dh]
    assert 64 * H * dh * 2 <= 128 * 1024
    assert 4 * keys * dh >= 128 * 128 * 2
    assert stages >= 2  # the attention holds two tiles at once
    assert wide_proj_smem_bytes(dh, H) <= SMEM_MAX


def test_wide_fused_projection_shared_memory_values():
    assert wide_proj_smem_bytes(256, 2) == 165_024
    assert wide_proj_smem_bytes(256, 4) == 230_576
    assert wide_proj_smem_bytes(384, 2) == 197_744
    assert wide_proj_smem_bytes(512, 2) == 230_512


def _specialisations(text: str, name: str) -> dict:
    pat = rf"struct {name}<(\d+)> \{{ static constexpr int ([^;]*); \}};"
    out = {}
    for d, body in re.findall(pat, text):
        out[int(d)] = {k: int(v) for k, v in re.findall(r"(\w+) = (\w+)", body)
                       if v.isdigit()}
    return out


def test_mirror_matches_the_cuda_sources():
    """The tiles in the Python mirror are the sources' (``FwdCfg``,
    ``ProjCfg``; two warpgroups to a row of y above Dh 128, ``kSplit``),
    and the bf16 wide C entries route Dh 256, 384 and 512 to the Hopper
    kernels."""
    fwd = (CSRC / "flash_fwd.cu").read_text()
    proj = (CSRC / "flash_fwd_proj.cu").read_text()
    cfg = _specialisations(fwd, "FwdCfg")
    for dh, (rows, keys, stages, split) in WIDE_FWD_TILES.items():
        assert cfg[dh] == {"BQ": rows, "BK": keys, "NST": stages, "QST": 1, "SPLIT": split}
    pcfg = _specialisations(proj, "ProjCfg")
    for dh, (keys, stages) in WIDE_PROJ_TILES.items():
        assert pcfg[dh] == {"BK": keys, "NST": stages}
    assert "constexpr int kSplit = D == 128 ? 1 : 2;" in proj
    entry = fwd[fwd.index("int deepcoro_flash_wide_fwd_bf16(FWD_ARGS)"):]
    entry = entry[:entry.index("\n}\n")]
    for dh in WIDE_DIMS:
        assert f"case {dh}: return launch_sm90<{dh}, false>(p, B, kr, st);" in entry
    assert "flash_fwd_wide_sm90_kernel<D>" in fwd[fwd.index("const void* fwd_kernel()"):]
    entry = proj[proj.index("int deepcoro_flash_fwd_proj_wide_bf16(PROJ_ARGS)"):]
    entry = entry[:entry.index("\n}\n")]
    for dh in WIDE_DIMS:
        assert f"case {dh}: return proj_bf16<{dh}, 2>(PROJ_NAMES, wo_cols);" in entry
    # the attrs entries ``wide_kernel_attrs`` calls with (Dh, int *, int *)
    assert "int deepcoro_flash_wide_fwd_attrs(int Dh, int* regs, int* local) {" in fwd
    assert "int deepcoro_flash_fwd_proj_wide_attrs(int Dh, int* regs, int* local) {" in proj


def test_the_wide_simt_forward_kernels_are_gone():
    """Nothing routes to the wide SIMT forwards any more, and no source
    defines them."""
    for path in CSRC.glob("*.cu*"):
        text = path.read_text()
        assert OLD_FWD not in text and OLD_PROJ not in text, path.name


def test_chip_smoke_names_the_new_kernels():
    """The traces of phases 39 and 42 look the kernels up by these names;
    no old name is a substring of a new one, nor the reverse."""
    assert chip_smoke.SIMT_FWD["bfloat16"] == ("flash_fwd_wide_sm90_kernel",)
    assert chip_smoke.SIMT_PROJ["bfloat16"] == ("flash_fwd_proj_wide_sm90_kernel",)
    assert chip_smoke.WIDE_OLD[:2] == (OLD_FWD, OLD_PROJ)  # then the backward's
    new = chip_smoke.SIMT_FWD["bfloat16"] + chip_smoke.SIMT_PROJ["bfloat16"]
    for dh in WIDE_DIMS:
        assert chip_smoke.fwd_names(BF16, dh)[0] in fwd_kernel_name(BF16, True, 393, 393, dh)
        assert chip_smoke.proj_names(BF16, dh)[0] in proj_kernel_name(BF16, dh, 1, 512)
    others = ("flash_fwd_sm90_kernel", "flash_fwd_proj_kernel", "flash_long_fwd_kernel",
              OLD_FWD, OLD_PROJ)
    for a in new:
        for b in others + tuple(n for n in new if n != a):
            assert a not in b and b not in a, (a, b)
    assert "flash_fwd_wide_sm90_kernel<Dh>" in chip_smoke.SIMT_NAMES["K1"][0]
    assert "flash_fwd_proj_wide_sm90_kernel<Dh>" in chip_smoke.SIMT_NAMES["K5"][0]


# --------------------------------------------------------------------------- #
# the plain bf16 versions against the JAX package (Pallas in interpret mode)


def _np(shape, seed, scale=1.3):
    """At the default scale q K^T / sqrt(Dh) has a std of about 1.7: the
    softmax is peaked, so a wrong rotation or mask moves the output by
    far more than the bar (near-uniform attention would return about
    mean(v) whatever RoPE does)."""
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _bf16_args(args):
    """The same bf16 values on both sides."""
    t = [torch.from_numpy(a).to(BF16) for a in args]
    return t, [jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in t]


@pytest.mark.parametrize("mode", ["rope", "mask"])
@pytest.mark.parametrize("dh,H", [(256, 2), (512, 1)])
def test_bf16_packed_matches_jax_interpret(dh, H, mode):
    """K1's plain version in bf16 (what the wide kernel is held to on the
    card), fused ``qkv`` ``[2, 40, 3*H*Dh]`` with 3D RoPE or a key mask,
    against the JAX packed wrapper's Pallas kernel in interpret mode."""
    B, L, D = 2, 40, H * dh
    (qkv,), (jqkv,) = _bf16_args([_np((B, L, 3 * D), dh + H)])
    jkw, tkw = {}, {}
    if mode == "rope":
        t = build_rope3d_tables(dh, 2, 4, 4, n_special=L - 32)
        jkw = dict(sin=jnp.asarray(t.sin), cos=jnp.asarray(t.cos))
        tkw = dict(sin=torch.from_numpy(t.sin), cos=torch.from_numpy(t.cos))
    else:
        m = np.random.default_rng(dh).random((B, L)) > 0.3
        m[:, 0] = True
        jkw, tkw = dict(kv_mask=jnp.asarray(m.astype(np.int32))), dict(kv_mask=torch.from_numpy(m))
    ref = jfap.flash_attention_packed(qkv=jqkv, num_heads=H, backend="interpret", **jkw)
    got = flash_attention_packed(qkv=qkv, num_heads=H, **tkw)
    assert got.dtype == BF16 and got.shape == (B, L, D)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), **JAX_TOL)


@pytest.mark.parametrize("dh,H,dout", [(256, 2, 512), (256, 1, 96), (512, 1, 320)])
def test_bf16_fused_projection_matches_jax_interpret(dh, H, dout):
    """K5's plain version in bf16, ``[2, 40, H*Dh]`` q, k, v and ``wo``
    ``[H*Dh, Dout]`` (Dout on and off the 128 grid), against the JAX
    wrapper's fused-projection kernel in interpret mode."""
    B, L, D = 2, 40, H * dh
    args = [_np((B, L, D), 80 + i) for i in range(3)] + [_np((D, dout), 83, 0.05)]
    targs, jargs = _bf16_args(args)
    ref = jfap.flash_attention_packed(*jargs[:3], num_heads=H, wo=jargs[3], backend="interpret")
    got = flash_attention_packed(*targs[:3], num_heads=H, wo=targs[3])
    assert got.dtype == BF16 and got.shape == (B, L, dout)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), **JAX_TOL)
