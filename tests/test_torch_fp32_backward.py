"""The register-tiled fp32 backward kernels (``csrc/bwd_f32_regtile.cuh``) on
the CPU: which calls reach them, and whether their shared memory fits.

fp32 K2 (packed, Dh 128) and K4 (``[B, H, L, Dh]`` past the short lengths)
at Dh 64 and 128 run ``flash_bwd_dkv_f32_regtile_kernel<Dh>`` (which also
writes dS^T to a scratch buffer) and ``flash_bwd_dq_f32_regtile_kernel<Dh>``
(dQ = dS K from it) behind the C entry ``deepcoro_flash_bwd_f32``, which
routes by Dh. Wider fp32 heads, the wide-bf16 routes, the bf16 Hopper
kernels and the short calls keep their kernels. ``_flash_cuda.bwd_kernel_names``
mirrors the routing, ``regtile_bwd_smem_bytes`` the kernels' dynamic shared
memory, which must stay within ``SMEM_MAX`` (232,448 bytes a block on an
H100: a launch above it is refused on the card); both are held against the
constants, the tile layouts and the switch of the CUDA sources, and the
ctypes argument list against the entries' C arguments, so the two sides
cannot drift apart unnoticed. The kernels themselves run only on the card:
``tests/test_torch_cuda.py`` (``test_regtile_bwd_*``) and ``chip_smoke.py``
phases 39 and 40.
"""

import re
from pathlib import Path

import pytest
import torch

import chip_smoke
from deepcoro_clip_tpu_torch.ops import _flash_cuda
from deepcoro_clip_tpu_torch.ops._flash_cuda import (
    REGTILE_DIMS,
    SMEM_MAX,
    bwd_kernel_names,
    bwd_symbol,
    regtile_bwd_smem_bytes,
)

F32, BF16 = torch.float32, torch.bfloat16
CSRC = Path(_flash_cuda.__file__).resolve().parents[1] / "csrc"


def _regtile(dh):
    return (f"flash_bwd_dkv_f32_regtile_kernel<{dh}>", f"flash_bwd_dq_f32_regtile_kernel<{dh}>")


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("L", [1569, 393, 128, 65])
@pytest.mark.parametrize("dh", REGTILE_DIMS)
def test_fp32_backward_runs_the_register_tiled_kernels(packed, L, dh):
    """fp32 K2 (packed, Dh 128) and K4 past the short lengths at Dh 64 and
    128, Lq = Lk and not (the decoder's cross attention 128|1572 among
    them), through the unchanged C entry."""
    if packed and dh % 128:
        with pytest.raises(ValueError, match="Dh % 128"):
            bwd_symbol(F32, packed, L, L, dh)
        return
    for lk in (L, 77, 1572):
        assert bwd_symbol(F32, packed, L, lk, dh) == "deepcoro_flash_bwd_f32"
        assert bwd_kernel_names(F32, packed, L, lk, dh) == _regtile(dh)


@pytest.mark.parametrize("Lq,Lk", [(1, 65), (65, 1), (10, 200), (200, 64)])
def test_one_long_length_is_enough(Lq, Lk):
    """The ``[B, H, L, Dh]`` entry leaves the short kernel when either
    length passes 64, and then runs the register-tiled pair."""
    assert bwd_kernel_names(F32, False, Lq, Lk, 64) == _regtile(64)


@pytest.mark.parametrize("dtype,packed,Lq,Lk,dh,kernels", [
    (F32, False, 64, 64, 64, ("flash_short_bwd_f32_kernel",)),  # short: one launch
    (F32, False, 1, 1, 128, ("flash_short_bwd_f32_kernel",)),
    (F32, False, 11, 64, 128, ("flash_short_bwd_f32_kernel",)),
    (F32, True, 393, 393, 256, ("flash_bwd_dkv_f32_kernel<256>", "flash_bwd_dq_f32_kernel<256>")),
    (F32, False, 512, 512, 384, ("flash_bwd_dkv_f32_kernel<384>",
                                 "flash_bwd_dq_f32_kernel<384>")),
    (F32, True, 1569, 1569, 512, ("flash_bwd_dkv_f32_kernel<512>",
                                  "flash_bwd_dq_f32_kernel<512>")),
    (F32, False, 10, 10, 256, ("flash_bwd_dkv_f32_kernel<256>", "flash_bwd_dq_f32_kernel<256>")),
    (BF16, True, 1569, 1569, 128, ("flash_bwd_dkv_sm90_kernel", "flash_bwd_dq_sm90_kernel")),
    (BF16, False, 512, 512, 64, ("flash_long_bwd_dkv_kernel<64>", "flash_long_bwd_dq_kernel<64>")),
    (BF16, False, 128, 1572, 128, ("flash_long_bwd_dkv_kernel<128>",
                                   "flash_long_bwd_dq_kernel<128>")),
    (BF16, False, 10, 10, 64, ("flash_short_bwd_bf16_kernel",)),
    (BF16, True, 393, 393, 256, ("flash_bwd_dkv_wide_sm90_kernel<256>",
                                 "flash_bwd_dq_wide_sm90_kernel<256>")),
    (BF16, False, 10, 10, 512, ("flash_bwd_dkv_wide_sm90_kernel<512>",
                                "flash_bwd_dq_wide_sm90_kernel<512>")),
])
def test_other_backward_routes_keep_their_kernels(dtype, packed, Lq, Lk, dh, kernels):
    """Short calls, fp32 past Dh 128, the bf16 Hopper, long and wide
    kernels: as before the register-tiled backward came."""
    assert bwd_kernel_names(dtype, packed, Lq, Lk, dh) == kernels


@pytest.mark.parametrize("dtype,packed,dh", [(F32, True, 96), (F32, False, 32), (BF16, True, 64),
                                             (torch.float16, False, 64)])
def test_what_no_kernel_takes_still_raises(dtype, packed, dh):
    with pytest.raises((ValueError, TypeError)):
        bwd_kernel_names(dtype, packed, 393, 393, dh)


@pytest.mark.parametrize("dh,dkv,dq", [(64, 120_832, 69_632), (128, 219_136, 102_400)])
def test_backward_shared_memory(dh, dkv, dq):
    """The dK/dV block (K, V resident, Q and dO double-buffered, the 16 KB
    exchange tile) fits one block of 8 warps an SM at Dh 128; the dQ block
    (dS^T and K double-buffered) two of 4 warps (228 KB an SM, 1 KB of it
    reserved a block)."""
    assert regtile_bwd_smem_bytes(dh) == (dkv, dq)
    assert max(dkv, dq) <= SMEM_MAX
    assert dkv + 1024 <= 228 * 1024 and 2 * (dq + 1024) <= 228 * 1024


def _constants(text: str) -> dict:
    return {k: int(v) for k, v in re.findall(r"constexpr int (RB_\w+) = (\d+);", text)}


def _tile_bytes(text: str, struct: str, consts: dict, D: int) -> int:
    """A tile struct's BYTES, its constexpr lines evaluated in order."""
    body = text[text.index(f"struct {struct} {{"):]
    body = body[:body.index("};")]
    env = {**consts, "D": D}
    for name, expr in re.findall(r"static constexpr int (\w+) = ([^;]+);", body):
        env[name] = eval(expr, {}, env)  # noqa: S307 (integer arithmetic of the source)
    return env["BYTES"]


def test_mirror_matches_the_cuda_sources():
    """The Python mirror's tile constants and shared-memory sizes are the
    header's (its structs evaluated), and the fp32 C entry routes Dh 64 /
    128 to the register-tiled pair and 256 to 512 to the SIMT kernels."""
    head = (CSRC / "bwd_f32_regtile.cuh").read_text()
    bwd = (CSRC / "flash_bwd.cu").read_text()
    c = _constants(head)
    assert c["RB_KEYS"] == _flash_cuda.REGTILE_BWD_KEYS
    assert c["RB_ROWS"] == _flash_cuda.REGTILE_BWD_ROWS
    assert c["RB_PAD"] == _flash_cuda.REGTILE_BWD_PAD
    assert (c["RB_WG"], c["RB_THREADS"], c["RB_OWN"], c["RB_PART"]) == (128, 256, 8, 4)
    for dh in REGTILE_DIMS:
        assert regtile_bwd_smem_bytes(dh) == (_tile_bytes(head, "RbDkvTiles", c, dh),
                                              _tile_bytes(head, "RbDqTiles", c, dh))
    entry = bwd[bwd.index("int bwd_f32(BWD_ARGS)"):]
    entry = entry[:entry.index("\n}\n")]
    for dh in REGTILE_DIMS:
        case = entry[entry.index(f"case {dh}:"):]
        case = case[:case.index("break;")]
        assert f"launch_regtile<{dh}>" in case and "launch_simt" not in case
    for dh in (256, 384, 512):
        assert f"case {dh}: err = launch_simt<{dh}>" in entry
    # the old SIMT dK/dV and dQ kernels are not built at Dh 64 or 128: no way back to them
    assert "launch_simt<64>" not in bwd and "launch_simt<128>" not in bwd


def test_ctypes_arguments_match_the_c_entries():
    """``BWD_ARGTYPES`` (16 pointers with the dS^T scratch, 5 ints, 24
    strides, scale, causal, stream) is the C entries' argument list."""
    bwd = (CSRC / "flash_bwd.cu").read_text()
    macro = bwd[bwd.index("#define BWD_ARGS"):bwd.index("#define BWD_NAMES")]
    args = [a.strip() for a in macro.replace("\\", " ").split("BWD_ARGS", 1)[1].split(",")]
    kinds = {"void": _flash_cuda._P, "int": _flash_cuda._I, "long": _flash_cuda._LL,
             "float": __import__("ctypes").c_float}
    want = [kinds[a.replace("const ", "").split()[0]] for a in args]
    assert want == _flash_cuda.BWD_ARGTYPES
    assert "void *ds" in macro


def test_chip_smoke_names_the_new_kernels():
    """The traces of phases 39 and 40 look the kernels up by these names."""
    assert chip_smoke.REGTILE_BWD == ("flash_bwd_dkv_f32_regtile_kernel",
                                      "flash_bwd_dq_f32_regtile_kernel")
    assert chip_smoke.F32_ROWS == ("bwd_rows_f32_kernel",)
    for dh in REGTILE_DIMS:
        names = bwd_kernel_names(F32, False, 393, 393, dh)
        assert all(w in n for w, n in zip(chip_smoke.REGTILE_BWD, names))
        assert chip_smoke.bwd_names(F32, dh) == chip_smoke.F32_ROWS + chip_smoke.REGTILE_BWD
    assert chip_smoke.bwd_names(F32, 256) == chip_smoke.SIMT_BWD["float32"]
    assert chip_smoke.bwd_names(BF16, 512) == chip_smoke.SIMT_BWD["bfloat16"]
    # no name is a substring of another (a trace lookup by substring keeps them apart)
    names = (chip_smoke.REGTILE_BWD + chip_smoke.SIMT_BWD["float32"][1:]
             + chip_smoke.SIMT_BWD["bfloat16"][1:] + chip_smoke.F32_ROWS)
    for a in names:
        assert [b for b in names if a in b] == [a], a
    # the SIMT entries of the kernels line name them
    assert "flash_bwd_dkv_f32_regtile_kernel<128>" in chip_smoke.SIMT_NAMES["K2"][0]
    assert "flash_bwd_dq_f32_regtile_kernel<64|128>" in chip_smoke.SIMT_NAMES["K4"][0]
    # phase 15's probing profile: no long fp32 backward kernel may run there
    src = Path(chip_smoke.__file__).read_text()
    probe = src[src.index("def phase_probe_profile"):src.index("def phase_probe_times")]
    assert "REGTILE_BWD" in probe


def test_older_tree_maps_to_the_simt_names(monkeypatch):
    """In a tree without the register-tiled backward (``--fp32-rows`` in
    the parent's tree) the script looks its fp32 backward up by the SIMT
    names."""
    for name in ("TILE_FWD", "TILE_BWD", "TILE_KERNELS", "REGTILE_FWD", "REGTILE_PROJ",
                 "REGTILE_BWD"):
        monkeypatch.setattr(chip_smoke, name, getattr(chip_smoke, name))
    chip_smoke._use_tree_kernel_names()
    assert chip_smoke.REGTILE_BWD == ("flash_bwd_dkv_f32_regtile_kernel",
                                      "flash_bwd_dq_f32_regtile_kernel")
    monkeypatch.delattr(_flash_cuda, "regtile_bwd_smem_bytes")
    chip_smoke._use_tree_kernel_names()
    assert chip_smoke.REGTILE_BWD == ("flash_bwd_dkv_f32_kernel", "flash_bwd_dq_f32_kernel")
    assert chip_smoke.bwd_names(F32, 128) == chip_smoke.SIMT_BWD["float32"]
