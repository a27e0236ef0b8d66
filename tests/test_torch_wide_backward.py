"""The wide bf16 backward on the tensor cores, on the CPU: which calls reach
its kernels, whether their shared memory fits, and the plain versions they
are held to on the card against the JAX package.

bf16 K2 (packed and fused, and the backward of the wide K5) at Dh 256, 384
and 512, and bf16 K4 (``[B, H, L, Dh]``) at the widths a head dim is padded
to above 128, at every length, run ``flash_bwd_dkv_wide_sm90_kernel<Dh>``
and ``flash_bwd_dq_wide_sm90_kernel<Dh>`` behind the C entry
``deepcoro_flash_wide_bwd_bf16``, after the Hopper row pre-pass. The fp32
routes keep their kernels (the SIMT ones at Dh 256 to 512).
``_flash_cuda.bwd_kernel_names`` mirrors the routing, ``wide_bwd_smem_bytes``
the kernels' dynamic shared memory (``DkvWideSmem`` / ``DqWideSmem`` of
``csrc/flash_bwd.cu``, evaluated here from the source), which must stay
within ``SMEM_MAX`` (232,448 bytes a block on an H100). The kernels run
only on the card: ``tests/test_torch_cuda.py`` (``test_wide_*``) and
``chip_smoke.py`` phases 39 and 43.

Tolerance of the plain bf16 gradients against ``jax.grad`` of the JAX
wrappers in interpret mode: atol 5e-2, rtol 5e-2 elementwise and a relative
l2 of 2e-2. Both sides round q, k, v, P, dS and the gradients to bf16, but
at other places (the JAX kernel rounds its fp32 sums per q block, the plain
version once): the forward's bar (``tests/test_torch_wide_forward.py``, 2e-2)
on values that are sums over twice the products, each rounded once more.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from deepcoro_clip_tpu.ops import flash_attention as jfa
from deepcoro_clip_tpu.ops import flash_attention_packed as jfap
from deepcoro_clip_tpu_torch.ops import _flash_cuda
from deepcoro_clip_tpu_torch.ops._flash_cuda import (
    SMEM_MAX,
    WIDE_BWD_ROWS,
    WIDE_BWD_SLAB,
    WIDE_BWD_TILES,
    WIDE_DIMS,
    bwd_kernel_names,
    bwd_symbol,
    wide_bwd_smem_bytes,
)
from deepcoro_clip_tpu_torch.ops.flash_attention import (
    flash_attention,
    kernel_head_dim,
    pad_head_dim,
)
from deepcoro_clip_tpu_torch.ops.flash_attention_packed import flash_attention_packed
from deepcoro_clip_tpu_torch.ops.rope3d import build_rope3d_tables

F32, BF16 = torch.float32, torch.bfloat16
CSRC = Path(_flash_cuda.__file__).resolve().parents[1] / "csrc"
OLD_BWD = ("bwd_rows_wide_bf16_kernel", "flash_bwd_dkv_wide_bf16_kernel",
           "flash_bwd_dq_wide_bf16_kernel")
GRAD_TOL = dict(atol=5e-2, rtol=5e-2)
GRAD_L2 = 2e-2


# --------------------------------------------------------------------------- #
# routing


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("Lq,Lk", [(1569, 1569), (393, 393), (65, 65), (1, 1), (10, 10),
                                   (130, 70), (1, 393)])
@pytest.mark.parametrize("dh", WIDE_DIMS)
def test_wide_bf16_backward_runs_the_hopper_kernels(dh, Lq, Lk, packed):
    """bf16 K2 (packed, fused: the same views) and K4 at Dh 256 to 512, at
    every length (a short ``[B, H, L, Dh]`` call at these widths too: the
    short kernels take Dh <= 128), Lq = Lk and not."""
    assert bwd_symbol(BF16, packed, Lq, Lk, dh) == "deepcoro_flash_wide_bwd_bf16"
    assert bwd_kernel_names(BF16, packed, Lq, Lk, dh) == (
        f"flash_bwd_dkv_wide_sm90_kernel<{dh}>", f"flash_bwd_dq_wide_sm90_kernel<{dh}>")


@pytest.mark.parametrize("dh,width", [(136, 256), (192, 256), (320, 384), (448, 512)])
def test_padded_k4_widths_run_the_wide_kernels(dh, width):
    """K4 at a head dim padded above 128 runs the wide pair at the padded
    width."""
    assert kernel_head_dim(dh) == width
    assert bwd_kernel_names(BF16, False, 512, 512, width) == (
        f"flash_bwd_dkv_wide_sm90_kernel<{width}>", f"flash_bwd_dq_wide_sm90_kernel<{width}>")


@pytest.mark.parametrize("dh", WIDE_DIMS)
@pytest.mark.parametrize("packed", [True, False])
def test_fp32_wide_backward_keeps_the_simt_kernels(dh, packed):
    assert bwd_symbol(F32, packed, 393, 393, dh) == "deepcoro_flash_bwd_f32"
    assert bwd_kernel_names(F32, packed, 393, 393, dh) == (
        f"flash_bwd_dkv_f32_kernel<{dh}>", f"flash_bwd_dq_f32_kernel<{dh}>")


# --------------------------------------------------------------------------- #
# shared memory: the Python mirror against the CUDA source


def _wide_cfg(src: str) -> dict:
    """``BwdWideCfg<D>``'s (T, NST) by head dim, from the source."""
    return {int(d): (int(t), int(n)) for d, t, n in re.findall(
        r"struct BwdWideCfg<(\d+)> \{ static constexpr int T = (\d+), NST = (\d+); \};", src)}


def _struct_bytes(src: str, struct: str, D: int) -> int:
    """A layout struct's BYTES, its constexpr lines evaluated in order (the
    wgmma box constants and the ring's stage size filled in)."""
    body = src[src.index(f"struct {struct} {{"):]
    body = body[:body.index("};")]
    T, NST = _wide_cfg(src)[D]
    env = {"D": D, "BOX_ROW_BYTES": 128, "WB_ROWS": WIDE_BWD_ROWS, "C::T": T, "C::NST": NST,
           "R::STAGE": 2 * (D // 64) * T * 128}
    for name, expr in re.findall(r"static constexpr int (\w+) = ([^;]+);", body):
        for k in sorted(env, key=len, reverse=True):
            if "::" in k:
                expr = expr.replace(k, str(env[k]))
        env[name] = eval(expr, {}, env)  # noqa: S307 (integer arithmetic of the source)
    return env["BYTES"]


def test_mirror_matches_the_cuda_source():
    """``WIDE_BWD_TILES`` is ``BwdWideCfg``, ``WIDE_BWD_ROWS`` /
    ``WIDE_BWD_SLAB`` the source's ``WB_ROWS`` / ``WB_SLAB``, and
    ``wide_bwd_smem_bytes`` the two layout structs evaluated."""
    src = (CSRC / "flash_bwd.cu").read_text()
    assert _wide_cfg(src) == WIDE_BWD_TILES
    assert f"constexpr int WB_ROWS = {WIDE_BWD_ROWS};" in src
    assert f"constexpr int WB_SLAB = {WIDE_BWD_SLAB};" in src
    for dh in WIDE_DIMS:
        assert wide_bwd_smem_bytes(dh) == (_struct_bytes(src, "DkvWideSmem", dh),
                                           _struct_bytes(src, "DqWideSmem", dh))


@pytest.mark.parametrize("dh,dkv,dq", [(256, 231_976, 222_248), (384, 214_824, 209_960),
                                       (512, 206_248, 203_816)])
def test_wide_backward_shared_memory(dh, dkv, dq):
    """The resident 64 rows (K and V; Q and dO), two stages of the streamed
    tile (64 rows at 256, 32 at 384, 16 at 512), the exchange tiles and the
    barriers: one block an SM at every width, each within the 227 KB a
    block may take."""
    assert wide_bwd_smem_bytes(dh) == (dkv, dq)
    assert max(dkv, dq) <= SMEM_MAX
    assert WIDE_BWD_TILES[dh] == {256: (64, 2), 384: (32, 2), 512: (16, 2)}[dh]


def test_c_entry_routes_the_wide_widths():
    """``deepcoro_flash_wide_bwd_bf16`` takes the bf16 entry at 256, 384
    and 512 to ``launch_wide<Dh>``; the fp32 entry keeps the SIMT kernels
    there; the attrs entry reads registers, local bytes and shared memory."""
    src = (CSRC / "flash_bwd.cu").read_text()
    assert ("int deepcoro_flash_wide_bwd_bf16(BWD_ARGS) { return bwd_bf16(Bf16Entry::WIDE, "
            "BWD_NAMES); }") in src
    entry = src[src.index("int bwd_bf16(Bf16Entry entry, BWD_ARGS)"):]
    entry = entry[:entry.index("\n}\n")]
    for dh in WIDE_DIMS:
        assert f"case {dh}: return launch_wide<{dh}>(" in entry
    assert ("int deepcoro_flash_wide_bwd_attrs(int which, int Dh, int* regs, int* local, "
            "int* smem) {") in src
    # the pre-pass is the Hopper kernels' (one warp a row at every wide Dh)
    launch = src[src.index("int launch_wide(BwdParams p"):]
    assert "prepare<D, 32>(" in launch[:launch.index("\n}\n")]


def test_the_wide_simt_backward_kernels_are_gone():
    """No source defines or launches the wide bf16 SIMT backward, its row
    pre-pass included."""
    for path in CSRC.glob("*.cu*"):
        text = path.read_text()
        for name in OLD_BWD:
            assert name not in text, (path.name, name)


# --------------------------------------------------------------------------- #
# chip_smoke's names


def test_chip_smoke_names_the_new_kernels():
    """Phases 39 and 43 look the wide backward up by these names; the old
    SIMT names are WIDE_OLD's last three (a trace with one of them fails);
    no new name is a substring of an old one, nor the reverse."""
    new = chip_smoke.SIMT_BWD["bfloat16"]
    assert new == ("bwd_rows_kernel", "flash_bwd_dkv_wide_sm90_kernel",
                   "flash_bwd_dq_wide_sm90_kernel")
    assert chip_smoke.WIDE_OLD_BWD == OLD_BWD == chip_smoke.WIDE_OLD[2:]
    for dh in WIDE_DIMS:
        assert chip_smoke.bwd_names(BF16, dh) == new
        kernels = bwd_kernel_names(BF16, True, 393, 393, dh)
        assert all(w in n for w, n in zip(new[1:], kernels))
    for a in new[1:]:
        for b in OLD_BWD + ("flash_bwd_dkv_sm90_kernel", "flash_bwd_dq_sm90_kernel",
                            "flash_long_bwd_dkv_kernel", "flash_long_bwd_dq_kernel"):
            assert a not in b and b not in a, (a, b)
    assert "flash_bwd_dkv_wide_sm90_kernel<Dh>" in chip_smoke.SIMT_NAMES["K2"][0]
    assert "flash_bwd_dq_wide_sm90_kernel<Dh>" in chip_smoke.SIMT_NAMES["K4"][0]


def test_older_tree_maps_to_the_simt_names(monkeypatch):
    """In a tree without the wide Hopper backward (``--wide-bwd-rows`` in
    the parent's tree) the script looks the wide bf16 backward up by the
    SIMT names."""
    monkeypatch.setitem(chip_smoke.SIMT_BWD, "bfloat16", chip_smoke.SIMT_BWD["bfloat16"])
    for name in ("TILE_FWD", "TILE_BWD", "TILE_KERNELS", "REGTILE_FWD", "REGTILE_PROJ",
                 "REGTILE_BWD"):
        monkeypatch.setattr(chip_smoke, name, getattr(chip_smoke, name))
    monkeypatch.delattr(_flash_cuda, "wide_bwd_smem_bytes")
    chip_smoke._use_tree_kernel_names()
    assert chip_smoke.bwd_names(BF16, 256) == OLD_BWD


def test_phase_43_is_wired():
    """Phase 43 runs in the whole script after phase 40, on phase 22's
    corpus and statistics, and ``--wide-bwd-rows`` takes its step; the
    kernels line carries the wide backward's own entry."""
    src = Path(chip_smoke.__file__).read_text()
    run_all = src[src.index("def run_all(torch)"):]
    assert run_all.index("phase_fp32_quality_run(") < run_all.index("phase_wide_train_run(")
    assert "phase_wide_train_run(torch, manifest, world1[\"stats\"]" in run_all
    assert "--wide-bwd-rows" in src[src.index("def main(argv)"):]
    assert chip_smoke.WIDE_HEADS == (2, 1)
    assert chip_smoke.WIDE_RUN_FIRST_REL == 1e-3 and chip_smoke.WIDE_RUN_LOSS_REL == 1e-2


# --------------------------------------------------------------------------- #
# the plain bf16 backward against jax.grad of the JAX wrappers (interpret mode)


def _np(shape, seed, scale=1.3):
    """At the default scale the softmax is peaked (q K^T / sqrt(Dh) has a
    std of about 1.7), so a wrong rotation or mask moves the gradients far
    past the bars."""
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _bf16(arrays):
    """The same bf16 values on both sides."""
    t = [torch.from_numpy(a).to(BF16) for a in arrays]
    return t, [jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in t]


def _jax_grads(fn, args, do):
    return jax.grad(lambda *a: jnp.sum((fn(*a) * do).astype(jnp.float32)),
                    argnums=tuple(range(len(args))))(*args)


def _torch_grads(fn, args, do):
    leaves = [a.clone().requires_grad_() for a in args]
    out = fn(*leaves)
    assert out.grad_fn is not None
    return torch.autograd.grad(out, leaves, do)


def _close(name, got, ref):
    got = got.float().numpy()
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, name
    np.testing.assert_allclose(got, ref, **GRAD_TOL, err_msg=name)
    l2 = float(np.linalg.norm(got - ref) / np.linalg.norm(ref))
    assert l2 <= GRAD_L2, f"{name}: rel l2 {l2:.3e}"


@pytest.mark.parametrize("dh,H", [(256, 2), (512, 1)])
def test_fused_rope_backward_matches_jax_interpret(dh, H):
    """K2's plain backward in bf16 (what the wide kernels are held to on
    the card): fused ``qkv`` ``[2, 40, 3*H*Dh]`` with 3D RoPE, the gradient
    of qkv against ``jax.grad`` of the JAX packed wrapper."""
    B, L, D = 2, 40, H * dh
    t = build_rope3d_tables(dh, 2, 4, 4, n_special=L - 32)
    (qkv, do), (jqkv, jdo) = _bf16([_np((B, L, 3 * D), dh + H), _np((B, L, D), dh + H + 1, 0.5)])
    ref = _jax_grads(lambda x: jfap.flash_attention_packed(
        qkv=x, num_heads=H, sin=jnp.asarray(t.sin), cos=jnp.asarray(t.cos),
        backend="interpret"), [jqkv], jdo)
    got = _torch_grads(lambda x: flash_attention_packed(
        qkv=x, num_heads=H, sin=torch.from_numpy(t.sin), cos=torch.from_numpy(t.cos)),
        [qkv], do)
    assert got[0].dtype == BF16
    for i, name in enumerate(("dq", "dk", "dv")):
        _close(name, got[0][..., i * D:(i + 1) * D], ref[0][..., i * D:(i + 1) * D])


@pytest.mark.parametrize("dh,H", [(256, 2), (512, 1)])
def test_split_masked_cross_backward_matches_jax_interpret(dh, H):
    """Split ``q`` ``[2, 40, H*Dh]`` over ``k``, ``v`` ``[2, 90, H*Dh]``
    with a key mask (Lq != Lk; one batch row keeps a single key): the three
    gradients against ``jax.grad`` of the JAX packed wrapper."""
    B, Lq, Lk, D = 2, 40, 90, H * dh
    (q, k, v, do), (jq, jk, jv, jdo) = _bf16([
        _np((B, Lq, D), 7), _np((B, Lk, D), 8), _np((B, Lk, D), 9), _np((B, Lq, D), 10, 0.5)])
    m = np.random.default_rng(dh).random((B, Lk)) > 0.3
    m[1] = False
    m[1, 17] = True
    ref = _jax_grads(lambda a, b, c: jfap.flash_attention_packed(
        a, b, c, num_heads=H, kv_mask=jnp.asarray(m.astype(np.int32)), backend="interpret"),
        [jq, jk, jv], jdo)
    got = _torch_grads(lambda a, b, c: flash_attention_packed(
        a, b, c, num_heads=H, kv_mask=torch.from_numpy(m)), [q, k, v], do)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        _close(name, g, r)


def test_padded_192_backward_matches_jax_interpret():
    """K4 at Dh 192 in bf16 as the card runs it: ``pad_head_dim`` to 256,
    the plain version at the padded width with the original scale, the
    output cut back, a key mask; the gradients against ``jax.grad`` of the
    JAX ``flash_attention`` in interpret mode (which pads to 256 itself),
    and the pad's own gradients exactly 0."""
    B, H, L, dh = 2, 2, 70, 192
    width = kernel_head_dim(dh)
    (q, k, v, do), (jq, jk, jv, jdo) = _bf16(
        [_np((B, H, L, dh), 20 + i) for i in range(3)] + [_np((B, H, L, dh), 23, 0.5)])
    m = np.random.default_rng(5).random((B, L)) > 0.4
    m[:, 0] = True
    ref = _jax_grads(lambda a, b, c: jfa.flash_attention(
        a, b, c, kv_mask=jnp.asarray(m), backend="interpret"), [jq, jk, jv], jdo)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    padded = pad_head_dim(*leaves, None, None, width)[:3]
    assert all(x.shape[-1] == width for x in padded)
    out = flash_attention(*padded, kv_mask=torch.from_numpy(m), scale=dh ** -0.5)[..., :dh]
    pad_grads = torch.autograd.grad(out, padded, do, retain_graph=True)
    got = torch.autograd.grad(out, leaves, do)
    for name, g, r, gp in zip(("dq", "dk", "dv"), got, ref, pad_grads):
        _close(name, g, r)
        assert bool((gp[..., dh:] == 0).all()), name
