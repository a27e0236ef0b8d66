"""The short kernels of K3 and K4 (``csrc/flash_short.cu``): routing, host path, parity.

Every ``[B, H, L, Dh]`` call with Lq, Lk <= 64 runs the one-launch forward
and backward of ``csrc/flash_short.cu`` on the card; the kernels themselves
are held against their plain versions there (tests/test_torch_cuda.py,
chip_smoke.py phase 20). Here, without a card:

- the routing (``fwd_symbol``, ``bwd_symbol``) is pinned for every class
  of (dtype, Lq, Lk, Dh), a pure function;
- the host path's argument block is checked against the C source's layout,
  and a bool or uint8 key mask is shown to reach it as it is (no
  conversion kernel), with its batch stride;
- the wrappers' CPU path (the plain versions, which the kernels are held
  to) is held against the JAX function with ``backend="interpret"`` (the
  Pallas kernels in interpret mode) at the main paths' shapes: the
  aggregator's [4,8,10,64] and [8,8,4,64] and the probing head's
  [8,8,11,64], each with a key mask, forward and ``jax.grad``, plus Lq = 1
  cross-attention and causal L = 16. Inputs come from a numpy seed, in
  fp32 on both sides: forward 2e-5 as in test_standard_matches_jax_interpret,
  1e-5 for the probing head's fp32 case, gradients 5e-5 (sums of products
  in another order than the Pallas kernel, whose forward and backward each
  rebuild P); and the aggregator's two shapes in bf16 on both sides, at the
  bf16 tolerance of test_plain_bf16_matches_jax_oracle_bf16.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepcoro_clip_tpu.ops import flash_attention as jfa

from deepcoro_clip_tpu_torch.ops import _flash_cuda
from deepcoro_clip_tpu_torch.ops.flash_attention import flash_attention

BF16, F32 = torch.bfloat16, torch.float32
SHORT_SRC = (Path(__file__).resolve().parents[1] / "deepcoro_clip_tpu_torch" / "csrc"
             / "flash_short.cu")


@pytest.mark.parametrize("dtype,Lq,Lk,Dh,fwd,bwd", [
    (BF16, 10, 10, 64, "deepcoro_flash_short_fwd_bf16", "deepcoro_flash_short_bwd_bf16"),
    (BF16, 4, 4, 64, "deepcoro_flash_short_fwd_bf16", "deepcoro_flash_short_bwd_bf16"),
    (F32, 11, 11, 64, "deepcoro_flash_short_fwd_f32", "deepcoro_flash_short_bwd_f32"),
    (BF16, 1, 64, 128, "deepcoro_flash_short_fwd_bf16", "deepcoro_flash_short_bwd_bf16"),
    (F32, 64, 64, 128, "deepcoro_flash_short_fwd_f32", "deepcoro_flash_short_bwd_f32"),
    (BF16, 65, 65, 64, "deepcoro_flash_long_fwd_bf16", "deepcoro_flash_long_bwd_bf16"),
    (BF16, 1, 65, 64, "deepcoro_flash_long_fwd_bf16", "deepcoro_flash_long_bwd_bf16"),
    (F32, 65, 1, 128, "deepcoro_flash_fwd_f32", "deepcoro_flash_bwd_f32"),
    (BF16, 1, 393, 64, "deepcoro_flash_long_fwd_bf16", "deepcoro_flash_long_bwd_bf16"),
    (F32, 99, 99, 64, "deepcoro_flash_fwd_f32", "deepcoro_flash_bwd_f32"),
])
def test_short_routing_by_length(dtype, Lq, Lk, Dh, fwd, bwd):
    """The [B, H, L, Dh] entry runs the short kernels at Lq, Lk <= 64 and
    the tile kernels past that (bf16: the Hopper ones), in both directions."""
    assert _flash_cuda.fwd_symbol(dtype, False, Lq, Lk, Dh) == fwd
    assert _flash_cuda.bwd_symbol(dtype, False, Lq, Lk, Dh) == bwd
    assert _flash_cuda.is_short(False, Lq, Lk, Dh) == ("short" in fwd)


@pytest.mark.parametrize("L", [10, 1569])
def test_packed_layouts_never_take_the_short_kernels(L):
    assert _flash_cuda.fwd_symbol(BF16, True, L, L, 128) == "deepcoro_flash_fwd_sm90_bf16"
    assert _flash_cuda.bwd_symbol(BF16, True, L, L, 128) == "deepcoro_flash_bwd_sm90_bf16"


def test_forward_routing_rejects_what_no_kernel_takes():
    """fp16, a head dim no kernel takes (96 is padded by the entry point
    before the choice; above 512 nothing takes it) and a packed head dim
    that is not a multiple of 128 raise; fp32 packed at short lengths and a
    wide head at short lengths take the SIMT kernels."""
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        _flash_cuda.fwd_symbol(torch.float16, False, 10, 10, 64)
    with pytest.raises(ValueError, match="Dh in"):
        _flash_cuda.fwd_symbol(BF16, False, 10, 10, 96)
    with pytest.raises(ValueError, match="Dh in"):
        _flash_cuda.fwd_symbol(F32, False, 10, 10, 640)
    with pytest.raises(ValueError, match="Dh % 128"):
        _flash_cuda.fwd_symbol(F32, True, 10, 10, 64)
    assert _flash_cuda.fwd_symbol(F32, True, 10, 10, 128) == "deepcoro_flash_fwd_f32"
    assert _flash_cuda.fwd_symbol(BF16, False, 10, 10, 256) == "deepcoro_flash_wide_fwd_bf16"
    assert not _flash_cuda.is_short(False, 10, 10, 256)


def test_argument_block_mirrors_the_c_source():
    """ops/_flash_cuda.py's A_* slots are csrc/flash_short.cu's enum
    ShortArg, name for name and in order."""
    body = re.search(r"enum ShortArg : int \{(.*?)\};", SHORT_SRC.read_text(), re.S).group(1)
    names = [n.split("=")[0].strip() for n in body.replace("\n", " ").split(",")]
    slot, want = 0, {}
    for n in names:
        want[n] = slot
        slot += 3 if n in ("A_QS", "A_KS", "A_VS", "A_DOS") else 1
    for n, i in want.items():
        assert getattr(_flash_cuda, n) == i, n
    assert _flash_cuda._ARGS.size == 8 * _flash_cuda.A_COUNT


def _unpack(block):
    return _flash_cuda._ARGS.unpack(block)


def test_bool_mask_reaches_the_kernel_as_it_is():
    """A bool (or uint8) mask with contiguous keys goes to the short
    kernels as it is, with its batch stride, also when it is a slice of a
    wider mask; the tile kernels take it as it is when it is contiguous."""
    q = torch.zeros(4, 8, 10, 64, dtype=BF16)
    wide = torch.ones(4, 16, dtype=torch.bool)
    for m in (wide[:, :10], wide[:, :10].contiguous(), wide[:, :10].to(torch.uint8)):
        assert _flash_cuda.mask_arg(m, strided=True) is m
        a = _unpack(_flash_cuda.short_args(q, q, q, q, sin=None, cos=None,
                                           mask=_flash_cuda.mask_arg(m, strided=True),
                                           causal=False, stream=0))
        assert a[_flash_cuda.A_MASK] == m.data_ptr()
        assert a[_flash_cuda.A_MASK_SB] == m.stride(0)
    m = wide[:, :10].contiguous()
    assert _flash_cuda.mask_arg(m, strided=False) is m
    # a strided one is copied for the tile kernels, which read [B, Lk] rows
    assert _flash_cuda.mask_arg(wide[:, :10], strided=False).is_contiguous()


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
def test_other_masks_are_converted_once(dtype):
    m = torch.tensor([[1, 0, 2], [0, 0, 0]], dtype=dtype)
    got = _flash_cuda.mask_arg(m, strided=True)
    assert got.dtype == torch.uint8 and got.is_contiguous()
    assert got.tolist() == [[1, 0, 1], [0, 0, 0]]


def test_argument_block_carries_strides_and_sizes():
    """q, k, v as the layers hand them over (strided views of [B, L, 3D]),
    the output gradient through a transpose; outputs contiguous."""
    B, L, H, Dh = 8, 4, 8, 64
    qkv = torch.zeros(B, L, 3 * H * Dh, dtype=BF16)
    q, k, v = (t.unflatten(2, (H, Dh)).transpose(1, 2) for t in qkv.split(H * Dh, -1))
    do = torch.zeros(B, L, H, Dh, dtype=BF16).transpose(1, 2)
    out = torch.empty(B, H, L, Dh, dtype=BF16)
    dq, dk, dv = (torch.empty_like(out) for _ in range(3))
    a = _unpack(_flash_cuda.short_args(q, k, v, out, sin=None, cos=None, mask=None,
                                       causal=True, stream=7, do=do, dq=dq, dk=dk, dv=dv))
    assert a[_flash_cuda.A_Q:_flash_cuda.A_STREAM + 1] == (
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), do.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), 0, 0, 0, 7)
    for slot, t in ((_flash_cuda.A_QS, q), (_flash_cuda.A_KS, k), (_flash_cuda.A_VS, v),
                    (_flash_cuda.A_DOS, do)):
        assert a[slot:slot + 3] == t.stride()[:3]
    assert a[_flash_cuda.A_MASK_SB:] == (0, B, H, L, L, Dh, 1)


# --------------------------------------------------------------------------- #
# the CPU path against the JAX function in interpret mode

TOL = dict(atol=2e-5, rtol=2e-5)
F32_TOL = dict(atol=1e-5, rtol=1e-5)
GTOL = dict(atol=5e-5, rtol=5e-5)


def _np(shape, seed):
    return (np.random.default_rng(seed).normal(size=shape) * 0.3).astype(np.float32)


def _mask(B, Lk, seed):
    m = np.random.default_rng(seed).random((B, Lk)) > 0.4
    m[:, 0] = True  # a valid key in every row (the Pallas kernel's contract)
    return m


@pytest.mark.parametrize("case,B,Lq,Lk,kw,tol", [
    ("serving aggregator", 4, 10, 10, "mask", TOL),
    ("training aggregator", 8, 4, 4, "mask", TOL),
    ("probing CLS block", 8, 11, 11, "mask", F32_TOL),
    ("one query, cross", 2, 1, 37, "mask", TOL),
    ("causal", 2, 16, 16, "causal", TOL),
])
def test_short_shapes_match_jax_interpret(case, B, Lq, Lk, kw, tol):
    """Forward and gradients of flash_attention (its CPU path) against
    jax.grad of ops/flash_attention.flash_attention with the Pallas kernels
    in interpret mode, H 8 x Dh 64, at the shapes the short kernels take."""
    H, Dh = 8, 64
    seed = Lq * 100 + Lk
    args = [_np((B, H, Lq, Dh), seed), _np((B, H, Lk, Dh), seed + 1),
            _np((B, H, Lk, Dh), seed + 2)]
    do = _np((B, H, Lq, Dh), seed + 3)
    if kw == "mask":
        m = _mask(B, Lk, seed + 4)
        kw_j, kw_t = dict(kv_mask=jnp.asarray(m)), dict(kv_mask=torch.from_numpy(m))
    else:
        kw_j = kw_t = dict(causal=True)

    def jfn(q, k, v):
        return jfa.flash_attention(q, k, v, backend="interpret", **kw_j)

    ref = jfn(*map(jnp.asarray, args))
    ref_g = jax.grad(lambda *a: jnp.sum(jfn(*a) * jnp.asarray(do)),
                     argnums=(0, 1, 2))(*map(jnp.asarray, args))
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    out = flash_attention(*leaves, **kw_t)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **tol)
    for g, r in zip(got, ref_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **GTOL)


@pytest.mark.parametrize("B,L", [(4, 10), (8, 4)])
def test_short_shapes_match_jax_interpret_bf16(B, L):
    """The aggregator's shapes in bf16 on both sides, with a key mask:
    forward and gradients of flash_attention's CPU path against the Pallas
    kernels in interpret mode, at the bf16 tolerance of
    test_plain_bf16_matches_jax_oracle_bf16 (2e-2): both round P to bf16
    before P V and dS before its products, from sums in another order."""
    H, Dh = 8, 64
    args = [_np((B, H, L, Dh), s) for s in (1, 2, 3)]
    do = _np((B, H, L, Dh), 4)
    m = _mask(B, L, 5)

    def jfn(q, k, v):
        return jfa.flash_attention(q, k, v, kv_mask=jnp.asarray(m), backend="interpret")

    ja = [jnp.asarray(a, jnp.bfloat16) for a in args]
    ref = jfn(*ja)
    ref_g = jax.grad(lambda *a: jnp.sum(jfn(*a).astype(jnp.float32) * jnp.asarray(do)),
                     argnums=(0, 1, 2))(*ja)
    leaves = [torch.from_numpy(a).to(torch.bfloat16).requires_grad_() for a in args]
    out = flash_attention(*leaves, kv_mask=torch.from_numpy(m))
    assert out.dtype == torch.bfloat16
    got = torch.autograd.grad(out, leaves, torch.from_numpy(do).to(torch.bfloat16))
    tol = dict(atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(out.detach().float().numpy(), np.asarray(ref, np.float32), **tol)
    for g, r in zip(got, ref_g):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(r, np.float32), **tol)
