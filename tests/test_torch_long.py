"""The long K3/K4 calls (``[B, H, L, Dh]`` above 64 tokens): routing, the key-tile skip, parity.

Every bf16 ``[B, H, L, Dh]`` call with Lq or Lk above ``SHORT_MAX`` runs
the Hopper kernels ``flash_long_fwd_kernel`` and
``flash_long_bwd_{dkv,dq}_kernel`` on the card, which visit a q tile's key
tiles only up to its key extent (``_flash_cuda.visit_keys``): the kernels
themselves are held against their plain versions there
(tests/test_torch_cuda.py, chip_smoke.py). Here, without a card:

- the routing (``fwd_symbol``, ``bwd_symbol``) of the long calls, which
  leaves the short, fp32 and packed routes as they were;
- the Python mirror of the skip rule against a brute-force reading of the
  (query, key) pairs a mask and causality leave: it never drops an
  attended key, it is tight without causal masking, and a q tile holding a
  row with no attended key visits every key (bank-like prefix masks, masks
  with holes, a fully masked row, causal masking under a caption mask
  whose first key is masked);
- why the skip is exact, on the plain version: fp32 attention over the
  keys cut to ``key_cut`` equals the uncut call, forward and gradients,
  for every batch row with a valid key (the sums run through BLAS at
  another length, so to 1e-6, with dK and dV exactly 0 past the cut);
- the plain version (the wrappers' CPU path, which the kernels are held
  to) against the JAX ``flash_attention`` with the Pallas kernels in
  interpret mode at a small bank-like shape, [6, 2, 80, 64] with 2 to 21
  real keys a row, plain and causal, forward 2e-5 and gradients 5e-5 as in
  tests/test_torch_short.py; its one fully masked batch row against the
  XLA oracle, since the Pallas kernel averages over the padding it adds
  (tests/test_torch_ops.py's module note).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepcoro_clip_tpu.ops import flash_attention as jfa

from deepcoro_clip_tpu_torch.ops import _flash_cuda
from deepcoro_clip_tpu_torch.ops.flash_attention import flash_attention, kernel_head_dim

BF16, F32 = torch.bfloat16, torch.float32
TOL = dict(atol=2e-5, rtol=2e-5)
GTOL = dict(atol=5e-5, rtol=5e-5)
# the cut call's sums run through BLAS at another length
CUT_TOL = dict(atol=1e-6, rtol=1e-6)


# --------------------------------------------------------------------------- #
# routing


@pytest.mark.parametrize("Lq,Lk,Dh", [(65, 65, 64), (512, 512, 64), (128, 128, 64),
                                      (128, 1572, 64), (1, 393, 64), (130, 130, 128),
                                      (70, 10, 128)])
def test_long_bf16_calls_take_the_hopper_kernels(Lq, Lk, Dh):
    assert _flash_cuda.fwd_symbol(BF16, False, Lq, Lk, Dh) == "deepcoro_flash_long_fwd_bf16"
    assert _flash_cuda.bwd_symbol(BF16, False, Lq, Lk, Dh) == "deepcoro_flash_long_bwd_bf16"
    assert not _flash_cuda.is_short(False, Lq, Lk, Dh)


@pytest.mark.parametrize("Lq,Lk,Dh", [(65, 65, 64), (99, 99, 128), (11, 200, 64)])
def test_long_fp32_calls_keep_the_fp32_kernels(Lq, Lk, Dh):
    assert _flash_cuda.fwd_symbol(F32, False, Lq, Lk, Dh) == "deepcoro_flash_fwd_f32"
    assert _flash_cuda.bwd_symbol(F32, False, Lq, Lk, Dh) == "deepcoro_flash_bwd_f32"


@pytest.mark.parametrize("dtype,suffix", [(BF16, "bf16"), (F32, "f32")])
def test_short_and_packed_routes_are_unchanged(dtype, suffix):
    for L in (1, 10, 64):
        assert _flash_cuda.fwd_symbol(dtype, False, L, L, 64) == \
            f"deepcoro_flash_short_fwd_{suffix}"
        assert _flash_cuda.bwd_symbol(dtype, False, L, L, 64) == \
            f"deepcoro_flash_short_bwd_{suffix}"
    for L in (10, 512, 1569):
        assert _flash_cuda.fwd_symbol(BF16, True, L, L, 128) == "deepcoro_flash_fwd_sm90_bf16"
        assert _flash_cuda.bwd_symbol(BF16, True, L, L, 128) == "deepcoro_flash_bwd_sm90_bf16"


def test_head_dims_no_kernel_takes_raise():
    """No kernel is built at Dh 96: the entry point pads it to 128 first
    (``kernel_head_dim``), as it pads 32 to 64 and 192 to 256; above 512
    nothing takes it, and the width is named."""
    for dtype in (BF16, F32):
        with pytest.raises(ValueError, match="Dh in"):
            _flash_cuda.fwd_symbol(dtype, False, 512, 512, 96)
        with pytest.raises(ValueError, match="Dh in"):
            _flash_cuda.fwd_symbol(dtype, False, 512, 512, 1024)
    assert [kernel_head_dim(d) for d in (32, 96, 192, 320, 512)] == [64, 128, 256, 384, 512]
    with pytest.raises(ValueError, match="Dh up to 512, got 640"):
        kernel_head_dim(640)


# --------------------------------------------------------------------------- #
# the skip rule's mirror


def _bank_mask(B, Lk, seed, lo=2, hi=21):
    """Prefix masks of lo..hi real tokens, as the SigLIP bank's prompts."""
    lens = np.random.default_rng(seed).integers(lo, hi + 1, size=B)
    return np.arange(Lk)[None, :] < lens[:, None]


def _masks():
    rng = np.random.default_rng(7)
    bank = _bank_mask(6, 200, 1)
    holes = rng.random((4, 300)) > 0.7
    holes[1, 250:] = False
    holes[2, :] = False
    holes[2, [5, 140, 222]] = True
    dead = _bank_mask(4, 150, 2)
    dead[3] = False  # a fully masked row
    caption = _bank_mask(5, 128, 3, lo=3, hi=100)
    caption[1, :4] = False  # the first keys masked: causal rows 0..3 have no key
    caption[4, 0] = False
    return {"bank": (bank, 200, False), "holes": (holes, 300, False),
            "fully masked row": (dead, 150, False), "causal + caption": (caption, 128, True),
            "causal, no mask": (None, 200, True), "cross, Lq 37": (holes, 300, False)}


def _allowed(mask, B, Lq, Lk, causal):
    """[B, Lq, Lk] bool: the (query, key) pairs the mask and causality leave."""
    a = np.ones((B, Lq, Lk), bool)
    if mask is not None:
        a &= mask[:, None, :]
    if causal:
        a &= np.tril(np.ones((Lq, Lk), bool))[None]
    return a


def test_key_extent_reads_the_last_and_first_real_key():
    m = np.zeros((4, 100), bool)
    m[0, :7] = True
    m[1, [3, 40, 98]] = True
    m[3] = True
    e, f = _flash_cuda.key_extent(m, 4, 100)
    assert e.tolist() == [7, 99, 0, 100] and f.tolist() == [0, 3, 100, 0]
    e, f = _flash_cuda.key_extent(torch.from_numpy(m).to(torch.uint8), 4, 100)
    assert e.tolist() == [7, 99, 0, 100] and f.tolist() == [0, 3, 100, 0]
    e, f = _flash_cuda.key_extent(None, 3, 50)
    assert e.tolist() == [50] * 3 and f.tolist() == [0] * 3


@pytest.mark.parametrize("name", list(_masks()))
@pytest.mark.parametrize("tiles", [_flash_cuda.FWD_TILES, _flash_cuda.DQ_TILES,
                                   _flash_cuda.DKV_TILES])
def test_the_skip_never_drops_an_attended_key(name, tiles):
    """Every (query, key) pair the mask and causality leave lies inside its
    q tile's extent; a tile with a row that attends nothing visits all Lk
    keys; without causal masking the extent is the last attended key + 1."""
    mask, Lk, causal = _masks()[name]
    B = 3 if mask is None else mask.shape[0]
    Lq = 37 if name.startswith("cross") else Lk
    rows = tiles[0]
    allowed = _allowed(mask, B, Lq, Lk, causal)
    e, f = _flash_cuda.key_extent(mask, B, Lk)
    for b in range(B):
        for q0 in range(0, Lq, rows):
            ext = _flash_cuda.visit_keys(int(e[b]), int(f[b]), Lq, Lk, q0, rows, causal)
            tile = allowed[b, q0:q0 + rows]
            assert 1 <= ext <= Lk
            assert not tile[:, ext:].any(), (b, q0, ext)
            if not tile.any(axis=1).all():
                assert ext == Lk
            elif not causal:
                assert ext == int(np.nonzero(tile.any(axis=0))[0].max()) + 1


def test_causal_rows_that_start_masked_visit_every_key():
    """Under causal masking a q tile whose first row comes before the first
    real key holds rows with no key at all: the tile visits all Lk keys, so
    those rows get the uniform mean over Lk (the rule's f <= q0 clause)."""
    Lk = 300
    m = np.zeros((1, Lk), bool)
    m[0, 70:90] = True
    e, f = _flash_cuda.key_extent(m, 1, Lk)
    assert (int(e[0]), int(f[0])) == (90, 70)
    assert _flash_cuda.visit_keys(90, 70, Lk, Lk, 0, 64, True) == Lk
    assert _flash_cuda.visit_keys(90, 70, Lk, Lk, 64, 64, True) == Lk  # rows 64..69
    assert _flash_cuda.visit_keys(90, 70, Lk, Lk, 128, 64, True) == 90
    assert _flash_cuda.visit_keys(90, 70, Lk, Lk, 0, 64, False) == 90


def test_the_bank_visits_one_key_tile_a_q_tile():
    """At the SigLIP bank's masks (2 to 21 real keys of 512) the forward and
    the dQ kernel visit one key tile a q tile, and only the dK/dV blocks of
    the first 64 keys visit any q tile: the others write zeros."""
    mask = _bank_mask(280, 512, 24)
    fwd = _flash_cuda.visited_key_tiles(mask, 280, 512, 512, False)
    dq = _flash_cuda.visited_key_tiles(mask, 280, 512, 512, False, _flash_cuda.DQ_TILES)
    assert fwd.shape == (280, 4) and (fwd == 1).all()
    assert dq.shape == (280, 4) and (dq == 1).all()
    dkv = _flash_cuda.visited_key_tiles(mask, 280, 512, 512, False, _flash_cuda.DKV_TILES)
    assert dkv.shape == (280, 8) and (dkv == 1).all()  # key block 0 only
    assert _flash_cuda.key_cut(mask, 280, 512) == 128
    full = np.ones((2, 512), bool)
    assert (_flash_cuda.visited_key_tiles(full, 2, 512, 512, False) == 4).all()
    assert _flash_cuda.key_cut(full, 2, 512) == 512
    dead = mask[:3].copy()
    dead[1] = False
    assert (_flash_cuda.visited_key_tiles(dead, 3, 512, 512, False)[1] == 4).all()
    assert _flash_cuda.key_cut(dead, 3, 512) == 512


# --------------------------------------------------------------------------- #
# why the skip is exact: the plain version over the cut keys


def _np(shape, seed):
    return (np.random.default_rng(seed).normal(size=shape) * 0.3).astype(np.float32)


@pytest.mark.parametrize("Lq,Lk", [(200, 200), (70, 300)])
def test_cut_keys_give_the_uncut_result(Lq, Lk):
    """fp32 plain attention over K, V and mask cut to ``key_cut`` equals the
    uncut call, forward and gradients, for every batch row with a valid
    key: the keys past every row's last real key score -FLT_MAX and add
    exactly 0. dK and dV of the cut-off keys are exactly 0."""
    B, H, Dh = 5, 2, 64
    mask = _bank_mask(B, Lk, 5)
    mask[2, :] = False
    mask[2, [3, 30]] = True  # a row with a hole
    q, k, v, do = (torch.from_numpy(_np(s, i)) for i, s in enumerate(
        ((B, H, Lq, Dh), (B, H, Lk, Dh), (B, H, Lk, Dh), (B, H, Lq, Dh))))
    cut = _flash_cuda.key_cut(mask, B, Lk)
    assert cut == 128

    def run(k, v, m):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = flash_attention(*leaves, kv_mask=torch.from_numpy(m))
        return (out.detach(),) + torch.autograd.grad(out, leaves, do)

    full = run(k, v, mask)
    short = run(k[:, :, :cut], v[:, :, :cut], np.ascontiguousarray(mask[:, :cut]))
    for name, a, r in zip(("out", "dq"), full[:2], short[:2]):
        torch.testing.assert_close(a, r, **CUT_TOL, msg=name)
    for name, a, r in zip(("dk", "dv"), full[2:], short[2:]):
        torch.testing.assert_close(a[:, :, :cut], r, **CUT_TOL, msg=name)
        assert float(a[:, :, cut:].abs().max()) == 0.0, name


def test_a_fully_masked_row_needs_every_key():
    """A row with no valid key is the uniform mean of v over all Lk keys: cut
    to fewer keys it would change, so the rule visits them all."""
    B, H, L, Dh = 2, 1, 100, 64
    q, k, v = (torch.from_numpy(_np((B, H, L, Dh), i)) for i in range(3))
    m = np.zeros((B, L), bool)
    m[0, :5] = True
    out = flash_attention(q, k, v, kv_mask=torch.from_numpy(m))
    torch.testing.assert_close(out[1], v[1].mean(1, keepdim=True).expand(H, L, Dh),
                               atol=1e-6, rtol=1e-6)
    assert _flash_cuda.key_cut(m, B, L) == L


# --------------------------------------------------------------------------- #
# the plain version against the JAX package at a bank-like shape


@pytest.mark.parametrize("causal", [False, True])
def test_bank_like_shape_matches_jax_interpret(causal):
    """[6, 2, 80, 64], 2 to 21 real keys a row (key 0 real: the Pallas
    kernel's contract) and batch row 5 fully masked; forward and gradients
    of flash_attention's CPU path against jax.grad of the JAX function with
    the Pallas kernels in interpret mode, row 5 against the XLA oracle."""
    B, H, L, Dh = 6, 2, 80, 64
    args = [_np((B, H, L, Dh), s) for s in (31, 32, 33)]
    do = _np((B, H, L, Dh), 34)
    m = _bank_mask(B, L, 35)
    m[5] = False

    def jgrads(backend):
        def fn(q, k, v):
            return jfa.flash_attention(q, k, v, kv_mask=jnp.asarray(m), causal=causal,
                                       backend=backend)

        ja = list(map(jnp.asarray, args))
        return (fn(*ja),) + jax.grad(lambda *a: jnp.sum(fn(*a) * jnp.asarray(do)),
                                     argnums=(0, 1, 2))(*ja)

    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    out = flash_attention(*leaves, kv_mask=torch.from_numpy(m), causal=causal)
    got = (out.detach(),) + torch.autograd.grad(out, leaves, torch.from_numpy(do))
    for rows, backend in ((slice(0, 5), "interpret"), (slice(5, 6), "xla")):
        ref = jgrads(backend)
        for i, (g, r) in enumerate(zip(got, ref)):
            np.testing.assert_allclose(g.numpy()[rows], np.asarray(r)[rows],
                                       **(TOL if i == 0 else GTOL))
