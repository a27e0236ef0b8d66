"""Port attention ops (deepcoro_clip_tpu_torch.ops) against the JAX package.

The port's wrappers run their plain PyTorch version on CPU tensors; they
are held against the JAX functions run as the JAX package's own tests run
them on the CPU: the Pallas kernels in interpret mode. Inputs are made with
numpy from a seed and go to both sides in fp32; the tolerance is the one
of tests/ops/test_flash_attention_packed.py (2e-5).

Fully masked key rows compare against the XLA oracle (``backend="xla"``):
there the Pallas kernel averages over the key padding it adds itself
(``sum(v) / padded length``) while the oracle, and the port, return the
uniform mean of v over the real keys.

The CUDA kernels themselves are held against the plain version on the
card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepcoro_clip_tpu.ops import flash_attention as jfa
from deepcoro_clip_tpu.ops import flash_attention_packed as jfap
from deepcoro_clip_tpu.ops.rope3d import build_rope3d_tables as jax_tables

from deepcoro_clip_tpu_torch.ops import _flash_cuda
from deepcoro_clip_tpu_torch.ops.attention import multi_head_attention
from deepcoro_clip_tpu_torch.ops.flash_attention import flash_attention
from deepcoro_clip_tpu_torch.ops.flash_attention_packed import flash_attention_packed
from deepcoro_clip_tpu_torch.ops.rope3d import build_rope3d_tables

TOL = dict(atol=2e-5, rtol=2e-5)


def _np(shape, seed):
    return (np.random.default_rng(seed).normal(size=shape) * 0.3).astype(np.float32)


def _mask(B, Lk, seed, dead_row=None):
    m = np.random.default_rng(seed).random((B, Lk)) > 0.4
    m[:, 0] = True  # at least one valid key (the Pallas kernel's contract)
    if dead_row is not None:
        m[dead_row] = False
    return m


def _rope(dh, thw, n_special=1):
    t = build_rope3d_tables(dh, *thw, n_special=n_special)
    return t.sin, t.cos


@pytest.mark.parametrize("thw,n_special", [((2, 3, 4), 1), ((2, 8, 8), 0),
                                           ((1, 1, 1), 0)])
def test_rope_tables_match_jax(thw, n_special):
    for dh in (64, 128):
        mine = build_rope3d_tables(dh, *thw, n_special=n_special, temporal_scale=2.0)
        ref = jax_tables(dh, *thw, n_special=n_special, temporal_scale=2.0)
        np.testing.assert_array_equal(mine.sin, ref.sin)
        np.testing.assert_array_equal(mine.cos, ref.cos)


# --------------------------------------------------------------------------- #
# K1: packed layout [B, L, H*Dh], Dh = 128

B1, H1, D1 = 2, 2, 256


@pytest.mark.parametrize("case", ["fused_rope_ragged", "qkv_mask_cross",
                                  "causal", "fused_plain"])
def test_packed_matches_jax_interpret(case):
    if case in ("fused_rope_ragged", "fused_plain"):
        sin, cos = _rope(128, (2, 5, 5))  # L = 51 with CLS: not a tile multiple
        L = sin.shape[0]
        qkv = _np((B1, L, 3 * D1), 0)
        rope = {} if case == "fused_plain" else dict(sin=sin, cos=cos)
        ref = jfap.flash_attention_packed(
            qkv=jnp.asarray(qkv), num_heads=H1, backend="interpret",
            **{k: jnp.asarray(v) for k, v in rope.items()})
        got = flash_attention_packed(
            qkv=torch.from_numpy(qkv), num_heads=H1,
            **{k: torch.from_numpy(v) for k, v in rope.items()})
    elif case == "qkv_mask_cross":
        q, k, v = _np((B1, 40, D1), 1), _np((B1, 90, D1), 2), _np((B1, 90, D1), 3)
        m = _mask(B1, 90, 4)
        ref = jfap.flash_attention_packed(
            *map(jnp.asarray, (q, k, v)), num_heads=H1,
            kv_mask=jnp.asarray(m.astype(np.int32)), backend="interpret")
        got = flash_attention_packed(*map(torch.from_numpy, (q, k, v)),
                                     num_heads=H1, kv_mask=torch.from_numpy(m))
    else:
        q, k, v = (_np((B1, 70, D1), s) for s in (5, 6, 7))
        ref = jfap.flash_attention_packed(*map(jnp.asarray, (q, k, v)),
                                          num_heads=H1, causal=True,
                                          backend="interpret")
        got = flash_attention_packed(*map(torch.from_numpy, (q, k, v)),
                                     num_heads=H1, causal=True)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_packed_fully_masked_row_matches_oracle():
    q, k, v = _np((B1, 12, D1), 8), _np((B1, 12, D1), 9), _np((B1, 12, D1), 10)
    m = _mask(B1, 12, 11, dead_row=1)
    ref = jfap.flash_attention_packed(*map(jnp.asarray, (q, k, v)), num_heads=H1,
                                      kv_mask=jnp.asarray(m), backend="xla")
    got = flash_attention_packed(*map(torch.from_numpy, (q, k, v)),
                                 num_heads=H1, kv_mask=torch.from_numpy(m))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    # the dead study is the uniform mean of v over its 12 real keys
    np.testing.assert_allclose(got.numpy()[1], np.broadcast_to(v[1].mean(0), (12, D1)),
                               atol=1e-6)


def test_packed_rejects_unaligned_head_dim():
    x = torch.zeros(1, 4, 3 * 192)
    with pytest.raises(ValueError, match="Dh%128"):
        flash_attention_packed(qkv=x, num_heads=2)


# --------------------------------------------------------------------------- #
# K3: [B, H, L, Dh], any even Dh


@pytest.mark.parametrize("case", ["rope_dh64", "mask_cross_dh64", "causal_dh128",
                                  "plain_dh32"])
def test_standard_matches_jax_interpret(case):
    kw_j, kw_t = {}, {}
    if case == "rope_dh64":
        sin, cos = _rope(64, (2, 3, 5))
        L = Lk = sin.shape[0]
        Dh = 64
        kw_j = dict(sin=jnp.asarray(sin), cos=jnp.asarray(cos))
        kw_t = dict(sin=torch.from_numpy(sin), cos=torch.from_numpy(cos))
    elif case == "mask_cross_dh64":
        L, Lk, Dh = 20, 90, 64
        m = _mask(2, Lk, 12)
        kw_j = dict(kv_mask=jnp.asarray(m))
        kw_t = dict(kv_mask=torch.from_numpy(m))
    elif case == "causal_dh128":
        L = Lk = 70
        Dh = 128
        kw_j = kw_t = dict(causal=True)
    else:
        L = Lk = 33
        Dh = 32
    q, k, v = _np((2, 3, L, Dh), 13), _np((2, 3, Lk, Dh), 14), _np((2, 3, Lk, Dh), 15)
    ref = jfa.flash_attention(*map(jnp.asarray, (q, k, v)), backend="interpret", **kw_j)
    got = flash_attention(*map(torch.from_numpy, (q, k, v)), **kw_t)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_standard_fully_masked_row_matches_oracle():
    """The aggregator's shape: a padded study has no valid video."""
    q, k, v = _np((4, 8, 10, 64), 16), _np((4, 8, 10, 64), 17), _np((4, 8, 10, 64), 18)
    m = np.zeros((4, 10), bool)
    m[0, :7], m[1], m[2, :1] = True, True, True
    ref = jfa.flash_attention(*map(jnp.asarray, (q, k, v)), kv_mask=jnp.asarray(m),
                              backend="xla")
    got = flash_attention(*map(torch.from_numpy, (q, k, v)), kv_mask=torch.from_numpy(m))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(got.numpy()[3],
                               np.broadcast_to(v[3].mean(1, keepdims=True), (8, 10, 64)),
                               atol=1e-6)


def test_plain_bf16_matches_jax_oracle_bf16():
    """bf16 compute: fp32 logits and softmax, P cast to bf16 before P V."""
    sin, cos = _rope(64, (1, 3, 3))
    L = sin.shape[0]
    q, k, v = (_np((2, 2, L, 64), s) for s in (19, 20, 21))
    ref = jfa.flash_attention(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                              sin=jnp.asarray(sin), cos=jnp.asarray(cos), backend="xla")
    got = multi_head_attention(*(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)),
                               sin=torch.from_numpy(sin), cos=torch.from_numpy(cos))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               atol=2e-2, rtol=2e-2)


def test_cpu_tensors_never_reach_the_kernel():
    n1, n3 = flash_attention_packed.launches, flash_attention.launches
    q = torch.zeros(1, 1, 4, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        _flash_cuda.flash_fwd(q, q, q, torch.empty_like(q), sin=None, cos=None,
                              kv_mask=None, causal=False, scale=0.125)
    flash_attention(q, q, q)
    flash_attention_packed(qkv=torch.zeros(1, 4, 3 * 128), num_heads=1)
    assert (flash_attention_packed.launches, flash_attention.launches) == (n1, n3)


@pytest.mark.parametrize("dtype,packed,symbol", [
    (torch.bfloat16, True, "deepcoro_flash_bwd_sm90_bf16"),   # K2: the Hopper kernels
    (torch.bfloat16, False, "deepcoro_flash_long_bwd_bf16"),  # K4: the Hopper ones
    (torch.float32, False, "deepcoro_flash_bwd_f32"),         # K4 on fp32 operands
])
def test_backward_kernel_choice(dtype, packed, symbol):
    """Which C entry of csrc/flash_bwd.cu a backward above the short
    lengths runs: a pure function of the operand type, the layout and the
    lengths, so it is checked here without a card."""
    assert _flash_cuda.bwd_symbol(dtype, packed, 393, 393, 128) == symbol


def test_backward_kernel_choice_rejects_what_no_kernel_takes():
    """fp16 and a head dim above 512 raise; fp32 packed operands, which
    raised before the SIMT kernels took the packed layouts, run them."""
    assert _flash_cuda.bwd_symbol(torch.float32, True, 393, 393, 128) == "deepcoro_flash_bwd_f32"
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        _flash_cuda.bwd_symbol(torch.float16, False, 10, 10, 64)
    with pytest.raises(ValueError, match="Dh in"):
        _flash_cuda.bwd_symbol(torch.float32, True, 393, 393, 640)


# --------------------------------------------------------------------------- #
# backward: flash_bwd_plain and the two autograd Functions (K2, K4)
#
# Held against jax.grad through the JAX functions with backend="interpret":
# the Pallas _bwd_kernels in interpret mode, as tests/ops/ run them. fp32 on
# both sides; tolerance 5e-5 (the gradients sum up to 90 products in another
# order than the Pallas kernel, whose forward and backward each rebuild P).

from deepcoro_clip_tpu_torch.ops.attention import flash_bwd_plain  # noqa: E402

import jax  # noqa: E402

GTOL = dict(atol=5e-5, rtol=5e-5)


def _jax_grads(fn, args, do):
    return jax.grad(lambda *a: jnp.sum(fn(*a) * jnp.asarray(do)),
                    argnums=tuple(range(len(args))))(*map(jnp.asarray, args))


def _torch_grads(fn, args, do):
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    out = fn(*leaves)
    assert out.grad_fn is not None  # the wrappers keep the graph
    return out, torch.autograd.grad(out, leaves, torch.from_numpy(do))


@pytest.mark.parametrize("case", ["fused_rope_ragged", "qkv_mask_cross", "causal"])
def test_packed_backward_matches_jax_interpret(case):
    """K2: flash_attention_packed's Function (flash_bwd_plain on the CPU)
    against jax.grad of ops/flash_attention_packed.flash_attention_packed."""
    if case == "fused_rope_ragged":
        sin, cos = _rope(128, (2, 5, 5))
        L = sin.shape[0]
        args, do = [_np((B1, L, 3 * D1), 30)], _np((B1, L, D1), 31)
        ref = _jax_grads(lambda x: jfap.flash_attention_packed(
            qkv=x, num_heads=H1, sin=jnp.asarray(sin), cos=jnp.asarray(cos),
            backend="interpret"), args, do)
        _, got = _torch_grads(lambda x: flash_attention_packed(
            qkv=x, num_heads=H1, sin=torch.from_numpy(sin),
            cos=torch.from_numpy(cos)), args, do)
    elif case == "qkv_mask_cross":
        args = [_np((B1, 40, D1), 32), _np((B1, 90, D1), 33), _np((B1, 90, D1), 34)]
        do, m = _np((B1, 40, D1), 35), _mask(B1, 90, 36)
        ref = _jax_grads(lambda q, k, v: jfap.flash_attention_packed(
            q, k, v, num_heads=H1, kv_mask=jnp.asarray(m.astype(np.int32)),
            backend="interpret"), args, do)
        _, got = _torch_grads(lambda q, k, v: flash_attention_packed(
            q, k, v, num_heads=H1, kv_mask=torch.from_numpy(m)), args, do)
    else:
        args, do = [_np((B1, 70, D1), s) for s in (37, 38, 39)], _np((B1, 70, D1), 40)
        ref = _jax_grads(lambda q, k, v: jfap.flash_attention_packed(
            q, k, v, num_heads=H1, causal=True, backend="interpret"), args, do)
        _, got = _torch_grads(lambda q, k, v: flash_attention_packed(
            q, k, v, num_heads=H1, causal=True), args, do)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **GTOL)


@pytest.mark.parametrize("case", ["rope_dh64", "mask_cross_dh64", "causal_dh128"])
def test_standard_backward_matches_jax_interpret(case):
    """K4: flash_attention's Function against jax.grad of
    ops/flash_attention.flash_attention."""
    kw_j, kw_t = {}, {}
    if case == "rope_dh64":
        sin, cos = _rope(64, (2, 3, 5))
        L = Lk = sin.shape[0]
        Dh = 64
        kw_j = dict(sin=jnp.asarray(sin), cos=jnp.asarray(cos))
        kw_t = dict(sin=torch.from_numpy(sin), cos=torch.from_numpy(cos))
    elif case == "mask_cross_dh64":
        L, Lk, Dh = 20, 90, 64
        m = _mask(2, Lk, 41)
        kw_j, kw_t = dict(kv_mask=jnp.asarray(m)), dict(kv_mask=torch.from_numpy(m))
    else:
        L = Lk = 70
        Dh = 128
        kw_j = kw_t = dict(causal=True)
    args = [_np((2, 3, L, Dh), 42), _np((2, 3, Lk, Dh), 43), _np((2, 3, Lk, Dh), 44)]
    do = _np((2, 3, L, Dh), 45)
    ref = _jax_grads(lambda q, k, v: jfa.flash_attention(
        q, k, v, backend="interpret", **kw_j), args, do)
    out, got = _torch_grads(lambda q, k, v: flash_attention(q, k, v, **kw_t), args, do)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **GTOL)
    # flash_bwd_plain called directly gives what the Function returned
    direct = flash_bwd_plain(*map(torch.from_numpy, args), torch.from_numpy(do),
                             out.detach(), **kw_t)
    for g, d in zip(got, direct):
        assert torch.equal(g, d)


@pytest.mark.parametrize("mode", ["rope_mask_dead_row", "causal_cross"])
def test_plain_backward_matches_autograd_and_gradcheck(mode):
    """flash_bwd_plain against autograd through multi_head_attention (fp32,
    atol 1e-5), including a row with no valid key, and
    torch.autograd.gradcheck of the Function in float64."""
    if mode == "rope_mask_dead_row":
        sin, cos = _rope(8, (1, 2, 3))
        L = Lk = sin.shape[0]
        m = _mask(2, Lk, 46, dead_row=1)
        kw = dict(sin=torch.from_numpy(sin), cos=torch.from_numpy(cos),
                  kv_mask=torch.from_numpy(m))
    else:
        L, Lk = 5, 9
        kw = dict(causal=True)
    q, k, v = (torch.from_numpy(_np((2, 2, n, 8), s)).requires_grad_()
               for n, s in ((L, 47), (Lk, 48), (Lk, 49)))
    do = torch.from_numpy(_np((2, 2, L, 8), 50))
    out = multi_head_attention(q, k, v, **kw)
    auto = torch.autograd.grad(out, (q, k, v), do)
    mine = flash_bwd_plain(q.detach(), k.detach(), v.detach(), do, out.detach(), **kw)
    for a, b in zip(auto, mine):
        torch.testing.assert_close(b, a, atol=1e-5, rtol=1e-5)
    if mode == "rope_mask_dead_row":  # no gradient through masked scores
        assert float(mine[0][1].abs().max()) == 0.0
        assert float(mine[1][1].abs().max()) == 0.0
    kw64 = {n: (t.double() if t.is_floating_point() else t) for n, t in kw.items()
            if isinstance(t, torch.Tensor)}
    kw64.update({n: t for n, t in kw.items() if not isinstance(t, torch.Tensor)})
    q64, k64, v64 = (t.detach().double().requires_grad_() for t in (q, k, v))
    assert torch.autograd.gradcheck(
        lambda a, b, c: flash_attention(a, b, c, **kw64), (q64, k64, v64))


def test_wrappers_keep_the_graph_and_count_nothing_on_the_cpu():
    """With gradients enabled the outputs carry a grad_fn and every input
    gets its gradient (fused: one [B, L, 3D] tensor); without, no graph."""
    counts = (flash_attention_packed.launches, flash_attention_packed.bwd_launches,
              flash_attention.launches, flash_attention.bwd_launches)
    qkv = torch.from_numpy(_np((1, 6, 3 * 128), 51)).requires_grad_()
    out = flash_attention_packed(qkv=qkv, num_heads=1)
    assert out.grad_fn is not None
    (g,) = torch.autograd.grad(out.sum(), qkv)
    assert g.shape == qkv.shape and float(g.abs().max()) > 0
    q = torch.from_numpy(_np((1, 2, 6, 16), 52)).requires_grad_()
    k = torch.from_numpy(_np((1, 2, 6, 16), 53))  # no gradient wanted for k
    out = flash_attention(q, k, k)
    assert out.grad_fn is not None
    out.sum().backward()
    assert q.grad is not None and k.grad is None
    with torch.no_grad():
        assert flash_attention(q, k, k).grad_fn is None
    assert counts == (flash_attention_packed.launches, flash_attention_packed.bwd_launches,
                      flash_attention.launches, flash_attention.bwd_launches)


# --------------------------------------------------------------------------- #
# K5: the output projection fused into the packed forward (wo=)
#
# Held against the JAX function with wo= and backend="interpret" (the Pallas
# _fwd_proj_kernel in interpret mode, as tests/ops/test_fused_outproj.py runs
# it), gradients by jax.grad. fp32 on both sides: 5e-5 forward, 1e-4
# gradients, the JAX tests' own tolerances.

PTOL = dict(atol=5e-5, rtol=5e-5)
PGTOL = dict(atol=1e-4, rtol=1e-4)


def _proj_case(case):
    """(args, torch kwargs, jax kwargs, fused?) of one mode."""
    kw_t, kw_j = {}, {}
    L = Lk = 70
    if case in ("fused_rope_ragged", "fused_plain"):
        sin, cos = _rope(128, (2, 5, 5))
        L = Lk = sin.shape[0]
        if case == "fused_rope_ragged":
            kw_t = dict(sin=torch.from_numpy(sin), cos=torch.from_numpy(cos))
            kw_j = dict(sin=jnp.asarray(sin), cos=jnp.asarray(cos))
    elif case == "qkv_mask_cross":
        L, Lk = 40, 90
        m = _mask(B1, Lk, 60)
        kw_t = dict(kv_mask=torch.from_numpy(m))
        kw_j = dict(kv_mask=jnp.asarray(m.astype(np.int32)))
    elif case == "causal":
        kw_t = kw_j = dict(causal=True)
    fused = case.startswith("fused")
    if fused:
        args = [_np((B1, L, 3 * D1), 61)]
    else:
        args = [_np((B1, L, D1), 62), _np((B1, Lk, D1), 63), _np((B1, Lk, D1), 64)]
    wo = (np.random.default_rng(65).normal(size=(D1, 384)) * 0.1).astype(np.float32)
    return args + [wo], kw_t, kw_j, fused, L


def _proj_fns(kw_t, kw_j, fused):
    if fused:
        return (lambda x, w: flash_attention_packed(qkv=x, num_heads=H1, wo=w, **kw_t),
                lambda x, w: jfap.flash_attention_packed(
                    qkv=x, num_heads=H1, wo=w, backend="interpret", **kw_j))
    return (lambda q, k, v, w: flash_attention_packed(q, k, v, num_heads=H1, wo=w, **kw_t),
            lambda q, k, v, w: jfap.flash_attention_packed(
                q, k, v, num_heads=H1, wo=w, backend="interpret", **kw_j))


@pytest.mark.parametrize("case", ["fused_rope_ragged", "fused_plain", "qkv_mask_cross",
                                  "causal"])
def test_fused_projection_matches_jax_interpret(case):
    """K5 forward: [B, Lq, Dout] with Dout != D, fused and separate operands,
    RoPE, key mask with Lq != Lk, causal; and the same numbers as the
    unfused call followed by the product."""
    args, kw_t, kw_j, fused, L = _proj_case(case)
    tfn, jfn = _proj_fns(kw_t, kw_j, fused)
    ref = jfn(*map(jnp.asarray, args))
    n = flash_attention_packed.proj_launches
    got = tfn(*map(torch.from_numpy, args))
    assert got.shape == (B1, L, 384) == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **PTOL)
    targs = list(map(torch.from_numpy, args))
    unfused = (flash_attention_packed(qkv=targs[0], num_heads=H1, **kw_t) if fused
               else flash_attention_packed(*targs[:3], num_heads=H1, **kw_t))
    np.testing.assert_allclose(got.numpy(), (unfused @ targs[-1]).numpy(), **PTOL)
    assert flash_attention_packed.proj_launches == n  # CPU tensors reach no kernel


@pytest.mark.parametrize("case", ["fused_rope_ragged", "qkv_mask_cross", "causal"])
def test_fused_projection_backward_matches_jax_interpret(case):
    """K5's Function on the CPU (do = gy wo^T and dwo = out^T gy as matrix
    products, dq/dk/dv from flash_bwd_plain) against jax.grad through the
    Pallas kernels in interpret mode: one [B, L, 3D] gradient for the fused
    operand, and dwo."""
    args, kw_t, kw_j, fused, L = _proj_case(case)
    tfn, jfn = _proj_fns(kw_t, kw_j, fused)
    gy = _np((B1, L, 384), 66)
    ref = _jax_grads(jfn, args, gy)
    out, got = _torch_grads(tfn, args, gy)
    assert len(got) == len(args) and got[0].shape == args[0].shape
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **PGTOL)


def test_fused_projection_fully_masked_row_matches_oracle():
    """A row with no valid key follows the XLA oracle, as K1 does: the
    uniform mean of v over the real keys, projected."""
    q, k, v = _np((B1, 12, D1), 67), _np((B1, 12, D1), 68), _np((B1, 12, D1), 69)
    wo = _np((D1, D1), 70)
    m = _mask(B1, 12, 71, dead_row=1)
    ref = jfap.flash_attention_packed(*map(jnp.asarray, (q, k, v)), num_heads=H1,
                                      kv_mask=jnp.asarray(m), wo=jnp.asarray(wo),
                                      backend="xla")
    got = flash_attention_packed(*map(torch.from_numpy, (q, k, v)), num_heads=H1,
                                 kv_mask=torch.from_numpy(m), wo=torch.from_numpy(wo))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **PTOL)
    np.testing.assert_allclose(got.numpy()[1], np.broadcast_to(v[1].mean(0) @ wo, (12, D1)),
                               atol=1e-5)


def test_fused_projection_rounds_where_the_kernel_does():
    """bf16 operands: wo is cast to the operands' type, the attention output
    is rounded to bf16 before the product, the product sums in fp32 and is
    rounded once; and wo of another height raises."""
    from deepcoro_clip_tpu_torch.ops.attention import project_plain

    qkv = torch.from_numpy(_np((1, 9, 3 * D1), 72)).to(torch.bfloat16)
    wo = torch.from_numpy(_np((D1, 128), 73))
    got = flash_attention_packed(qkv=qkv, num_heads=H1, wo=wo)
    out = flash_attention_packed(qkv=qkv, num_heads=H1)
    assert got.dtype == torch.bfloat16 and out.dtype == torch.bfloat16
    want = (out.float() @ wo.to(torch.bfloat16).float()).to(torch.bfloat16)
    assert torch.equal(got, want)
    assert torch.equal(got, project_plain(out, wo.to(torch.bfloat16)))
    with pytest.raises(ValueError, match="wo must be"):
        flash_attention_packed(qkv=qkv, num_heads=H1, wo=wo[:100])


def test_fused_projection_keeps_the_graph_and_counts_nothing_on_the_cpu():
    counts = (flash_attention_packed.launches, flash_attention_packed.proj_launches,
              flash_attention_packed.bwd_launches)
    qkv = torch.from_numpy(_np((1, 6, 3 * 128), 74)).requires_grad_()
    wo = torch.from_numpy(_np((128, 128), 75)).requires_grad_()
    y = flash_attention_packed(qkv=qkv, num_heads=1, wo=wo)
    assert y.grad_fn is not None
    y.sum().backward()
    assert qkv.grad.shape == qkv.shape and wo.grad.shape == wo.shape
    frozen = flash_attention_packed(qkv=qkv.detach(), num_heads=1, wo=wo)  # only dwo wanted
    (dwo,) = torch.autograd.grad(frozen.sum(), wo)
    torch.testing.assert_close(dwo, wo.grad)
    with torch.no_grad():
        assert flash_attention_packed(qkv=qkv, num_heads=1, wo=wo).grad_fn is None
    assert counts == (flash_attention_packed.launches, flash_attention_packed.proj_launches,
                      flash_attention_packed.bwd_launches)


# --------------------------------------------------------------------------- #
# cross-attention as AttentionPool calls it: one query over a clip's tokens


@pytest.mark.parametrize("dh", [64, 128])
def test_single_query_cross_attention_matches_jax_interpret(dh):
    """Lq = 1 against Lk = 45 keys with a key mask, forward and gradients:
    the [B, H, L, Dh] entry at Dh 64 (K3/K4) and the packed entry at Dh 128
    (K1/K2), each against its JAX function in interpret mode."""
    H, Lk = 256 // dh, 45
    m = _mask(2, Lk, 80)
    do = _np((2, 1, 256), 84)
    args = [_np((2, 1, 256), 81), _np((2, Lk, 256), 82), _np((2, Lk, 256), 83)]
    if dh == 128:
        jfn = lambda q, k, v: jfap.flash_attention_packed(  # noqa: E731
            q, k, v, num_heads=H, kv_mask=jnp.asarray(m.astype(np.int32)),
            backend="interpret")
        tfn = lambda q, k, v: flash_attention_packed(  # noqa: E731
            q, k, v, num_heads=H, kv_mask=torch.from_numpy(m))
    else:
        def jfn(q, k, v):
            heads = [t.reshape(2, -1, H, dh).transpose(0, 2, 1, 3) for t in (q, k, v)]
            out = jfa.flash_attention(*heads, kv_mask=jnp.asarray(m), backend="interpret")
            return out.transpose(0, 2, 1, 3).reshape(2, 1, 256)

        def tfn(q, k, v):
            heads = [t.reshape(2, -1, H, dh).transpose(1, 2) for t in (q, k, v)]
            out = flash_attention(*heads, kv_mask=torch.from_numpy(m))
            return out.transpose(1, 2).reshape(2, 1, 256)
    ref = jfn(*map(jnp.asarray, args))
    out, got = _torch_grads(tfn, args, do)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
    for g, r in zip(got, _jax_grads(jfn, args, do)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **GTOL)
