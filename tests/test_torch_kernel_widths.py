"""The attention entry points at every precision and head width the JAX
wrappers take, against the JAX package on the CPU.

On the card the port runs fp32 packed attention (K1, K2, K5) and bf16 at
Dh 256 to 512 on the SIMT kernels of ``csrc/``, pads every other even
``[B, H, L, Dh]`` head dim to the next width a kernel takes (K3, K4:
``pad_head_dim``, as the JAX wrapper's ``_repack_halves``), and runs the
ring step (K6) in fp32 and at padded widths. Here, without a card, the
plain versions that those kernels are held to on the card run against
the JAX functions as the JAX package's own tests run them: the Pallas
kernels in interpret mode (the ring against the oracle its own tests
hold the interpreted ring to). The kernel each case runs on the card is a
pure function of type, layout, lengths and head dim, checked here too.
Inputs come from numpy seeds.

Tolerances, fp32 on both sides: forwards 2e-5 (the JAX packed tests'
own), gradients 5e-5 (the port's other backward tests: sums of up to 200
products in another order than the Pallas kernel's, whose forward and
backward each rebuild P), the fused projection 5e-5 / 1e-4 (the JAX
fused-projection tests' own); the train step's scalars rtol 1e-4
(``tests/test_torch_train.py``'s bar) and every gradient leaf within
1e-6 + 1e-3 of the leaf's largest entry (the towers' sums of fp32
products in another order; Adam would turn a leaf's rounding noise into
whole steps of the rate, so the leaves are compared before it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepcoro_clip_tpu.data.patch_wire import patchify_videos
from deepcoro_clip_tpu.flagship import tiny_config as jax_tiny
from deepcoro_clip_tpu.ops import flash_attention as jfa
from deepcoro_clip_tpu.ops import flash_attention_packed as jfap
from deepcoro_clip_tpu.ops.attention import multi_head_attention as jax_mha
from deepcoro_clip_tpu.parallel import MeshSpec as JMeshSpec
from deepcoro_clip_tpu.parallel import make_mesh as jmake_mesh
from deepcoro_clip_tpu.parallel.ring_attention import ring_attention as jring
from deepcoro_clip_tpu.registry import register_all
from deepcoro_clip_tpu.train import clip as jclip

from deepcoro_clip_tpu_torch import convert
from deepcoro_clip_tpu_torch.flagship import tiny_config
from deepcoro_clip_tpu_torch.ops import _flash_cuda, _ring_cuda
from deepcoro_clip_tpu_torch.ops.flash_attention import (
    flash_attention,
    kernel_head_dim,
    pad_head_dim,
)
from deepcoro_clip_tpu_torch.ops.flash_attention_packed import flash_attention_packed
from deepcoro_clip_tpu_torch.ops.rope3d import build_rope3d_tables
from deepcoro_clip_tpu_torch.parallel import MeshSpec, make_mesh, ring_attention
from deepcoro_clip_tpu_torch.parallel.ring_attention import ring_rdma_plain
from deepcoro_clip_tpu_torch.train import clip as tclip

register_all()

TOL = dict(atol=2e-5, rtol=2e-5)
GTOL = dict(atol=5e-5, rtol=5e-5)
PTOL = dict(atol=5e-5, rtol=5e-5)
PGTOL = dict(atol=1e-4, rtol=1e-4)
RING_TOL = dict(atol=2e-5, rtol=2e-4)  # the JAX ring tests' own
SCALAR_TOL = dict(rtol=1e-4, atol=1e-6)
F32, BF16 = torch.float32, torch.bfloat16
B, H = 2, 2


def _np(shape, seed, scale=0.3):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _mask(Lk, seed):
    m = np.random.default_rng(seed).random((B, Lk)) > 0.3
    m[:, 0] = True  # a valid key in every row (the Pallas kernels' contract)
    return m


def _tables(dh, L):
    """3D RoPE tables of ``L`` rows: 8 or 16 clip tokens ahead of the grid."""
    thw = {136: (2, 8, 8), 200: (2, 8, 12), 33: (2, 4, 4)}[L]
    t = build_rope3d_tables(dh, *thw, n_special=L - int(np.prod(thw)))
    return t.sin, t.cos


def _jax_grads(fn, args, do):
    return jax.grad(lambda *a: jnp.sum(fn(*a) * jnp.asarray(do)),
                    argnums=tuple(range(len(args))))(*map(jnp.asarray, args))


def _torch_grads(fn, args, do):
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    out = fn(*leaves)
    assert out.grad_fn is not None
    return out, torch.autograd.grad(out, leaves, torch.from_numpy(do))


# --------------------------------------------------------------------------- #
# K1 / K2: the packed entry in fp32 at Dh 128 and 256, against the Pallas
# kernels in interpret mode


def _packed_kw(mode, dh, L):
    kw = {}
    if mode in ("rope_mask", "rope_causal"):
        sin, cos = _tables(dh, L)
        kw.update(sin=sin, cos=cos)
    if mode == "rope_mask":
        kw["kv_mask"] = _mask(L, 7)
    if mode == "rope_causal":
        kw["causal"] = True
    jkw = {k: (jnp.asarray(v.astype(np.int32)) if k == "kv_mask" else
               v if k == "causal" else jnp.asarray(v)) for k, v in kw.items()}
    tkw = {k: (v if k == "causal" else torch.from_numpy(v)) for k, v in kw.items()}
    return jkw, tkw


@pytest.mark.parametrize("mode", ["rope_mask", "rope_causal"])
@pytest.mark.parametrize("L", [136, 200])
@pytest.mark.parametrize("dh", [128, 256])
def test_fp32_packed_matches_jax_interpret(dh, L, mode):
    """K1 and K2's plain versions, fused ``qkv`` ``[2, L, 3*2*dh]`` in fp32
    with RoPE and a key mask or causal masking, L 136 and 200 (the Pallas
    kernel pads the rows to its tiles): the forward and ``jax.grad``."""
    D = H * dh
    jkw, tkw = _packed_kw(mode, dh, L)
    qkv, do = _np((B, L, 3 * D), dh + L), _np((B, L, D), dh + L + 1)
    ref = jfap.flash_attention_packed(qkv=jnp.asarray(qkv), num_heads=H,
                                      backend="interpret", **jkw)
    got = flash_attention_packed(qkv=torch.from_numpy(qkv), num_heads=H, **tkw)
    assert got.dtype == F32 and got.shape == (B, L, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    jg = _jax_grads(lambda x: jfap.flash_attention_packed(
        qkv=x, num_heads=H, backend="interpret", **jkw), [qkv], do)
    _, tg = _torch_grads(lambda x: flash_attention_packed(qkv=x, num_heads=H, **tkw),
                         [qkv], do)
    np.testing.assert_allclose(tg[0].numpy(), np.asarray(jg[0]), **GTOL)


@pytest.mark.parametrize("mode", ["plain", "rope", "mask"])
@pytest.mark.parametrize("dh", [128, 256])
def test_fp32_fused_projection_matches_jax_interpret(dh, mode):
    """K5's plain version in fp32 at ``tests/ops/test_fused_outproj.py``'s
    set-up (B 2, H 2, L 136, ``wo`` ``[D, D]``), at Dh 128 and 256: the
    projected output and the gradients of q, k, v and ``wo``."""
    L, D = 136, H * dh
    kw = {}
    if mode == "rope":
        sin, cos = _tables(dh, L)
        kw = dict(sin=sin, cos=cos)
    if mode == "mask":
        kw = dict(kv_mask=(np.arange(L) < L - 9)[None].repeat(B, 0))
    jkw = {k: jnp.asarray(v.astype(np.int32) if k == "kv_mask" else v) for k, v in kw.items()}
    tkw = {k: torch.from_numpy(v) for k, v in kw.items()}
    args = [_np((B, L, D), 70 + i) for i in range(3)] + [_np((D, D), 73, 0.1)]
    ref = jfap.flash_attention_packed(*map(jnp.asarray, args[:3]), num_heads=H,
                                      wo=jnp.asarray(args[3]), backend="interpret", **jkw)
    got = flash_attention_packed(*map(torch.from_numpy, args[:3]), num_heads=H,
                                 wo=torch.from_numpy(args[3]), **tkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **PTOL)
    gy = _np((B, L, D), 74)
    jg = _jax_grads(lambda q, k, v, w: jfap.flash_attention_packed(
        q, k, v, num_heads=H, wo=w, backend="interpret", **jkw), args, gy)
    _, tg = _torch_grads(lambda q, k, v, w: flash_attention_packed(
        q, k, v, num_heads=H, wo=w, **tkw), args, gy)
    for name, g, r in zip(("dq", "dk", "dv", "dwo"), tg, jg):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **PGTOL, err_msg=name)


@pytest.mark.parametrize("dh", [128, 256])
def test_fp32_packed_operator_exports(dh):
    """A no-grad fp32 packed call is one ``deepcoro::attention`` node under
    ``torch.export`` (its fake kernel gives the fp32 output), and the
    exported program computes what the eager call does on the CPU."""

    class Packed(torch.nn.Module):
        def forward(self, qkv):
            return flash_attention_packed(qkv=qkv, num_heads=H)

    x = torch.from_numpy(_np((B, 10, 3 * H * dh), 5))
    with torch.no_grad():
        ep = torch.export.export(Packed(), (x,))
        got, want = ep.module()(x), Packed()(x)
    assert any("deepcoro.attention" in str(n.target) for n in ep.graph.nodes)
    assert got.dtype == F32
    torch.testing.assert_close(got, want, atol=0, rtol=0)


# --------------------------------------------------------------------------- #
# K3 / K4 at the head dims the kernels do not take: padded as JAX pads


@pytest.mark.parametrize("dh,rope,L", [(32, True, 33), (96, False, 136),
                                       (192, True, 136), (96, True, 200)])
def test_padded_head_dims_match_jax_interpret(dh, rope, L):
    """``pad_head_dim`` to ``kernel_head_dim`` (32 -> 64, 96 -> 128, 192 ->
    256), then the plain version at the padded width with the scale of the
    original ``Dh ** -0.5``, the output cut back to Dh: against the JAX
    ``flash_attention`` in interpret mode (which pads to 128 itself), with
    a key mask; forward and gradients. Dh 32 with RoPE is the JAX test's
    own 3D-RoPE case (``tests/ops/test_flash_attention.py``: T 2, H 4, W 4
    and one special token)."""
    width = kernel_head_dim(dh)
    assert width in _flash_cuda.HEAD_DIMS and width > dh
    sin = cos = None
    if rope:
        sin, cos = _tables(dh, L)
    m = _mask(L, 11)
    args = [_np((B, 3, L, dh), 80 + i) for i in range(3)]
    do = _np((B, 3, L, dh), 83)
    jkw = dict(kv_mask=jnp.asarray(m))
    if rope:
        jkw.update(sin=jnp.asarray(sin), cos=jnp.asarray(cos))
    tsin = None if sin is None else torch.from_numpy(sin)
    tcos = None if cos is None else torch.from_numpy(cos)

    def padded_call(q, k, v):
        qp, kp, vp, sp, cp = pad_head_dim(q, k, v, tsin, tcos, width)
        assert qp.shape[-1] == width and (sp is None or sp.shape == (L, width))
        out = flash_attention(qp, kp, vp, sin=sp, cos=cp, kv_mask=torch.from_numpy(m),
                              scale=dh ** -0.5)
        return out[..., :dh]

    ref = jfa.flash_attention(*map(jnp.asarray, args), backend="interpret", **jkw)
    got = padded_call(*map(torch.from_numpy, args))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    # the entry point on the CPU (no padding there) gives the same numbers
    direct = flash_attention(*map(torch.from_numpy, args), sin=tsin, cos=tcos,
                             kv_mask=torch.from_numpy(m))
    np.testing.assert_allclose(got.numpy(), direct.numpy(), atol=1e-6, rtol=1e-6)
    jg = _jax_grads(lambda q, k, v: jfa.flash_attention(
        q, k, v, backend="interpret", **jkw), args, do)
    _, tg = _torch_grads(padded_call, args, do)
    for name, g, r in zip(("dq", "dk", "dv"), tg, jg):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **GTOL, err_msg=name)


@pytest.mark.parametrize("dh,rope", [(32, True), (96, False), (192, True)])
def test_padded_columns_of_every_gradient_are_zero(dh, rope):
    """The gradients of the padded q, k, v are exactly 0 in the pad: zero
    columns of q and k add nothing to any score, the cut output sends no
    gradient into v's pad, and RoPE's transpose maps the pad onto itself
    (sin 0, cos 1 there)."""
    L, width = 33 if dh == 32 else 136, kernel_head_dim(dh)
    sin = cos = None
    if rope:
        sin, cos = (torch.from_numpy(t) for t in _tables(dh, L))
    leaves = [torch.from_numpy(_np((B, 3, L, dh), 90 + i)) for i in range(3)]
    padded = [t.requires_grad_() for t in pad_head_dim(*leaves, sin, cos, width)[:3]]
    sp, cp = pad_head_dim(*leaves, sin, cos, width)[3:]
    out = flash_attention(*padded, sin=sp, cos=cp, scale=dh ** -0.5)[..., :dh]
    grads = torch.autograd.grad(out, padded, torch.from_numpy(_np((B, 3, L, dh), 93)))
    half, ph = dh // 2, width // 2
    real = (torch.cat([torch.arange(half), ph + torch.arange(half)]) if rope
            else torch.arange(dh))
    pad = torch.ones(width, dtype=torch.bool)
    pad[real] = False
    for name, g in zip(("dq", "dk"), grads[:2]):
        assert torch.count_nonzero(g[..., pad]) == 0, name
        assert torch.count_nonzero(g[..., real]) > 0, name
    assert torch.count_nonzero(grads[2][..., dh:]) == 0  # v is padded at its end


def test_pad_head_dim_mirrors_the_jax_repack():
    """The padded tensors are the JAX wrapper's ``_repack_halves`` layout
    with RoPE (sin padded with 0, cos with 1) and plain zero columns
    without it; a width a kernel takes goes through unchanged."""
    x = torch.from_numpy(_np((1, 1, 4, 6), 1))
    s, c = (torch.from_numpy(_np((4, 6), i)) for i in (2, 3))
    q, k, v, sp, cp = pad_head_dim(x, x, x, s, c, 10)
    for got, t, fill in ((q, x, 0.0), (sp, s, 0.0), (cp, c, 1.0)):
        want = np.asarray(jfa._repack_halves(jnp.asarray(t.numpy()), 3, 5, fill))
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(v.numpy(), np.pad(x.numpy(), [(0, 0)] * 3 + [(0, 4)]))
    q, _, _, sp, cp = pad_head_dim(x, x, x, None, None, 10)
    assert sp is None and cp is None and torch.equal(q[..., 6:], torch.zeros(1, 1, 4, 4))
    assert pad_head_dim(x, x, x, s, c, 6)[0] is x


# --------------------------------------------------------------------------- #
# K6 in fp32, and at a padded head dim


@pytest.mark.parametrize("dh", [128, 96])
@pytest.mark.parametrize("n", [2, 4])
def test_fp32_ring_matches_jax(n, dh):
    """K6's plain version (the slot protocol) in fp32 at Dh 128 and at Dh
    96, which the card's ring pads to 128 (``_ring_cuda._pad_operands``,
    the scale the caller's ``96 ** -0.5``), against the JAX ring's oracle
    (``multi_head_attention`` over the whole sequence, what its own tests
    hold the interpreted ring to) and the JAX ``"xla"`` ring."""
    q, k, v = (_np((2, 2, 64, dh), 100 + dh + i, 1.0) for i in range(3))
    jargs = [jnp.asarray(x) for x in (q, k, v)]
    oracle = np.asarray(jax_mha(*jargs))
    jmesh = jmake_mesh(JMeshSpec(data=1, model=n), devices=jax.devices()[:n])
    xla = np.asarray(jring(*jargs, jmesh, axis="model", backend="xla"))
    mesh = make_mesh(MeshSpec(data=1, model=n), devices=["cpu"] * n)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = ring_attention(tq, tk, tv, mesh, backend="rdma")
    assert got.dtype == F32
    for ref in (oracle, xla):
        np.testing.assert_allclose(got.numpy(), ref, **RING_TOL)
    # the padded pass the card runs: chunks padded to the kernel's width
    chunks = [list(t.chunk(n, dim=2)) for t in (tq, tk, tv)]
    outs = [torch.empty_like(c) for c in chunks[0]]
    qs, ks, vs, pouts, cut = _ring_cuda._pad_operands(*chunks, outs)
    assert qs[0].shape[-1] == kernel_head_dim(dh)
    assert (cut is None) == (dh == 128)
    padded = ring_rdma_plain(qs, ks, vs, dh ** -0.5)
    got = torch.cat([o[..., :dh] for o in padded], dim=2)
    np.testing.assert_allclose(got.numpy(), oracle, **RING_TOL)


# --------------------------------------------------------------------------- #
# the kernel each new case runs on the card


@pytest.mark.parametrize("dtype,packed,L,dh,fwd,bwd", [
    (F32, True, 1569, 128, "deepcoro_flash_fwd_f32", "deepcoro_flash_bwd_f32"),
    (F32, True, 10, 512, "deepcoro_flash_fwd_f32", "deepcoro_flash_bwd_f32"),
    (BF16, True, 1569, 256, "deepcoro_flash_wide_fwd_bf16", "deepcoro_flash_wide_bwd_bf16"),
    (BF16, True, 393, 512, "deepcoro_flash_wide_fwd_bf16", "deepcoro_flash_wide_bwd_bf16"),
    (BF16, False, 10, 256, "deepcoro_flash_wide_fwd_bf16", "deepcoro_flash_wide_bwd_bf16"),
    (F32, False, 512, 384, "deepcoro_flash_fwd_f32", "deepcoro_flash_bwd_f32"),
    (BF16, True, 1569, 128, "deepcoro_flash_fwd_sm90_bf16", "deepcoro_flash_bwd_sm90_bf16"),
])
def test_kernel_choice_for_the_new_cases(dtype, packed, L, dh, fwd, bwd):
    """fp32 packed (K1, K2 on the SIMT fp32 kernels), wide bf16 (the wide
    SIMT kernels, also below the short lengths), wide fp32, and the bf16
    Hopper route left as it was."""
    assert _flash_cuda.fwd_symbol(dtype, packed, L, L, dh) == fwd
    assert _flash_cuda.bwd_symbol(dtype, packed, L, L, dh) == bwd


@pytest.mark.parametrize("dh,width,dtype,fwd", [
    (32, 64, F32, "deepcoro_flash_short_fwd_f32"),       # the aggregator's Dh 32, L 1
    (96, 128, BF16, "deepcoro_flash_long_fwd_bf16"),
    (192, 256, BF16, "deepcoro_flash_wide_fwd_bf16"),
    (192, 256, F32, "deepcoro_flash_fwd_f32"),
    (500, 512, BF16, "deepcoro_flash_wide_fwd_bf16"),
])
def test_kernel_choice_at_a_padded_width(dh, width, dtype, fwd):
    L = 1 if dh == 32 else 300
    assert kernel_head_dim(dh) == width
    assert _flash_cuda.fwd_symbol(dtype, False, L, L, width) == fwd
    with pytest.raises(ValueError, match="Dh in"):
        _flash_cuda.fwd_symbol(dtype, False, L, L, dh)


@pytest.mark.parametrize("dtype,dh,H_,dout,symbol", [
    (F32, 128, 4, 512, "deepcoro_flash_fwd_proj_f32"),
    (F32, 512, 2, 300, "deepcoro_flash_fwd_proj_f32"),
    (BF16, 256, 2, 512, "deepcoro_flash_fwd_proj_wide_bf16"),
    (BF16, 128, 4, 512, "deepcoro_flash_fwd_proj_bf16"),
])
def test_fused_projection_kernel_choice(dtype, dh, H_, dout, symbol):
    """K5: the Hopper kernel in bf16 at Dh 128, the SIMT kernel for fp32 and
    for bf16 at Dh 256 to 512; past ``H*Dh`` 1024, at a Dh no kernel takes,
    in fp16 and (Hopper) at a Dout off the 128 grid it raises."""
    assert _flash_cuda.proj_symbol(dtype, dh, H_, dout) == symbol
    with pytest.raises(ValueError, match="H\\*Dh <= 1024"):
        _flash_cuda.proj_symbol(dtype, dh, 2048 // dh + 1, dout)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        _flash_cuda.proj_symbol(torch.float16, dh, H_, dout)
    with pytest.raises(ValueError, match="Dh"):
        _flash_cuda.proj_symbol(dtype, 640, 1, dout)
    if symbol == "deepcoro_flash_fwd_proj_bf16":
        with pytest.raises(ValueError, match="Dout % 128"):
            _flash_cuda.proj_symbol(dtype, dh, H_, 300)


def test_ring_kernel_choice_in_fp32_and_padded():
    assert _ring_cuda.step_symbol(128, F32) == "deepcoro_ring_step_f32"
    assert _ring_cuda.step_symbol(kernel_head_dim(96), F32) == "deepcoro_ring_step_f32"
    assert _ring_cuda.step_symbol(kernel_head_dim(200), BF16) == \
        "deepcoro_ring_step_wide_bf16"
    assert _ring_cuda.step_symbol(kernel_head_dim(32), BF16) == "deepcoro_ring_step_bf16"
    with pytest.raises(ValueError, match="Dh up to 512"):
        kernel_head_dim(513)


# --------------------------------------------------------------------------- #
# the slice: a train step at precision fp32 with the kernels' path on


CFG = dict(text_dim=128, text_heads=1, epochs=2, label_smoothing=0.1, vit_depth=2)
STEPS_PER_EPOCH = 4


def _batch(cfg, seed=0, n=4):
    r = np.random.default_rng(seed)
    videos = r.integers(0, 255, size=(n, cfg.num_videos, cfg.frames, cfg.resize,
                                      cfg.resize, 3)).astype(np.uint8)
    mask = np.ones((n, cfg.num_videos), bool)
    mask[1, 1] = False
    att = np.ones((n, cfg.max_text_length), np.int32)
    att[2, 9:] = 0
    return {"videos": patchify_videos(videos, (2, 16, 16)), "video_mask": mask,
            "input_ids": r.integers(0, cfg.text_vocab_size,
                                    size=(n, cfg.max_text_length)).astype(np.int32),
            "attention_mask": att}


def _port_grad_tree(bundle, state, batch) -> dict:
    """The port's gradients at ``state``'s weights, flattened under the JAX
    tree's names (written into the modules' parameters, which ``convert``
    then reads as a training tree)."""
    params = state.params
    out = tclip.compute_loss(bundle, params["log_temp"], batch, deterministic=True,
                             logit_bias=params["logit_bias"])
    names = [n for n, p in params.items() if p.requires_grad]
    grads = torch.autograd.grad(out["loss"], [params[n] for n in names], allow_unused=True)
    with torch.no_grad():
        for n, g in zip(names, grads):
            params[n].copy_(torch.zeros_like(params[n]) if g is None else g)
    return float(out["loss"].detach()), convert.flatten_tree(convert.training_tree(
        bundle.video_model, bundle.text_model, params["log_temp"], params["logit_bias"]))


@pytest.mark.parametrize("vit_dim,dh", [(256, 128), (512, 256)])
def test_fp32_train_step_matches_jax(vit_dim, dh):
    """A tiny ``ClipConfig`` at ``precision="fp32"`` and
    ``use_pallas_attention=True`` whose video tower (2 blocks, 2 heads) has
    Dh 128 or 256, the packed path's widths (the text tower: one head of
    128): the JAX step and the port's from the same weights (``convert``).
    Over two train steps the loss, grad norms (total and per tower) and
    alignment per step (rtol 1e-4); at the initial weights the loss and
    every gradient leaf (atol 1e-6 + rtol 1e-3: sums of fp32 products in
    another order, relative to each leaf's largest entry)."""
    kw = dict(CFG, vit_dim=vit_dim, vit_heads=2, precision="fp32")
    jcfg, tcfg = jax_tiny(**kw), tiny_config(use_pallas_attention=True, **kw)
    assert tcfg.vit_dim // tcfg.vit_heads == dh and tcfg.precision == "fp32"
    jmesh = jmake_mesh(JMeshSpec(data=1, model=1), devices=jax.devices()[:1])
    jbundle, jstate = jclip.build_clip_bundle(jcfg, jmesh, jax.random.PRNGKey(0),
                                              steps_per_epoch=STEPS_PER_EPOCH)
    jbundle = jbundle._replace(text_model=jbundle.text_model.clone(proj_dropout=0.0))
    init = jax.tree_util.tree_map(np.asarray, jstate.params)

    def port_bundle():
        bundle, state = tclip.build_clip_bundle(tcfg, seed=0, steps_per_epoch=STEPS_PER_EPOCH,
                                                device="cpu")
        bundle.text_model.proj.dropout = 0.0
        convert.load_training_tree(init, bundle.video_model, bundle.text_model,
                                   state.params["log_temp"], state.params["logit_bias"])
        return bundle, state

    bundle, tstate = port_bundle()
    assert all(m.use_flash for m in bundle.video_model.modules() if hasattr(m, "use_flash"))
    batch = _batch(jcfg)
    jb, tb = jbundle.batch_sharding_fn(batch), tclip.to_device_batch(bundle, batch)
    n_packed = flash_attention_packed.launches

    jloss, jgrads = jax.value_and_grad(lambda p: jclip.compute_loss(
        jbundle, p, jb, {"dropout": jax.random.PRNGKey(0)}, deterministic=True)["loss"])(
        jstate.params)
    tloss, tgrads = _port_grad_tree(*port_bundle(), tb)
    np.testing.assert_allclose(tloss, float(jloss), **SCALAR_TOL)
    jgrads = convert.flatten_tree(jax.tree_util.tree_map(np.asarray, jgrads))
    assert jgrads.keys() == tgrads.keys()
    for k in jgrads:
        top = float(np.abs(jgrads[k]).max())
        np.testing.assert_allclose(tgrads[k], jgrads[k], atol=1e-6 + 1e-3 * top, rtol=0,
                                   err_msg=k)

    jstep, tstep = jclip.make_train_step(jbundle), tclip.make_train_step(bundle)
    for i in range(2):
        jstate, jm = jstep(jstate, jb, jax.random.PRNGKey(i), 0.0, 0.0, -1.0)
        tstate, tm = tstep(tstate, tb, None, 0.0, 0.0, -1.0)
        for key in ("loss", "grad_norm", "grad_norm_video_encoder",
                    "grad_norm_text_encoder", "alignment"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), err_msg=key,
                                       **SCALAR_TOL)
    assert flash_attention_packed.launches == n_packed  # CPU tensors reach no kernel
