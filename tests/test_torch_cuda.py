"""The port's CUDA kernels against their plain PyTorch version, on the card.

Every test here needs an NVIDIA card (a CUDA kernel has no CPU mode) and
skips without one. The file imports no JAX, so on a machine that has the
card but no JAX it runs without the suite's conftest (which imports JAX):

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerance, kernel vs plain in bf16: atol 1e-2, rtol 1e-2 (outputs are
rounded to bf16, 2^-8 relative, and P is rounded to bf16 against the
running max in the kernel but the final max in the plain version). The
backward kernels against ``flash_bwd_plain``: atol 2e-2, rtol 2e-2 (dq, dk,
dv are sums over up to 199 bf16-rounded products, each rounded once more
to bf16 on the way out, and the plain version starts from its own ``out``).
"""

import pytest
import torch

from deepcoro_clip_tpu_torch.ops.attention import (
    flash_bwd_plain,
    multi_head_attention,
    project_plain,
)
from deepcoro_clip_tpu_torch.ops.flash_attention import flash_attention
from deepcoro_clip_tpu_torch.ops.flash_attention_packed import flash_attention_packed
from deepcoro_clip_tpu_torch.ops.rope3d import build_rope3d_tables

pytestmark = pytest.mark.cuda
TOL = dict(atol=1e-2, rtol=1e-2)


@pytest.fixture(scope="session")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    # every source built before the first test: on the H100 machine, once a
    # source had been built in the process after the profiler's first
    # trace, later traces dropped the port's kernels (the same tests passed
    # in a second process, whose sources were built already)
    from deepcoro_clip_tpu_torch.ops import _build

    _build.build_all()
    return torch.device("cuda")


def _rope(dh, device):
    t = build_rope3d_tables(dh, 2, 9, 11, n_special=1)  # L = 199
    return (torch.from_numpy(t.sin).to(device), torch.from_numpy(t.cos).to(device))


@pytest.mark.parametrize("mode", ["rope", "mask", "causal", "plain"])
def test_kernels_match_plain(cuda, mode):
    """Both entry points on one [2, 199, 512] bf16 input: K1 with 4 heads
    of 128, K3 with 8 heads of 64. L = 199 is ragged against the tiles."""
    g = torch.Generator(device=cuda).manual_seed(0)
    L = 199
    q, k, v = (torch.randn(2, L, 512, generator=g, device=cuda).to(torch.bfloat16)
               for _ in range(3))
    kw = {128: {}, 64: {}}
    for dh in kw:
        if mode == "rope":
            sin, cos = _rope(dh, cuda)
            kw[dh] = dict(sin=sin, cos=cos)
        elif mode == "causal":
            kw[dh] = dict(causal=True)
    if mode == "mask":
        m = torch.rand(2, L, generator=g, device=cuda) > 0.5
        m[1] = False  # no valid key: the uniform mean of v
        kw = {dh: dict(kv_mask=m) for dh in kw}
    n1, n3 = flash_attention_packed.launches, flash_attention.launches
    got = flash_attention_packed(q, k, v, num_heads=4, **kw[128])
    qh, kh, vh = (t.unflatten(2, (4, 128)).transpose(1, 2) for t in (q, k, v))
    ref = multi_head_attention(qh, kh, vh, **kw[128]).transpose(1, 2).reshape(2, L, 512)
    torch.testing.assert_close(got.float(), ref.float(), **TOL)
    q4, k4, v4 = (t.unflatten(2, (8, 64)).transpose(1, 2) for t in (q, k, v))
    got4 = flash_attention(q4, k4, v4, **kw[64])
    ref4 = multi_head_attention(q4, k4, v4, **kw[64])
    torch.testing.assert_close(got4.float(), ref4.float(), **TOL)
    assert (flash_attention_packed.launches, flash_attention.launches) == (n1 + 1, n3 + 1)


def test_fused_qkv_matches_separate_views(cuda):
    g = torch.Generator(device=cuda).manual_seed(1)
    qkv = torch.randn(3, 150, 3 * 256, generator=g, device=cuda).to(torch.bfloat16)
    q, k, v = qkv.split(256, dim=-1)
    a = flash_attention_packed(qkv=qkv, num_heads=2)
    b = flash_attention_packed(q.contiguous(), k.contiguous(), v.contiguous(), num_heads=2)
    assert torch.equal(a, b)  # same arithmetic, only the strides differ


@pytest.mark.parametrize("proj", [False, True])
def test_results_do_not_depend_on_batch_size(cuda, proj):
    """Fixed tiles: a study's output is bit-identical alone or in a batch,
    through K1 and through K5 (whose q-tile height changes with the width
    but never with the batch)."""
    g = torch.Generator(device=cuda).manual_seed(2)
    sin, cos = _rope(128, cuda)
    qkv = torch.randn(5, 199, 3 * 512, generator=g, device=cuda).to(torch.bfloat16)
    wo = torch.randn(512, 512, generator=g, device=cuda) / 23 if proj else None
    full = flash_attention_packed(qkv=qkv, num_heads=4, sin=sin, cos=cos, wo=wo)
    one = flash_attention_packed(qkv=qkv[3:4], num_heads=4, sin=sin, cos=cos, wo=wo)
    assert torch.equal(full[3:4], one)


def _ragged_rope(L, device):
    """RoPE tables of the tower's 1 + T*H*W token layout for L tokens."""
    thw = {1569: (8, 14, 14), 393: (8, 7, 7), 130: (1, 3, 43), 10: (1, 3, 3)}[L]
    t = build_rope3d_tables(128, *thw, n_special=1)
    return (torch.from_numpy(t.sin).to(device), torch.from_numpy(t.cos).to(device))


def _packed_plain(q, k, v, H, **kw):
    B, Lq, D = q.shape
    heads = [t.unflatten(2, (H, t.shape[2] // H)).transpose(1, 2) for t in (q, k, v)]
    return multi_head_attention(*heads, **kw).transpose(1, 2).reshape(B, Lq, D)


@pytest.mark.parametrize("proj", [False, True])
def test_rope_in_the_kernel_rotates_as_the_plain_version(cuda, proj):
    """K1 and K5 rotate q in shared memory and K in a pre-pass, with the
    plain version's bf16 rounding points: the same bits as the kernel on q
    and k rotated beforehand by ``apply_rope``."""
    from deepcoro_clip_tpu_torch.ops.attention import apply_rope

    g = torch.Generator(device=cuda).manual_seed(11)
    sin, cos = _ragged_rope(393, cuda)
    qkv = torch.randn(3, 393, 3 * 512, generator=g, device=cuda).to(torch.bfloat16)
    q, k, v = qkv.split(512, dim=-1)
    qr, kr = (apply_rope(t.unflatten(2, (4, 128)).transpose(1, 2), sin, cos)
              .transpose(1, 2).reshape(3, 393, 512) for t in (q, k))
    wo = torch.randn(512, 512, generator=g, device=cuda) / 23 if proj else None
    got = flash_attention_packed(qkv=qkv, num_heads=4, sin=sin, cos=cos, wo=wo)
    assert torch.equal(got, flash_attention_packed(qr, kr, v.contiguous(), num_heads=4,
                                                   wo=wo))


@pytest.mark.parametrize("L", [1569, 393, 130, 10])
def test_packed_kernels_at_ragged_lengths(cuda, L):
    """K1 and K5 on fused qkv with RoPE at the tower's lengths and two
    short ones, all ragged against the 128-row q tiles and the 128 / 64-key
    tiles: against the plain versions, bit-equal run to run, and (below
    the tower's first length) K2's gradients from the statistics the
    Hopper forward wrote against flash_bwd_plain."""
    g = torch.Generator(device=cuda).manual_seed(9)
    B = 2 if L == 1569 else 3
    sin, cos = _ragged_rope(L, cuda)
    qkv = torch.randn(B, L, 3 * 512, generator=g, device=cuda).to(torch.bfloat16)
    q, k, v = qkv.split(512, dim=-1)
    wo = torch.randn(512, 512, generator=g, device=cuda) / 23
    ref = _packed_plain(q, k, v, 4, sin=sin, cos=cos)
    got = flash_attention_packed(qkv=qkv, num_heads=4, sin=sin, cos=cos)
    torch.testing.assert_close(got.float(), ref.float(), **TOL)
    assert torch.equal(got, flash_attention_packed(qkv=qkv, num_heads=4, sin=sin, cos=cos))
    y = flash_attention_packed(qkv=qkv, num_heads=4, sin=sin, cos=cos, wo=wo)
    torch.testing.assert_close(y.float(), project_plain(ref, wo.to(torch.bfloat16)).float(),
                               **TOL)
    assert torch.equal(y, flash_attention_packed(qkv=qkv, num_heads=4, sin=sin, cos=cos,
                                                 wo=wo))
    if L == 1569:
        return
    leaf = qkv.clone().requires_grad_()
    out = flash_attention_packed(qkv=leaf, num_heads=4, sin=sin, cos=cos)
    assert torch.equal(out.detach(), got)
    do = torch.randn(B, L, 512, generator=g, device=cuda).to(torch.bfloat16)
    (dqkv,) = torch.autograd.grad(out, leaf, do)
    heads = [t.unflatten(2, (4, 128)).transpose(1, 2) for t in (q, k, v, do)]
    ref_h = ref.unflatten(2, (4, 128)).transpose(1, 2)
    want = flash_bwd_plain(*heads, ref_h, sin=sin, cos=cos)
    want = torch.cat([t.transpose(1, 2).flatten(2) for t in want], dim=-1)
    torch.testing.assert_close(dqkv.float(), want.float(), **BWD_TOL)


@pytest.mark.parametrize("proj", [False, True])
def test_text_shape(cuda, proj):
    """The text tower's shape, H 6 x 128 over [8, 512, 2304] fused qkv with a
    key mask (padded reports, one fully masked): K1 with its gradients
    (the text tower trains through K1 and K2), or K5 with Dout 768."""
    g = torch.Generator(device=cuda).manual_seed(10)
    qkv = torch.randn(8, 512, 3 * 768, generator=g, device=cuda).to(torch.bfloat16)
    q, k, v = qkv.split(768, dim=-1)
    m = torch.arange(512, device=cuda)[None, :] < torch.tensor(
        [512, 300, 77, 1, 450, 512, 200, 130], device=cuda)[:, None]
    m[3] = False
    ref = _packed_plain(q, k, v, 6, kv_mask=m)
    if proj:
        wo = torch.randn(768, 768, generator=g, device=cuda) / 28
        y = flash_attention_packed(qkv=qkv, num_heads=6, kv_mask=m, wo=wo)
        torch.testing.assert_close(
            y.float(), project_plain(ref, wo.to(torch.bfloat16)).float(), **TOL)
        assert torch.equal(y, flash_attention_packed(qkv=qkv, num_heads=6, kv_mask=m, wo=wo))
        return
    leaf = qkv.clone().requires_grad_()
    out = flash_attention_packed(qkv=leaf, num_heads=6, kv_mask=m)
    torch.testing.assert_close(out.detach().float(), ref.float(), **TOL)
    with torch.no_grad():
        assert torch.equal(flash_attention_packed(qkv=qkv, num_heads=6, kv_mask=m),
                           out.detach())
    do = torch.randn(8, 512, 768, generator=g, device=cuda).to(torch.bfloat16)
    (dqkv,) = torch.autograd.grad(out, leaf, do)
    heads = [t.unflatten(2, (6, 128)).transpose(1, 2) for t in (q, k, v, do, ref)]
    want = flash_bwd_plain(*heads, kv_mask=m)
    want = torch.cat([t.transpose(1, 2).flatten(2) for t in want], dim=-1)
    torch.testing.assert_close(dqkv.float(), want.float(), **BWD_TOL)


def test_kernels_reject_what_they_do_not_take(cuda):
    """fp16, a head dim above 512 and the fused projection past H*Dh 1024
    raise; fp32 packed operands and a Dh of 96, which raised before the
    SIMT kernels and the padding, now run a kernel (each launch counted)."""
    q = torch.zeros(1, 2, 16, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        flash_attention(q, q, q)
    q = torch.zeros(1, 16, 256, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        flash_attention_packed(q, q, q, num_heads=2)
    q = torch.zeros(1, 16, 256, device=cuda)  # fp32 packed: the SIMT kernels
    n = flash_attention_packed.launches, flash_attention_packed.proj_launches
    flash_attention_packed(q, q, q, num_heads=2)
    flash_attention_packed(q, q, q, num_heads=2, wo=torch.zeros(256, 256, device=cuda))
    assert (flash_attention_packed.launches, flash_attention_packed.proj_launches) == (
        n[0] + 1, n[1] + 1)
    q = torch.zeros(1, 16, 2048, device=cuda)
    with pytest.raises(ValueError, match="H\\*Dh <= 1024"):
        flash_attention_packed(q, q, q, num_heads=4, wo=torch.zeros(2048, 256, device=cuda))
    q = torch.zeros(1, 2, 16, 96, device=cuda, dtype=torch.bfloat16)
    n = flash_attention.launches
    assert flash_attention(q, q, q).shape == q.shape  # padded to 128
    assert flash_attention.launches == n + 1
    q = torch.zeros(1, 2, 16, 640, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="Dh up to 512"):
        flash_attention(q, q, q)


# --------------------------------------------------------------------------- #
# backward kernels (K2, K4)

BWD_TOL = dict(atol=2e-2, rtol=2e-2)


def _plain_grads(q4, k4, v4, do4, **kw):
    out = multi_head_attention(q4, k4, v4, **kw)
    return flash_bwd_plain(q4, k4, v4, do4, out, **kw)


@pytest.mark.parametrize("mode", ["rope", "mask", "causal", "plain"])
def test_backward_kernels_match_plain(cuda, mode):
    """Gradients of both entry points on [2, 199|130, 512] bf16 inputs
    against flash_bwd_plain; the outputs carry a grad_fn and agree with the
    plain forward (and bit for bit with the forward that keeps no
    statistics), the launch counters move, and a second backward agrees bit
    for bit."""
    g = torch.Generator(device=cuda).manual_seed(3)
    L = 199
    Lk = 130 if mode == "mask" else L  # Lq != Lk without RoPE
    q, k, v = (torch.randn(2, n, 512, generator=g, device=cuda).to(torch.bfloat16)
               for n in (L, Lk, Lk))
    do = torch.randn(2, L, 512, generator=g, device=cuda).to(torch.bfloat16)
    kw = {128: {}, 64: {}}
    for dh in kw:
        if mode == "rope":
            sin, cos = _rope(dh, cuda)
            kw[dh] = dict(sin=sin, cos=cos)
        elif mode == "causal":
            kw[dh] = dict(causal=True)
    if mode == "mask":
        m = torch.rand(2, Lk, generator=g, device=cuda) > 0.5
        m[1] = False  # no valid key: uniform P feeds dv, dq = dk = 0
        kw = {dh: dict(kv_mask=m) for dh in kw}

    def grads(fn, H, dh, to_heads, from_heads):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        n_f, n_b = fn.launches, fn.bwd_launches
        out = fn(*[to_heads(t) for t in leaves], **kw[dh]) if fn is flash_attention \
            else fn(*leaves, num_heads=H, **kw[dh])
        assert out.grad_fn is not None
        # this forward also wrote the row statistics: same bits as without,
        # and within the forward tolerance of the plain version
        with torch.no_grad():
            bare = fn(*[to_heads(t) for t in leaves], **kw[dh]) if fn is flash_attention \
                else fn(*leaves, num_heads=H, **kw[dh])
        assert torch.equal(out.detach(), bare)
        ref_out = multi_head_attention(*[to_heads(t) for t in (q, k, v)], **kw[dh])
        if fn is not flash_attention:
            ref_out = from_heads(ref_out)
        torch.testing.assert_close(out.detach().float(), ref_out.float(), **TOL)
        n_f += 1
        got = torch.autograd.grad(out, leaves, to_heads(do) if fn is flash_attention
                                  else do, retain_graph=True)
        again = torch.autograd.grad(out, leaves, to_heads(do) if fn is flash_attention
                                    else do)
        assert (fn.launches, fn.bwd_launches) == (n_f + 1, n_b + 2)
        for a, b in zip(got, again):
            assert torch.equal(a, b)  # no atomics: bit-equal run to run
        ref = _plain_grads(*[to_heads(t) for t in (q, k, v)], to_heads(do), **kw[dh])
        for name, a, r in zip("qkv", got, ref):
            assert torch.isfinite(a).all(), name
            torch.testing.assert_close(a.float(), from_heads(r).float(), **BWD_TOL,
                                       msg=lambda s, n=name: f"d{n} (Dh {dh}): {s}")
        return got

    def heads(H):
        return lambda t: t.unflatten(2, (H, 512 // H)).transpose(1, 2)

    def unheads(t):
        return t.transpose(1, 2).flatten(2)

    grads(flash_attention_packed, 4, 128, heads(4), unheads)
    got = grads(flash_attention, 8, 64, heads(8), unheads)
    if mode == "mask":  # the fully masked batch row: no gradient through scores
        assert float(got[0][1].abs().max()) == 0.0
        assert float(got[1][1].abs().max()) == 0.0
        assert float(got[2][1].abs().max()) > 0.0


def test_fused_qkv_backward_matches_separate(cuda):
    """The fused [B, L, 3D] gradient is dq|dk|dv of the separate call, bit
    for bit, and a strided (transposed) output gradient is taken."""
    g = torch.Generator(device=cuda).manual_seed(4)
    sin, cos = _rope(128, cuda)
    qkv = torch.randn(3, 199, 3 * 256, generator=g, device=cuda).to(torch.bfloat16)
    do = torch.randn(3, 256, 199, generator=g, device=cuda).to(torch.bfloat16)
    do = do.transpose(1, 2)  # [3, 199, 256], feature stride 199
    fused = qkv.clone().requires_grad_()
    out = flash_attention_packed(qkv=fused, num_heads=2, sin=sin, cos=cos)
    (dqkv,) = torch.autograd.grad(out, fused, do)
    parts = [t.clone().contiguous().requires_grad_() for t in qkv.split(256, dim=-1)]
    out2 = flash_attention_packed(*parts, num_heads=2, sin=sin, cos=cos)
    assert torch.equal(out, out2)
    sep = torch.autograd.grad(out2, parts, do)
    assert torch.equal(dqkv, torch.cat(sep, dim=-1))


def test_no_grad_writes_no_statistics_and_matches(cuda):
    """The serving path: without a gradient the output is the same bits and
    no graph is kept."""
    g = torch.Generator(device=cuda).manual_seed(5)
    qkv = torch.randn(2, 150, 3 * 256, generator=g, device=cuda).to(torch.bfloat16)
    with torch.inference_mode():
        a = flash_attention_packed(qkv=qkv, num_heads=2)
    b = flash_attention_packed(qkv=qkv.clone().requires_grad_(), num_heads=2)
    assert a.grad_fn is None and b.grad_fn is not None
    assert torch.equal(a, b.detach())


def test_backward_rejects_fp32_on_the_card(cuda):
    """The packed entry with a gradient: fp16 raises; fp32, which raised
    before the SIMT kernels took it, now runs the fp32 forward and backward
    kernels (one launch each, counted) and gives the plain gradients."""
    q = torch.zeros(1, 16, 256, device=cuda, dtype=torch.float16, requires_grad=True)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        flash_attention_packed(q, q, q, num_heads=2)
    g = torch.Generator(device=cuda).manual_seed(3)
    q = torch.randn(1, 16, 256, generator=g, device=cuda, requires_grad=True)
    n = flash_attention_packed.launches, flash_attention_packed.bwd_launches
    (dq,) = torch.autograd.grad(flash_attention_packed(q, q, q, num_heads=2).sum(), [q])
    assert (flash_attention_packed.launches, flash_attention_packed.bwd_launches) == (
        n[0] + 1, n[1] + 1)
    qp = q.detach().clone().requires_grad_()
    heads = qp.unflatten(2, (2, 128)).transpose(1, 2)
    (want,) = torch.autograd.grad(multi_head_attention(heads, heads, heads).sum(), [qp])
    torch.testing.assert_close(dq, want, atol=1e-4, rtol=1e-4)


def _kernels_run(fn):
    """Names of the kernels the card ran during ``fn()``, one a launch (a
    profiler trace)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    for _ in range(3):  # the profiler now and then traces no device event: again
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            return names
    return names


def _ran(names, kernel):
    return any(kernel in n for n in names)


@pytest.mark.parametrize("L", [1569, 393, 130, 10])
def test_packed_backward_at_ragged_lengths(cuda, L):
    """K2's Hopper kernels on fused qkv with RoPE at the tower's lengths and
    two short ones (ragged against the 128-key, 64-row and 128-row tiles):
    dq, dk, dv against flash_bwd_plain, two launches bit-equal, and one
    clip's gradients the same bits alone (B = 1) as in a batch of 4."""
    g = torch.Generator(device=cuda).manual_seed(12)
    sin, cos = _ragged_rope(L, cuda)
    qkv = torch.randn(4, L, 3 * 512, generator=g, device=cuda).to(torch.bfloat16)
    do = torch.randn(4, L, 512, generator=g, device=cuda).to(torch.bfloat16)

    def grads(x, d):
        leaf = x.clone().requires_grad_()
        out = flash_attention_packed(qkv=leaf, num_heads=4, sin=sin, cos=cos)
        a = torch.autograd.grad(out, leaf, d, retain_graph=True)[0]
        b = torch.autograd.grad(out, leaf, d)[0]
        assert torch.equal(a, b)  # no atomics: bit-equal run to run
        return a, out.detach()

    dqkv, out = grads(qkv, do)
    one, _ = grads(qkv[2:3], do[2:3])
    assert torch.equal(dqkv[2:3], one)  # fixed tiles: batch-size invariant
    heads = [t.unflatten(2, (4, 128)).transpose(1, 2)
             for t in (*qkv.split(512, dim=-1), do, out)]
    want = flash_bwd_plain(*heads, sin=sin, cos=cos)
    want = torch.cat([t.transpose(1, 2).flatten(2) for t in want], dim=-1)
    torch.testing.assert_close(dqkv.float(), want.float(), **BWD_TOL)


@pytest.mark.parametrize("mode", ["cross_mask", "causal", "causal_mask"])
def test_packed_backward_modes(cuda, mode):
    """K2's Hopper kernels on separate q/k/v: Lq != Lk with a key mask and a
    fully masked batch row; causal at a length of several tiles (the tiles
    the causal mask removes are skipped); causal with a key mask and a fully
    masked row (nothing skipped: that row's uniform P reaches every key)."""
    g = torch.Generator(device=cuda).manual_seed(13)
    Lq, Lk = (200, 333) if mode == "cross_mask" else (393, 393)
    q = torch.randn(3, Lq, 512, generator=g, device=cuda).to(torch.bfloat16)
    k, v = (torch.randn(3, Lk, 512, generator=g, device=cuda).to(torch.bfloat16)
            for _ in range(2))
    do = torch.randn(3, Lq, 512, generator=g, device=cuda).to(torch.bfloat16)
    kw = {}
    if mode != "causal":
        m = torch.rand(3, Lk, generator=g, device=cuda) > 0.3
        m[1] = False
        kw["kv_mask"] = m
    if mode != "cross_mask":
        kw["causal"] = True
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = flash_attention_packed(*leaves, num_heads=4, **kw)
    got = torch.autograd.grad(out, leaves, do, retain_graph=True)
    again = torch.autograd.grad(out, leaves, do)
    heads = [t.unflatten(2, (4, 128)).transpose(1, 2) for t in (q, k, v, do)]
    want = _plain_grads(*heads, **kw)
    for name, a, b, r in zip("qkv", got, again, want):
        assert torch.equal(a, b), name
        torch.testing.assert_close(a.float(), r.transpose(1, 2).flatten(2).float(),
                                   **BWD_TOL, msg=lambda s, n=name: f"d{n}: {s}")
    if "mask" in mode:  # the fully masked batch row: no gradient through scores
        assert float(got[0][1].abs().max()) == 0.0 and float(got[1][1].abs().max()) == 0.0
        assert float(got[2][1].abs().max()) > 0.0


def test_backward_kernels_by_layout(cuda):
    """The packed entry's backward (K2) runs its Hopper kernels, the
    [B, H, L, Dh] entry's (K4) above 64 tokens the long Hopper ones, at both
    of its head dims."""
    g = torch.Generator(device=cuda).manual_seed(14)
    x = torch.randn(2, 150, 3 * 256, generator=g, device=cuda).to(torch.bfloat16)
    leaf = x.clone().requires_grad_()
    out = flash_attention_packed(qkv=leaf, num_heads=2)
    names = _kernels_run(lambda: torch.autograd.grad(out, leaf, torch.ones_like(out)))
    assert _ran(names, "flash_bwd_dkv_sm90_kernel") and _ran(names, "flash_bwd_dq_sm90_kernel")
    assert not _ran(names, "flash_long_bwd")
    for dh in (64, 128):
        leaves = [t.clone().requires_grad_() for t in x.split(256, dim=-1)]
        out = flash_attention(*[t.unflatten(2, (256 // dh, dh)).transpose(1, 2)
                                for t in leaves])
        names = _kernels_run(lambda: torch.autograd.grad(out, leaves, torch.ones_like(out)))
        assert _ran(names, f"flash_long_bwd_dkv_kernel<{dh}>")
        assert _ran(names, f"flash_long_bwd_dq_kernel<{dh}>")
        assert not _ran(names, "sm90")


# --------------------------------------------------------------------------- #
# fp32 operands on the [B, H, L, Dh] entry (K3, K4)

# kernel vs plain, both fp32: the kernel folds log2(e) into the scale and
# takes exp2, sums in another order and contracts a*b+c into FMAs
F32_TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("mode", ["rope", "mask", "causal", "cross"])
@pytest.mark.parametrize("dh", [64, 128])
def test_fp32_kernels_match_plain(cuda, mode, dh):
    """Forward and gradients of flash_attention on fp32 operands (strided
    views of a packed [B, L, H*Dh] tensor, as the layers hand them over)
    against the plain versions in fp32, with nothing cast to bf16."""
    g = torch.Generator(device=cuda).manual_seed(6)
    H, L = 512 // dh, 199
    Lk = 77 if mode in ("mask", "cross") else L
    q, k, v = (torch.randn(2, n, 512, generator=g, device=cuda) for n in (L, Lk, Lk))
    do = torch.randn(2, L, 512, generator=g, device=cuda)
    kw = {}
    if mode == "rope":
        sin, cos = _rope(dh, cuda)
        kw = dict(sin=sin, cos=cos)
    elif mode == "causal":
        kw = dict(causal=True)
    elif mode == "mask":
        m = torch.rand(2, Lk, generator=g, device=cuda) > 0.5
        m[1] = False
        kw = dict(kv_mask=m)

    def heads(t):
        return t.unflatten(2, (H, dh)).transpose(1, 2)

    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    n_f, n_b = flash_attention.launches, flash_attention.bwd_launches
    out = flash_attention(*[heads(t) for t in leaves], **kw)
    assert out.dtype == torch.float32 and out.grad_fn is not None
    ref = multi_head_attention(*[heads(t) for t in (q, k, v)], **kw)
    torch.testing.assert_close(out.detach(), ref, **F32_TOL)
    with torch.no_grad():
        assert torch.equal(flash_attention(*[heads(t) for t in leaves], **kw), out.detach())
    got = torch.autograd.grad(out, leaves, heads(do), retain_graph=True)
    again = torch.autograd.grad(out, leaves, heads(do))
    assert (flash_attention.launches, flash_attention.bwd_launches) == (n_f + 2, n_b + 2)
    want = flash_bwd_plain(*[heads(t) for t in (q, k, v)], heads(do), ref, **kw)
    for name, a, b, r in zip("qkv", got, again, want):
        assert torch.equal(a, b)
        # gradients are sums of up to 199 products of O(1) values
        torch.testing.assert_close(a, r.transpose(1, 2).flatten(2), atol=5e-5, rtol=1e-5,
                                   msg=lambda s, n=name: f"d{n}: {s}")
    if mode == "mask":
        assert float(got[0][1].abs().max()) == 0.0 and float(got[2][1].abs().max()) > 0.0


# --------------------------------------------------------------------------- #
# the forward with the output projection fused in (K5)


def _proj_plain(q, k, v, wo, H, **kw):
    """The plain version, and the attention output it projects."""
    heads = [t.unflatten(2, (H, t.shape[2] // H)).transpose(1, 2) for t in (q, k, v)]
    out = multi_head_attention(*heads, **kw).transpose(1, 2).flatten(2)
    return project_plain(out, wo), out


@pytest.mark.parametrize("mode", ["rope", "mask", "causal", "plain"])
def test_fused_projection_matches_plain(cuda, mode):
    """K5 on [2, 199|130, 512] bf16 with a [512, 384] projection: y against
    the plain version (forward tolerance of K1), dqkv/dwo against the plain
    backward, K1 never launched, K2 launched by the backward, bit-equal run
    to run, and the same bits with and without a gradient wanted."""
    g = torch.Generator(device=cuda).manual_seed(7)
    L = 199
    Lk = 130 if mode == "mask" else L
    q, k, v = (torch.randn(2, n, 512, generator=g, device=cuda).to(torch.bfloat16)
               for n in (L, Lk, Lk))
    wo = (torch.randn(512, 384, generator=g, device=cuda) * 512 ** -0.5)
    gy = torch.randn(2, L, 384, generator=g, device=cuda).to(torch.bfloat16)
    kw = {}
    if mode == "rope":
        sin, cos = _rope(128, cuda)
        kw = dict(sin=sin, cos=cos)
    elif mode == "causal":
        kw = dict(causal=True)
    elif mode == "mask":
        m = torch.rand(2, Lk, generator=g, device=cuda) > 0.5
        m[1] = False
        kw = dict(kv_mask=m)
    fn = flash_attention_packed
    before = (fn.launches, fn.proj_launches, fn.bwd_launches)
    leaves = [t.clone().requires_grad_() for t in (q, k, v, wo)]
    y = fn(*leaves[:3], num_heads=4, wo=leaves[3], **kw)
    assert y.shape == (2, L, 384) and y.dtype == torch.bfloat16 and y.grad_fn is not None
    wo16 = wo.to(torch.bfloat16)
    ref, ref_out = _proj_plain(q, k, v, wo16, 4, **kw)
    torch.testing.assert_close(y.detach().float(), ref.float(), **TOL)
    with torch.no_grad():
        assert torch.equal(fn(q, k, v, num_heads=4, wo=wo, **kw), y.detach())
    got = torch.autograd.grad(y, leaves, gy, retain_graph=True)
    again = torch.autograd.grad(y, leaves, gy)
    assert (fn.launches, fn.proj_launches, fn.bwd_launches) == (
        before[0], before[1] + 2, before[2] + 2)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    assert got[3].dtype == torch.float32 and got[3].shape == wo.shape
    do = torch.matmul(gy, wo16.t())
    heads = [t.unflatten(2, (4, 128)).transpose(1, 2) for t in (q, k, v, do, ref_out)]
    want = [t.transpose(1, 2).flatten(2) for t in flash_bwd_plain(*heads, **kw)]
    want.append(torch.matmul(ref_out.flatten(0, 1).t().float(), gy.flatten(0, 1).float()))
    for name, a, r in zip(("q", "k", "v", "wo"), got, want):
        # dwo sums 398 rows: its bf16 rounding (2^-9 relative) is of |dwo| ~ 10
        tol = dict(atol=1e-1, rtol=2e-2) if name == "wo" else BWD_TOL
        torch.testing.assert_close(a.float(), r.float(), **tol,
                                   msg=lambda s, n=name: f"d{n}: {s}")


def test_fused_projection_on_fused_qkv(cuda):
    """The layer's call: one fused [B, L, 3D] operand with RoPE; same bits
    as the separate-operand call, and one [B, L, 3D] gradient."""
    g = torch.Generator(device=cuda).manual_seed(8)
    sin, cos = _rope(128, cuda)
    qkv = torch.randn(3, 199, 3 * 256, generator=g, device=cuda).to(torch.bfloat16)
    wo = torch.randn(256, 256, generator=g, device=cuda) / 16
    leaf = qkv.clone().requires_grad_()
    y = flash_attention_packed(qkv=leaf, num_heads=2, sin=sin, cos=cos, wo=wo)
    parts = [t.contiguous() for t in qkv.split(256, dim=-1)]
    y2 = flash_attention_packed(*parts, num_heads=2, sin=sin, cos=cos, wo=wo)
    assert torch.equal(y.detach(), y2)
    ref, _ = _proj_plain(*parts, wo.to(torch.bfloat16), 2, sin=sin, cos=cos)
    torch.testing.assert_close(y.detach().float(), ref.float(), **TOL)
    (dqkv,) = torch.autograd.grad(y, leaf, torch.ones_like(y))
    assert dqkv.shape == qkv.shape and torch.isfinite(dqkv).all()


# --------------------------------------------------------------------------- #
# the short kernels of K3 and K4 (csrc/flash_short.cu, Lq and Lk <= 64)


def _short_inputs(device, B, Lq, Lk, dh, dtype, seed):
    """q, k, v as the layers hand them over (strided views of a packed
    tensor), the output gradient through a transpose, and a bool key mask
    with a fully masked batch row."""
    g = torch.Generator(device=device).manual_seed(seed)
    H = 4
    q = torch.randn(B, Lq, H, dh, generator=g, device=device).to(dtype).transpose(1, 2)
    kv = torch.randn(B, Lk, 2, H, dh, generator=g, device=device).to(dtype)
    k, v = kv[:, :, 0].transpose(1, 2), kv[:, :, 1].transpose(1, 2)
    do = torch.randn(B, Lq, H, dh, generator=g, device=device).to(dtype).transpose(1, 2)
    m = torch.rand(B, Lk, generator=g, device=device) > 0.3
    m[:, 0] = True
    m[min(1, B - 1)] = False
    return q, k, v, do, m


def _short_grads(q, k, v, do, **kw):
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = flash_attention(*leaves, **kw)
    return out.detach(), torch.autograd.grad(out, leaves, do)


@pytest.mark.parametrize("L,short", [(64, True), (65, False)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_short_routing_boundary(cuda, L, short, dtype):
    """At L = 64 a forward and a backward are one short kernel each; at
    L = 65 the tile kernels run and no short kernel."""
    q, k, v, do, m = _short_inputs(cuda, 2, L, L, 64, dtype, 30)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = flash_attention(*leaves, kv_mask=m)
    fwd = _kernels_run(lambda: [flash_attention(q, k, v, kv_mask=m) for _ in range(4)])
    bwd = _kernels_run(lambda: [torch.autograd.grad(out, leaves, do, retain_graph=True)
                                for _ in range(4)])  # 4 calls a trace
    sfx = "bf16" if dtype == torch.bfloat16 else "f32"
    if short:
        assert len(fwd) == 4 and _ran(fwd, f"flash_short_fwd_{sfx}_kernel")
        assert len(bwd) == 4 and _ran(bwd, f"flash_short_bwd_{sfx}_kernel")
    else:
        assert not _ran(fwd + bwd, "flash_short")
        if dtype == torch.bfloat16:
            assert _ran(fwd, "flash_long_fwd_kernel<64>")
            assert _ran(bwd, "flash_long_bwd_dkv") and _ran(bwd, "flash_long_bwd_dq")
        else:  # the fp32 forward at Dh 64 on the register-tiled kernel
            assert _ran(fwd, "flash_fwd_f32_regtile_kernel<64>")
            assert _ran(bwd, "flash_bwd_dkv_f32_regtile_kernel<64>")
            assert _ran(bwd, "flash_bwd_dq_f32_regtile_kernel<64>")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dh", [64, 128])
def test_short_kernels_batch_invariant_and_reproducible(cuda, dtype, dh):
    """One batch row alone (B = 1) gives the same bits as in a batch of 4,
    forward and gradients, and two launches on the same inputs agree bit
    for bit."""
    q, k, v, do, m = _short_inputs(cuda, 4, 10, 10, dh, dtype, 31)
    out, got = _short_grads(q, k, v, do, kv_mask=m)
    out2, got2 = _short_grads(q, k, v, do, kv_mask=m)
    one, got1 = _short_grads(q[2:3], k[2:3], v[2:3], do[2:3], kv_mask=m[2:3])
    assert torch.equal(out, out2) and all(torch.equal(a, b) for a, b in zip(got, got2))
    assert torch.equal(out[2:3], one)
    assert all(torch.equal(a[2:3], b) for a, b in zip(got, got1))


@pytest.mark.parametrize("mode", ["mask", "causal", "cross", "rope"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_short_forward_matches_the_tile_kernel(cuda, mode, dtype):
    """The short forward against the tile kernel (called directly: bf16
    flash_long_fwd_kernel, fp32 flash_fwd_f32_regtile_kernel) on the same
    inputs, Lk <= 64. In bf16 by TOL: the Hopper tile kernel sums Q K^T and
    P V in wgmma's order, not the short kernel's mma.sync order, so the two
    agree to bf16 rounding, not bit for bit; in fp32 the tile kernel's
    online softmax sums in another order, so F32_TOL."""
    from deepcoro_clip_tpu_torch.ops._flash_cuda import flash_fwd

    Lq, Lk = (37, 50) if mode == "cross" else (10, 10) if mode == "rope" else (17, 17)
    q, k, v, _, m = _short_inputs(cuda, 3, Lq, Lk, 64, dtype, 32)
    kw = {}
    if mode == "mask" or mode == "cross":
        kw["kv_mask"] = m
    if mode == "causal":
        kw["causal"] = True
    if mode == "rope":
        t = build_rope3d_tables(64, 1, 3, 3, n_special=1)
        kw.update(sin=torch.from_numpy(t.sin).to(cuda), cos=torch.from_numpy(t.cos).to(cuda))
    out = flash_attention(q, k, v, **kw)
    tile = torch.empty_like(out)
    flash_fwd(q, k, v, tile, sin=kw.get("sin"), cos=kw.get("cos"), kv_mask=kw.get("kv_mask"),
              causal=bool(kw.get("causal")), scale=64 ** -0.5)
    torch.testing.assert_close(out.float(), tile.float(),
                               **(TOL if dtype == torch.bfloat16 else F32_TOL))


@pytest.mark.parametrize("mode", ["mask", "causal", "cross", "rope", "one_key"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dh", [64, 128])
def test_short_gradients_match_plain(cuda, mode, dtype, dh):
    """Forward and gradients through FlashAttention against
    multi_head_attention and flash_bwd_plain: bf16 at TOL and BWD_TOL,
    fp32 at F32_TOL and the fp32 gradients' 5e-5; the fully masked batch
    row passes no gradient through its scores. At one key (Lk = 1) the exact
    dq and dk are 0 and both sides' are rounding noise: held to the atol."""
    Lq, Lk = {"cross": (1, 64), "one_key": (1, 1), "rope": (10, 10)}.get(mode, (11, 11))
    q, k, v, do, m = _short_inputs(cuda, 3, Lq, Lk, dh, dtype, 33)
    kw = {}
    if mode in ("mask", "cross", "one_key"):
        kw["kv_mask"] = m
    if mode == "causal":
        kw["causal"] = True
    if mode == "rope":
        t = build_rope3d_tables(dh, 1, 3, 3, n_special=1)
        kw.update(sin=torch.from_numpy(t.sin).to(cuda), cos=torch.from_numpy(t.cos).to(cuda))
    n_f, n_b = flash_attention.launches, flash_attention.bwd_launches
    out, got = _short_grads(q, k, v, do, **kw)
    assert (flash_attention.launches, flash_attention.bwd_launches) == (n_f + 1, n_b + 1)
    ref_out = multi_head_attention(q, k, v, **kw)
    ref = flash_bwd_plain(q, k, v, do, ref_out, **kw)
    fp32 = dtype == torch.float32
    torch.testing.assert_close(out, ref_out, **(F32_TOL if fp32 else TOL))
    for name, a, r in zip("qkv", got, ref):
        tol = dict(atol=5e-5, rtol=1e-5) if fp32 else BWD_TOL
        torch.testing.assert_close(a, r, **tol, msg=lambda s, n=name: f"d{n}: {s}")
    if "kv_mask" in kw:
        assert float(got[0][1].abs().max()) == 0.0 and float(got[1][1].abs().max()) == 0.0


def test_short_fp32_takes_unaligned_operands(cuda):
    """An fp32 operand the 16-byte copies cannot read (a base one element
    off) is copied once, forward and backward, as the tile kernels took any
    strides; bf16 ones must allow the copies, as before."""
    g = torch.Generator(device=cuda).manual_seed(35)
    base = torch.randn(2, 4, 11, 65, generator=g, device=cuda)
    q = base[..., 1:]  # [2, 4, 11, 64], base 4 bytes past a 16-byte boundary
    k, v, do = (torch.randn(2, 4, 11, 64, generator=g, device=cuda) for _ in range(3))
    out, got = _short_grads(q, k, v, do)
    ref_out = multi_head_attention(q, k, v)
    torch.testing.assert_close(out, ref_out, **F32_TOL)
    for a, r in zip(got, flash_bwd_plain(q, k, v, do, ref_out)):
        torch.testing.assert_close(a, r, atol=5e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention(base.to(torch.bfloat16)[..., 1:], k.to(torch.bfloat16),
                        v.to(torch.bfloat16))


def test_short_calls_run_one_kernel_with_a_bool_mask(cuda):
    """At the aggregator's training shape a forward and a backward with the
    bool key mask are one kernel each: no mask conversion, no pre-pass."""
    q, k, v, do, m = _short_inputs(cuda, 8, 4, 4, 64, torch.bfloat16, 34)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = flash_attention(*leaves, kv_mask=m)
    for fn in (lambda: flash_attention(q, k, v, kv_mask=m),
               lambda: torch.autograd.grad(out, leaves, do, retain_graph=True)):
        names = _kernels_run(lambda: [fn() for _ in range(10)])  # 10 calls a trace
        assert len(names) == 10 and all("flash_short" in n for n in names), names


# --------------------------------------------------------------------------- #
# ring attention (K6)


def _ring_mesh(n, devices):
    from deepcoro_clip_tpu_torch.parallel import MeshSpec, make_mesh

    return make_mesh(MeshSpec(data=1, model=n), devices=devices)


@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_ring_kernel_matches_plain(cuda, n, dh):
    """K6 over n shards on the card against its plain version and the
    ``"xla"`` ring; chunks of 199 rows are ragged against the 64-row tiles.
    n x n launches a call; two calls agree bit for bit."""
    from deepcoro_clip_tpu_torch.parallel import ring_attention

    g = torch.Generator(device=cuda).manual_seed(20 + n)
    q, k, v = (torch.randn(2, 3, 199 * n, dh, generator=g, device=cuda).to(torch.bfloat16)
               for _ in range(3))
    mesh = _ring_mesh(n, [cuda] * n)
    before = ring_attention.launches
    got = ring_attention(q, k, v, mesh, backend="rdma")
    assert ring_attention.launches == before + n * n
    again = ring_attention(q, k, v, mesh, backend="rdma")
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    for backend in ("rdma_interpret", "xla"):
        ref = ring_attention(q, k, v, mesh, backend=backend)
        torch.testing.assert_close(got.float(), ref.float(), **TOL)
    assert ring_attention.launches == before + 2 * n * n  # the plain ones launch nothing


@pytest.mark.parametrize("dh,kernel", [(128, "ring_step_sm90_kernel"),
                                       (64, "ring_step_kernel")])
def test_ring_step_kernel_by_head_dim(cuda, dh, kernel):
    """Dh 128 runs the Hopper step kernel, Dh 64 the mma.sync one."""
    from deepcoro_clip_tpu_torch.parallel import ring_attention

    q = torch.zeros(1, 2, 2 * 150, dh, device=cuda, dtype=torch.bfloat16)
    mesh = _ring_mesh(2, [cuda] * 2)
    names = _kernels_run(lambda: ring_attention(q, q, q, mesh, backend="rdma"))
    assert _ran(names, kernel)
    assert dh == 128 or not _ran(names, "ring_step_sm90_kernel")


def test_ring_kernel_gradients_are_the_plain_rings(cuda):
    """``backend="rdma"`` differentiates through the ``"xla"`` ring (the JAX
    custom_vjp): the same gradients as the ``"xla"`` ring's own."""
    from deepcoro_clip_tpu_torch.parallel import ring_attention

    g = torch.Generator(device=cuda).manual_seed(30)
    q, k, v = (torch.randn(1, 2, 4 * 150, 128, generator=g, device=cuda).to(torch.bfloat16)
               for _ in range(3))
    mesh = _ring_mesh(4, [cuda] * 4)
    grads = {}
    for backend in ("rdma", "xla"):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = ring_attention(*leaves, mesh, backend=backend)
        grads[backend] = torch.autograd.grad(out.float().square().sum(), leaves)
    for a, b in zip(grads["rdma"], grads["xla"]):
        torch.testing.assert_close(a.float(), b.float(), **BWD_TOL)


def test_ring_kernel_rejects_what_it_does_not_take(cuda):
    from deepcoro_clip_tpu_torch.parallel import ring_attention

    mesh = _ring_mesh(2, [cuda] * 2)
    q = torch.zeros(1, 2, 64, 128, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        ring_attention(q, q, q, mesh, backend="rdma")
    q = torch.zeros(1, 2, 64, 640, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="Dh up to 512"):
        ring_attention(q, q, q, mesh, backend="rdma")
    # fp32, and a Dh of 96 (padded to 128), which raised before, run K6
    for dtype, dh in ((torch.float32, 128), (torch.bfloat16, 96)):
        q = torch.zeros(1, 2, 64, dh, device=cuda, dtype=dtype)
        assert ring_attention(q, q, q, mesh, backend="rdma").shape == q.shape


def test_ring_kernel_across_cards_equals_one_card(cuda):
    """Where the machine has several cards: the ring over them (peer copies)
    gives the bits of the same number of shards on one card."""
    from deepcoro_clip_tpu_torch.parallel import ring_attention

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more cards")
    g = torch.Generator(device=cuda).manual_seed(40)
    q, k, v = (torch.randn(2, 2, 130 * n, 128, generator=g, device=cuda).to(torch.bfloat16)
               for _ in range(3))
    cards = [torch.device("cuda", i) for i in range(n)]
    one = ring_attention(q, k, v, _ring_mesh(n, [cuda] * n), backend="rdma")
    many = ring_attention(q, k, v, _ring_mesh(n, cards), backend="rdma")
    assert torch.equal(one, many)


# --------------------------------------------------------------------------- #
# the multitask decoder's calls (K3/K4 on the tile kernels)


@pytest.mark.parametrize("mode", ["causal_mask", "cross", "text_mask", "locca_causal_mask",
                                  "locca_cross"])
def test_decoder_attention_shapes(cuda, mode):
    """K3/K4 as the multitask path calls them on the tile kernels, strided
    views of [B, L, H * 64] projections: the captioning decoder's causal
    self-attention at L 128 under a caption padding mask and its
    cross-attention of 128 queries over 1572 keys (4 clips x 393 tokens:
    the last key tile partial), 8 heads; the text tower at L 512, 12 heads,
    under a report padding mask; the contrastive path's LocCa decoder at L
    256, causal under the caption mask, and across 256 queries over one
    clip's 393 tokens. Forward against multi_head_attention, gradients
    against flash_bwd_plain, one launch each way, two backward launches
    bit-equal."""
    g = torch.Generator(device=cuda).manual_seed(21)
    B, H = 2, (12 if mode == "text_mask" else 8)
    L = {"text_mask": 512, "locca_causal_mask": 256, "locca_cross": 256}.get(mode, 128)
    Lk = {"cross": 1572, "locca_cross": 393}.get(mode, L)

    def heads(n):
        t = torch.randn(B, n, H * 64, generator=g, device=cuda).to(torch.bfloat16)
        return t.unflatten(2, (H, 64)).transpose(1, 2)

    q, k, v, do = heads(L), heads(Lk), heads(Lk), heads(L)
    kw = {}
    if not mode.endswith("cross"):
        m = torch.ones(B, L, dtype=torch.int32, device=cuda)
        m[0, 40:] = 0
        m[1, 97:] = 0
        kw = dict(kv_mask=m, causal=mode.endswith("causal_mask"))
    pkw = dict(kw, kv_mask=kw["kv_mask"] != 0) if kw else {}
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    n_f, n_b = flash_attention.launches, flash_attention.bwd_launches
    out = flash_attention(*leaves, **kw)
    got = torch.autograd.grad(out, leaves, do, retain_graph=True)
    again = torch.autograd.grad(out, leaves, do)
    assert flash_attention.launches == n_f + 1 and flash_attention.bwd_launches == n_b + 2
    torch.testing.assert_close(out.float(), multi_head_attention(q, k, v, **pkw).float(),
                               **TOL)
    want = _plain_grads(q, k, v, do, **pkw)
    for name, a, b, r in zip("qkv", got, again, want):
        assert torch.equal(a, b), name
        torch.testing.assert_close(a.float(), r.float(), **BWD_TOL,
                                   msg=lambda s, n=name: f"d{n}: {s}")
    names = _kernels_run(lambda: flash_attention(q, k, v, **kw))
    assert _ran(names, "flash_long_fwd_kernel<64>") and not _ran(names, "flash_short")


def test_captioning_decoder_on_the_card(cuda):
    """A decoder layer at the multitask widths (512 / 8 heads, L 128, 1572
    video tokens), bf16: logits through the kernels against the same
    weights through the plain attention (within 2% of the largest logit),
    two K3 launches a layer forward and two K4 backward, and the gradients
    of both paths at cosine >= 0.999."""
    from deepcoro_clip_tpu_torch.models.captioning_decoder import CaptioningDecoder
    from deepcoro_clip_tpu_torch.models.video_encoder import init_params

    g = torch.Generator(device=cuda).manual_seed(22)
    kw = dict(vocab_size=1000, dim=512, depth=1, num_heads=8, max_length=128,
              memory_dim=512, dropout=0.0)
    flash = init_params(CaptioningDecoder(**kw, use_flash=True), 3).to(cuda)
    plain = CaptioningDecoder(**kw, use_flash=False).to(cuda)
    plain.load_state_dict(flash.state_dict())
    ids = torch.randint(0, 1000, (2, 128), generator=g, device=cuda)
    mask = torch.ones(2, 128, dtype=torch.int32, device=cuda)
    mask[1, 70:] = 0
    mem = torch.randn(2, 1572, 512, generator=g, device=cuda)
    n_f, n_b = flash_attention.launches, flash_attention.bwd_launches
    a = flash(ids, mem, attention_mask=mask)
    b = plain(ids, mem, attention_mask=mask)
    assert flash_attention.launches == n_f + 2
    assert float((a - b).detach().abs().max()) <= 0.02 * float(b.detach().abs().max())
    ga = torch.autograd.grad(a.square().mean(), list(flash.parameters()))
    assert flash_attention.bwd_launches == n_b + 2
    gb = torch.autograd.grad(b.square().mean(), list(plain.parameters()))
    fa = torch.cat([t.flatten() for t in ga])
    fb = torch.cat([t.flatten() for t in gb])
    assert float(torch.nn.functional.cosine_similarity(fa, fb, dim=0)) >= 0.999


def _bank_mask(n_texts, L, device, seed=0):
    """A SigLIP text bank's key mask: the first third real prompts of 6 to
    20 tokens, the rest "" fillers of 2 ([CLS] [SEP]), as
    collate_multi_positive pads a bank to batch_size x 40 texts."""
    g = torch.Generator().manual_seed(seed)
    lengths = torch.full((n_texts,), 2)
    real = max(1, n_texts // 3)
    lengths[:real] = torch.randint(6, 21, (real,), generator=g)
    return (torch.arange(L)[None, :] < lengths[:, None]).to(torch.int32).to(device)


def test_bank_attention_shapes(cuda):
    """K3/K4 on the tile kernels at the text tower's call on a SigLIP bank,
    scaled down from [B x 40, 12, 512, 64] to 40 texts: strided views of
    [40, 512, 768] projections, the bank's per-row mask (2 to 20 real keys
    of 512, every later key masked). Forward against multi_head_attention;
    gradients against flash_bwd_plain by the bars of chip_smoke.py's phase
    7, relative to the call's largest gradient (max |d| <= 2e-2 of it,
    relative L2 <= 1e-2: the queries of a filler attend to 2 keys, so dv
    and dq run to tens, where bf16 rounds by ~0.1); one launch each way, two
    backward launches bit-equal, the masked keys' gradients zero, and each
    row of the batch bit-equal to that row alone (the tiles do not depend
    on the batch)."""
    g = torch.Generator(device=cuda).manual_seed(24)
    B, H, L = 40, 12, 512

    def heads(n):
        t = torch.randn(n, L, H * 64, generator=g, device=cuda).to(torch.bfloat16)
        return t.unflatten(2, (H, 64)).transpose(1, 2)

    q, k, v, do = heads(B), heads(B), heads(B), heads(B)
    m = _bank_mask(B, L, cuda)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    n_f, n_b = flash_attention.launches, flash_attention.bwd_launches
    out = flash_attention(*leaves, kv_mask=m)
    got = torch.autograd.grad(out, leaves, do, retain_graph=True)
    again = torch.autograd.grad(out, leaves, do)
    assert flash_attention.launches == n_f + 1 and flash_attention.bwd_launches == n_b + 2
    pm = m != 0
    torch.testing.assert_close(out.float(), multi_head_attention(q, k, v, kv_mask=pm).float(),
                               **TOL)
    want = _plain_grads(q, k, v, do, kv_mask=pm)
    for name, a, b, r in zip("qkv", got, again, want):
        assert torch.equal(a, b), name
        d, r = (a.float() - r.float()), r.float()
        assert float(d.abs().max()) <= 2e-2 * float(r.abs().max()), name
        assert float(d.norm()) <= 1e-2 * float(r.norm()), name
    # the masked keys get no gradient
    assert not got[1].transpose(1, 2)[~pm].any() and not got[2].transpose(1, 2)[~pm].any()
    for i in (0, B // 2, B - 1):
        alone = flash_attention(q[i:i + 1], k[i:i + 1], v[i:i + 1], kv_mask=m[i:i + 1])
        assert torch.equal(alone[0], out[i].detach()), i
    names = _kernels_run(lambda: flash_attention(q, k, v, kv_mask=m))
    assert _ran(names, "flash_long_fwd_kernel<64>") and not _ran(names, "flash_short")


@pytest.mark.parametrize("n", [1, 5])
def test_padded_head_dim_on_the_card(cuda, n):
    """Dh 32 (the single-video aggregator of siglip_multi_positive_config.yaml:
    512 wide, 16 heads, N = 1; and N = 5 with a video mask) runs the short
    kernel at Dh 64 on zero-padded operands: output and gradients at Dh 32
    against the plain version at Dh 32, one launch each way."""
    g = torch.Generator(device=cuda).manual_seed(25)
    B, H = 4, 16
    qkv = torch.randn(B, n, 3 * H * 32, generator=g, device=cuda).to(torch.bfloat16)
    q, k, v = (t.unflatten(2, (H, 32)).transpose(1, 2) for t in qkv.split(H * 32, -1))
    do = torch.randn(B, H, n, 32, generator=g, device=cuda).to(torch.bfloat16)
    m = torch.ones(B, n, dtype=torch.bool, device=cuda)
    m[1, n // 2 + 1:] = False
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    n_f, n_b = flash_attention.launches, flash_attention.bwd_launches
    out = flash_attention(*leaves, kv_mask=m)
    got = torch.autograd.grad(out, leaves, do)
    assert flash_attention.launches == n_f + 1 and flash_attention.bwd_launches == n_b + 1
    assert out.shape == (B, H, n, 32) and all(t.shape == q.shape for t in got)
    torch.testing.assert_close(out.float(), multi_head_attention(q, k, v, kv_mask=m).float(),
                               **TOL)
    for name, a, r in zip("qkv", got, _plain_grads(q, k, v, do, kv_mask=m)):
        torch.testing.assert_close(a.float(), r.float(), **BWD_TOL,
                                   msg=lambda s, nm=name: f"d{nm}: {s}")
    names = _kernels_run(lambda: flash_attention(q, k, v, kv_mask=m))
    assert _ran(names, "flash_short_fwd_bf16_kernel")


# --------------------------------------------------------------------------- #
# the long K3/K4 calls (Lq or Lk above 64) on the Hopper kernels, which skip
# the key tiles past each q tile's key extent


def _long_inputs(device, B, H, Lq, Lk, dh, seed, mask=None):
    """q, k, v and the output gradient as strided views of [B, L, H * dh]
    projections, as the layers hand them over."""
    g = torch.Generator(device=device).manual_seed(seed)

    def heads(n):
        t = torch.randn(B, n, H * dh, generator=g, device=device).to(torch.bfloat16)
        return t.unflatten(2, (H, dh)).transpose(1, 2)

    return heads(Lq), heads(Lk), heads(Lk), heads(Lq)


def _prefix_mask(B, L, lo, hi, device, seed):
    g = torch.Generator().manual_seed(seed)
    lengths = torch.randint(lo, hi + 1, (B,), generator=g)
    return (torch.arange(L)[None, :] < lengths[:, None]).to(device)


def _long_case(case, device):
    """(B, H, Lq, Lk, dh, kwargs) of the main paths' long calls, scaled in B."""
    if case == "bank prompts":  # every row a real prompt of 2 to 21 tokens
        return 24, 12, 512, 512, 64, dict(kv_mask=_prefix_mask(24, 512, 2, 21, device, 1))
    if case == "all real":
        return 8, 12, 512, 512, 64, dict(kv_mask=torch.ones(8, 512, dtype=torch.bool,
                                                            device=device))
    if case == "text 128":
        return 16, 12, 128, 128, 64, dict(kv_mask=_prefix_mask(16, 128, 5, 60, device, 2))
    if case == "caption causal":  # rows 0 and 1 of batch row 1 have no key
        m = _prefix_mask(8, 128, 3, 100, device, 3)
        m[1, :2] = False
        return 8, 8, 128, 128, 64, dict(kv_mask=m, causal=True)
    if case == "cross":
        return 4, 8, 128, 1572, 64, {}
    if case == "holes, a fully masked row":
        g = torch.Generator(device=device).manual_seed(4)
        m = torch.rand(3, 300, generator=g, device=device) > 0.8
        m[1] = False
        return 3, 4, 200, 300, 64, dict(kv_mask=m)
    sin, cos = _rope(128, device)  # "Dh 128, RoPE": L = 199
    return 2, 4, 199, 199, 128, dict(sin=sin, cos=cos)


LONG_CASES = ["bank prompts", "all real", "text 128", "caption causal", "cross",
              "holes, a fully masked row", "Dh 128, RoPE"]


@pytest.mark.parametrize("case", LONG_CASES)
def test_long_kernels_match_plain(cuda, case):
    """The long forward against multi_head_attention (TOL), its gradients
    against flash_bwd_plain by chip_smoke.py phase 7's bars, relative to the
    call's largest gradient; a fully masked row is the uniform mean of v
    over all keys, and its scores pass no gradient."""
    B, H, Lq, Lk, dh, kw = _long_case(case, cuda)
    q, k, v, do = _long_inputs(cuda, B, H, Lq, Lk, dh, 40)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = flash_attention(*leaves, **kw)
    got = torch.autograd.grad(out, leaves, do)
    ref = multi_head_attention(q, k, v, **kw)
    torch.testing.assert_close(out.float(), ref.float(), **TOL)
    want = _plain_grads(q, k, v, do, **kw)
    top = max(float(r.float().abs().max()) for r in want)
    for name, a, r in zip("qkv", got, want):
        d = a.float() - r.float()
        assert float(d.abs().max()) <= 2e-2 * top, name
        assert float(d.norm()) <= 1e-2 * max(float(r.float().norm()), 1e-30) or \
            float(r.float().abs().max()) == 0.0, name
    if case == "holes, a fully masked row":
        torch.testing.assert_close(out[1].float(), v[1].float().mean(1, keepdim=True)
                                   .expand(H, Lq, dh), **TOL)
        assert float(got[0][1].abs().max()) == 0.0 and float(got[1][1].abs().max()) == 0.0


@pytest.mark.parametrize("case", ["bank prompts", "caption causal", "cross", "Dh 128, RoPE"])
def test_long_kernels_batch_invariant_and_reproducible(cuda, case):
    """Two launches agree bit for bit, and a batch row alone (B = 1) gives
    the bits it has in the batch, forward and gradients: the tiles are
    fixed and the skip never changes a real key's arithmetic."""
    B, H, Lq, Lk, dh, kw = _long_case(case, cuda)
    q, k, v, do = _long_inputs(cuda, B, H, Lq, Lk, dh, 41)
    out, got = _short_grads(q, k, v, do, **kw)
    out2, got2 = _short_grads(q, k, v, do, **kw)
    assert torch.equal(out, out2) and all(torch.equal(a, b) for a, b in zip(got, got2))
    i = B // 2
    one_kw = dict(kw, kv_mask=kw["kv_mask"][i:i + 1]) if "kv_mask" in kw else kw
    one, got1 = _short_grads(q[i:i + 1], k[i:i + 1], v[i:i + 1], do[i:i + 1], **one_kw)
    assert torch.equal(out[i:i + 1], one)
    assert all(torch.equal(a[i:i + 1], b) for a, b in zip(got, got1))


def test_long_skip_equals_the_cut_call(cuda):
    """At bank masks (2 to 21 real keys of 512, and one row of 40) the
    forward and dQ equal, bit for bit, a call whose K, V and mask are cut
    to ``key_cut`` keys (the largest extent rounded up to the 128-key
    tiles), and dK and dV past the cut are exactly 0."""
    from deepcoro_clip_tpu_torch.ops._flash_cuda import key_cut

    B, H, L = 24, 12, 512
    q, k, v, do = _long_inputs(cuda, B, H, L, L, 64, 42)
    m = _prefix_mask(B, L, 2, 21, cuda, 5)
    m[3, :40] = True
    cut = key_cut(m, B, L)
    assert cut == 128
    out, got = _short_grads(q, k, v, do, kv_mask=m)
    out_c, got_c = _short_grads(q, k[:, :, :cut], v[:, :, :cut], do,
                                kv_mask=m[:, :cut].contiguous())
    assert torch.equal(out, out_c) and torch.equal(got[0], got_c[0])
    for a, b in zip(got[1:], got_c[1:]):
        assert torch.equal(a[:, :, :cut], b)
        assert float(a[:, :, cut:].abs().max()) == 0.0


def test_long_calls_run_the_hopper_kernels(cuda):
    """From profiler traces: a long bf16 forward is one flash_long_fwd_kernel
    (at Dh 64 and 128, with the RoPE pre-pass where RoPE is on), its
    backward the row pre-pass and the two long backward kernels; no other
    attention kernel of the port runs."""
    for case, dh in (("bank prompts", 64), ("Dh 128, RoPE", 128)):
        B, H, Lq, Lk, _, kw = _long_case(case, cuda)
        q, k, v, do = _long_inputs(cuda, B, H, Lq, Lk, dh, 43)
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = flash_attention(*leaves, **kw)
        fwd = _kernels_run(lambda: flash_attention(q, k, v, **kw))
        bwd = _kernels_run(lambda: torch.autograd.grad(out, leaves, do, retain_graph=True))
        ours = [n for n in fwd + bwd if "flash_" in n or "bwd_rows" in n]
        assert sum(f"flash_long_fwd_kernel<{dh}>" in n for n in fwd) == 1
        assert _ran(bwd, "bwd_rows_kernel") and _ran(bwd, f"flash_long_bwd_dkv_kernel<{dh}>")
        assert _ran(bwd, f"flash_long_bwd_dq_kernel<{dh}>")
        assert not any("sm90" in n or "short" in n or "f32" in n for n in ours), ours


# --------------------------------------------------------------------------- #
# the probing run and the contrastive inference through main, at tiny width

TINY_RUN = dict(frames=4, resize=32, batch_size=2, num_workers=1, multi_video=True,
                num_videos=2, vit_dim=128, vit_depth=1, vit_heads=1, vit_patch=[2, 16, 16],
                vit_pool_stages=[], embedding_dim=16, num_heads=2, aggregator_depth=1,
                dropout=0.0, precision="bf16", use_pallas_attention=True, seed=0,
                dataset_mean=[120.0] * 3, dataset_std=[60.0] * 3, use_wandb=False)


def _tiny_workspace(root):
    import numpy as np

    from deepcoro_clip_tpu_torch.data.csv_utils import write_csv

    r = np.random.default_rng(0)
    rows = []
    for i in range(12):
        p = root / f"clip{i}.npy"
        np.save(p, r.integers(0, 255, size=(4, 32, 32, 3)).astype(np.uint8))
        rows.append({"FileName": str(p), "StudyInstanceUID": f"S{i // 2}",
                     "Split": "train" if i < 8 else "val", "Report": f"report {i % 3}",
                     "stenosis": float(i * 5), "cto": float(i % 2)})
    write_csv(root / "data.csv", list(rows[0]), rows)
    return root / "data.csv"


def test_probing_run_on_the_card(cuda, tmp_path, monkeypatch):
    """The probing runner through main on the card (the backbone at one head
    of 128, so K1 / K5 take it): with DEEPCORO_FUSED_OUTPROJ=1 a train step
    launches K5 (one per block) and the head's fp32 K3/K4, no K1; the
    inference's study embeddings through K5 and through K1 + F.linear agree
    to cosine 0.999."""
    import numpy as np

    from deepcoro_clip_tpu_torch.configs import LinearProbingConfig
    from deepcoro_clip_tpu_torch.main import main

    data = _tiny_workspace(tmp_path)
    kw = dict(TINY_RUN, pipeline_project="DeepCORO_video_linear_probing",
              data_filename=str(data), epochs=1, pooling_mode="attention+cls_token",
              head_structure={"stenosis": 1, "cto": 1},
              loss_structure={"stenosis": "huber", "cto": "bce_logit"},
              head_task={"stenosis": "regression", "cto": "binary"}, attention_hidden=8,
              ci_n_bootstrap=20, save_embeddings=True)
    monkeypatch.setenv("DEEPCORO_FUSED_OUTPROJ", "1")
    n5, n1 = flash_attention_packed.proj_launches, flash_attention_packed.launches
    n3, n4 = flash_attention.launches, flash_attention.bwd_launches
    res = main(config=LinearProbingConfig.from_dict(dict(kw, output_dir=str(tmp_path / "t"))))
    assert np.isfinite(res["history"][0]["loss"])
    # 2 train steps and 1 validation batch, one block
    assert flash_attention_packed.proj_launches - n5 == 3
    assert flash_attention_packed.launches == n1
    assert (flash_attention.launches - n3, flash_attention.bwd_launches - n4) == (3, 2)
    emb = {}
    for switch in ("1", "0"):
        monkeypatch.setenv("DEEPCORO_FUSED_OUTPROJ", switch)
        out = tmp_path / f"infer{switch}"
        r = main(config=LinearProbingConfig.from_dict(dict(
            kw, output_dir=str(out), run_mode="inference", split_filter="all")))
        assert r["rows"] == 6
        (npz,) = out.rglob("study_embeddings.npz")
        emb[switch] = torch.from_numpy(np.load(npz)["embeddings"])
    assert flash_attention_packed.launches > n1  # the switch off: K1
    cos = torch.nn.functional.cosine_similarity(emb["1"], emb["0"], dim=1)
    assert float(cos.min()) >= 0.999


def test_clip_inference_on_the_card(cuda, tmp_path):
    """The contrastive inference through main on the card: one row a study,
    K1 per block and batch, and the top-1 of each study equal to the plain
    attention's with the same weights where the two best scores are 1e-3
    apart."""
    import csv
    import json

    import numpy as np

    from deepcoro_clip_tpu_torch.configs import ClipConfig
    from deepcoro_clip_tpu_torch.main import main
    from deepcoro_clip_tpu_torch.runners.contrastive import VideoContrastiveLearningRunner

    data = _tiny_workspace(tmp_path)
    r = np.random.default_rng(1)
    np.savez(tmp_path / "bank.npz", text_embeddings=r.normal(size=(8, 16)).astype(np.float32))
    (tmp_path / "meta.csv").write_text("x,y\n" + "".join(f"{i},{'ab'[i % 2]}\n"
                                                          for i in range(8)))
    cfg = ClipConfig.from_dict(dict(
        TINY_RUN, pipeline_project="DeepCORO_clip", run_mode="inference",
        data_filename=str(data), split_column="none", output_dir=str(tmp_path / "o"),
        text_dim=64, text_depth=1, text_heads=1, text_vocab_size=512, max_text_length=16,
        text_embeddings_path=str(tmp_path / "bank.npz"), topk=3,
        metadata_path=str(tmp_path / "meta.csv"),
        inference_results_path=str(tmp_path / "inference")))
    n1 = flash_attention_packed.launches
    assert main(config=cfg)["inference_rows"] == 6
    assert flash_attention_packed.launches - n1 == 3  # 3 batches, one block
    with open(tmp_path / "inference" / "averaged_metadata.csv") as f:
        rows = list(csv.DictReader(f))
    runner = VideoContrastiveLearningRunner(cfg, output_dir=tmp_path / "plain")
    for m in runner.bundle.video_model.modules():
        if hasattr(m, "use_flash"):
            m.use_flash = False
    v = np.concatenate([runner.video_embeddings(b) for b in runner.loaders["inference"]])
    bank = np.load(tmp_path / "bank.npz")["text_embeddings"]
    sim = (v / np.linalg.norm(v, axis=1, keepdims=True)) @ (
        bank / np.linalg.norm(bank, axis=1, keepdims=True)).T
    for b, row in enumerate(rows):
        order = np.argsort(-sim[b])
        got = json.loads(row["topk_indices"])
        if sim[b, order[0]] - sim[b, order[1]] > 1e-3:
            assert got[0] == int(order[0])
        assert abs(json.loads(row["topk_scores"])[0] - sim[b, order[0]]) <= 1e-2


# --------------------------------------------------------------------------- #
# the SIMT kernels: fp32 packed (K1, K2, K5), bf16 at Dh 256 to 512, the
# padded K3/K4 widths, K6 in fp32 and padded

# fp32 kernels vs the plain versions in fp32 (nothing rounded below fp32;
# exp2 with the scale folded in, sums in another order)
SIMT_F32_TOL = dict(atol=2e-5, rtol=2e-5)
SIMT_F32_BWD_TOL = dict(atol=1e-4, rtol=1e-4)


def _tables(L, dh, device):
    pos = torch.arange(L, dtype=torch.float32)[:, None]
    f = 1.0 / 10000 ** (torch.arange(dh // 2, dtype=torch.float32) / (dh // 2))
    a = torch.cat([pos * f, pos * f], dim=1)
    return a.sin().to(device).contiguous(), a.cos().to(device).contiguous()


@pytest.mark.parametrize("dtype,dh,H,L", [
    (torch.float32, 128, 2, 200), (torch.float32, 256, 2, 136),
    (torch.float32, 512, 1, 70), (torch.bfloat16, 256, 2, 200),
    (torch.bfloat16, 384, 1, 70), (torch.bfloat16, 512, 1, 70)])
@pytest.mark.parametrize("causal", [False, True])
def test_simt_packed_kernels_match_plain(cuda, dtype, dh, H, L, causal):
    """K1, K2 (fused qkv, RoPE, a key mask with a half-masked row) and K5
    (``wo`` 384 wide) on the SIMT kernels against the plain versions: fp32
    at SIMT_F32_TOL, bf16 at the bf16 bars; one launch each, counted."""
    g = torch.Generator(device=cuda).manual_seed(dh + L)
    D = H * dh
    qkv = (torch.randn(2, L, 3 * D, generator=g, device=cuda) * 0.5).to(dtype)
    do = (torch.randn(2, L, D, generator=g, device=cuda) * 0.5).to(dtype)
    sin, cos = _tables(L, dh, cuda)
    m = torch.ones(2, L, dtype=torch.bool, device=cuda)
    m[1, L // 2:] = False
    kw = dict(sin=sin, cos=cos, kv_mask=m, causal=causal)
    tol, btol = (SIMT_F32_TOL, SIMT_F32_BWD_TOL) if dtype == torch.float32 else (TOL, BWD_TOL)
    n = flash_attention_packed.launches, flash_attention_packed.bwd_launches
    leaf = qkv.clone().requires_grad_()
    out = flash_attention_packed(qkv=leaf, num_heads=H, **kw)
    (dqkv,) = torch.autograd.grad(out, [leaf], do)
    assert (flash_attention_packed.launches, flash_attention_packed.bwd_launches) == (
        n[0] + 1, n[1] + 1)
    heads = [t.unflatten(2, (H, dh)).transpose(1, 2) for t in qkv.split(D, -1)]
    ref = multi_head_attention(*heads, **kw)
    torch.testing.assert_close(out.detach().float(),
                               ref.transpose(1, 2).flatten(2).float(), **tol)
    want = flash_bwd_plain(*heads, do.unflatten(2, (H, dh)).transpose(1, 2), ref, **kw)
    want = torch.cat([w.transpose(1, 2).flatten(2) for w in want], -1)
    torch.testing.assert_close(dqkv.float(), want.float(), **btol)
    if not causal:
        wo = (torch.randn(D, 384, generator=g, device=cuda) * D ** -0.5).to(dtype)
        n5 = flash_attention_packed.proj_launches
        with torch.no_grad():
            y = flash_attention_packed(qkv=qkv, num_heads=H, wo=wo, **kw)
        assert flash_attention_packed.proj_launches == n5 + 1
        yref = torch.matmul(ref.transpose(1, 2).flatten(2).float(), wo.float())
        torch.testing.assert_close(y.float(), yref, **(tol if dtype == torch.float32
                                                        else dict(atol=3e-2, rtol=3e-2)))


@pytest.mark.parametrize("dtype,dh,rope", [
    (torch.float32, 32, True), (torch.bfloat16, 32, True), (torch.float32, 96, False),
    (torch.bfloat16, 96, True), (torch.bfloat16, 192, True), (torch.float32, 192, False)])
def test_padded_head_dims_match_plain(cuda, dtype, dh, rope):
    """K3/K4 at head dims no kernel is built for, padded as the JAX
    wrapper pads (``pad_head_dim``): the output and gradients against the
    plain version at the original width."""
    g = torch.Generator(device=cuda).manual_seed(dh)
    L = 130
    q, k, v, do = ((torch.randn(2, 3, L, dh, generator=g, device=cuda) * 0.5).to(dtype)
                   for _ in range(4))
    sin, cos = _tables(L, dh, cuda) if rope else (None, None)
    m = torch.ones(2, L, dtype=torch.bool, device=cuda)
    m[0, 100:] = False
    tol, btol = (SIMT_F32_TOL, SIMT_F32_BWD_TOL) if dtype == torch.float32 else (TOL, BWD_TOL)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    n = flash_attention.launches
    out = flash_attention(*leaves, sin=sin, cos=cos, kv_mask=m)
    grads = torch.autograd.grad(out, leaves, do)
    assert flash_attention.launches == n + 1
    ref = multi_head_attention(q, k, v, sin=sin, cos=cos, kv_mask=m)
    torch.testing.assert_close(out.detach().float(), ref.float(), **tol)
    want = flash_bwd_plain(q, k, v, do, ref, sin=sin, cos=cos, kv_mask=m)
    for got, w in zip(grads, want):
        torch.testing.assert_close(got.float(), w.float(), **btol)


@pytest.mark.parametrize("dtype,dh", [(torch.float32, 128), (torch.float32, 96),
                                      (torch.bfloat16, 256)])
def test_ring_kernel_in_fp32_and_padded(cuda, dtype, dh):
    """K6's fp32 SIMT step (at Dh 128, and at 96 padded to 128) and the wide
    bf16 one (Dh 256) over 4 shards on one card against the whole
    sequence's plain attention; n x n launches."""
    from deepcoro_clip_tpu_torch.parallel import ring_attention

    g = torch.Generator(device=cuda).manual_seed(dh)
    q, k, v = ((torch.randn(2, 2, 512, dh, generator=g, device=cuda)).to(dtype)
               for _ in range(3))
    n = ring_attention.launches
    with torch.no_grad():
        out = ring_attention(q, k, v, _ring_mesh(4, [cuda] * 4), backend="rdma")
    assert ring_attention.launches == n + 16
    tol = SIMT_F32_TOL if dtype == torch.float32 else TOL
    torch.testing.assert_close(out.float(), multi_head_attention(q, k, v).float(), **tol)


# --------------------------------------------------------------------------- #
# the register-tiled fp32 forward (csrc/fwd_f32_regtile.cuh): K1 and K3 at
# Dh 64 / 128, K5 at Dh 128. Bars: the forward by F32_TOL (1e-5 +
# 1e-5|plain|; nothing rounded below fp32, sums in another order), the
# gradients (K2 / K4 from the new forward's statistics) by REGTILE_GRAD_REL
# of max|plain|; where every row sees one key (one key, or one query row
# under causal masking) dq and dk are 0 up to rounding, and held by the
# forward's F32_TOL elementwise instead, as chip_smoke.py holds a short
# call's fp32 gradients: a bar relative to their max|plain| would read noise.

REGTILE_GRAD_REL = 1e-4


def _grad_close(name, got, want, one_key=False):
    """``one_key``: every row sees one key, so dq and dk are 0 up to
    rounding."""
    if one_key and name in ("dq", "dk"):
        torch.testing.assert_close(got, want, **F32_TOL, msg=lambda s: f"{name}: {s}")
        return
    err, top = float((got - want).abs().max()), float(want.abs().max())
    assert err <= REGTILE_GRAD_REL * top, f"{name}: max|d| {err:.3e}, max|plain| {top:.3e}"


def _regtile_kw(mode, Lq, Lk, dh, B, g, device):
    """rope (Lq = Lk), a key mask whose batch row 1 is fully masked, or causal."""
    if mode == "rope":
        sin, cos = _tables(Lq, dh, device)
        return dict(sin=sin, cos=cos)
    if mode == "causal":
        return dict(causal=True)
    m = torch.rand(B, Lk, generator=g, device=device) > 0.3
    m[1] = False
    return dict(kv_mask=m)


@pytest.mark.parametrize("layout", ["fused", "split"])
@pytest.mark.parametrize("mode", ["rope", "mask", "causal", "plain"])
@pytest.mark.parametrize("L", [1569, 393, 128, 65, 1])
def test_regtile_packed_forward_and_gradients(cuda, L, mode, layout):
    """fp32 K1 at Dh 128 on ``flash_fwd_f32_regtile_kernel<128>`` (fused
    qkv or split q/k/v, at the video tower's lengths, a 64-row tile, one row
    past it and one row), against the plain version; K2's gradients from the
    new forward's statistics against ``flash_bwd_plain``."""
    g = torch.Generator(device=cuda).manual_seed(L + len(mode))
    B, H, dh = 2, 4, 128
    D = H * dh
    kw = {} if mode == "plain" else _regtile_kw(mode, L, L, dh, B, g, cuda)
    qkv = torch.randn(B, L, 3 * D, generator=g, device=cuda) * 0.5
    do = torch.randn(B, L, D, generator=g, device=cuda) * 0.5
    heads = [t.unflatten(2, (H, dh)).transpose(1, 2) for t in qkv.split(D, -1)]
    if layout == "fused":
        leaves = [qkv.clone().requires_grad_()]
        out = flash_attention_packed(qkv=leaves[0], num_heads=H, **kw)
    else:
        leaves = [t.contiguous().requires_grad_() for t in qkv.split(D, -1)]
        out = flash_attention_packed(*leaves, num_heads=H, **kw)
    ref = multi_head_attention(*heads, **kw)
    torch.testing.assert_close(out.detach(), ref.transpose(1, 2).flatten(2), **F32_TOL)
    grads = torch.autograd.grad(out, leaves, do)
    grads = grads[0].split(D, -1) if layout == "fused" else grads
    want = flash_bwd_plain(*heads, do.unflatten(2, (H, dh)).transpose(1, 2), ref, **kw)
    for name, a, w in zip("qkv", grads, want):
        _grad_close(f"d{name}", a, w.transpose(1, 2).flatten(2), one_key=L == 1)
    if mode == "mask":  # a row with no real key: the uniform mean, its dq 0
        assert float(grads[0][1].abs().max()) == 0.0


REGTILE_HEADS_CASES = [(Lq, Lk, mode) for Lq, Lk in ((393, 393), (128, 128), (65, 65),
                                                      (130, 77), (1, 200), (200, 1))
                       for mode in ("rope", "mask", "causal") if mode != "rope" or Lq == Lk]


@pytest.mark.parametrize("Lq,Lk,mode", REGTILE_HEADS_CASES)
@pytest.mark.parametrize("dh", [64, 128])
def test_regtile_heads_forward_and_gradients(cuda, dh, Lq, Lk, mode):
    """fp32 K3 (the ``[B, H, L, Dh]`` entry past the short lengths) at Dh 64
    and 128 on ``flash_fwd_f32_regtile_kernel<Dh>``, Lq = Lk and not (RoPE
    only at Lq = Lk, as the entry takes it), with strided views of packed
    operands; K4's gradients from its statistics."""
    g = torch.Generator(device=cuda).manual_seed(dh + Lq + 7 * Lk)
    B, H = 2, 512 // dh
    kw = _regtile_kw(mode, Lq, Lk, dh, B, g, cuda)
    q, k, v = ((torch.randn(B, n, 512, generator=g, device=cuda) * 0.5)
               .unflatten(2, (H, dh)).transpose(1, 2) for n in (Lq, Lk, Lk))
    do = torch.randn(B, H, Lq, dh, generator=g, device=cuda) * 0.5
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    n = flash_attention.launches
    out = flash_attention(*leaves, **kw)
    assert flash_attention.launches == n + 1
    ref = multi_head_attention(q, k, v, **kw)
    torch.testing.assert_close(out.detach(), ref, **F32_TOL)
    grads = torch.autograd.grad(out, leaves, do)
    want = flash_bwd_plain(q, k, v, do, ref, **kw)
    one_key = Lk == 1 or (Lq == 1 and mode == "causal")
    for name, a, w in zip("qkv", grads, want):
        _grad_close(f"d{name}", a, w, one_key=one_key)


@pytest.mark.parametrize("mode", ["rope", "mask", "causal"])
@pytest.mark.parametrize("H,dout", [(4, 512), (4, 300), (8, 512), (8, 300), (2, 640)])
def test_regtile_fused_projection(cuda, H, dout, mode):
    """fp32 K5 at Dh 128 on ``flash_fwd_proj_f32_regtile_kernel``: H*Dh 512
    and 1024, Dout 512, a ragged 300 and 640 (five 128-column chunks),
    y against the plain attention and product; with a gradient the same
    kernel writes ``o`` and the statistics, and the backward's dq, dk, dv,
    dwo match autograd through the plain version."""
    g = torch.Generator(device=cuda).manual_seed(H * dout + len(mode))
    B, L, dh = 2, 393, 128
    D = H * dh
    kw = _regtile_kw(mode, L, L, dh, B, g, cuda)
    qkv = torch.randn(B, L, 3 * D, generator=g, device=cuda) * 0.5
    wo = torch.randn(D, dout, generator=g, device=cuda) * D ** -0.5
    gy = torch.randn(B, L, dout, generator=g, device=cuda)
    n = flash_attention_packed.proj_launches
    with torch.no_grad():
        y = flash_attention_packed(qkv=qkv, num_heads=H, wo=wo, **kw)
    leaves = [qkv.clone().requires_grad_(), wo.clone().requires_grad_()]
    y2 = flash_attention_packed(qkv=leaves[0], num_heads=H, wo=leaves[1], **kw)
    assert flash_attention_packed.proj_launches == n + 2
    assert torch.equal(y, y2.detach())
    plain = [qkv.clone().requires_grad_(), wo.clone().requires_grad_()]
    heads = [t.unflatten(2, (H, dh)).transpose(1, 2) for t in plain[0].split(D, -1)]
    yref = project_plain(multi_head_attention(*heads, **kw).transpose(1, 2).flatten(2), plain[1])
    torch.testing.assert_close(y, yref.detach(), **F32_TOL)
    got = torch.autograd.grad(y2, leaves, gy)
    want = torch.autograd.grad(yref, plain, gy)
    for name, a, w in zip(("dqkv", "dwo"), got, want):
        _grad_close(name, a, w)


@pytest.mark.parametrize("which", ["K1", "K3 Dh 64", "K3 Dh 128", "K5"])
def test_regtile_batch_invariant_and_reproducible(cuda, which):
    """Every row of a B = 4 call bit-equal to the same row called alone (B
    = 1), and two calls bit-equal: fixed tiles, fixed sums, no atomics."""
    g = torch.Generator(device=cuda).manual_seed(19)
    sin, cos = _tables(393, 128, cuda)
    qkv = torch.randn(4, 393, 1536, generator=g, device=cuda) * 0.5
    wo = torch.randn(512, 512, generator=g, device=cuda) * 512 ** -0.5
    text = torch.randn(4, 3, 200, 768, generator=g, device=cuda) * 0.5
    mask = torch.rand(4, 200, generator=g, device=cuda) > 0.3

    def call(rows):
        if which == "K1":
            return flash_attention_packed(qkv=qkv[rows], num_heads=4, sin=sin, cos=cos)
        if which == "K5":
            return flash_attention_packed(qkv=qkv[rows], num_heads=4, sin=sin, cos=cos, wo=wo)
        dh = int(which.split()[-1])
        q, k, v = (text[rows, i].unflatten(2, (768 // dh, dh)).transpose(1, 2)
                   for i in range(3))
        return flash_attention(q, k, v, kv_mask=mask[rows])

    with torch.no_grad():
        full = call(slice(0, 4))
        assert torch.equal(full, call(slice(0, 4)))
        for b in range(4):
            assert torch.equal(full[b:b + 1], call(slice(b, b + 1))), f"row {b}"


def test_regtile_kernels_by_name(cuda):
    """The profiler names the new kernels for fp32 at Dh 64 / 128 and K5 at
    128, and the SIMT ones for fp32 at Dh 256 (K1) and 512 (K5)."""
    g = torch.Generator(device=cuda).manual_seed(5)
    qkv = torch.randn(2, 200, 1536, generator=g, device=cuda)
    wo = torch.randn(512, 512, generator=g, device=cuda) * 0.05
    x = torch.randn(2, 8, 200, 64, generator=g, device=cuda)
    with torch.no_grad():
        for fn, want, not_want in (
                (lambda: flash_attention_packed(qkv=qkv, num_heads=4),
                 "flash_fwd_f32_regtile_kernel<128>", "flash_fwd_f32_kernel"),
                (lambda: flash_attention(x, x, x), "flash_fwd_f32_regtile_kernel<64>",
                 "flash_fwd_f32_kernel"),
                (lambda: flash_attention_packed(qkv=qkv, num_heads=4, wo=wo),
                 "flash_fwd_proj_f32_regtile_kernel", "flash_fwd_proj_f32_kernel"),
                (lambda: flash_attention_packed(qkv=qkv, num_heads=2),
                 "flash_fwd_f32_kernel<256>", "regtile"),
                (lambda: flash_attention_packed(qkv=qkv, num_heads=1, wo=wo),
                 "flash_fwd_proj_f32_kernel<512>", "regtile")):
            names = _kernels_run(fn)
            assert _ran(names, want) and not _ran(names, not_want), names


def test_regtile_takes_unaligned_operands(cuda):
    """fp32 operands that do not allow 16-byte copies (an odd offset, an odd
    row stride) go through the 4-byte copies and match the plain version."""
    g = torch.Generator(device=cuda).manual_seed(3)
    base = torch.randn(2 * 130 * 513 + 1, generator=g, device=cuda)
    x = base[1:].view(2, 130, 513)[..., :512]  # offset 4 bytes, row stride 513
    q, k, v = (x.unflatten(2, (8, 64)).transpose(1, 2) for _ in range(3))
    wo = torch.randn(512, 301, generator=g, device=cuda) * 0.05
    with torch.no_grad():
        out = flash_attention(q, k, v)
        torch.testing.assert_close(out, multi_head_attention(q, k, v), **F32_TOL)
        y = flash_attention_packed(x, x, x, num_heads=4, wo=wo)
        heads = [t.unflatten(2, (4, 128)).transpose(1, 2) for t in (x, x, x)]
        ref = project_plain(multi_head_attention(*heads).transpose(1, 2).flatten(2), wo)
        torch.testing.assert_close(y, ref, **F32_TOL)


# --------------------------------------------------------------------------- #
# the register-tiled fp32 backward (csrc/bwd_f32_regtile.cuh): K2 and K4 at
# Dh 64 / 128 on flash_bwd_dkv_f32_regtile_kernel<Dh> and
# flash_bwd_dq_f32_regtile_kernel<Dh>. The gradients against
# flash_bwd_plain (from the plain output) by REGTILE_GRAD_REL of max|plain|,
# as the forward's tests hold them: nothing rounded below fp32, sums in
# another order.


def _packed_leaves(qkv, D, layout):
    """fused: one [B, L, 3D] leaf; packed: three contiguous [B, L, D];
    split: three strided views of one [B, L, 3D] (rows 3D apart)."""
    if layout == "fused":
        return [qkv.clone().requires_grad_()]
    if layout == "packed":
        return [t.contiguous().requires_grad_() for t in qkv.split(D, -1)]
    base = qkv.clone().requires_grad_()
    return [base]


def _packed_call(leaves, D, layout, **kw):
    if layout == "fused":
        return flash_attention_packed(qkv=leaves[0], **kw)
    if layout == "packed":
        return flash_attention_packed(*leaves, **kw)
    return flash_attention_packed(*leaves[0].split(D, -1), **kw)


@pytest.mark.parametrize("layout", ["fused", "packed", "split"])
@pytest.mark.parametrize("L,mode", [(1569, "rope"), (393, "rope"), (393, "mask"),
                                    (393, "causal"), (130, "rope")])
def test_regtile_bwd_packed_layouts(cuda, L, mode, layout):
    """fp32 K2 at Dh 128 on the register-tiled dK/dV and dQ kernels, every
    packed layout (fused qkv, three contiguous tensors, three strided views
    of one), at the video tower's lengths (1569 = 24 * 64 + 33, 393 = 6 *
    64 + 9: the tails of the 64-key and 64- / 128-row tiles), with RoPE, a
    key mask whose batch row 1 has no real key, or causal: one backward
    launch a call, dq, dk, dv against the plain version."""
    g = torch.Generator(device=cuda).manual_seed(L + 3 * len(mode) + len(layout))
    B, H, dh = 2, 4, 128
    D = H * dh
    kw = _regtile_kw(mode, L, L, dh, B, g, cuda)
    qkv = torch.randn(B, L, 3 * D, generator=g, device=cuda) * 0.5
    do = torch.randn(B, L, D, generator=g, device=cuda) * 0.5
    leaves = _packed_leaves(qkv, D, layout)
    out = _packed_call(leaves, D, layout, num_heads=H, **kw)
    n = flash_attention_packed.bwd_launches
    grads = torch.autograd.grad(out, leaves, do)
    assert flash_attention_packed.bwd_launches == n + 1
    grads = grads[0].split(D, -1) if layout != "packed" else grads
    heads = [t.unflatten(2, (H, dh)).transpose(1, 2) for t in qkv.split(D, -1)]
    ref = multi_head_attention(*heads, **kw)
    want = flash_bwd_plain(*heads, do.unflatten(2, (H, dh)).transpose(1, 2), ref, **kw)
    for name, a, w in zip("qkv", grads, want):
        _grad_close(f"d{name}", a, w.transpose(1, 2).flatten(2))
    if mode == "mask":  # batch row 1 has no real key: no gradient through its scores
        assert float(grads[0][1].abs().max()) == 0.0 and float(grads[1][1].abs().max()) == 0.0


REGTILE_BWD_HEADS_CASES = [(128, 128, "mask"), (393, 393, "causal"), (200, 200, "rope"),
                           (128, 1572, "mask"), (1572, 128, "mask"), (65, 65, "mask"),
                           (393, 393, "mask")]


@pytest.mark.parametrize("Lq,Lk,mode", REGTILE_BWD_HEADS_CASES)
@pytest.mark.parametrize("dh", [64, 128])
def test_regtile_bwd_heads(cuda, dh, Lq, Lk, mode):
    """fp32 K4 (the ``[B, H, L, Dh]`` entry past the short lengths) at Dh 64
    and 128 on the register-tiled backward: a padding mask (a real prefix
    a row, batch row 1 with none), causal, RoPE, and Lq != Lk (the
    decoder's cross attention 128|1572, and the other way round), with
    strided views of packed operands."""
    g = torch.Generator(device=cuda).manual_seed(dh + 3 * Lq + Lk)
    B, H = 3, 512 // dh
    if mode == "mask":  # the text tower's kind: a real prefix a row, row 1 none
        lengths = torch.randint(1, Lk + 1, (B,), generator=g, device=cuda)
        kw = dict(kv_mask=torch.arange(Lk, device=cuda)[None] < lengths[:, None])
        kw["kv_mask"][1] = False
    else:
        kw = _regtile_kw(mode, Lq, Lk, dh, B, g, cuda)
    q, k, v = ((torch.randn(B, n, 512, generator=g, device=cuda) * 0.5)
               .unflatten(2, (H, dh)).transpose(1, 2) for n in (Lq, Lk, Lk))
    do = torch.randn(B, H, Lq, dh, generator=g, device=cuda) * 0.5
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out = flash_attention(*leaves, **kw)
    n = flash_attention.bwd_launches
    grads = torch.autograd.grad(out, leaves, do)
    assert flash_attention.bwd_launches == n + 1
    ref = multi_head_attention(q, k, v, **kw)
    want = flash_bwd_plain(q, k, v, do, ref, **kw)
    for name, a, w in zip("qkv", grads, want):
        _grad_close(f"d{name}", a, w)
    if mode == "mask":
        assert float(grads[0][1].abs().max()) == 0.0  # no real key: dq 0
        assert bool(torch.isfinite(grads[2]).all())


@pytest.mark.parametrize("which", ["K2", "K4 Dh 64", "K4 Dh 128"])
def test_regtile_bwd_batch_invariant_and_reproducible(cuda, which):
    """Every row's gradients of a B = 4 call bit-equal to the same row
    called alone (B = 1), and two calls bit-equal: fixed tiles, fixed sums,
    no atomics."""
    g = torch.Generator(device=cuda).manual_seed(20)
    sin, cos = _tables(393, 128, cuda)
    qkv = torch.randn(4, 393, 1536, generator=g, device=cuda) * 0.5
    do_p = torch.randn(4, 393, 512, generator=g, device=cuda) * 0.5
    text = torch.randn(4, 3, 200, 768, generator=g, device=cuda) * 0.5
    do_t = torch.randn(4, 200, 768, generator=g, device=cuda) * 0.5
    mask = torch.rand(4, 200, generator=g, device=cuda) > 0.3

    def grads(rows):
        if which == "K2":
            leaf = qkv[rows].clone().requires_grad_()
            out = flash_attention_packed(qkv=leaf, num_heads=4, sin=sin, cos=cos)
            return torch.autograd.grad(out, [leaf], do_p[rows])
        dh = int(which.split()[-1])
        leaves = [text[rows, i].unflatten(2, (768 // dh, dh)).transpose(1, 2).clone()
                  .requires_grad_() for i in range(3)]
        out = flash_attention(*leaves, kv_mask=mask[rows])
        return torch.autograd.grad(out, leaves,
                                   do_t[rows].unflatten(2, (768 // dh, dh)).transpose(1, 2))

    full = grads(slice(0, 4))
    for a, c in zip(full, grads(slice(0, 4))):
        assert torch.equal(a, c)
    for b in range(4):
        for a, c in zip(full, grads(slice(b, b + 1))):
            assert torch.equal(a[b:b + 1], c), f"row {b}"


def test_regtile_bwd_takes_unaligned_operands(cuda):
    """fp32 operands that allow only 4-byte copies (q, k, v and dO at a
    4-byte offset with rows 513 floats apart) through the register-tiled
    backward, K4 at Dh 64 and 128 and K2."""
    g = torch.Generator(device=cuda).manual_seed(4)
    x = [torch.randn(2 * 130 * 513 + 1, generator=g, device=cuda)[1:].view(2, 130, 513)[..., :512]
         for _ in range(4)]  # q, k, v, dO
    for H, dh, packed in ((8, 64, False), (4, 128, False), (4, 128, True)):
        heads = [t.unflatten(2, (H, dh)).transpose(1, 2) for t in x]
        if packed:
            leaves = [t.detach().requires_grad_() for t in x[:3]]
            grads = torch.autograd.grad(flash_attention_packed(*leaves, num_heads=H), leaves, x[3])
            grads = [t.unflatten(2, (H, dh)).transpose(1, 2) for t in grads]
        else:
            leaves = [t.detach().requires_grad_() for t in heads[:3]]
            grads = torch.autograd.grad(flash_attention(*leaves), leaves, heads[3])
        want = flash_bwd_plain(*heads, multi_head_attention(*heads[:3]))
        for name, a, w in zip("qkv", grads, want):
            _grad_close(f"d{name} Dh {dh}{' packed' if packed else ''}", a, w)


def test_regtile_bwd_fused_writes_only_its_columns(cuda):
    """K2's fused layout through ``_flash_cuda.flash_bwd``: dq, dk, dv are
    column blocks of one gradient buffer (here inside a wider one filled
    with a sentinel); each kernel writes only its own block (bit-equal to
    the gradients written into three separate tensors) and nothing
    outside them."""
    from deepcoro_clip_tpu_torch.ops._flash_cuda import flash_bwd, flash_fwd

    g = torch.Generator(device=cuda).manual_seed(6)
    B, L, H, dh = 2, 393, 4, 128
    D = H * dh
    sin, cos = _tables(L, dh, cuda)
    qkv = torch.randn(B, L, 3 * D, generator=g, device=cuda) * 0.5
    q, k, v = (t.unflatten(2, (H, dh)).transpose(1, 2) for t in qkv.split(D, -1))
    do = ((torch.randn(B, L, D, generator=g, device=cuda) * 0.5).unflatten(2, (H, dh))
          .transpose(1, 2))
    out = torch.empty(B, L, D, device=cuda).unflatten(2, (H, dh)).transpose(1, 2)
    stats = torch.empty(2, B, H, L, device=cuda)
    kw = dict(sin=sin, cos=cos, kv_mask=None, causal=False, scale=dh ** -0.5)
    flash_fwd(q, k, v, out, stats=stats, packed=True, **kw)
    wide = torch.full((B, L, 3 * D + 96), 7.25, device=cuda)
    blocks = [wide[..., 32 + i * D:32 + (i + 1) * D].unflatten(2, (H, dh)).transpose(1, 2)
              for i in range(3)]
    flash_bwd(q, k, v, out, do, stats, *blocks, packed=True, **kw)
    apart = [torch.empty(B, L, D, device=cuda).unflatten(2, (H, dh)).transpose(1, 2)
             for _ in range(3)]
    flash_bwd(q, k, v, out, do, stats, *apart, packed=True, **kw)
    for name, a, c in zip("qkv", blocks, apart):
        assert torch.equal(a, c), f"d{name}"
    assert bool((wide[..., :32] == 7.25).all()) and bool((wide[..., 32 + 3 * D:] == 7.25).all())


def test_regtile_bwd_kernels_by_name(cuda):
    """The profiler names the new dK/dV and dQ kernels for fp32 K2 at Dh 128
    and K4 at Dh 64 / 128 (the old SIMT ones not), and the SIMT ones for
    fp32 K2 at Dh 256."""
    g = torch.Generator(device=cuda).manual_seed(8)
    qkv = torch.randn(2, 200, 1536, generator=g, device=cuda)
    x = torch.randn(2, 8, 200, 64, generator=g, device=cuda)
    y = torch.randn(2, 4, 200, 128, generator=g, device=cuda)

    def backward(fn, leaves):
        out = fn(*leaves)
        do = torch.ones_like(out)
        return lambda: torch.autograd.grad(out, leaves, do, retain_graph=True)

    for fn, leaves, want, not_want in (
            (lambda a: flash_attention_packed(qkv=a, num_heads=4), [qkv.clone().requires_grad_()],
             ("flash_bwd_dkv_f32_regtile_kernel<128>", "flash_bwd_dq_f32_regtile_kernel<128>"),
             ("flash_bwd_dkv_f32_kernel", "flash_bwd_dq_f32_kernel")),
            (flash_attention, [x.clone().requires_grad_() for _ in range(3)],
             ("flash_bwd_dkv_f32_regtile_kernel<64>", "flash_bwd_dq_f32_regtile_kernel<64>"),
             ("flash_bwd_dkv_f32_kernel", "flash_bwd_dq_f32_kernel")),
            (flash_attention, [y.clone().requires_grad_() for _ in range(3)],
             ("flash_bwd_dkv_f32_regtile_kernel<128>", "flash_bwd_dq_f32_regtile_kernel<128>"),
             ("flash_bwd_dkv_f32_kernel", "flash_bwd_dq_f32_kernel")),
            (lambda a: flash_attention_packed(qkv=a, num_heads=2), [qkv.clone().requires_grad_()],
             ("flash_bwd_dkv_f32_kernel<256>", "flash_bwd_dq_f32_kernel<256>"), ("regtile",))):
        names = _kernels_run(backward(fn, leaves))
        assert all(_ran(names, w) for w in want), names
        assert not any(_ran(names, w) for w in not_want), names


# --------------------------------------------------------------------------- #
# the wide bf16 forwards on the tensor cores: K1 and K3 at Dh 256 to 512 on
# flash_fwd_wide_sm90_kernel<Dh>, K5 there on
# flash_fwd_proj_wide_sm90_kernel<Dh>. The forward against the plain
# version by TOL; K5's y against the plain output's product with wo in fp32
# by WIDE_PROJ_TOL (y is rounded once to bf16 from a sum over up to 1024
# bf16 products of the bf16-rounded output, as test_simt_packed_kernels_
# match_plain holds it); the gradients (the wide SIMT backward from the new
# forward's row statistics) by chip_smoke.py's relative l2 of 1e-2
# (BWD_L2_REL). q and k are drawn WIDE_QK times wider than v (std 1.5: the
# scores' std is 2.25 and the softmax peaked, as chip_smoke.py's
# WIDE_QK_SCALE), so that a wrong rotation or mask moves the output far past
# the bars; the forward is held by a relative l2 of WIDE_FWD_L2 too.

WIDE_PROJ_TOL = dict(atol=3e-2, rtol=3e-2)
WIDE_BWD_L2 = 1e-2
WIDE_FWD_L2 = 1e-2
WIDE_QK = 3.0
BF = torch.bfloat16


def _wide_randn(shape, D, g, device):
    """A ``[..., 3D]`` qkv at std 0.5, its first 2D columns (q and k)
    WIDE_QK times wider, in bf16."""
    x = torch.randn(*shape, generator=g, device=device) * 0.5
    x[..., :2 * D] *= WIDE_QK
    return x.to(BF)


def _fwd_close(got, want, tol=TOL):
    """Elementwise by ``tol`` and by a relative l2 of WIDE_FWD_L2."""
    got, want = got.float(), want.float()
    torch.testing.assert_close(got, want, **tol)
    err = float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))
    assert err <= WIDE_FWD_L2, f"forward rel l2 {err:.3e}"


def _rel_l2(name, got, want, one_key=False):
    """``one_key``: every row sees one key, so dq and dk are 0 up to
    rounding (held by F32_TOL elementwise, as ``_grad_close`` holds them)."""
    got, want = got.float(), want.float()
    if one_key and name in ("dq", "dk"):
        torch.testing.assert_close(got, want, **F32_TOL, msg=lambda s: f"{name}: {s}")
        return
    err = float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))
    assert err <= WIDE_BWD_L2 and bool(torch.isfinite(got).all()), f"{name}: rel l2 {err:.3e}"


def _wide_kw(mode, Lq, Lk, dh, B, g, device):
    """rope (Lq = Lk), a key mask whose batch row 1 is fully masked, causal,
    or nothing."""
    if mode == "rope":
        sin, cos = _tables(Lq, dh, device)
        return dict(sin=sin, cos=cos)
    if mode == "causal":
        return dict(causal=True)
    if mode == "mask":
        m = torch.rand(B, Lk, generator=g, device=device) > 0.3
        m[1] = False
        return dict(kv_mask=m)
    return {}


WIDE_PACKED_CASES = [(256, 2, 393), (256, 4, 200), (384, 1, 130), (384, 2, 65), (512, 1, 65),
                     (512, 2, 1)]


@pytest.mark.parametrize("layout", ["fused", "packed"])
@pytest.mark.parametrize("mode", ["rope", "mask", "causal", "plain"])
@pytest.mark.parametrize("dh,H,L", WIDE_PACKED_CASES)
def test_wide_packed_forward_and_gradients(cuda, dh, H, L, mode, layout):
    """K1 at Dh 256 to 512 on fused qkv (the fused strides) or three
    contiguous packed tensors, at lengths ragged against the tiles and at L 1; one launch
    counted; the wide backward's gradients from the new forward's
    statistics against flash_bwd_plain."""
    g = torch.Generator(device=cuda).manual_seed(dh + L)
    B, D = 2, H * dh
    qkv = _wide_randn((B, L, 3 * D), D, g, cuda)
    do = (torch.randn(B, L, D, generator=g, device=cuda) * 0.5).to(BF)
    kw = _wide_kw(mode, L, L, dh, B, g, cuda)
    leaves = _packed_leaves(qkv, D, layout)
    n = flash_attention_packed.launches
    out = _packed_call(leaves, D, layout, num_heads=H, **kw)
    assert flash_attention_packed.launches == n + 1
    heads = [t.unflatten(2, (H, dh)).transpose(1, 2) for t in qkv.split(D, -1)]
    ref = multi_head_attention(*heads, **kw)
    _fwd_close(out.detach(), ref.transpose(1, 2).flatten(2))
    grads = torch.autograd.grad(out, leaves, do)
    grads = grads[0].split(D, -1) if len(grads) == 1 else grads
    want = flash_bwd_plain(*heads, do.unflatten(2, (H, dh)).transpose(1, 2), ref, **kw)
    for name, a, w in zip(("dq", "dk", "dv"), grads, want):
        _rel_l2(name, a.unflatten(2, (H, dh)).transpose(1, 2), w, one_key=L == 1)


WIDE_HEADS_CASES = [(192, 130, 130, "rope"), (256, 100, 300, "mask"), (256, 300, 100, "causal"),
                    (320, 65, 65, "mask"), (384, 1, 200, "mask"), (448, 200, 70, "plain"),
                    (512, 130, 130, "causal")]


@pytest.mark.parametrize("dh,Lq,Lk,mode", WIDE_HEADS_CASES)
def test_wide_heads_forward_and_gradients(cuda, dh, Lq, Lk, mode):
    """K3 at the widths a head dim is padded to above 128 (192 -> 256, 320
    and 384 -> 384, 448 and 512 -> 512), on transposed views of ``[B, L,
    H*Dh]`` as the text tower hands them, Lq != Lk, Lq 1, a fully masked
    row; one launch counted; K4's gradients from the new statistics."""
    g = torch.Generator(device=cuda).manual_seed(dh + Lq + Lk)
    B, H = 2, 2
    q, do = ((torch.randn(B, Lq, H * dh, generator=g, device=cuda) * s).to(BF)
             .unflatten(2, (H, dh)).transpose(1, 2) for s in (0.5 * WIDE_QK, 0.5))
    k, v = ((torch.randn(B, Lk, H * dh, generator=g, device=cuda) * s).to(BF)
            .unflatten(2, (H, dh)).transpose(1, 2) for s in (0.5 * WIDE_QK, 0.5))
    kw = _wide_kw(mode, Lq, Lk, dh, B, g, cuda)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    n = flash_attention.launches
    out = flash_attention(*leaves, **kw)
    assert flash_attention.launches == n + 1
    ref = multi_head_attention(q, k, v, **kw)
    _fwd_close(out.detach(), ref)
    want = flash_bwd_plain(q, k, v, do, ref, **kw)
    for name, a, w in zip(("dq", "dk", "dv"), torch.autograd.grad(out, leaves, do), want):
        _rel_l2(name, a, w)


WIDE_PROJ_CASES = [(256, 2, 512), (256, 1, 320), (256, 4, 96), (256, 3, 101), (384, 2, 320),
                   (384, 1, 96), (512, 2, 512), (512, 1, 7)]


@pytest.mark.parametrize("mode", ["rope", "mask", "causal"])
@pytest.mark.parametrize("dh,H,dout", WIDE_PROJ_CASES)
def test_wide_fused_projection(cuda, dh, H, dout, mode):
    """K5 at Dh 256 to 512, H*Dh up to 1024, Dout on and off the 128 grid
    (96, 320, an odd 101 and 7): y without a gradient against the plain
    output's product with wo, the same y with the residuals written (one
    launch each, bit-equal), and the gradients of qkv and wo (the wide
    backward from the new statistics, two products) against the plain
    path's."""
    g = torch.Generator(device=cuda).manual_seed(dh + H + dout)
    B, L, D = 2, 130, H * dh
    qkv = _wide_randn((B, L, 3 * D), D, g, cuda)
    wo = (torch.randn(D, dout, generator=g, device=cuda) * D ** -0.5).to(BF)
    gy = (torch.randn(B, L, dout, generator=g, device=cuda) * 0.5).to(BF)
    kw = _wide_kw(mode, L, L, dh, B, g, cuda)
    heads = [t.unflatten(2, (H, dh)).transpose(1, 2) for t in qkv.split(D, -1)]
    ref = multi_head_attention(*heads, **kw).transpose(1, 2).flatten(2)
    n = flash_attention_packed.proj_launches
    with torch.no_grad():
        y = flash_attention_packed(qkv=qkv, num_heads=H, wo=wo, **kw)
    assert y.shape == (B, L, dout)
    _fwd_close(y, ref.float() @ wo.float(), WIDE_PROJ_TOL)
    leaves = [qkv.clone().requires_grad_(), wo.clone().requires_grad_()]
    y2 = flash_attention_packed(qkv=leaves[0], num_heads=H, wo=leaves[1], **kw)
    assert flash_attention_packed.proj_launches == n + 2
    assert torch.equal(y, y2.detach())
    plain = [qkv.clone().requires_grad_(), wo.clone().requires_grad_()]
    pheads = [t.unflatten(2, (H, dh)).transpose(1, 2) for t in plain[0].split(D, -1)]
    yref = project_plain(multi_head_attention(*pheads, **kw).transpose(1, 2).flatten(2),
                         plain[1])
    for name, a, w in zip(("dqkv", "dwo"), torch.autograd.grad(y2, leaves, gy),
                          torch.autograd.grad(yref, plain, gy)):
        _rel_l2(name, a, w)


@pytest.mark.parametrize("which", ["K1 Dh 256", "K1 Dh 512", "K3 Dh 384", "K5 Dh 256 H 2",
                                   "K5 Dh 256 H 4", "K5 Dh 512 H 2"])
def test_wide_batch_invariant_and_reproducible(cuda, which):
    """Every row of a B = 4 call bit-equal to the same row called alone (B
    = 1), and two calls bit-equal: fixed tiles, fixed sums, no atomics."""
    g = torch.Generator(device=cuda).manual_seed(21)
    dh = int(which.split()[2])
    H = int(which.split()[-1]) if which.startswith("K5") else 1024 // dh // 2
    L, D = 393, H * dh
    sin, cos = _tables(L, dh, cuda)
    qkv = (torch.randn(4, L, 3 * D, generator=g, device=cuda) * 0.5).to(BF)
    wo = (torch.randn(D, 512, generator=g, device=cuda) * D ** -0.5).to(BF)
    mask = torch.rand(4, L, generator=g, device=cuda) > 0.3

    def call(rows):
        if which.startswith("K1"):
            return flash_attention_packed(qkv=qkv[rows], num_heads=H, sin=sin, cos=cos)
        if which.startswith("K5"):
            return flash_attention_packed(qkv=qkv[rows], num_heads=H, sin=sin, cos=cos, wo=wo)
        q, k, v = (t.unflatten(2, (H, dh)).transpose(1, 2) for t in qkv[rows].split(D, -1))
        return flash_attention(q, k, v, kv_mask=mask[rows])

    with torch.no_grad():
        full = call(slice(0, 4))
        assert torch.equal(full, call(slice(0, 4)))
        for b in range(4):
            assert torch.equal(full[b:b + 1], call(slice(b, b + 1))), f"row {b}"


def test_wide_kernels_by_name(cuda):
    """The profiler names the wide Hopper kernels for bf16 K1 (Dh 256, 384,
    512), K3 padded (192 -> 256) and K5 (split 1 and 2), and never the
    SIMT kernels they replaced."""
    g = torch.Generator(device=cuda).manual_seed(6)
    qkv = (torch.randn(2, 200, 3 * 768, generator=g, device=cuda) * 0.5).to(BF)
    x = (torch.randn(2, 2, 200, 192, generator=g, device=cuda) * 0.5).to(BF)
    wo = (torch.randn(768, 512, generator=g, device=cuda) * 0.03).to(BF)
    wide = qkv[..., :3 * 512]
    with torch.no_grad():
        for fn, want in (
                (lambda: flash_attention_packed(qkv=wide, num_heads=2),
                 "flash_fwd_wide_sm90_kernel<256>"),
                (lambda: flash_attention_packed(qkv=qkv, num_heads=2),
                 "flash_fwd_wide_sm90_kernel<384>"),
                (lambda: flash_attention_packed(qkv=wide, num_heads=1),
                 "flash_fwd_wide_sm90_kernel<512>"),
                (lambda: flash_attention(x, x, x), "flash_fwd_wide_sm90_kernel<256>"),
                (lambda: flash_attention_packed(qkv=wide, num_heads=2, wo=wo[:512]),
                 "flash_fwd_proj_wide_sm90_kernel<256>"),
                (lambda: flash_attention_packed(qkv=qkv, num_heads=2, wo=wo),
                 "flash_fwd_proj_wide_sm90_kernel<384>")):
            names = _kernels_run(fn)
            assert _ran(names, want), names
            assert not _ran(names, "wide_bf16_kernel"), names


# --------------------------------------------------------------------------- #
# the wide bf16 backward on the tensor cores: K2 at Dh 256 to 512 and K4 at
# the padded widths on flash_bwd_dkv_wide_sm90_kernel<Dh> and
# flash_bwd_dq_wide_sm90_kernel<Dh> (the wide tests above hold their
# gradients at every route of the forward; these add split q/k/v with Lq !=
# Lk, the training step's shapes, reruns and batch rows bit-equal, the fused
# layout's columns and the kernels' names), against flash_bwd_plain by
# WIDE_BWD_L2.

OLD_WIDE_BWD = ("bwd_rows_wide_bf16_kernel", "flash_bwd_dkv_wide_bf16_kernel",
                "flash_bwd_dq_wide_bf16_kernel")


@pytest.mark.parametrize("dh,H", [(256, 2), (384, 1), (512, 1)])
def test_wide_bwd_split_cross_with_masked_rows(cuda, dh, H):
    """Split q ``[3, 130, H*Dh]`` over k, v ``[3, 300, H*Dh]`` (Lq != Lk)
    with a key mask whose batch row 1 is fully masked and row 2 keeps one
    key: one backward launch counted, the gradients against
    flash_bwd_plain."""
    g = torch.Generator(device=cuda).manual_seed(dh + 22)
    B, Lq, Lk, D = 3, 130, 300, H * dh
    q = (torch.randn(B, Lq, D, generator=g, device=cuda) * 0.5 * WIDE_QK).to(BF)
    k = (torch.randn(B, Lk, D, generator=g, device=cuda) * 0.5 * WIDE_QK).to(BF)
    v, do = ((torch.randn(B, L, D, generator=g, device=cuda) * 0.5).to(BF) for L in (Lk, Lq))
    m = torch.rand(B, Lk, generator=g, device=cuda) > 0.3
    m[1] = False
    m[2] = False
    m[2, 250] = True
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = flash_attention_packed(*leaves, num_heads=H, kv_mask=m)
    n = flash_attention_packed.bwd_launches
    grads = torch.autograd.grad(out, leaves, do)
    assert flash_attention_packed.bwd_launches == n + 1
    heads = [t.unflatten(2, (H, dh)).transpose(1, 2) for t in (q, k, v, do)]
    want = flash_bwd_plain(*heads, multi_head_attention(*heads[:3], kv_mask=m), kv_mask=m)
    for name, a, w in zip(("dq", "dk", "dv"), grads, want):
        _rel_l2(name, a.unflatten(2, (H, dh)).transpose(1, 2), w)


@pytest.mark.parametrize("dh,H,L", [(256, 2, 1569), (512, 1, 1569), (256, 2, 393)])
def test_wide_bwd_at_the_training_shapes(cuda, dh, H, L):
    """K2 at the wide-head training step's shapes (four clips of
    ``[L, 1536]``, 3D RoPE): the gradients of the fused qkv against
    flash_bwd_plain."""
    g = torch.Generator(device=cuda).manual_seed(dh + L)
    B, D = 4, H * dh
    hw = {1569: 14, 393: 7}[L]
    t = build_rope3d_tables(dh, 8, hw, hw, n_special=1)
    rope = dict(sin=torch.from_numpy(t.sin).to(cuda), cos=torch.from_numpy(t.cos).to(cuda))
    qkv = _wide_randn((B, L, 3 * D), D, g, cuda)
    do = (torch.randn(B, L, D, generator=g, device=cuda) * 0.5).to(BF)
    leaf = qkv.clone().requires_grad_()
    out = flash_attention_packed(qkv=leaf, num_heads=H, **rope)
    (grad,) = torch.autograd.grad(out, [leaf], do)
    heads = [x.unflatten(2, (H, dh)).transpose(1, 2) for x in qkv.split(D, -1)]
    dh_ = do.unflatten(2, (H, dh)).transpose(1, 2)
    want = flash_bwd_plain(*heads, dh_, multi_head_attention(*heads, **rope), **rope)
    for name, a, w in zip(("dq", "dk", "dv"), grad.split(D, -1), want):
        _rel_l2(name, a.unflatten(2, (H, dh)).transpose(1, 2), w)


@pytest.mark.parametrize("which", ["K2 Dh 256", "K2 Dh 384", "K2 Dh 512", "K4 Dh 384"])
def test_wide_bwd_batch_invariant_and_reproducible(cuda, which):
    """The gradients of a B = 4 call, row by row, bit-equal to the same row
    called alone (B = 1), and two backward launches bit-equal: fixed tiles,
    fixed sums, no atomics (RoPE on K2, a key mask on K4)."""
    g = torch.Generator(device=cuda).manual_seed(43)
    dh = int(which.split()[2])
    H = 1024 // dh // 2 if dh != 384 else 1
    L, D = 393, H * dh
    sin, cos = _tables(L, dh, cuda)
    qkv = (torch.randn(4, L, 3 * D, generator=g, device=cuda) * 0.5).to(BF)
    do = (torch.randn(4, L, D, generator=g, device=cuda) * 0.5).to(BF)
    mask = torch.rand(4, L, generator=g, device=cuda) > 0.3

    def grads(rows, twice=False):
        leaf = qkv[rows].clone().requires_grad_()
        if which.startswith("K2"):
            out = flash_attention_packed(qkv=leaf, num_heads=H, sin=sin, cos=cos)
            dout = do[rows]
        else:
            q, k, v = (t.unflatten(2, (H, dh)).transpose(1, 2) for t in leaf.split(D, -1))
            out = flash_attention(q, k, v, kv_mask=mask[rows])
            dout = do[rows].unflatten(2, (H, dh)).transpose(1, 2)
        first = torch.autograd.grad(out, [leaf], dout, retain_graph=twice)[0]
        if twice:
            assert torch.equal(first, torch.autograd.grad(out, [leaf], dout)[0])
        return first

    full = grads(slice(0, 4), twice=True)
    for b in range(4):
        assert torch.equal(full[b:b + 1], grads(slice(b, b + 1))), f"row {b}"


@pytest.mark.parametrize("dh,H", [(256, 2), (512, 1)])
def test_wide_bwd_fused_writes_only_its_columns(cuda, dh, H):
    """K2's fused layout through ``_flash_cuda.flash_bwd`` at Dh 256 and
    512: dq, dk, dv are column blocks of one gradient buffer inside a wider
    one filled with a sentinel; each kernel writes only its own block
    (bit-equal to the gradients written into three separate tensors) and
    nothing outside them."""
    from deepcoro_clip_tpu_torch.ops._flash_cuda import flash_bwd, flash_fwd

    g = torch.Generator(device=cuda).manual_seed(dh + 7)
    B, L = 2, 393
    D = H * dh
    sin, cos = _tables(L, dh, cuda)
    qkv = _wide_randn((B, L, 3 * D), D, g, cuda)
    q, k, v = (t.unflatten(2, (H, dh)).transpose(1, 2) for t in qkv.split(D, -1))
    do = ((torch.randn(B, L, D, generator=g, device=cuda) * 0.5).to(BF).unflatten(2, (H, dh))
          .transpose(1, 2))
    out = torch.empty(B, L, D, device=cuda, dtype=BF).unflatten(2, (H, dh)).transpose(1, 2)
    stats = torch.empty(2, B, H, L, device=cuda)
    kw = dict(sin=sin, cos=cos, kv_mask=None, causal=False, scale=dh ** -0.5)
    flash_fwd(q, k, v, out, stats=stats, packed=True, **kw)
    wide = torch.full((B, L, 3 * D + 128), 7.25, device=cuda, dtype=BF)
    blocks = [wide[..., 64 + i * D:64 + (i + 1) * D].unflatten(2, (H, dh)).transpose(1, 2)
              for i in range(3)]
    flash_bwd(q, k, v, out, do, stats, *blocks, packed=True, **kw)
    apart = [torch.empty(B, L, D, device=cuda, dtype=BF).unflatten(2, (H, dh)).transpose(1, 2)
             for _ in range(3)]
    flash_bwd(q, k, v, out, do, stats, *apart, packed=True, **kw)
    for name, a, c in zip("qkv", blocks, apart):
        assert torch.equal(a, c), f"d{name}"
    assert bool((wide[..., :64] == 7.25).all()) and bool((wide[..., 64 + 3 * D:] == 7.25).all())


def test_wide_bwd_kernels_by_name(cuda):
    """The profiler names the wide Hopper backward for bf16 K2 at Dh 256,
    384 and 512 and K4 padded (192 -> 256), and never the SIMT kernels it
    replaced."""
    g = torch.Generator(device=cuda).manual_seed(9)
    qkv = (torch.randn(2, 200, 3 * 768, generator=g, device=cuda) * 0.5).to(BF)
    x = (torch.randn(2, 2, 200, 192, generator=g, device=cuda) * 0.5).to(BF)
    for inp, call, want in (
            (qkv, lambda t: flash_attention_packed(qkv=t[..., :3 * 512], num_heads=2),
             "flash_bwd_dkv_wide_sm90_kernel<256>"),
            (qkv, lambda t: flash_attention_packed(qkv=t, num_heads=2),
             "flash_bwd_dkv_wide_sm90_kernel<384>"),
            (qkv, lambda t: flash_attention_packed(qkv=t[..., :3 * 512], num_heads=1),
             "flash_bwd_dkv_wide_sm90_kernel<512>"),
            (x, lambda t: flash_attention(t, t, t), "flash_bwd_dkv_wide_sm90_kernel<256>")):
        leaf = inp.clone().requires_grad_()
        out = call(leaf)
        names = _kernels_run(lambda out=out, leaf=leaf: torch.autograd.grad(
            out, [leaf], torch.ones_like(out), retain_graph=True))
        assert _ran(names, want) and _ran(names, want.replace("dkv", "dq")), names
        assert not any(_ran(names, old) for old in OLD_WIDE_BWD), names
