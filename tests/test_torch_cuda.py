"""The port's CUDA kernels against their plain PyTorch version, on the card.

Every test here needs an NVIDIA card (a CUDA kernel has no CPU mode) and
skips without one. The file imports no JAX, so on a machine that has the
card but no JAX it runs without the suite's conftest (which imports JAX):

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerance, kernel vs plain in bf16: atol 1e-2, rtol 1e-2 (outputs are
rounded to bf16, 2^-8 relative, and P is rounded to bf16 against the
running max in the kernel but the final max in the plain version).
"""

import pytest
import torch

from deepcoro_clip_tpu_torch.ops.attention import multi_head_attention
from deepcoro_clip_tpu_torch.ops.flash_attention import flash_attention
from deepcoro_clip_tpu_torch.ops.flash_attention_packed import flash_attention_packed
from deepcoro_clip_tpu_torch.ops.rope3d import build_rope3d_tables

pytestmark = pytest.mark.cuda
TOL = dict(atol=1e-2, rtol=1e-2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
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


def test_results_do_not_depend_on_batch_size(cuda):
    """Fixed tiles: a study's output is bit-identical alone or in a batch."""
    g = torch.Generator(device=cuda).manual_seed(2)
    sin, cos = _rope(128, cuda)
    qkv = torch.randn(5, 199, 3 * 512, generator=g, device=cuda).to(torch.bfloat16)
    full = flash_attention_packed(qkv=qkv, num_heads=4, sin=sin, cos=cos)
    one = flash_attention_packed(qkv=qkv[3:4], num_heads=4, sin=sin, cos=cos)
    assert torch.equal(full[3:4], one)


def test_kernels_reject_what_they_do_not_take(cuda):
    q = torch.zeros(1, 2, 16, 64, device=cuda)
    with pytest.raises(TypeError, match="bfloat16"):
        flash_attention(q, q, q)
    q = torch.zeros(1, 2, 16, 96, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="Dh in"):
        flash_attention(q, q, q)
