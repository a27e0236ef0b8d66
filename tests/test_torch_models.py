"""Port model modules against the JAX package, same weights, same inputs.

JAX modules are initialized at small sizes, their parameter trees go
through ``deepcoro_clip_tpu_torch.convert`` into the port's modules
(``load_state_dict(strict=True)``, so every name must map), and both sides
run the same numpy inputs in fp32 on the CPU. Outputs agree to
atol 1e-4 (plus rtol 1e-5 where raw 0..255 pixels make outputs large).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepcoro_clip_tpu.flagship import flagship_config as jax_flagship
from deepcoro_clip_tpu.flagship import tiny_config as jax_tiny
from deepcoro_clip_tpu.models import layers as jl
from deepcoro_clip_tpu.models import video_encoder as jve
from deepcoro_clip_tpu.models.video_aggregator import (
    EnhancedVideoAggregator as JaxAggregator,
)
from deepcoro_clip_tpu.ops.rope3d import build_rope3d_tables

from deepcoro_clip_tpu_torch import convert
from deepcoro_clip_tpu_torch.flagship import flagship_config, tiny_config
from deepcoro_clip_tpu_torch.models import layers as tl
from deepcoro_clip_tpu_torch.models import video_encoder as tve
from deepcoro_clip_tpu_torch.models.video_aggregator import EnhancedVideoAggregator

TOL = dict(atol=1e-4, rtol=1e-5)
MEAN = (110.5, 98.2, 101.0)
STD = (37.8, 41.2, 39.9)


def _load(module, params):
    tree = jax.tree_util.tree_map(np.asarray, fnn.unbox(params))
    module.load_state_dict(convert.jax_tree_to_state_dict(tree), strict=True)
    return module.eval()


def _close(got, ref):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)


# --------------------------------------------------------------------------- #
# PatchEmbed3D on every wire


@pytest.mark.parametrize("case", ["wire_u8_stats", "wire_u8_nostats",
                                  "wire_mono_stats", "spatial_u8_pad_stats",
                                  "spatial_mono_pad_stats", "spatial_float"])
def test_patch_embed_matches_jax(case):
    r = np.random.default_rng(0)
    patch, dim = (2, 8, 8), 32
    stats = {} if "nostats" in case or "float" in case else dict(
        pixel_mean=MEAN, pixel_std=STD)
    grid = (2, 2, 2)
    if case.startswith("wire"):
        c = 1 if "mono" in case else 3
        x = r.integers(0, 256, size=(2, 8, 2 * 8 * 8 * c), dtype=np.uint8)
    elif case == "spatial_float":
        x = r.normal(size=(2, 4, 16, 16, 3)).astype(np.float32)
    else:  # 5 x 13 x 13 does not tile (2, 8, 8): normalize, then pad
        c = 1 if "mono" in case else 3
        x = r.integers(0, 256, size=(2, 5, 13, 13, c), dtype=np.uint8)
    jm = jl.PatchEmbed3D(dim, patch, jnp.float32, patch_grid=grid, **stats)
    init_x = jnp.zeros((1, 4, 16, 16, 3), jnp.float32)
    params = jm.init(jax.random.PRNGKey(1), init_x)["params"]
    ref, thw = jm.apply({"params": params}, jnp.asarray(x))
    tm = _load(tl.PatchEmbed3D(dim, patch, torch.float32, patch_grid=grid, **stats),
               params)
    got, thw_t = tm(torch.from_numpy(x))
    assert tuple(thw_t) == tuple(thw)
    _close(got, ref)


# --------------------------------------------------------------------------- #
# TransformerBlock: plain, masked, and the packed (Dh 128) dispatch


@pytest.mark.parametrize("case", ["rope_dh32", "mask_dh32", "packed_rope_dh128",
                                  "packed_mask_dh128"])
def test_transformer_block_matches_jax(case):
    packed = case.startswith("packed")
    dim, heads = (256, 2) if packed else (64, 2)
    dh = dim // heads
    t = build_rope3d_tables(dh, 2, 3, 3, n_special=1)
    L = t.sin.shape[0]
    r = np.random.default_rng(2)
    x = r.normal(size=(2, L, dim)).astype(np.float32)
    jkw, tkw = {}, {}
    if "rope" in case:
        jkw = dict(sin=jnp.asarray(t.sin), cos=jnp.asarray(t.cos))
        tkw = dict(sin=torch.from_numpy(t.sin), cos=torch.from_numpy(t.cos))
    else:
        m = r.random((2, L)) > 0.3
        m[1] = False  # a row with no valid key: the oracle's uniform mean
        jkw, tkw = dict(kv_mask=jnp.asarray(m)), dict(kv_mask=torch.from_numpy(m))
    jm = jl.TransformerBlock(dim, heads, dtype=jnp.float32, use_flash=True)
    params = jm.init(jax.random.PRNGKey(3), jnp.asarray(x), **jkw)["params"]
    ref = jm.apply({"params": params}, jnp.asarray(x), **jkw)
    tm = _load(tl.TransformerBlock(dim, heads, dtype=torch.float32, use_flash=True),
               params)
    _close(tm(torch.from_numpy(x), **tkw), ref)


# --------------------------------------------------------------------------- #
# aggregator, including an all-masked study


@pytest.mark.parametrize("masked", [True, False])
def test_aggregator_matches_jax(masked):
    r = np.random.default_rng(4)
    x = r.normal(size=(3, 5, 32)).astype(np.float32)
    m = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1], [0, 0, 0, 0, 0]], bool)
    jm = JaxAggregator(dim=32, num_heads=2, depth=2, dtype=jnp.float32)
    jmask = jnp.asarray(m) if masked else None
    params = jm.init(jax.random.PRNGKey(5), jnp.asarray(x), mask=jmask)["params"]
    ref = jm.apply({"params": params}, jnp.asarray(x), mask=jmask)
    tm = _load(EnhancedVideoAggregator(dim=32, num_heads=2, depth=2,
                                       dtype=torch.float32), params)
    got = tm(torch.from_numpy(x), mask=torch.from_numpy(m) if masked else None)
    _close(got, ref)
    assert torch.isfinite(got).all()


# --------------------------------------------------------------------------- #
# VideoEncoder from a config, on the patch-major uint8 wire


ENCODERS = {
    # tiny_config: 2 heads of 32, mean pooling, no CLS
    "tiny": {},
    # the flagship's dispatch at small size: Dh 128 (packed path), CLS,
    # a 2x2 pool at block 1 with RoPE tables rebuilt, dataset stats
    "packed_cls_pool": dict(vit_dim=128, vit_heads=1, vit_pool_stages=[1],
                            use_cls_token=True, use_pallas_attention=True,
                            dataset_mean=list(MEAN), dataset_std=list(STD)),
    "cls_token_pooling": dict(use_cls_token=True, pooling_mode="cls_token"),
}


@pytest.fixture(scope="module", params=sorted(ENCODERS))
def encoders(request):
    kw = dict(multi_video=True, num_videos=3, **ENCODERS[request.param])
    jcfg, tcfg = jax_tiny(**kw), tiny_config(**kw)
    jm = jve.video_encoder_from_config(jcfg)
    r = np.random.default_rng(6)
    L = (4 // 2) * (32 // 16) ** 2
    x = r.integers(0, 256, size=(2, 3, L, 2 * 16 * 16 * 3), dtype=np.uint8)
    mask = np.array([[1, 1, 0], [0, 0, 0]], bool)
    params = jm.init({"params": jax.random.PRNGKey(7),
                      "dropout": jax.random.PRNGKey(7)},
                     jnp.asarray(x), video_mask=jnp.asarray(mask))["params"]
    tm = _load(tve.video_encoder_from_config(tcfg), params)
    return jm, params, tm, x, mask


def test_video_encoder_call_matches_jax(encoders):
    jm, params, tm, x, mask = encoders
    ref = jm.apply({"params": params}, jnp.asarray(x), video_mask=jnp.asarray(mask))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), video_mask=torch.from_numpy(mask))
    assert got.shape == ref.shape
    _close(got, ref)


def test_video_encoder_features_match_jax(encoders):
    jm, params, tm, x, mask = encoders
    ref = jm.apply({"params": params}, jnp.asarray(x), video_mask=jnp.asarray(mask),
                   method=jm.features)
    with torch.no_grad():
        got = tm.features(torch.from_numpy(x), video_mask=torch.from_numpy(mask))
    for key in ("tokens", "video", "study"):
        _close(got[key], ref[key])


@pytest.mark.parametrize("mode", ["patch", "video", "study"])
def test_video_encoder_get_tokens_match_jax(encoders, mode):
    jm, params, tm, x, _ = encoders
    ref = jm.apply({"params": params}, jnp.asarray(x), mode=mode,
                   method=jm.get_tokens)
    with torch.no_grad():
        got = tm.get_tokens(torch.from_numpy(x), mode=mode)
    _close(got, ref)


def test_video_encoder_attention_pooling_matches_jax():
    """The wait is over: ``pooling_mode="attention"`` builds the AttentionPool
    (the cross-attention path of ``Attention``) and the study embedding
    matches the JAX encoder's from the same weights."""
    jm = jve.video_encoder_from_config(jax_tiny(pooling_mode="attention"))
    tm = tve.video_encoder_from_config(tiny_config(pooling_mode="attention"))
    r = np.random.default_rng(9)
    x = r.normal(size=(2, 2, 4, 32, 32, 3)).astype(np.float32)
    mask = np.array([[1, 1], [1, 0]], bool)
    params = jm.init(jax.random.PRNGKey(8), jnp.asarray(x),
                     video_mask=jnp.asarray(mask))["params"]
    assert set(params["pool"]) == {"query", "attn", "norm"}
    tm = _load(tm, params)
    ref = jm.apply({"params": params}, jnp.asarray(x), video_mask=jnp.asarray(mask))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), video_mask=torch.from_numpy(mask))
    _close(got, ref)


# --------------------------------------------------------------------------- #
# configs and random init


@pytest.mark.parametrize("which", ["flagship", "tiny", "flagship_preset_override"])
def test_configs_and_architecture_match_jax(which):
    if which == "flagship":
        kw = dict(multi_video=True, num_videos=10)
        j, t = jax_flagship(**kw), flagship_config(**kw)
    elif which == "tiny":
        j, t = jax_tiny(), tiny_config()
    else:
        kw = dict(model_name="x3d_s", vit_heads=8)
        j, t = jax_flagship(**kw), flagship_config(**kw)
    for key, val in t.to_dict().items():
        assert j.get(key) == val, key
    assert tve.resolve_architecture(t) == jve.resolve_architecture(j)
    assert tve._config_patch_grid(t, (2, 16, 16)) == jve._config_patch_grid(j, (2, 16, 16))


def test_init_params_is_seeded_and_fills_every_tensor():
    cfg = tiny_config(use_cls_token=True, vit_pool_stages=[1])
    a = tve.init_params(tve.video_encoder_from_config(cfg), seed=3).state_dict()
    b = tve.init_params(tve.video_encoder_from_config(cfg), seed=3).state_dict()
    c = tve.init_params(tve.video_encoder_from_config(cfg), seed=4).state_dict()
    assert a.keys() == b.keys()
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
        if "norm" not in k and k.endswith(("kernel", "weight", "cls", "query",
                                               "pos_embedding")):
            assert a[k].std() > 0, k  # nothing left at its zero placeholder
    assert not torch.equal(a["backbone.cls"], c["backbone.cls"])


def test_params_npz_round_trip(tmp_path):
    tree = {"backbone": {"norm": {"scale": np.ones(3, np.float32)},
                         "block0": {"attn": {"qkv": {"kernel": np.eye(3, 9, dtype=np.float32)}}}}}
    path = tmp_path / "p.npz"
    convert.save_params_npz(tree, path)
    back = convert.load_params_npz(path)
    np.testing.assert_array_equal(back["backbone"]["block0"]["attn"]["qkv"]["kernel"],
                                  tree["backbone"]["block0"]["attn"]["qkv"]["kernel"])
    sd = convert.jax_tree_to_state_dict(back)
    assert sd["backbone.block0.attn.qkv.weight"].shape == (9, 3)
    assert sd["backbone.norm.weight"].tolist() == [1.0, 1.0, 1.0]
