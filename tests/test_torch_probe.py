"""The port's linear-probing slice against the JAX package, same weights, same inputs.

JAX modules and bundles are initialized at small sizes on one CPU device,
their parameter trees go through ``deepcoro_clip_tpu_torch.convert`` into the
port's modules (``load_state_dict(strict=True)``: every name must map), and
both sides run the same numpy inputs in fp32 on the CPU with dropout 0 (the
two frameworks draw different masks from the same seed).

Tolerances. Module outputs: atol 1e-4, rtol 1e-5 (fp32 sums in another
order). Losses: rtol 1e-5. Train steps: loss, every metric rtol 1e-4;
parameters after the steps atol 3e-5 at rates up to 1.5e-3 (1% of what Adam
can move a parameter in three steps). Two leaves whose whole gradient is
rounding noise around zero are left out, since Adam turns such noise into a
step of the full rate: the key bias of a fused ``attn/qkv/bias`` (as in
``test_torch_train.py``) and the bias of the gated pool's score layer
``*_gated/w/bias`` (a softmax does not see a constant added to every score).
"""

import dataclasses
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from deepcoro_clip_tpu.configs.linear_probing import LinearProbingConfig as JaxProbeConfig
from deepcoro_clip_tpu.configs.linear_probing import MultiviewConfig as JaxMultiviewConfig
from deepcoro_clip_tpu.configs.parser import parse_config as jax_parse_config
from deepcoro_clip_tpu.losses import heads as jheads
from deepcoro_clip_tpu.models import attention_pool as jpool
from deepcoro_clip_tpu.models import layers as jl
from deepcoro_clip_tpu.models import mil as jmil
from deepcoro_clip_tpu.models import video_encoder as jve
from deepcoro_clip_tpu.parallel import MeshSpec, make_mesh
from deepcoro_clip_tpu.registry import LossRegistry, register_all
from deepcoro_clip_tpu.train import linear_probe as jprobe

from deepcoro_clip_tpu_torch import configs as tconfigs
from deepcoro_clip_tpu_torch import convert
from deepcoro_clip_tpu_torch.flagship import tiny_config
from deepcoro_clip_tpu_torch.losses import heads as theads
from deepcoro_clip_tpu_torch.models import attention_pool as tpool
from deepcoro_clip_tpu_torch.models import layers as tl
from deepcoro_clip_tpu_torch.models import mil as tmil
from deepcoro_clip_tpu_torch.models import video_encoder as tve
from deepcoro_clip_tpu_torch.ops.flash_attention import flash_attention
from deepcoro_clip_tpu_torch.ops.flash_attention_packed import flash_attention_packed
from deepcoro_clip_tpu_torch.train import clip as tclip
from deepcoro_clip_tpu_torch.train import linear_probe as tprobe
from deepcoro_clip_tpu_torch.train import optim as toptim

register_all()

REPO = Path(__file__).resolve().parents[1]
TOL = dict(atol=1e-4, rtol=1e-5)
SCALAR_TOL = dict(rtol=1e-4, atol=1e-6)
PARAM_ATOL = 3e-5
STEPS_PER_EPOCH = 4


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, fnn.unbox(params))


def _load(module, params):
    module.load_state_dict(convert.jax_tree_to_state_dict(_np_tree(params)), strict=True)
    return module.eval()


def _close(got, ref, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **(tol or TOL))


# --------------------------------------------------------------------------- #
# Attention: the cross-attention path and the fused output projection


@pytest.mark.parametrize("heads,use_flash", [(2, True), (4, True), (4, False)])
def test_cross_attention_matches_jax(heads, use_flash):
    """The ``context`` path (q/k/v Dense): packed at Dh 128, [B,H,L,Dh] at
    Dh 64, plain without use_flash; Lq != Lk with a key mask."""
    r = np.random.default_rng(0)
    dim = 256
    x = r.normal(size=(2, 3, dim)).astype(np.float32)
    ctx = r.normal(size=(2, 11, dim)).astype(np.float32)
    mask = r.random((2, 11)) > 0.3
    jm = jl.Attention(dim, heads, dtype=jnp.float32, use_flash=use_flash)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), context=jnp.asarray(ctx))["params"]
    assert set(params) == {"q", "k", "v", "proj"}
    ref = jm.apply({"params": params}, jnp.asarray(x), context=jnp.asarray(ctx),
                   kv_mask=jnp.asarray(mask))
    tm = _load(tl.Attention(dim, heads, dtype=torch.float32, use_flash=use_flash,
                            cross=True), params)
    _close(tm(torch.from_numpy(x), context=torch.from_numpy(ctx),
              kv_mask=torch.from_numpy(mask)), ref)
    with pytest.raises(ValueError, match="context"):
        tm(torch.from_numpy(x))


@pytest.mark.parametrize("mode", ["plain", "mask", "causal"])
def test_attention_fused_outproj_matches_jax(monkeypatch, mode):
    """The layer with the projection inside the attention call, against the
    JAX layer under DEEPCORO_FUSED_OUTPROJ=1 (dim 256, 2 heads of 128): same
    parameter names as the dense path, same output and parameter gradients
    (atol 1e-4), the env switch read at construction, and the unfused path
    untouched by it."""
    monkeypatch.setenv("DEEPCORO_FUSED_OUTPROJ", "1")
    r = np.random.default_rng(1)
    dim, heads, L = 256, 2, 9
    x = r.normal(size=(2, L, dim)).astype(np.float32)
    kw, jkw = {}, {}
    if mode == "mask":
        m = r.random((2, L)) > 0.3
        kw, jkw = dict(kv_mask=torch.from_numpy(m)), dict(kv_mask=jnp.asarray(m))
    elif mode == "causal":
        kw = jkw = dict(causal=True)
    jm = jl.Attention(dim, heads, dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = jax.tree_util.tree_map(  # a bias that is not zero
        lambda a: a + 0.01 * jnp.arange(a.size, dtype=a.dtype).reshape(a.shape) / a.size, params)
    ref = jm.apply({"params": params}, jnp.asarray(x), **jkw)
    jgrads = jax.grad(lambda p: jnp.sum(
        jm.apply({"params": p}, jnp.asarray(x), **jkw) ** 2))(params)

    tm = _load(tl.Attention(dim, heads, dtype=torch.float32), params)
    assert tm.fused_outproj  # read from the environment at construction
    n = flash_attention_packed.proj_launches
    out = tm(torch.from_numpy(x), **kw)
    _close(out, ref)
    assert flash_attention_packed.proj_launches == n  # CPU tensors reach no kernel
    (out ** 2).sum().backward()
    want = convert.jax_tree_to_state_dict(_np_tree(jgrads))  # gradients, torch names
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=1e-4,
                                   rtol=1e-4, err_msg=name)

    off = tl.Attention(dim, heads, dtype=torch.float32, fused_outproj=False)
    assert off.state_dict().keys() == tm.state_dict().keys()
    off.load_state_dict(tm.state_dict())
    _close(off(torch.from_numpy(x), **kw), ref)
    monkeypatch.setenv("DEEPCORO_FUSED_OUTPROJ", "0")
    assert not tl.Attention(dim, heads).fused_outproj


# --------------------------------------------------------------------------- #
# AttentionPool, AttentionPoolWithCLS, and the encoder's "attention" pooling


@pytest.mark.parametrize("cls_variant", [False, True])
@pytest.mark.parametrize("output_dim", [None, 24])
def test_attention_pool_matches_jax(cls_variant, output_dim):
    r = np.random.default_rng(2)
    x = r.normal(size=(3, 7, 64)).astype(np.float32)
    mask = r.random((3, 7)) > 0.3
    mask[:, 0] = True
    kw = dict(dim=64, num_heads=2, dtype=jnp.float32, output_dim=output_dim)
    jm = (jpool.AttentionPoolWithCLS if cls_variant else jpool.AttentionPool)(**kw)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    ref = jm.apply({"params": params}, jnp.asarray(x), mask=jnp.asarray(mask))
    kw["dtype"] = torch.float32
    tm = _load((tpool.AttentionPoolWithCLS if cls_variant else tpool.AttentionPool)(**kw),
               params)
    got = tm(torch.from_numpy(x), mask=torch.from_numpy(mask))
    assert got.shape == (3, output_dim or 64)
    _close(got, ref)


@pytest.mark.parametrize("pooling_mode", ["attention", "attention+cls_token", "cls_token"])
def test_video_encoder_pooling_modes_match_jax(pooling_mode):
    """``attention`` builds and runs the AttentionPool; a hybrid mode falls
    through to the token mean in the encoder (only the probing head reads
    it), as in the JAX encoder."""
    r = np.random.default_rng(3)
    x = r.normal(size=(2, 2, 4, 32, 32, 3)).astype(np.float32)
    kw = dict(embedding_dim=32, backbone_dim=64, depth=1, backbone_heads=2,
              num_heads=2, aggregator_depth=1, dropout=0.0,
              aggregate_videos_tokens=False, per_video_pool=True,
              pooling_mode=pooling_mode, use_cls_token=True)
    jm = jve.VideoEncoder(dtype=jnp.float32, use_flash=False, **kw)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    assert ("pool" in params) == (pooling_mode == "attention")
    ref = jm.apply({"params": params}, jnp.asarray(x))
    # strict: like the JAX tree, the port's encoder has no aggregator here
    tm = _load(tve.VideoEncoder(dtype=torch.float32, use_flash=False, **kw), params)
    got = tm(torch.from_numpy(x))
    assert got.shape == (2, 2, 32)
    _close(got, ref)


# --------------------------------------------------------------------------- #
# MultiInstanceLinearProbing

HEADS = {"stenosis": 1, "stenosis_binary": 1, "grade": 3}


def _mil_pair(x, mask, view_ids, **kw):
    jm = jmil.MultiInstanceLinearProbing(embedding_dim=32, head_structure=HEADS,
                                         attention_hidden=8, num_heads=2,
                                         dtype=jnp.float32, **kw)
    jargs = dict(mask=None if mask is None else jnp.asarray(mask),
                 view_ids=None if view_ids is None else jnp.asarray(view_ids))
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), **jargs)["params"]
    ref, sown = jm.apply({"params": params}, jnp.asarray(x), mutable=["intermediates"],
                         **jargs)
    tm = _load(tmil.MultiInstanceLinearProbing(
        embedding_dim=32, head_structure=HEADS, attention_hidden=8, num_heads=2,
        dtype=torch.float32, **kw), params)
    got, inter = tm(torch.from_numpy(x),
                    mask=None if mask is None else torch.from_numpy(mask),
                    view_ids=None if view_ids is None else torch.from_numpy(view_ids),
                    return_intermediates=True)
    return ref, sown["intermediates"], got, inter, params


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("pooling_mode", tmil.POOLING_MODES)
def test_mil_pooling_modes_match_jax(pooling_mode, use_flash):
    """[B, N, D] input with a mask (one study fully masked): every head's
    output, the pooled study embedding and the gated attention weights."""
    r = np.random.default_rng(4)
    x = r.normal(size=(3, 5, 32)).astype(np.float32)
    mask = r.random((3, 5)) > 0.3
    mask[0], mask[2] = True, False
    ref, sown, got, inter, params = _mil_pair(
        x, mask, None, pooling_mode=pooling_mode, use_flash=use_flash)
    assert set(got) == set(HEADS)
    for head, n in HEADS.items():
        assert got[head].shape == (3, n) and got[head].dtype == torch.float32
        _close(got[head], ref[head])
    _close(inter["pooled"], sown["pooled"][0])
    assert ("across_attention" in inter) == ("attention" in pooling_mode)
    if "attention" in pooling_mode:
        _close(inter["across_attention"], sown["across_attention"][0])
        _close(inter["across_attention"][2], np.full(5, 0.2))  # no valid video: uniform
    # the within pools are not built without hierarchical input
    assert not any(k.startswith("within") for k in params)


@pytest.mark.parametrize("separate", [True, False])
@pytest.mark.parametrize("pooling_mode", ["attention+cls_token", "mean", "cls_token"])
def test_mil_hierarchical_matches_jax(pooling_mode, separate):
    """[B, N, L, D] tokens: within-video pooling, ``hier_proj`` for the
    hybrid, separate or shared pools, view embeddings with the PAD id (and
    ids past it, which are clipped to it)."""
    r = np.random.default_rng(5)
    x = r.normal(size=(2, 3, 4, 32)).astype(np.float32)
    mask = np.array([[True, True, False], [True, False, False]])
    view_ids = np.array([[0, 2, 4], [1, 4, 9]], np.int32)  # 4 = PAD of 4 classes
    ref, sown, got, inter, params = _mil_pair(
        x, mask, view_ids, pooling_mode=pooling_mode, hierarchical=True,
        separate_video_attention=separate, use_view_embeddings=True,
        num_view_classes=4, normalization_strategy="post_norm")
    for head in HEADS:
        _close(got[head], ref[head])
    _close(inter["pooled"], sown["pooled"][0])
    assert ("hier_proj" in params) == ("+" in pooling_mode)
    prefixes = {k.split("_")[0] for k in params if "_gated" in k or "_cls" in k}
    if pooling_mode != "mean":
        assert prefixes == ({"within", "across"} if separate else {"shared"})
    if "attention" in pooling_mode:
        _close(inter["within_attention"], sown["within_attention"][0])


def test_mil_rejects_what_it_cannot_pool():
    with pytest.raises(ValueError, match="pooling_mode"):
        tmil.MultiInstanceLinearProbing(pooling_mode="median")
    m = tmil.MultiInstanceLinearProbing(embedding_dim=8, head_structure={"a": 1},
                                        pooling_mode="mean")
    with pytest.raises(ValueError, match="hierarchical"):
        m(torch.zeros(1, 2, 3, 8))


# --------------------------------------------------------------------------- #
# losses

LOSS_NAMES = sorted(theads.LOSSES)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", LOSS_NAMES)
def test_head_losses_match_jax(name, masked):
    """Each loss (aliases included) against the JAX registry's, value and
    gradient with respect to the prediction (rtol 1e-5)."""
    r = np.random.default_rng(6)
    multiclass = name in ("ce", "cross_entropy", "multiclass_focal")
    pred = (r.normal(size=(6, 4) if multiclass else (6,)) * 2).astype(np.float32)
    if multiclass:
        target = r.integers(0, 4, size=(6,)).astype(np.int32)
    elif name in ("mse", "mae", "rmse", "huber"):
        target = r.normal(size=(6,)).astype(np.float32)
    else:
        target = (r.random(6) > 0.5).astype(np.float32)
    mask = np.array([1, 1, 0, 1, 0, 1], bool) if masked else None
    jfn = LossRegistry.get(name)
    jmask = None if mask is None else jnp.asarray(mask)
    ref, jgrad = jax.value_and_grad(
        lambda p: jfn(p, jnp.asarray(target), sample_mask=jmask))(jnp.asarray(pred))
    tp = torch.from_numpy(pred).requires_grad_()
    got = theads.LOSSES[name](tp, torch.from_numpy(target),
                              sample_mask=None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got.detach()), float(ref), rtol=1e-5, atol=1e-7)
    got.backward()
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jgrad), rtol=1e-4, atol=1e-7)


def test_loss_names_cover_the_jax_registry():
    assert set(theads.LOSSES) >= {
        "mse", "mae", "rmse", "huber", "bce_logit", "bce_with_logits", "bce", "ce",
        "cross_entropy", "binary_focal", "multiclass_focal"}
    for name in theads.LOSSES:
        assert LossRegistry.get(name) is not None


@pytest.mark.parametrize("masked", [False, True])
def test_multi_head_loss_matches_jax(masked):
    """[B, 1] predictions against [B] targets are squeezed (no [B, B]
    broadcast), weights default to 1, ``main`` is the weighted sum."""
    r = np.random.default_rng(7)
    outputs = {"a": r.normal(size=(5, 1)).astype(np.float32),
               "b": r.normal(size=(5, 1)).astype(np.float32),
               "c": r.normal(size=(5, 3)).astype(np.float32)}
    targets = {"a": r.normal(size=(5,)).astype(np.float32),
               "b": (r.random(5) > 0.5).astype(np.float32),
               "c": r.integers(0, 3, size=(5,)).astype(np.int32)}
    structure = {"a": "huber", "b": "bce_logit", "c": "ce"}
    weights = {"a": 2.0, "c": 0.5}
    mask = np.array([1, 0, 1, 1, 0], bool) if masked else None
    ref = jheads.multi_head_loss(
        {k: jnp.asarray(v) for k, v in outputs.items()},
        {k: jnp.asarray(v) for k, v in targets.items()}, structure, weights,
        sample_mask=None if mask is None else jnp.asarray(mask))
    got = theads.multi_head_loss(
        {k: torch.from_numpy(v) for k, v in outputs.items()},
        {k: torch.from_numpy(v) for k, v in targets.items()}, structure, weights,
        sample_mask=None if mask is None else torch.from_numpy(mask))
    assert set(got) == set(ref) == {"a", "b", "c", "main"}
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-5, err_msg=k)
    with pytest.raises(KeyError, match="unknown loss"):
        theads.multi_head_loss(outputs, targets, {"a": "hinge"})


# --------------------------------------------------------------------------- #
# configs and the YAML reader

PROBING_YAMLS = sorted((REPO / "config" / "linear_probing").glob("*.yaml"))
TINY = ["--frames", "4", "--resize", "32", "--batch_size", "2", "--vit_dim", "32",
        "--vit_depth", "1", "--vit_heads", "1", "--embedding_dim", "16",
        "--num_heads", "2", "--aggregator_depth", "1", "--precision", "fp32",
        "--use_pallas_attention", "false", "--num_videos", "2", "--epochs", "1",
        "--vit_pool_stages", "[]"]
PROBE_TINY = TINY + ["--attention_hidden", "8"]


def _fields(cls):
    return {f.name: (f.default if f.default is not dataclasses.MISSING
                     else f.default_factory()) for f in dataclasses.fields(cls)}


@pytest.mark.parametrize("cls,jcls", [(tconfigs.LinearProbingConfig, JaxProbeConfig),
                                      (tconfigs.MultiviewConfig, JaxMultiviewConfig)],
                         ids=["linear_probing", "multiview"])
def test_probe_config_field_parity(cls, jcls):
    port = _fields(cls)
    assert {k: port.pop(k) for k in tconfigs.PORT_FIELDS} == {"device": None}
    assert port == _fields(jcls)


def test_multiview_config_maps_the_legacy_fields():
    c = tconfigs.MultiviewConfig.from_dict(
        {"pipeline_project": "DeepCORO_Multiview", "video_encoder_lr": "0.01", "zz": 1})
    j = JaxMultiviewConfig.from_dict(
        {"pipeline_project": "DeepCORO_Multiview", "video_encoder_lr": "0.01", "zz": 1})
    assert (c.lr, c.pipeline_project, c.extra()) == (j.lr, j.pipeline_project, j.extra())
    assert c.lr == 0.01 and c.pipeline_project == "DeepCORO_video_linear_probing"


@pytest.mark.parametrize("path", PROBING_YAMLS + [REPO / "config" / "clip" / "base_config.yaml"],
                         ids=lambda p: p.stem)
def test_parse_config_matches_jax_parser(path):
    """The port's YAML/CLI reader against configs/parser.py on every shipped
    probing YAML (and the contrastive base config): the same values field by
    field, with list, bool, int and dict overrides."""
    over = TINY + ["--lr", "0.002"]
    if "linear_probing" in str(path):
        over += ["--attention_hidden", "8", "--head_weights", "{stenosis: 2.0}"]
    got = tconfigs.parse_config(["--base_config", str(path)] + over)
    ref = jax_parse_config(["--base_config", str(path)] + over)
    ref_d = ref.to_dict()
    for key, val in got.to_dict().items():
        if key in tconfigs.PORT_FIELDS:  # the port's own, None unless asked
            assert val is None, key
            continue
        assert key in ref_d, key
        if key not in ("is_ref_device", "process_index", "process_count", "world_size"):
            assert val == ref_d[key], key
    assert got.vit_pool_stages == [] and got.use_pallas_attention is False
    assert got.lr == 0.002 and got.frames == 4


def test_parse_config_rejects_a_pipeline_that_is_not_ported(tmp_path):
    # every pipeline of the JAX package has its config class in the port
    # since the multitask slice: a name outside them stands for one that is not
    p = tmp_path / "c.yaml"
    p.write_text("pipeline_project: DeepCORO_segmentation\n")
    with pytest.raises(NotImplementedError, match="not ported"):
        tconfigs.parse_config(["--base_config", str(p)])


def test_chip_smoke_probe_config_is_the_shipped_yaml():
    """chip_smoke.py spells the stenosis configuration out as a dict (the
    card machine need not have PyYAML): it must equal the YAML as the port's
    parser reads it."""
    import chip_smoke

    want = tconfigs.parse_config(
        ["--base_config", str(REPO / "config" / "linear_probing" / "stenosis_config.yaml")])
    assert chip_smoke.probe_config().to_dict() == want.to_dict()
    raw = yaml.safe_load((REPO / "config" / "linear_probing" / "stenosis_config.yaml").read_text())
    assert raw["video_freeze_ratio"] == 1.0 and raw["num_videos"] == 10


@pytest.mark.parametrize("path", PROBING_YAMLS, ids=lambda p: p.stem)
def test_shipped_probing_yaml_builds_and_steps(path):
    """Every shipped probing family assembles at tiny size from the port's
    parser and takes one train step on the CPU, as the JAX package's
    test_shipped_configs does for its own."""
    cfg = tconfigs.parse_config(["--base_config", str(path)] + PROBE_TINY)
    bundle, state = tprobe.build_probe_bundle(cfg, device="cpu")
    assert set(bundle.head_names) == set(cfg.head_structure)
    r = np.random.default_rng(0)
    B, N = 2, cfg.num_videos
    batch = {"videos": r.normal(size=(B, N, cfg.frames, cfg.resize, cfg.resize, 3)
                                ).astype(np.float32),
             "video_mask": np.ones((B, N), bool),
             "targets": {h: r.normal(size=(B,)).astype(np.float32)
                         for h in cfg.head_structure}}
    if cfg.use_view_embeddings:
        batch["view_ids"] = np.zeros((B, N), np.int32)
    step = tprobe.make_probe_train_step(bundle)
    state, metrics = step(state, tprobe.to_device_batch(bundle, batch),
                          torch.Generator().manual_seed(0), cfg.video_freeze_ratio)
    assert np.isfinite(float(metrics["loss"])) and state.step == 1
    assert set(metrics) == {"loss", "lr", "grad_norm"} | {
        f"loss_{h}" for h in cfg.head_structure}


def test_probe_entry_points_need_cuda_unless_cpu_is_asked():
    cfg = tconfigs.parse_config(["--base_config", str(PROBING_YAMLS[0])] + PROBE_TINY)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tprobe.build_probe_bundle(cfg)


# --------------------------------------------------------------------------- #
# the optimizer's groups, the train and eval steps

PROBE = dict(
    frames=4, resize=32, batch_size=2, num_videos=3, vit_dim=64, vit_depth=2,
    vit_heads=2, vit_patch=[2, 16, 16], embedding_dim=32, num_heads=2,
    attention_hidden=8, dropout=0.0, dropout_attention=0.0, precision="fp32",
    use_pallas_attention=True, epochs=2, scheduler_name="cosine_with_warmup",
    pooling_mode="attention+cls_token", use_cls_token=True,
    normalization_strategy="pre_norm", attention_lr=0.0015,
    attention_weight_decay=0.00005, lr=0.001, weight_decay=0.00001,
    head_structure={"stenosis": 1, "stenosis_binary": 1, "calcif_binary": 1, "CTO": 1},
    loss_structure={"stenosis": "huber", "stenosis_binary": "bce_logit",
                    "calcif_binary": "bce_logit", "CTO": "bce_logit"},
    head_lr={"stenosis": 0.0003, "stenosis_binary": 0.0003, "calcif_binary": 0.0003,
             "CTO": 0.0003},
    head_weight_decay={"stenosis": 0.00001, "stenosis_binary": 0.00001,
                       "calcif_binary": 0.00001, "CTO": 0.00001},
    head_weights={"stenosis": 2.0},
)
# backbone at 2 heads of 128: the packed dispatch, where the fused projection runs
WIDE = dict(vit_dim=256, vit_heads=2)


def _probe_batch(cfg, seed=0):
    r = np.random.default_rng(seed)
    B, N = cfg.batch_size, cfg.num_videos
    mask = np.ones((B, N), bool)
    mask[1, 1:] = False
    batch = {"videos": r.normal(size=(B, N, cfg.frames, cfg.resize, cfg.resize, 3)
                                ).astype(np.float32),
             "video_mask": mask,
             "targets": {"stenosis": r.random(B).astype(np.float32),
                         **{h: (r.random(B) > 0.5).astype(np.float32)
                            for h in ("stenosis_binary", "calcif_binary", "CTO")}}}
    if cfg.use_view_embeddings:
        batch["view_ids"] = r.integers(0, cfg.num_view_classes + 1, size=(B, N)).astype(np.int32)
    return batch


class ProbePair:
    """The two packages' probing bundles on the same initial weights."""

    def __init__(self, fused=False, **over):
        kw = dict(PROBE, **over)
        self.jcfg = JaxProbeConfig.from_dict(kw)
        self.tcfg = tconfigs.LinearProbingConfig.from_dict(kw)
        self.fused = fused
        self.mesh = make_mesh(MeshSpec(data=1, model=1), devices=jax.devices()[:1])
        self.jbundle, jstate = self.jax_side()
        self.init_tree = jax.tree_util.tree_map(np.asarray, jstate.params)
        self.batch = _probe_batch(self.jcfg)

    def jax_side(self):
        return jprobe.build_probe_bundle(self.jcfg, self.mesh, jax.random.PRNGKey(0),
                                         steps_per_epoch=STEPS_PER_EPOCH)

    def torch_side(self):
        bundle, state = tprobe.build_probe_bundle(
            self.tcfg, seed=0, steps_per_epoch=STEPS_PER_EPOCH, device="cpu",
            fused_outproj=self.fused)
        convert.load_probe_tree(self.init_tree, bundle.video_model, bundle.mil_model)
        return bundle, state

    def run(self, n, ratio):
        _, jstate = self.jax_side()
        jstep = jprobe.make_probe_train_step(self.jbundle)
        jb = self.jbundle.batch_sharding_fn(self.batch)
        bundle, tstate = self.torch_side()
        tstep = tprobe.make_probe_train_step(bundle)
        tb = tprobe.to_device_batch(bundle, self.batch)
        jm, tm = [], []
        for i in range(n):
            jstate, m = jstep(jstate, jb, jax.random.PRNGKey(i), ratio)
            jm.append({k: float(v) for k, v in m.items()})
            tstate, m = tstep(tstate, tb, None, ratio)
            tm.append({k: float(v) for k, v in m.items()})
        jtree = jax.tree_util.tree_map(np.asarray, jstate.params)
        return jm, tm, jtree, convert.probe_tree(bundle.video_model, bundle.mil_model), tstate


NOISE_LEAF = "_gated/w/bias"  # its gradient is rounding noise (see the module note)


def _assert_trees_close(ttree, jtree, atol=PARAM_ATOL):
    jf, tf = convert.flatten_tree(jtree), convert.flatten_tree(ttree)
    assert jf.keys() == tf.keys()
    for k in jf:
        a, b = tf[k], jf[k]
        if k.endswith(NOISE_LEAF):
            continue
        if k.endswith("attn/qkv/bias"):  # drop the key bias: pure noise
            n = a.shape[0] // 3
            a, b = np.delete(a, slice(n, 2 * n)), np.delete(b, slice(n, 2 * n))
        np.testing.assert_allclose(a, b, atol=atol, rtol=0, err_msg=k)


@pytest.fixture(scope="module")
def pair():
    return ProbePair()


def test_probe_tree_round_trips(pair):
    """JAX tree -> port -> JAX tree is the identity, name for name."""
    bundle, _ = pair.torch_side()
    back = convert.probe_tree(bundle.video_model, bundle.mil_model)
    jf, tf = convert.flatten_tree(pair.init_tree), convert.flatten_tree(back)
    assert jf.keys() == tf.keys()
    for k in jf:
        np.testing.assert_array_equal(tf[k], jf[k], err_msg=k)


def test_probe_optimizer_labels_match_jax(pair):
    """Every parameter's group against the JAX package's label rule applied
    with ``tree_map_with_path``: the head test is a substring test, so
    ``head_stenosis_binary`` lands in ``head_stenosis``."""
    cfg = pair.jcfg

    def label(path, _):  # train/linear_probe.make_probe_optimizer's rule
        parts = [str(getattr(k, "key", k)) for k in path]
        if parts[0] == "video_encoder":
            return "encoder"
        joined = "/".join(parts)
        for head in cfg.head_structure:
            if f"head_{head}" in joined:
                return f"head_{head}"
        if "view_embeddings" in joined:
            return "view_embedding"
        if "within" in joined:
            return "attention_within"
        if "across" in joined or "shared" in joined:
            return "attention_across"
        return "mil_other"

    want = convert.flatten_tree(jax.tree_util.tree_map_with_path(label, pair.init_tree))
    bundle, state = pair.torch_side()
    got = {name: toptim.probe_group_label(name, cfg.head_structure)
           for name in state.params}
    assert got == {n: lab for lab, names in bundle.tx.groups.items() for n in names}
    # a torch name is the flax path with '.' for '/' up to the leaf's name
    # (weight for kernel, scale or embedding)
    assert len(got) == len(want)
    for name, lab in got.items():
        stem = name.replace(".", "/").rsplit("/", 1)[0]
        matches = {str(v) for k, v in want.items() if k.rsplit("/", 1)[0] == stem}
        assert matches == {lab}, (name, lab, matches)
    assert got["mil.head_stenosis_binary.weight"] == "head_stenosis"
    assert got["mil.head_CTO.bias"] == "head_CTO"
    assert got["mil.across_cls.block0.attn.qkv.weight"] == "attention_across"
    assert got["video_encoder.backbone.block0.attn.qkv.weight"] == "encoder"
    assert not bundle.tx.groups["head_stenosis_binary"]


def test_probe_optimizer_hyperparameters_follow_the_config(pair):
    bundle, _ = pair.torch_side()
    h = bundle.tx.hyper
    assert h["encoder"] == (1.0, 1e-5, 1.0)
    np.testing.assert_allclose(h["attention_across"], (1.5, 5e-5, 1.0))
    np.testing.assert_allclose(h["attention_within"], (1.5, 5e-5, 1.0))
    np.testing.assert_allclose(h["head_CTO"], (0.3, 1e-5, 1.0))
    assert h["view_embedding"] == (1.0, 1e-5, 1.0) and h["mil_other"] == (1.0, 1e-5, 1.0)


def _check_steps(pair, n, ratio, atol=PARAM_ATOL):
    n_k3, n_k5 = flash_attention.launches, flash_attention_packed.proj_launches
    jm, tm, jtree, ttree, tstate = pair.run(n, ratio)
    for j, t in zip(jm, tm):
        assert j.keys() == t.keys()
        for key in j:
            np.testing.assert_allclose(t[key], j[key], err_msg=key, **SCALAR_TOL)
    assert tm[0]["lr"] == 0.0 and tm[1]["lr"] > 0.0
    assert tstate.step == n
    _assert_trees_close(ttree, jtree, atol)
    # CPU tensors never reach a kernel
    assert (flash_attention.launches, flash_attention_packed.proj_launches) == (n_k3, n_k5)
    init, jf, tf = (convert.flatten_tree(t) for t in (pair.init_tree, jtree, ttree))
    frozen_j = {k for k in jf if np.array_equal(jf[k], init[k])}
    frozen_t = {k for k in tf if np.array_equal(tf[k], init[k])}
    assert ({k for k in frozen_j if not k.endswith(NOISE_LEAF)}
            == {k for k in frozen_t if not k.endswith(NOISE_LEAF)})
    return tm, frozen_t, tf


def test_frozen_probe_steps_match_jax(pair):
    """Three steps at video_freeze_ratio 1.0 (the encoder runs without a
    graph in the port): loss, lr, grad_norm (taken after the mask, so the
    same number), the per-head losses, and every parameter; the encoder
    stays bit for bit, every MIL parameter moves."""
    tm, frozen, tf = _check_steps(pair, 3, 1.0)
    assert all(k in frozen for k in tf if k.startswith("video_encoder/"))
    assert not any(k in frozen for k in tf if k.startswith("mil/"))
    assert tm[0]["grad_norm"] > 0.0


@pytest.mark.parametrize("ratio", [0.0, 0.8])
def test_partly_frozen_probe_steps_match_jax(pair, ratio):
    """The encoder trains (0.0) or its top trains (0.8, the value of
    cathef_regression_config.yaml), backward through the attention
    autograd.Function's plain versions."""
    _, frozen, tf = _check_steps(pair, 3, ratio)
    assert "video_encoder/backbone/norm/scale" not in frozen
    assert ("video_encoder/backbone/patch_embed/conv/kernel" in frozen) == (ratio > 0)
    assert "video_encoder/proj/proj/kernel" not in frozen


@pytest.mark.parametrize("ratio", [1.0, 0.5])
def test_probe_steps_with_fused_outproj_match_jax(monkeypatch, ratio):
    """The backbone at 2 heads of 128 with the output projection inside the
    attention call on both sides (the JAX layer under
    DEEPCORO_FUSED_OUTPROJ=1, the port with fused_outproj=True), frozen and
    with gradients through the fused call's backward. Parameters to atol
    1e-4 here: among the 256-wide encoder's 4 M trained values a few have
    gradients that are rounding noise around zero (3 of a 262144-value
    kernel moved 7e-5 apart), which Adam turns into steps of another size."""
    monkeypatch.setenv("DEEPCORO_FUSED_OUTPROJ", "1")
    p = ProbePair(fused=True, **WIDE)
    bundle, _ = p.torch_side()
    assert bundle.video_model.backbone.block0.attn.fused_outproj
    _check_steps(p, 3, ratio, atol=1e-4)


def test_probe_steps_hierarchical_with_views_and_accumulation_match_jax():
    """Hierarchical tokens (the encoder emits [B, N*L, D]), shared pools,
    view embeddings, gradient accumulation over 2 micro-steps, sample_mask."""
    p = ProbePair(hierarchical_tokens=True, separate_video_attention=False,
                  use_view_embeddings=True, num_view_classes=3, view_embedding_lr=0.002,
                  gradient_accumulation_steps=2, pooling_mode="attention+cls_token")
    p.batch["sample_mask"] = np.array([True, False])
    jm, tm, jtree, ttree, tstate = p.run(4, 1.0)
    for j, t in zip(jm, tm):
        for key in j:
            np.testing.assert_allclose(t[key], j[key], err_msg=key, **SCALAR_TOL)
    _assert_trees_close(ttree, jtree)
    assert int(tstate.opt_state["gradient_step"]) == 2
    assert "shared_gated" in ttree["mil"] and "hier_proj" in ttree["mil"]
    assert "view_embeddings" in ttree["mil"]


def test_probe_eval_step_matches_jax(pair):
    _, jstate = pair.jax_side()
    jout = jprobe.make_probe_eval_step(pair.jbundle)(
        jstate.params, pair.jbundle.batch_sharding_fn(pair.batch))
    bundle, state = pair.torch_side()
    tout = tprobe.make_probe_eval_step(bundle)(
        state.params, tprobe.to_device_batch(bundle, pair.batch))
    np.testing.assert_allclose(float(tout["loss"]), float(jout["loss"]), **SCALAR_TOL)
    _close(tout["embeddings"], jout["embeddings"])
    assert tout["embeddings"].shape == (2, 3, 32)
    for head in pair.jcfg.head_structure:
        _close(tout["outputs"][head], jout["outputs"][head])


def test_steps_refuse_parameters_that_are_not_the_bundles_own(pair):
    """The steps run the bundle's modules: a dict of other tensors (copies,
    another bundle's state) would be ignored, so it raises instead."""
    bundle, state = pair.torch_side()
    batch = tprobe.to_device_batch(bundle, pair.batch)
    copies = {k: v.detach().clone() for k, v in state.params.items()}
    with pytest.raises(ValueError, match="own parameters"):
        tprobe.make_probe_eval_step(bundle)(copies, batch)
    with pytest.raises(ValueError, match="own parameters"):
        tprobe.make_probe_train_step(bundle)(state.replace(params=copies), batch, None, 1.0)
    short = dict(list(state.params.items())[1:])
    with pytest.raises(ValueError, match="own parameters"):
        tprobe.make_probe_eval_step(bundle)(short, batch)


def test_nonfinite_loss_changes_nothing(pair):
    """A NaN target: parameters, moments and the count stay where they were."""
    bundle, state = pair.torch_side()
    step = tprobe.make_probe_train_step(bundle)
    batch = tprobe.to_device_batch(bundle, pair.batch)
    state, _ = step(state, batch, None, 1.0)
    state, _ = step(state, batch, None, 1.0)
    before = {k: v.detach().clone() for k, v in state.params.items()}
    mu = {k: v.clone() for k, v in state.opt_state["mu"].items()}
    bad = dict(batch, targets=dict(batch["targets"], stenosis=torch.full((2,), float("nan"))))
    state, m = step(state, bad, None, 1.0)
    assert not np.isfinite(float(m["loss"]))
    assert int(state.opt_state["count"]) == 2
    assert all(torch.equal(v, before[k]) for k, v in state.params.items())
    assert all(torch.equal(v, mu[k]) for k, v in state.opt_state["mu"].items())


# --------------------------------------------------------------------------- #
# the transplant of a CLIP video tree


def test_merge_encoder_params_matches_jax():
    """Same answer as train/linear_probe._merge_encoder_params on trees with
    a probing-only subtree, a checkpoint-only subtree, a shape mismatch and
    a structural mismatch."""
    r = np.random.default_rng(8)
    new = {"backbone": {"a": r.normal(size=(2, 3)), "b": r.normal(size=(4,)),
                        "c": {"d": r.normal(size=(2,))}},
           "pool": {"query": r.normal(size=(1, 1, 4))}, "proj": r.normal(size=(3,))}
    old = {"backbone": {"a": r.normal(size=(2, 3)), "b": r.normal(size=(5,)),
                        "c": r.normal(size=(2,))},
           "aggregator": {"x": r.normal(size=(2,))}, "proj": r.normal(size=(3,))}
    got = tprobe.merge_encoder_params(new, old)
    ref = jprobe._merge_encoder_params(new, old)
    gf, rf = convert.flatten_tree(got), convert.flatten_tree(ref)
    assert gf.keys() == rf.keys() == convert.flatten_tree(new).keys()
    for k in gf:
        np.testing.assert_array_equal(gf[k], rf[k], err_msg=k)
    np.testing.assert_array_equal(got["backbone"]["a"], old["backbone"]["a"])
    np.testing.assert_array_equal(got["backbone"]["b"], new["backbone"]["b"])
    np.testing.assert_array_equal(got["pool"]["query"], new["pool"]["query"])


@pytest.mark.parametrize("pooling_mode", ["attention+cls_token", "attention"])
def test_build_probe_bundle_transplants_a_clip_video_tree(pooling_mode):
    """A CLIP tree produced by the port's own build_clip_bundle goes into the
    probing encoder: backbone and projection transfer, the aggregator of
    another depth keeps the probing encoder's fresh values, and the
    probing-only AttentionPool keeps its own."""
    clip_cfg = tiny_config(num_videos=3, aggregator_depth=2, dropout=0.0)
    clip_bundle, _ = tclip.build_clip_bundle(clip_cfg, seed=5, device="cpu")
    clip_tree = convert.module_to_jax_tree(clip_bundle.video_model)
    cfg = tconfigs.LinearProbingConfig.from_dict(
        dict(PROBE, pooling_mode=pooling_mode, aggregator_depth=1))
    fresh, _ = tprobe.build_probe_bundle(cfg, seed=0, device="cpu")
    bundle, _ = tprobe.build_probe_bundle(cfg, seed=0, device="cpu",
                                          encoder_params={"params": clip_tree})
    got = convert.flatten_tree(convert.module_to_jax_tree(bundle.video_model))
    base = convert.flatten_tree(convert.module_to_jax_tree(fresh.video_model))
    src = convert.flatten_tree(clip_tree)
    moved = [k for k in got if k in src and src[k].shape == got[k].shape]
    assert any(k.startswith("backbone/block1/") for k in moved)
    assert "proj/proj/kernel" in moved
    for k in got:
        np.testing.assert_array_equal(got[k], src[k] if k in moved else base[k], err_msg=k)
    assert ("pool/query" in got) == (pooling_mode == "attention")
    assert "aggregator/block1/attn/qkv/kernel" in src
    assert "aggregator/block1/attn/qkv/kernel" not in got
