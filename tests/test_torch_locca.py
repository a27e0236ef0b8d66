"""The LocCa head of the contrastive path against the JAX package, on the CPU.

Each piece takes the same numpy inputs (made from a seed) in both packages:

- ``LocCaDecoder`` through ``convert.py``: logits fp32 atol 1e-5 rtol 1e-5
  (without a token grid, with one, and with 3 videos whose tokens repeat
  the grid's coordinates), bf16 within 2% of the largest logit; the
  ``ValueError`` on a memory that is not a multiple of the grid;
  ``locca_token_grid``; greedy generation's ids equal;
- a ``DeepCORO_clip`` step with the head on (``siglip_single_head`` over a
  bank, 2 videos a study, a location mask, task weights, label smoothing):
  the loss, ``locca_loss`` and every gradient leaf against
  ``jax.value_and_grad`` of the JAX ``compute_loss``; three train steps
  against ``make_train_step`` (every metric ``SCALAR_TOL``, the tree after
  the update within ``PARAM_ATOL``, as ``tests/test_torch_train.py``
  states); the eval step against ``make_eval_step``;
- where the decoder's leaves go: the ``video`` group of the optimizer, no
  freeze fraction, the training tree both ways with a strict load;
- ``siglip_single_head_config.yaml`` with ``locca_enabled: true`` through
  the port's ``main`` and the JAX package's ``main`` over 2 epochs:
  per-epoch losses (``locca_loss`` too) within relative 1e-4.
"""

import math

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepcoro_clip_tpu.configs.clip import ClipConfig as JaxClipConfig
from deepcoro_clip_tpu.flagship import tiny_config as jax_tiny
from deepcoro_clip_tpu.models import captioning_decoder as jcap
from deepcoro_clip_tpu.models import locca_decoder as jloc
from deepcoro_clip_tpu.parallel import MeshSpec, make_mesh
from deepcoro_clip_tpu.registry import register_all
from deepcoro_clip_tpu.train import clip as jclip

import chip_smoke
from deepcoro_clip_tpu_torch import convert
from deepcoro_clip_tpu_torch.flagship import tiny_config
from deepcoro_clip_tpu_torch.models import captioning_decoder as tcap
from deepcoro_clip_tpu_torch.models import locca_decoder as tloc
from deepcoro_clip_tpu_torch.registry import ModelRegistry
from deepcoro_clip_tpu_torch.train import clip as tclip
from deepcoro_clip_tpu_torch.train import optim as toptim

from tests.single_head_runs import EPOCH_KEYS, LOCCA_RUN, run_both_mains, siglip_corpus, \
    single_head_yaml

register_all()

SCALAR_TOL = dict(rtol=1e-4, atol=1e-6)
PARAM_ATOL = 3e-5
RUN_RTOL = 1e-4


# --------------------------------------------------------------------------- #
# the decoder


DEC = dict(vocab_size=50, dim=16, depth=2, num_heads=2, max_length=8, memory_dim=12,
           dropout=0.0, n_special_tokens=1)
GRID = (2, 2, 2)


def _decoder_pair(grid=GRID, dtype="fp32", seed=0):
    jd = jloc.LocCaDecoder(**DEC, token_grid=grid, use_flash=False,
                           dtype=jnp.float32 if dtype == "fp32" else jnp.bfloat16)
    r = np.random.default_rng(seed)
    ids = r.integers(0, 50, (2, 8)).astype(np.int32)
    params = jd.init(jax.random.PRNGKey(seed), jnp.asarray(ids),
                     jnp.zeros((2, 9, 12), jnp.float32))
    td = tloc.LocCaDecoder(**DEC, token_grid=grid, use_flash=True,
                           dtype=torch.float32 if dtype == "fp32" else torch.bfloat16)
    td.load_state_dict(convert.jax_tree_to_state_dict(
        jax.tree_util.tree_map(np.asarray, fnn.unbox(params["params"]))), strict=True)
    return jd, params, td, ids


@pytest.mark.parametrize("grid,videos", [(None, 1), (GRID, 1), (GRID, 3)],
                         ids=["no_grid", "grid", "grid_3_videos"])
def test_decoder_logits_match_jax(grid, videos):
    """fp32 logits with the captions' padding mask, atol 1e-5 rtol 1e-5; with
    3 videos the memory holds 27 tokens and the 9 coordinates repeat."""
    jd, params, td, ids = _decoder_pair(grid)
    r = np.random.default_rng(1)
    mem = r.normal(size=(2, 9 * videos, 12)).astype(np.float32)
    mask = np.ones((2, 8), np.int32)
    mask[1, 5:] = 0
    want = np.asarray(jd.apply(params, jnp.asarray(ids), jnp.asarray(mem),
                               attention_mask=jnp.asarray(mask)))
    got = td(torch.from_numpy(ids), torch.from_numpy(mem), attention_mask=torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.shape == (2, 8, 50)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5, rtol=1e-5)
    assert hasattr(td, "coord_emb") == (grid is not None)


def test_decoder_logits_match_jax_bf16():
    """bf16 compute (fp32 LayerNorm and head): within 2% of the largest logit."""
    jd, params, td, ids = _decoder_pair(dtype="bf16")
    mem = np.random.default_rng(2).normal(size=(2, 18, 12)).astype(np.float32)
    want = np.asarray(jd.apply(params, jnp.asarray(ids), jnp.asarray(mem)))
    got = td(torch.from_numpy(ids), torch.from_numpy(mem)).detach().numpy()
    assert np.abs(got - want).max() <= 0.02 * np.abs(want).max()


def test_memory_off_the_grid_raises():
    _, _, td, ids = _decoder_pair()
    with pytest.raises(ValueError, match="not a multiple"):
        td(torch.from_numpy(ids), torch.zeros(2, 10, 12))


def test_tables_and_token_grid_match_jax():
    np.testing.assert_array_equal(tloc.sinusoidal_positions(16, 12),
                                  jloc.sinusoidal_positions(16, 12))
    np.testing.assert_array_equal(tloc.grid_coordinates((3, 2, 4), 1),
                                  jloc.grid_coordinates((3, 2, 4), 1))
    for over in (dict(), dict(frames=15, vit_pool_stages=[]), dict(resize=232),
                 dict(use_cls_token=False, vit_pool_stages=[3, 6])):
        cfg = chip_smoke.siglip_config(**over)
        jcfg = JaxClipConfig.from_dict({k: getattr(cfg, k) for k in (
            "frames", "resize", "vit_patch", "vit_pool_stages", "use_cls_token")})
        assert tloc.locca_token_grid(cfg) == jloc.locca_token_grid(jcfg), over
    assert tloc.locca_token_grid(chip_smoke.siglip_config()) == ((8, 7, 7), 1)
    assert ModelRegistry.get("locca_decoder") is tloc.LocCaDecoder


def test_greedy_generation_with_the_locca_decoder_matches_jax():
    """captioning_decoder.greedy_generate decodes with a LocCaDecoder: the
    JAX package's ids exactly, BOS first."""
    jd, params, td, _ = _decoder_pair(seed=4)
    mem = np.random.default_rng(4).normal(size=(2, 9, 12)).astype(np.float32)
    want = np.asarray(jcap.greedy_generate(jd, params, jnp.asarray(mem), 1, 2, 8))
    got = tcap.greedy_generate(td, torch.from_numpy(mem), 1, 2, 8).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[:, 0] == 1).all() and got.shape == (2, 8)


# --------------------------------------------------------------------------- #
# the train and eval steps with the head


STEP_CFG = dict(
    vit_depth=1, text_depth=1, text_dim=128, text_heads=1, scheduler_name="cosine_with_warmup",
    epochs=2,
    label_smoothing=0.1, batch_size=4, loss_name="siglip_single_head",
    siglip_max_positive_per_video=2, siglip_negatives_per_video=2, siglip_bias_init=-3.0,
    locca_enabled=True, locca_d_model=32, locca_num_layers=2, locca_num_heads=2,
    locca_max_seq_len=12, locca_weight=0.5,
    locca_task_weights={"captioning": 1.0, "referring": 0.5, "grounded": 0.7},
)
STEPS_PER_EPOCH = 4


def _step_batch(cfg, seed=0):
    """4 studies of 2 clips (one padded), a bank of 16 texts (3 fillers),
    W-matrix weights with zeros, captions with padding and locations."""
    r = np.random.default_rng(seed)
    B, N, L, M = 4, cfg.num_videos, cfg.max_text_length, 16
    vmask = np.ones((B, N), bool)
    vmask[1, 1] = False
    att = np.ones((M, L), np.int32)
    att[2, 9:] = 0
    att[-3:, 2:] = 0
    pos = np.zeros((B, M), np.float32)
    pos[0, [0, 1]] = pos[1, 2] = pos[2, [3, 4]] = pos[3, 5] = 1.0
    w = r.uniform(0.0, 1.5, (B, M)).astype(np.float32)
    w[:, -3:] = 0.0
    w[0, 7] = 0.0
    Lc = cfg.locca_max_seq_len
    cmask = np.ones((B, Lc), np.int32)
    cmask[0, 7:] = 0
    cmask[3, 4:] = 0
    return {
        "videos": r.normal(size=(B, N, cfg.frames, cfg.resize, cfg.resize, 3))
        .astype(np.float32),
        "video_mask": vmask,
        "input_ids": r.integers(0, cfg.text_vocab_size, (M, L)).astype(np.int32),
        "attention_mask": att,
        "positive_mask": pos,
        "positive_weights": w,
        "text_valid": np.r_[np.ones(M - 3), np.zeros(3)].astype(np.float32),
        "caption_ids": r.integers(0, cfg.text_vocab_size, (B, Lc)).astype(np.int32),
        "caption_mask": cmask,
        "location_mask": (r.uniform(size=(B, Lc)) < 0.3).astype(np.float32),
    }


class Pair:
    """The two packages' bundles with the head, on the same initial weights."""

    def __init__(self):
        self.jcfg = jax_tiny(**STEP_CFG)
        self.tcfg = tiny_config(use_pallas_attention=True, **STEP_CFG)
        mesh = make_mesh(MeshSpec(data=1, model=1), devices=jax.devices()[:1])
        self.jbundle, self.jstate = jclip.build_clip_bundle(
            self.jcfg, mesh, jax.random.PRNGKey(0), steps_per_epoch=STEPS_PER_EPOCH)
        self.jbundle = self.jbundle._replace(
            text_model=self.jbundle.text_model.clone(proj_dropout=0.0))
        self.init = jax.tree_util.tree_map(np.asarray, self.jstate.params)
        self.batch = _step_batch(self.jcfg)

    def torch_side(self):
        bundle, state = tclip.build_clip_bundle(self.tcfg, seed=0,
                                                steps_per_epoch=STEPS_PER_EPOCH, device="cpu")
        bundle.text_model.proj.dropout = 0.0
        p = state.params
        convert.load_training_tree(self.init, bundle.video_model, bundle.text_model,
                                   p["log_temp"], p["logit_bias"], bundle.locca_decoder)
        return bundle, state, tclip.to_device_batch(bundle, self.batch)

    def tree(self, bundle, params):
        return convert.flatten_tree(convert.training_tree(
            bundle.video_model, bundle.text_model, params["log_temp"],
            params["logit_bias"], bundle.locca_decoder))


@pytest.fixture(scope="module")
def pair():
    return Pair()


def _noise(key: str) -> bool:
    """Key biases, whose gradient softmax's shift invariance makes noise."""
    return key.endswith(("/k/bias", "key/bias"))


def _close_trees(tf, jf, atol):
    assert tf.keys() == jf.keys()
    for k in jf:
        a, b = tf[k], jf[k]
        if k.endswith("attn/qkv/bias"):
            n = a.shape[0] // 3
            a, b = np.delete(a, slice(n, 2 * n)), np.delete(b, slice(n, 2 * n))
        elif _noise(k):
            continue
        np.testing.assert_allclose(a, b, atol=atol(b), rtol=0, err_msg=k)


def test_bundle_builds_the_head(pair):
    """The decoder at the config's widths over embedding_dim tokens, its
    leaves in the flat training dict under ``locca_decoder.``, in the
    optimizer's ``video`` group (the JAX label rule), outside both freeze
    trees; the training tree round-trips with a strict load."""
    bundle, state, _ = pair.torch_side()
    dec = bundle.locca_decoder
    assert isinstance(dec, tloc.LocCaDecoder)
    assert (dec.dim, dec.depth, dec.num_heads, dec.max_length) == (32, 2, 2, 12)
    assert dec.layer0.cross_attn.k.in_features == pair.tcfg.embedding_dim
    names = [n for n in state.params if n.startswith("locca_decoder.")]
    assert len(names) == len(list(dec.parameters()))
    labels = {toptim.group_label(n) for n in names}
    assert labels == {"video"}
    assert not any(n[len("video_encoder."):] in bundle.video_fracs for n in names)
    assert convert.flatten_tree(pair.init).keys() == pair.tree(bundle, state.params).keys()
    for k, v in convert.flatten_tree(pair.init).items():
        np.testing.assert_array_equal(pair.tree(bundle, state.params)[k], v, err_msg=k)
    with pytest.raises(ValueError, match="LocCa head"):
        convert.load_training_tree(pair.init, bundle.video_model, bundle.text_model,
                                   state.params["log_temp"], state.params["logit_bias"])


def test_loss_and_gradients_match_jax(pair):
    """``loss`` and ``locca_loss`` rtol 1e-4; every gradient leaf within
    1e-4 of the leaf's largest magnitude (key biases left out)."""
    jb = pair.jbundle.batch_sharding_fn(pair.batch)

    def loss_fn(params):
        out = jclip.compute_loss(pair.jbundle, params, jb,
                                 {"dropout": jax.random.PRNGKey(1)}, deterministic=False)
        return out["loss"], out

    (jl, jout), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, pair.init))
    bundle, state, batch = pair.torch_side()
    params = state.params
    out = tclip.compute_loss(bundle, params["log_temp"], batch, None, deterministic=False,
                             logit_bias=params["logit_bias"])
    np.testing.assert_allclose(float(out["loss"].detach()), float(jl), **SCALAR_TOL)
    np.testing.assert_allclose(float(out["locca_loss"].detach()),
                               float(jout["locca_loss"]), **SCALAR_TOL)
    assert float(jout["locca_loss"]) > 1.0
    names = list(params)
    got = torch.autograd.grad(out["loss"], [params[n] for n in names])
    saved = {k: p.detach().clone() for k, p in params.items()}
    with torch.no_grad():
        for n, g in zip(names, got):
            params[n].copy_(g)
    tg = pair.tree(bundle, params)
    with torch.no_grad():
        for k, v in saved.items():
            params[k].copy_(v)
    jgf = convert.flatten_tree(jax.tree_util.tree_map(np.asarray, jg))
    _close_trees(tg, jgf, lambda b: max(1e-4 * max(float(np.abs(b).max()), 1e-6), 1e-7))
    assert any(k.startswith("locca_decoder/coord_emb") for k in jgf)


def test_train_steps_match_jax(pair):
    """Three steps: every metric of the JAX step (``grad_norm_locca_decoder``
    among them) SCALAR_TOL, ``locca_loss`` against the JAX ``compute_loss``
    on each step's parameters, the tree after the updates within
    PARAM_ATOL; the decoder moved."""
    jstep = jclip.make_train_step(pair.jbundle)
    # a copy: the step donates the state it is given
    jstate = jax.tree_util.tree_map(lambda x: jnp.array(x, copy=True), pair.jstate)
    jb = pair.jbundle.batch_sharding_fn(pair.batch)
    bundle, state, batch = pair.torch_side()
    tstep = tclip.make_train_step(bundle)
    for i in range(3):
        jout = jclip.compute_loss(pair.jbundle, jstate.params, jb, None, deterministic=True)
        jstate, jm = jstep(jstate, jb, jax.random.PRNGKey(i), 0.0, 0.0, -1.0)
        state, tm = tstep(state, batch, None, 0.0, 0.0, -1.0)
        assert set(tm) == set(jm) | {"locca_loss"}
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), err_msg=f"{i} {k}",
                                       **SCALAR_TOL)
        np.testing.assert_allclose(float(tm["locca_loss"]), float(jout["locca_loss"]),
                                   err_msg=f"{i} locca_loss", **SCALAR_TOL)
    assert float(jm["grad_norm_locca_decoder"]) > 0
    jf = convert.flatten_tree(jax.tree_util.tree_map(np.asarray, jstate.params))
    tf = pair.tree(bundle, state.params)
    _close_trees(tf, jf, lambda b: PARAM_ATOL)
    init = convert.flatten_tree(pair.init)
    assert all(not np.array_equal(tf[k], init[k]) for k in tf
               if k.startswith("locca_decoder/") and not _noise(k))


def test_eval_step_matches_jax(pair):
    """The validation loss includes the LocCa term, as the JAX eval step's
    ``compute_loss`` does: loss, alignment SCALAR_TOL, embeddings atol 1e-5."""
    jout = jclip.make_eval_step(pair.jbundle)(jax.tree_util.tree_map(jnp.asarray, pair.init),
                                              pair.jbundle.batch_sharding_fn(pair.batch))
    jfull = jclip.compute_loss(pair.jbundle, jax.tree_util.tree_map(jnp.asarray, pair.init),
                               pair.jbundle.batch_sharding_fn(pair.batch), None,
                               deterministic=True)
    bundle, state, batch = pair.torch_side()
    tout = tclip.make_eval_step(bundle)(state.params, batch)
    for k in ("loss", "alignment"):
        np.testing.assert_allclose(float(tout[k]), float(jout[k]), err_msg=k, **SCALAR_TOL)
    np.testing.assert_allclose(float(tout["locca_loss"]), float(jfull["locca_loss"]),
                               **SCALAR_TOL)
    for k in ("video_emb", "text_emb"):
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]), atol=1e-5,
                                   rtol=1e-4, err_msg=k)
    # without caption ids the head is not run, in both packages
    no_cap = {k: v for k, v in batch.items() if k not in ("caption_ids", "caption_mask",
                                                          "location_mask")}
    assert "locca_loss" not in tclip.make_eval_step(bundle)(state.params, no_cap)


# --------------------------------------------------------------------------- #
# the run through both mains


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return siglip_corpus(tmp_path_factory.mktemp("locca_corpus"), seed=1)


def test_single_head_locca_run_matches_jax_main(corpus, monkeypatch):
    """siglip_single_head_config.yaml with locca_enabled: true, 2 epochs,
    through both mains: every epoch's train and validation metrics, the
    LocCa loss (the JAX step's total minus the contrastive part is not
    reported: the port's ``locca_loss`` is checked finite and the total
    against JAX's) and the decoder's gradient norm within relative 1e-4."""
    cfg = single_head_yaml(corpus["paths"], corpus["root"] / "out", **LOCCA_RUN)
    jhist, thist = run_both_mains(corpus["root"], cfg, monkeypatch)
    assert len(jhist) == len(thist) == 2
    for j, t in zip(jhist, thist):
        for key in EPOCH_KEYS + ("grad_norm_locca_decoder",):
            np.testing.assert_allclose(t[key], j[key], rtol=RUN_RTOL, atol=1e-7,
                                       err_msg=f"epoch {t['epoch']} {key}")
        for key in ("locca_loss", "val_locca_loss"):
            assert math.isfinite(t[key]) and t[key] > 1.0, key
