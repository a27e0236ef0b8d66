"""The port's contrastive train step against the JAX package, same weights,
same batch.

``deepcoro_clip_tpu.train.clip.build_clip_bundle`` initializes the JAX
state at ``tiny_config`` sizes on one CPU device; its parameter tree goes
through ``deepcoro_clip_tpu_torch.convert.load_training_tree`` into the
port's bundle, and both packages take the same steps of ``make_train_step``
on the same numpy batch (uint8 patch-major videos, as ``bench.py`` feeds
them), fp32, dropout 0 (the text head's ``proj_dropout``, which no config
field reaches and both packages leave at 0.1, is set to 0 on both bundles:
the two frameworks draw different masks from the same seed). The port's
attention runs through its
``autograd.Function`` (``use_pallas_attention=True``: plain forward and
``flash_bwd_plain`` on the CPU), the JAX side through its XLA attention.

Tolerances. Loss, ``grad_norm`` and ``alignment``: rtol 1e-4 (fp32 sums in
another order). Parameters after the steps: atol 3e-5 with lr 1e-3, that
is 1% of the 3e-3 a parameter can move in three Adam steps: Adam divides
the first moment by the root of the second, so a gradient that is itself
rounding noise around zero moves its parameter by a different fraction of
the rate in the two packages. The key bias (the middle third of a fused
``attn/qkv/bias``) is the extreme case and is left out: the softmax does
not depend on it, so its whole gradient is rounding noise.
"""

import jax
import numpy as np
import pytest
import torch

from deepcoro_clip_tpu.data.patch_wire import patchify_videos
from deepcoro_clip_tpu.flagship import tiny_config as jax_tiny
from deepcoro_clip_tpu.parallel import MeshSpec, make_mesh
from deepcoro_clip_tpu.registry import register_all
from deepcoro_clip_tpu.train import clip as jclip

from deepcoro_clip_tpu_torch import convert
from deepcoro_clip_tpu_torch.flagship import tiny_config
from deepcoro_clip_tpu_torch.ops.flash_attention import flash_attention
from deepcoro_clip_tpu_torch.train import clip as tclip

register_all()

SCALAR_TOL = dict(rtol=1e-4, atol=1e-6)
PARAM_ATOL = 3e-5
# text tower at one head of 128 (the packed dispatch), video at 2 x 32
CFG = dict(text_dim=128, text_heads=1, scheduler_name="cosine_with_warmup",
           epochs=2, label_smoothing=0.1)
STEPS_PER_EPOCH = 4


def _batch(cfg, seed=0, B=4):
    r = np.random.default_rng(seed)
    videos = r.integers(0, 255, size=(B, cfg.num_videos, cfg.frames, cfg.resize,
                                      cfg.resize, 3)).astype(np.uint8)
    mask = np.ones((B, cfg.num_videos), bool)
    mask[1, 1] = False
    att = np.ones((B, cfg.max_text_length), np.int32)
    att[2, 9:] = 0
    return {
        "videos": patchify_videos(videos, (2, 16, 16)),
        "video_mask": mask,
        "input_ids": r.integers(0, cfg.text_vocab_size,
                                size=(B, cfg.max_text_length)).astype(np.int32),
        "attention_mask": att,
    }


def _flat(tree):
    return convert.flatten_tree(tree)


class Pair:
    """The two packages' bundles on the same initial weights."""

    def __init__(self, **over):
        kw = dict(CFG, **over)
        self.jcfg = jax_tiny(**kw)
        self.tcfg = tiny_config(use_pallas_attention=True, **kw)
        mesh = make_mesh(MeshSpec(data=1, model=1), devices=jax.devices()[:1])
        self.jbundle, self.jstate = jclip.build_clip_bundle(
            self.jcfg, mesh, jax.random.PRNGKey(0), steps_per_epoch=STEPS_PER_EPOCH)
        self.jbundle = self.jbundle._replace(
            text_model=self.jbundle.text_model.clone(proj_dropout=0.0))
        self.jstep = jclip.make_train_step(self.jbundle)
        self.init_tree = jax.tree_util.tree_map(np.asarray, self.jstate.params)
        self.batch = _batch(self.jcfg)

    def torch_side(self):
        bundle, state = tclip.build_clip_bundle(
            self.tcfg, seed=0, steps_per_epoch=STEPS_PER_EPOCH, device="cpu")
        bundle.text_model.proj.dropout = 0.0
        convert.load_training_tree(
            self.init_tree, bundle.video_model, bundle.text_model,
            state.params["log_temp"], state.params["logit_bias"])
        return bundle, state, tclip.make_train_step(bundle)

    def fresh_jax_state(self):
        _, state = jclip.build_clip_bundle(
            self.jcfg, self.jbundle.mesh, jax.random.PRNGKey(0),
            steps_per_epoch=STEPS_PER_EPOCH)
        return state

    def run(self, n, vfr=0.0, tfr=0.0, temp=-1.0):
        """n steps in both packages: (jax metrics, torch metrics, jax tree,
        torch tree, torch state)."""
        jstate = self.fresh_jax_state()
        jb = self.jbundle.batch_sharding_fn(self.batch)
        bundle, tstate, tstep = self.torch_side()
        tb = tclip.to_device_batch(bundle, self.batch)
        jm, tm = [], []
        for i in range(n):
            jstate, m = self.jstep(jstate, jb, jax.random.PRNGKey(i), vfr, tfr, temp)
            jm.append({k: float(v) for k, v in m.items()})
            tstate, m = tstep(tstate, tb, None, vfr, tfr, temp)
            tm.append({k: float(v) for k, v in m.items()})
        jtree = jax.tree_util.tree_map(np.asarray, jstate.params)
        ttree = convert.training_tree(
            bundle.video_model, bundle.text_model, tstate.params["log_temp"],
            tstate.params["logit_bias"])
        return jm, tm, jtree, ttree, tstate


@pytest.fixture(scope="module")
def pair():
    return Pair()


def _assert_trees_close(ttree, jtree, atol=PARAM_ATOL):
    jf, tf = _flat(jtree), _flat(ttree)
    assert jf.keys() == tf.keys()
    for k in jf:
        a, b = tf[k], jf[k]
        if k.endswith("attn/qkv/bias"):  # drop the key bias: pure noise
            n = a.shape[0] // 3
            a, b = np.delete(a, slice(n, 2 * n)), np.delete(b, slice(n, 2 * n))
        np.testing.assert_allclose(a, b, atol=atol, rtol=0, err_msg=k)


def test_training_tree_round_trips(pair):
    """JAX tree -> port -> JAX tree is the identity, name for name."""
    bundle, state, _ = pair.torch_side()
    back = convert.training_tree(bundle.video_model, bundle.text_model,
                                 state.params["log_temp"], state.params["logit_bias"])
    jf, tf = _flat(pair.init_tree), _flat(back)
    assert jf.keys() == tf.keys()
    for k in jf:
        np.testing.assert_array_equal(tf[k], jf[k], err_msg=k)


def test_three_train_steps_match_jax(pair):
    """Held against train/clip.make_train_step: loss, grad_norm, the
    per-tower norms, alignment, temperature, lr per step (rtol 1e-4), and
    every parameter after the third step (atol 3e-5)."""
    n_fwd = flash_attention.launches
    jm, tm, jtree, ttree, tstate = pair.run(3)
    for j, t in zip(jm, tm):
        for key in ("loss", "grad_norm", "grad_norm_video_encoder",
                    "grad_norm_text_encoder", "alignment", "temperature", "lr",
                    "video_emb_norm", "text_emb_norm"):
            np.testing.assert_allclose(t[key], j[key], err_msg=key, **SCALAR_TOL)
    assert tm[0]["lr"] == 0.0 and tm[1]["lr"] > 0.0  # schedule read before the update
    assert tstate.step == 3 and int(tstate.opt_state["count"]) == 3
    _assert_trees_close(ttree, jtree)
    moved = _flat(ttree)["video_encoder/backbone/block0/attn/qkv/kernel"]
    assert np.abs(moved - _flat(pair.init_tree)[
        "video_encoder/backbone/block0/attn/qkv/kernel"]).max() > 1e-4
    assert flash_attention.launches == n_fwd  # CPU tensors never reach a kernel


def test_eval_step_matches_jax(pair):
    """Held against train/clip.make_eval_step (atol 1e-4 on embeddings)."""
    jout = jclip.make_eval_step(pair.jbundle)(
        pair.fresh_jax_state().params, pair.jbundle.batch_sharding_fn(pair.batch))
    bundle, state, _ = pair.torch_side()
    tout = tclip.make_eval_step(bundle)(state.params,
                                        tclip.to_device_batch(bundle, pair.batch))
    for key in ("loss", "alignment"):
        np.testing.assert_allclose(float(tout[key]), float(jout[key]), **SCALAR_TOL)
    for key in ("video_emb", "text_emb"):
        np.testing.assert_allclose(tout[key].numpy(), np.asarray(jout[key]),
                                   atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("vfr,tfr", [(0.5, 0.5), (1.0, 0.0), (0.0, 1.0)])
def test_freeze_ratios_match_jax(pair, vfr, tfr):
    """Two steps with freeze ratios, against the JAX step: the same leaves
    stay exactly where they were, the others move alike."""
    _, _, jtree, ttree, _ = pair.run(2, vfr=vfr, tfr=tfr)
    _assert_trees_close(ttree, jtree)
    init, jf, tf = _flat(pair.init_tree), _flat(jtree), _flat(ttree)
    frozen_j = {k for k in jf if np.array_equal(jf[k], init[k])}
    frozen_t = {k for k in tf if np.array_equal(tf[k], init[k])}
    assert frozen_j == frozen_t
    if vfr >= 1.0:  # the whole tower, heads included
        assert all(k in frozen_t for k in tf if k.startswith("video_encoder/"))
        assert "text_encoder/layer0/attention/query/kernel" not in frozen_t
    if vfr == 0.5:  # bottom of the backbone frozen, top and heads trainable
        assert "video_encoder/backbone/patch_embed/conv/kernel" in frozen_t
        assert "video_encoder/backbone/norm/scale" not in frozen_t
        assert "video_encoder/proj/proj/kernel" not in frozen_t


def test_temp_override_pins_the_temperature(pair):
    jm, tm, jtree, ttree, _ = pair.run(2, temp=0.2)
    for j, t in zip(jm, tm):
        assert t["temperature"] == pytest.approx(0.2, rel=1e-6)
        np.testing.assert_allclose(t["loss"], j["loss"], **SCALAR_TOL)
    np.testing.assert_array_equal(ttree["log_temp"], pair.init_tree["log_temp"])
    _assert_trees_close(ttree, jtree)


def test_nonfinite_loss_changes_nothing(pair):
    """A NaN loss leaves parameters, moments and the count untouched, and
    the step after it goes on from there."""
    bundle, state, step = pair.torch_side()
    batch = tclip.to_device_batch(bundle, pair.batch)
    state, _ = step(state, batch)
    state, _ = step(state, batch)
    snap = {k: v.detach().clone() for k, v in state.params.items()}
    mu = {k: v.clone() for k, v in state.opt_state["mu"].items()}
    nu = {k: v.clone() for k, v in state.opt_state["nu"].items()}
    with torch.no_grad():
        good = state.params["log_temp"].clone()
        state.params["log_temp"].fill_(float("nan"))
    state, m = step(state, batch)
    assert not np.isfinite(float(m["loss"]))
    assert int(state.opt_state["count"]) == 2 and state.step == 3
    with torch.no_grad():
        state.params["log_temp"].copy_(good)
    for k in snap:
        assert torch.equal(state.params[k], snap[k]), k
        assert torch.equal(state.opt_state["mu"][k], mu[k]), k
        assert torch.equal(state.opt_state["nu"][k], nu[k]), k
    state, m = step(state, batch)
    assert np.isfinite(float(m["loss"])) and int(state.opt_state["count"]) == 3


def test_gradient_accumulation_matches_jax():
    """optax.MultiSteps(2) against the port's MultiSteps over four
    micro-steps: no movement on the odd ones, the same parameters after."""
    pair = Pair(gradient_accumulation_steps=2)
    jm, tm, jtree, ttree, tstate = pair.run(4)
    for j, t in zip(jm, tm):
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(t[key], j[key], err_msg=key, **SCALAR_TOL)
    assert int(tstate.opt_state["gradient_step"]) == 2
    assert int(tstate.opt_state["mini_step"]) == 0
    _assert_trees_close(ttree, jtree)


@pytest.mark.parametrize("kw,exc", [
    (dict(locca_enabled=True, locca_d_model=32, locca_num_layers=1, locca_num_heads=2,
          locca_max_seq_len=8), None),
    (dict(optimizer="adafactor"), NotImplementedError),
    (dict(optimizer="lion"), NotImplementedError),
    (dict(loss_name="nope"), ValueError),
])
def test_unported_options_raise(kw, exc):
    """What the step does not take raises; ``locca_enabled``, which raised
    until the LocCa head was ported, builds the head and trains it
    (tests/test_torch_locca.py holds it against the JAX step)."""
    if exc is not None:
        with pytest.raises(exc):
            tclip.build_clip_bundle(tiny_config(**kw), device="cpu")
        return
    bundle, state = tclip.build_clip_bundle(tiny_config(**kw), device="cpu")
    assert bundle.locca_decoder is not None
    batch = _batch(bundle.config)
    r = np.random.default_rng(3)
    batch.update(caption_ids=r.integers(0, 256, (4, 8)).astype(np.int32),
                 caption_mask=np.ones((4, 8), np.int32))
    state, m = tclip.make_train_step(bundle)(state, tclip.to_device_batch(bundle, batch))
    assert float(m["locca_loss"]) > 0 and float(m["grad_norm_locca_decoder"]) > 0


@pytest.mark.parametrize("loss", ["siglip", "siglip2_bce", "weighted_siglip",
                                  "multi_positive_infonce"])
def test_siglip_losses_build(loss):
    """The SigLIP family builds (tests/test_torch_siglip.py holds it
    against the JAX package)."""
    bundle, state = tclip.build_clip_bundle(tiny_config(loss_name=loss), device="cpu")
    assert float(state.params["logit_bias"].detach()) == bundle.config.siglip_bias_init


def test_entry_point_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tclip.build_clip_bundle(tiny_config())


@pytest.mark.parametrize("mode", ["paired", "paired_masked", "multi_positive"])
def test_alignment_score_matches_jax(mode):
    """Held against train/clip.alignment_score in both modes (rtol 1e-5)."""
    r = np.random.default_rng(7)
    v = r.normal(size=(5, 16)).astype(np.float32)
    t = r.normal(size=(7 if mode == "multi_positive" else 5, 16)).astype(np.float32)
    sm = None if mode == "paired" else np.array([1, 1, 0, 1, 0], np.float32)
    pos = (r.random((5, 7)) > 0.6).astype(np.float32) if mode == "multi_positive" else None

    def opt(a, conv):
        return None if a is None else conv(a)

    ref = jclip.alignment_score(jax.numpy.asarray(v), jax.numpy.asarray(t),
                                positive_mask=opt(pos, jax.numpy.asarray),
                                sample_mask=opt(sm, jax.numpy.asarray))
    got = tclip.alignment_score(torch.from_numpy(v), torch.from_numpy(t),
                                positive_mask=opt(pos, torch.from_numpy),
                                sample_mask=opt(sm, torch.from_numpy))
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5, atol=1e-7)


def test_layer_grad_norms_match_jax():
    """``log_layer_grad_norms``: the step emits one ``grad_norm_video_<name>``
    per child of the video backbone (``block{i}``, ``patch_embed``, ``cls``,
    ``norm``, ...), as train/clip.py:446-455 does: the same metric keys as
    the JAX step, and the same values (rtol 1e-4), over two steps."""
    pair = Pair(log_layer_grad_norms=True)
    jm, tm, _, _, _ = pair.run(2)
    for j, t in zip(jm, tm):
        assert set(t) == set(j)
        blocks = sorted(k for k in j if k.startswith("grad_norm_video_")
                        and k != "grad_norm_video_encoder")
        assert {"grad_norm_video_block0", "grad_norm_video_patch_embed"} <= set(blocks)
        for key in blocks:
            assert t[key] > 0.0, key
            np.testing.assert_allclose(t[key], j[key], err_msg=key, **SCALAR_TOL)
    pair.tcfg.log_layer_grad_norms = False  # off: the per-tower norms only
    bundle, state, step = pair.torch_side()
    _, m = step(state, tclip.to_device_batch(bundle, pair.batch))
    assert "grad_norm_video_encoder" in m and "grad_norm_video_block0" not in m
