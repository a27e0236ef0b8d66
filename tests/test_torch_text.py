"""The port's text tower and contrastive loss against the JAX package.

Text tower: ``deepcoro_clip_tpu.models.text_encoder.TextEncoder`` is
initialized at small sizes, its tree goes through
``deepcoro_clip_tpu_torch.convert`` (``load_state_dict(strict=True)``), and
both sides run the same numpy token ids in fp32; outputs agree to atol 1e-4
(rtol 1e-5), the tolerance of tests/test_torch_models.py. One case has a
head dim of 128, so both sides take the packed attention (the JAX side its
Pallas kernel in interpret mode through ``backend="auto"`` on the CPU).

Loss: ``losses.contrastive.clip_loss`` values and gradients against
``jax.value_and_grad`` of the JAX function, fp32, atol 1e-6 / rtol 1e-5.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepcoro_clip_tpu.flagship import tiny_config as jax_tiny
from deepcoro_clip_tpu.losses import contrastive as jloss
from deepcoro_clip_tpu.models import text_encoder as jte

from deepcoro_clip_tpu_torch import convert
from deepcoro_clip_tpu_torch.flagship import tiny_config
from deepcoro_clip_tpu_torch.losses import contrastive as tloss
from deepcoro_clip_tpu_torch.models import text_encoder as tte
from deepcoro_clip_tpu_torch.models.video_encoder import init_params

TOL = dict(atol=1e-4, rtol=1e-5)

TEXT = {
    "dh32": dict(text_dim=64, text_heads=2),
    # the flagship's dispatch at small size: Dh 128, the packed kernel's path
    "packed_dh128": dict(text_dim=128, text_heads=1, use_pallas_attention=True),
    "flash_dh32": dict(text_dim=64, text_heads=2, use_pallas_attention=True),
}


@pytest.fixture(scope="module", params=sorted(TEXT))
def towers(request):
    kw = TEXT[request.param]
    jm = jte.text_encoder_from_config(jax_tiny(**kw))
    tm = tte.text_encoder_from_config(tiny_config(**kw))
    r = np.random.default_rng(0)
    ids = r.integers(0, 256, size=(3, 16)).astype(np.int32)
    att = np.ones((3, 16), np.int32)
    att[1, 5:], att[2, 11:] = 0, 0
    params = jm.init({"params": jax.random.PRNGKey(1), "dropout": jax.random.PRNGKey(1)},
                     jnp.asarray(ids), attention_mask=jnp.asarray(att))["params"]
    tree = jax.tree_util.tree_map(np.asarray, fnn.unbox(params))
    tm.load_state_dict(convert.jax_tree_to_state_dict(tree), strict=True)
    return jm, params, tm.eval(), ids, att, tree


@pytest.mark.parametrize("return_hidden", [False, True])
def test_text_encoder_matches_jax(towers, return_hidden):
    jm, params, tm, ids, att, _ = towers
    ref = jm.apply({"params": params}, jnp.asarray(ids), attention_mask=jnp.asarray(att),
                   return_hidden=return_hidden)
    with torch.no_grad():
        got = tm(torch.from_numpy(ids), attention_mask=torch.from_numpy(att),
                 return_hidden=return_hidden)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_text_tree_round_trips(towers):
    *_, tm, _, _, tree = towers
    back = convert.flatten_tree(convert.module_to_jax_tree(tm))
    flat = convert.flatten_tree(tree)
    assert back.keys() == flat.keys()
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)


def test_text_encoder_training_mode_draws_from_the_generator():
    tm = init_params(tte.text_encoder_from_config(tiny_config(dropout=0.3)), seed=2)
    ids = torch.arange(32).reshape(2, 16)
    att = torch.ones(2, 16, dtype=torch.int32)

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        return tm(ids, attention_mask=att, deterministic=False, generator=g)

    a, b, c = run(0), run(0), run(1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a, tm(ids, attention_mask=att))  # dropout was on
    assert tm.position_embeddings.shape[0] == 512  # max(512, max_text_length)


# --------------------------------------------------------------------------- #
# clip_loss


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("masked", [False, True])
def test_clip_loss_values_and_gradients_match_jax(smoothing, masked):
    r = np.random.default_rng(3)
    v, t = r.normal(size=(6, 32)).astype(np.float32), r.normal(size=(6, 32)).astype(np.float32)
    lt = np.float32(np.log(0.07))
    sm = np.array([1, 1, 0, 1, 1, 0], np.float32) if masked else None

    def jf(v, t, lt):
        return jloss.clip_loss(v, t, lt, label_smoothing=smoothing,
                               sample_mask=None if sm is None else jnp.asarray(sm))["loss"]

    ref, gref = jax.value_and_grad(jf, argnums=(0, 1, 2))(
        jnp.asarray(v), jnp.asarray(t), jnp.asarray(lt))
    leaves = [torch.tensor(a, requires_grad=True) for a in (v, t, lt)]
    out = tloss.clip_loss(*leaves, label_smoothing=smoothing,
                          sample_mask=None if sm is None else torch.from_numpy(sm))
    got = torch.autograd.grad(out["loss"], leaves)
    np.testing.assert_allclose(float(out["loss"].detach()), float(ref), atol=1e-6, rtol=1e-5)
    for g, gr in zip(got, gref):
        np.testing.assert_allclose(g.numpy(), np.asarray(gr), atol=1e-6, rtol=1e-5)
    jout = jloss.clip_loss(jnp.asarray(v), jnp.asarray(t), jnp.asarray(lt))
    np.testing.assert_allclose(float(out["temperature"].detach()), float(jout["temperature"]),
                               rtol=1e-6)
    if masked:  # padded rows are no anchors and no negatives
        assert float(got[0][2].abs().max()) == 0.0 and float(got[1][5].abs().max()) == 0.0


def test_clip_loss_clamps_the_temperature():
    v = torch.eye(4, 8)
    out = tloss.clip_loss(v, v, torch.tensor(-20.0))
    assert float(out["temperature"]) == pytest.approx(1e-4)
    ref = jloss.clip_loss(jnp.eye(4, 8), jnp.eye(4, 8), jnp.float32(-20.0))
    np.testing.assert_allclose(float(out["loss"]), float(ref["loss"]), atol=1e-6)
