"""The port's captioning parts against the JAX package, on the CPU: the
decoder and its generation, masked video modeling, the captioning and
LocCa losses, the task-weight schedule, the LocCa location mask, the
stenosis-aware caption weights and the caption metrics.

Modules take the same weights (JAX trees through
``deepcoro_clip_tpu_torch.convert``) and the same seeded numpy inputs as
their JAX counterparts; the JAX side runs its XLA attention
(``use_flash=False``), the port's side its kernel wrappers, whose plain
versions run on CPU tensors, or (where a test says so) its plain attention.
The JAX package draws the MVM mask from ``jax.random``, which torch cannot
reproduce: the MVM test hands both modules the JAX mask.

Tolerances, stated at each test: fp32 values rtol 1e-4 or atol 1e-5 (fp32
sums in another order); bf16 logits within 2% of their largest magnitude
(bf16 rounds to 2^-8 relative at each of the decoder's products, in another
order in each framework); token ids, masks, weights and caption metrics
exact.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepcoro_clip_tpu.data import locca as jlocca
from deepcoro_clip_tpu.data.tokenizer import get_tokenizer as jax_get_tokenizer
from deepcoro_clip_tpu.losses import locca as jlocca_loss
from deepcoro_clip_tpu.losses import multitask as jmt_loss
from deepcoro_clip_tpu.models import captioning_decoder as jdec
from deepcoro_clip_tpu.models import masked_video_modeling as jmvm
from deepcoro_clip_tpu.utils import caption_metrics as jcm
from deepcoro_clip_tpu.utils.stenosis_extractor import StenosisExtractor as JaxExtractor

from deepcoro_clip_tpu_torch import convert
from deepcoro_clip_tpu_torch.data import locca as tlocca
from deepcoro_clip_tpu_torch.data.tokenizer import get_tokenizer
from deepcoro_clip_tpu_torch.losses import locca as tlocca_loss
from deepcoro_clip_tpu_torch.losses import multitask as tmt_loss
from deepcoro_clip_tpu_torch.models import captioning_decoder as tdec
from deepcoro_clip_tpu_torch.models import masked_video_modeling as tmvm
from deepcoro_clip_tpu_torch.utils import caption_metrics as tcm
from deepcoro_clip_tpu_torch.utils.stenosis_extractor import StenosisExtractor

FP32 = dict(rtol=1e-4, atol=1e-5)
REPORTS = [
    "Severe 80% stenosis of the proximal LAD. The mid RCA shows mild 30% disease; "
    "chronic total occlusion of the distal RCA.",
    "normal coronary arteries",
    "moderate calcifications in the mid lad",
    "70.0 % stenosis in the first obtuse marginal; 95% lesion of the left main",
    "Left main: 50-70% narrowing. PDA normal.",
    "",
]


def _state_dict(jax_params):
    return convert.jax_tree_to_state_dict(
        jax.tree_util.tree_map(np.asarray, nn.unbox(jax_params)))


# --------------------------------------------------------------------------- #
# host helpers: stenosis weights, location masks, caption metrics (exact)


def test_stenosis_extractor_matches_jax():
    t, j = StenosisExtractor(), JaxExtractor()
    for text in REPORTS:
        assert t.max_severity_weight(text) == j.max_severity_weight(text), text
        tf, jf = t.extract(text), j.extract(text)
        assert {k: vars(v) for k, v in tf.items()} == {k: vars(v) for k, v in jf.items()}


@pytest.mark.parametrize("vocab", [512, 30522])
def test_location_mask_matches_jax(vocab):
    """Hash tokenizer (vocab 512) and WordPiece (30522): the LocCa batch's
    ids, mask and location mask equal the JAX package's."""
    tt = get_tokenizer(vocab_size=vocab, max_length=24)
    jt = jax_get_tokenizer(vocab_size=vocab, max_length=24)
    assert type(tt).__name__ == type(jt).__name__
    got = tlocca.locca_caption_batch(REPORTS, tt, 24)
    want = jlocca.locca_caption_batch(REPORTS, jt, 24)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["location_mask"].sum() > 0


def test_caption_metrics_match_jax():
    r = np.random.default_rng(3)
    words = "the lad rca is normal severe stenosis of proximal mid".split()
    cands = [" ".join(r.choice(words, r.integers(0, 9))) for _ in range(12)]
    refs = [" ".join(r.choice(words, r.integers(1, 9))) for _ in range(12)]
    cands[0], refs[0] = "the lad is normal", "the lad is normal"
    assert tcm.captioning_metrics(cands, refs) == jcm.captioning_metrics(cands, refs)
    perfect = tcm.captioning_metrics(["the lad is normal"], ["the lad is normal"])
    assert perfect["bleu1"] == pytest.approx(1.0) and perfect["rouge_l"] == pytest.approx(1.0)


# --------------------------------------------------------------------------- #
# losses (fp32, rtol 1e-4)


def _loss_inputs(B=3, L=7, V=11, seed=0):
    r = np.random.default_rng(seed)
    logits = r.normal(size=(B, L, V)).astype(np.float32) * 3
    ids = r.integers(0, V, (B, L)).astype(np.int32)
    mask = np.ones((B, L), np.int32)
    mask[1, 4:] = 0
    loc = (r.random((B, L)) > 0.6).astype(np.float32)
    w = np.asarray([1.0, 8.0, 0.0], np.float32)
    return logits, ids, mask, loc, w


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("weighted", [False, True])
def test_captioning_loss_matches_jax(smoothing, weighted):
    logits, ids, mask, _, w = _loss_inputs()
    sw = w if weighted else None
    want = jmt_loss.captioning_loss(jnp.asarray(logits), jnp.asarray(ids),
                                    jnp.asarray(mask), smoothing,
                                    None if sw is None else jnp.asarray(sw))
    got = tmt_loss.captioning_loss(torch.from_numpy(logits), torch.from_numpy(ids),
                                   torch.from_numpy(mask), smoothing,
                                   None if sw is None else torch.from_numpy(sw))
    np.testing.assert_allclose(float(got), float(want), **FP32)


@pytest.mark.parametrize("with_location", [False, True])
def test_locca_losses_match_jax(with_location):
    logits, ids, mask, loc, w = _loss_inputs(seed=1)
    weights = {"captioning": 1.0, "referring": 0.5, "grounded": 0.25}
    jl = jnp.asarray(loc) if with_location else None
    tl = torch.from_numpy(loc) if with_location else None
    want = jlocca_loss.locca_combined_loss(
        jnp.asarray(logits), jnp.asarray(ids), jnp.asarray(mask), jl, weights, 0.1,
        jnp.asarray(w))
    got = tlocca_loss.locca_combined_loss(
        torch.from_numpy(logits), torch.from_numpy(ids), torch.from_numpy(mask), tl,
        weights, 0.1, torch.from_numpy(w))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), err_msg=k, **FP32)
    if with_location:  # the single-task functions agree with the combined terms
        args = (torch.from_numpy(logits), torch.from_numpy(ids), torch.from_numpy(mask), tl)
        np.testing.assert_allclose(float(tlocca_loss.locca_referring_expression_loss(
            *args, sample_weights=torch.from_numpy(w))), float(got["referring"]), **FP32)
        np.testing.assert_allclose(float(tlocca_loss.locca_grounded_captioning_loss(
            *args, 0.1, torch.from_numpy(w))), float(got["grounded"]), **FP32)
        np.testing.assert_allclose(float(tlocca_loss.locca_captioning_loss(
            *args[:3], 0.1, torch.from_numpy(w))), float(got["captioning"]), **FP32)


def test_loss_weight_scheduler_and_sum_match_jax():
    base = {"contrastive": 1.0, "captioning": 0.5, "mvm": 1.0}
    sched = {"mvm": [[10, 0.25], [0, 2.0], [30, 0.0]], "captioning": [[5, 1.5]]}
    t, j = tmt_loss.LossWeightScheduler(base, sched), jmt_loss.LossWeightScheduler(base, sched)
    for step in (0, 4, 5, 9, 10, 29, 30, 100):
        assert t.at(step) == j.at(step), step
    losses = {"contrastive": 1.5, "captioning": 2.25, "mvm": 0.5}
    got = tmt_loss.multitask_loss({k: torch.tensor(v) for k, v in losses.items()},
                                  t.at(12))
    want = jmt_loss.multitask_loss({k: jnp.float32(v) for k, v in losses.items()},
                                   j.at(12))
    np.testing.assert_allclose(float(got["total"]), float(want["total"]), rtol=1e-6)


# --------------------------------------------------------------------------- #
# the captioning decoder and generation


DEC = dict(vocab_size=64, dim=32, depth=2, num_heads=2, max_length=10, memory_dim=16,
           dropout=0.0)


def _decoder_pair(dtype="fp32", use_flash=True, seed=0):
    jd = jdec.CaptioningDecoder(**DEC, dtype=jnp.float32 if dtype == "fp32"
                                else jnp.bfloat16, use_flash=False)
    r = np.random.default_rng(seed)
    ids = r.integers(3, 64, (3, 10)).astype(np.int32)
    mask = np.ones((3, 10), np.int32)
    mask[1, 6:] = 0
    mem = r.normal(size=(3, 7, 16)).astype(np.float32)
    params = jd.init(jax.random.PRNGKey(seed), jnp.asarray(ids), jnp.asarray(mem))
    td = tdec.CaptioningDecoder(**DEC, dtype=torch.float32 if dtype == "fp32"
                                else torch.bfloat16, use_flash=use_flash)
    td.load_state_dict(_state_dict(params["params"]), strict=True)
    return jd, params, td, ids, mask, mem


@pytest.mark.parametrize("use_flash", [True, False])
def test_decoder_logits_match_jax_fp32(use_flash):
    """fp32, with and without the captions' padding mask: atol 1e-5. The
    port's kernel wrapper (plain version on the CPU) and its plain attention
    both."""
    jd, params, td, ids, mask, mem = _decoder_pair(use_flash=use_flash)
    for m in (None, mask):
        want = jd.apply(params, jnp.asarray(ids), jnp.asarray(mem),
                        attention_mask=None if m is None else jnp.asarray(m))
        got = td(torch.from_numpy(ids), torch.from_numpy(mem),
                 attention_mask=None if m is None else torch.from_numpy(m))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-5)


def test_decoder_logits_match_jax_bf16():
    """bf16 compute (fp32 LayerNorm and LM head): within 2% of the largest
    logit magnitude."""
    jd, params, td, ids, mask, mem = _decoder_pair(dtype="bf16")
    want = np.asarray(jd.apply(params, jnp.asarray(ids), jnp.asarray(mem),
                               attention_mask=jnp.asarray(mask)))
    got = td(torch.from_numpy(ids), torch.from_numpy(mem),
             attention_mask=torch.from_numpy(mask)).detach().numpy()
    assert np.abs(got - want).max() <= 0.02 * np.abs(want).max()


def test_decoder_is_causal():
    """Changing a token moves no earlier position's logits (exactly) and
    moves that position's."""
    _, _, td, ids, mask, mem = _decoder_pair()
    ids2 = ids.copy()
    ids2[:, 5] = (ids2[:, 5] + 1) % 64
    a = td(torch.from_numpy(ids), torch.from_numpy(mem), torch.from_numpy(mask))
    b = td(torch.from_numpy(ids2), torch.from_numpy(mem), torch.from_numpy(mask))
    assert torch.equal(a[:, :5], b[:, :5])
    assert not torch.allclose(a[:, 5:], b[:, 5:])


def test_generation_matches_jax():
    """Greedy decoding by recompute and with the K/V cache give the JAX
    package's token ids exactly, and the cached path equals the recompute
    path; BOS first, 0 after EOS."""
    jd, params, td, _, _, mem = _decoder_pair(seed=4)
    eos = int(np.asarray(jd.apply(params, jnp.full((3, 1), 1, jnp.int32),
                                  jnp.asarray(mem))[0, 0]).argmax())
    want = np.asarray(jdec.greedy_generate(jd, params, jnp.asarray(mem), 1, eos, 9))
    want_kv = np.asarray(jdec.greedy_generate_kv(jd, params, jnp.asarray(mem), 1, eos, 9))
    got = tdec.greedy_generate(td, torch.from_numpy(mem), 1, eos, 9).numpy()
    got_kv = tdec.greedy_generate_kv(td, torch.from_numpy(mem), 1, eos, 9).numpy()
    np.testing.assert_array_equal(want, want_kv)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_kv, want)
    assert (got_kv[:, 0] == 1).all() and got_kv.dtype == np.int32
    row = got_kv[0]
    assert (row[1] == eos) and (row[2:] == 0).all()  # EOS at once on row 0, then 0s


def test_sampled_generation_is_seeded():
    _, _, td, _, _, mem = _decoder_pair(seed=5)
    m = torch.from_numpy(mem)

    def run(seed):
        return tdec.greedy_generate_kv(td, m, 1, 2, 8, temperature=1.0,
                                       generator=torch.Generator().manual_seed(seed))

    assert torch.equal(run(0), run(0))
    assert not torch.equal(run(0), run(1))


# --------------------------------------------------------------------------- #
# masked video modeling


def test_random_token_mask_count_and_seed():
    g = torch.Generator().manual_seed(0)
    m = tmvm.random_token_mask(g, 4, 20, 0.75)
    assert m.shape == (4, 20) and m.dtype == torch.bool
    assert m.sum(1).tolist() == [15] * 4
    m2 = tmvm.random_token_mask(torch.Generator().manual_seed(0), 4, 20, 0.75)
    assert torch.equal(m, m2)
    # round(L * ratio) with Python's rounding, as in the JAX function
    for L, ratio in ((10, 0.25), (393, 0.75), (7, 0.5)):
        got = tmvm.random_token_mask(g, 2, L, ratio).sum(1)
        want = np.asarray(jmvm.random_token_mask(jax.random.PRNGKey(0), 2, L, ratio)).sum(1)
        assert got.tolist() == want.tolist() == [int(round(L * ratio))] * 2


@pytest.mark.parametrize("norm_targets", [True, False])
def test_mvm_matches_jax_with_the_same_mask(norm_targets):
    """The JAX mask handed to both: loss and prediction, fp32, atol 1e-5."""
    jm = jmvm.MaskedVideoModeling(dim=16, decoder_dim=8, decoder_depth=2, num_heads=2,
                                  norm_targets=norm_targets, dtype=jnp.float32)
    r = np.random.default_rng(0)
    toks = r.normal(size=(3, 10, 16)).astype(np.float32)
    mask = np.asarray(jmvm.random_token_mask(jax.random.PRNGKey(1), 3, 10, 0.6))
    want, params = jm.init_with_output(jax.random.PRNGKey(0), jnp.asarray(toks),
                                       jnp.asarray(mask))
    tm = tmvm.MaskedVideoModeling(dim=16, num_tokens=10, decoder_dim=8, decoder_depth=2,
                                  num_heads=2, norm_targets=norm_targets,
                                  dtype=torch.float32)
    tm.load_state_dict(_state_dict(params["params"]), strict=True)
    got = tm(torch.from_numpy(toks), torch.from_numpy(mask))
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), **FP32)
    np.testing.assert_allclose(got["pred"].detach().numpy(), np.asarray(want["pred"]),
                               atol=1e-5, rtol=1e-5)
