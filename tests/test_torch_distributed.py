"""Data parallelism of the port on two ``gloo`` ranks on the CPU, against the
JAX package on a data=2 mesh.

The ranks are ``torch.multiprocessing`` children (``tests/test_torch_ddp_workers.py``,
which imports the port only) joined through a file store under the test's
temporary directory. The JAX side runs here, on
``make_mesh(MeshSpec(data=2, model=1), devices=jax.devices()[:2])`` of the
conftest's CPU devices.

- The host helpers (``parallel/multihost.py``) at world 1 (the identity, as
  the JAX ones with one process) and 2.
- The collectives (``parallel/distributed.py``): the differentiable gather's
  forward against the rows of one process, its gradient (each rank gets
  ``world`` times the one-process gradient of its rows, which the gradient
  average divides out), the gradient average bit-equal on both ranks.
- The padding rule of ``make_batch_sharding_fn`` against the JAX function's
  shards for 5 rows at world 2, replicated keys included; ``local_batch_slice``
  and the loader's own rows.
- One step each of CLIP, SigLIP multi-positive (the bank replicated),
  multitask (LocCa and consistency on, the JAX step's MVM mask handed over)
  and probing (encoder trained) at world 2 against the JAX step on the
  data=2 mesh, on 3-row batches: padded to 4, rank 0 holds 2 real rows and
  rank 1 one real row and the padding row, and the rows' caption tokens
  differ (6, 8, 8). The loss (rtol 1e-4, fp32 sums in another order), every
  gradient leaf (within 1e-4 of the leaf's largest magnitude, 1e-7
  absolute: the tolerance of the one-process tests), every metric of the
  step (rtol 1e-4) and the parameters after the update (atol 3e-5, the key
  bias's middle third left out: its gradient is rounding noise; see
  ``tests/test_torch_train.py``); loss, gradients and parameters are
  bit-equal across the ranks.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from deepcoro_clip_tpu.configs.clip import ClipConfig as JaxClipConfig
from deepcoro_clip_tpu.configs import MultitaskConfig as JaxMultitaskConfig
from deepcoro_clip_tpu.configs.linear_probing import LinearProbingConfig as JaxProbeConfig
from deepcoro_clip_tpu.losses.heads import multi_head_loss as jax_multi_head_loss
from deepcoro_clip_tpu.models import masked_video_modeling as jmvm
from deepcoro_clip_tpu.parallel import MeshSpec, make_mesh
from deepcoro_clip_tpu.parallel import multihost as jmultihost
from deepcoro_clip_tpu.parallel.batching import make_batch_sharding_fn as jax_sharding_fn
from deepcoro_clip_tpu.parallel.mesh import local_batch_slice as jax_local_batch_slice
from deepcoro_clip_tpu.registry import register_all
from deepcoro_clip_tpu.train import clip as jclip
from deepcoro_clip_tpu.train import linear_probe as jprobe
from deepcoro_clip_tpu.train import multitask as jmt

from deepcoro_clip_tpu_torch import convert
from deepcoro_clip_tpu_torch.data.loader import PrefetchLoader
from deepcoro_clip_tpu_torch.data.sampler import ShardedBatchSampler
from deepcoro_clip_tpu_torch.parallel import multihost, distributed
from deepcoro_clip_tpu_torch.parallel.batching import make_batch_sharding_fn, owned_rows
from deepcoro_clip_tpu_torch.parallel.mesh import (
    batch_sharding,
    local_batch_slice,
    pad_to_multiple,
    shard_batch,
)

from tests import test_torch_ddp_workers as workers

register_all()

WORLD = 2
FP32 = dict(rtol=1e-4, atol=1e-5)
PARAM_ATOL = 3e-5
NOISE_LEAF = "_gated/w/bias"  # the probing head's gate bias: a noise gradient


def _mesh():
    return make_mesh(MeshSpec(data=WORLD, model=1), devices=jax.devices()[:WORLD])


# --------------------------------------------------------------------------- #
# host helpers and collectives


def test_multihost_helpers_are_the_identity_at_world_1():
    """No process group: each helper returns its input, as the JAX ones do
    with one process."""
    assert not distributed.is_active() and distributed.world_size() == 1
    objs = ["a", {"b": 1}]
    assert multihost.gather_objects(objs) == jmultihost.gather_objects(objs) == objs
    x = np.arange(6).reshape(3, 2)
    np.testing.assert_array_equal(multihost.gather_arrays(x), jmultihost.gather_arrays(x))
    assert multihost.broadcast_from_host0({"k": 2}) == {"k": 2}
    t = torch.ones(3, requires_grad=True)
    assert distributed.gather_rows(t) is t and distributed.all_reduce_sum(t) is t
    grads = {"g": torch.full((2,), 3.0)}
    distributed.all_reduce_grads(grads)
    assert grads["g"].tolist() == [3.0, 3.0]


@pytest.fixture(scope="module")
def collective_runs(tmp_path_factory):
    return workers.spawn(workers.collectives, WORLD, tmp_path_factory.mktemp("coll"))


def test_multihost_helpers_at_world_2(collective_runs):
    for out in collective_runs:
        assert out["objects"] == ["r0", {"rank": 0}, "r1", {"rank": 1}]
        np.testing.assert_array_equal(out["arrays"], np.array([[0, 0], [1, 1], [1, 1]]))
        assert out["broadcast"] == {"from": 0}


def test_gather_rows_forward_and_gradients_match_one_process(collective_runs):
    """The gathered rows are the one-process batch (exactly); the loss is
    the one-process loss on every rank (rtol 1e-6); each rank's gradient is
    ``world`` times the one-process gradient of its rows (rtol 1e-5)."""
    x_all = torch.from_numpy(collective_runs[0]["x_all"]).requires_grad_(True)
    w = torch.from_numpy(collective_runs[0]["w"])
    loss = (x_all * w).sum() ** 2 / 10.0 + (x_all ** 3).sum() * 0.5
    (g,) = torch.autograd.grad(loss, [x_all])
    for r, out in enumerate(collective_runs):
        np.testing.assert_array_equal(out["gathered"], x_all.detach().numpy())
        np.testing.assert_allclose(out["loss"], float(loss.detach()), rtol=1e-6)
        np.testing.assert_allclose(out["grad"] / WORLD, g[r * 3:(r + 1) * 3].numpy(),
                                   rtol=1e-5)


def test_gradient_average_and_global_ratio(collective_runs):
    """The gradient all-reduce averages, bit-equal on both ranks; the
    global ratio divides the summed numerators by the summed counts."""
    a, b = (out["reduced"] for out in collective_runs)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    np.testing.assert_array_equal(a["a"], np.full((3,), 1.5, np.float32))
    np.testing.assert_array_equal(a["b"], np.full((2, 2), 5.0, np.float32))
    assert [out["ratio"] for out in collective_runs] == [0.75, 0.75]


# --------------------------------------------------------------------------- #
# the batch rule


def _five_row_batch():
    r = np.random.default_rng(3)
    return {
        "videos": r.integers(0, 255, (5, 2, 4, 8, 8, 3)).astype(np.uint8),
        "video_mask": np.array([[1, 1], [1, 0], [1, 1], [1, 1], [0, 1]], bool),
        "positive_mask": (r.random((5, 7)) > 0.5).astype(np.float32),
        "targets_a": r.random(5).astype(np.float32),
        # the bank: 7 rows, replicated
        "input_ids": r.integers(0, 50, (7, 6)).astype(np.int32),
        "attention_mask": np.ones((7, 6), np.int32),
        "text_valid": np.array([1, 1, 1, 1, 1, 0, 0], np.float32),
    }


def test_padding_rule_matches_jax_at_world_2():
    """5 rows at world 2: the JAX function's global arrays (padded by the
    last row, sample_mask 1,1,1,1,1,0) split over the two data devices;
    each port rank's arrays are its device's shard, replicated keys whole."""
    batch = _five_row_batch()
    replicated = ("input_ids", "attention_mask", "text_valid")
    jb = jax_sharding_fn(_mesh(), replicated_keys=replicated)(batch)
    np.testing.assert_array_equal(np.asarray(jb["sample_mask"]), [1, 1, 1, 1, 1, 0])
    devices = jax.devices()[:WORLD]
    for r in range(WORLD):
        tb = make_batch_sharding_fn(WORLD, r, replicated)(batch, torch.device("cpu"))
        assert set(tb) == set(jb)
        for k, v in jb.items():
            shard = [s.data for s in v.addressable_shards if s.device == devices[r]][0]
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(shard), err_msg=k)
            if k in replicated:
                np.testing.assert_array_equal(tb[k].numpy(), batch[k], err_msg=k)
    # world 1: every row, a mask of ones, nothing padded
    one = make_batch_sharding_fn(1, 0, replicated)(batch, torch.device("cpu"))
    np.testing.assert_array_equal(one["videos"].numpy(), batch["videos"])
    assert one["sample_mask"].tolist() == [1.0] * 5


def test_local_batch_slice_and_helpers():
    """The slice of each rank (JAX's over a data axis of one process is the
    whole batch; a rank is one data device here), the sharding function,
    padding and the rows a rank loads."""
    assert jax_local_batch_slice(8, _mesh()) == slice(0, 8)
    assert [local_batch_slice(8, 2, r) for r in (0, 1)] == [slice(0, 4), slice(4, 8)]
    assert [local_batch_slice(9, 3, r) for r in range(3)] == [
        slice(0, 3), slice(3, 6), slice(6, 9)]
    with pytest.raises(ValueError, match="not divisible"):
        local_batch_slice(5, 2, 0)
    assert pad_to_multiple(5, 2) == 6 and pad_to_multiple(6, 4) == 8
    x = np.arange(12).reshape(6, 2)
    np.testing.assert_array_equal(batch_sharding(3, 1)(x), x[2:4])
    tree = shard_batch({"a": x, "b": {"c": np.arange(6)}}, 2, 1)
    np.testing.assert_array_equal(tree["a"], x[3:])
    np.testing.assert_array_equal(tree["b"]["c"], [3, 4, 5])
    assert owned_rows(5, 2, 0) == {0, 1, 2} and owned_rows(5, 2, 1) == {3, 4}
    assert owned_rows(3, 4, 3) == {2} and owned_rows(4, 1, 0) == {0, 1, 2, 3}


class _Items:
    """A dataset whose items name their index and whether their video was
    loaded."""

    def __len__(self):
        return 7

    def __getitem__(self, i):
        return self.get(i)

    def get(self, i, load=True):
        return {"i": i, "loaded": load}


def test_loader_builds_its_own_rows_only():
    """Every rank draws the same global batches; the rows it holds (with
    the padding rule) are built in full, the others without their videos."""
    def batches(shard):
        sampler = ShardedBatchSampler(7, 5, shuffle=True, seed=3, drop_last=False)
        return list(PrefetchLoader(_Items(), sampler, list, num_workers=2, shard=shard))

    one = batches((1, 0))
    assert all(it["loaded"] for b in one for it in b)
    for r in range(WORLD):
        got = batches((WORLD, r))
        assert [[it["i"] for it in b] for b in got] == [[it["i"] for it in b] for b in one]
        for b in got:
            own = owned_rows(len(b), WORLD, r)
            assert [it["loaded"] for it in b] == [j in own for j in range(len(b))]


# --------------------------------------------------------------------------- #
# one train step of each pipeline at world 2 against the JAX step on data=2


CLIP = dict(
    frames=4, resize=32, batch_size=3, multi_video=False, num_videos=1,
    vit_dim=32, vit_depth=1, vit_heads=1, vit_patch=[2, 16, 16], use_cls_token=True,
    text_dim=32, text_depth=1, text_heads=2, text_vocab_size=256, max_text_length=8,
    embedding_dim=16, num_heads=2, aggregator_depth=1, dropout=0.0, lr=1e-3,
    precision="fp32", scheduler_name="cosine", epochs=2, temperature=0.1,
    siglip_max_positive_per_video=2, siglip_negatives_per_video=2,
    siglip_entropy_reg_weight=0.3, siglip_positive_loss_weight=1.3,
    siglip_negative_loss_weight=0.8, siglip_bias_init=-2.0,
)
MULTITASK = dict(
    frames=4, resize=32, batch_size=3, multi_video=True, num_videos=2,
    vit_dim=32, vit_depth=1, vit_heads=1, vit_patch=[2, 16, 16], use_cls_token=True,
    text_dim=32, text_depth=1, text_heads=2, text_vocab_size=256, max_text_length=8,
    embedding_dim=16, num_heads=2, aggregator_depth=1, decoder_dim=16, decoder_depth=2,
    decoder_heads=2, decoder_max_length=8, mvm_decoder_dim=8, mvm_decoder_depth=1,
    dropout=0.0, lr=1e-3, precision="fp32", consistency_weight=0.5, locca_enabled=True,
    label_smoothing=0.1, scheduler_name="cosine", epochs=2,
)
PROBE = dict(
    frames=4, resize=32, batch_size=3, num_videos=3, vit_dim=32, vit_depth=1,
    vit_heads=1, vit_patch=[2, 16, 16], embedding_dim=32, num_heads=2,
    attention_hidden=8, dropout=0.0, dropout_attention=0.0, precision="fp32",
    use_pallas_attention=True, epochs=2, scheduler_name="cosine",
    pooling_mode="attention+cls_token", use_cls_token=True,
    normalization_strategy="pre_norm", lr=0.001,
    head_structure={"stenosis": 1, "stenosis_binary": 1, "CTO": 1},
    loss_structure={"stenosis": "huber", "stenosis_binary": "bce_logit", "CTO": "bce_logit"},
    head_weights={"stenosis": 2.0},
)
WEIGHTS = (1.0, 0.7, 0.4)  # contrastive, captioning, mvm
MT_RNG = jax.random.PRNGKey(7)


def _videos(r, B, N, cfg):
    return r.normal(size=(B, N, cfg["frames"], cfg["resize"], cfg["resize"], 3)
                    ).astype(np.float32)


def _clip_batch(cfg, seed=0):
    r = np.random.default_rng(seed)
    B, L = 3, cfg["max_text_length"]
    att = np.ones((B, L), np.int32)
    att[1, 5:] = 0
    return {"videos": _videos(r, B, 1, cfg), "video_mask": np.ones((B, 1), bool),
            "input_ids": r.integers(0, 256, (B, L)).astype(np.int32),
            "attention_mask": att}


def _bank_batch(cfg, seed=0):
    r = np.random.default_rng(seed)
    B, L = 3, cfg["max_text_length"]
    M = B * (cfg["siglip_max_positive_per_video"] + cfg["siglip_negatives_per_video"])
    att = np.ones((M, L), np.int32)
    att[1, 5:] = 0
    att[-3:, 2:] = 0
    pos = np.zeros((B, M), np.float32)
    pos[0, [0, 1]] = pos[1, 2] = pos[2, [3, 4]] = 1.0
    return {"videos": _videos(r, B, 1, cfg), "video_mask": np.ones((B, 1), bool),
            "input_ids": r.integers(0, 256, (M, L)).astype(np.int32),
            "attention_mask": att, "positive_mask": pos,
            "text_valid": np.r_[np.ones(M - 3), np.zeros(3)].astype(np.float32),
            "positive_weights": r.uniform(0.75, 2.5, (B, M)).astype(np.float32)}


def _multitask_batch(cfg, seed=0):
    r = np.random.default_rng(seed)
    B, N, L, C = 3, cfg["num_videos"], cfg["max_text_length"], cfg["decoder_max_length"]
    vmask = np.ones((B, N), bool)
    vmask[2, 1] = False
    att = np.ones((B, L), np.int32)
    att[1, 5:] = 0
    cap = np.ones((B, C), np.int32)
    cap[0, 6:] = 0  # caption tokens 6, 8, 8: rank 0 holds 14, rank 1 8 (+ the padding)
    return {"videos": _videos(r, B, N, cfg), "video_mask": vmask,
            "input_ids": r.integers(0, 256, (B, L)).astype(np.int32),
            "attention_mask": att,
            "caption_ids": r.integers(0, 256, (B, C)).astype(np.int32),
            "caption_mask": cap,
            "location_mask": (r.random((B, C)) > 0.5).astype(np.float32),
            "caption_weights": np.asarray([1.0, 8.0, 2.0], np.float32)}


def _probe_batch(cfg, seed=0):
    r = np.random.default_rng(seed)
    B, N = 3, cfg["num_videos"]
    mask = np.ones((B, N), bool)
    mask[1, 1:] = False
    return {"videos": _videos(r, B, N, cfg), "video_mask": mask,
            "targets": {"stenosis": r.random(B).astype(np.float32),
                        **{h: (r.random(B) > 0.5).astype(np.float32)
                           for h in ("stenosis_binary", "CTO")}}}


def _flat(tree):
    return convert.flatten_tree(jax.tree_util.tree_map(np.asarray, tree))


def _jax_clip(cfg_dict, batch):
    jcfg = JaxClipConfig.from_dict(dict(cfg_dict, use_pallas_attention=False))

    bundle, state = jclip.build_clip_bundle(jcfg, _mesh(), jax.random.PRNGKey(0),
                                            steps_per_epoch=4)
    bundle = bundle._replace(text_model=bundle.text_model.clone(proj_dropout=0.0))
    init = jax.tree_util.tree_map(np.array, state.params)
    jb = bundle.batch_sharding_fn(batch)

    def loss_fn(params):
        out = jclip.compute_loss(bundle, params, jb, {"dropout": jax.random.PRNGKey(1)},
                                 deterministic=False)
        return out["loss"], out

    def compute():
        (loss, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            jax.tree_util.tree_map(jnp.asarray, init))
        after, metrics = jclip.make_train_step(bundle)(state, jb,
                                                       jax.random.PRNGKey(1), 0.0, 0.0, -1.0)
        return {"loss": float(loss), "grads": _flat(grads),
                "metrics": {k: float(v) for k, v in metrics.items()},
                "params": _flat(after.params)}

    return init, compute


def _jax_multitask(cfg_dict, batch):
    jcfg = JaxMultitaskConfig.from_dict(dict(cfg_dict, use_pallas_attention=False))

    bundle, state = jmt.build_multitask_bundle(jcfg, _mesh(), jax.random.PRNGKey(0),
                                               steps_per_epoch=4)
    bundle = bundle._replace(text_model=bundle.text_model.clone(proj_dropout=0.0))
    init = jax.tree_util.tree_map(np.array, state.params)
    jb = bundle.batch_sharding_fn(batch)
    w_con, w_cap, w_mvm = WEIGHTS

    def loss_fn(params):
        out = jmt.multitask_forward(bundle, params, jb, MT_RNG, deterministic=False)
        return (w_con * out["contrastive"] + w_cap * out["captioning"] + w_mvm * out["mvm"]
                + jcfg.consistency_weight * out["consistency"]), out

    # the JAX step's MVM mask over the padded global batch (4 rows x N clips)
    rows = pad_to_multiple(len(batch["videos"]), WORLD) * cfg_dict["num_videos"]
    mask = np.asarray(jmvm.random_token_mask(
        jax.random.fold_in(MT_RNG, 1), rows, int(init["mvm"]["pos_emb"].shape[1]),
        jcfg.mask_ratio))

    def compute():
        (loss, out), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            jax.tree_util.tree_map(jnp.asarray, init))
        after, metrics = jmt.make_multitask_train_step(bundle)(
            state, jb, MT_RNG, *WEIGHTS, 0.0, 0.0, -1.0)
        terms = {k: float(out[k]) for k in ("contrastive", "captioning", "mvm",
                                            "consistency")}
        return {"loss": float(loss), "terms": terms, "grads": _flat(grads),
                "metrics": {k: float(v) for k, v in metrics.items()},
                "params": _flat(after.params)}

    return init, mask, compute


def _jax_probe(cfg_dict, batch, ratio):
    jcfg = JaxProbeConfig.from_dict(cfg_dict)

    bundle, state = jprobe.build_probe_bundle(jcfg, _mesh(), jax.random.PRNGKey(0),
                                              steps_per_epoch=4)
    init = jax.tree_util.tree_map(np.array, state.params)
    jb = bundle.batch_sharding_fn(batch)

    def loss_fn(params):
        outputs, _ = jprobe.forward_heads(bundle, params, jb,
                                          {"dropout": jax.random.PRNGKey(0)},
                                          deterministic=False)
        losses = jax_multi_head_loss(outputs, jb["targets"], dict(jcfg.loss_structure),
                                     head_weights=dict(jcfg.head_weights),
                                     sample_mask=jb.get("sample_mask"))
        return losses["main"]

    def compute():
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
            jax.tree_util.tree_map(jnp.asarray, init))
        after, metrics = jprobe.make_probe_train_step(bundle)(state, jb,
                                                              jax.random.PRNGKey(0), ratio)
        return {"loss": float(loss), "grads": _flat(grads),
                "metrics": {k: float(v) for k, v in metrics.items()},
                "params": _flat(after.params)}

    return init, compute


STEP_CASES = ("clip", "siglip_multi_positive", "multitask", "probe")


@pytest.fixture(scope="module")
def step_runs(tmp_path_factory):
    """(JAX results, the two ranks' results) for every case; the ranks run
    while the JAX steps compile."""
    import pickle

    spec, compute = {}, {}
    cfg = dict(CLIP, loss_name="clip", label_smoothing=0.1)
    batch = _clip_batch(cfg)
    init, compute["clip"] = _jax_clip(cfg, batch)
    spec["clip"] = {"kind": "clip", "config": dict(cfg, use_pallas_attention=True),
                    "init": init, "batch": batch}
    cfg = dict(CLIP, loss_name="siglip_pairwise")
    batch = _bank_batch(cfg)
    init, compute["siglip_multi_positive"] = _jax_clip(cfg, batch)
    spec["siglip_multi_positive"] = {"kind": "clip",
                                     "config": dict(cfg, use_pallas_attention=True),
                                     "init": init, "batch": batch}
    batch = _multitask_batch(MULTITASK)
    init, mask, compute["multitask"] = _jax_multitask(MULTITASK, batch)
    spec["multitask"] = {"kind": "multitask",
                         "config": dict(MULTITASK, use_pallas_attention=True),
                         "init": init, "batch": batch, "mvm_mask": mask, "weights": WEIGHTS}
    batch = _probe_batch(PROBE)
    init, compute["probe"] = _jax_probe(PROBE, batch, 0.0)
    spec["probe"] = {"kind": "probe", "config": PROBE, "init": init, "batch": batch,
                     "ratio": 0.0}
    out = tmp_path_factory.mktemp("steps")
    with open(out / "spec.pkl", "wb") as f:
        pickle.dump(spec, f)
    wait = workers.start(workers.steps, WORLD, out, str(out / "spec.pkl"))
    want = {name: fn() for name, fn in compute.items()}
    return want, wait()


def _noise(k):
    return k.endswith(NOISE_LEAF)


def _without_key_bias(k, a, b):
    if k.endswith("attn/qkv/bias"):
        n = a.shape[0] // 3
        return np.delete(a, slice(n, 2 * n)), np.delete(b, slice(n, 2 * n))
    return a, b


@pytest.mark.parametrize("case", STEP_CASES)
def test_loss_and_gradients_match_jax_data2(step_runs, case):
    want, ranks = step_runs
    j = want[case]
    for got in (r[case] for r in ranks):
        np.testing.assert_allclose(got["loss"], j["loss"], **FP32)
        if "terms" in j:
            for k, v in j["terms"].items():
                np.testing.assert_allclose(got["terms"][k], v, err_msg=k, **FP32)
        assert got["grads"].keys() == j["grads"].keys()
        for k, g in j["grads"].items():
            scale = max(float(np.abs(g).max()), 1e-6)
            np.testing.assert_allclose(got["grads"][k], g, atol=max(1e-4 * scale, 1e-7),
                                       rtol=0, err_msg=k)


@pytest.mark.parametrize("case", STEP_CASES)
def test_train_step_matches_jax_data2(step_runs, case):
    """Every metric rtol 1e-4; the parameters after the update atol 3e-5
    where the JAX gradient is resolved, that is larger than the gradient
    tolerance above (1e-4 of the leaf's largest magnitude): Adam's first
    step, lr * g / (|g| + eps), follows the rounding noise of a gradient
    within that tolerance of zero, and moves it by up to the full rate."""
    want, ranks = step_runs
    j = want[case]
    for got in (r[case] for r in ranks):
        assert set(got["metrics"]) == set(j["metrics"])
        for k, v in j["metrics"].items():
            np.testing.assert_allclose(got["metrics"][k], v, err_msg=k, **FP32)
        assert got["params"].keys() == j["params"].keys()
        for k, v in j["params"].items():
            if _noise(k):
                continue
            g = j["grads"][k]
            resolved = np.abs(g) > 1e-4 * max(float(np.abs(g).max()), 1e-6)
            a, b = _without_key_bias(k, np.where(resolved, got["params"][k], v), v)
            np.testing.assert_allclose(a, b, atol=PARAM_ATOL, rtol=0, err_msg=k)


@pytest.mark.parametrize("case", STEP_CASES)
def test_ranks_agree_bit_for_bit(step_runs, case):
    """Loss, every gradient, every metric and every parameter after the
    update: the same bits on both ranks."""
    _, (a, b) = step_runs
    a, b = a[case], b[case]
    assert a["loss"] == b["loss"] and a["metrics"] == b["metrics"]
    for key in ("grads", "params"):
        for k in a[key]:
            np.testing.assert_array_equal(a[key][k], b[key][k], err_msg=k)
