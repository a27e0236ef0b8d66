"""The port's SigLIP slice against the JAX package, on the CPU.

Each piece takes the same numpy inputs (made from a seed) in both packages:

- every loss of the SigLIP family: the loss and its gradients with respect
  to both embeddings, ``log_temp`` and ``logit_bias``, fp32, rtol 1e-5
  (atol 1e-7 for entries that are rounding noise around zero), over padded
  ``text_valid``, ``sample_mask``, weights, the clamp, ``auto_balance`` and
  the entropy regularizer;
- ``collate_multi_positive`` arrays, ``SiglipVideoDataset`` items,
  ``ClassAwareBatchSampler`` index sequences, ``SiglipRuntimeSettings``
  and ``build_siglip_manifests`` rows: equal;
- ``compute_semantic_metrics``: equal (rtol 1e-12, the same float sums);
- one train step for ``siglip_pairwise``, ``siglip`` (study batches) and
  ``multi_positive_infonce``: the loss and every gradient leaf (within
  1e-4 of the leaf's largest magnitude), the metrics (rtol 1e-4) and the
  parameters after the update (atol 3e-5, as ``tests/test_torch_train.py``
  states), fp32, dropout 0;
- the runner over 2 epochs on manifests built from a rendered corpus,
  against the JAX runner: per-epoch metrics, the semantic panel included,
  rtol 1e-4; resume through ``main`` bit-equal.

The corpus glue (a clip's findings as per-segment percent columns) is
``chip_smoke.siglip_rows``, the one phase 24 runs on the card.
"""

import dataclasses
import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
import yaml

from deepcoro_clip_tpu.configs.clip import ClipConfig as JaxClipConfig
from deepcoro_clip_tpu.configs.parser import parse_config as jax_parse_config
from deepcoro_clip_tpu.data import collate as jcollate
from deepcoro_clip_tpu.data import dataset_creation as jcreate
from deepcoro_clip_tpu.data import datasets as jdatasets
from deepcoro_clip_tpu.data import sampler as jsampler
from deepcoro_clip_tpu.data import siglip as jsiglip
from deepcoro_clip_tpu.data.siglip_runtime import SiglipRuntimeSettings as JaxRuntime
from deepcoro_clip_tpu.data.tokenizer import get_tokenizer as jax_tokenizer
from deepcoro_clip_tpu.losses import contrastive as jloss
from deepcoro_clip_tpu.parallel import MeshSpec, make_mesh
from deepcoro_clip_tpu.registry import register_all
from deepcoro_clip_tpu.runners.contrastive import VideoContrastiveLearningRunner as JaxRunner
from deepcoro_clip_tpu.train import clip as jclip
from deepcoro_clip_tpu.utils.semantic_metrics import compute_semantic_metrics as jsemantic

import chip_smoke
from deepcoro_clip_tpu_torch import configs as tconfigs
from deepcoro_clip_tpu_torch import convert
from deepcoro_clip_tpu_torch.data import collate as tcollate
from deepcoro_clip_tpu_torch.data import dataset_creation as tcreate
from deepcoro_clip_tpu_torch.data import datasets as tdatasets
from deepcoro_clip_tpu_torch.data import sampler as tsampler
from deepcoro_clip_tpu_torch.data import siglip as tsiglip
from deepcoro_clip_tpu_torch.data.csv_utils import read_csv_with_fallback
from deepcoro_clip_tpu_torch.data.siglip_runtime import SiglipRuntimeSettings
from deepcoro_clip_tpu_torch.data.synthetic_angio import generate_corpus, write_study_manifest
from deepcoro_clip_tpu_torch.data.tokenizer import get_tokenizer
from deepcoro_clip_tpu_torch.losses import contrastive as tloss
from deepcoro_clip_tpu_torch.main import main
from deepcoro_clip_tpu_torch.ops.flash_attention import flash_attention, kernel_head_dim
from deepcoro_clip_tpu_torch.registry import LossRegistry
from deepcoro_clip_tpu_torch.runners import contrastive as trun
from deepcoro_clip_tpu_torch.train import clip as tclip
from deepcoro_clip_tpu_torch.utils.semantic_metrics import compute_semantic_metrics

register_all()

REPO = Path(__file__).resolve().parents[1]
LOSS_TOL = dict(rtol=1e-5, atol=1e-7)
FP32 = dict(rtol=1e-4, atol=1e-6)
PARAM_ATOL = 3e-5
RUN_RTOL = 1e-4


# --------------------------------------------------------------------------- #
# the losses


def _loss_inputs(seed=0, B=4, M=10, D=8):
    r = np.random.default_rng(seed)
    pos = np.zeros((B, M), np.float32)
    for i in range(B):
        pos[i, r.choice(M - 3, size=1 + i % 3, replace=False)] = 1.0
    return {
        "video_emb": r.normal(size=(B, D)).astype(np.float32),
        "text_emb": r.normal(size=(M, D)).astype(np.float32),
        "positive_mask": pos,
        "positive_weights": r.uniform(0.5, 2.5, size=(B, M)).astype(np.float32),
        "text_valid": np.r_[np.ones(M - 3), np.zeros(3)].astype(np.float32),
        "sample_mask": np.r_[np.ones(B - 1), np.zeros(1)].astype(np.float32),
        # a temperature of 0.05 and a bias of -2 put logits on both sides of 0
        "log_temp": np.float32(np.log(0.05)),
        "bias": np.float32(-2.0),
    }


# (loss name, keyword arguments beyond the embeddings; "pairwise": the square
# siglip loss, which takes no bank)
LOSS_CASES = [
    ("siglip_pairwise", {}),
    ("siglip_pairwise", dict(positive_weights=1, text_valid=1, sample_mask=1,
                             positive_loss_weight=1.5, negative_loss_weight=0.7)),
    ("siglip_pairwise", dict(text_valid=1, logit_clamp=2.0)),
    ("siglip_pairwise", dict(text_valid=1, sample_mask=1, auto_balance=True)),
    ("siglip_pairwise", dict(auto_balance=True, positive_weights=1)),
    ("siglip_pairwise", dict(text_valid=1, entropy_reg_weight=0.5)),
    ("siglip2_bce", dict(positive_weights=1, text_valid=1, entropy_reg_weight=0.01)),
    ("siglip_single_head", dict(positive_weights=1, text_valid=1, sample_mask=1)),
    ("siglip_single_head", dict(entropy_reg_weight=0.3, logit_clamp=3.0)),
    ("weighted_siglip", dict(positive_weights=1, text_valid=1, sample_mask=1)),
    ("weighted_siglip", {}),
    ("multi_positive_infonce", dict(positive_weights=1, text_valid=1, sample_mask=1)),
    ("multi_positive_infonce", {}),
    ("siglip", {}),
    ("siglip", dict(sample_mask=1, logit_clamp=4.0)),
]


def _call(mod, registry_get, name, x, kw, xp):
    """Both packages' loss ``name`` on the inputs ``x`` (converted by
    ``xp``), the arrays ``kw`` asks for by a 1 taken from ``x``."""
    args = {k: (xp(x[k]) if v == 1 and k in x else v) for k, v in kw.items()}
    if name in ("siglip", "siglip_ddp"):
        B = x["video_emb"].shape[0]
        if "sample_mask" in args:
            args["sample_mask"] = xp(x["sample_mask"])
        return mod.siglip_pairwise_loss(xp(x["video_emb"]), xp(x["text_emb"][:B]),
                                        xp(x["log_temp"]), xp(x["bias"]), **args)
    fn = registry_get(name)
    if name == "multi_positive_infonce":
        return fn(xp(x["video_emb"]), xp(x["text_emb"]), xp(x["positive_mask"]),
                  xp(x["log_temp"]), **args)
    return fn(xp(x["video_emb"]), xp(x["text_emb"]), positive_mask=xp(x["positive_mask"]),
              log_temp=xp(x["log_temp"]), bias=xp(x["bias"]), **args)


@pytest.mark.parametrize("name,kw", LOSS_CASES,
                         ids=[f"{n}-{'-'.join(sorted(k)) or 'plain'}" for n, k in LOSS_CASES])
def test_loss_and_gradients_match_jax(name, kw):
    """The loss, ``similarity`` and the gradients with respect to the video
    and text embeddings, ``log_temp`` and the bias, against jax.grad."""
    from deepcoro_clip_tpu.registry import LossRegistry as JaxLossRegistry

    x = _loss_inputs()
    keys = ("video_emb", "text_emb", "log_temp", "bias")

    def jfn(v, t, lt, b):
        y = dict(x, video_emb=v, text_emb=t, log_temp=lt, bias=b)
        out = _call(jloss, JaxLossRegistry.get, name, y, kw, lambda a: a)
        return out["loss"], out["similarity"]

    (jl, jsim), jg = jax.value_and_grad(jfn, argnums=(0, 1, 2, 3), has_aux=True)(
        *(jnp.asarray(x[k]) for k in keys))
    leaves = {k: torch.tensor(np.asarray(x[k]), requires_grad=True) for k in keys}
    y = dict(x, **leaves)
    out = _call(tloss, LossRegistry.get, name, y, kw,
                lambda a: a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a)))
    assert out["loss"].dtype == torch.float32
    np.testing.assert_allclose(float(out["loss"].detach()), float(jl), **LOSS_TOL)
    np.testing.assert_allclose(out["similarity"].detach().numpy(), np.asarray(jsim),
                               rtol=1e-5, atol=1e-5)
    got = torch.autograd.grad(out["loss"], [leaves[k] for k in keys], allow_unused=True)
    for k, g, j in zip(keys, got, jg):
        g = np.zeros_like(x[k]) if g is None else g.numpy()
        np.testing.assert_allclose(g, np.asarray(j), err_msg=k, **LOSS_TOL)
    assert np.any(np.asarray(jg[0]) != 0)


@pytest.mark.parametrize("weight,masked", [(0.0, False), (0.2, False), (0.2, True),
                                           (5.0, True)])
def test_entropy_regularization_matches_jax(weight, masked):
    r = np.random.default_rng(3)
    sim = (r.normal(size=(5, 9)) * 4).astype(np.float32)
    mask = np.r_[np.ones(6), np.zeros(3)].astype(np.float32) if masked else None
    j = jloss.entropy_regularization(jnp.asarray(sim), weight,
                                     col_mask=None if mask is None else jnp.asarray(mask))
    t = tloss.entropy_regularization(torch.from_numpy(sim), weight,
                                     col_mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(float(t), float(j), **LOSS_TOL)


def test_loss_registry_names_match_jax():
    from deepcoro_clip_tpu.registry import LossRegistry as JaxLossRegistry

    contrastive = {k for k, fn in JaxLossRegistry._registry.items()
                   if fn.__module__ == jloss.__name__}
    assert set(LossRegistry._registry) == contrastive
    for k, fn in LossRegistry._registry.items():
        assert fn.__name__ == JaxLossRegistry.get(k).__name__, k
    assert tclip.MULTI_POSITIVE_LOSSES == jclip.MULTI_POSITIVE_LOSSES
    assert tclip.MULTI_POSITIVE_LOSSES <= set(LossRegistry._registry)


# --------------------------------------------------------------------------- #
# the data layer: manifests, resources, dataset, collate, sampler, settings


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A rendered corpus of 16 train + 8 val clips of 4 x 32 x 32, and the
    SigLIP manifests both packages build from its clips' findings."""
    root = tmp_path_factory.mktemp("siglip_corpus")
    manifest = generate_corpus(root / "corpus", n_train=16, n_val=8, size=32, frames=4,
                               seed=0)
    rows = chip_smoke.siglip_rows(manifest, seed=0)
    cto = chip_smoke.siglip_cto_columns()
    tpaths = tcreate.build_siglip_manifests(rows, root / "port", cto_columns=cto)
    jpaths = jcreate.build_siglip_manifests(pd.DataFrame(rows), root / "jax",
                                            cto_columns=cto)
    return {"root": root, "manifest": manifest, "rows": rows, "port": tpaths,
            "jax": jpaths}


def _rows(path):
    return [tuple(r) for r in pd.read_csv(path, keep_default_na=False).astype(str)
            .itertuples(index=False)]


def test_build_siglip_manifests_rows_match_jax(corpus):
    for kind in ("texts", "edges", "videos"):
        want = pd.read_csv(corpus["jax"][kind])
        got = pd.read_csv(corpus["port"][kind])
        assert list(got.columns) == list(want.columns), kind
        assert _rows(corpus["port"][kind]) == _rows(corpus["jax"][kind]), kind
    texts = pd.read_csv(corpus["port"]["texts"])
    # the corpus reaches every severity the synthetic findings have
    assert {"normal", "cto"} <= set(texts["disease_severity"])
    assert len(pd.read_csv(corpus["port"]["edges"])) >= len(corpus["rows"])


def test_canonical_prompt_matches_jax():
    for args in (("prox_lad", "severe", 73.0, False), ("d1", "normal", 0.0, False),
                 ("mid_rca", "cto", 100.0, True), ("odd_segment", "mild", None, False)):
        assert tcreate.canonical_prompt(*args) == jcreate.canonical_prompt(*args)
    assert tcreate.SEGMENT_INFO == jcreate.SEGMENT_INFO


def _resources(pkg, paths, **kw):
    return pkg.SiglipResources(str(paths["texts"]), str(paths["edges"]), **kw)


def _same_pairs(a, b):
    """Lists of (text, weight): the same texts in the same order, weights to
    2 ulp (pandas' default CSV float parser, which the JAX package reads
    edges.csv with, may round the last digit of a written weight such as
    1.6400000000000001; the port's ``float`` reads it exactly)."""
    assert [x[0] for x in a] == [x[0] for x in b]
    np.testing.assert_allclose([x[1] for x in a], [x[1] for x in b], rtol=5e-16, atol=0)


@pytest.mark.parametrize("weighting", [True, False])
def test_siglip_resources_match_jax(corpus, weighting):
    kw = dict(enable_severity_weighting=weighting,
              severity_weights={"normal": 0.5, "mild": 1.5, "severe": 4.0} if weighting
              else None)
    t, j = _resources(tsiglip, corpus["port"], **kw), _resources(jsiglip, corpus["jax"], **kw)
    assert t.text_by_id == j.text_by_id and t.meta_by_id == j.meta_by_id
    assert t.video_to_positives.keys() == j.video_to_positives.keys()
    assert dict(t.texts_by_segment) == dict(j.texts_by_segment)
    for vid in j.video_to_positives:
        _same_pairs(t.video_to_positives[vid], j.video_to_positives[vid])
        assert t.video_is_abnormal(vid) == j.video_is_abnormal(vid)
        assert t.build_report_from_positives(vid) == j.build_report_from_positives(vid)
        for tid, w in j.video_to_positives[vid]:
            assert t.pair_weight(tid, w) == j.pair_weight(tid, w)
        for epoch in (0, 1, 2):
            for k, rr in ((1, True), (1, False), (8, True)):
                kws = dict(round_robin=rr, epoch=epoch, max_segments=1 if k == 1 else 15)
                _same_pairs(t.sample_positives(vid, k, rng=np.random.default_rng(epoch), **kws),
                            j.sample_positives(vid, k, rng=np.random.default_rng(epoch), **kws))
            for boost in (0.0, 2.0):
                kws = dict(contradiction_boost=boost, contradiction_min_severity="mild")
                assert (t.sample_negatives(vid, 7, rng=np.random.default_rng(epoch), **kws)
                        == j.sample_negatives(vid, 7, rng=np.random.default_rng(epoch),
                                              **kws))


DS_KW = dict(frames=4, resize=32, stride=1, seed=3, wire_dtype="uint8")


def _siglip_datasets(corpus, split, **over):
    kw = dict(DS_KW, data_filename=str(corpus["port"]["videos"]), split=split,
              target_label=None, max_positive_per_video=2, negatives_per_video=5,
              max_segments_per_video=15, contradiction_boost=1.5, **over)
    t = tsiglip.SiglipVideoDataset(siglip=_resources(tsiglip, corpus["port"]), **kw)
    kw["data_filename"] = str(corpus["jax"]["videos"])
    j = jsiglip.SiglipVideoDataset(siglip=_resources(jsiglip, corpus["jax"]), **kw)
    return t, j


def _assert_items_equal(a, b, keys):
    for k in keys:
        if isinstance(b[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("split", ["train", "val"])
def test_siglip_dataset_items_match_jax(corpus, split):
    """Items over two epochs: videos, masks, the positive and negative packs
    (the per-item generator seeded from crc32(video_id) and the epoch),
    the video id and the LocCa report; abnormality labels."""
    t, j = _siglip_datasets(corpus, split)
    assert len(t) == len(j) > 0
    np.testing.assert_array_equal(t.abnormal_labels(), j.abnormal_labels())
    for epoch in (0, 1):
        t.set_epoch(epoch)
        j.set_epoch(epoch)
        for i in range(len(j)):
            a, b = t[i], j[i]
            _assert_items_equal(a, b, ("videos", "video_mask", "negatives", "video_id",
                                       "locca_report", "text"))
            _same_pairs(a["positives"], b["positives"])
            assert [Path(p).name for p in a["paths"]] == [Path(p).name for p in b["paths"]]


def test_collate_multi_positive_matches_jax(corpus):
    """The bank, padded to exactly max_texts, and every array; a bank too
    small drops texts and counts them."""
    t, j = _siglip_datasets(corpus, "train")
    items_t, items_j = [t[i] for i in range(4)], [j[i] for i in range(4)]
    tt = get_tokenizer(vocab_size=30522, max_length=24)
    jt = jax_tokenizer(vocab_size=30522, max_length=24)
    for max_texts in (4 * 7, 6):
        a = tcollate.collate_multi_positive(items_t, tt, max_text_length=24,
                                            max_texts=max_texts, patch=(2, 16, 16))
        b = jcollate.collate_multi_positive(items_j, jt, max_text_length=24,
                                            max_texts=max_texts, patch=(2, 16, 16))
        assert set(a) == set(b)
        for k in ("videos", "video_mask", "input_ids", "attention_mask", "positive_mask",
                  "positive_weights", "text_valid"):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a["unique_texts"] == b["unique_texts"]
        assert a["n_dropped_texts"] == b["n_dropped_texts"]
        assert a["input_ids"].shape == (max_texts, 24)
    assert b["n_dropped_texts"] > 0


@pytest.mark.parametrize("ratio,labels", [
    (0.5, [1, 0, 0, 1, 0, 0, 0, 1, 0, 0, 1, 1, 0]),
    (0.25, [0, 0, 0, 0, 1, 0, 0, 0, 0]),
    (0.5, [0] * 7),
    (0.75, [1] * 6),
])
def test_class_aware_sampler_matches_jax(ratio, labels):
    for rank, n in ((0, 1), (1, 2)):
        kw = dict(abnormal_ratio=ratio, seed=11, process_index=rank, process_count=n)
        t = tsampler.ClassAwareBatchSampler(labels, 4, **kw)
        j = jsampler.ClassAwareBatchSampler(labels, 4, **kw)
        assert len(t) == len(j)
        for epoch in (0, 1, 5):
            t.set_epoch(epoch)
            j.set_epoch(epoch)
            got, want = list(t), list(j)
            assert len(got) == len(want)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)


def _asdict(settings):
    return dataclasses.asdict(settings)


@pytest.mark.parametrize("over", [
    {},
    dict(siglip_debug_batches=2, siglip_debug_every=3, siglip_debug_sample_count=5,
         siglip_negatives_per_video=32, siglip_use_class_aware_sampler=True,
         siglip_abnormal_ratio=0.3, siglip_contradiction_boost=2.0,
         siglip_round_robin_sampling=False),
])
def test_runtime_settings_match_jax(over):
    """Field by field, from each package's config of the shipped SigLIP YAML
    plus overrides, and from a namespace with the resolver's extra keys."""
    path = str(REPO / "config" / "clip" / "siglip_multi_positive_config.yaml")
    t = tconfigs.parse_config(["--base_config", path])
    j = jax_parse_config(["--base_config", path])
    for k, v in over.items():
        setattr(t, k, v)
        setattr(j, k, v)
    assert (_asdict(SiglipRuntimeSettings.from_config(t, "/out"))
            == _asdict(JaxRuntime.from_config(j, "/out")))
    ns = type("NS", (), dict(siglip_infonce_weight=0.9, siglip_focal_alpha_clip_min=3.0,
                             siglip_focal_alpha_clip_max=1.0, siglip_bag_targets={"mild": "x",
                                                                                 "severe": 3},
                             siglip_phase_transition_epoch=2, siglip_debug_every=0))()
    a, b = SiglipRuntimeSettings.from_config(ns), JaxRuntime.from_config(ns)
    assert _asdict(a) == _asdict(b)
    assert [a.phase_for_epoch(e) for e in range(4)] == [b.phase_for_epoch(e) for e in range(4)]
    assert ([a.debug.fires(e, i) for e in range(3) for i in range(3)]
            == [b.debug.fires(e, i) for e in range(3) for i in range(3)])


@pytest.mark.parametrize("seed", [0, 1])
def test_semantic_metrics_match_jax(seed):
    r = np.random.default_rng(seed)
    trees, segs = ["left", "right", None], ["prox_lad", "mid_rca", "d1", None]
    sevs = ["normal", "mild", "moderate", "severe", None]
    ids = [f"t{i}" for i in range(30)]
    meta = {tid: {"tree": trees[r.integers(3)], "segment": segs[r.integers(4)],
                  "severity": sevs[r.integers(5)]} for tid in ids[:-2]}
    meta["t28"] = {"tree": "Left ", "segment": "PROX_LAD", "disease_severity": "Severe"}
    positives = [list(r.choice(ids, size=r.integers(0, 5), replace=False)) for _ in range(12)]
    sim = r.normal(size=(12, 30))
    got = compute_semantic_metrics(sim, positives, meta, ids)
    want = jsemantic(sim, positives, meta, ids)
    assert got.keys() == want.keys() and "semantic/tree_recall@5" in got
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, err_msg=k)


def test_study_items_at_the_multivideo_config_match_jax(corpus):
    """``VideoClipDataset`` study mode as multivideo_config.yaml reads it
    (num_videos 5, groupby StudyInstanceUID, shuffle_videos), on the
    corpus grouped by write_study_manifest: the same items."""
    studies = write_study_manifest(corpus["manifest"].parent, seed=0,
                                   videos_per_study=(3, 6))
    for split in ("train", "val"):
        kw = dict(DS_KW, data_filename=str(studies), split=split, multi_video=True,
                  num_videos=5, groupby_column="StudyInstanceUID", shuffle_videos=True)
        t, j = tdatasets.VideoClipDataset(**kw), jdatasets.VideoClipDataset(**kw)
        assert len(t) == len(j) > 0
        for epoch in (0, 1):
            t.set_epoch(epoch)
            j.set_epoch(epoch)
            for i in range(len(j)):
                a, b = t[i], j[i]
                _assert_items_equal(a, b, ("videos", "video_mask", "text", "study_id"))
                assert a["paths"] == b["paths"]


# --------------------------------------------------------------------------- #
# the configs and the kernel entry


def test_chip_smoke_configs_are_the_shipped_yamls():
    """chip_smoke.py spells the three SigLIP recipes out as dicts (the card's
    machine need not have PyYAML): each equals its YAML as the port's
    parser reads it, and every run passes the runner's check."""
    for fn, name in ((chip_smoke.siglip_config, "siglip_multi_positive_config.yaml"),
                     (chip_smoke.multivideo_config, "multivideo_config.yaml"),
                     (chip_smoke.siglip_single_head_config,
                      "siglip_single_head_config.yaml")):
        want = tconfigs.parse_config(["--base_config", str(REPO / "config" / "clip" / name)])
        got = fn()
        assert got.to_dict() == want.to_dict(), name
        trun.check_ported(got)


def test_kernel_head_dim():
    """The head dim a CUDA K3/K4 call runs at: 64 and 128 as they are, 32
    (the single-video aggregator of siglip_multi_positive_config.yaml: 512
    wide, 16 heads) and 8 padded to 64; 96 and 130 to the next width a
    kernel takes (with or without RoPE: ``pad_head_dim`` keeps the rotated
    halves apart); 256 as it is; above 512 it raises."""
    assert [kernel_head_dim(d) for d in (8, 32, 64, 128)] == [64, 64, 64, 128]
    assert [kernel_head_dim(d) for d in (96, 130, 256)] == [128, 256, 256]
    with pytest.raises(ValueError, match="Dh"):
        kernel_head_dim(514)
    cfg = chip_smoke.siglip_config()
    assert cfg.embedding_dim // cfg.num_heads == 32 and not cfg.multi_video


# --------------------------------------------------------------------------- #
# the train step against the JAX step


STEP_CFG = dict(
    frames=4, resize=32, batch_size=3, multi_video=False, num_videos=1,
    vit_dim=32, vit_depth=1, vit_heads=1, vit_patch=[2, 16, 16], use_cls_token=True,
    text_dim=32, text_depth=1, text_heads=2, text_vocab_size=256, max_text_length=8,
    embedding_dim=16, num_heads=2, aggregator_depth=1, dropout=0.0, lr=1e-3,
    # a rate that is not 0 at the first step, so that the update moves
    precision="fp32", scheduler_name="cosine", epochs=2,
    siglip_max_positive_per_video=2, siglip_negatives_per_video=2,
    siglip_entropy_reg_weight=0.3, siglip_positive_loss_weight=1.3,
    siglip_negative_loss_weight=0.8, siglip_bias_init=-2.0, temperature=0.1,
)
STEP_CASES = {
    "siglip_pairwise": dict(loss_name="siglip_pairwise"),
    "siglip": dict(loss_name="siglip", multi_video=True, num_videos=3, num_heads=2),
    "multi_positive_infonce": dict(loss_name="multi_positive_infonce",
                                   siglip_auto_balance=True),
}


def _step_batch(cfg, seed=0):
    r = np.random.default_rng(seed)
    B, N, L = cfg["batch_size"], cfg["num_videos"], cfg["max_text_length"]
    multi = cfg["loss_name"] != "siglip"
    M = B * (cfg["siglip_max_positive_per_video"] + cfg["siglip_negatives_per_video"])
    T = M if multi else B
    att = np.ones((T, L), np.int32)
    att[1, 5:] = 0
    att[-3:, 2:] = 0  # the bank's "" fillers: [CLS] [SEP]
    batch = {
        "videos": r.normal(size=(B, N, cfg["frames"], cfg["resize"], cfg["resize"], 3))
        .astype(np.float32),
        "video_mask": np.ones((B, N), bool),
        "input_ids": r.integers(0, 256, (T, L)).astype(np.int32),
        "attention_mask": att,
        "sample_mask": np.ones((B,), np.float32),
    }
    if N > 1:
        batch["video_mask"][2, 1:] = False
    if multi:
        pos = np.zeros((B, M), np.float32)
        pos[0, [0, 1]] = pos[1, 2] = pos[2, [3, 4]] = 1.0
        valid = np.r_[np.ones(M - 3), np.zeros(3)].astype(np.float32)
        batch.update(positive_mask=pos, text_valid=valid,
                     positive_weights=r.uniform(0.75, 2.5, (B, M)).astype(np.float32))
    return batch


class StepPair:
    """The JAX bundle and the port's on the same initial weights and batch."""

    def __init__(self, case):
        d = dict(STEP_CFG, **STEP_CASES[case])
        self.jcfg = JaxClipConfig.from_dict(dict(d, use_pallas_attention=False))
        self.tcfg = tconfigs.ClipConfig.from_dict(dict(d, use_pallas_attention=True))
        mesh = make_mesh(MeshSpec(data=1, model=1), devices=jax.devices()[:1])
        self.jbundle, self.jstate = jclip.build_clip_bundle(
            self.jcfg, mesh, jax.random.PRNGKey(0), steps_per_epoch=4)
        self.jbundle = self.jbundle._replace(
            text_model=self.jbundle.text_model.clone(proj_dropout=0.0))
        self.init = jax.tree_util.tree_map(np.array, self.jstate.params)
        self.batch = _step_batch(d)

    def torch_side(self):
        bundle, state = tclip.build_clip_bundle(self.tcfg, seed=0, steps_per_epoch=4,
                                                device="cpu")
        bundle.text_model.proj.dropout = 0.0
        p = state.params
        convert.load_training_tree(self.init, bundle.video_model, bundle.text_model,
                                   p["log_temp"], p["logit_bias"])
        batch = {k: torch.from_numpy(v) for k, v in self.batch.items()}
        return bundle, state, batch


def _grad_tree(bundle, state, grads):
    """Gradients as a JAX-shaped tree (through the parameter names)."""
    params = state.params
    saved = {k: p.detach().clone() for k, p in params.items()}
    with torch.no_grad():
        for k, g in grads.items():
            params[k].copy_(g)
    tree = convert.training_tree(bundle.video_model, bundle.text_model,
                                 params["log_temp"], params["logit_bias"])
    with torch.no_grad():
        for k, v in saved.items():
            params[k].copy_(v)
    return convert.flatten_tree(tree)


@pytest.fixture(scope="module", params=list(STEP_CASES))
def step_pair(request):
    return StepPair(request.param)


def test_loss_and_gradients_of_the_step_match_jax(step_pair):
    """The loss and every gradient leaf (logit_bias's included) against
    jax.value_and_grad of the JAX compute_loss: loss rtol 1e-4; gradients
    within 1e-4 of each leaf's largest magnitude and 1e-7 absolute."""
    p = step_pair
    jb = p.jbundle.batch_sharding_fn(p.batch)

    def loss_fn(params):
        out = jclip.compute_loss(p.jbundle, params, jb, {"dropout": jax.random.PRNGKey(1)},
                                 deterministic=False)
        return out["loss"], out

    (jl, _), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, p.init))
    bundle, state, batch = p.torch_side()
    params = state.params
    out = tclip.compute_loss(bundle, params["log_temp"], batch, None, deterministic=False,
                             logit_bias=params["logit_bias"])
    np.testing.assert_allclose(float(out["loss"].detach()), float(jl), **FP32)
    names = list(params)
    got = torch.autograd.grad(out["loss"], [params[n] for n in names], allow_unused=True)
    # a leaf the loss does not read (logit_bias under multi_positive_infonce)
    # has a zero gradient in JAX
    tg = _grad_tree(bundle, state, {n: torch.zeros_like(params[n]) if g is None else g
                                    for n, g in zip(names, got)})
    jgf = convert.flatten_tree(jax.tree_util.tree_map(np.asarray, jg))
    assert tg.keys() == jgf.keys()
    for k in jgf:
        scale = max(float(np.abs(jgf[k]).max()), 1e-6)
        np.testing.assert_allclose(tg[k], jgf[k], atol=max(1e-4 * scale, 1e-7), rtol=0,
                                   err_msg=k)
    if p.tcfg.loss_name != "multi_positive_infonce":  # the SigLIP losses read the bias
        assert abs(float(jgf["logit_bias"])) > 1e-3


def test_train_step_matches_jax(step_pair):
    """One step: every metric rtol 1e-4, every parameter after the update
    atol 3e-5 (the key bias's middle third left out: its gradient is
    noise), logit_bias moved as in JAX."""
    p = step_pair
    jstep = jclip.make_train_step(p.jbundle)
    _, jstate = jclip.build_clip_bundle(p.jcfg, p.jbundle.mesh, jax.random.PRNGKey(0),
                                        steps_per_epoch=4)
    jstate, jm = jstep(jstate, p.jbundle.batch_sharding_fn(p.batch), jax.random.PRNGKey(1),
                       0.0, 0.0, -1.0)
    bundle, state, batch = p.torch_side()
    n_fwd = flash_attention.launches
    state, tm = tclip.make_train_step(bundle)(state, batch, None, 0.0, 0.0, -1.0)
    assert flash_attention.launches == n_fwd  # CPU tensors never reach a kernel
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), err_msg=k, **FP32)
    jf = convert.flatten_tree(jax.tree_util.tree_map(np.asarray, jstate.params))
    tf = convert.flatten_tree(convert.training_tree(
        bundle.video_model, bundle.text_model, state.params["log_temp"],
        state.params["logit_bias"]))
    for k in jf:
        a, b = tf[k], jf[k]
        if k.endswith("attn/qkv/bias"):
            n = a.shape[0] // 3
            a, b = np.delete(a, slice(n, 2 * n)), np.delete(b, slice(n, 2 * n))
        np.testing.assert_allclose(a, b, atol=PARAM_ATOL, rtol=0, err_msg=k)
    moved = float(state.params["logit_bias"].detach()) != p.tcfg.siglip_bias_init
    assert moved == (p.tcfg.loss_name != "multi_positive_infonce")


def test_eval_step_matches_jax(step_pair):
    p = step_pair
    jout = jclip.make_eval_step(p.jbundle)(jax.tree_util.tree_map(jnp.asarray, p.init),
                                           p.jbundle.batch_sharding_fn(p.batch))
    bundle, state, batch = p.torch_side()
    tout = tclip.make_eval_step(bundle)(state.params, batch)
    for k in ("loss", "alignment"):
        np.testing.assert_allclose(float(tout[k]), float(jout[k]), err_msg=k, **FP32)
    for k in ("video_emb", "text_emb"):
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]), atol=1e-5,
                                   rtol=1e-4, err_msg=k)


def test_logit_bias_round_trips_through_convert(step_pair):
    """logit_bias goes into the JAX tree and back unchanged."""
    bundle, state, _ = step_pair.torch_side()
    with torch.no_grad():
        state.params["logit_bias"].fill_(-7.25)
    tree = convert.training_tree(bundle.video_model, bundle.text_model,
                                 state.params["log_temp"], state.params["logit_bias"])
    assert float(np.asarray(tree["logit_bias"])) == -7.25
    b2, s2, _ = step_pair.torch_side()
    convert.load_training_tree(tree, b2.video_model, b2.text_model, s2.params["log_temp"],
                               s2.params["logit_bias"])
    assert float(s2.params["logit_bias"].detach()) == -7.25


# --------------------------------------------------------------------------- #
# the runner against the JAX runner


def _run_cfg(corpus, out, **over):
    paths = corpus["port"]
    cfg = dict(
        pipeline_project="DeepCORO_clip", run_mode="train",
        data_filename=str(paths["videos"]), output_dir=str(out), target_label=None,
        siglip_texts_path=str(paths["texts"]), siglip_edges_path=str(paths["edges"]),
        siglip_max_positive_per_video=2, siglip_negatives_per_video=6,
        siglip_enable_severity_weighting=True, siglip_use_class_aware_sampler=True,
        siglip_abnormal_ratio=0.5, siglip_entropy_reg_weight=0.01, siglip_bias_init=-5.0,
        loss_name="siglip_pairwise",
        epochs=2, batch_size=4, frames=4, resize=32, stride=1, num_workers=2,
        multi_video=False, vit_dim=32, vit_depth=1, vit_heads=1, vit_patch=[2, 16, 16],
        text_dim=32, text_depth=1, text_heads=2, text_vocab_size=30522,
        max_text_length=16, embedding_dim=16, num_heads=2, aggregator_depth=1,
        dropout=0.0, lr=1e-3, precision="fp32", use_pallas_attention=False,
        use_wandb=False, recall_k=[1, 5], ndcg_k=[5], mesh_data=-1, mesh_model=1, seed=0,
        scheduler_name="linear_warmup", temperature=0.07,
    )
    cfg.update(over)
    return cfg


def _write_yaml(path: Path, cfg: dict) -> Path:
    path.write_text(yaml.safe_dump(cfg))
    return path


EPOCH_KEYS = ("loss", "alignment", "temperature", "grad_norm", "grad_norm_video_encoder",
              "grad_norm_text_encoder", "lr", "val_loss", "val_alignment", "val_MRR",
              "val_MAP", "val_MedianRank", "val_Recall@1", "val_Recall@5", "val_NDCG@5")


@pytest.fixture(scope="module")
def runs(corpus):
    """(JAX history, port history, port runner) over the same 2 epochs."""
    root = corpus["root"]
    path = _write_yaml(root / "parity.yaml", _run_cfg(corpus, root / "outputs"))
    jcfg = jax_parse_config(["--base_config", str(path)])
    jr = JaxRunner(jcfg, output_dir=root / "jax_run")
    jr.bundle = jr.bundle._replace(text_model=jr.bundle.text_model.clone(proj_dropout=0.0))
    jr.train_step = jclip.make_train_step(jr.bundle)
    jr.eval_step = jclip.make_eval_step(jr.bundle)
    init = root / "init.npz"
    convert.save_params_npz(jax.tree_util.tree_map(np.asarray, jr.state.params), init)
    jhist = jr.train()["history"]

    cfg = tconfigs.parse_config(["--base_config", str(path), "--device", "cpu",
                                 "--init_from_checkpoint", str(init)])
    tr = trun.VideoContrastiveLearningRunner(cfg, output_dir=root / "port_run")
    tr.bundle.text_model.proj.dropout = 0.0
    thist = tr.train()["history"]
    return jhist, thist, tr


def test_runner_matches_jax_per_epoch(runs):
    """Two epochs on the class-aware batches of the SigLIP dataset: the
    train and validation metrics and the semantic panel within relative
    1e-4 of the JAX runner's."""
    jhist, thist, _ = runs
    assert len(jhist) == len(thist) == 2
    for j, t in zip(jhist, thist):
        semantic = sorted(k for k in j if k.startswith("val_semantic/"))
        assert "val_semantic/tree_recall@5" in semantic
        assert sorted(k for k in t if k.startswith("val_semantic/")) == semantic
        assert set(j) <= set(t)
        for key in EPOCH_KEYS + tuple(semantic):
            np.testing.assert_allclose(t[key], j[key], rtol=RUN_RTOL, atol=1e-7,
                                       err_msg=f"epoch {t['epoch']} {key}")
        assert math.isfinite(t["loss"]) and t["loss"] > 0


def test_runner_batches_and_artifacts(runs, corpus):
    """The class-aware loader, the bank of batch_size x (8 + 32) texts, the
    validation artifacts with every video's best positive rank."""
    _, _, tr = runs
    cfg = tr.config
    assert isinstance(tr.loaders["train"].sampler, tsampler.ClassAwareBatchSampler)
    batch = next(iter(tr.loaders["train"]))
    M = cfg.batch_size * (cfg.siglip_max_positive_per_video + cfg.siglip_negatives_per_video)
    assert batch["input_ids"].shape == (M, cfg.max_text_length)
    assert batch["positive_mask"].shape == (cfg.batch_size, M)
    assert batch["positive_mask"].sum(1).min() >= 1
    run = Path(tr.output_dir)
    for name in ("unique_texts_epoch_1.csv", "retrieval_results_epoch_1.csv",
                 "text_embeddings_epoch_1.npz"):
        assert (run / "val" / name).exists(), name
    rows = read_csv_with_fallback(run / "val" / "retrieval_results_epoch_1.csv",
                                  expected_columns=["path", "gt_text", "gt_rank"]).rows
    assert len(rows) == len(tr.datasets["val"]) and all(r["gt_rank"] >= 1 for r in rows)
    saved = torch.load(run / "checkpoints" / "checkpoint.pt", weights_only=True)
    assert float(saved["params"]["logit_bias"]) != -5.0


def test_siglip_debug_dump(corpus, tmp_path):
    """siglip_debug_batches: one JSON line a gated batch, with the sampled
    videos' positive and negative logits and the step's metrics."""
    path = _write_yaml(tmp_path / "debug.yaml", _run_cfg(
        corpus, tmp_path / "out", epochs=1, siglip_debug_batches=1,
        siglip_debug_sample_count=2))
    result = main(["--base_config", str(path), "--device", "cpu"])
    lines = (Path(result["output_dir"]) / "siglip_debug" / "epoch_0000.jsonl"
             ).read_text().splitlines()
    assert len(lines) == 1
    entry = json.loads(lines[0])
    assert {"loss", "temperature", "logit_bias", "grad_norm", "samples"} <= set(entry)
    assert len(entry["samples"]) == 2 and entry["samples"][0]["positives"]


def _final_params(run_dir):
    return torch.load(Path(run_dir) / "checkpoints" / "checkpoint.pt",
                      weights_only=True)["params"]


@pytest.mark.parametrize("loss", ["siglip_pairwise", "siglip"])
def test_resume_repeats_the_uninterrupted_run(corpus, tmp_path, monkeypatch, loss):
    """Through ``main``, dropout on: a run stopped after epoch 0 and resumed
    ends bit-equal to an uninterrupted one (epoch-1 loss, parameters). The
    ``siglip`` case runs config 2's study mode on the corpus grouped into
    studies."""
    over = dict(dropout=0.1)
    if loss == "siglip":
        studies = write_study_manifest(corpus["manifest"].parent, seed=0)
        over.update(loss_name="siglip", siglip_texts_path=None, siglip_edges_path=None,
                    siglip_use_class_aware_sampler=False, data_filename=str(studies),
                    target_label="Report", multi_video=True, num_videos=3,
                    groupby_column="StudyInstanceUID", batch_size=2)
    path = _write_yaml(tmp_path / "resume.yaml", _run_cfg(corpus, tmp_path / "out", **over))
    full = main(["--base_config", str(path), "--device", "cpu"])
    train = trun.VideoContrastiveLearningRunner.train
    monkeypatch.setattr(trun.VideoContrastiveLearningRunner, "train",
                        lambda self, start_epoch=0, end_epoch=None: train(self, start_epoch, 1))
    cut = main(["--base_config", str(path), "--device", "cpu"])
    monkeypatch.undo()
    resumed = main(["--base_config", str(path), "--device", "cpu",
                    "--resume_training", "true", "--checkpoint", cut["output_dir"]])
    assert [h["epoch"] for h in resumed["history"]] == [1]
    assert resumed["history"][0]["loss"] == full["history"][1]["loss"]
    assert resumed["history"][0]["val_loss"] == full["history"][1]["val_loss"]
    a, b = _final_params(full["output_dir"]), _final_params(cut["output_dir"])
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
