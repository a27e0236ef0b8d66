"""The port's single-head SigLIP path against the JAX package, on the CPU.

Each piece takes the same inputs (a rendered corpus, its SigLIP manifests,
seeds) in both packages:

- ``build_text_catalog``, ``compute_class_statistics`` and the sampler's
  catalog from ``make_single_head_sampler``: equal;
- ``SingleHeadRetrievalSampler.prepare_batch`` over 6 calls across 2
  epochs, round-robin on and off, with and without negatives: the bank's
  ``text_ids``, labels, weights, metadata and audit bit-equal, and the
  round-robin and generator state after them equal;
- ``collate_single_head``: every array equal, with a bank that overflows
  ``max_texts`` (every positive kept) and one whose positives alone
  overflow it (both warn);
- ``SeverityBucketBatchSampler``: the same index batches;
- ``siglip_single_head_config.yaml`` through both ``main``s over 2 epochs:
  per-epoch metrics within relative 1e-4;
- the run's sampler state in every checkpoint: a run stopped after epoch 0
  and resumed through ``main`` ends bit-equal to the whole run (LocCa and
  dropout on), and does not without that state; the process loader
  collates in this process, so its batches equal the thread loader's.
"""

import dataclasses
import math
import random
import warnings
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch
import yaml

from deepcoro_clip_tpu.configs.clip import ClipConfig as JaxClipConfig
from deepcoro_clip_tpu.data import collate as jcollate
from deepcoro_clip_tpu.data import sampler as jsampler
from deepcoro_clip_tpu.data import siglip as jsiglip
from deepcoro_clip_tpu.data import single_head_sampler as jsh
from deepcoro_clip_tpu.data.tokenizer import get_tokenizer as jax_tokenizer
from deepcoro_clip_tpu.data import dataset_creation as jcreate

import chip_smoke
from deepcoro_clip_tpu_torch import configs as tconfigs
from deepcoro_clip_tpu_torch.data import collate as tcollate
from deepcoro_clip_tpu_torch.data import sampler as tsampler
from deepcoro_clip_tpu_torch.data import siglip as tsiglip
from deepcoro_clip_tpu_torch.data import single_head_sampler as tsh
from deepcoro_clip_tpu_torch.data.tokenizer import get_tokenizer
from deepcoro_clip_tpu_torch.main import main
from deepcoro_clip_tpu_torch.runners import contrastive as trun

from tests.single_head_runs import (
    EPOCH_KEYS,
    LOCCA_RUN,
    SINGLE_HEAD_YAML,
    run_both_mains,
    siglip_corpus,
    single_head_yaml,
)

RUN_RTOL = 1e-4


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """16 train + 8 val clips, the manifests both packages write from their
    findings, and each package's SigLIP resources over them."""
    c = siglip_corpus(tmp_path_factory.mktemp("single_head"), seed=0, n_train=16, n_val=8)
    jpaths = jcreate.build_siglip_manifests(pd.DataFrame(c["rows"]), c["root"] / "jax",
                                            cto_columns=chip_smoke.siglip_cto_columns())
    c["jax"] = jpaths
    c["t_res"] = tsiglip.SiglipResources(str(c["paths"]["texts"]), str(c["paths"]["edges"]))
    c["j_res"] = jsiglip.SiglipResources(str(jpaths["texts"]), str(jpaths["edges"]))
    return c


def _raw(res):
    """The catalog rows ``make_single_head_sampler`` reads off the resources."""
    return [{"text_id": tid, "prompt_text": res.text_by_id[tid],
             "category": m.get("category"), "segment": m.get("segment"), "bin": m.get("bin"),
             "tree": m.get("tree"), "stent": m.get("stent"),
             "soft_weight": m.get("soft_weight", 1.0),
             "disease_severity": m.get("severity"), "prompt_bucket": m.get("prompt_bucket")}
            for tid, m in ((t, res.meta_by_id[t]) for t in res.all_text_ids)]


def _entries(catalog):
    return {k: dataclasses.asdict(v) for k, v in catalog.items()}


def test_catalog_and_class_statistics_match_jax(corpus):
    """The class statistics and the catalog from the same rows, and the
    samplers' catalogs each package builds from its own manifests."""
    raw = _raw(corpus["t_res"])
    tcw, tlb = tsh.compute_class_statistics(raw)
    jcw, jlb = jsh.compute_class_statistics(raw)
    assert tcw == jcw and tlb == jlb and len(tcw) > 3
    assert _entries(tsh.build_text_catalog(raw, tcw, tlb)) == \
        _entries(jsh.build_text_catalog(raw, jcw, jlb))
    t = corpus["t_res"].make_single_head_sampler(seed=0)
    j = corpus["j_res"].make_single_head_sampler(seed=0)
    assert _entries(t.catalog) == _entries(j.catalog)
    sev = {tsh.severity_label(m) for m in t.catalog.values()}
    assert {"normal", "severe"} <= sev  # the corpus reaches both ends


SAMPLER_CASES = {
    "round_robin": dict(siglip_round_robin_sampling=True, siglip_negatives_per_video=6),
    "random": dict(siglip_round_robin_sampling=False, siglip_negatives_per_video=6),
    "random_weights": dict(siglip_round_robin_sampling=False, siglip_negatives_per_video=40,
                           siglip_min_pos_weight=0.3, siglip_contradiction_boost=2.0,
                           siglip_contradiction_min_severity="mild",
                           siglip_positive_severity_weights={"normal": 0.5, "severe": 2.0}),
    "no_negatives": dict(siglip_round_robin_sampling=True, siglip_negatives_per_video=0),
}


def _sampler_configs(over):
    d = dict(siglip_base_negative_weight=0.04, **over)
    return tconfigs.ClipConfig.from_dict(d), JaxClipConfig.from_dict(d)


@pytest.mark.parametrize("case", list(SAMPLER_CASES))
def test_sampler_matches_jax(corpus, case):
    """Both samplers over one catalog (the port's resources'), seeded alike
    and fed the same videos: 3 batches of 4 an epoch over 2 epochs, each
    epoch's videos in a seeded order (videos repeat across batches, so the
    round-robin state matters). Every output bit-equal, and the state after."""
    res = corpus["t_res"]
    tcfg, jcfg = _sampler_configs(SAMPLER_CASES[case])
    t = res.make_single_head_sampler(tcfg, seed=7)
    raw = _raw(res)
    cw, lb = jsh.compute_class_statistics(raw)
    j = jsh.SingleHeadRetrievalSampler(
        jsh.build_text_catalog(raw, cw, lb), rng=random.Random(7),
        max_negatives=jcfg.siglip_negatives_per_video,
        base_negative_weight=jcfg.siglip_base_negative_weight,
        round_robin=jcfg.siglip_round_robin_sampling, min_pos_weight=jcfg.siglip_min_pos_weight,
        positive_severity_weights=jcfg.siglip_positive_severity_weights,
        contradiction_boost=jcfg.siglip_contradiction_boost or 1.0,
        contradiction_min_severity=jcfg.siglip_contradiction_min_severity)
    videos = sorted(res.video_to_positives)
    calls = 0
    for epoch in (0, 1):
        order = np.random.default_rng(epoch).permutation(len(videos))
        for b in range(3):
            vids = [videos[i] for i in order[(b * 4) % len(videos):][:4]] + [videos[order[0]]]
            want = j.prepare_batch([jsh.VideoEntry(v, positive_pairs=res.video_to_positives[v])
                                    for v in vids], epoch=epoch)
            got = t.prepare_batch([tsh.VideoEntry(v, positive_pairs=res.video_to_positives[v])
                                   for v in vids], epoch=epoch)
            calls += 1
            assert got.text_ids == want.text_ids
            for k in ("labels", "weights"):
                a, w = getattr(got, k), getattr(want, k)
                assert a.dtype == w.dtype and a.tobytes() == w.tobytes(), k
            assert got.text_metadata == want.text_metadata
            assert got.audit == want.audit
    assert calls == 6
    assert dict(t._rr_state) == dict(j._rr_state) and t._pos_rr == j._pos_rr
    assert t._rng.getstate() == j._rng.getstate()
    if SAMPLER_CASES[case]["siglip_negatives_per_video"]:
        assert (got.labels == 0).any() and (got.weights[got.labels == 0] > 0).any()


def test_sampler_state_round_trips(corpus):
    """``state_dict`` then ``load_state_dict`` into a fresh sampler: the
    next calls equal the original's."""
    res = corpus["t_res"]
    cfg = tconfigs.ClipConfig.from_dict(dict(siglip_negatives_per_video=6,
                                             siglip_round_robin_sampling=False))
    a = res.make_single_head_sampler(cfg, seed=3)
    vids = sorted(res.video_to_positives)[:4]
    batch = [tsh.VideoEntry(v, positive_pairs=res.video_to_positives[v]) for v in vids]
    a.prepare_batch(batch)
    b = res.make_single_head_sampler(cfg, seed=3)
    b.load_state_dict(a.state_dict())
    x, y = a.prepare_batch(batch), b.prepare_batch(batch)
    assert x.text_ids == y.text_ids and np.array_equal(x.weights, y.weights)
    fresh = res.make_single_head_sampler(cfg, seed=3).prepare_batch(batch)
    assert fresh.text_ids != x.text_ids  # the state is what made them equal


def _collate_pair(corpus, max_texts, n_items=4, **over):
    cfg = dict(siglip_negatives_per_video=6, siglip_round_robin_sampling=True, **over)
    tcfg, jcfg = _sampler_configs(cfg)
    res_t, res_j = corpus["t_res"], corpus["j_res"]
    ds = tsiglip.SiglipVideoDataset(
        data_filename=str(corpus["paths"]["videos"]), split="train", target_label=None,
        frames=4, resize=32, stride=1, seed=3, wire_dtype="uint8", siglip=res_t,
        max_positive_per_video=2, negatives_per_video=6)
    items = [ds[i] for i in range(n_items)]
    tt = get_tokenizer(vocab_size=30522, max_length=24)
    jt = jax_tokenizer(vocab_size=30522, max_length=24)
    kw = dict(epoch=1, max_text_length=24, max_texts=max_texts, patch=(2, 16, 16))
    a = tcollate.collate_single_head(items, tt, res_t.make_single_head_sampler(tcfg, seed=1),
                                     res_t.text_by_id, res_t.video_to_positives, **kw)
    b = jcollate.collate_single_head(items, jt, res_j.make_single_head_sampler(jcfg, seed=1),
                                     res_j.text_by_id, res_t.video_to_positives, **kw)
    return a, b


def _assert_batches_equal(a, b):
    assert set(a) == set(b)
    for k in ("videos", "video_mask", "input_ids", "attention_mask", "positive_mask",
              "positive_weights", "text_valid"):
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert a["unique_texts"] == b["unique_texts"]
    assert a["n_dropped_texts"] == b["n_dropped_texts"]
    assert [[Path(p).name for p in x] for x in a["paths"]] == \
        [[Path(p).name for p in x] for x in b["paths"]]


@pytest.mark.parametrize("max_texts", [32, 10])
def test_collate_single_head_matches_jax(corpus, max_texts):
    """The padded bank and (Y, W); at 10 the bank overflows and only
    negatives go: each row keeps every positive it had, W is 0 off the
    sampled pairs and on the fillers."""
    a, b = _collate_pair(corpus, max_texts)
    _assert_batches_equal(a, b)
    assert a["input_ids"].shape == (max_texts, 24)
    pos, w = a["positive_mask"], a["positive_weights"]
    assert (pos.sum(1) >= 1).all()
    M = int(a["text_valid"].sum())
    assert (w[:, M:] == 0).all() and (w[pos > 0] > 0).all()
    if max_texts == 10:
        assert a["n_dropped_texts"] > 0 and M == 10
        full, _ = _collate_pair(corpus, 64)
        np.testing.assert_array_equal(pos.sum(1), full["positive_mask"].sum(1))


def test_collate_single_head_warns_when_positives_overflow(corpus):
    """Positives alone past max_texts: both packages warn and cut alike."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        a, b = _collate_pair(corpus, 3, n_items=6)
    said = [str(w.message) for w in caught if "collate_single_head" in str(w.message)]
    assert len(said) == 2 and said[0] == said[1]
    _assert_batches_equal(a, b)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(bucket_quotas={"normal": 0.5, "severe": 0.3, "mild": 0.2}),
    dict(exam_priors={"severe": 2.0}, warmup_epochs=2),
    dict(bucket_quotas={"Severe": 1.0, "normal": 1.0}, n_batches=5),
], ids=["even", "quotas", "priors_warmup", "batches"])
def test_severity_bucket_sampler_matches_jax(kw):
    """The same index batches, epoch by epoch, for one process and for
    either of two."""
    sev = ["normal", "mild", "severe", "normal", "moderate", "normal", "severe", "mild",
           "normal", "severe", "normal", "normal", "moderate"]
    for rank, n in ((0, 1), (0, 2), (1, 2)):
        t = tsampler.SeverityBucketBatchSampler(sev, 4, seed=5, process_index=rank,
                                                process_count=n, **kw)
        j = jsampler.SeverityBucketBatchSampler(sev, 4, seed=5, process_index=rank,
                                                process_count=n, **kw)
        assert len(t) == len(j)
        for epoch in (0, 1, 3):
            t.set_epoch(epoch)
            j.set_epoch(epoch)
            got, want = list(t), list(j)
            assert len(got) == len(want) > 0
            for x, y in zip(got, want):
                np.testing.assert_array_equal(x, y)


def test_severity_bucket_sampler_refuses_foreign_quotas():
    with pytest.raises(ValueError, match="match none"):
        tsampler.SeverityBucketBatchSampler(["normal", "mild"], 2, bucket_quotas={"cto": 1.0})


# --------------------------------------------------------------------------- #
# the run through main


def test_shipped_yaml_takes_the_single_head_path(corpus):
    """The shipped YAML parses, passes ``check_ported`` with nothing left
    unported, and its runner collates through one sampler a run (on the
    plain sharded batch order: the YAML sets no class-aware sampler)."""
    cfg = tconfigs.parse_config(["--base_config", str(SINGLE_HEAD_YAML)])
    assert cfg.siglip_sampler == "single_head" and cfg.loss_name == "siglip_single_head"
    assert tconfigs.unported_settings(cfg) == []
    trun.check_ported(cfg)
    over = single_head_yaml(corpus["paths"], corpus["root"] / "probe", epochs=1)
    r = trun.VideoContrastiveLearningRunner(
        tconfigs.ClipConfig.from_dict(dict(over, device="cpu")))
    assert r.single_head and type(r.loaders["train"].sampler) is tsampler.ShardedBatchSampler
    batch = next(iter(r.loaders["train"]))
    sampler = r.single_head_sampler()
    assert r.single_head_sampler() is sampler
    pos, w = batch["positive_mask"], batch["positive_weights"]
    assert (w[pos == 0] == 0).any() and (w[pos > 0] > 0).all()


def test_single_head_run_matches_jax_main(corpus, monkeypatch):
    """siglip_single_head_config.yaml (widths, data and epochs cut) through
    the JAX main and the port's: every epoch's train and validation metrics
    within relative 1e-4."""
    cfg = single_head_yaml(corpus["paths"], corpus["root"] / "out")
    jhist, thist = run_both_mains(corpus["root"], cfg, monkeypatch)
    assert len(jhist) == len(thist) == 2
    for j, t in zip(jhist, thist):
        for key in EPOCH_KEYS:
            np.testing.assert_allclose(t[key], j[key], rtol=RUN_RTOL, atol=1e-7,
                                       err_msg=f"epoch {t['epoch']} {key}")
        assert math.isfinite(t["loss"]) and "locca_loss" not in t


def _final(run_dir):
    return torch.load(Path(run_dir) / "checkpoints" / "checkpoint.pt", weights_only=True)


@pytest.fixture(scope="module")
def resume_yaml(corpus):
    """The single-head YAML with LocCa and dropout 0.1, and its whole run
    through main."""
    cfg = single_head_yaml(corpus["paths"], corpus["root"] / "resume", dropout=0.1,
                           **LOCCA_RUN)
    path = corpus["root"] / "resume.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path, main(["--base_config", str(path), "--device", "cpu"])


def _resume_runs(resume_yaml, monkeypatch, drop_sampler_state=False):
    """(whole run, run stopped after epoch 0 and resumed) through main."""
    path, full = resume_yaml
    train = trun.VideoContrastiveLearningRunner.train
    monkeypatch.setattr(trun.VideoContrastiveLearningRunner, "train",
                        lambda self, start_epoch=0, end_epoch=None: train(self, start_epoch, 1))
    cut = main(["--base_config", str(path), "--device", "cpu"])
    monkeypatch.undo()
    if drop_sampler_state:
        ck = Path(cut["output_dir"]) / "checkpoints" / "checkpoint.pt"
        saved = torch.load(ck, weights_only=True)
        saved["sampler"] = None
        torch.save(saved, ck)
    resumed = main(["--base_config", str(path), "--device", "cpu",
                    "--resume_training", "true", "--checkpoint", cut["output_dir"]])
    return full, resumed


def test_resume_repeats_the_uninterrupted_run(resume_yaml, monkeypatch):
    """Stopped after epoch 0 and resumed through main: epoch 1's losses
    (LocCa's too) and every final parameter bit-equal to the whole run's;
    the checkpoint holds the sampler's generator and round-robin state."""
    full, resumed = _resume_runs(resume_yaml, monkeypatch)
    assert [h["epoch"] for h in resumed["history"]] == [1]
    a, b = full["history"][1], resumed["history"][0]
    for k in ("loss", "locca_loss", "val_loss", "val_locca_loss", "grad_norm_locca_decoder"):
        assert a[k] == b[k], k
    fa, fb = _final(full["output_dir"]), _final(resumed["output_dir"])
    assert fa["params"].keys() == fb["params"].keys()
    assert any(k.startswith("locca_decoder.") for k in fa["params"])
    for k in fa["params"]:
        assert torch.equal(fa["params"][k], fb["params"][k]), k
    assert fa["sampler"] == fb["sampler"] and set(fa["sampler"]) == {"rng", "rr_state",
                                                                       "pos_rr"}
    assert fa["sampler"]["pos_rr"] and fa["sampler"]["rr_state"]


def test_resume_without_the_sampler_state_differs(resume_yaml, monkeypatch):
    """What the JAX package does (it keeps no sampler state): the resumed
    run's sampler starts fresh and epoch 1 differs from the whole run's."""
    full, resumed = _resume_runs(resume_yaml, monkeypatch, drop_sampler_state=True)
    assert resumed["history"][0]["loss"] != full["history"][1]["loss"]


def test_process_loader_collates_in_this_process(corpus, tmp_path):
    """``loader_backend: process``: workers build items, the sampler stays
    in this process, so an epoch's batches equal the thread loader's."""
    batches = {}
    for backend in ("thread", "process"):
        over = single_head_yaml(corpus["paths"], tmp_path / backend, epochs=1,
                                loader_backend=backend, num_workers=1, device="cpu")
        r = trun.VideoContrastiveLearningRunner(tconfigs.ClipConfig.from_dict(over))
        r.loaders["train"].set_epoch(0)
        batches[backend] = list(r.loaders["train"])
    assert len(batches["thread"]) == len(batches["process"]) > 1
    for a, b in zip(batches["thread"], batches["process"]):
        for k in ("positive_mask", "positive_weights", "input_ids", "videos"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a["unique_texts"] == b["unique_texts"]
