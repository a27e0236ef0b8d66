"""The port's linear-probing run end to end on the CPU, against the JAX package.

Data: ``VideoDataset`` items and ``collate_mil`` batches against the JAX
package's on one manifest (``labels_map``, views by name and by number,
unknown views and padded slots at the PAD id, shuffled clip order in
training): equal arrays, equal ids.

The run: the workspace of ``tests/runners/test_linear_probing_runner.py``
(16 clips ``.npy`` of 6 x 32 x 32 behind an ``α``-separated manifest, 8
studies x 2 clips, 6 train and 2 val, a regression and a binary head,
view ids; fp32, dropout 0). Both packages' ``main`` run it; the port's
``build_probe_bundle`` is wrapped to load the JAX runner's initial tree
(``convert.load_probe_tree``), the data order and the statistics are each
package's own. Per epoch the history, the predictions CSV and the metrics
JSON agree to a relative 1e-4 (fp32 sums in another order); so do the
``run_mode: val`` pass with its bootstrap intervals, and the inference
predictions and study embeddings (headless too, as the ``pci_comparison``
configs run). Resume through ``main`` is bit-equal; the encoder loads from
a port checkpoint and from a JAX ``.npz``; inference at batch 1 and 2
agrees to 1e-6; every shipped probing YAML parses as in JAX and runs one
tiny epoch (or inference) through the port's ``main`` on the CPU.
"""

import csv
import json
from pathlib import Path

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch
import yaml

from deepcoro_clip_tpu.configs.parser import parse_config as jax_parse_config
from deepcoro_clip_tpu.data.collate import collate_mil as jax_collate_mil
from deepcoro_clip_tpu.data.datasets import VideoDataset as JaxVideoDataset
from deepcoro_clip_tpu.main import main as jax_main
from deepcoro_clip_tpu.registry import register_all as jax_register_all
from deepcoro_clip_tpu.runners.linear_probing import LinearProbingRunner as JaxRunner

from deepcoro_clip_tpu_torch import configs as tconfigs
from deepcoro_clip_tpu_torch import convert
from deepcoro_clip_tpu_torch.data.collate import collate_mil
from deepcoro_clip_tpu_torch.data.csv_utils import write_csv
from deepcoro_clip_tpu_torch.data.datasets import VideoDataset
from deepcoro_clip_tpu_torch.main import main
from deepcoro_clip_tpu_torch.runners import linear_probing as tlp

jax_register_all()

REPO = Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-4, 1e-6
STATS = ["--dataset_mean", "[127,127,127]", "--dataset_std", "[50,50,50]"]


def _write_yaml(path: Path, cfg: dict) -> Path:
    path.write_text(yaml.safe_dump(cfg))
    return path


def _read_csv(path: Path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _close_rows(got, want, numeric):
    """CSV rows: the ``numeric`` columns within RTOL, the rest equal."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            if k in numeric:
                np.testing.assert_allclose(float(g[k]), float(w[k]), rtol=RTOL, atol=ATOL,
                                           err_msg=k)
            else:
                assert g[k] == w[k], k


def _close_json(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            _close_json(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, float) and np.isnan(want):
        assert np.isnan(got), path
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=path)


def _run_dir(out: Path) -> Path:
    (run,) = [p for p in out.rglob("config.yaml")]
    return run.parent


# --------------------------------------------------------------------------- #
# the dataset and the collate


@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    """Studies of 1 to 4 clips; a labels-map column with an unknown and an
    empty label, a numeric target with an empty cell, views by name, by
    number, unknown and empty."""
    root = tmp_path_factory.mktemp("items")
    r = np.random.default_rng(3)
    views = ["AP", "3", "LAO Cranial", "XYZ", "", "1", "RAO Straight", "0", "AP", "2"]
    grades = ["low", "high", "mid", "", "intermediate"]
    rows = []
    for i in range(20):
        p = root / f"c{i}.npy"
        np.save(p, r.integers(0, 255, size=(4, 16, 16, 3)).astype(np.uint8))
        study = i // 4 if i < 12 else 3 + (i - 12) // 2  # 3 of 4 clips, then of 2
        rows.append({"FileName": str(p), "StudyInstanceUID": f"S{study}",
                     "Split": "train" if i < 16 else "val",
                     "grade": grades[study % len(grades)],
                     "score": "" if study == 2 else float(study) * 1.5,
                     "view": views[i % len(views)]})
    write_csv(root / "m.csv", list(rows[0]), rows)
    return root / "m.csv"


@pytest.mark.parametrize("split,num_videos,shuffle", [("train", 3, True), ("train", 4, False),
                                                       ("val", 2, True), ("all", 3, True)])
def test_video_dataset_and_collate_match_jax(manifest, split, num_videos, shuffle):
    kw = dict(data_filename=str(manifest), split=split, multi_video=True,
              num_videos=num_videos, shuffle_videos=shuffle, frames=4, resize=16, stride=1,
              seed=5, target_labels=["grade", "score"],
              labels_map={"grade": {"low": 0, "intermediate": 1, "high": 2}},
              view_column="view", num_view_classes=12,
              view_labels_map={"AP": 0, "LAO Cranial": 4, "RAO Straight": 11},
              wire_dtype="uint8")
    t, j = VideoDataset(**kw), JaxVideoDataset(**kw)
    assert len(t) == len(j) > 0
    for epoch in (0, 1):
        t.set_epoch(epoch)
        j.set_epoch(epoch)
        items = []
        for i in range(len(t)):
            a, b = t[i], j[i]
            np.testing.assert_array_equal(a["videos"], b["videos"])
            np.testing.assert_array_equal(a["video_mask"], b["video_mask"])
            np.testing.assert_array_equal(a["view_ids"], b["view_ids"])
            assert a["view_ids"].dtype == b["view_ids"].dtype == np.int32
            assert a["paths"] == b["paths"] and a["study_id"] == b["study_id"]
            assert a["selected_rows"] == [int(x) for x in b["selected_rows"]]
            assert a["targets"].keys() == b["targets"].keys()
            for h in a["targets"]:
                assert a["targets"][h] == b["targets"][h] and a["targets"][h].dtype == np.float32
            items.append((a, b))
        got = collate_mil([a for a, _ in items], ["grade", "score"], patch=(2, 8, 8))
        want = jax_collate_mil([b for _, b in items], ["grade", "score"], patch=(2, 8, 8))
        assert got.keys() == want.keys()
        for k in ("videos", "video_mask", "view_ids"):
            np.testing.assert_array_equal(got[k], want[k])
        for h in ("grade", "score"):
            np.testing.assert_array_equal(got["targets"][h], want["targets"][h])
        assert got["study_ids"] == want["study_ids"] and got["paths"] == want["paths"]
    if split == "all":  # the rules themselves: an unknown label -1, an empty cell 0, PAD 12
        by_study = {it["study_id"]: it for it in (t[i] for i in range(len(t)))}
        assert by_study["S2"]["targets"]["grade"] == -1.0  # "mid"
        assert by_study["S3"]["targets"]["grade"] == 0.0  # empty
        assert by_study["S2"]["targets"]["score"] == 0.0  # empty
        assert by_study["S1"]["targets"]["grade"] == 2.0 and by_study["S1"]["targets"]["score"] == 1.5
        assert any((it["view_ids"] == 12).any() for it in by_study.values())


def test_collate_mil_without_views():
    items = [{"videos": np.zeros((2, 2, 4, 4, 3), np.uint8), "video_mask": np.ones(2, bool),
              "targets": {"a": np.float32(i)}, "study_id": f"S{i}", "paths": ["x", "y"]}
             for i in range(3)]
    got, want = collate_mil(items, ["a"]), jax_collate_mil(items, ["a"])
    assert "view_ids" not in got and got.keys() == want.keys()
    np.testing.assert_array_equal(got["targets"]["a"], want["targets"]["a"])


# --------------------------------------------------------------------------- #
# the run against the JAX runner


def _cfg(root: Path, **over):
    cfg = dict(
        pipeline_project="DeepCORO_video_linear_probing", run_mode="train",
        data_filename=str(root / "labels.csv"), output_dir=str(root / "out"),
        epochs=2, batch_size=2, frames=4, resize=32, num_workers=2,
        multi_video=True, num_videos=2,
        head_structure={"stenosis": 1, "cto": 1},
        loss_structure={"stenosis": "huber", "cto": "bce_logit"},
        head_task={"stenosis": "regression", "cto": "binary"},
        head_lr={"stenosis": 0.001, "cto": 0.002},
        pooling_mode="attention+cls_token",
        use_view_embeddings=True, view_column="view_id", num_view_classes=3,
        vit_dim=32, vit_depth=1, vit_heads=1, vit_patch=[2, 16, 16],
        embedding_dim=16, num_heads=2, aggregator_depth=1,
        attention_hidden=8, dropout=0.0, lr=1e-3,
        precision="fp32", use_pallas_attention=False,
        video_freeze_ratio=1.0, ci_n_bootstrap=20,
        save_embeddings=True, use_wandb=False, seed=0,
    )
    cfg.update(over)
    return cfg


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp("lp")
    r = np.random.default_rng(0)
    rows = []
    for i in range(16):
        study = f"S{i // 2}"  # 8 studies x 2 clips
        p = root / f"clip{i}.npy"
        np.save(p, r.integers(0, 255, size=(6, 32, 32, 3)).astype(np.uint8))
        rows.append({"FileName": str(p), "StudyInstanceUID": study,
                     "Split": "train" if i < 12 else "val",
                     "stenosis": float((i // 2) * 10), "cto": float((i // 2) % 2),
                     "view_id": i % 3})
    write_csv(root / "labels.csv", list(rows[0]), rows)
    return root


@pytest.fixture(scope="module")
def init_tree(workspace):
    """The JAX runner's initial probing tree, as numpy."""
    path = _write_yaml(workspace / "init.yaml", _cfg(workspace))
    jr = JaxRunner(jax_parse_config(["--base_config", str(path)]),
                   output_dir=workspace / "jax_init")
    return jax.tree_util.tree_map(np.asarray, fnn.unbox(jr.state.params))


def _with_jax_init(mp, tree):
    """The port's bundles start from the JAX runner's initial weights."""
    build = tlp.probe_train.build_probe_bundle

    def built(*args, **kw):
        bundle, state = build(*args, **kw)
        convert.load_probe_tree(tree, bundle.video_model, bundle.mil_model)
        return bundle, state

    mp.setattr(tlp.probe_train, "build_probe_bundle", built)


def _both(workspace, init_tree, name, extra=(), **over):
    """The same config through both mains; returns (JAX, port) (result, run dir)."""
    path = _write_yaml(workspace / f"{name}.yaml", _cfg(workspace, **over))
    argv = ["--base_config", str(path), *extra]
    jres = jax_main(argv + ["--output_dir", str(workspace / f"{name}_jax")])
    with pytest.MonkeyPatch.context() as mp:
        _with_jax_init(mp, init_tree)
        tres = main(argv + ["--output_dir", str(workspace / f"{name}_port"), "--device", "cpu"])
    return ((jres, _run_dir(workspace / f"{name}_jax")),
            (tres, _run_dir(workspace / f"{name}_port")))


@pytest.fixture(scope="module")
def trained(workspace, init_tree):
    return _both(workspace, init_tree, "train")


def test_runner_matches_jax_per_epoch(trained):
    """Two epochs: every key of the JAX history (train loss, lr, grad norm,
    per-head losses, the validation loss and every scalar head metric)
    within relative 1e-4; the port adds the loader's wait and the times."""
    (jres, _), (tres, _) = trained
    jh, th = jres["history"], tres["history"]
    assert len(jh) == len(th) == 2
    assert "val_stenosis/mae" in jh[0] and "val_cto/auc" in jh[0] and "loss_cto" in jh[0]
    for j, t in zip(jh, th):
        assert set(t) - set(j) == {"loader_wait_ms", "epoch_seconds", "val_metrics_seconds",
                                   "val_seconds"}
        for key in j:
            np.testing.assert_allclose(t[key], j[key], rtol=RTOL, atol=ATOL,
                                       err_msg=f"epoch {j['epoch']} {key}")
    assert tres["best_epoch"] == jres["best_epoch"]
    np.testing.assert_allclose(tres["best_val_loss"], jres["best_val_loss"], rtol=RTOL)


def test_predictions_and_metrics_per_epoch_match_jax(trained):
    (_, jdir), (_, tdir) = trained
    for epoch in (0, 1):
        got = _read_csv(tdir / "val" / f"predictions_epoch_{epoch}.csv")
        want = _read_csv(jdir / "val" / f"predictions_epoch_{epoch}.csv")
        # (the heads in the YAML's order: safe_dump sorts the keys)
        assert list(got[0]) == ["study_id", "cto_pred", "cto_target", "stenosis_pred",
                                "stenosis_target"] and len(got) == 2
        _close_rows(got, want, {"stenosis_pred", "stenosis_target", "cto_pred",
                                "cto_target"})
        _close_json(json.loads((tdir / "val" / f"metrics_epoch_{epoch}.json").read_text()),
                    json.loads((jdir / "val" / f"metrics_epoch_{epoch}.json").read_text()))


def test_checkpoints_and_meta(trained):
    """The latest and best-loss checkpoints, the dataset statistics and the
    best loss in the meta, the run's dropout generator in the file; the
    frozen encoder did not move."""
    (_, _), (tres, tdir) = trained
    ck = tdir / "checkpoints"
    names = sorted(p.name for p in ck.iterdir())
    assert "checkpoint.pt" in names and "checkpoint.json" in names
    assert len([n for n in names if n.startswith("best_model_epoch_")]) == 2
    meta = json.loads((ck / "checkpoint.json").read_text())
    assert {"epoch", "train_loss", "val_loss", "dataset_mean", "dataset_std", "best_val_loss",
            "best_epoch"} <= set(meta) and meta["epoch"] == 1
    saved = torch.load(ck / "checkpoint.pt", weights_only=True)
    assert saved["generator"] is not None and saved["step"] == 6


def test_validation_with_bootstrap_intervals_matches_jax(workspace, init_tree):
    """``run_mode: val`` through both mains: the metrics JSON with every
    head's interval (``mae_ci``, ``auc_ci``) within relative 1e-4."""
    (jres, jdir), (tres, tdir) = _both(workspace, init_tree, "val", STATS, run_mode="val",
                                       ci_n_bootstrap=50)
    got = json.loads((tdir / "val" / "metrics_epoch_0.json").read_text())
    want = json.loads((jdir / "val" / "metrics_epoch_0.json").read_text())
    assert "stenosis/mae_ci" in want and "cto/auc_ci" in want
    _close_json(got, want)
    assert tres["metrics_seconds"] > 0 and tres["seconds"] >= tres["metrics_seconds"]


@pytest.mark.parametrize("headless", [False, True], ids=["heads", "pci_headless"])
def test_inference_matches_jax(workspace, init_tree, headless):
    """``run_mode: inference`` over every study: the predictions CSV and the
    pooled study embeddings (``attention+cls_token``: 2 x 16 wide) within
    relative 1e-4. Headless (``head_structure: {}``, as
    ``config/linear_probing/pci_comparison/*.yaml``): the embeddings only,
    into ``embedding_output_file``."""
    over = dict(run_mode="inference", split_filter="all")
    name = "infer"
    if headless:
        name = "headless"
        over.update(head_structure={}, loss_structure={}, head_task={}, head_lr={},
                    embedding_output_file="pre_pci_study_embeddings.npz")
    init = init_tree
    if headless:  # no head leaves in a headless tree
        init = {"video_encoder": init_tree["video_encoder"],
                "mil": {k: v for k, v in init_tree["mil"].items()
                        if not k.startswith("head_")}}
    (jres, jdir), (tres, tdir) = _both(workspace, init, name, STATS, **over)
    assert tres["rows"] == jres["rows"] == 8
    heads = [] if headless else ["cto", "stenosis"]
    got = _read_csv(tdir / "inference" / "predictions.csv")
    assert list(got[0]) == ["study_id"] + heads
    _close_rows(got, _read_csv(jdir / "inference" / "predictions.csv"), set(heads))
    fname = "pre_pci_study_embeddings.npz" if headless else "study_embeddings.npz"
    a, b = np.load(tdir / "inference" / fname), np.load(jdir / "inference" / fname)
    assert a["embeddings"].shape == (8, 32)
    np.testing.assert_allclose(a["embeddings"], b["embeddings"], rtol=RTOL, atol=1e-5)
    assert a["study_ids"].tolist() == b["study_ids"].tolist()


def test_inference_does_not_read_checkpoint_into_the_head(trained, workspace):
    """As in the JAX runner, ``checkpoint`` is not read outside training:
    the head starts from the seed (``deterministic_inference_demo.yaml``
    assumes otherwise, ROADMAP Queue 3). A trained run's directory as
    ``checkpoint`` changes no prediction."""
    (_, _), (_, tdir) = trained
    path = _write_yaml(workspace / "nockpt.yaml",
                       _cfg(workspace, run_mode="inference", split_filter="all"))
    base = ["--base_config", str(path), "--device", "cpu", *STATS]
    main(base + ["--output_dir", str(workspace / "nockpt_a")])
    main(base + ["--output_dir", str(workspace / "nockpt_b"), "--checkpoint", str(tdir)])
    a = _read_csv(_run_dir(workspace / "nockpt_a") / "inference" / "predictions.csv")
    b = _read_csv(_run_dir(workspace / "nockpt_b") / "inference" / "predictions.csv")
    assert a == b


def test_resume_repeats_the_uninterrupted_run(workspace, monkeypatch):
    """Through ``main``, dropout 0.1: a run stopped after epoch 0 and resumed
    with ``resume_training`` + ``checkpoint`` ends bit-equal to an
    uninterrupted one (parameters, step, generator, epoch-1 losses)."""
    path = _write_yaml(workspace / "resume.yaml",
                       _cfg(workspace, dropout=0.1, dropout_attention=0.1,
                            output_dir=str(workspace / "resume")))
    argv = ["--base_config", str(path), "--device", "cpu"]
    full = main(argv)
    train = tlp.LinearProbingRunner.train
    monkeypatch.setattr(tlp.LinearProbingRunner, "train",
                        lambda self, start_epoch=0, end_epoch=None: train(self, start_epoch, 1))
    cut = main(argv)
    monkeypatch.undo()
    resumed = main(argv + ["--resume_training", "true", "--checkpoint", cut["output_dir"]])
    assert resumed["output_dir"] == cut["output_dir"]
    assert [h["epoch"] for h in cut["history"]] == [0]
    assert [h["epoch"] for h in resumed["history"]] == [1]
    for key in ("loss", "val_loss", "val_stenosis/mae"):
        assert resumed["history"][0][key] == full["history"][1][key], key
    a, b = (torch.load(Path(r["output_dir"]) / "checkpoints" / "checkpoint.pt",
                       weights_only=True) for r in (full, resumed))
    assert a["step"] == b["step"] == 6 and torch.equal(a["generator"], b["generator"])
    for k in a["params"]:
        assert torch.equal(a["params"][k], b["params"][k]), k
    # the best loss so far comes back, not the last epoch's
    meta = json.loads((Path(cut["output_dir"]) / "checkpoints" / "checkpoint.json").read_text())
    assert resumed["best_val_loss"] == min(meta["best_val_loss"],
                                           resumed["history"][0]["val_loss"])


def test_encoder_from_a_port_checkpoint(workspace):
    """``video_encoder_checkpoint_path`` naming a contrastive run's
    checkpoints directory: every backbone and projection leaf comes from
    it; a probing-only pool would keep its fresh values."""
    from deepcoro_clip_tpu_torch.runners.contrastive import VideoContrastiveLearningRunner

    clip = tconfigs.ClipConfig.from_dict(dict(
        pipeline_project="DeepCORO_clip", data_filename=str(workspace / "labels.csv"),
        output_dir=str(workspace / "clip"), batch_size=2, frames=4, resize=32,
        num_workers=1, multi_video=True, num_videos=2, vit_dim=32, vit_depth=1,
        vit_heads=1, vit_patch=[2, 16, 16], text_dim=32, text_depth=1, text_heads=2,
        text_vocab_size=512, max_text_length=16, embedding_dim=16, num_heads=2,
        aggregator_depth=1, precision="fp32", use_pallas_attention=False, seed=7,
        device="cpu"))
    cr = VideoContrastiveLearningRunner(clip, output_dir=workspace / "clip")
    cr.ckpt.save_latest(cr.state, {"epoch": 0})
    cfg = tconfigs.LinearProbingConfig.from_dict(_cfg(
        workspace, device="cpu", video_encoder_checkpoint_path=str(cr.ckpt.dir)))
    r = tlp.LinearProbingRunner(cfg, output_dir=workspace / "from_pt")
    loaded, total = r.encoder_loaded
    tree = convert.flatten_tree(convert.module_to_jax_tree(r.bundle.video_model))
    backbone = {k for k in tree if k.startswith(("backbone/", "proj/"))}
    assert backbone and backbone <= set(loaded) and total == len(tree)
    assert not any(k.startswith("pool/") for k in loaded)  # (a probing-only pool, if any)
    clip_params = dict(cr.bundle.video_model.named_parameters())
    for name, p in r.bundle.video_model.named_parameters():
        if name.startswith(("backbone.", "proj.")):
            assert torch.equal(p, clip_params[name]), name
    # a .pt file reads the same
    r2 = tlp.LinearProbingRunner(tconfigs.LinearProbingConfig.from_dict(_cfg(
        workspace, device="cpu",
        video_encoder_checkpoint_path=str(cr.ckpt.dir / "checkpoint.pt"))),
        output_dir=workspace / "from_pt2")
    assert r2.encoder_loaded == r.encoder_loaded


def test_encoder_from_a_jax_npz(workspace, init_tree):
    """An ``.npz`` of the JAX tree (``convert.save_params_npz``): every
    encoder leaf of it, bit for bit."""
    npz = workspace / "jax_tree.npz"
    convert.save_params_npz(init_tree, npz)
    cfg = tconfigs.LinearProbingConfig.from_dict(_cfg(
        workspace, device="cpu", video_encoder_checkpoint_path=str(npz)))
    r = tlp.LinearProbingRunner(cfg, output_dir=workspace / "from_npz")
    want = convert.flatten_tree(init_tree["video_encoder"])
    got = convert.flatten_tree(convert.module_to_jax_tree(r.bundle.video_model))
    assert got.keys() == want.keys() and sorted(r.encoder_loaded[0]) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_inference_is_batch_size_invariant(workspace):
    """The same weights at batch 1 and 2: predictions and embeddings within
    1e-6."""
    out = {}
    for bs in (1, 2):
        cfg = tconfigs.parse_config(["--base_config", str(_write_yaml(
            workspace / f"bs{bs}.yaml", _cfg(workspace, run_mode="inference",
                                             split_filter="all", batch_size=bs))),
            "--device", "cpu", *STATS])
        r = tlp.LinearProbingRunner(cfg, output_dir=workspace / f"bs{bs}")
        rows = r.inference()
        out[bs] = (rows, np.load(workspace / f"bs{bs}" / "inference" / "study_embeddings.npz"))
    (r1, e1), (r2, e2) = out[1], out[2]
    assert [r["study_id"] for r in r1] == [r["study_id"] for r in r2]
    for a, b in zip(r1, r2):
        for h in ("stenosis", "cto"):
            assert abs(a[h] - b[h]) <= 1e-6, (h, a[h], b[h])
    np.testing.assert_allclose(e1["embeddings"], e2["embeddings"], atol=1e-6, rtol=0)


def test_build_datasets_maps_only_an_empty_split_to_none(workspace, tmp_path):
    """A split without studies is left out (training runs without
    validation); any other error propagates (a deliberate divergence: the
    JAX runner maps every exception to a missing split)."""
    rows = _read_csv_alpha(workspace / "labels.csv")
    for r in rows:
        r["Split"] = "train"
    write_csv(tmp_path / "train_only.csv", list(rows[0]), rows)
    cfg = tconfigs.LinearProbingConfig.from_dict(_cfg(
        workspace, device="cpu", epochs=1, data_filename=str(tmp_path / "train_only.csv")))
    r = tlp.LinearProbingRunner(cfg, output_dir=tmp_path / "run")
    assert r.datasets["val"] is None and set(r.loaders) == {"train"}
    hist = r.train()["history"]
    assert len(hist) == 1 and "val_loss" not in hist[0]
    bad = tconfigs.LinearProbingConfig.from_dict(_cfg(
        workspace, device="cpu", data_filename=str(tmp_path / "missing.csv")))
    with pytest.raises(FileNotFoundError):
        tlp.LinearProbingRunner(bad, output_dir=tmp_path / "bad")


def _read_csv_alpha(path: Path):
    from deepcoro_clip_tpu_torch.data.csv_utils import read_csv_with_fallback

    return read_csv_with_fallback(path).rows


# --------------------------------------------------------------------------- #
# every shipped probing YAML through main

PROBING_YAMLS = sorted((REPO / "config" / "linear_probing").rglob("*.yaml")) + [
    REPO / "config" / "inference" / "deterministic_inference_demo.yaml",
    REPO / "config" / "inference" / "stenosis70_probing_val.yaml"]
TINY = ["--frames", "4", "--resize", "32", "--batch_size", "2", "--vit_dim", "32",
        "--vit_depth", "1", "--vit_heads", "1", "--embedding_dim", "16",
        "--num_heads", "2", "--aggregator_depth", "1", "--precision", "fp32",
        "--use_pallas_attention", "false", "--num_videos", "2", "--epochs", "1",
        "--vit_pool_stages", "[]", "--attention_hidden", "8", "--num_workers", "1",
        "--ci_n_bootstrap", "20"]


@pytest.fixture(scope="module")
def yaml_manifest(tmp_path_factory):
    """Two to four studies of 2 clips in each split the shipped YAMLs name,
    with the label columns of their heads (a head without a column reads 0)."""
    root = tmp_path_factory.mktemp("yamls")
    r = np.random.default_rng(1)
    rows = []
    for split, n in (("train", 4), ("val", 2), ("diagnostic", 2), ("POST_PCI", 2),
                     ("inference", 3)):
        for s in range(n):
            for c in range(2):
                p = root / f"{split}_{s}_{c}.npy"
                np.save(p, r.integers(0, 255, size=(4, 32, 32, 3)).astype(np.uint8))
                rows.append({
                    "FileName": str(p), "StudyInstanceUID": f"S{s}", "Split": split,
                    "stenosis": 30.0 * s, "stenosis_binary": float(s % 2),
                    "calcif_binary": float(c), "CTO": float(s == 1), "cto": float(s % 2),
                    "syntax_left": 2.0 * s, "syntax_right": 1.0 + s,
                    "syntax_category": ("low", "intermediate", "high")[s % 3],
                    "Value": 55.0 + s, "y_true_cat": float(s % 2), "ifr": 0.8 + 0.05 * s,
                    "diabetes": float(s % 2), "mace_730d": float(s == 0),
                    "prox_rca_stenosis": 10.0 * s, "prox_lad_stenosis": 5.0 * s,
                    "view_class": ("AP", "LAO Caudal", "RAO Cranial")[(s + c) % 3]})
    write_csv(root / "m.csv", list(rows[0]), rows)
    return root


@pytest.mark.parametrize("path", PROBING_YAMLS,
                         ids=lambda p: f"{p.parent.name}/{p.stem}")
def test_shipped_probing_yaml_runs_through_main(path, yaml_manifest):
    """The YAML reads field for field as the JAX parser reads it, and one
    tiny epoch (or its validation / inference pass) runs through the port's
    ``main`` on the CPU at its own heads, losses, pooling, views and split."""
    got = tconfigs.parse_config(["--base_config", str(path)])
    ref = jax_parse_config(["--base_config", str(path)]).to_dict()
    for key, val in got.to_dict().items():
        if key not in ("is_ref_device", "process_index", "process_count", "world_size",
                       *tconfigs.PORT_FIELDS):
            assert val == ref[key], key
    out = yaml_manifest / "runs" / f"{path.parent.name}_{path.stem}"
    result = main(["--base_config", str(path), *TINY, *STATS, "--device", "cpu",
                   "--data_filename", str(yaml_manifest / "m.csv"), "--output_dir", str(out)])
    run = _run_dir(out)
    if got.run_mode == "train":
        assert len(result["history"]) == 1 and np.isfinite(result["history"][0]["loss"])
        assert (run / "checkpoints" / "checkpoint.pt").exists()
        assert (run / "val" / "predictions_epoch_0.csv").exists()
    elif got.run_mode == "val":
        assert np.isfinite(result["loss"])
        assert any(k.endswith("_ci") for k in result)
    else:
        split = got.split_filter or "inference"
        studies = {"diagnostic": 2, "POST_PCI": 2, "inference": 3, "all": 4}[split]
        assert result["rows"] == studies
        emb = np.load(run / "inference" / (got.embedding_output_file or "study_embeddings.npz"))
        assert emb["embeddings"].shape[0] == studies
        assert np.isfinite(emb["embeddings"]).all()


def test_probing_project_is_registered():
    from deepcoro_clip_tpu_torch.registry import ProjectRegistry, RunnerRegistry, register_all

    register_all()
    assert ProjectRegistry.get("DeepCORO_video_linear_probing").__name__ == \
        "LinearProbingProject"
    assert RunnerRegistry.get("DeepCORO_video_linear_probing") is tlp.LinearProbingRunner


def test_nonfinite_loss_saves_a_snapshot_and_raises(workspace, tmp_path):
    """As the port's other runners (``runners/common.run_pipelined_epoch``):
    a non-finite loss writes ``nan_debug`` and raises (the JAX probing runner
    averages it into the epoch, ROADMAP Queue 3)."""
    cfg = tconfigs.LinearProbingConfig.from_dict(_cfg(workspace, device="cpu"))
    r = tlp.LinearProbingRunner(cfg, output_dir=tmp_path / "nan")
    with torch.no_grad():
        r.state.params["mil.head_stenosis.bias"].fill_(float("nan"))
    with pytest.raises(tlp.NonFiniteLossError, match="non-finite loss"):
        r.train()
    assert r.ckpt.load_meta("nan_debug")["nan_loss_at_step"] == 0
    assert not r.ckpt.latest_exists()
