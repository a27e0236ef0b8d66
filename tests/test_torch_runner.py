"""The port's contrastive run end to end on the CPU, against the JAX runner.

The workspace is the one of ``tests/runners/test_contrastive_runner.py``:
12 clips of 8 x 32 x 32 on disk behind an ``α``-separated manifest (8
train, 4 val), a tiny fp32 model, dropout 0, 2 epochs of 2 steps. The JAX
runner (``use_pallas_attention: false``) is built once for the module; its
initial parameters go through ``convert.save_params_npz`` into the port's
``init_from_checkpoint``, and the text head's ``proj_dropout`` (which no
config field reaches, 0.1 in both packages) is set to 0 on both sides, as in
``tests/test_torch_train.py``. The data order (``ShardedBatchSampler``), the
tokenizer and the dataset statistics are each package's own. Per epoch the
train loss, alignment, temperature, the per-block gradient norms, the
validation loss, alignment, Recall@1, MRR, MAP and median rank must agree to a relative
1e-4 (fp32 sums in another order).

Resume: a run stopped after epoch 0 and resumed through ``main`` ends with
parameters bit-equal to an uninterrupted run's (dropout on, so the
checkpointed generator state matters).
"""

import json
import math
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from deepcoro_clip_tpu.configs.parser import parse_config as jax_parse_config
from deepcoro_clip_tpu.registry import register_all as jax_register_all
from deepcoro_clip_tpu.runners.contrastive import (
    VideoContrastiveLearningRunner as JaxRunner,
)
from deepcoro_clip_tpu.train import clip as jclip
from deepcoro_clip_tpu.train.checkpoint import CheckpointManager as JaxCheckpointManager

from deepcoro_clip_tpu_torch import configs as tconfigs
from deepcoro_clip_tpu_torch import convert
from deepcoro_clip_tpu_torch.data.csv_utils import write_csv
from deepcoro_clip_tpu_torch.main import main
from deepcoro_clip_tpu_torch.runners import contrastive as trun
from deepcoro_clip_tpu_torch.train.checkpoint import CheckpointManager

from tests.single_head_runs import siglip_corpus, single_head_yaml

jax_register_all()

REPO = Path(__file__).resolve().parents[1]
RTOL = 1e-4
# (the workspace's 4 validation reports are 3 distinct texts: Recall@5 and
# NDCG@5 are left out of the panel by both packages)
EPOCH_KEYS = ("loss", "alignment", "temperature", "grad_norm", "grad_norm_video_encoder",
              "grad_norm_text_encoder", "lr", "val_loss", "val_alignment", "val_MRR",
              "val_MAP", "val_MedianRank", "val_Recall@1")


def _cfg(root: Path, **over):
    cfg = dict(
        pipeline_project="DeepCORO_clip", run_mode="train",
        data_filename=str(root / "data.csv"), output_dir=str(root / "outputs"),
        epochs=2, batch_size=4, frames=4, resize=32, num_workers=2, multi_video=False,
        vit_dim=32, vit_depth=1, vit_heads=1, vit_patch=[2, 16, 16],
        text_dim=32, text_depth=1, text_heads=2, text_vocab_size=512,
        max_text_length=16, embedding_dim=16, num_heads=2, aggregator_depth=1,
        dropout=0.0, lr=1e-3, precision="fp32", use_pallas_attention=False,
        use_wandb=False, recall_k=[1, 5], ndcg_k=[5], mesh_data=-1, mesh_model=1,
        seed=0, log_layer_grad_norms=True,
    )
    cfg.update(over)
    return cfg


def _write_yaml(path: Path, cfg: dict) -> Path:
    path.write_text(yaml.safe_dump(cfg))
    return path


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp("ws")
    r = np.random.default_rng(0)
    rows = []
    for i in range(12):
        p = root / f"clip{i}.npy"
        np.save(p, r.integers(0, 255, size=(8, 32, 32, 3)).astype(np.uint8))
        rows.append({"FileName": str(p),
                     "Report": f"left main stenosis {i % 3} severity report",
                     "StudyInstanceUID": f"S{i}",
                     "Split": "train" if i < 8 else "val"})
    write_csv(root / "data.csv", ["FileName", "Report", "StudyInstanceUID", "Split"], rows)
    return root


@pytest.fixture(scope="module")
def runs(workspace):
    """(JAX history, port history, port runner) over the same 2 epochs."""
    path = _write_yaml(workspace / "parity.yaml", _cfg(workspace))
    jr = JaxRunner(jax_parse_config(["--base_config", str(path)]),
                   output_dir=workspace / "jax_run")
    jr.bundle = jr.bundle._replace(text_model=jr.bundle.text_model.clone(proj_dropout=0.0))
    jr.train_step = jclip.make_train_step(jr.bundle)
    jr.eval_step = jclip.make_eval_step(jr.bundle)
    init = workspace / "init.npz"
    convert.save_params_npz(jax.tree_util.tree_map(np.asarray, jr.state.params), init)
    jhist = jr.train()["history"]

    cfg = tconfigs.parse_config(["--base_config", str(path), "--device", "cpu",
                                 "--init_from_checkpoint", str(init)])
    tr = trun.VideoContrastiveLearningRunner(cfg, output_dir=workspace / "port_run")
    tr.bundle.text_model.proj.dropout = 0.0
    thist = tr.train()["history"]
    return jhist, thist, tr


def test_init_from_jax_npz_loads_every_leaf(runs, workspace):
    """The port's initial parameters are the JAX runner's, leaf for leaf."""
    tr = runs[2]
    fresh = trun.VideoContrastiveLearningRunner(tr.config, output_dir=workspace / "fresh")
    want = convert.flatten_tree(convert.load_params_npz(workspace / "init.npz"))
    p = fresh.state.params
    got = convert.flatten_tree(convert.training_tree(
        fresh.bundle.video_model, fresh.bundle.text_model, p["log_temp"], p["logit_bias"]))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_runner_matches_jax_per_epoch(runs):
    """Two epochs: every listed per-epoch metric and every per-block
    gradient norm within relative 1e-4 of the JAX runner's."""
    jhist, thist, _ = runs
    assert len(jhist) == len(thist) == 2
    for j, t in zip(jhist, thist):
        blocks = [k for k in j if k.startswith("grad_norm_video_")]
        assert "grad_norm_video_block0" in blocks
        assert sorted(k for k in t if k.startswith("val_Recall@")) == ["val_Recall@1"]
        for key in EPOCH_KEYS + tuple(blocks):
            assert key in j and key in t, key
            np.testing.assert_allclose(t[key], j[key], rtol=RTOL, atol=1e-7,
                                       err_msg=f"epoch {t['epoch']} {key}")


def test_history_keys_match_jax(runs):
    """The port's history has the JAX runner's keys, plus the loader's wait
    and the validation pass's time."""
    jhist, thist, _ = runs
    for j, t in zip(jhist, thist):
        assert set(t) - set(j) == {"loader_wait_ms", "val_seconds"}
        assert set(j) <= set(t)
        assert t["loader_wait_ms"] >= 0.0 and t["val_seconds"] > 0.0


def test_checkpoints_and_artifacts(runs, workspace):
    """The latest, best-loss and highest-alignment checkpoints with their
    sidecars; one of each kind; the validation artifacts."""
    run = workspace / "port_run"
    ck = run / "checkpoints"
    names = sorted(p.name for p in ck.iterdir())
    assert "checkpoint.pt" in names and "checkpoint.json" in names
    for prefix in ("best_model_epoch_", "highest_alignment_epoch_"):
        kind = [n for n in names if n.startswith(prefix)]
        assert len(kind) == 2 and {Path(n).suffix for n in kind} == {".pt", ".json"}, kind
    meta = json.loads((ck / "checkpoint.json").read_text())
    assert {"epoch", "train_loss", "val_loss", "alignment", "temperature", "best_val_loss",
            "best_epoch", "highest_alignment", "dataset_mean", "dataset_std"} <= set(meta)
    assert meta["epoch"] == 1
    saved = torch.load(ck / "checkpoint.pt", weights_only=True)
    assert {"step", "params", "opt_state", "generator", "meta"} <= set(saved)
    assert saved["step"] == 4 and int(saved["opt_state"]["count"]) == 4
    lines = (run / "metrics.jsonl").read_text().splitlines()
    assert any("val/Recall@1" in line for line in lines)
    for name in ("unique_texts_epoch_1.csv", "retrieval_results_epoch_1.csv",
                 "text_embeddings_epoch_1.npz"):
        assert (run / "val" / name).exists(), name


def test_checkpoint_pruning_matches_jax(tmp_path):
    """save_best / save_alignment keep only the newest of each kind, as the
    JAX manager does; the latest and a debug snapshot stay."""
    from deepcoro_clip_tpu_torch.train.state import TrainState

    state = TrainState(step=3, params={"w": torch.ones(2)},
                       opt_state={"count": torch.tensor(3)})
    jstate = {"w": np.ones(2, np.float32)}
    t, j = CheckpointManager(tmp_path / "t"), JaxCheckpointManager(tmp_path / "j")
    for epoch in (0, 1, 3):
        for m, s in ((t, state), (j, jstate)):
            m.save_latest(s, {"epoch": epoch})
            m.save_best(s, epoch, {"epoch": epoch})
            if epoch != 1:
                m.save_alignment(s, epoch, {"epoch": epoch})
    t.save_debug("nan_debug", state, {})
    j.save_debug("nan_debug", jstate, {})

    def kinds(d):
        return sorted({p.name.split(".")[0] for p in d.iterdir()})

    assert kinds(tmp_path / "t") == kinds(tmp_path / "j") == [
        "best_model_epoch_3", "checkpoint", "highest_alignment_epoch_3", "nan_debug"]
    assert t.find_best() == j.find_best() == "best_model_epoch_3"
    assert t.load_meta("checkpoint") == j.load_meta("checkpoint") == {"epoch": 3}
    restored = t.restore(TrainState(step=0, params={"w": torch.zeros(2)},
                                    opt_state={"count": torch.tensor(0)}))
    assert restored.step == 3 and torch.equal(restored.params["w"], torch.ones(2))


def test_snapshots_of_the_latest_state_link_its_file(tmp_path):
    """A best or alignment snapshot of the state the latest checkpoint was
    just written from is that file (one write); another step, another meta
    or a generator drawn from since is written anew; the next latest
    checkpoint leaves the snapshot as it was."""
    from deepcoro_clip_tpu_torch.train.state import TrainState

    def state(step):
        return TrainState(step=step, params={"w": torch.full((2,), float(step))},
                          opt_state={"count": torch.tensor(step)})

    m, gen = CheckpointManager(tmp_path), torch.Generator().manual_seed(0)
    ck = tmp_path / "checkpoint.pt"
    s3 = state(3)
    m.save_latest(s3, {"epoch": 0}, gen)
    best = m.save_best(s3, 0, {"epoch": 0}, gen)
    align = m.save_alignment(s3, 0, {"epoch": 0}, gen)
    assert best.samefile(ck) and align.samefile(ck)
    assert json.loads((tmp_path / "best_model_epoch_0.json").read_text()) == {"epoch": 0}
    m.save_latest(state(5), {"epoch": 1}, gen)  # a new file moved into the latest's name
    assert torch.load(best, weights_only=True)["step"] == 3

    s4 = state(4)
    assert not m.save_best(s4, 1, {"epoch": 1}, gen).samefile(ck)  # not the latest's state
    m.save_latest(s4, {"epoch": 1}, gen)
    assert not m.save_best(s4, 1, {"epoch": 1, "best_epoch": 1}, gen).samefile(ck)  # meta
    torch.rand(1, generator=gen)
    drawn = m.save_alignment(s4, 1, {"epoch": 1}, gen)  # the generator moved
    assert not drawn.samefile(ck)
    assert not torch.equal(torch.load(drawn, weights_only=True)["generator"],
                           torch.load(ck, weights_only=True)["generator"])

    m.save_latest(state(9), {"epoch": 2}, gen)
    for name, step in (("best_model_epoch_1", 4), ("highest_alignment_epoch_1", 4),
                       ("checkpoint", 9)):
        saved = torch.load(tmp_path / f"{name}.pt", weights_only=True)
        assert saved["step"] == step and torch.equal(saved["params"]["w"],
                                                     torch.full((2,), float(step)))


def _final_params(run_dir: Path):
    return torch.load(Path(run_dir) / "checkpoints" / "checkpoint.pt",
                      weights_only=True)["params"]


def test_resume_repeats_the_uninterrupted_run(workspace, monkeypatch):
    """Through ``main`` on the CPU, dropout 0.1: a run stopped after epoch 0
    (its ``train`` cut at ``end_epoch=1``, as a killed run would stop) and
    resumed with ``resume_training`` + ``checkpoint`` ends bit-equal to an
    uninterrupted 2-epoch run: parameters, optimizer count, epoch-1 loss."""
    cfg = _cfg(workspace, dropout=0.1, output_dir=str(workspace / "resume"))
    path = _write_yaml(workspace / "resume.yaml", cfg)
    full = main(["--base_config", str(path), "--device", "cpu"])

    train = trun.VideoContrastiveLearningRunner.train
    monkeypatch.setattr(trun.VideoContrastiveLearningRunner, "train",
                        lambda self, start_epoch=0, end_epoch=None:
                        train(self, start_epoch, 1))
    cut = main(["--base_config", str(path), "--device", "cpu"])
    monkeypatch.undo()
    assert [h["epoch"] for h in cut["history"]] == [0]
    resumed = main(["--base_config", str(path), "--device", "cpu",
                    "--resume_training", "true", "--checkpoint", cut["output_dir"]])
    assert resumed["output_dir"] == cut["output_dir"]
    assert [h["epoch"] for h in resumed["history"]] == [1]
    assert resumed["history"][0]["loss"] == full["history"][1]["loss"]
    assert resumed["history"][0]["val_loss"] == full["history"][1]["val_loss"]
    a, b = _final_params(full["output_dir"]), _final_params(cut["output_dir"])
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    # dropout was on: the uninterrupted run differs from one without it
    assert full["history"][1]["loss"] != pytest.approx(
        main(["--base_config", str(path), "--device", "cpu", "--dropout", "0.0"]
             )["history"][1]["loss"], rel=1e-6)


def test_main_trains_on_the_cpu_and_backs_up_the_config(workspace):
    path = _write_yaml(workspace / "main.yaml",
                       _cfg(workspace, output_dir=str(workspace / "main_out"), epochs=1))
    result = main(["--base_config", str(path), "--device", "cpu"])
    assert len(result["history"]) == 1 and np.isfinite(result["history"][0]["loss"])
    backup = Path(result["output_dir"]) / "config.yaml"
    saved = json.loads(backup.read_text())
    assert saved["epochs"] == 1 and len(saved["dataset_mean"]) == 3
    # a YAML reader reads it too (PyYAML keeps "1e-07" a string; the
    # config class coerces it back)
    again = tconfigs.ClipConfig.from_dict(yaml.safe_load(backup.read_text()))
    assert again.to_dict() == tconfigs.ClipConfig.from_dict(saved).to_dict()


def test_nonfinite_loss_saves_a_snapshot_and_raises(workspace):
    cfg = tconfigs.parse_config(["--base_config", str(_write_yaml(
        workspace / "nan.yaml", _cfg(workspace))), "--device", "cpu"])
    r = trun.VideoContrastiveLearningRunner(cfg, output_dir=workspace / "nan_run")
    with torch.no_grad():
        r.state.params["log_temp"].fill_(float("nan"))
    with pytest.raises(trun.NonFiniteLossError, match="non-finite loss"):
        r.train()
    meta = r.ckpt.load_meta("nan_debug")
    assert meta["nan_loss_at_step"] == 0 and not r.ckpt.latest_exists()


def test_init_from_a_port_checkpoint(runs, workspace):
    """``init_from_checkpoint`` with a port ``.pt``: the parameters, not the
    optimizer state or the step."""
    tr = runs[2]
    ckpt = workspace / "port_run" / "checkpoints" / "checkpoint.pt"
    cfg = tconfigs.ClipConfig.from_dict(dict(tr.config.to_dict(),
                                             init_from_checkpoint=str(ckpt)))
    r = trun.VideoContrastiveLearningRunner(cfg, output_dir=workspace / "warm")
    saved = torch.load(ckpt, weights_only=True)["params"]
    for k, v in r.state.params.items():
        assert torch.equal(v.detach(), saved[k]), k
    assert r.state.step == 0 and int(r.state.opt_state["count"]) == 0


CLIP_YAMLS = sorted((REPO / "config" / "clip").glob("*.yaml")) + [
    REPO / "config" / "quality" / "flagship_quality_train.yaml"]


@pytest.mark.parametrize("path", CLIP_YAMLS, ids=lambda p: p.stem)
def test_shipped_clip_yaml_parses_as_in_jax(path):
    """Every shipped contrastive YAML reads, field for field as the JAX
    parser reads it, and the runner takes each (multivideo_config.yaml and
    siglip_multi_positive_config.yaml too: tests/test_torch_siglip.py runs
    them; siglip_single_head_config.yaml: tests/test_torch_single_head.py)."""
    got = tconfigs.parse_config(["--base_config", str(path)])
    ref = jax_parse_config(["--base_config", str(path)]).to_dict()
    for key, val in got.to_dict().items():
        if key not in ("is_ref_device", "process_index", "process_count", "world_size",
                       *tconfigs.PORT_FIELDS):
            assert val == ref[key], key
    assert tconfigs.unported_settings(got) == []
    trun.check_ported(got)


@pytest.mark.parametrize("over,match", [
    (dict(loss_name="siglip_single_head", siglip_sampler="single_head"), "single_head"),
    (dict(locca_enabled=True, locca_d_model=16, locca_num_layers=1, locca_num_heads=2,
          locca_max_seq_len=12), "locca"),
    (dict(run_mode="inference"), "inference"),
    (dict(siglip_sampler="single_head", loss_name="siglip_single_head",
          locca_enabled=True, locca_d_model=16, locca_num_layers=1, locca_num_heads=2,
          locca_max_seq_len=24), "single_head_locca"),
])
def test_unported_paths_raise_through_main(workspace, tmp_path, over, match):
    """The paths that raised before they were ported run through main now,
    and nothing is left that ``check_ported`` refuses: ``run_mode:
    inference`` (one row a clip, the averaged metadata of a seeded bank;
    tests/test_torch_inference.py holds it against the JAX runner), the
    single-head SigLIP sampler (on SigLIP manifests of a rendered corpus),
    the LocCa head on plain CLIP batches (the reports as its targets), and
    both together (tests/test_torch_single_head.py and
    tests/test_torch_locca.py hold them against the JAX package)."""
    if over.get("run_mode") == "inference":
        r = np.random.default_rng(1)
        np.savez(workspace / "bank.npz", text_embeddings=r.normal(size=(6, 16)))
        write_csv(workspace / "meta.csv", ["grade", "finding"],
                  [{"grade": float(i), "finding": "ab"[i % 2]} for i in range(6)], sep=",")
        # split_column names no column of the manifest: every clip is read
        over = dict(over, split_column="Mode", data_filename=str(workspace / "data.csv"),
                    dataset_mean=[120.0] * 3, dataset_std=[60.0] * 3, topk=3,
                    text_embeddings_path=str(workspace / "bank.npz"),
                    metadata_path=str(workspace / "meta.csv"),
                    inference_results_path=str(workspace / "inference"))
        path = _write_yaml(workspace / "inference.yaml",
                           _cfg(workspace, output_dir=str(workspace / "unported"), **over))
        result = main(["--base_config", str(path), "--device", "cpu"])
        rows = (workspace / "inference" / "averaged_metadata.csv").read_text().splitlines()
        assert result["inference_rows"] == 12 and len(rows) == 13
        assert rows[0] == "path,topk_indices,topk_scores,grade,finding"
        return
    cfg = _cfg(workspace, output_dir=str(tmp_path / "run"), epochs=1, **over)
    if over.get("siglip_sampler") == "single_head":
        paths = siglip_corpus(tmp_path, seed=2, n_train=8, n_val=4)["paths"]
        cfg = single_head_yaml(paths, tmp_path / "run", epochs=1, **{
            k: v for k, v in over.items() if k.startswith("locca_")})
    assert tconfigs.unported_settings(tconfigs.ClipConfig.from_dict(cfg)) == []
    path = _write_yaml(tmp_path / f"{match}.yaml", cfg)
    (h,) = main(["--base_config", str(path), "--device", "cpu"])["history"]
    assert math.isfinite(h["loss"]) and math.isfinite(h["val_loss"])
    assert ("locca_loss" in h) == ("locca" in match)
    if "locca" in match:
        assert math.isfinite(h["locca_loss"]) and h["grad_norm_locca_decoder"] > 0


def test_entry_point_defaults_to_the_card(workspace):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    path = _write_yaml(workspace / "card.yaml",
                       _cfg(workspace, output_dir=str(workspace / "card")))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--base_config", str(path)])


def test_clip_config_field_parity():
    """ClipConfig: every field of the JAX class, with its default, in order,
    and the port's own ``device`` (None: the card)."""
    import dataclasses

    from deepcoro_clip_tpu.configs.clip import ClipConfig as JaxClipConfig

    def fields(cls):
        return [(f.name, f.default if f.default is not dataclasses.MISSING
                 else f.default_factory()) for f in dataclasses.fields(cls)]

    port = fields(tconfigs.ClipConfig)
    assert [f for f in port if f[0] not in tconfigs.PORT_FIELDS] == fields(JaxClipConfig)
    assert [f for f in port if f[0] in tconfigs.PORT_FIELDS] == [("device", None)]


def test_chip_smoke_quality_config_is_the_shipped_yaml():
    """chip_smoke.py spells the flagship quality recipe out as a dict (the
    card machine need not have PyYAML): it equals the YAML as the port's
    parser reads it."""
    import chip_smoke

    want = tconfigs.parse_config(
        ["--base_config", str(REPO / "config" / "quality" / "flagship_quality_train.yaml")])
    assert chip_smoke.quality_train_config().to_dict() == want.to_dict()
