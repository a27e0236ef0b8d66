"""The port's contrastive run data-parallel on the CPU: two ``gloo`` ranks
through the port's ``main``, against the JAX runner on a data=2 mesh.

The workspace is the one of ``tests/test_torch_runner.py`` with one more
validation clip: 8 train and 5 validation clips of 8 x 32 x 32, batch 4, so
that the last validation batch holds one row, which the second rank gets
as padding. The run is ``config/quality/flagship_quality_train.yaml`` at
tiny widths, fp32, dropout 0, 2 epochs of 2 steps, ``mesh_data: 2``. The
JAX ``main`` (its runner at data=2) writes its initial tree; the ranks
(``tests/test_torch_ddp_workers.run_mains``, children that import the port
only) and a one-process run of the port's ``main`` start from it
(``init_from_checkpoint``). The text head's projection
dropout, which no config field reaches, is off on every side.

- Per epoch the train loss, alignment, temperature, the gradient norms and
  the validation loss, alignment, Recall@1, MRR, MAP and median rank of both
  ranks against the JAX runner's, relative 1e-4 (fp32 sums in another
  order, as ``tests/test_torch_runner.py``; the alignments, mean cosines
  near 0 here, to 2e-6 absolute); the two ranks' histories are equal; the
  world-2 run against the one-process run, relative 1e-5.
- Every file of the run is written by rank 0 (an audit hook records what
  each rank opens for writing).
- Resume at world 2: a run stopped after epoch 0 and resumed ends with the
  parameters of an uninterrupted world-2 run, bit for bit, at dropout 0.1
  (each rank's generator is restored from the checkpoint).
- A one-process checkpoint resumed at world 2.
- A ``batch_size`` the world does not divide raises on both ranks; so does
  ``mesh_model`` 2 (tensor parallelism) with ``mesh_data`` 2, which the
  two ranks cannot hold, while the same config with ``mesh_data`` -1
  builds the grid ``(data 1, model 2)`` on both.
- ``run_mode: inference`` (``embedding_extraction.yaml``) sharded and
  gathered: the same file as the one-process run's; a multitask and a
  probing run (one epoch each, the heads' labels added to the workspace)
  against their one-process runs.
- The command a user types, ``python -m torch.distributed.run --standalone
  --nproc_per_node 2 -m deepcoro_clip_tpu_torch.main --base_config
  config/quality/flagship_quality_train.yaml --device cpu`` at tiny widths:
  ``main`` starts the group itself, trains, validates and checkpoints; with a
  ``batch_size`` two ranks do not divide the launch exits non-zero.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from deepcoro_clip_tpu.main import main as jax_main
from deepcoro_clip_tpu.registry import register_all as jax_register_all
from deepcoro_clip_tpu.runners.contrastive import (
    VideoContrastiveLearningRunner as JaxRunner,
)
from deepcoro_clip_tpu.train import clip as jclip

from deepcoro_clip_tpu_torch import convert
from deepcoro_clip_tpu_torch.data.csv_utils import write_csv
from deepcoro_clip_tpu_torch.main import main
from deepcoro_clip_tpu_torch.runners import contrastive as trun
from deepcoro_clip_tpu_torch.runners import multitask as mrun

from tests import test_torch_ddp_workers as workers

jax_register_all()

REPO = Path(__file__).resolve().parents[1]
QUALITY_YAML = REPO / "config/quality/flagship_quality_train.yaml"
WORLD = 2
HEADS = ("stenosis", "stenosis_binary", "calcif_binary", "CTO")
RTOL = 1e-4
# the alignments are means of cosines, here near 0 (0.0021 at epoch 1):
# fp32 rounding of the cosines, not a relative error, bounds them
ALIGN_ATOL = 2e-6
PARAM_ATOL = 3e-5
EPOCH_KEYS = ("loss", "alignment", "temperature", "grad_norm", "grad_norm_video_encoder",
              "grad_norm_text_encoder", "lr", "val_loss", "val_alignment", "val_MRR",
              "val_MAP", "val_MedianRank", "val_Recall@1")


def _cfg(root: Path, **over):
    """``config/quality/flagship_quality_train.yaml`` on the workspace at tiny
    widths, fp32, dropout 0, ``mesh_data: 2``."""
    cfg = yaml.safe_load(QUALITY_YAML.read_text())
    cfg.update(
        data_filename=str(root / "data.csv"), output_dir=str(root / "outputs"),
        epochs=2, batch_size=4, frames=4, resize=32, num_workers=2,
        vit_dim=32, vit_depth=1, vit_heads=1, vit_pool_stages=[],
        text_dim=32, text_depth=1, text_heads=2, max_text_length=16,
        embedding_dim=16, num_heads=2, aggregator_depth=1,
        dropout=0.0, precision="fp32", use_pallas_attention=False,
        mesh_data=WORLD, mesh_model=1,
    )
    cfg.update(over)
    return cfg


def _yaml(root: Path, name: str, **over) -> str:
    path = root / f"{name}.yaml"
    path.write_text(yaml.safe_dump(_cfg(root, output_dir=str(root / name), **over)))
    return str(path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX history, the two ranks' job results, the one-process port
    results, and the workspace. The ranks run while the JAX run trains."""
    root = tmp_path_factory.mktemp("ddp")
    r = np.random.default_rng(0)
    rows = []
    for i in range(13):
        p = root / f"clip{i}.npy"
        np.save(p, r.integers(0, 255, size=(8, 32, 32, 3)).astype(np.uint8))
        rows.append({"FileName": str(p),
                     "Report": f"left main stenosis {i % 3} severity report",
                     "StudyInstanceUID": f"S{i}",
                     "Split": "train" if i < 8 else "val"})
    for i in range(5):  # the inference split: 5 studies of one clip
        rows.append({"FileName": str(root / f"clip{i}.npy"), "Report": "",
                     "StudyInstanceUID": f"I{i}", "Split": "inference"})
    for i, row in enumerate(rows):  # the probing heads' labels
        row.update(stenosis=f"{r.random():.3f}", stenosis_binary=str(i % 2),
                   calcif_binary=str((i // 2) % 2), CTO=str(int(i % 3 == 0)))
    write_csv(root / "data.csv", ["FileName", "Report", "StudyInstanceUID", "Split",
                                  *HEADS], rows)
    init = root / "init.npz"
    cpu = ["--device", "cpu", "--init_from_checkpoint", str(init)]
    mp = pytest.MonkeyPatch()
    one = {}
    waits = []
    jinit = JaxRunner.__init__

    def wrapped(self, *a, **kw):
        jinit(self, *a, **kw)
        self.bundle = self.bundle._replace(
            text_model=self.bundle.text_model.clone(proj_dropout=0.0))
        self.train_step = jclip.make_train_step(self.bundle)
        self.eval_step = jclip.make_eval_step(self.bundle)
        convert.save_params_npz(jax.tree_util.tree_map(np.asarray, self.state.params), init)
        # a one-process run stopped after epoch 0, for the world-2 resume
        one["cut"] = _port_main(mp, ["--base_config", _yaml(root, "one_cut", mesh_data=-1)]
                                + cpu, cut=True)
        jobs = [
            {"argv": ["--base_config", _yaml(root, "world2")] + cpu},
            {"argv": ["--base_config", _yaml(root, "cut", dropout=0.1)] + cpu, "cut": True},
            {"argv": ["--base_config", _yaml(root, "cut", dropout=0.1)] + cpu,
             "resume_from": 1},
            {"argv": ["--base_config", _yaml(root, "full", dropout=0.1)] + cpu},
            {"argv": ["--base_config", _yaml(root, "one_cut", mesh_data=-1)] + cpu
             + ["--resume_training", "true", "--checkpoint", one["cut"]["output_dir"]]},
            {"argv": ["--base_config", _yaml(root, "odd", batch_size=3)] + cpu,
             "expect_error": True},
            {"argv": ["--base_config", _yaml(root, "tp", mesh_model=2)] + cpu,
             "expect_error": True},
            {"argv": _inference_argv(root, root / "world2" / "inference")},
            {"argv": _multitask_argv(root, "multitask2")},
            {"argv": _probing_argv(root, "probing2")},
            {"argv": ["--base_config", _yaml(root, "tp_grid", mesh_model=2, mesh_data=-1)]
             + cpu, "grid_only": True},
        ]
        waits.append(workers.start(workers.run_mains, WORLD, root / "ranks", jobs,
                                   str(root / "world2")))

    mp.setattr(JaxRunner, "__init__", wrapped)
    jax_yaml = _yaml(root, "jax")
    jhist = jax_main(["--base_config", jax_yaml])["history"]
    mp.undo()
    one["full"] = _port_main(mp, ["--base_config", _yaml(root, "one", mesh_data=-1)] + cpu)
    one["inference"] = _port_main(mp, _inference_argv(root, root / "one_inference"))
    one["multitask"] = _port_main(mp, _multitask_argv(root, "multitask1"))
    one["probing"] = _port_main(mp, _probing_argv(root, "probing1"))
    ranks = waits[0]()
    return jhist, ranks, one, root


def _port_main(mp, argv, cut=False):
    """The port's ``main`` in this process (world 1), the text head's
    projection dropout off; ``cut`` stops it after epoch 0."""
    runner = trun.VideoContrastiveLearningRunner
    train = runner.train
    inits = {cls: cls.__init__ for cls in (runner, mrun.MultitaskRunner)}
    for cls, init in inits.items():
        mp.setattr(cls, "__init__", _without_text_dropout(init))
    if cut:
        mp.setattr(runner, "train",
                   lambda self, start_epoch=0, end_epoch=None: train(self, start_epoch, 1))
    try:
        out = main(argv)
    finally:
        for cls, init in inits.items():
            mp.setattr(cls, "__init__", init)
        mp.setattr(runner, "train", train)
    return {k: out.get(k) for k in ("history", "output_dir", "inference_rows")}


def _without_text_dropout(init):
    def wrapped(self, *a, **kw):
        init(self, *a, **kw)
        self.bundle.text_model.proj.dropout = 0.0

    return wrapped


def _multitask_argv(root: Path, name: str) -> list:
    """``config/multitask/multitask_config.yaml`` at tiny widths on the
    workspace's studies, one epoch at batch 2, dropout 0 and the MVM task's
    weight 0 (each rank draws its own MVM mask)."""
    return ["--base_config", "config/multitask/multitask_config.yaml", "--device", "cpu",
            "--data_filename", str(root / "data.csv"), *TINY_CLI, "--batch_size", "2",
            "--num_videos", "2", "--dropout", "0", "--decoder_dim", "16",
            "--decoder_depth", "1", "--decoder_heads", "2", "--decoder_max_length", "16",
            "--mvm_decoder_dim", "8", "--mvm_decoder_depth", "1",
            "--loss_weights", "{contrastive: 1.0, captioning: 1.0, mvm: 0.0}",
            "--output_dir", str(root / name)]


def _probing_argv(root: Path, name: str) -> list:
    """``config/linear_probing/stenosis_config.yaml`` at tiny widths on the
    workspace's studies (the heads' labels), one epoch at batch 2, dropout
    0, the encoder from the seed."""
    return ["--base_config", "config/linear_probing/stenosis_config.yaml", "--device", "cpu",
            "--data_filename", str(root / "data.csv"), *VIDEO_CLI, "--batch_size", "2",
            "--num_videos", "2", "--dropout", "0", "--dropout_attention", "0",
            "--attention_hidden", "8", "--output_dir", str(root / name)]


def _inference_argv(root: Path, results: Path) -> list:
    """``config/inference/embedding_extraction.yaml`` at tiny widths over the
    workspace's inference split (5 studies at batch 2: the last batch holds
    one row), the weights from the seed, the embeddings into ``results``."""
    return ["--base_config", "config/inference/embedding_extraction.yaml", "--device", "cpu",
            "--data_filename", str(root / "data.csv"), *TINY_CLI, "--batch_size", "2",
            "--num_videos", "2", "--output_dir", str(root / "inference_runs"),
            "--inference_results_path", str(results)]


def _untimed(h):
    """An epoch's entry without its host times (each rank reads its own
    clock)."""
    return {k: v for k, v in h.items()
            if k not in ("loader_wait_ms", "epoch_seconds", "val_seconds",
                         "val_metrics_seconds")}


def _final_params(run_dir):
    return torch.load(Path(run_dir) / "checkpoints" / "checkpoint.pt",
                      weights_only=True)


def test_world2_matches_jax_per_epoch(runs):
    """Both ranks' per-epoch metrics and per-block gradient norms within
    relative 1e-4 of the JAX runner's on the data=2 mesh; the ranks' own
    histories are equal."""
    jhist, ranks, _, _ = runs
    a, b = (r[0]["history"] for r in ranks)
    assert [_untimed(h) for h in a] == [_untimed(h) for h in b]
    assert len(jhist) == len(a) == 2
    for j, t in zip(jhist, a):
        blocks = [k for k in j if k.startswith("grad_norm_video_")]
        assert "grad_norm_video_block0" in blocks
        for key in EPOCH_KEYS + tuple(blocks):
            np.testing.assert_allclose(t[key], j[key], rtol=RTOL,
                                       atol=ALIGN_ATOL if "alignment" in key else 1e-7,
                                       err_msg=f"epoch {t['epoch']} {key}")


def test_uneven_last_validation_batch_matches_world_1(runs):
    """5 validation clips at batch 4: the second batch's one row is padded
    for the second rank; every validation metric and every train metric of
    the world-2 run within relative 1e-5 of the one-process run's."""
    _, ranks, one, _ = runs
    for t, w1 in zip(ranks[0][0]["history"], one["full"]["history"]):
        for key in EPOCH_KEYS + ("val_Recall@1",):
            np.testing.assert_allclose(t[key], w1[key], rtol=1e-5, atol=1e-7, err_msg=key)


def test_rank_0_writes_every_file(runs):
    """The run's checkpoints, history, validation artifacts and config
    backup exist once, and no file of it was opened for writing by rank 1."""
    _, ranks, _, root = runs
    run = Path(ranks[0][0]["output_dir"])
    assert run == Path(ranks[1][0]["output_dir"]) and run.is_relative_to(root / "world2")
    assert ranks[1][-1]["written"] == []
    written = ranks[0][-1]["written"]
    for name in ("checkpoints/checkpoint.pt", "metrics.jsonl", "config.yaml",
                 "val/retrieval_results_epoch_1.csv"):
        assert (run / name).exists() and any(w.startswith(str(run / name))
                                             for w in written), name
    assert len(list((root / "world2").rglob("checkpoints"))) == 1
    saved = torch.load(run / "checkpoints" / "checkpoint.pt", weights_only=True)
    assert len(saved["generators"]) == WORLD and saved["step"] == 4


def test_resume_at_world_2_repeats_the_uninterrupted_run(runs):
    """Dropout 0.1: stopped after epoch 0 and resumed at world 2, the run
    ends with the uninterrupted world-2 run's parameters, bit for bit, and
    its epoch-1 losses; the two ranks' generators differ."""
    _, ranks, _, _ = runs
    cut, resumed, full = ranks[0][1:4]
    assert [h["epoch"] for h in cut["history"]] == [0]
    assert [h["epoch"] for h in resumed["history"]] == [1]
    assert resumed["output_dir"] == cut["output_dir"]
    assert resumed["history"][0]["loss"] == full["history"][1]["loss"]
    assert resumed["history"][0]["val_loss"] == full["history"][1]["val_loss"]
    a, b = _final_params(full["output_dir"]), _final_params(cut["output_dir"])
    for k in a["params"]:
        assert torch.equal(a["params"][k], b["params"][k]), k
    g0, g1 = a["generators"]
    assert not torch.equal(g0, g1)
    assert all(torch.equal(x, y) for x, y in zip(a["generators"], b["generators"]))


def test_one_process_checkpoint_resumes_at_world_2(runs):
    """A world-1 run stopped after epoch 0, resumed by two ranks: epoch 1
    runs from its parameters and ends within fp32 rounding of the
    one-process run's epoch 1 (dropout 0: no generator state matters):
    losses relative 1e-5, parameters atol 3e-5 (1% of what Adam moves a
    parameter in these steps, the tolerance of ``tests/test_torch_train.py``,
    the key bias's middle third left out: its gradient is rounding noise)."""
    _, ranks, one, _ = runs
    resumed = ranks[0][4]
    assert resumed["output_dir"] == one["cut"]["output_dir"]
    assert [h["epoch"] for h in resumed["history"]] == [1]
    np.testing.assert_allclose(resumed["history"][0]["loss"],
                               one["full"]["history"][1]["loss"], rtol=1e-5)
    np.testing.assert_allclose(resumed["history"][0]["val_loss"],
                               one["full"]["history"][1]["val_loss"], rtol=1e-5)
    a = _final_params(one["cut"]["output_dir"])
    b = _final_params(one["full"]["output_dir"])
    for k in a["params"]:
        x, y = a["params"][k].numpy(), b["params"][k].numpy()
        if k.endswith("attn.qkv.bias"):  # the key bias: its gradient is noise
            n = x.shape[0] // 3
            x, y = np.delete(x, slice(n, 2 * n)), np.delete(y, slice(n, 2 * n))
        np.testing.assert_allclose(x, y, atol=PARAM_ATOL, rtol=0, err_msg=k)


def test_batch_size_and_ring_raise_on_every_rank(runs):
    """A batch the data axis does not divide raises; ``mesh_model`` 2
    without the ring (tensor parallelism) builds its grid on both ranks,
    and with a ``mesh_data`` the ranks cannot hold still raises."""
    _, ranks, _, _ = runs
    for r in ranks:
        odd, tp_data, tp = r[5]["error"], r[6]["error"], r[10]
        assert odd.startswith("ValueError") and "gcd(2, 3)" in odd
        assert tp_data.startswith("ValueError") and "mesh_data=2" in tp_data
        assert "set -1 or 1" in tp_data
        assert tp == {"grid": {"data": 1, "model": 2}}


VIDEO_CLI = ["--frames", "4", "--resize", "32", "--vit_dim", "32", "--vit_depth", "1",
             "--vit_heads", "1", "--vit_pool_stages", "[]", "--embedding_dim", "16",
             "--num_heads", "2", "--precision", "fp32", "--num_workers", "1", "--epochs", "1"]
TINY_CLI = VIDEO_CLI + ["--text_dim", "32", "--text_depth", "1", "--text_heads", "2",
                        "--max_text_length", "16", "--aggregator_depth", "1"]


def _torchrun(root: Path, *extra: str) -> subprocess.CompletedProcess:
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "2", "-m", "deepcoro_clip_tpu_torch.main",
           "--base_config", "config/quality/flagship_quality_train.yaml", "--device", "cpu",
           "--data_filename", str(root / "data.csv"), "--output_dir", str(root / "cli"),
           *TINY_CLI, *extra]
    env = dict(os.environ, OMP_NUM_THREADS="2")
    return subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=240)


def test_torch_distributed_run_command_on_the_cpu(runs):
    """The launch command of the README, at tiny widths: exit 0, the group
    started by main (gloo, world 2), one epoch trained, validated and
    checkpointed in one run directory."""
    root = runs[3]
    proc = _torchrun(root, "--batch_size", "4")
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "data parallel: world 2, backend gloo" in proc.stdout
    assert "[deepcoro_clip_tpu_torch] done:" in proc.stdout
    (ck,) = list((root / "cli").rglob("checkpoints"))
    saved = torch.load(ck / "checkpoint.pt", weights_only=True)
    assert saved["step"] == 2 and len(saved["generators"]) == 2
    assert (ck.parent / "val" / "retrieval_results_epoch_0.csv").exists()


def test_a_failing_rank_fails_the_launch(runs):
    """``batch_size`` 3 over 2 ranks raises in main on every rank: the
    launch exits non-zero and names the error."""
    proc = _torchrun(runs[3], "--batch_size", "3")
    assert proc.returncode != 0
    assert "gcd(2, 3)" in proc.stdout + proc.stderr


def test_inference_sharded_and_gathered_equals_world_1(runs):
    """``run_mode: inference`` at world 2 (each rank encodes its rows of a
    batch, the last batch's one row padded for the second rank): the study
    embeddings file holds the one-process run's rows in the same order
    (paths equal, embeddings within 1e-5 relative / 1e-6 absolute: fp32
    sums over other batch compositions), written by rank 0 alone."""
    _, ranks, one, root = runs
    assert [r[7]["inference_rows"] for r in ranks] == [5, 5]
    assert one["inference"]["inference_rows"] == 5
    a = np.load(root / "world2" / "inference" / "video_embeddings.npz")
    b = np.load(root / "one_inference" / "video_embeddings.npz")
    assert list(a["paths"]) == list(b["paths"]) and len(a["paths"]) == 5
    np.testing.assert_allclose(a["video_embeddings"], b["video_embeddings"], rtol=1e-5,
                               atol=1e-6)
    assert ranks[1][-1]["written"] == []
    assert any(w.endswith("video_embeddings.npz") for w in ranks[0][-1]["written"])


@pytest.mark.parametrize("pipeline", ["multitask", "probing"])
def test_multitask_and_probing_runs_equal_world_1(runs, pipeline):
    """The multitask and the probing runs through two ranks' ``main``: one
    epoch, the validation's last batch padded for the second rank; every
    metric of the epoch (losses, BLEU / ROUGE-L / METEOR of the gathered
    greedy captions; the heads' metrics from the gathered outputs) within
    relative 1e-5 of the one-process run's (the multitask ``loss_mvm`` apart:
    each rank draws its own MVM mask, and the task's weight is 0), the two
    ranks' histories equal."""
    _, ranks, one, _ = runs
    job = {"multitask": 8, "probing": 9}[pipeline]
    a, b = (_untimed(r[job]["history"][0]) for r in ranks)
    w1 = _untimed(one[pipeline]["history"][0])
    assert a == b
    assert set(a) == set(w1) and len(a) > 5
    for key in sorted(set(a) - {"loss_mvm"}):
        np.testing.assert_allclose(a[key], w1[key], rtol=1e-5, atol=1e-7, err_msg=key)
