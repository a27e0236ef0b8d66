"""The port's contrastive ``run_mode: inference`` and its text-bank writer on
the CPU, against the JAX package.

The workspace: 12 clips ``.npy`` of 4 x 32 x 32 in 6 studies of 2 (split
``inference``), a tiny fp32 model. The JAX runner is built once; its
initial parameters go through ``convert.save_params_npz`` into the port's
``init_from_checkpoint``, as ``tests/test_torch_runner.py`` does.

- ``inference``: a seeded bank of 10 texts and a metadata table with a
  numeric column with empty cells, a string column with ties, a boolean
  column and an all-empty column; the top-k indices equal, the scores
  within relative 1e-4 or absolute 1e-5, the averaged metadata equal
  (pandas' mean, and the smallest of the tied modes), from a CSV and, with
  ``pyarrow``, a parquet table;
- ``average_metadata`` against pandas' ``mean`` / ``mode`` on columns
  built to tie;
- ``generate_embeddings``: the bank from a port checkpoint of the same
  weights against the JAX runner's ``_encode_texts`` (relative 1e-4);
- the three contrastive YAMLs of ``config/inference/`` parse as in JAX and
  run through the port's ``main`` at tiny width.
"""

import csv
from pathlib import Path

import jax
import numpy as np
import pandas as pd
import pytest
import torch
import yaml

from deepcoro_clip_tpu.configs.parser import parse_config as jax_parse_config
from deepcoro_clip_tpu.registry import register_all as jax_register_all
from deepcoro_clip_tpu.runners.contrastive import (
    VideoContrastiveLearningRunner as JaxRunner,
)

from deepcoro_clip_tpu_torch import configs as tconfigs
from deepcoro_clip_tpu_torch import convert, generate_embeddings
from deepcoro_clip_tpu_torch.data.csv_utils import write_csv
from deepcoro_clip_tpu_torch.main import main
from deepcoro_clip_tpu_torch.runners import contrastive as trun
from deepcoro_clip_tpu_torch.serve import load_text_bank

jax_register_all()

REPO = Path(__file__).resolve().parents[1]
RTOL = 1e-4
# a cosine near 0 has no relative precision: the scores (cosines, at most 1
# in size) also pass within 1e-5 absolute (fp32 embeddings summed in
# another order differ by ~1e-6)
SCORE_ATOL = 1e-5
BANK = 10


def _cfg(root: Path, **over):
    cfg = dict(
        pipeline_project="DeepCORO_clip", run_mode="inference",
        data_filename=str(root / "data.csv"), output_dir=str(root / "outputs"),
        batch_size=4, frames=4, resize=32, num_workers=2, multi_video=True, num_videos=2,
        vit_dim=32, vit_depth=1, vit_heads=1, vit_patch=[2, 16, 16],
        text_dim=32, text_depth=1, text_heads=2, text_vocab_size=512,
        max_text_length=16, embedding_dim=16, num_heads=2, aggregator_depth=1,
        dropout=0.0, precision="fp32", use_pallas_attention=False, use_wandb=False,
        seed=0, topk=4, dataset_mean=[120.0, 120.0, 120.0], dataset_std=[60.0, 60.0, 60.0],
        text_embeddings_path=str(root / "bank.npz"), metadata_path=str(root / "meta.csv"),
    )
    cfg.update(over)
    return cfg


def _write_yaml(path: Path, cfg: dict) -> Path:
    path.write_text(yaml.safe_dump(cfg))
    return path


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp("inf")
    r = np.random.default_rng(0)
    rows = []
    for i in range(12):
        p = root / f"clip{i}.npy"
        np.save(p, r.integers(0, 255, size=(4, 32, 32, 3)).astype(np.uint8))
        rows.append({"FileName": str(p), "Report": f"lad stenosis {i % 4} percent",
                     "StudyInstanceUID": f"S{i // 2}", "Split": "inference"})
    write_csv(root / "data.csv", list(rows[0]), rows)
    np.savez(root / "bank.npz", text_embeddings=r.normal(size=(BANK, 16)).astype(np.float32),
             texts=np.asarray([f"text {j}" for j in range(BANK)]))
    meta = pd.DataFrame({
        "stenosis_pct": [10.0, np.nan, 30.0, 70.0, np.nan, 90.0, 50.0, 20.0, 40.0, 60.0],
        "count": [1, 2, 3, 4, 5, 6, 7, 8, 9, 10],
        "finding": ["b", "a", "b", "a", None, "c", "a", "b", "c", None],
        "severe": [True, False, True, False, True, False, True, False, True, False],
        "empty": [np.nan] * BANK,
    })
    meta.to_csv(root / "meta.csv", index=False)
    return root


@pytest.fixture(scope="module")
def runners(workspace):
    """(JAX runner, port runner) on the same weights."""
    path = _write_yaml(workspace / "cfg.yaml", _cfg(workspace))
    jr = JaxRunner(jax_parse_config(["--base_config", str(path)]),
                   output_dir=workspace / "jax_run")
    init = workspace / "init.npz"
    convert.save_params_npz(jax.tree_util.tree_map(np.asarray, jr.state.params), init)
    cfg = tconfigs.parse_config(["--base_config", str(path), "--device", "cpu",
                                 "--init_from_checkpoint", str(init)])
    tr = trun.VideoContrastiveLearningRunner(cfg, output_dir=workspace / "port_run")
    return jr, tr


def _read(path: Path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _scores(cell: str):
    return [float(x) for x in cell.strip("[]").split(",")]


@pytest.mark.parametrize("table", ["csv", "parquet"])
def test_inference_matches_jax(runners, workspace, table):
    """One row a study; the top-k indices equal, their scores within
    relative 1e-4 or absolute 1e-5, every averaged metadata column equal
    cell for cell."""
    jr, tr = runners
    meta = workspace / "meta.csv"
    if table == "parquet":
        pytest.importorskip("pyarrow")
        meta = workspace / "meta.parquet"
        pd.read_csv(workspace / "meta.csv").to_parquet(meta)
    for r, name in ((jr, "jax"), (tr, "port")):
        r.config.metadata_path = str(meta)
        r.config.inference_results_path = str(workspace / f"{table}_{name}")
    jdf = jr.inference()
    rows = tr.inference()
    assert len(rows) == len(jdf) == 6
    got = _read(workspace / f"{table}_port" / "averaged_metadata.csv")
    want = _read(workspace / f"{table}_jax" / "averaged_metadata.csv")
    assert list(got[0]) == list(want[0]) == ["path", "topk_indices", "topk_scores",
                                             "stenosis_pct", "count", "finding", "severe",
                                             "empty"]
    for g, w in zip(got, want):
        assert g["path"] == w["path"] and g["topk_indices"] == w["topk_indices"]
        np.testing.assert_allclose(_scores(g["topk_scores"]), _scores(w["topk_scores"]),
                                   rtol=RTOL, atol=SCORE_ATOL)
        for col in ("stenosis_pct", "count", "finding", "severe", "empty"):
            assert g[col] == w[col], (col, g[col], w[col])
    assert all(g["empty"] == "" for g in got)


def test_average_metadata_follows_pandas():
    """Mean skips missing cells (NaN when none is left); the mode ignores
    them and takes the smallest of the tied values ("" when none is left)."""
    cases = [
        ([3.0, None, 4.0, 8.0], True),
        ([None, None], True),
        (["b", "a", "b", "a"], False),
        (["c", None, "a", "c", "a", "b"], False),
        (["z"], False),
        ([None, None], False),
        ([1.0, 0.0, 1.0], True),
    ]
    for values, numeric in cases:
        s = pd.Series(values, dtype="float64" if numeric else "object")
        want = float(s.mean()) if numeric else (s.mode().iloc[0] if len(s.mode()) else "")
        got = trun.average_metadata(values, numeric)
        if numeric and np.isnan(want):
            assert np.isnan(got)
        else:
            assert got == want, (values, got, want)


def test_read_metadata_types_columns_as_pandas(workspace, tmp_path):
    p = tmp_path / "m.csv"
    p.write_text("a,b,c,d,e\n1,x,True,,NA\n2.5,,False,,3\n,y,True,,4\n")
    cols, values, numeric = trun.read_metadata(p)
    df = pd.read_csv(p)
    assert cols == list(df.columns)
    assert numeric == {c: bool(pd.api.types.is_numeric_dtype(df[c])) for c in cols}
    assert values["a"] == [1.0, 2.5, None] and values["b"] == ["x", None, "y"]
    assert values["c"] == [1.0, 0.0, 1.0] and values["e"] == [None, 3.0, 4.0]


def test_generate_embeddings_matches_jax_encode_texts(runners, workspace):
    """The bank written from a port checkpoint of the JAX runner's weights:
    the unique reports in first-seen order, their embeddings within relative
    1e-4 of the JAX runner's ``_encode_texts``; ``serve --text_bank`` reads
    it. ``--videos``: one embedding a study."""
    jr, tr = runners
    tr.ckpt.save_latest(tr.state, {"epoch": 0})
    out = workspace / "bank_port.npz"
    path = workspace / "cfg.yaml"
    generate_embeddings.main(["--base_config", str(path), "--device", "cpu",
                              "--checkpoint", str(tr.ckpt.dir), "--texts_csv",
                              str(workspace / "data.csv"), "--text_column", "Report",
                              "--videos", "--out", str(out),
                              "--output_dir", str(workspace / "gen")])
    emb, texts = load_text_bank(out)
    assert texts.tolist() == [f"lad stenosis {i} percent" for i in range(4)]
    np.testing.assert_allclose(emb, jr._encode_texts(texts.tolist()), rtol=RTOL, atol=1e-6)
    bank = np.load(out)
    assert bank["video_embeddings"].shape == (6, 16) and len(bank["paths"]) == 6
    # the study embeddings are the runner's own
    want = np.concatenate([tr.video_embeddings(b) for b in tr.loaders["inference"]])
    np.testing.assert_array_equal(bank["video_embeddings"], want)


def test_generate_embeddings_refuses_a_checkpoint_that_does_not_fit(runners, workspace,
                                                                   tmp_path):
    _, tr = runners
    tr.ckpt.save_latest(tr.state, {"epoch": 0})
    with pytest.raises(ValueError, match="does not fit the config"):
        generate_embeddings.main([
            "--base_config", str(workspace / "cfg.yaml"), "--device", "cpu",
            "--checkpoint", str(tr.ckpt.dir / "checkpoint.pt"), "--texts_csv",
            str(workspace / "data.csv"), "--out", str(tmp_path / "b.npz"),
            "--text_dim", "64", "--output_dir", str(tmp_path / "o")])


def test_generate_embeddings_takes_a_config_object(runners, workspace, tmp_path):
    """``main(argv, config=...)``: no YAML reader needed."""
    _, tr = runners
    tr.ckpt.save_latest(tr.state, {"epoch": 0})
    cfg = tconfigs.ClipConfig.from_dict(_cfg(workspace, device="cpu",
                                             output_dir=str(tmp_path / "o")))
    out = generate_embeddings.main(["--checkpoint", str(tr.ckpt.dir), "--texts_csv",
                                    str(workspace / "data.csv"), "--out",
                                    str(tmp_path / "b.npz")], config=cfg)
    assert out["text_embeddings"].shape == (4, 16)


INFERENCE_YAMLS = [REPO / "config" / "inference" / f"{n}.yaml" for n in
                   ("clip_retrieval_inference", "embedding_extraction",
                    "study_retrieval_latency")]
TINY = ["--frames", "4", "--resize", "32", "--batch_size", "2", "--vit_dim", "32",
        "--vit_depth", "1", "--vit_heads", "1", "--embedding_dim", "16", "--num_heads", "2",
        "--aggregator_depth", "1", "--precision", "fp32", "--use_pallas_attention", "false",
        "--num_videos", "2", "--vit_pool_stages", "[]", "--text_dim", "32",
        "--text_depth", "1", "--text_heads", "2", "--text_vocab_size", "512",
        "--max_text_length", "16", "--num_workers", "1"]


@pytest.mark.parametrize("path", INFERENCE_YAMLS, ids=lambda p: p.stem)
def test_shipped_inference_yaml_runs_through_main(path, workspace):
    """Field for field as the JAX parser reads it; through the port's
    ``main`` at tiny width: the averaged metadata of the bank, or (no bank:
    ``embedding_extraction.yaml``) the study embeddings."""
    got = tconfigs.parse_config(["--base_config", str(path)])
    ref = jax_parse_config(["--base_config", str(path)]).to_dict()
    for key, val in got.to_dict().items():
        if key not in ("is_ref_device", "process_index", "process_count", "world_size",
                       *tconfigs.PORT_FIELDS):
            assert val == ref[key], key
    assert got.run_mode == "inference"
    out = workspace / "yaml" / path.stem
    argv = ["--base_config", str(path), *TINY, "--device", "cpu",
            "--data_filename", str(workspace / "data.csv"), "--output_dir", str(out),
            "--inference_results_path", str(out / "inference")]
    if got.text_embeddings_path:
        argv += ["--text_embeddings_path", str(workspace / "bank.npz"),
                 "--metadata_path", str(workspace / "meta.csv")]
    result = main(argv)
    assert result["inference_rows"] == 6
    if got.text_embeddings_path:
        rows = _read(out / "inference" / "averaged_metadata.csv")
        assert len(rows) == 6 and len(_scores(rows[0]["topk_scores"])) == got.topk
    else:
        emb = np.load(out / "inference" / "video_embeddings.npz")
        assert emb["video_embeddings"].shape == (6, 16) and len(emb["paths"]) == 6
        assert torch.isfinite(torch.from_numpy(emb["video_embeddings"])).all()


def test_chip_smoke_inference_config_is_the_shipped_yaml():
    """chip_smoke.py spells clip_retrieval_inference.yaml out as a dict (the
    card machine need not have PyYAML): it equals the YAML as the port's
    parser reads it."""
    import chip_smoke

    want = tconfigs.parse_config(["--base_config", str(INFERENCE_YAMLS[0])])
    assert chip_smoke.clip_inference_config().to_dict() == want.to_dict()
