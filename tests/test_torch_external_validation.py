"""The port's external-validation pipeline against the JAX package's script.

Every stage function of ``deepcoro_clip_tpu_torch/external_validation.py``
runs beside its counterpart in ``scripts/external_validation.py`` (loaded
with ``importlib``) on the same CSV, which pandas reads for the script and
``data/csv_utils`` for the port: the same columns in the same order and the
same cells (numbers equal, blanks and NaN alike). Covered: the input
template (byte for byte) and its round trip, stenosis cells, the column
preparation with and without target filling, procedure status, the
reference filter with its raise on an empty result, the DICOM farm with a
stand-in ``pydicom`` and without one.

Then the whole pipeline through both ``main``s on a tiny ``.npy`` manifest
(4 studies of 2 to 3 clips, 32 x 32, a probing head of 2 tasks, fp32 on the
CPU), from a JAX probing checkpoint and the port checkpoint converted from
its tree (``convert.load_probe_tree``): the port's ``predictions.csv`` equals
the port runner's inference with the restored state, and agrees with the
JAX pipeline's to a relative 1e-4. The VasoVision role through
``--filter_config`` / ``--filter_checkpoint``: a filter model's decisions
per row, and the same probing checkpoint as filter (no filter head: the
reference filter reads the CSV's own columns).
"""

import importlib.util
import math
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pandas as pd
import pytest
import torch
import yaml

from deepcoro_clip_tpu.configs.parser import parse_config as jax_parse_config
from deepcoro_clip_tpu.registry import register_all as jax_register_all
from deepcoro_clip_tpu.runners.linear_probing import LinearProbingRunner as JaxRunner
from deepcoro_clip_tpu.train.checkpoint import CheckpointManager as JaxCheckpoints

from deepcoro_clip_tpu_torch import convert
from deepcoro_clip_tpu_torch import external_validation as ev
from deepcoro_clip_tpu_torch.configs import parse_config
from deepcoro_clip_tpu_torch.data.csv_utils import read_csv_with_fallback, write_csv
from deepcoro_clip_tpu_torch.runners.linear_probing import LinearProbingRunner
from deepcoro_clip_tpu_torch.train.checkpoint import CheckpointManager

jax_register_all()

REPO = Path(__file__).resolve().parents[1]
RTOL = 1e-4
STATS = ["--dataset_mean", "[127,127,127]", "--dataset_std", "[50,50,50]"]


@pytest.fixture(scope="module")
def jev():
    spec = importlib.util.spec_from_file_location(
        "jax_external_validation", REPO / "scripts" / "external_validation.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _same(table, df: pd.DataFrame) -> None:
    """A port table and a pandas frame: columns in order, cells equal."""
    assert table.columns == list(df.columns)
    assert len(table.rows) == len(df)
    for i, row in enumerate(table.rows):
        for c in table.columns:
            got, want = row.get(c), df.iloc[i][c]
            if pd.isna(want):
                assert got is None or (isinstance(got, float) and math.isnan(got)), (i, c, got)
            elif isinstance(want, (str,)):
                assert got == want, (i, c, got, want)
            else:
                assert got is not None and float(got) == float(want), (i, c, got, want)


def _both(tmp_path, rows, columns=None):
    """``rows`` written once, read by pandas and by the port."""
    path = tmp_path / "in.csv"
    write_csv(path, columns or list(rows[0]), rows, sep=",")
    return read_csv_with_fallback(path), pd.read_csv(path)


def test_template_round_trip(jev, tmp_path):
    ev.write_input_template(tmp_path / "port.csv")
    jev.write_input_template(tmp_path / "jax.csv")
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()
    table = read_csv_with_fallback(tmp_path / "port.csv")
    assert len(table.columns) == 4 * len(ev.SEGMENTS) + 3
    got = ev.prepare_input_columns(table)
    _same(got, jev.prepare_input_columns(pd.read_csv(tmp_path / "jax.csv")))
    assert {"Patient_ID", "StudyInstanceUID", "DICOMPath"} <= set(got.columns)
    assert all(r["prox_rca_stenosis_binary"] == 0 and r["lvp_cto"] == 0 for r in got.rows)


@pytest.mark.parametrize("cell", [50, 50.5, "50-70%", "occluded 100", "12.5 %", "none", "",
                                  None, float("nan"), True, "70", "<30"])
def test_stenosis_cell(jev, cell):
    got, want = ev.parse_stenosis_cell(cell), jev.parse_stenosis_cell(cell)
    assert (math.isnan(got) and math.isnan(want)) or got == want


@pytest.mark.parametrize("fill", [False, True])
def test_prepare_input_columns(jev, tmp_path, fill):
    rows = [
        {"ss_patient_id": "P1", "ss_event_cath_id": "E1", "prox_rca_stenosis": "50-70%",
         "mid_lad_stenosis": 90, "lm_calcif_binary": "mild", "rca_calcif_binary": 1,
         "pda_cto": True, "om1_thrombus": "", "empty_col": "", "stenosis_binary": 1,
         "DICOMPath": "/x/a.dcm"},
        {"ss_patient_id": "P1", "ss_event_cath_id": "E1", "prox_rca_stenosis": "",
         "mid_lad_stenosis": 20, "lm_calcif_binary": "none", "rca_calcif_binary": 0,
         "pda_cto": False, "om1_thrombus": True, "empty_col": "", "stenosis_binary": "",
         "DICOMPath": "/x/b.avi"},
        {"ss_patient_id": "P2", "ss_event_cath_id": "E2", "prox_rca_stenosis": "occluded 100",
         "mid_lad_stenosis": "", "lm_calcif_binary": "unknown", "rca_calcif_binary": "",
         "pda_cto": "", "om1_thrombus": False, "empty_col": "", "stenosis_binary": 0,
         "DICOMPath": "/x/c.npy"},
    ]
    table, df = _both(tmp_path, rows)
    targets = ("stenosis_binary", "CTO") if fill else ()
    got = ev.prepare_input_columns(table, target_labels=targets, fill_missing_targets=fill)
    want = jev.prepare_input_columns(df, target_labels=targets, fill_missing_targets=fill)
    _same(got, want)
    assert "empty_col" not in got.columns and ("CTO" in got.columns) == fill
    # the CSV with StudyInstanceUID already there keeps it and the event id
    table2, df2 = _both(tmp_path, [dict(r, StudyInstanceUID=f"S{i}") for i, r in
                                   enumerate(rows)])
    _same(ev.prepare_input_columns(table2), jev.prepare_input_columns(df2))


STATUS_ROWS = [
    {"StudyInstanceUID": "S1", "stent_presence": 0, "contrast_agent": 1, "main_structure": 0},
    {"StudyInstanceUID": "S1", "stent_presence": 1, "contrast_agent": 1, "main_structure": 1},
    {"StudyInstanceUID": "S1", "stent_presence": 0, "contrast_agent": 1, "main_structure": 0},
    {"StudyInstanceUID": "S1", "stent_presence": 0, "contrast_agent": 0, "main_structure": 0},
    {"StudyInstanceUID": "S2", "stent_presence": "", "contrast_agent": 1, "main_structure": 2},
    {"StudyInstanceUID": "S2", "stent_presence": 0, "contrast_agent": "", "main_structure": 1},
    {"StudyInstanceUID": "", "stent_presence": 0, "contrast_agent": 1, "main_structure": 0},
    {"StudyInstanceUID": "S3", "stent_presence": 0, "contrast_agent": 1, "main_structure": ""},
]


@pytest.mark.parametrize("drop", [None, "contrast_agent", "stent_presence", "main_structure"])
def test_procedure_status_and_reference_filter(jev, tmp_path, drop):
    rows = [{k: v for k, v in r.items() if k != drop} for r in STATUS_ROWS]
    table, df = _both(tmp_path, rows)
    status = ev.assign_procedure_status(table)
    _same(status, jev.assign_procedure_status(df))
    if drop is None:
        assert [r["status"] for r in status.rows] == [
            "diagnostic", "PCI", "POST_PCI", "unknown", "diagnostic", "diagnostic",
            "POST_PCI", "diagnostic"]
    _same(ev.apply_reference_filter(table), jev.apply_reference_filter(df))


def test_reference_filter_raises_when_empty(jev, tmp_path):
    table, df = _both(tmp_path, [{"StudyInstanceUID": "S", "main_structure": 5,
                                  "contrast_agent": 0, "stent_presence": 1}])
    with pytest.raises(RuntimeError, match="No rows remain"):
        ev.apply_reference_filter(table)
    with pytest.raises(RuntimeError, match="No rows remain"):
        jev.apply_reference_filter(df)


@pytest.mark.parametrize("pydicom,workers", [("stand-in", 1), ("absent", 1), ("absent", 2)])
def test_convert_dicoms(jev, tmp_path, monkeypatch, pydicom, workers):
    """``.npy`` rows pass through; a DICOM becomes a ``.npy`` clip with the
    stand-in reader and is dropped without one (also through the pool of
    spawned workers, where a DICOM that cannot be read converts to
    nothing)."""
    if pydicom == "stand-in":
        class _DS:
            pixel_array = np.arange(3 * 8 * 8, dtype=np.uint16).reshape(3, 8, 8)

        fake = types.ModuleType("pydicom")
        fake.dcmread = lambda p: _DS()
        monkeypatch.setitem(sys.modules, "pydicom", fake)
    else:
        monkeypatch.setitem(sys.modules, "pydicom", None)  # the import raises
    clip = tmp_path / "already.npy"
    np.save(clip, np.zeros((2, 4, 4, 3), np.uint8))
    rows = [{"DICOMPath": str(clip), "StudyInstanceUID": "A"},
            {"DICOMPath": str(tmp_path / "scan1.dcm"), "StudyInstanceUID": "B"},
            {"DICOMPath": "", "StudyInstanceUID": "C"}]
    table, df = _both(tmp_path, rows)
    got = ev.convert_dicoms(table, tmp_path / "port", workers=workers)
    want = jev.convert_dicoms(df, tmp_path / "jax", workers=1)
    assert got.columns == list(want.columns)
    rel = [Path(r["FileName"]).name for r in got.rows]
    assert rel == [Path(p).name for p in want["FileName"]]
    assert [r["StudyInstanceUID"] for r in got.rows] == list(want["StudyInstanceUID"])
    if pydicom == "stand-in":
        # (the stand-in reads any path, the blank one's "nan" too)
        assert rel == ["already.npy", "scan1.npy", "nan.npy"]
        a = np.load(got.rows[1]["FileName"])
        assert a.shape == (3, 8, 8, 3) and a.dtype == np.uint8
        np.testing.assert_array_equal(a, np.load(want["FileName"].iloc[1]))
        assert ev.dicom_to_npy((str(tmp_path / "scan2.dcm"), str(tmp_path))) == \
            str(tmp_path / "scan2.npy")
    else:
        assert rel == ["already.npy"]
        assert ev.dicom_to_npy((str(tmp_path / "x.dcm"), str(tmp_path))) is None
        assert jev.dicom_to_npy((str(tmp_path / "x.dcm"), str(tmp_path))) is None


# --------------------------------------------------------------------------- #
# the pipeline


def _probe_yaml(path: Path, **over) -> Path:
    cfg = dict(
        pipeline_project="DeepCORO_video_linear_probing", run_mode="train",
        data_filename="unused.csv", output_dir="unused", epochs=1, batch_size=2,
        frames=4, resize=32, num_workers=0, multi_video=True, num_videos=3,
        head_structure={"stenosis": 1, "cto": 1},
        loss_structure={"stenosis": "huber", "cto": "bce_logit"},
        head_task={"stenosis": "regression", "cto": "binary"},
        pooling_mode="attention+cls_token", vit_dim=32, vit_depth=1, vit_heads=1,
        vit_patch=[2, 16, 16], embedding_dim=16, num_heads=2, attention_hidden=8,
        dropout=0.0, precision="fp32", use_pallas_attention=False, use_wandb=False, seed=0)
    cfg.update(over)
    path.write_text(yaml.safe_dump(cfg))
    return path


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """4 studies of 2 to 3 ``.npy`` clips in the documented input columns;
    the view/contrast/status columns drop a non-coronary clip, a clip
    without contrast and a PCI clip (and the clip after it, POST_PCI). A
    JAX probing checkpoint of the JAX runner's state moved off its seeded
    values, and a port probing checkpoint of the same tree."""
    import flax.linen as fnn

    root = tmp_path_factory.mktemp("ev")
    r = np.random.default_rng(0)
    rows = []
    for s, n in enumerate((3, 2, 3, 2)):
        for j in range(n):
            p = root / f"s{s}_c{j}.npy"
            np.save(p, r.integers(0, 255, size=(6, 32, 32, 3)).astype(np.uint8))
            rows.append({"ss_patient_id": f"P{s}", "ss_event_cath_id": f"STUDY{s}",
                         "prox_rca_stenosis": f"{10 * s}-{10 * s + 5}%",
                         "prox_rca_calcif_binary": "mild" if j else "none",
                         "prox_rca_cto": bool(s % 2), "DICOMPath": str(p),
                         "main_structure": 2 if (s, j) == (0, 2) else j % 2,
                         "contrast_agent": 0 if (s, j) == (1, 1) else 1,
                         "stent_presence": 1 if (s, j) == (2, 1) else 0})
    write_csv(root / "input.csv", list(rows[0]), rows, sep=",")
    # the manifest the runners that write the checkpoints are built on
    write_csv(root / "clips.csv", ["FileName", "StudyInstanceUID", "Split"],
              [{"FileName": r["DICOMPath"], "StudyInstanceUID": r["ss_event_cath_id"],
                "Split": "train"} for r in rows])
    probe = _probe_yaml(root / "probe.yaml")
    jr = JaxRunner(jax_parse_config(["--base_config", str(probe), "--data_filename",
                                     str(root / "clips.csv")] + STATS),
                   output_dir=root / "jax_init")
    jr.state = jr.state.replace(params=jax.tree_util.tree_map(lambda a: a * 1.25,
                                                              jr.state.params))
    JaxCheckpoints(root / "jax_ckpt").save_latest(jr.state, {"epoch": 0})
    tree = jax.tree_util.tree_map(np.asarray, fnn.unbox(jr.state.params))
    cfg = parse_config(["--base_config", str(probe), "--run_mode", "inference",
                        "--data_filename", str(root / "clips.csv"), "--device", "cpu",
                        "--split_filter", "all"] + STATS)
    runner = LinearProbingRunner(cfg, output_dir=root / "port_init")
    convert.load_probe_tree(tree, runner.bundle.video_model, runner.bundle.mil_model)
    CheckpointManager(root / "port_ckpt").save_latest(runner.state, {"epoch": 0})
    return root


def _read(path):
    return read_csv_with_fallback(path)


def _restored_inference(cfg, ckpt, out):
    runner = LinearProbingRunner(cfg, output_dir=out)
    runner.state = CheckpointManager(ckpt).restore(runner.state)
    return runner.inference(split="inference")


@pytest.fixture(scope="module")
def pipelines(workspace, jev):
    root = workspace
    port_out, jax_out = root / "port_out", root / "jax_out"
    common = ["--input_csv", str(root / "input.csv"), "--base_config", str(root / "probe.yaml"),
              "--workers", "1"]
    preds = ev.main(common + ["--checkpoint", str(root / "port_ckpt"), "--output_dir",
                              str(port_out), "--device", "cpu"] + STATS)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", ["external_validation.py"] + common
                   + ["--checkpoint", str(root / "jax_ckpt"), "--output_dir", str(jax_out)]
                   + STATS)
        jev.main()
    return preds, port_out, jax_out


def test_pipeline_matches_the_runner_and_jax(pipelines, workspace):
    preds, port_out, jax_out = pipelines
    got = _read(port_out / "predictions.csv")
    want = pd.read_csv(jax_out / "predictions.csv")
    # studies 0 (a non-coronary clip dropped), 1 (a clip without contrast
    # dropped), 2 (PCI at clip 1: clips 1 and 2 dropped), 3 whole
    assert got.columns == list(want.columns) == ["study_id", "cto", "stenosis"]  # YAML order
    assert [r["study_id"] for r in got.rows] == list(want["study_id"]) == [
        "STUDY0", "STUDY1", "STUDY2", "STUDY3"]
    for h in ("stenosis", "cto"):
        np.testing.assert_allclose([r[h] for r in got.rows], want[h].to_numpy(), rtol=RTOL,
                                   atol=1e-6, err_msg=h)
    manifest = _read(port_out / "runtime_manifest.csv")
    jmanifest = pd.read_csv(jax_out / "runtime_manifest.csv", sep="α", engine="python")
    assert manifest.columns == list(jmanifest.columns)
    assert [r["FileName"] for r in manifest.rows] == list(jmanifest["FileName"])
    assert len(manifest.rows) == 6
    # the port runner on the filtered manifest, its state restored by hand
    cfg = parse_config(["--base_config", str(workspace / "probe.yaml"),
                        "--data_filename", str(port_out / "runtime_manifest.csv"),
                        "--run_mode", "inference", "--device", "cpu"] + STATS)
    runner = LinearProbingRunner(cfg, output_dir=workspace / "by_hand")
    runner.state = CheckpointManager(workspace / "port_ckpt").restore(runner.state)
    rows = runner.inference(split="inference")
    assert rows == preds
    assert [[str(r["study_id"]), repr(r["stenosis"]), repr(r["cto"])] for r in rows] == \
        [[str(r["study_id"]), repr(r["stenosis"]), repr(r["cto"])] for r in got.rows]
    # the head was restored: the seeded head gives other outputs
    fresh = LinearProbingRunner(cfg, output_dir=workspace / "fresh").inference("inference")
    assert fresh[0]["cto"] != rows[0]["cto"]


def test_filter_model_roles(workspace, tmp_path):
    """``--filter_config``/``--filter_checkpoint``: (a) the probing
    checkpoint itself as filter (no filter head: the CSV's own columns
    decide, the same rows as without it); (b) a per-clip filter model with
    the three filter heads: each row takes its clip's decisions, which
    replace the CSV's columns."""
    root = workspace
    common = ["--input_csv", str(root / "input.csv"), "--base_config", str(root / "probe.yaml"),
              "--checkpoint", str(root / "port_ckpt"), "--workers", "1", "--device", "cpu"]
    plain = ev.main(common + ["--output_dir", str(tmp_path / "plain")] + STATS)
    same = ev.main(common + ["--output_dir", str(tmp_path / "same"), "--filter_config",
                             str(root / "probe.yaml"), "--filter_checkpoint",
                             str(root / "port_ckpt")] + STATS)
    assert same == plain

    heads = ("main_structure", "contrast_agent", "stent_presence")
    filt = _probe_yaml(tmp_path / "filter.yaml", multi_video=False, num_videos=1,
                       head_structure={h: 1 for h in heads},
                       loss_structure={h: "bce_logit" for h in heads},
                       head_task={h: "binary" for h in heads})
    cfg = parse_config(["--base_config", str(filt), "--data_filename",
                        str(root / "clips.csv"), "--run_mode", "inference",
                        "--split_filter", "all", "--device", "cpu"] + STATS)
    runner = LinearProbingRunner(cfg, output_dir=tmp_path / "filter_init")
    with torch.no_grad():  # decisions that keep some clips and drop others
        runner.bundle.mil_model.head_main_structure.bias.fill_(0.6)
        runner.bundle.mil_model.head_contrast_agent.bias.fill_(2.0)
        runner.bundle.mil_model.head_stent_presence.bias.fill_(-2.0)
    CheckpointManager(tmp_path / "filter_ckpt").save_latest(runner.state, {})
    manifest = tmp_path / "manifest.csv"
    table = ev.prepare_input_columns(_read(root / "input.csv"))
    table = ev.convert_dicoms(table, tmp_path, workers=1)
    write_csv(manifest, table.columns + ["Split"],
              [dict(r, Split="inference") for r in table.rows])
    out = ev.run_filter_model(table, manifest, str(filt), str(tmp_path / "filter_ckpt"),
                              tmp_path, list(STATS) + ["--device", "cpu"])
    assert out.columns[-3:] == list(heads)
    cfg = parse_config(["--base_config", str(filt), "--data_filename", str(manifest),
                        "--run_mode", "inference", "--device", "cpu"] + STATS)
    ref = _restored_inference(cfg, tmp_path / "filter_ckpt", tmp_path / "ref")
    by_path = {r["study_id"]: r for r in ref}
    for r in out.rows:
        p = by_path[r["FileName"]]
        assert r["main_structure"] == round(p["main_structure"])
        assert r["contrast_agent"] == int(p["contrast_agent"] > 0.5)
        assert r["stent_presence"] == int(p["stent_presence"] > 0.5)


def test_write_template_and_the_cuda_default(tmp_path, monkeypatch, workspace):
    assert ev.main(["--write_template", str(tmp_path / "t.csv")]) == []
    assert (tmp_path / "t.csv").exists()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ev.main(["--input_csv", str(workspace / "input.csv"), "--base_config",
                 str(workspace / "probe.yaml"), "--workers", "1", "--output_dir",
                 str(tmp_path / "out")] + STATS)
