"""External-validation pipeline: a DICOM/AVI study CSV -> multiprocess
conversion -> view/contrast/diagnostic filtering -> linear-probing inference
in process -> ``predictions.csv``.

The port's counterpart of the JAX package's ``scripts/external_validation.py``
(the deployment entry its ``deploy/entrypoint.sh`` runs), on the standard
library's ``csv`` and numpy instead of pandas: a CSV travels as a
``data/csv_utils.Table`` (column names and one dict a row, an empty cell
``None``, pandas' NaN). The stages:

- 0, the documented input spec -> framework columns (``prepare_input_columns``);
- 1, DICOM -> ``.npy`` clips on a ``ProcessPoolExecutor`` over ``pydicom``
  (gated: without it a DICOM converts to nothing; ``.avi``/``.mp4``/``.npy``
  rows pass straight through to the framework's own decoder);
- 2, the VasoVision role, served by any linear-probing run of the port
  whose model predicts ``main_structure`` / ``contrast_agent`` /
  ``stent_presence`` (``--filter_config`` + ``--filter_checkpoint``), by a
  plug-in module (``--filter_module``) or by columns already in the CSV;
  then the reference keep rule (coronary structure, contrast, diagnostic
  status);
- 3, the port's ``LinearProbingRunner`` in ``run_mode: inference`` with the
  whole probing state (encoder and head) restored from ``--checkpoint``
  (``CheckpointManager.restore``, as the JAX script restores its runner's
  state), its predictions written to ``<output_dir>/predictions.csv``.

The filter model's predictions come back keyed by the runner's
``study_id``: the clip's path (resolved against the config's ``root``) in a
per-clip run, the ``groupby_column`` value in a multi-video one; each CSV
row takes the prediction of its key. (The JAX script merges them on a
``FileName`` column its runner's predictions do not carry.)

Usage:
    python -m deepcoro_clip_tpu_torch.external_validation --input_csv studies.csv \\
        --base_config config/linear_probing/stenosis_config.yaml \\
        --checkpoint <probing run>/checkpoints --output_dir results/ \\
        [--filter_config cfg.yaml --filter_checkpoint <ckpt dir>] \\
        [--filter_module my_filter] [--workers 8] [--device cpu] [--any_config_field value]
    python -m deepcoro_clip_tpu_torch.external_validation --write_template template.csv

Arguments the parser does not know override fields of both configs
(``--dataset_mean``/``--dataset_std`` are needed outside training;
``--device cpu`` runs on the CPU, the card otherwise).
"""

from __future__ import annotations

import argparse
import math
import multiprocessing
import os
import re
import sys
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path
from typing import Any, List, Optional, Sequence

import numpy as np

from deepcoro_clip_tpu_torch.data.csv_utils import Table, read_csv_with_fallback, write_csv

# main_structure class ids (the VasoVision config's labels_map values)
RIGHT_CORONARY = 0
LEFT_CORONARY = 1
CONTRAST_YES = 1

# severity words accepted in `<segment>_calcif_binary` columns ("none" is
# negative, any named severity is positive)
_CALCIF_WORD = {"none": 0, "mild": 1, "moderate": 1, "severe": 1}
# the cells pandas' CSV reader turns into booleans
_BOOL_WORD = {"True": True, "TRUE": True, "true": True,
              "False": False, "FALSE": False, "false": False}

# the 18 coronary segments of the documented input template
SEGMENTS = (
    "prox_rca", "mid_rca", "dist_rca", "pda", "posterolateral",
    "left_main", "prox_lad", "mid_lad", "dist_lad", "D1", "D2",
    "prox_lcx", "mid_lcx", "dist_lcx", "om1", "om2", "bx", "lvp",
)
FILTER_HEADS = ("main_structure", "contrast_agent", "stent_presence")


def _log(msg: str) -> None:
    print(f"[external_validation] {msg}", flush=True)


def _missing(v) -> bool:
    return v is None or (isinstance(v, float) and math.isnan(v))


def _numeric(v):
    """A cell as pandas' ``to_numeric(errors="coerce")`` reads it."""
    if _missing(v):
        return None
    if isinstance(v, (bool, np.bool_)):
        return int(v)
    if isinstance(v, (int, float, np.integer, np.floating)):
        return v
    for kind in (int, float):
        try:
            return kind(str(v))
        except ValueError:
            pass
    return None


def _copy(table: Table) -> Table:
    return Table(list(table.columns), [dict(r) for r in table.rows])


def _set_column(table: Table, name: str, values: Sequence[Any]) -> None:
    if name not in table.columns:
        table.columns.append(name)
    for r, v in zip(table.rows, values):
        r[name] = v


def write_input_template(path) -> None:
    """Emit the documented input CSV template: per-segment stenosis percent,
    calcification severity word, CTO/thrombus booleans, study-level ids, one
    row per DICOM."""
    cols = {"ss_patient_id": ["P001", "P001"], "ss_event_cath_id": ["STUDY001", "STUDY001"]}
    for seg in SEGMENTS:
        cols[f"{seg}_stenosis"] = [0, 0]
    for seg in SEGMENTS:
        cols[f"{seg}_calcif_binary"] = ["none", "none"]
    for seg in SEGMENTS:
        cols[f"{seg}_cto"] = [False, False]
    for seg in SEGMENTS:
        cols[f"{seg}_thrombus"] = [False, False]
    cols["DICOMPath"] = ["/path/to/STUDY001_SERIES001.dcm",
                         "/path/to/STUDY001_SERIES002.dcm"]
    rows = [{c: v[i] for c, v in cols.items()} for i in range(2)]
    write_csv(path, list(cols), rows, sep=",")


def parse_stenosis_cell(value):
    """One stenosis cell -> float percent or NaN: numbers pass through;
    strings yield the LARGEST number they contain ("50-70%" -> 70.0,
    "occluded 100" -> 100.0); blank or number-free text is NaN."""
    if _missing(value):
        return math.nan
    if isinstance(value, (int, float, np.integer, np.floating)):
        return float(value)
    found = re.findall(r"\d+(?:\.\d+)?", str(value))
    return max(float(x) for x in found) if found else math.nan


def _bool01(v):
    """``{False: 0, True: 1}`` as pandas' ``map`` applies it to a cell the
    CSV reader gave (a bool, a number, or text it left alone)."""
    if isinstance(v, str):
        v = _BOOL_WORD.get(v)
    return None if _missing(v) else {0: 0, 1: 1}.get(v)  # True == 1, as a dict key too


def prepare_input_columns(table: Table, target_labels=(),
                          fill_missing_targets: bool = False) -> Table:
    """Normalize a CSV written to the documented input spec:

    - ``<seg>_calcif_binary``: none/mild/moderate/severe -> 0/1 (columns
      that are already numeric pass through as numbers);
    - ``<seg>_cto`` / ``<seg>_thrombus``: True/False -> 1/0;
    - every ``*_stenosis`` column is parsed to float percent and gains a
      derived ``*_stenosis_binary`` (1 where value > 70);
    - ``ss_patient_id`` -> ``Patient_ID``; ``ss_event_cath_id`` ->
      ``StudyInstanceUID`` (only when the latter is absent);
    - validation-capable runs (``fill_missing_targets``): requested target
      columns are created / blank-filled with 0.0 (blank means
      negative/normal);
    - all-empty columns are dropped, except protected targets.
    """
    t = _copy(table)
    for col in list(t.columns):
        cells = t.column(col)
        if col.endswith("_calcif_binary"):
            if any(isinstance(v, str) for v in cells if not _missing(v)):
                new = [_CALCIF_WORD.get(v) if isinstance(v, str) else None for v in cells]
            else:
                new = [_numeric(v) for v in cells]
            _set_column(t, col, new)
        elif col.endswith("_cto") or col.endswith("_thrombus"):
            _set_column(t, col, [_bool01(v) for v in cells])

    for col in [c for c in t.columns if c.endswith("_stenosis")]:
        vals = [parse_stenosis_cell(v) for v in t.column(col)]
        _set_column(t, col, vals)
        _set_column(t, f"{col}_binary", [int(v > 70) for v in vals])

    renames = {}
    if "ss_patient_id" in t.columns:
        renames["ss_patient_id"] = "Patient_ID"
    if "ss_event_cath_id" in t.columns and "StudyInstanceUID" not in t.columns:
        renames["ss_event_cath_id"] = "StudyInstanceUID"
    if renames:
        t.columns = [renames.get(c, c) for c in t.columns]
        t.rows = [{renames.get(k, k): v for k, v in r.items()} for r in t.rows]

    protected = set()
    if fill_missing_targets and target_labels:
        protected = set(target_labels)
        for label in target_labels:
            if label not in t.columns:
                _set_column(t, label, [0.0] * len(t.rows))
            else:
                _set_column(t, label, [0.0 if _missing(v) else v for v in t.column(label)])

    empty = [c for c in t.columns
             if c not in protected and all(_missing(v) for v in t.column(c))]
    if empty:
        _log(f"dropping {len(empty)} empty columns: {empty}")
        t.columns = [c for c in t.columns if c not in empty]
        for r in t.rows:
            for c in empty:
                r.pop(c, None)
    return t


def dicom_to_npy(args) -> Optional[str]:
    """Convert one DICOM to a ``.npy`` clip; module-level so that it pickles
    into pool workers. Without ``pydicom``, or on a file it cannot read,
    None."""
    dicom_path, out_dir = args
    try:
        import pydicom  # optional dependency
    except ImportError:
        return None
    try:
        ds = pydicom.dcmread(dicom_path)
        arr = ds.pixel_array  # [F, H, W] or [F, H, W, C]
        if arr.ndim == 2:
            arr = arr[None]
        if arr.ndim == 3:
            arr = arr[..., None].repeat(3, axis=-1)
        arr = np.clip(arr, 0, 255).astype(np.uint8)
        out = Path(out_dir) / (Path(dicom_path).stem + ".npy")
        np.save(out, arr)
        return str(out)
    except Exception as e:  # noqa: BLE001 - per-file fault tolerance
        _log(f"failed to convert {dicom_path}: {e}")
        return None


def convert_dicoms(table: Table, out_dir: Path, workers: Optional[int] = None) -> Table:
    """The multiprocess DICOM -> ``.npy`` farm into ``out_dir/clips``;
    ``FileName`` names each row's clip. Non-DICOM rows (``.avi``, ``.mp4``,
    ``.npy``, ``.npz``) pass through untouched; rows without a clip are
    dropped."""
    clips_dir = Path(out_dir) / "clips"
    clips_dir.mkdir(parents=True, exist_ok=True)
    t = _copy(table)
    paths = ["nan" if _missing(p) else str(p) for p in t.column("DICOMPath")]
    through = [p.lower().endswith((".avi", ".mp4", ".npy", ".npz")) for p in paths]
    tasks = [(p, str(clips_dir)) for p, ok in zip(paths, through) if not ok]
    workers = workers or min(8, os.cpu_count() or 1)
    results: List[Optional[str]] = []
    if tasks:
        if workers > 1:  # spawned: the caller's process may hold threads (torch)
            with ProcessPoolExecutor(max_workers=workers,
                                     mp_context=multiprocessing.get_context("spawn")) as pool:
                results = list(pool.map(dicom_to_npy, tasks))
        else:
            results = [dicom_to_npy(task) for task in tasks]
    it = iter(results)
    _set_column(t, "FileName", [p if ok else (next(it) or "") for p, ok in zip(paths, through)])
    kept = Table(t.columns, [r for r in t.rows if r["FileName"] != ""])
    _log(f"{len(kept.rows)}/{len(t.rows)} rows have clips")
    return kept


def _eq(v, x) -> bool:
    return not _missing(v) and v == x


def assign_procedure_status(table: Table) -> Table:
    """PCI / POST_PCI / diagnostic status per row: PCI = stent placed this
    acquisition; POST_PCI = a later acquisition (with contrast) of a study
    that already had a PCI; diagnostic = no PCI seen yet in the study (rows
    in CSV order)."""
    t = _copy(table)
    if "StudyInstanceUID" not in t.columns:
        raise KeyError("StudyInstanceUID")
    has_stent = "stent_presence" in t.columns
    has_contrast = "contrast_agent" in t.columns
    seen: dict = {}
    status = []
    for r in t.rows:
        is_pci = has_stent and _eq(r.get("stent_presence"), 1)
        study = r.get("StudyInstanceUID")
        # a row without a study id has no group: pandas' transform gives it
        # NaN, which reads True
        before = True if _missing(study) else seen.get(study, False)
        if not _missing(study):
            seen[study] = before or is_pci
        contrast = _eq(r.get("contrast_agent"), CONTRAST_YES) if has_contrast else True
        if is_pci:
            status.append("PCI")
        elif before and contrast:
            status.append("POST_PCI")
        elif not before:
            status.append("diagnostic")
        else:
            status.append("unknown")
    _set_column(t, "status", status)
    return t


def apply_reference_filter(table: Table) -> Table:
    """The reference keep rule: coronary main_structure, contrast agent
    detected, diagnostic procedure status; raises when no row remains."""
    t = assign_procedure_status(table)
    keep = []
    for r in t.rows:
        ok = r["status"] == "diagnostic"
        if "main_structure" in t.columns:
            ok &= _numeric(r.get("main_structure")) in (RIGHT_CORONARY, LEFT_CORONARY)
        if "contrast_agent" in t.columns:
            ok &= _eq(_numeric(r.get("contrast_agent")), CONTRAST_YES)
        keep.append(ok)
    out = Table(t.columns, [r for r, k in zip(t.rows, keep) if k])
    if not out.rows:
        raise RuntimeError("No rows remain after view/contrast/diagnostic filtering")
    return out


def _runtime_config(base, manifest: Path, extra: Sequence[str]):
    """The probing config of ``base`` (a YAML path, or a config object for
    callers without a YAML reader) with the runtime manifest, in
    ``run_mode: inference``."""
    from deepcoro_clip_tpu_torch.registry import register_all

    register_all()
    if isinstance(base, (str, Path)):
        from deepcoro_clip_tpu_torch.configs import parse_config

        return parse_config(["--base_config", str(base), "--data_filename", str(manifest),
                             "--run_mode", "inference", *extra])
    if extra:
        raise ValueError(f"config fields as arguments need a YAML config: {list(extra)}")
    cfg = type(base).from_dict({**base.to_dict(), "data_filename": str(manifest),
                                "run_mode": "inference"})
    cfg.set_device_info_in_place()
    return cfg


def _restored_runner(cfg, checkpoint: Optional[str], out_dir: Path):
    """A probing runner on ``cfg`` whose whole state (encoder and head) is
    restored from ``checkpoint``'s ``checkpoint``."""
    from deepcoro_clip_tpu_torch.runners.linear_probing import LinearProbingRunner
    from deepcoro_clip_tpu_torch.train.checkpoint import CheckpointManager

    runner = LinearProbingRunner(cfg, output_dir=out_dir)
    if checkpoint:
        runner.ckpt = CheckpointManager(checkpoint)
        runner.state = runner.ckpt.restore(runner.state, "checkpoint")
    return runner


def _study_key(cfg, row) -> Any:
    """The ``study_id`` a probing run gives the study of a CSV row."""
    if cfg.multi_video:
        return row.get(cfg.groupby_column)
    p = str(row.get(cfg.datapoint_loc_label))
    return p if Path(p).is_absolute() else str(Path(cfg.root) / p)


def run_filter_model(table: Table, manifest: Path, filter_config, filter_checkpoint,
                     out_dir: Path, extra: Sequence[str]) -> Table:
    """Serve the VasoVision role with a linear-probing model of the port:
    inference over the manifest, its ``main_structure`` (rounded) /
    ``contrast_agent`` / ``stent_presence`` (> 0.5) outputs as columns,
    replacing the CSV's own."""
    cfg = _runtime_config(filter_config, manifest, extra)
    runner = _restored_runner(cfg, filter_checkpoint, Path(out_dir) / "filter_model")
    preds = runner.inference(split="inference")
    heads = list(cfg.head_structure)
    decided = {}
    for head in FILTER_HEADS:
        col = next((c for c in heads if c.startswith(head)), None)
        if col is None:
            continue
        vals = np.asarray([p[col] for p in preds], float)
        decided[head] = (vals.round().astype(int) if head == "main_structure"
                         else (vals > 0.5).astype(int)).tolist()
    by_key = {p["study_id"]: i for i, p in enumerate(preds)}
    t = _copy(table)
    t.columns = [c for c in t.columns if c not in decided]
    for r in t.rows:
        i = by_key.get(_study_key(cfg, r))
        for head, vals in decided.items():
            r[head] = None if i is None else vals[i]
    t.columns += list(decided)
    return t


def _target_labels(base) -> tuple:
    if isinstance(base, (str, Path)):
        import yaml

        with open(base) as f:
            return tuple(yaml.safe_load(f).get("target_label", []) or ())
    return tuple(base.to_dict().get("target_label") or ())


def main(argv: Optional[Sequence[str]] = None, config=None, filter_config=None) -> list:
    """The pipeline; returns the prediction rows. ``config`` /
    ``filter_config``: config objects in place of ``--base_config`` /
    ``--filter_config`` (then no config field may come as an argument)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--write_template" in argv:
        tp = argparse.ArgumentParser()
        tp.add_argument("--write_template",
                        help="emit the documented input CSV template and exit")
        path = tp.parse_known_args(argv)[0].write_template
        write_input_template(path)
        _log(f"wrote input template to {path}")
        return []
    ap = argparse.ArgumentParser(prog="python -m deepcoro_clip_tpu_torch.external_validation")
    ap.add_argument("--input_csv", required=True, help="CSV with DICOMPath or FileName column")
    ap.add_argument("--base_config", required=config is None)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--output_dir", default="results")
    ap.add_argument("--workers", type=int, default=None)
    ap.add_argument("--filter_module", default=None,
                    help="python module exposing filter_studies(table) -> table")
    ap.add_argument("--filter_config", default=None,
                    help="probing config whose model predicts main_structure/"
                         "contrast_agent/stent_presence (the VasoVision role)")
    ap.add_argument("--filter_checkpoint", default=None)
    ap.add_argument("--skip_reference_filter", action="store_true")
    ap.add_argument("--fill_missing_targets", action="store_true",
                    help="validation-capable runs: create/zero-fill the config's target "
                         "columns (also DEEPCORO_RUN_MODE=val|auto)")
    args, rest = ap.parse_known_args(argv)
    base = config if config is not None else args.base_config
    filt = filter_config if filter_config is not None else args.filter_config

    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    table = read_csv_with_fallback(args.input_csv)

    # ---- stage 0: documented input spec -> framework columns ----
    fill = args.fill_missing_targets or (
        os.environ.get("DEEPCORO_RUN_MODE", "").strip().lower() in ("val", "auto"))
    targets = _target_labels(base) if fill else ()
    table = prepare_input_columns(table, target_labels=targets, fill_missing_targets=fill)

    # ---- stage 1: multiprocess DICOM -> clip conversion ----
    if "DICOMPath" in table.columns:
        table = convert_dicoms(table, out_dir, args.workers)

    if "Split" not in table.columns:
        _set_column(table, "Split", ["inference"] * len(table.rows))
    manifest = out_dir / "runtime_manifest.csv"
    write_csv(manifest, table.columns, table.rows)

    # ---- stage 2: view/contrast/diagnostic filtering ----
    if filt is not None:
        table = run_filter_model(table, manifest, filt, args.filter_checkpoint, out_dir, rest)
    if args.filter_module:
        import importlib

        mod = importlib.import_module(args.filter_module)
        before = len(table.rows)
        table = mod.filter_studies(table)
        _log(f"plug-in filter kept {len(table.rows)}/{before} rows")
    if not args.skip_reference_filter and set(FILTER_HEADS) & set(table.columns):
        before = len(table.rows)
        table = apply_reference_filter(table)
        _log(f"reference filter kept {len(table.rows)}/{before} rows")
    write_csv(manifest, table.columns, table.rows)

    # ---- stage 3: runtime config + in-process probing inference ----
    cfg = _runtime_config(base, manifest, rest)
    runner = _restored_runner(cfg, args.checkpoint, out_dir)
    preds = runner.inference(split="inference")
    columns = ["study_id"] + list(cfg.head_structure)
    write_csv(out_dir / "predictions.csv", columns, preds, sep=",")
    _log(f"wrote {len(preds)} predictions to {out_dir / 'predictions.csv'}")
    return preds


if __name__ == "__main__":
    main()
