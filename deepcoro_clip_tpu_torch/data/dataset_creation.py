"""SigLIP manifests from per-segment stenosis findings.

The port's copy of ``SEGMENT_INFO``, ``canonical_prompt`` and
``build_siglip_manifests`` of the JAX package's
``data/dataset_creation.py``, on the standard library's ``csv`` instead of
pandas: one canonical prompt per distinct finding (``texts.csv``: text_id,
text, tree, segment, disease_severity), an edge from each video to each of
its findings' prompts weighted ``1 + percent / 100`` (``edges.csv``), and
the videos' file, id, split and study columns (``videos.csv``). The rest of
that module (report generation from structured predictions) is an offline
tool that no pipeline runs.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

from deepcoro_clip_tpu_torch.data.csv_utils import write_csv
from deepcoro_clip_tpu_torch.utils.stenosis_extractor import percent_to_severity

# segment -> (coronary tree, human-readable name)
SEGMENT_INFO: Dict[str, Tuple[str, str]] = {
    "left_main": ("left", "left main"),
    "prox_lad": ("left", "proximal LAD"),
    "mid_lad": ("left", "mid LAD"),
    "dist_lad": ("left", "distal LAD"),
    "d1": ("left", "first diagonal"),
    "d2": ("left", "second diagonal"),
    "prox_lcx": ("left", "proximal circumflex"),
    "dist_lcx": ("left", "distal circumflex"),
    "om1": ("left", "first obtuse marginal"),
    "om2": ("left", "second obtuse marginal"),
    "ramus": ("left", "ramus intermedius"),
    "prox_rca": ("right", "proximal RCA"),
    "mid_rca": ("right", "mid RCA"),
    "dist_rca": ("right", "distal RCA"),
    "pda": ("right", "posterior descending artery"),
    "posterolateral": ("right", "posterolateral branch"),
}


def canonical_prompt(segment: str, severity: str, percent: Optional[float] = None,
                     cto: bool = False) -> str:
    """The prompt of one finding: identical findings give identical
    strings, so the bank deduplicates them."""
    _, name = SEGMENT_INFO.get(segment, ("", segment.replace("_", " ")))
    if cto:
        return f"chronic total occlusion of the {name}"
    if severity == "normal":
        return f"the {name} is normal"
    if percent is not None:
        bucket = int(round(percent / 10.0) * 10)
        return f"{severity} stenosis of the {name} ({bucket}%)"
    return f"{severity} stenosis of the {name}"


def _missing(value: Any) -> bool:
    return value is None or (isinstance(value, float) and math.isnan(value))


def build_siglip_manifests(
    rows: Sequence[Dict[str, Any]],
    out_dir: str | Path,
    video_id_column: str = "video_id",
    filename_column: str = "FileName",
    segment_columns: Optional[Dict[str, str]] = None,
    cto_columns: Optional[Dict[str, str]] = None,
    split_column: str = "Split",
) -> Dict[str, Path]:
    """rows: one dict a video with per-segment stenosis-percent columns (a
    missing or NaN cell: no finding there). ``segment_columns``: {segment:
    column}, by default every ``<segment>_stenosis`` column of
    ``SEGMENT_INFO`` the rows have; ``cto_columns``: {segment: column} of
    truthy CTO flags. Writes ``texts.csv``, ``edges.csv`` and
    ``videos.csv`` into ``out_dir`` and returns their paths."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    columns: List[str] = []
    for r in rows:
        columns += [c for c in r if c not in columns]
    if segment_columns is None:
        segment_columns = {seg: f"{seg}_stenosis" for seg in SEGMENT_INFO
                           if f"{seg}_stenosis" in columns}
    cto_columns = cto_columns or {}

    text_ids: Dict[str, str] = {}
    texts_rows: List[dict] = []
    edges_rows: List[dict] = []

    def text_id_for(segment: str, severity: str, prompt: str) -> str:
        if prompt not in text_ids:
            tid = f"t{len(text_ids):06d}"
            text_ids[prompt] = tid
            tree, _ = SEGMENT_INFO.get(segment, ("", ""))
            texts_rows.append({"text_id": tid, "text": prompt, "tree": tree,
                               "segment": segment, "disease_severity": severity})
        return text_ids[prompt]

    for row in rows:
        vid = str(row[video_id_column] if video_id_column in row else row[filename_column])
        for seg, col in segment_columns.items():
            val = row.get(col)
            if _missing(val):
                continue
            pct = float(val)
            cto = bool(row.get(cto_columns.get(seg, ""), False))
            severity = "cto" if cto else percent_to_severity(pct)
            tid = text_id_for(seg, severity, canonical_prompt(seg, severity, pct, cto))
            # the edge weight grows with the finding's percent
            edges_rows.append({"video_id": vid, "text_id": tid, "weight": 1.0 + pct / 100.0})

    paths = {"texts": out_dir / "texts.csv", "edges": out_dir / "edges.csv",
             "videos": out_dir / "videos.csv"}
    write_csv(paths["texts"], ["text_id", "text", "tree", "segment", "disease_severity"],
              texts_rows, sep=",")
    write_csv(paths["edges"], ["video_id", "text_id", "weight"], edges_rows, sep=",")
    video_cols = [c for c in (filename_column, video_id_column, split_column,
                              "StudyInstanceUID") if c in columns]
    write_csv(paths["videos"], video_cols, rows, sep=",")
    return paths
