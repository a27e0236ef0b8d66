"""Procedural synthetic angiography corpus (numpy only).

The port's copy of the JAX package's ``data/synthetic_angio.py``: the same
seeded findings, report text and rendered clips, bit for bit, so a run of
either package can train on the same corpus with no download. Manifests are
written with the standard library's ``csv`` in the ``α``-separated format
the JAX package writes with pandas (``data/csv_utils.write_csv``).

Visual model: a fixed tree of 8 coronary-named segments, each a curved
vessel with a fixed anchor; a finding (segment, severity) renders as a
narrowing whose residual width is monotone in the reported percent, plus a
bright collateral ring (a CTO is a gap with no distal run-off); a contrast
bolus sweeps the vessels over the frames. Report model: template sentences
per finding with seeded paraphrase.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from deepcoro_clip_tpu_torch.data.csv_utils import read_csv_with_fallback, write_csv

MANIFEST_COLUMNS = ["FileName", "Report", "StudyInstanceUID", "Split"]
# (name, start_xy, ctrl_xy, end_xy) in unit coordinates — a quadratic Bezier
# per segment, anchors spread so position identifies the segment.
SEGMENTS: List[Tuple[str, Tuple[float, float], Tuple[float, float], Tuple[float, float]]] = [
    ("left main", (0.50, 0.08), (0.55, 0.18), (0.58, 0.30)),
    ("proximal lad", (0.58, 0.30), (0.52, 0.45), (0.50, 0.60)),
    ("mid lad", (0.50, 0.60), (0.47, 0.72), (0.46, 0.86)),
    ("first diagonal", (0.54, 0.45), (0.68, 0.55), (0.78, 0.68)),
    ("proximal circumflex", (0.58, 0.30), (0.72, 0.33), (0.84, 0.42)),
    ("first obtuse marginal", (0.76, 0.38), (0.86, 0.52), (0.90, 0.66)),
    ("proximal rca", (0.22, 0.18), (0.16, 0.35), (0.16, 0.52)),
    ("mid rca", (0.16, 0.52), (0.18, 0.68), (0.28, 0.82)),
]

SEVERITIES = ["normal", "mild", "moderate", "severe", "critical", "cto"]


def narrowing_of(f: "Finding") -> float:
    """Residual lumen width fraction — CONTINUOUS in the reported percent,
    so fine-grained report percents are visually grounded (the hard corpus
    tier measures fine discrimination, not memorization)."""
    if f.severity == "normal":
        return 1.0
    if f.severity == "cto":
        return 0.0
    return max(0.08, 1.0 - 0.0095 * f.pct)
# representative percents for report text
SEVERITY_PCT = {
    "mild": (20, 45), "moderate": (50, 65), "severe": (70, 85),
    "critical": (90, 99),
}

_TEMPLATES = [
    "{seg} with {pct}% stenosis.",
    "{pct}% lesion in the {seg}.",
    "the {seg} shows {pct}% narrowing.",
]
_NORMAL_TEMPLATES = [
    "{seg} is normal.",
    "no significant disease in the {seg}.",
]
_CTO_TEMPLATES = [
    "chronic total occlusion of the {seg}.",
    "the {seg} is totally occluded.",
]


@dataclass(frozen=True)
class Finding:
    segment: int  # index into SEGMENTS
    severity: str
    pct: int  # report percent (0 for normal/cto)


def _rng_for(video_id: int, seed: int) -> np.random.Generator:
    h = hashlib.sha256(f"{seed}:{video_id}".encode()).digest()
    return np.random.default_rng(int.from_bytes(h[:8], "little"))


def sample_findings(video_id: int, seed: int, max_findings: int = 2,
                    coarse_pct: bool = False) -> List[Finding]:
    """``coarse_pct`` snaps report percents to the bucket midpoint, shrinking
    the text vocabulary to the (segment x severity) grid — the easy corpus
    tier for learnability regression tests."""
    rng = _rng_for(video_id, seed)
    n = int(rng.integers(1, max_findings + 1))
    segs = rng.choice(len(SEGMENTS), size=n, replace=False)
    out = []
    for s in sorted(int(x) for x in segs):
        sev = SEVERITIES[int(rng.integers(0, len(SEVERITIES)))]
        if sev in SEVERITY_PCT:
            lo, hi = SEVERITY_PCT[sev]
            pct = (lo + hi) // 2 if coarse_pct else int(rng.integers(lo, hi + 1))
        else:
            pct = 0
        out.append(Finding(segment=s, severity=sev, pct=pct))
    return out


def report_text(findings: Sequence[Finding], video_id: int, seed: int,
                paraphrase: bool = True) -> str:
    rng = _rng_for(video_id * 2654435761 + 1, seed)
    parts = []
    for f in findings:
        name = SEGMENTS[f.segment][0]
        if f.severity == "normal":
            tpl = _NORMAL_TEMPLATES[
                int(rng.integers(0, len(_NORMAL_TEMPLATES))) if paraphrase else 0
            ]
            parts.append(tpl.format(seg=name))
        elif f.severity == "cto":
            tpl = _CTO_TEMPLATES[
                int(rng.integers(0, len(_CTO_TEMPLATES))) if paraphrase else 0
            ]
            parts.append(tpl.format(seg=name))
        else:
            tpl = _TEMPLATES[
                int(rng.integers(0, len(_TEMPLATES))) if paraphrase else 0
            ]
            parts.append(tpl.format(seg=name, pct=f.pct))
    return " ".join(parts)


# --------------------------------------------------------------------- #
# rendering
# --------------------------------------------------------------------- #

_N_SAMPLES = 160  # points per vessel


def _bezier_points(size: int):
    """[n_seg, N, 2] pixel coordinates of each segment's centerline."""
    t = np.linspace(0.0, 1.0, _N_SAMPLES)[:, None]
    pts = []
    for _, p0, p1, p2 in SEGMENTS:
        p0, p1, p2 = map(np.asarray, (p0, p1, p2))
        c = ((1 - t) ** 2) * p0 + 2 * (1 - t) * t * p1 + (t**2) * p2
        pts.append(c * (size - 1))
    return np.stack(pts)  # [S, N, 2] (x, y)


_POINT_CACHE: Dict[int, np.ndarray] = {}


def _points(size: int) -> np.ndarray:
    if size not in _POINT_CACHE:
        _POINT_CACHE[size] = _bezier_points(size)
    return _POINT_CACHE[size]


def _paint(img: np.ndarray, xs, ys, width: np.ndarray, value: float):
    """Accumulate discs of per-point ``width`` onto img (additive, clipped by
    caller). Vectorized over (points x offsets)."""
    size = img.shape[0]
    wmax = int(np.ceil(width.max())) if width.size else 0
    if wmax <= 0:
        return
    off = np.arange(-wmax, wmax + 1)
    dx, dy = np.meshgrid(off, off)
    mask_r = np.sqrt(dx**2 + dy**2)  # [K, K]
    px = np.clip(xs[:, None, None] + dx[None], 0, size - 1).astype(np.int32)
    py = np.clip(ys[:, None, None] + dy[None], 0, size - 1).astype(np.int32)
    keep = mask_r[None] <= width[:, None, None]
    np.maximum.at(img, (py[keep], px[keep]), value)


def render_clip(
    video_id: int,
    seed: int,
    size: int = 224,
    frames: int = 16,
    findings: Optional[Sequence[Finding]] = None,
) -> np.ndarray:
    """[frames, size, size, 3] uint8 clip for a video id."""
    rng = _rng_for(video_id * 7 + 3, seed)
    if findings is None:
        findings = sample_findings(video_id, seed)
    by_seg = {f.segment: f for f in findings}

    pts = _points(size)  # [S, N, 2]
    base_w = max(2.0, size / 40.0)

    # static vessel layer (per clip): width profile per segment
    vessel = np.zeros((size, size), np.float32)
    lesion = np.zeros((size, size), np.float32)
    for s in range(pts.shape[0]):
        xs, ys = pts[s, :, 0], pts[s, :, 1]
        w = np.full(_N_SAMPLES, base_w, np.float32)
        f = by_seg.get(s)
        if f is not None and f.severity != "normal":
            narrow = narrowing_of(f)
            lo, hi = int(_N_SAMPLES * 0.60), int(_N_SAMPLES * 0.90)
            w[lo:hi] = base_w * narrow
            # bright collateral ring at the lesion, scaled by severity
            ring = np.zeros((size, size), np.float32)
            mid = (lo + hi) // 2
            _paint(ring, xs[mid : mid + 1], ys[mid : mid + 1],
                   np.asarray([base_w * 3.0]), 1.0)
            lesion += ring * (1.0 - narrow) * 0.5
            if f.severity == "cto":
                w[lo:] = 0.0  # no distal run-off
        _paint(vessel, xs, ys, w, 1.0)

    # temporal contrast bolus: front advances along every vessel
    phase = float(rng.uniform(0.0, 0.3))
    clip = np.empty((frames, size, size), np.float32)
    noise = rng.normal(0.12, 0.04, size=(size // 8, size // 8)).astype(np.float32)
    bg = np.kron(noise, np.ones((8, 8), np.float32))[:size, :size]
    for t in range(frames):
        front = phase + (1.0 - phase) * (t + 1) / frames
        sweep = np.zeros((size, size), np.float32)
        n_vis = max(2, int(_N_SAMPLES * front))
        for s in range(pts.shape[0]):
            xs, ys = pts[s, :n_vis, 0], pts[s, :n_vis, 1]
            w = np.full(n_vis, base_w, np.float32)
            f = by_seg.get(s)
            if f is not None and f.severity != "normal":
                narrow = narrowing_of(f)
                lo, hi = int(_N_SAMPLES * 0.60), int(_N_SAMPLES * 0.90)
                w[lo : min(hi, n_vis)] = base_w * narrow
                if f.severity == "cto":
                    w[lo:] = 0.0
            _paint(sweep, xs, ys, w, 1.0)
        frame = bg + 0.25 * vessel + 0.55 * sweep * vessel + lesion
        clip[t] = frame
    clip = np.clip(clip, 0.0, 1.0)
    u8 = (clip * 255.0).astype(np.uint8)
    return np.repeat(u8[..., None], 3, axis=-1)


# --------------------------------------------------------------------- #
# corpus generation
# --------------------------------------------------------------------- #


def generate_corpus(
    out_dir: str | Path,
    n_train: int = 6000,
    n_val: int = 1024,
    size: int = 224,
    frames: int = 16,
    seed: int = 0,
    max_findings: int = 2,
    paraphrase: bool = True,
    coarse_pct: bool = False,
) -> Path:
    """Write clips as .npy + a manifest CSV; returns the manifest path.
    Skips clips that already exist (resumable)."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    rows = []
    for i in range(n_train + n_val):
        split = "train" if i < n_train else "val"
        path = out / f"clip_{i:06d}.npy"
        findings = sample_findings(i, seed, max_findings, coarse_pct)
        if not path.exists():
            np.save(path, render_clip(i, seed, size, frames, findings))
        rows.append(
            {
                "FileName": str(path),
                "Report": report_text(findings, i, seed, paraphrase),
                "StudyInstanceUID": f"SYN{i:06d}",
                "Split": split,
            }
        )
    manifest = out / "data.csv"
    write_csv(manifest, MANIFEST_COLUMNS, rows)
    return manifest


SEGMENT_SLUGS = [name.replace(" ", "_") for name, _, _, _ in SEGMENTS]

# ≥70% obstruction — the reference's stenosis-binarization threshold
# (utils/stenosis_extractor ladder; README's "stenosis AUROC" task is a
# frozen-backbone probe of exactly this per-segment binary).
_OBSTRUCTIVE = ("severe", "critical", "cto")


def probe_label_columns() -> List[str]:
    """Label columns for frozen-backbone linear probing, in CSV order."""
    return ([f"stenosis_{s}" for s in SEGMENT_SLUGS]
            + ["severe_any", "cto_any", "max_stenosis_pct"])


def probe_labels_for(video_id: int, seed: int, max_findings: int = 2,
                     coarse_pct: bool = False) -> Dict[str, float]:
    """Ground-truth probing labels for one corpus clip, derived from the
    same ``sample_findings`` call that rendered it (pure function of
    (video_id, corpus seed) — no label files need to survive VM resets).

    Heads mirror the reference's probing task shapes
    (runners/linear_probing_runner.py:567-691 output over
    config/linear_probing/stenosis):
      - ``stenosis_<segment>``: binary, that segment carries a >=70%
        lesion (severe/critical/CTO);
      - ``severe_any``: binary, any segment >=70%;
      - ``cto_any``: binary, any chronic total occlusion;
      - ``max_stenosis_pct``: regression 0-100, worst lesion percent
        (CTO = 100) — the MAE analog of the reference's LVEF head.
    """
    findings = sample_findings(video_id, seed, max_findings, coarse_pct)
    labels: Dict[str, float] = {f"stenosis_{s}": 0.0 for s in SEGMENT_SLUGS}
    mx = 0.0
    cto = 0.0
    for f in findings:
        pct = 100.0 if f.severity == "cto" else float(f.pct)
        if f.severity in _OBSTRUCTIVE:
            labels[f"stenosis_{SEGMENT_SLUGS[f.segment]}"] = 1.0
        if f.severity == "cto":
            cto = 1.0
        mx = max(mx, pct)
    labels["severe_any"] = float(any(
        labels[f"stenosis_{s}"] for s in SEGMENT_SLUGS))
    labels["cto_any"] = cto
    labels["max_stenosis_pct"] = mx
    return labels


def write_probe_labels(corpus_dir: str | Path, seed: int,
                       max_findings: int = 2,
                       coarse_pct: bool = False) -> Path:
    """Augment a generated corpus manifest with probing label columns;
    writes ``probe_labels.csv`` next to ``data.csv`` and returns its path."""
    corpus = Path(corpus_dir)
    out_csv = corpus / "probe_labels.csv"
    table = read_csv_with_fallback(corpus / "data.csv")
    rows = [dict(r, **probe_labels_for(int(str(r["StudyInstanceUID"]).replace("SYN", "")),
                                       seed, max_findings, coarse_pct))
            for r in table.rows]
    write_csv(out_csv, table.columns + probe_label_columns(), rows)
    return out_csv


def merge_study_findings(findings_per_clip: Sequence[Sequence[Finding]]
                         ) -> List[Finding]:
    """Study-level ground truth from member clips: keep the MOST SEVERE
    finding per segment (max obstruction) — the same worst-lesion-per-vessel
    rule the reference's study aggregation applies
    (utils/data_aggregation.py max-stenosis merge)."""
    best: Dict[int, Finding] = {}
    for findings in findings_per_clip:
        for f in findings:
            cur = best.get(f.segment)
            if cur is None or narrowing_of(f) < narrowing_of(cur):
                best[f.segment] = f
    return [best[s] for s in sorted(best)]


def write_study_manifest(corpus_dir: str | Path, seed: int,
                         max_findings: int = 2, coarse_pct: bool = False,
                         videos_per_study: Tuple[int, int] = (2, 4),
                         group_seed: int = 1234) -> Path:
    """Group an existing single-video corpus into multi-view studies
    (north-star config #2, reference
    config/clip/base_config_x3d_m_multivideo.yaml): N clips share a
    StudyInstanceUID and ONE study report describing the union of their
    findings (different views show different vessels; worst lesion per
    segment wins — ``merge_study_findings``). Reuses the rendered clips
    as-is; writes ``study_data.csv`` next to ``data.csv``."""
    corpus = Path(corpus_dir)
    out_csv = corpus / "study_data.csv"
    table = read_csv_with_fallback(corpus / "data.csv")
    rng = np.random.default_rng(group_seed)
    rows = []
    n_study = 0
    for split in ("train", "val"):
        sub = [r for r in table.rows if r["Split"] == split]
        ids = np.asarray([int(str(r["StudyInstanceUID"]).replace("SYN", ""))
                          for r in sub], dtype=np.int64)
        order = rng.permutation(len(ids))
        i = 0
        while i < len(order):
            n = int(rng.integers(videos_per_study[0], videos_per_study[1] + 1))
            members = order[i:i + n]
            i += n
            clip_ids = [int(ids[m]) for m in members]
            merged = merge_study_findings([
                sample_findings(c, seed, max_findings, coarse_pct)
                for c in clip_ids
            ])
            text = report_text(merged, 7_000_000 + n_study, seed,
                               paraphrase=True)
            uid = f"SYNSTUDY{n_study:05d}"
            n_study += 1
            for m in members:
                rows.append({
                    "FileName": sub[int(m)]["FileName"],
                    "Report": text,
                    "StudyInstanceUID": uid,
                    "Split": split,
                })
    write_csv(out_csv, MANIFEST_COLUMNS, rows)
    return out_csv
