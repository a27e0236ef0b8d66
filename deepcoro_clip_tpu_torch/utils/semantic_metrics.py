"""Tree/segment/severity ("semantic") retrieval metrics of multi-positive
validation.

The port's copy of ``compute_semantic_metrics`` of the JAX package's
``utils/semantic_metrics.py``: retrieval judged by whether the retrieved
texts describe the same coronary tree, segment and severity as a video's
positives:

- ``semantic/tree_recall@5``: the share of the top 5 whose tree is one of
  the video's trees, averaged over videos;
- ``semantic/segment_severity_alignment@15``: per positive segment, the
  share of the top 15 with that (segment, severity), averaged over
  segments, then videos;
- ``semantic/severity_tree_recall@{5,15}/<level>``: over all videos, the
  share of top-k entries of that severity in a tree where the positives
  have it.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np

DEFAULT_SEVERITY_LEVELS = ("normal", "mild", "moderate", "severe")


def _norm(value) -> Optional[str]:
    if value is None or (isinstance(value, float) and np.isnan(value)):
        return None
    text = str(value).strip().lower()
    return text if text and text not in {"nan", "none"} else None


def compute_semantic_metrics(
    sim: np.ndarray,
    video_positive_ids: Sequence[Sequence[str]],
    text_meta: Dict[str, Dict[str, Optional[str]]],
    all_text_ids: Sequence[str],
    top_tree_k: int = 5,
    top_segment_k: int = 15,
    severity_levels: Sequence[str] = DEFAULT_SEVERITY_LEVELS,
) -> Dict[str, float]:
    """Reference ``compute_siglip_semantic_metrics`` over plain arrays:
    ``sim`` [N videos, M texts]; ``video_positive_ids[i]`` the ground-truth
    positive text ids of video i; ``text_meta[text_id]`` carries
    tree/segment/severity (reference keys tree / segment /
    disease_severity also accepted)."""
    if sim.size == 0:
        return {}
    n_cand = sim.shape[1]
    tree_k = min(top_tree_k, n_cand)
    segment_k = min(top_segment_k, n_cand)
    if tree_k <= 0:
        return {}
    max_k = max(tree_k, segment_k)
    top = np.argsort(-sim, axis=1)[:, :max_k]

    def attrs_of(tid):
        meta = text_meta.get(tid)
        if meta is None:
            return None
        return {
            "tree": _norm(meta.get("tree")),
            "segment": _norm(meta.get("segment")),
            "severity": _norm(meta.get("severity",
                                       meta.get("disease_severity"))),
        }

    severity_levels = tuple(s.lower() for s in severity_levels)
    tree_scores: List[float] = []
    segment_scores: List[float] = []
    c5 = {s: [0, 0] for s in severity_levels}   # match, total
    c15 = {s: [0, 0] for s in severity_levels}

    for i, positives in enumerate(video_positive_ids):
        if i >= sim.shape[0] or not positives:
            continue
        gt_trees: set = set()
        segment_to_severity: Dict[str, set] = defaultdict(set)
        severity_to_trees: Dict[str, set] = defaultdict(set)
        for tid in positives:
            a = attrs_of(str(tid))
            if a is None:
                continue
            if a["tree"]:
                gt_trees.add(a["tree"])
                if a["severity"]:
                    severity_to_trees[a["severity"]].add(a["tree"])
            if a["segment"] and a["severity"]:
                segment_to_severity[a["segment"]].add(a["severity"])
        if not gt_trees and not segment_to_severity:
            continue

        pred_attrs = [
            attrs_of(str(all_text_ids[j])) if j < len(all_text_ids) else None
            for j in top[i]
        ]

        if gt_trees:
            matches = sum(1 for a in pred_attrs[:tree_k]
                          if a and a["tree"] in gt_trees)
            tree_scores.append(matches / tree_k)

        if segment_to_severity:
            per_segment = []
            for segment, sevs in segment_to_severity.items():
                if not sevs:
                    continue
                m = sum(1 for a in pred_attrs[:segment_k]
                        if a and a["segment"] == segment
                        and a["severity"] in sevs)
                per_segment.append(m / segment_k)
            if per_segment:
                segment_scores.append(float(np.mean(per_segment)))

        for sev in severity_levels:
            trees = severity_to_trees.get(sev)
            if not trees:
                continue
            m5 = sum(1 for a in pred_attrs[:tree_k]
                     if a and a["severity"] == sev and a["tree"] in trees)
            c5[sev][0] += m5
            c5[sev][1] += tree_k
            m15 = sum(1 for a in pred_attrs[:segment_k]
                      if a and a["severity"] == sev and a["tree"] in trees)
            c15[sev][0] += m15
            c15[sev][1] += segment_k

    out: Dict[str, float] = {}
    if tree_scores:
        out["semantic/tree_recall@5"] = float(np.mean(tree_scores))
    if segment_scores:
        out["semantic/segment_severity_alignment@15"] = float(
            np.mean(segment_scores))
    for sev in severity_levels:
        if c5[sev][1] > 0:
            out[f"semantic/severity_tree_recall@5/{sev}"] = (
                c5[sev][0] / c5[sev][1])
        if c15[sev][1] > 0:
            out[f"semantic/severity_tree_recall@15/{sev}"] = (
                c15[sev][0] / c15[sev][1])
    return out
