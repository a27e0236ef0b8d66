"""Single-head SigLIP retrieval sampler (batch-level targets).

The port's copy of the JAX package's ``data/single_head_sampler.py``
(stdlib ``random`` and numpy; nothing here touches the card):

- severity-aware positive capping: abnormal prompts always enter; NORMAL
  prompts are picked round-robin under a weight budget of a third of the
  abnormal weight when the video has abnormal prompts;
- exam-severity positive weights (normal 0.25 ... severe/critical/cto 1.5)
  composed with the soft, class and base weights;
- bucketed negative quotas drained in priority order same_segment ->
  same_tree -> cross_tree across all positives, then a global fallback
  pool, with per-(video, bucket) round-robin state;
- preferred-severity targeting (normal/mild positives attract severe
  negatives and the reverse) and negative weight scaling (normal 0.25,
  mild or calcification 0.75, abnormal 1.5; same segment x1.5 with the
  contradiction boost, same tree x1.25);
- class-balance statistics: effective-number class weights and prior logit
  biases keyed by (segment, bin, stent).

The output is the dense SigLIP (labels, weights) pair over the batch's
deduplicated text bank, which ``losses/contrastive.siglip_single_head_loss``
consumes through ``data/collate.collate_single_head``, plus per-text
metadata and an audit trail.

Given the same catalog, seed and calls, the sampler returns what the JAX
package's returns, bit for bit: the same ``random.Random`` draws and the
same round-robin state carried across calls (``_rr_state``, ``_pos_rr``).
``state_dict`` / ``load_state_dict`` carry that state and the generator's
through a checkpoint, so that a resumed run draws as an uninterrupted one
(the JAX package does not save it).
"""

from __future__ import annotations

import math
import random
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Sequence, Set, Tuple

import numpy as np

ClassKey = Tuple[Optional[str], Optional[str], Optional[str]]

ABNORMAL_CATEGORIES = {
    "stenosis", "in_stent", "thrombus", "calcification", "cto", "medina",
}
SUMMARY_BUCKETS = {"summary", "other_summary"}
DEFAULT_POSITIVE_SEVERITY_WEIGHTS = {
    "normal": 0.25, "mild": 0.5, "moderate": 1.0,
    "severe": 1.5, "critical": 1.5, "cto": 1.5,
}
SEVERITY_ORDER = {"normal": 0, "mild": 1, "moderate": 2, "severe": 3}


@dataclass(frozen=True)
class TextEntry:
    """Canonical metadata for one prompt in the text catalog."""

    text_id: str
    prompt_text: str = ""
    prompt_type: Optional[str] = None
    category: Optional[str] = None
    segment: Optional[str] = None
    bin: Optional[str] = None
    tree: Optional[str] = None
    stent: Optional[str] = None
    soft_weight: float = 1.0
    disease_severity: Optional[str] = None
    prompt_bucket: Optional[str] = None
    class_key: Optional[ClassKey] = None
    logit_bias: float = 0.0
    class_weight: float = 1.0


@dataclass
class VideoEntry:
    """One video's sampling request: its positive pairs + exam context."""

    video_id: str
    exam_severity: str = "NORMAL"  # NORMAL | MILD | SEVERE
    tree: Optional[str] = None
    positive_pairs: Sequence[Tuple[str, float]] = ()


@dataclass
class SamplerOutput:
    text_ids: List[str]
    labels: np.ndarray   # [B, T] float32, 1.0 on positives
    weights: np.ndarray  # [B, T] float32, per-pair loss weights
    text_metadata: List[Dict[str, Any]]
    audit: Dict[str, Any]


@dataclass(frozen=True)
class _Candidate:
    meta: TextEntry
    bucket: str
    reason: str


def severity_label(meta: TextEntry) -> str:
    """Severity ladder: explicit severity > stenosis bin > category;
    critical/cto collapse into 'severe'."""
    sev = (meta.disease_severity or "").strip().lower()
    if sev in {"critical", "cto"}:
        return "severe"
    if sev in SEVERITY_ORDER:
        return sev
    b = _normalize_bin(meta.bin)
    if b in {"0", "<30"}:
        return "normal"
    if b == "30-49":
        return "mild"
    if b == "50-69":
        return "moderate"
    if b in {"70-89", ">=90", "100", "cto"}:
        return "severe"
    cat = (meta.category or "").lower()
    if cat == "normal":
        return "normal"
    if cat in ABNORMAL_CATEGORIES:
        return "severe"
    return "unknown"


def _normalize_bin(b) -> str:
    if b is None:
        return ""
    if isinstance(b, float):
        if math.isnan(b):
            return ""
        s = f"{b:.0f}" if b.is_integer() else str(b)
        return s.strip().lower()
    return str(b).strip().lower()


def _severity_rank(s: str) -> int:
    if not s:
        return -1
    base = s.strip().lower()
    if base in {"critical", "cto"}:
        base = "severe"
    return SEVERITY_ORDER.get(base, -1)


def _is_abnormal(meta: TextEntry) -> bool:
    if (meta.category or "").lower() in ABNORMAL_CATEGORIES:
        return True
    if (meta.prompt_bucket or "").lower() == "abnormal":
        return True
    return (meta.disease_severity or "").lower() in {
        "mild", "moderate", "severe", "critical", "cto"}


def _is_summary(meta: TextEntry) -> bool:
    return ((meta.prompt_bucket or "").lower() in SUMMARY_BUCKETS
            or (meta.category or "").lower() == "summary")


def _same_segment_targets(sev: str) -> Set[str]:
    """Severities a same-segment negative may carry."""
    ladder = {"normal": {"mild", "moderate", "severe"},
              "mild": {"moderate", "severe"},
              "moderate": {"mild", "severe"},
              "severe": {"mild", "moderate"}}
    return ladder.get(sev, set())


def _preferred_negative_severities(sev: str) -> Set[str]:
    """Maximally contrastive severity per positive."""
    if sev in {"normal", "mild"}:
        return {"severe"}
    if sev in {"moderate", "severe"}:
        return {"normal"}
    return set()


class SingleHeadRetrievalSampler:
    """Batch-level SigLIP target construction with the reference's severity
    priors, bucketed negative quotas, and round-robin coverage state."""

    def __init__(
        self,
        text_catalog: Dict[str, TextEntry],
        *,
        alpha_neg: float = 2.0,
        rng: Optional[random.Random] = None,
        max_negatives: int = 0,
        base_negative_weight: float = 0.04,
        round_robin: bool = False,
        min_pos_weight: float = 0.0,
        positive_severity_weights: Optional[Dict[str, float]] = None,
        neg_normal_scale: float = 0.25,
        neg_mild_scale: float = 0.75,
        neg_abnormal_scale: float = 1.5,
        same_segment_boost: float = 1.5,
        same_tree_boost: float = 1.25,
        contradiction_boost: float = 1.0,
        contradiction_min_severity: str = "moderate",
    ) -> None:
        self.catalog = text_catalog
        self.alpha_neg = alpha_neg
        self._rng = rng or random.Random(0)
        self.max_negatives = max(0, int(max_negatives))
        self.base_negative_weight = max(0.0, float(base_negative_weight))
        self.round_robin = bool(round_robin)
        self.min_pos_weight = max(0.0, float(min_pos_weight))
        self.pos_sev_weights = dict(DEFAULT_POSITIVE_SEVERITY_WEIGHTS)
        for k, v in (positive_severity_weights or {}).items():
            try:
                self.pos_sev_weights[str(k).lower()] = max(float(v), 0.0)
            except (TypeError, ValueError):
                continue
        self.neg_normal_scale = max(0.0, float(neg_normal_scale))
        self.neg_mild_scale = max(0.0, float(neg_mild_scale))
        self.neg_abnormal_scale = max(0.0, float(neg_abnormal_scale))
        self.same_segment_boost = max(0.0, float(same_segment_boost))
        self.same_tree_boost = max(0.0, float(same_tree_boost))
        self.contradiction_boost = max(0.0, float(contradiction_boost))
        self._contra_min_rank = _severity_rank(contradiction_min_severity)

        # per-(video, bucket-key) round-robin coverage state
        self._rr_state: Dict[str, Dict[str, int]] = defaultdict(dict)
        self._pos_rr: Dict[str, int] = {}

        self._by_segment: Dict[str, List[TextEntry]] = defaultdict(list)
        self._by_tree: Dict[str, List[TextEntry]] = defaultdict(list)
        self._all: List[TextEntry] = list(text_catalog.values())
        for m in self._all:
            if m.segment:
                self._by_segment[m.segment].append(m)
            if m.tree:
                self._by_tree[m.tree].append(m)

    def state_dict(self) -> Dict[str, Any]:
        """What later calls depend on: the generator's state and the
        round-robin state, as plain tuples, dicts, ints and strings."""
        return {"rng": self._rng.getstate(),
                "rr_state": {v: dict(d) for v, d in self._rr_state.items()},
                "pos_rr": dict(self._pos_rr)}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        version, internal, gauss = state["rng"]
        self._rng.setstate((version, tuple(internal), gauss))
        self._rr_state = defaultdict(dict, {v: dict(d)
                                            for v, d in state["rr_state"].items()})
        self._pos_rr = dict(state["pos_rr"])

    # -------------------------------------------------------------- #

    def prepare_batch(self, batch_videos: Sequence[VideoEntry], *,
                      epoch: int = 0, phase: str = "train") -> SamplerOutput:
        """Dense (labels, weights) over the batch's deduped text bank;
        labels take the max across duplicate pairs, weights accumulate."""
        B = len(batch_videos)
        text_ids: List[str] = []
        per_video: List[List[Tuple[str, float, float]]] = []
        audits: Dict[str, Any] = {}
        for v in batch_videos:
            entries, audit = self._video_entries(v)
            per_video.append(entries)
            audits[v.video_id] = audit
            for tid, _, _ in entries:
                if tid not in text_ids:
                    text_ids.append(tid)
        col = {t: i for i, t in enumerate(text_ids)}
        labels = np.zeros((B, len(text_ids)), np.float32)
        weights = np.zeros_like(labels)
        for r, entries in enumerate(per_video):
            for tid, y, w in entries:
                c = col[tid]
                labels[r, c] = max(labels[r, c], y)
                weights[r, c] += w
        meta = [self._meta_dict(self.catalog[t]) for t in text_ids]
        return SamplerOutput(text_ids, labels, weights, meta,
                             {"videos": audits, "phase": phase,
                              "epoch": epoch})

    # -------------------------------------------------------------- #

    def _video_entries(self, video: VideoEntry):
        audit: Dict[str, Any] = {"positives": [], "negatives": []}
        pairs = [(self.catalog[t], float(w))
                 for t, w in video.positive_pairs if t in self.catalog]
        if not pairs:
            return [], audit
        selected, skipped = self._select_positives(video.video_id, pairs)
        for m, _ in skipped:
            audit["positives"].append(
                {"text_id": m.text_id, "weight": 0.0,
                 "severity": severity_label(m), "note": "capped_normal"})
        positives: List[Tuple[str, float, float]] = []
        pos_ids: Set[str] = set()
        pos_meta: List[TextEntry] = []
        for m, base in selected:
            w = self._positive_weight(m, base)
            positives.append((m.text_id, 1.0, w))
            pos_ids.add(m.text_id)
            pos_meta.append(m)
            audit["positives"].append(
                {"text_id": m.text_id, "weight": w,
                 "severity": severity_label(m)})
        if not positives:
            return [], audit
        negs, neg_audit = self._build_negatives(video, pos_meta, pos_ids)
        audit["negatives"].extend(neg_audit)
        return positives + negs, audit

    def _select_positives(self, video_id, pairs):
        """Abnormals pass; normals round-robin under weight budget."""
        normals = [(m, w) for m, w in pairs if severity_label(m) == "normal"]
        abnormals = [(m, w) for m, w in pairs
                     if severity_label(m) != "normal"]
        selected = list(abnormals)
        if not normals:
            return selected, []
        if not abnormals:
            picks, skipped = self._select_normals(video_id, normals, None)
        else:
            budget = max(sum(self._sev_weight(m) for m, _ in abnormals) / 3.0,
                         0.0)
            picks, skipped = self._select_normals(video_id, normals, budget)
        selected.extend(picks)
        return selected, skipped

    def _select_normals(self, video_id, normal_pairs, max_weight):
        """Round-robin normals under a severity-weight budget."""
        pairs = sorted(normal_pairs, key=lambda p: p[0].text_id)
        total = len(pairs)
        limit = float("inf") if max_weight is None else max(max_weight, 0.0)
        start = self._pos_rr.get(video_id, 0) % total
        picks: List[Tuple[TextEntry, float]] = []
        used = 0.0
        visited = 0
        while visited < total:
            pair = pairs[(start + visited) % total]
            visited += 1
            w = self._sev_weight(pair[0])
            if used + w <= limit + 1e-6 or not picks or math.isinf(limit):
                picks.append(pair)
                used += w
            if used >= limit - 1e-6 and not math.isinf(limit):
                break
        if not picks and pairs:
            picks.append(pairs[start])
            visited = max(visited, 1)
        self._pos_rr[video_id] = (start + max(visited, 1)) % total
        picked = {m.text_id for m, _ in picks}
        return picks, [p for p in pairs if p[0].text_id not in picked]

    def _sev_weight(self, meta: TextEntry) -> float:
        return self.pos_sev_weights.get(severity_label(meta), 1.0)

    def _positive_weight(self, meta: TextEntry, base: float) -> float:
        w = (float(meta.soft_weight or 1.0) * float(meta.class_weight or 1.0)
             * max(base, 0.0) * max(self._sev_weight(meta), 1e-3))
        return max(w, self.min_pos_weight)

    # ---- negatives ------------------------------------------------ #

    def _gather_same_segment(self, pos: TextEntry, pos_ids: Set[str]):
        if not pos.segment:
            return []
        sev = severity_label(pos)
        targets = _same_segment_targets(sev)
        preferred_sev = _preferred_negative_severities(sev)
        preferred, fallback = [], []
        for m in self._by_segment.get(pos.segment, []):
            if m.text_id in pos_ids or m.text_id == pos.text_id:
                continue
            if _is_summary(m):
                continue
            cs = severity_label(m)
            cand = _Candidate(m, "same_segment",
                              f"segment:{pos.segment}|severity:{cs}")
            if cs in preferred_sev:
                preferred.append(cand)
            elif cs in targets:
                fallback.append(cand)
        return _dedupe(preferred) or _dedupe(fallback)

    def _gather_same_tree(self, pos: TextEntry, pos_ids: Set[str]):
        tree = (pos.tree or "").lower()
        if not tree:
            return []
        sev = severity_label(pos)
        preferred_sev = _preferred_negative_severities(sev)
        preferred, fallback = [], []
        for m in self._by_tree.get(tree, []):
            if m.text_id in pos_ids or m.text_id == pos.text_id:
                continue
            if _is_summary(m) or m.segment == pos.segment or not m.segment:
                continue
            cs = severity_label(m)
            if cs == "unknown" or (sev == "normal" and cs == "normal"):
                continue
            cand = _Candidate(m, "same_tree",
                              f"tree:{tree}|segment:{m.segment}|severity:{cs}")
            if cs in preferred_sev:
                preferred.append(cand)
            elif cs != sev:
                fallback.append(cand)
        return _dedupe(preferred) or _dedupe(fallback)

    def _gather_cross_tree(self, pos: TextEntry, pos_ids: Set[str]):
        pos_tree = (pos.tree or "").lower()
        sev = severity_label(pos)
        preferred_sev = _preferred_negative_severities(sev)
        trees = ([t for t in self._by_tree if t != pos_tree]
                 if pos_tree else list(self._by_tree))
        preferred, fallback = [], []
        for tree in trees:
            for m in self._by_tree.get(tree, []):
                if m.text_id in pos_ids or _is_summary(m):
                    continue
                cs = severity_label(m)
                if cs == "unknown":
                    continue
                if cs == sev and sev != "unknown":
                    continue
                if sev == "normal" and cs == "normal":
                    continue
                cand = _Candidate(
                    m, "cross_tree",
                    f"tree:{tree}|segment:{m.segment}|severity:{cs}")
                if cs in preferred_sev:
                    preferred.append(cand)
                elif cs != sev:
                    fallback.append(cand)
        return _dedupe(preferred) or _dedupe(fallback)

    def _build_negatives(self, video, pos_meta, pos_ids):
        """Priority-exhaustive bucket fill: drain
        same_segment across ALL positives, then same_tree, then cross_tree,
        then a global fallback pool up to ``max_negatives``."""
        if self.max_negatives <= 0:
            return [], []
        used: Set[str] = set(pos_ids)
        groups = [(m, {"same_segment": self._gather_same_segment(m, pos_ids),
                       "same_tree": self._gather_same_tree(m, pos_ids),
                       "cross_tree": self._gather_cross_tree(m, pos_ids)})
                  for m in pos_meta]
        negatives: List[Tuple[str, float, float]] = []
        audit: List[Dict[str, Any]] = []
        for bucket in ("same_segment", "same_tree", "cross_tree"):
            if len(negatives) >= self.max_negatives:
                break
            progress = True
            while len(negatives) < self.max_negatives and progress:
                progress = False
                for m, group in groups:
                    if len(negatives) >= self.max_negatives:
                        break
                    cands = group[bucket]
                    if not cands:
                        continue
                    key = (f"{bucket}|{(m.tree or 'unknown').lower()}"
                           f"|{m.segment or 'none'}|{severity_label(m)}")
                    pick = self._pop(video.video_id, key, cands, used)
                    if pick is None:
                        continue
                    w = self._negative_weight(pick.meta, m)
                    negatives.append((pick.meta.text_id, 0.0, w))
                    audit.append({"text_id": pick.meta.text_id, "weight": w,
                                  "bucket": bucket, "reason": pick.reason,
                                  "positive_ref": m.text_id})
                    progress = True
        if len(negatives) < self.max_negatives:
            for m in self._all:
                if len(negatives) >= self.max_negatives:
                    break
                if m.text_id in used or _is_summary(m):
                    continue
                used.add(m.text_id)
                w = self._negative_weight(m, None)
                negatives.append((m.text_id, 0.0, w))
                audit.append({"text_id": m.text_id, "weight": w,
                              "bucket": "fallback", "reason": "global_pool",
                              "positive_ref": None})
        return negatives[:self.max_negatives], audit[:self.max_negatives]

    def _pop(self, video_id, key, cands: List[_Candidate], used: Set[str]):
        pool = [c for c in cands if c.meta.text_id not in used]
        if not pool:
            return None
        if self.round_robin:
            state = self._rr_state[video_id]
            off = state.get(key, 0) % len(pool)
            state[key] = (off + 1) % len(pool)
            pick = pool[off]
        else:
            pick = pool[self._rng.randrange(len(pool))]
        used.add(pick.meta.text_id)
        cands[:] = [c for c in cands if c.meta.text_id != pick.meta.text_id]
        return pick

    def _negative_weight(self, cand: TextEntry,
                         ref: Optional[TextEntry]) -> float:
        """base x severity scale x proximity boosts."""
        w = self.base_negative_weight
        sev = (cand.disease_severity or "").strip().lower()
        cat = (cand.category or "").strip().lower()
        if not _is_abnormal(cand):
            scale = self.neg_normal_scale
        elif sev == "mild" or cat == "calcification":
            scale = self.neg_mild_scale
        else:
            scale = self.neg_abnormal_scale
        w *= max(scale, 0.0)
        if ref is not None:
            same_seg = bool(cand.segment and ref.segment
                            and cand.segment == ref.segment)
            same_tree = bool(cand.tree and ref.tree
                             and cand.tree == ref.tree)
            if same_seg:
                w *= max(self.same_segment_boost, 0.0)
                if (self.contradiction_boost > 0.0
                        and self._contra_min_rank >= 0
                        and severity_label(cand) == "normal"
                        and _severity_rank(severity_label(ref))
                        >= self._contra_min_rank):
                    w *= max(self.contradiction_boost, 0.0)
            elif same_tree:
                w *= max(self.same_tree_boost, 0.0)
        return w

    def _meta_dict(self, m: TextEntry) -> Dict[str, Any]:
        return {"text_id": m.text_id, "prompt_text": m.prompt_text,
                "prompt_type": m.prompt_type, "segment": m.segment,
                "tree": m.tree, "category": m.category, "bin": m.bin,
                "prompt_bucket": m.prompt_bucket,
                "is_abnormal": _is_abnormal(m),
                "class_weight": float(m.class_weight or 1.0)}


def _dedupe(cands: List[_Candidate]) -> List[_Candidate]:
    seen: Dict[str, _Candidate] = {}
    for c in cands:
        seen.setdefault(c.meta.text_id, c)
    return list(seen.values())


# ------------------------------------------------------------------ #
# catalog construction
# ------------------------------------------------------------------ #

def build_text_catalog(
    texts: Iterable[Dict[str, Any]],
    class_weight: Optional[Dict[ClassKey, float]] = None,
    logit_bias: Optional[Dict[ClassKey, float]] = None,
) -> Dict[str, TextEntry]:
    """Raw dict rows -> TextEntry catalog."""
    class_weight = class_weight or {}
    logit_bias = logit_bias or {}
    catalog: Dict[str, TextEntry] = {}
    for e in texts:
        tid = str(e["text_id"])
        tags = dict(e.get("tags") or {})
        segment = e.get("segment") or tags.get("segment")
        bin_label = e.get("bin") or tags.get("bin")
        stent = e.get("stent") or tags.get("stent") or "n"
        tree = (e.get("tree") or tags.get("tree") or "").lower() or None
        key = (segment, bin_label, stent)
        catalog[tid] = TextEntry(
            text_id=tid, prompt_text=str(e.get("prompt_text", "")),
            prompt_type=e.get("prompt_type"), category=e.get("category"),
            segment=segment, bin=bin_label, tree=tree, stent=stent,
            soft_weight=float(e.get("soft_weight", 1.0)),
            disease_severity=e.get("disease_severity"),
            prompt_bucket=e.get("prompt_bucket"), class_key=key,
            logit_bias=logit_bias.get(key, 0.0),
            class_weight=class_weight.get(key, 1.0),
        )
    return catalog


def compute_class_statistics(
    texts: Iterable[Dict[str, Any]], beta: float = 0.999,
) -> Tuple[Dict[ClassKey, float], Dict[ClassKey, float]]:
    """(effective-number class weights, prior logit biases) keyed by
    (segment, bin, stent) (Cui et al. class-balanced
    effective number (1-beta)/(1-beta^n), bias = log((1-pi)/pi))."""
    counts: Dict[ClassKey, int] = {}
    for e in texts:
        tags = dict(e.get("tags") or {})
        key = (e.get("segment") or tags.get("segment"),
               e.get("bin") or tags.get("bin"),
               e.get("stent") or tags.get("stent") or "n")
        counts[key] = counts.get(key, 0) + 1
    total = max(1, sum(counts.values()))
    cw: Dict[ClassKey, float] = {}
    lb: Dict[ClassKey, float] = {}
    for key, n in counts.items():
        cw[key] = (1 - beta) / (1 - math.pow(beta, n))
        pi = min(max(n / total, 1e-6), 1 - 1e-6)
        lb[key] = math.log((1 - pi) / pi)
    return cw, lb
