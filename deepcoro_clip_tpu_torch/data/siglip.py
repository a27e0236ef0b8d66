"""SigLIP multi-positive resources and dataset.

The port's copy of the JAX package's ``data/siglip.py`` on the port's
``csv_utils`` (no pandas):

- ``SiglipResources`` reads ``texts.csv`` (text_id, text, and optional
  tree, segment, disease_severity, bin, category, stent, prompt_bucket,
  soft_weight columns) and ``edges.csv`` (video_id -> text_id positive
  pairs with a weight column);
- a positive's weight is its edge weight times a severity scale, with the
  floors of ``pair_weight``;
- a video's positives are pruned (one text a tree and segment, the most
  severe, then most specific) and picked round-robin by epoch or at random
  up to ``max_positive_per_video``;
- negatives come same segment, then same tree, then the rest, each tier
  shuffled (a boosted tier of contradicting normal texts first);
- ``make_single_head_sampler`` builds the batch-level
  ``SingleHeadRetrievalSampler`` over the texts' catalog, with
  class-balance statistics computed from the catalog itself;
- ``SiglipVideoDataset`` adds a per-item pack of ``positives`` and
  ``negatives`` to ``VideoClipDataset``'s items, drawn from a numpy
  generator seeded ``(crc32(video_id), epoch)`` as in the JAX package, and
  ``abnormal_labels`` for the class-aware sampler.
"""

from __future__ import annotations

import collections
import random
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from deepcoro_clip_tpu_torch.data.csv_utils import read_csv_with_fallback
from deepcoro_clip_tpu_torch.data.datasets import VideoClipDataset
from deepcoro_clip_tpu_torch.data.single_head_sampler import (
    SingleHeadRetrievalSampler,
    build_text_catalog,
    compute_class_statistics,
)

# the default ladder of severity weights; a config's
# siglip_positive_severity_weights replaces it
DEFAULT_SEVERITY_WEIGHTS: Dict[str, float] = {
    "normal": 0.75,
    "mild": 1.25,
    "moderate": 1.75,
    "severe": 2.5,
    "critical": 2.5,
    "cto": 2.5,
}
ABNORMAL_SEVERITIES = {"moderate", "severe", "critical", "cto"}
_ABNORMAL_CATEGORIES = {"stenosis", "in_stent", "thrombus", "calcification",
                        "cto", "medina"}


class SiglipResources:
    def __init__(
        self,
        texts_path: str,
        edges_path: str,
        text_id_column: str = "text_id",
        text_column: str = "text",
        video_id_column: str = "video_id",
        edge_weight_column: str = "weight",
        severity_weights: Optional[Dict[str, float]] = None,
        enable_severity_weighting: bool = True,
    ):
        texts = read_csv_with_fallback(texts_path)
        if text_column not in texts.columns:
            for cand in ("prompt_text", "prompt", "sentence"):
                if cand in texts.columns:
                    text_column = cand
                    break
        missing = {text_id_column, text_column} - set(texts.columns)
        if missing:
            raise ValueError(f"texts.csv missing columns: {sorted(missing)}")

        self.severity_weights = dict(
            severity_weights or DEFAULT_SEVERITY_WEIGHTS
        )
        self.enable_severity_weighting = enable_severity_weighting

        self.text_by_id: Dict[str, str] = {}
        self.meta_by_id: Dict[str, Dict[str, Optional[str]]] = {}
        self.texts_by_segment: Dict[str, List[str]] = collections.defaultdict(list)
        self.texts_by_tree: Dict[str, List[str]] = collections.defaultdict(list)
        self.all_text_ids: List[str] = []
        for row in texts.rows:
            tid = str(row[text_id_column])
            self.text_by_id[tid] = str(row[text_column])
            tree = self._norm(row.get("tree"))
            segment = self._norm(row.get("segment"))
            severity = self._norm(row.get("disease_severity"))
            try:
                soft_w = float(row.get("soft_weight", 1.0))
            except (TypeError, ValueError):  # an empty cell too
                soft_w = 1.0
            self.meta_by_id[tid] = {
                "tree": tree, "segment": segment, "severity": severity,
                # optional specificity columns (reference TextMetadata,
                # utils/siglip/single_head_sampler.py:35-52)
                "bin": self._norm(row.get("bin")),
                "category": self._norm(row.get("category")),
                "stent": self._norm(row.get("stent")),
                "prompt_bucket": self._norm(row.get("prompt_bucket")),
                "soft_weight": soft_w if np.isfinite(soft_w) else 1.0,
            }
            self.all_text_ids.append(tid)
            if segment:
                self.texts_by_segment[segment].append(tid)
            if tree:
                self.texts_by_tree[tree].append(tid)

        edges = read_csv_with_fallback(edges_path)
        missing_e = {video_id_column, text_id_column} - set(edges.columns)
        if missing_e:
            raise ValueError(f"edges.csv missing columns: {sorted(missing_e)}")
        self.video_to_positives: Dict[str, List[Tuple[str, float]]] = (
            collections.defaultdict(list)
        )
        for row in edges.rows:
            vid = str(row[video_id_column])
            tid = str(row[text_id_column])
            if tid not in self.text_by_id:
                continue
            w = float(row.get(edge_weight_column, 1.0) or 1.0)
            self.video_to_positives[vid].append((tid, w))

    def make_single_head_sampler(self, config=None, seed: int = 0
                                 ) -> SingleHeadRetrievalSampler:
        """The batch-level ``SingleHeadRetrievalSampler`` over this catalog,
        drawing from ``random.Random(seed)``; a config's ``siglip_*``
        settings set its quotas and weights."""
        raw = []
        for tid in self.all_text_ids:
            m = self.meta_by_id[tid]
            raw.append({
                "text_id": tid,
                "prompt_text": self.text_by_id[tid],
                "category": m.get("category"),
                "segment": m.get("segment"),
                "bin": m.get("bin"),
                "tree": m.get("tree"),
                "stent": m.get("stent"),
                "soft_weight": m.get("soft_weight", 1.0),
                "disease_severity": m.get("severity"),
                "prompt_bucket": m.get("prompt_bucket"),
            })
        cw, lb = compute_class_statistics(raw)
        kw = {}
        if config is not None:
            kw = dict(
                max_negatives=config.siglip_negatives_per_video,
                base_negative_weight=config.siglip_base_negative_weight,
                round_robin=config.siglip_round_robin_sampling,
                min_pos_weight=config.siglip_min_pos_weight,
                positive_severity_weights=config.siglip_positive_severity_weights,
                contradiction_boost=config.siglip_contradiction_boost or 1.0,
                contradiction_min_severity=config.siglip_contradiction_min_severity,
            )
        return SingleHeadRetrievalSampler(build_text_catalog(raw, cw, lb),
                                          rng=random.Random(seed), **kw)

    @staticmethod
    def _norm(v) -> Optional[str]:
        if isinstance(v, str) and v.strip():
            return v.strip().lower()
        return None

    # ------------------------------------------------------------------ #

    @staticmethod
    def _meta_is_abnormal(meta: Dict) -> bool:
        """reference _is_abnormal (dataloaders/siglip_support.py:581-592)."""
        if (meta.get("category") or "").lower() in _ABNORMAL_CATEGORIES:
            return True
        if (meta.get("prompt_bucket") or "").lower() == "abnormal":
            return True
        return (meta.get("severity") or "").lower() not in {"", "normal"}

    def pair_weight(self, text_id: str, edge_weight: float) -> float:
        """soft_weight x edge_weight x severity scale, with the reference's
        floors — abnormal prompts never down-weighted, normal clamped to
        [0.5, 1.0], mild>=1.0, moderate>=1.5, severe>=2.0 (reference
        _compute_positive_weight, dataloaders/siglip_support.py:592-629)."""
        try:
            edge = float(edge_weight or 1.0)
        except (TypeError, ValueError):
            edge = 1.0
        if not self.enable_severity_weighting:
            return edge
        meta = self.meta_by_id.get(text_id)
        if meta is None:
            return edge
        label = self._severity_label(meta)
        scale = self.severity_weights.get(label, 1.0)
        if self._meta_is_abnormal(meta):
            scale = max(scale, 1.0)
        else:
            scale = min(scale, self.severity_weights.get("mild", scale))
        combined = float(meta.get("soft_weight") or 1.0) * edge * scale
        if label == "normal":
            combined = min(max(combined, 0.5), 1.0)
        elif label == "mild":
            combined = max(combined, 1.0)
        elif label == "moderate":
            combined = max(combined, 1.5)
        elif label == "severe":
            combined = max(combined, 2.0)
        return float(max(combined, 1e-6))

    _SEVERITY_RANK = {"critical": 0, "cto": 0, "severe": 0,
                      "moderate": 1, "mild": 2, "normal": 3}

    # ------------------------------------------------------------------ #
    # positive-pair filtering (reference filter_positive_pairs,
    # dataloaders/siglip_support.py:510-556)
    # ------------------------------------------------------------------ #

    @staticmethod
    def _severity_label(meta: Dict) -> str:
        """Normalized severity label with bin/category fallbacks
        (reference _severity_label, siglip_support.py:558-580)."""
        sev = (meta.get("severity") or "").strip().lower()
        if sev in {"critical", "cto"}:
            return "severe"
        if sev in {"normal", "mild", "moderate", "severe"}:
            return sev
        b = (meta.get("bin") or "").strip().lower()
        if b in {"0", "<30"}:
            return "normal"
        if b == "30-49":
            return "mild"
        if b == "50-69":
            return "moderate"
        if b in {"70-89", ">=90", "100", "cto"}:
            return "severe"
        cat = (meta.get("category") or "").lower()
        if cat == "normal":
            return "normal"
        if cat in {"stenosis", "in_stent", "medina", "thrombus",
                   "calcification", "cto"}:
            return "severe"
        return "unknown"

    @staticmethod
    def _severity_order(label: str) -> int:
        """Higher = more severe (reference _severity_rank)."""
        return {"normal": 0, "mild": 1, "moderate": 2, "severe": 3}.get(
            (label or "").lower(), -1
        )

    @staticmethod
    def _specificity_score(meta: Dict) -> int:
        """More anatomy/finding detail = higher (reference
        _specificity_score, siglip_support.py:631-641)."""
        score = 0
        if meta.get("segment"):
            score += 3
        if meta.get("bin"):
            score += 2
        if (meta.get("category") or "").lower() not in ("", "normal"):
            score += 1
        if (meta.get("stent") or "").lower() not in ("", "n", "no"):
            score += 1
        return score

    def filter_positive_pairs(
        self,
        pairs: List[Tuple[str, float]],
        tree_hint: Optional[str] = None,
        max_segments: Optional[int] = None,
    ) -> List[Tuple[str, float]]:
        """Prune contradictory or overly generic positives for a video:
        drop off-tree texts, keep ONE text per (tree, segment) — the most
        severe then most specific — prefer segmented texts when everything
        is non-diseased, and cap at ``max_segments`` by (severity,
        specificity, weight). Reference siglip_support.py:510-556."""
        if not pairs:
            return []
        tree_hint = self._norm(tree_hint)
        items = []
        for tid, w in pairs:
            meta = self.meta_by_id.get(tid)
            if meta is None:
                continue
            if tree_hint and meta.get("tree") and meta["tree"] != tree_hint:
                continue
            items.append((tid, meta, float(w)))
        if not items:
            return []

        def rank(i):
            tid, meta, w = items[i]
            return (self._severity_order(self._severity_label(meta)),
                    self._specificity_score(meta), -i)

        groups: Dict[Tuple[str, str], List[int]] = {}
        for i, (tid, meta, _) in enumerate(items):
            key = (meta.get("tree") or "", meta.get("segment") or "")
            groups.setdefault(key, []).append(i)
        keep = {max(idxs, key=rank) for idxs in groups.values()}

        labels = [self._severity_label(m) for _, m, _ in items]
        if all(self._severity_order(l) <= 0 for l in labels):
            segmented = {i for i in keep if items[i][1].get("segment")}
            if segmented:
                keep = segmented

        kept = [items[i] for i in sorted(keep)]
        if max_segments and max_segments > 0 and len(kept) > max_segments:
            kept = sorted(
                kept,
                key=lambda it: (
                    self._severity_order(self._severity_label(it[1])),
                    self._specificity_score(it[1]),
                    it[2],
                ),
                reverse=True,
            )[:max_segments]
        return [(tid, w) for tid, _, w in kept]

    def build_report_from_positives(
        self,
        video_id: str,
        separator: str = " ",
        order_by_severity: bool = True,
    ) -> str:
        """Concatenated report from a video's positive texts — the LocCa
        generation target (reference siglip_support.py:815-860: severe
        findings first, then by segment; 'No findings.' when empty)."""
        pairs = self.video_to_positives.get(str(video_id), [])
        if not pairs:
            return "No findings."
        entries = []
        for tid, _ in pairs:
            meta = self.meta_by_id.get(tid, {})
            rank = self._SEVERITY_RANK.get(meta.get("severity") or "normal", 3)
            entries.append((rank, meta.get("segment") or "",
                            self.text_by_id.get(tid, str(tid))))
        if order_by_severity:
            entries.sort(key=lambda e: (e[0], e[1]))
        return separator.join(e[2] for e in entries)

    def video_is_abnormal(self, video_id: str) -> bool:
        for tid, _ in self.video_to_positives.get(str(video_id), []):
            sev = self.meta_by_id.get(tid, {}).get("severity")
            if sev in ABNORMAL_SEVERITIES:
                return True
        return False

    def sample_positives(
        self,
        video_id: str,
        k: int,
        round_robin: bool = True,
        epoch: int = 0,
        rng: Optional[np.random.Generator] = None,
        tree_hint: Optional[str] = None,
        filter_pairs: bool = True,
        max_segments: Optional[int] = None,
    ) -> List[Tuple[str, float]]:
        """Returns [(text, weight)] up to k pairs (reference :546-595),
        after severity/specificity positive filtering (reference :510)."""
        pairs = self.video_to_positives.get(str(video_id), [])
        if filter_pairs:
            filtered = self.filter_positive_pairs(
                pairs, tree_hint=tree_hint, max_segments=max_segments
            )
            if filtered:
                pairs = filtered
        if not pairs:
            return []
        if len(pairs) <= k:
            chosen = pairs
        elif round_robin:
            off = (epoch * k) % len(pairs)
            chosen = [pairs[(off + i) % len(pairs)] for i in range(k)]
        else:
            rng = rng or np.random.default_rng(0)
            idx = rng.choice(len(pairs), k, replace=False)
            chosen = [pairs[i] for i in idx]
        return [
            (self.text_by_id[tid], self.pair_weight(tid, w)) for tid, w in chosen
        ]

    def sample_negatives(
        self,
        video_id: str,
        k: int,
        rng: Optional[np.random.Generator] = None,
        contradiction_boost: float = 0.0,
        contradiction_min_severity: str = "moderate",
    ) -> List[Tuple[str, float]]:
        """Negative pool: same-segment -> same-tree -> global, excluding the
        video's positives (reference build_negative_candidates:724).

        ``contradiction_boost`` > 0 implements the reference's contradiction
        weighting (utils/siglip/single_head_sampler.py:770-780): a NORMAL
        text for a segment whose positive is >= ``contradiction_min_severity``
        is a direct contradiction — it is sampled first and its negative
        loss weight is multiplied by the boost.
        """
        if k <= 0:
            return []
        rng = rng or np.random.default_rng(0)
        pos_ids = {tid for tid, _ in self.video_to_positives.get(str(video_id), [])}
        seg_severity: Dict[str, int] = {}
        for t in pos_ids:
            meta = self.meta_by_id.get(t, {})
            seg = meta.get("segment")
            if seg:
                seg_severity[seg] = max(
                    seg_severity.get(seg, -1),
                    self._severity_order(self._severity_label(meta)),
                )
        segs = set(seg_severity)
        trees = {
            self.meta_by_id[t].get("tree") for t in pos_ids
        } - {None}
        min_rank = self._severity_order(contradiction_min_severity)

        # priority tiers, shuffled within each tier (priority order preserved
        # across tiers, matching the reference's bucketed assembly :724);
        # contradictions form their own top tier when boosted
        seen = set(pos_ids)
        contradictions: List[str] = []
        tiers: List[List[str]] = [[], [], []]
        for s in segs:
            for t in self.texts_by_segment.get(s, []):
                if t in seen:
                    continue
                seen.add(t)
                meta = self.meta_by_id[t]
                is_contra = (
                    contradiction_boost > 0.0
                    and self._severity_label(meta) == "normal"
                    and seg_severity.get(s, -1) >= min_rank >= 0
                )
                (contradictions if is_contra else tiers[0]).append(t)
        for tr in trees:
            for t in self.texts_by_tree.get(tr, []):
                if t not in seen:
                    seen.add(t)
                    tiers[1].append(t)
        for t in self.all_text_ids:
            if t not in seen:
                seen.add(t)
                tiers[2].append(t)
        pool: List[Tuple[str, float]] = []
        rng.shuffle(contradictions)
        pool.extend((t, max(contradiction_boost, 1.0)) for t in contradictions)
        for tier in tiers:
            tier = list(tier)
            rng.shuffle(tier)
            pool.extend((t, 1.0) for t in tier)
        return [(self.text_by_id[t], w) for t, w in pool[:k]]



class SiglipVideoDataset(VideoClipDataset):
    """VideoClipDataset + per-item multi-positive/negative text packs."""

    def __init__(
        self,
        *args,
        siglip: SiglipResources,
        video_id_column: str = "video_id",
        max_positive_per_video: int = 8,
        negatives_per_video: int = 0,
        round_robin: bool = True,
        max_segments_per_video: Optional[int] = None,
        contradiction_boost: float = 0.0,
        contradiction_min_severity: str = "moderate",
        tree_column: str = "tree",
        **kwargs,
    ):
        super().__init__(*args, **kwargs)
        self.siglip = siglip
        self.video_id_column = video_id_column
        self.max_pos = max_positive_per_video
        self.n_neg = negatives_per_video
        self.round_robin = round_robin
        self.max_segments = max_segments_per_video
        self.contradiction_boost = contradiction_boost
        self.contradiction_min_severity = contradiction_min_severity
        self.tree_column = tree_column
        # samples without a positive are dropped
        self.samples = [s for s in self.samples
                        if self.siglip.video_to_positives.get(self._vid_of(s))]

    def _row_of(self, sample) -> dict:
        return self.rows[sample["row_indices"][0]]

    def _vid_of(self, sample) -> str:
        row = self._row_of(sample)
        if self.video_id_column in row:
            return str(row[self.video_id_column])
        return str(row["__path"])

    def abnormal_labels(self) -> np.ndarray:
        """Per-sample abnormality for the class-aware sampler."""
        return np.array([int(self.siglip.video_is_abnormal(self._vid_of(s)))
                         for s in self.samples])

    def get(self, i: int, load: bool = True):
        out = super().get(i, load)
        sample = self.samples[i]
        vid = self._vid_of(sample)
        # crc32, not hash(): a str hash is salted per interpreter
        rng = np.random.default_rng((zlib.crc32(vid.encode()), self.epoch))
        row = self._row_of(sample)
        tree_hint = str(row[self.tree_column]) if self.tree_column in row else None
        out["positives"] = self.siglip.sample_positives(
            vid, self.max_pos, round_robin=self.round_robin, epoch=self.epoch, rng=rng,
            tree_hint=tree_hint, max_segments=self.max_segments)
        out["negatives"] = self.siglip.sample_negatives(
            vid, self.n_neg, rng=rng, contradiction_boost=self.contradiction_boost,
            contradiction_min_severity=self.contradiction_min_severity)
        out["video_id"] = vid
        # the LocCa generation target of the JAX module
        out["locca_report"] = self.siglip.build_report_from_positives(vid)
        return out
