"""Retrieval metrics: Recall@k, MRR, MedianRank, MAP, NDCG, alignment.

The port's copy of the JAX package's ``utils/retrieval_metrics.py``
(numpy): the ground truth is multi-label (after text dedup every video
whose report equals text j counts text j as relevant), and every metric is
computed on the host from the similarity matrix.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def gt_matrix_from_text_ids(text_ids: Sequence[int], n_texts: int) -> np.ndarray:
    """[N videos] text index -> bool relevance matrix [N, M]."""
    ids = np.asarray(text_ids)
    gt = np.zeros((len(ids), n_texts), bool)
    gt[np.arange(len(ids)), ids] = True
    return gt


def _ranks_of_relevant(sim: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """Rank (1-based) of the best-ranked relevant text per video."""
    order = np.argsort(-sim, axis=1)  # descending
    gt_sorted = np.take_along_axis(gt, order, axis=1)
    first_hit = gt_sorted.argmax(axis=1)  # first True position
    has_hit = gt_sorted.any(axis=1)
    ranks = np.where(has_hit, first_hit + 1, sim.shape[1] + 1)
    return ranks


def compute_recall_at_k(
    sim: np.ndarray, gt: np.ndarray, ks: Sequence[int]
) -> Dict[str, float]:
    ranks = _ranks_of_relevant(sim, gt)
    return {f"Recall@{k}": float(np.mean(ranks <= k)) for k in ks}


def compute_mrr(sim: np.ndarray, gt: np.ndarray) -> float:
    ranks = _ranks_of_relevant(sim, gt)
    return float(np.mean(1.0 / ranks))


def compute_median_rank(sim: np.ndarray, gt: np.ndarray) -> float:
    return float(np.median(_ranks_of_relevant(sim, gt)))


def compute_map(sim: np.ndarray, gt: np.ndarray) -> float:
    """Mean average precision over all relevant texts per video."""
    order = np.argsort(-sim, axis=1)
    gt_sorted = np.take_along_axis(gt, order, axis=1).astype(np.float64)
    cum_hits = np.cumsum(gt_sorted, axis=1)
    ranks = np.arange(1, sim.shape[1] + 1)[None, :]
    precision_at_hit = (cum_hits / ranks) * gt_sorted
    n_rel = np.maximum(gt_sorted.sum(axis=1), 1.0)
    ap = precision_at_hit.sum(axis=1) / n_rel
    return float(np.mean(ap))


def compute_ndcg_at_k(sim: np.ndarray, gt: np.ndarray, k: int) -> float:
    order = np.argsort(-sim, axis=1)[:, :k]
    gt_sorted = np.take_along_axis(gt, order, axis=1).astype(np.float64)
    discounts = 1.0 / np.log2(np.arange(2, k + 2))
    dcg = (gt_sorted * discounts[None, :]).sum(axis=1)
    n_rel = np.minimum(gt.sum(axis=1), k).astype(int)
    ideal = np.array([discounts[:n].sum() if n > 0 else 1.0 for n in n_rel])
    return float(np.mean(dcg / np.maximum(ideal, 1e-12)))


def compute_alignment_score(v_emb: np.ndarray, t_emb: np.ndarray) -> float:
    """Mean cosine similarity of matched (video, text) pairs (reference :174)."""
    v = v_emb / np.maximum(np.linalg.norm(v_emb, axis=1, keepdims=True), 1e-8)
    t = t_emb / np.maximum(np.linalg.norm(t_emb, axis=1, keepdims=True), 1e-8)
    n = min(len(v), len(t))
    return float(np.mean(np.sum(v[:n] * t[:n], axis=1)))


def compute_embedding_norms(v_emb: np.ndarray, t_emb: np.ndarray) -> Dict[str, float]:
    return {
        "video_norm": float(np.mean(np.linalg.norm(v_emb, axis=1))),
        "text_norm": float(np.mean(np.linalg.norm(t_emb, axis=1))),
    }


def compute_retrieval_metrics(
    sim: np.ndarray,
    gt: np.ndarray,
    recall_k: Sequence[int] = (1, 5, 10, 50),
    ndcg_k: Sequence[int] = (5,),
    prefix: str = "",
) -> Dict[str, float]:
    """The full epoch-end retrieval panel (reference runner :982-999)."""
    ks = [k for k in recall_k if k <= sim.shape[1]]
    out = compute_recall_at_k(sim, gt, ks)
    out["MRR"] = compute_mrr(sim, gt)
    out["MedianRank"] = compute_median_rank(sim, gt)
    out["MAP"] = compute_map(sim, gt)
    for k in ndcg_k:
        if k <= sim.shape[1]:
            out[f"NDCG@{k}"] = compute_ndcg_at_k(sim, gt, k)
    if prefix:
        out = {f"{prefix}{k}": v for k, v in out.items()}
    return out
