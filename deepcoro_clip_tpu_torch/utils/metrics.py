"""Classification and regression metrics with bootstrap confidence intervals.

The port's copy of the JAX package's ``utils/metrics.py`` (numpy, off the
hot path): MAE / MSE / RMSE / Pearson r for regression; AUROC (average rank
on ties), AUPRC, the best-F1 threshold and the confusion counts for binary
heads; accuracy, macro AUROC and macro F1 for multiclass heads; a
percentile bootstrap whose generator is ``default_rng(seed)`` drawn anew on
every call, so that equal predictions give equal intervals bit for bit; and
``compute_head_metrics``, the dispatch on a head's task, with the reference
configs' ``*_classification`` names as aliases.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np


def regression_metrics(preds: np.ndarray, targets: np.ndarray) -> Dict[str, float]:
    p = np.asarray(preds, np.float64).reshape(-1)
    t = np.asarray(targets, np.float64).reshape(-1)
    err = p - t
    out = {
        "mae": float(np.mean(np.abs(err))),
        "mse": float(np.mean(err**2)),
        "rmse": float(np.sqrt(np.mean(err**2))),
    }
    if len(p) > 1 and p.std() > 1e-12 and t.std() > 1e-12:
        out["pearson_r"] = float(np.corrcoef(p, t)[0, 1])
    else:
        out["pearson_r"] = 0.0
    return out


def _roc_auc(scores: np.ndarray, labels: np.ndarray) -> float:
    """Rank-based AUROC (ties handled by average rank)."""
    pos = labels > 0
    n_pos = int(pos.sum())
    n_neg = len(labels) - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty(len(scores), np.float64)
    sorted_scores = scores[order]
    i = 0
    r = 1
    while i < len(scores):
        j = i
        while j + 1 < len(scores) and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        avg = (r + r + (j - i)) / 2.0
        ranks[order[i : j + 1]] = avg
        r += j - i + 1
        i = j + 1
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def _auprc(scores: np.ndarray, labels: np.ndarray) -> float:
    """Average precision (area under PR curve, step interpolation)."""
    pos = labels > 0
    if pos.sum() == 0:
        return float("nan")
    order = np.argsort(-scores, kind="mergesort")
    tp = np.cumsum(pos[order])
    precision = tp / np.arange(1, len(scores) + 1)
    return float(np.sum(precision * pos[order]) / pos.sum())


def binary_metrics(
    logits: np.ndarray, targets: np.ndarray, threshold: Optional[float] = None
) -> Dict[str, float]:
    s = np.asarray(logits, np.float64).reshape(-1)
    t = (np.asarray(targets).reshape(-1) > 0.5).astype(int)
    probs = 1.0 / (1.0 + np.exp(-s))
    out = {"auc": _roc_auc(probs, t), "auprc": _auprc(probs, t)}
    if threshold is None:
        # the threshold of the best F1 over the distinct probabilities
        cand = np.unique(probs)
        if len(cand) > 200:
            cand = np.quantile(cand, np.linspace(0, 1, 200))
        best_f1, best_thr = -1.0, 0.5
        for thr in cand:
            pred = probs >= thr
            tp = int((pred & (t == 1)).sum())
            fp = int((pred & (t == 0)).sum())
            fn = int((~pred & (t == 1)).sum())
            f1 = 2 * tp / max(2 * tp + fp + fn, 1)
            if f1 > best_f1:
                best_f1, best_thr = f1, float(thr)
        threshold = best_thr
        out["best_f1"] = best_f1
    pred = (probs >= threshold).astype(int)
    tp = int(((pred == 1) & (t == 1)).sum())
    tn = int(((pred == 0) & (t == 0)).sum())
    fp = int(((pred == 1) & (t == 0)).sum())
    fn = int(((pred == 0) & (t == 1)).sum())
    out.update(
        threshold=float(threshold),
        accuracy=(tp + tn) / max(len(t), 1),
        sensitivity=tp / max(tp + fn, 1),
        specificity=tn / max(tn + fp, 1),
        ppv=tp / max(tp + fp, 1),
        npv=tn / max(tn + fn, 1),
        confusion={"tp": tp, "tn": tn, "fp": fp, "fn": fn},
    )
    return out


def multiclass_metrics(logits: np.ndarray, targets: np.ndarray) -> Dict[str, float]:
    p = np.asarray(logits, np.float64)
    t = np.asarray(targets).astype(int).reshape(-1)
    pred = p.argmax(axis=-1)
    out = {"accuracy": float(np.mean(pred == t))}
    n_classes = p.shape[-1]
    aucs = []
    f1s = []
    for c in range(n_classes):
        bin_t = (t == c).astype(int)
        if bin_t.sum() and bin_t.sum() < len(bin_t):
            aucs.append(_roc_auc(p[:, c], bin_t))
        tp = int(((pred == c) & (t == c)).sum())
        fp = int(((pred == c) & (t != c)).sum())
        fn = int(((pred != c) & (t == c)).sum())
        f1s.append(2 * tp / max(2 * tp + fp + fn, 1))
    out["auc_macro"] = float(np.mean(aucs)) if aucs else float("nan")
    out["f1_macro"] = float(np.mean(f1s))
    return out


def bootstrap_ci(
    metric_fn: Callable[[np.ndarray, np.ndarray], float],
    preds: np.ndarray,
    targets: np.ndarray,
    n_bootstrap: int = 1000,
    confidence: float = 0.95,
    seed: int = 42,
) -> Tuple[float, float, float]:
    """(point, lo, hi): the metric, and the percentile interval over
    ``n_bootstrap`` resamples (a resample whose metric raises or is not
    finite is left out)."""
    preds = np.asarray(preds)
    targets = np.asarray(targets)
    point = metric_fn(preds, targets)
    rng = np.random.default_rng(seed)
    n = len(preds)
    vals = []
    for _ in range(n_bootstrap):
        idx = rng.integers(0, n, n)
        try:
            v = metric_fn(preds[idx], targets[idx])
        except Exception:
            continue
        if np.isfinite(v):
            vals.append(v)
    if not vals:
        return point, float("nan"), float("nan")
    alpha = (1 - confidence) / 2
    lo, hi = np.quantile(vals, [alpha, 1 - alpha])
    return float(point), float(lo), float(hi)


# head_task as config/linear_probing/**/*.yaml spells it
# (binary_classification, multiclass_classification); the code uses the
# short forms
_TASK_ALIASES = {
    "binary_classification": "binary",
    "multiclass_classification": "multiclass",
    "multi_class_classification": "multiclass",
}


def normalize_head_task(task: str) -> str:
    return _TASK_ALIASES.get(task, task)


def compute_head_metrics(
    preds: np.ndarray,
    targets: np.ndarray,
    task: str,
    with_ci: bool = False,
    n_bootstrap: int = 1000,
    confidence: float = 0.95,
) -> Dict[str, object]:
    """The metrics of one head's task; with ``with_ci`` also the bootstrap
    interval of its key metric (``mae``, ``auc`` or ``accuracy``) under
    ``<key>_ci``."""
    task = normalize_head_task(task)
    if task == "regression":
        out = regression_metrics(preds, targets)
        key = "mae"
        fn = lambda p, t: regression_metrics(p, t)["mae"]
    elif task == "binary":
        out = binary_metrics(preds, targets)
        key = "auc"
        fn = lambda p, t: binary_metrics(p, t)["auc"]
    elif task == "multiclass":
        out = multiclass_metrics(preds, targets)
        key = "accuracy"
        fn = lambda p, t: multiclass_metrics(p, t)["accuracy"]
    else:
        raise ValueError(f"unknown head task {task!r}")
    if with_ci:
        point, lo, hi = bootstrap_ci(
            fn, preds, targets, n_bootstrap=n_bootstrap, confidence=confidence
        )
        out[f"{key}_ci"] = {"point": point, "lo": lo, "hi": hi}
    return out
