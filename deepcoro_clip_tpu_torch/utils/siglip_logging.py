"""Per-sample SigLIP debug dumps.

The port's copy of the JAX package's ``utils/siglip_logging.py``: for the
batches the ``siglip_debug_*`` settings gate (off by default), each
sampled video's positive and hardest negative logits against the batch's
bank of unique texts, its positive-negative margin, and the step's loss,
temperature, bias and gradient norms, one JSON line a batch under
``{run dir}/siglip_debug/``. The logits are recomputed on the host from
the eval step's embeddings (a ``[B, D] x [M, D]`` numpy product).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np


def siglip_logits(
    video_emb: np.ndarray,
    text_emb: np.ndarray,
    log_temp: float,
    logit_bias: float = 0.0,
    logit_clamp: float = 30.0,
) -> np.ndarray:
    """[B,M] pairwise logits exactly as the loss sees them
    (losses/contrastive.py: sim / temp + bias, clamped)."""
    v = video_emb / np.maximum(
        np.linalg.norm(video_emb, axis=-1, keepdims=True), 1e-8
    )
    t = text_emb / np.maximum(
        np.linalg.norm(text_emb, axis=-1, keepdims=True), 1e-8
    )
    temp = max(float(np.exp(log_temp)), 1e-6)
    logits = (v @ t.T) / temp + float(logit_bias)
    return np.clip(logits, -logit_clamp, logit_clamp)


def build_debug_records(
    paths: Sequence[str],
    unique_texts: Sequence[str],
    positive_mask: np.ndarray,
    logits: np.ndarray,
    positive_weights: Optional[np.ndarray] = None,
    sample_count: int = 4,
    top_k_negatives: int = 5,
    max_text_chars: int = 160,
) -> List[Dict]:
    """Per-sample records for the first ``sample_count`` videos of a batch."""
    records: List[Dict] = []
    pos = np.asarray(positive_mask, bool)
    n = min(sample_count, logits.shape[0], len(paths))
    m = min(len(unique_texts), logits.shape[1])
    for i in range(n):
        row = logits[i, :m]
        prow = pos[i, :m]
        pos_idx = np.flatnonzero(prow)
        neg_idx = np.flatnonzero(~prow)
        neg_sorted = neg_idx[np.argsort(row[neg_idx])[::-1]][:top_k_negatives]
        rec = {
            "path": str(paths[i]),
            "positives": [
                {
                    "text": unique_texts[j][:max_text_chars],
                    "logit": round(float(row[j]), 4),
                    **(
                        {"weight": round(float(positive_weights[i, j]), 4)}
                        if positive_weights is not None
                        else {}
                    ),
                }
                for j in pos_idx
            ],
            "top_negatives": [
                {
                    "text": unique_texts[j][:max_text_chars],
                    "logit": round(float(row[j]), 4),
                }
                for j in neg_sorted
            ],
        }
        if pos_idx.size and neg_idx.size:
            rec["margin"] = round(
                float(row[pos_idx].min() - row[neg_sorted].max()), 4
            )
        if pos_idx.size:
            rec["mean_pos_logit"] = round(float(row[pos_idx].mean()), 4)
        if neg_idx.size:
            rec["mean_neg_logit"] = round(float(row[neg_idx].mean()), 4)
        records.append(rec)
    return records


class SiglipDebugLogger:
    """Writes ``siglip_debug/epoch_{e}.jsonl`` under the run directory.

    One JSON line per dumped batch: a header (epoch/step/loss/temperature/
    bias/grad norms — the reference's per-batch grad dump role) plus the
    per-sample records."""

    def __init__(self, output_dir: str | Path, enabled: bool = True):
        self.dir = Path(output_dir) / "siglip_debug"
        self.enabled = enabled

    def log_batch(
        self,
        epoch: int,
        step: int,
        records: List[Dict],
        header: Optional[Dict] = None,
    ) -> Optional[Path]:
        if not self.enabled:
            return None
        self.dir.mkdir(parents=True, exist_ok=True)
        path = self.dir / f"epoch_{epoch:04d}.jsonl"
        entry = {
            "epoch": int(epoch),
            "step": int(step),
            **{k: _scalar(v) for k, v in (header or {}).items()},
            "samples": records,
        }
        with path.open("a") as f:
            f.write(json.dumps(entry) + "\n")
        return path


def _scalar(v):
    try:
        return round(float(v), 6)
    except (TypeError, ValueError):
        return str(v)
