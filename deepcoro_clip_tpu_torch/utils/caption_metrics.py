"""Captioning metrics: BLEU-n, ROUGE-L and METEOR (host-side, pure Python).

The port's copy of the JAX package's ``utils/caption_metrics.py``: corpus
BLEU with uniform n-gram weights and the brevity penalty, ROUGE-L F1 from
the longest common subsequence, and METEOR's exact-match stage, without
nltk or rouge_score.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Dict, List, Sequence


def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1))


def corpus_bleu(
    candidates: List[str], references: List[str], max_n: int = 4
) -> Dict[str, float]:
    """Corpus-level BLEU-1..max_n (uniform weights, standard brevity penalty)."""
    clipped = [0] * max_n
    totals = [0] * max_n
    cand_len = 0
    ref_len = 0
    for cand, ref in zip(candidates, references):
        c = str(cand).lower().split()
        r = str(ref).lower().split()
        cand_len += len(c)
        ref_len += len(r)
        for n in range(1, max_n + 1):
            cg = _ngrams(c, n)
            rg = _ngrams(r, n)
            clipped[n - 1] += sum(min(v, rg[g]) for g, v in cg.items())
            totals[n - 1] += max(sum(cg.values()), 0)
    precisions = [
        clipped[i] / totals[i] if totals[i] else 0.0 for i in range(max_n)
    ]
    bp = 1.0 if cand_len > ref_len else math.exp(1 - ref_len / max(cand_len, 1))
    out = {}
    for n in range(1, max_n + 1):
        ps = precisions[:n]
        if min(ps) > 0:
            geo = math.exp(sum(math.log(p) for p in ps) / n)
        else:
            geo = 0.0
        out[f"bleu{n}"] = bp * geo
    return out


def _lcs_len(a: List[str], b: List[str]) -> int:
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0] * (len(b) + 1)
        for j, y in enumerate(b, 1):
            cur[j] = prev[j - 1] + 1 if x == y else max(prev[j], cur[j - 1])
        prev = cur
    return prev[-1]


def rouge_l(candidates: List[str], references: List[str]) -> float:
    """Mean sentence-level ROUGE-L F1."""
    f1s = []
    for cand, ref in zip(candidates, references):
        c = str(cand).lower().split()
        r = str(ref).lower().split()
        lcs = _lcs_len(c, r)
        if lcs == 0:
            f1s.append(0.0)
            continue
        p = lcs / len(c)
        rec = lcs / len(r)
        f1s.append(2 * p * rec / (p + rec))
    return float(sum(f1s) / max(len(f1s), 1))


def _meteor_align(c: List[str], r: List[str]) -> tuple:
    """Greedy in-order exact alignment (nltk's exact stage): each candidate
    token maps to the leftmost unused identical reference token. Returns
    (matches, chunks) where chunks counts contiguous mapped spans."""
    used = [False] * len(r)
    pairs = []  # (cand_idx, ref_idx)
    for i, tok in enumerate(c):
        for j, rt in enumerate(r):
            if not used[j] and rt == tok:
                used[j] = True
                pairs.append((i, j))
                break
    if not pairs:
        return 0, 0
    chunks = 1
    for (pi, pj), (ci_, cj) in zip(pairs, pairs[1:]):
        if ci_ != pi + 1 or cj != pj + 1:
            chunks += 1
    return len(pairs), chunks


def meteor(candidates: List[str], references: List[str]) -> float:
    """Mean sentence-level METEOR, exact-match stage only (no Porter stems
    or WordNet synonyms, which need nltk and its corpora). Standard
    parameters: harmonic mean F = 10PR/(R+9P), fragmentation penalty
    0.5*(chunks/matches)^3."""
    scores = []
    for cand, ref in zip(candidates, references):
        c = str(cand).lower().split()
        r = str(ref).lower().split()
        if not c or not r:
            scores.append(0.0)
            continue
        m, ch = _meteor_align(c, r)
        if m == 0:
            scores.append(0.0)
            continue
        p, rec = m / len(c), m / len(r)
        fmean = 10 * p * rec / (rec + 9 * p)
        penalty = 0.5 * (ch / m) ** 3
        scores.append(fmean * (1 - penalty))
    return float(sum(scores) / max(len(scores), 1))


def captioning_metrics(candidates: List[str], references: List[str]) -> Dict[str, float]:
    out = corpus_bleu(candidates, references)
    out["rouge_l"] = rouge_l(candidates, references)
    out["meteor"] = meteor(candidates, references)
    return out
