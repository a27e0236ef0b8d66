"""Regex extraction of per-artery stenosis findings from report text.

The port's copy of the JAX package's ``utils/stenosis_extractor.py`` (pure
``re`` and dataclasses): maps free-text angiography reports to per-segment
{percent, severity, cto} findings, which feed the multitask pipeline's
stenosis-aware caption weights (``max_severity_weight``) and the LocCa
location mask (``SEGMENT_ALIASES``, ``data/locca.py``).
``REPORT_SEVERITY_WEIGHTS`` is the copy of the JAX package's
``data/siglip.REPORT_SEVERITY_WEIGHTS``.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, List, Optional

# canonical coronary segments and their textual aliases (the reference's
# 18-segment vocabulary, config/linear_probing/.../docker_base_config.yaml)
SEGMENT_ALIASES: Dict[str, List[str]] = {
    "left_main": ["left main", "lm", "lmca"],
    "prox_lad": ["proximal lad", "prox lad", "plad"],
    "mid_lad": ["mid lad", "middle lad"],
    "dist_lad": ["distal lad", "dist lad"],
    "d1": ["first diagonal", "d1", "diagonal 1"],
    "d2": ["second diagonal", "d2", "diagonal 2"],
    "prox_lcx": ["proximal circumflex", "prox lcx", "proximal lcx"],
    "dist_lcx": ["distal circumflex", "dist lcx", "distal lcx"],
    "om1": ["first obtuse marginal", "om1", "marginal 1"],
    "om2": ["second obtuse marginal", "om2", "marginal 2"],
    "prox_rca": ["proximal rca", "prox rca"],
    "mid_rca": ["mid rca", "middle rca"],
    "dist_rca": ["distal rca", "dist rca"],
    "pda": ["posterior descending", "pda"],
    "lvp": ["left posterolateral branch", "left posterolateral",
            "right ventricular posterior", "rvp", "lvp"],
    "posterolateral": ["posterolateral", "plv", "pl branch"],
    "ramus": ["ramus", "intermediate"],
    "lad": ["lad", "left anterior descending"],
    "rca": ["rca", "right coronary"],
    "lcx": ["lcx", "circumflex"],
}

# Reference severity ladder (classify_severity in the reference
# stenosis extractor + BIN_TO_SEVERITY in its dataset_creation): <50 mild,
# 50-69 moderate, 70-89 severe, >=90 critical; ~0 is normal.  70% is the
# clinical "significant stenosis" line the published AUROC is built on, so
# these buckets are the behavioral-parity default.
REFERENCE_SEVERITY_LADDER = [
    (0, "normal"),
    (1, "mild"),
    (50, "moderate"),
    (70, "severe"),
    (90, "critical"),
]

# Optional finer 6-level ladder (kept as an
# opt-in for tooling that wants a "minimal" band; NOT reference parity).
FINE_SEVERITY_LADDER = [
    (0, "normal"),
    (1, "minimal"),
    (25, "mild"),
    (50, "moderate"),
    (70, "severe"),
    (99, "critical"),
]

SEVERITY_BY_PERCENT = REFERENCE_SEVERITY_LADDER

# per-report loss weight of each severity (the worst finding counts)
REPORT_SEVERITY_WEIGHTS: Dict[str, float] = {
    "normal": 1.0,
    "minimal": 1.5,
    "mild": 2.0,
    "moderate": 4.0,
    "severe": 8.0,
    "critical": 10.0,
    "cto": 10.0,
}

SEVERITY_KEYWORDS = {
    "normal": 0.0,
    "minimal": 10.0,
    "mild": 30.0,
    "moderate": 55.0,
    "severe": 80.0,
    "critical": 95.0,
    "subtotal": 95.0,
    "occluded": 100.0,
    "occlusion": 100.0,
}

# decimals included ("~70.0%", reference _normalize_numeric_tokens handles
# "80. 0 %" spacing — the \s* groups below cover the same inputs)
_PCT = re.compile(
    r"(\d{1,3}(?:\s*\.\s*\d+)?)\s*(?:-\s*(\d{1,3}(?:\s*\.\s*\d+)?)\s*)?%"
)


def _pct_value(tok: str) -> float:
    return float(tok.replace(" ", ""))
_CTO = re.compile(r"\b(cto|chronic total occlusion|total(?:ly)? occlu\w*)\b")
# nouns that make a clause a stenotic finding (gates the severity-keyword
# -> percent fallback; calcification/tortuosity adjectives must not count)
_DISEASE_NOUN = re.compile(
    r"\b(stenosis|stenotic|restenosis|lesion|narrowing|blocked|occlu\w*"
    r"|disease)\b")


@dataclass
class SegmentFinding:
    segment: str
    percent: Optional[float] = None
    severity: str = "normal"
    cto: bool = False


def percent_to_severity(pct: float, ladder=None) -> str:
    """Severity bucket for a stenosis percentage (reference buckets by
    default; pass ``ladder=FINE_SEVERITY_LADDER`` for the 6-level variant)."""
    sev = "normal"
    for threshold, name in (ladder or SEVERITY_BY_PERCENT):
        if pct >= threshold:
            sev = name
    return sev


def classify_severity(percentage: float) -> str:
    """Name-for-name parity with the reference's ``classify_severity``
    (reference: utils/stenosis_extractor.py): returns 'none' (not 'normal')
    below 1%."""
    sev = percent_to_severity(percentage, REFERENCE_SEVERITY_LADDER)
    return "none" if sev == "normal" else sev


class StenosisExtractor:
    def __init__(self):
        # longest-alias-first so "proximal lad" wins over "lad"
        pats = []
        for seg, aliases in SEGMENT_ALIASES.items():
            for a in sorted(aliases, key=len, reverse=True):
                pats.append((re.compile(rf"\b{re.escape(a)}\b"), seg, len(a)))
        self._patterns = sorted(pats, key=lambda t: -t[2])

    def extract(self, text: str) -> Dict[str, SegmentFinding]:
        """Split the report into clauses; attribute percents/severities/CTO to
        the segments mentioned in each clause."""
        text = str(text).lower()
        # numeric-token normalization (reference _normalize_numeric_tokens):
        # "80. 0" -> "80.0", "80.0 %" -> "80.0%"
        text = re.sub(r"(\d+)\s*\.\s*(\d+)", r"\1.\2", text)
        text = re.sub(r"(\d)\s*%", r"\1%", text)
        findings: Dict[str, SegmentFinding] = {}
        # a period between digits is a decimal point ("70.0%"), not a
        # clause boundary
        for clause in re.split(r";|\n|\.(?!\d)", text):
            if not clause.strip():
                continue
            matched: List[str] = []
            covered: List[tuple] = []
            for pat, seg, _ in self._patterns:
                for m in pat.finditer(clause):
                    span = (m.start(), m.end())
                    if any(s < span[1] and span[0] < e for s, e in covered):
                        continue  # inside a longer alias match
                    covered.append(span)
                    if seg not in matched:
                        matched.append(seg)
            if not matched:
                continue

            pct: Optional[float] = None
            m = _PCT.search(clause)
            if m:
                lo = _pct_value(m.group(1))
                hi = _pct_value(m.group(2)) if m.group(2) else lo
                pct = (lo + hi) / 2.0
            cto = bool(_CTO.search(clause))
            severity_kw = next(
                (k for k in SEVERITY_KEYWORDS if k in clause), None
            )
            if pct is None and severity_kw is not None:
                # a severity ADJECTIVE only becomes a percent when the clause
                # actually describes a stenotic finding — "moderate
                # calcifications in the mid lad" must not fabricate a 55%
                # lesion (the reference's patterns all require the literal
                # word "stenosis"; utils/stenosis_extractor.py:146-168).
                # normal/occlusion terms are standalone findings themselves.
                standalone = severity_kw in (
                    "normal", "occluded", "occlusion", "subtotal")
                if standalone or _DISEASE_NOUN.search(clause):
                    pct = SEVERITY_KEYWORDS[severity_kw]
            if cto and pct is None:
                pct = 100.0

            for seg in matched:
                f = findings.get(seg) or SegmentFinding(segment=seg)
                if pct is not None and (f.percent is None or pct > f.percent):
                    f.percent = pct
                    # severity always derives from the percent (reference
                    # StenosisInfo.severity = classify_severity(percentage))
                    # — a keyword like "moderate calcifications" in the same
                    # clause must not relabel a 70% lesion
                    f.severity = percent_to_severity(pct)
                f.cto = f.cto or cto
                findings[seg] = f
        return findings

    def max_severity_weight(
        self, text: str, weights: Optional[Dict[str, float]] = None
    ) -> float:
        """Scalar loss weight for a report = max per-segment severity weight
        (the multitask stenosis-aware weighting,
        utils/loss/multitask_loss.py:165-230)."""
        weights = weights or REPORT_SEVERITY_WEIGHTS
        w = 1.0
        for f in self.extract(text).values():
            sev = "cto" if f.cto else f.severity
            w = max(w, weights.get(sev, 1.0))
        return w


# reference artery order (get_stenosis_feature_vector,
# utils/stenosis_extractor.py:380-386)
DEFAULT_ARTERY_ORDER: List[str] = [
    "left_main", "prox_lad", "mid_lad", "dist_lad", "d1", "d2",
    "prox_lcx", "dist_lcx", "om1", "om2", "ramus", "lvp",
    "prox_rca", "mid_rca", "dist_rca", "pda", "posterolateral",
]


def stenosis_feature_vector(
    report: str,
    artery_order: Optional[List[str]] = None,
    extractor: Optional[StenosisExtractor] = None,
) -> "np.ndarray":
    """Fixed-length per-artery stenosis-percent vector (reference
    get_stenosis_feature_vector, utils/stenosis_extractor.py:363-400).
    Unparseable reports yield all zeros — appropriate for early-training
    generated text."""
    import numpy as np

    order = artery_order or DEFAULT_ARTERY_ORDER
    vec = np.zeros(len(order), np.float32)
    try:
        findings = (extractor or StenosisExtractor()).extract(report)
    except Exception:
        return vec
    for i, seg in enumerate(order):
        f = findings.get(seg)
        if f is not None and f.percent is not None:
            vec[i] = f.percent
    return vec
