"""LocCa (location-aware captioning) batch helpers.

The port's copy of the JAX package's ``data/locca.py`` (numpy and ``re``).
The LocCa tasks split decoder targets into LOCATION tokens (anatomical
segment words, stenosis percents) and description tokens; the mask is built
from the report text with the stenosis extractor's segment vocabulary, so
the three LocCa losses (``losses/locca.py``) train end to end.
"""

from __future__ import annotations

import re
from typing import Sequence

import numpy as np

from deepcoro_clip_tpu_torch.utils.stenosis_extractor import SEGMENT_ALIASES

# every word that can appear inside a segment alias, plus percent digits
LOCATION_WORDS = frozenset(
    w
    for aliases in SEGMENT_ALIASES.values()
    for alias in aliases
    for w in alias.split()
)

_WORD_SPLIT = re.compile(r"[a-z]+|\d+|[^\sa-z\d]")


def _is_location_word(word: str) -> bool:
    return word in LOCATION_WORDS or word.isdigit() or word == "%"


def location_token_mask(
    texts: Sequence[str],
    tokenizer,
    max_length: int,
) -> np.ndarray:
    """[B, max_length] float mask: 1 where the token belongs to a location
    word (segment name / percent / '%'), aligned with the tokenizer's
    [CLS] body [SEP] layout.

    Works with the hash tokenizer (1 token per word) and any HF tokenizer
    exposing per-word subtoken counts via ``tokenize``.
    """
    out = np.zeros((len(texts), max_length), np.float32)
    for i, text in enumerate(texts):
        words = _WORD_SPLIT.findall(str(text).lower())
        pos = 1  # skip [CLS]
        for w in words:
            if hasattr(tokenizer, "tokenize_ids"):
                n_sub = len(tokenizer.tokenize_ids(w))
            else:  # HF tokenizer
                n_sub = max(1, len(tokenizer.tokenize(w)))
            if _is_location_word(w):
                out[i, pos : min(pos + n_sub, max_length)] = 1.0
            pos += n_sub
            if pos >= max_length - 1:  # room for [SEP]
                break
    return out


def locca_caption_batch(
    texts: Sequence[str],
    tokenizer,
    max_length: int,
) -> dict:
    """Tokenized decoder targets + attention + location mask for LocCa."""
    enc = tokenizer(
        list(texts),
        max_length=max_length,
        padding="max_length",
        truncation=True,
        return_tensors="np",
    )
    return {
        "caption_ids": np.asarray(enc["input_ids"], np.int32),
        "caption_mask": np.asarray(enc["attention_mask"], np.int32),
        "location_mask": location_token_mask(texts, tokenizer, max_length),
    }
