"""Tokenization of report text: BERT WordPiece from a local vocabulary.

The port's copy of the JAX package's ``data/tokenizer.py``:
``WordPieceTokenizer`` (greedy longest-match-first over a ``vocab.txt``,
BERT uncased id layout, reversible), ``HashTokenizer`` (the deterministic
vocabulary-free fallback) and ``get_tokenizer``, which finds the vocabulary
at ``$DEEPCORO_VOCAB``, else at the repository's ``assets/vocab.txt``
(30522 lines). ``transformers`` is not imported: the JAX package tries the
HuggingFace tokenizer first, from a local cache only, and the port does
not, so the two agree wherever that cache holds no PubMedBERT tokenizer.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence

import numpy as np

PAD_ID = 0
UNK_ID = 100
CLS_ID = 101
SEP_ID = 102
_FIRST_FREE = 999  # ids below this are reserved (BERT [unusedN] + specials)


class HashTokenizer:
    """Deterministic, vocabulary-free tokenizer.

    Lowercases, splits words/numbers/punctuation, maps each token to a stable
    hash bucket in [_FIRST_FREE, vocab_size). Collisions are acceptable for a
    from-scratch-trained text tower; the interface (and id layout for
    PAD/UNK/CLS/SEP) matches BERT so a real WordPiece vocab can drop in.
    """

    def __init__(self, vocab_size: int = 30522, max_length: int = 512):
        if vocab_size <= SEP_ID + 2:
            raise ValueError(f"vocab_size {vocab_size} too small (need > {SEP_ID + 2})")
        self.vocab_size = vocab_size
        self.model_max_length = max_length
        # small test vocabularies: shrink the reserved-id region so hash
        # buckets stay in range
        self.first_free = _FIRST_FREE if vocab_size > 2 * _FIRST_FREE else SEP_ID + 1
        self._splitter = re.compile(r"[a-z]+|\d+|[^\sa-z\d]")

    def _token_id(self, tok: str) -> int:
        h = 2166136261
        for ch in tok.encode():
            h = ((h ^ ch) * 16777619) & 0xFFFFFFFF
        return self.first_free + h % (self.vocab_size - self.first_free)

    def tokenize_ids(self, text: str) -> List[int]:
        toks = self._splitter.findall(str(text).lower())
        return [self._token_id(t) for t in toks]

    def __call__(
        self,
        texts: Sequence[str] | str,
        max_length: Optional[int] = None,
        padding: str = "max_length",
        truncation: bool = True,
        return_tensors: str = "np",
    ) -> Dict[str, np.ndarray]:
        if isinstance(texts, str):
            texts = [texts]
        max_length = max_length or self.model_max_length
        ids = np.full((len(texts), max_length), PAD_ID, np.int32)
        mask = np.zeros((len(texts), max_length), np.int32)
        for i, text in enumerate(texts):
            body = self.tokenize_ids(text)[: max_length - 2]
            seq = [CLS_ID] + body + [SEP_ID]
            ids[i, : len(seq)] = seq
            mask[i, : len(seq)] = 1
        return {"input_ids": ids, "attention_mask": mask}


class WordPieceTokenizer:
    """Real BERT WordPiece from a local ``vocab.txt`` — no network needed.

    Implements the greedy longest-match-first subword algorithm of BERT
    uncased tokenizers (the reference's PubMedBERT tokenizer behavior,
    models/text_encoder.py:8-23) with the same call contract as the HF
    tokenizer/HashTokenizer. Also REVERSIBLE (``decode``), which the hash
    fallback is not — captioning metrics can compare real text.
    """

    def __init__(self, vocab_path: str, max_length: int = 512):
        self.vocab: Dict[str, int] = {}
        with open(vocab_path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                self.vocab[line.rstrip("\n")] = i
        self.inv_vocab = {i: t for t, i in self.vocab.items()}
        self.vocab_size = len(self.vocab)
        self.model_max_length = max_length
        self.pad_id = self.vocab.get("[PAD]", PAD_ID)
        self.unk_id = self.vocab.get("[UNK]", UNK_ID)
        self.cls_id = self.vocab.get("[CLS]", CLS_ID)
        self.sep_id = self.vocab.get("[SEP]", SEP_ID)
        self._splitter = re.compile(r"[a-z]+|\d+|[^\sa-z\d]")

    def _wordpiece(self, word: str) -> List[int]:
        ids: List[int] = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                piece = word[start:end]
                if start > 0:
                    piece = "##" + piece
                if piece in self.vocab:
                    cur = self.vocab[piece]
                    break
                end -= 1
            if cur is None:
                return [self.unk_id]
            ids.append(cur)
            start = end
        return ids

    def tokenize_ids(self, text: str) -> List[int]:
        out: List[int] = []
        for w in self._splitter.findall(str(text).lower()):
            out.extend(self._wordpiece(w))
        return out

    def tokenize(self, text: str) -> List[str]:
        return [self.inv_vocab[i] for i in self.tokenize_ids(text)]

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        special = {self.pad_id, self.cls_id, self.sep_id}
        toks = []
        for i in ids:
            i = int(i)
            if skip_special_tokens and i in special:
                continue
            toks.append(self.inv_vocab.get(i, "[UNK]"))
        words: List[str] = []
        for t in toks:
            if t.startswith("##") and words:
                words[-1] += t[2:]
            else:
                words.append(t)
        return " ".join(words)

    def __call__(
        self,
        texts: Sequence[str] | str,
        max_length: Optional[int] = None,
        padding: str = "max_length",
        truncation: bool = True,
        return_tensors: str = "np",
    ) -> Dict[str, np.ndarray]:
        if isinstance(texts, str):
            texts = [texts]
        max_length = max_length or self.model_max_length
        ids = np.full((len(texts), max_length), self.pad_id, np.int32)
        mask = np.zeros((len(texts), max_length), np.int32)
        for i, text in enumerate(texts):
            body = self.tokenize_ids(text)[: max_length - 2]
            seq = [self.cls_id] + body + [self.sep_id]
            ids[i, : len(seq)] = seq
            mask[i, : len(seq)] = 1
        return {"input_ids": ids, "attention_mask": mask}


def find_local_vocab(
    name: str = "microsoft/BiomedNLP-PubMedBERT-base-uncased-abstract-fulltext",
) -> Optional[str]:
    """A vocab.txt on disk: ``$DEEPCORO_VOCAB``, else the repository's
    ``assets/vocab.txt``. ``name`` is kept for the JAX signature."""
    import os
    from pathlib import Path

    cand = os.environ.get("DEEPCORO_VOCAB")
    if cand and Path(cand).exists():
        return cand
    local = Path(__file__).resolve().parents[2] / "assets" / "vocab.txt"
    if local.exists():
        return str(local)
    return None


def get_tokenizer(
    name: str = "microsoft/BiomedNLP-PubMedBERT-base-uncased-abstract-fulltext",
    vocab_size: int = 30522,
    max_length: int = 512,
):
    """WordPiece from a local vocab.txt when its vocabulary fits the text
    tower's embedding table (``vocab_size``), else the hash fallback."""
    vocab = find_local_vocab(name)
    if vocab:
        try:
            tok = WordPieceTokenizer(vocab, max_length=max_length)
            if tok.vocab_size <= vocab_size:
                return tok
        except Exception:  # pragma: no cover - malformed vocab file
            pass
    return HashTokenizer(vocab_size=vocab_size, max_length=max_length)
