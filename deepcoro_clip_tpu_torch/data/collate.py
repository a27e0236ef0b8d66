"""Collation into fixed-shape numpy batches.

The port's copy of the JAX package's ``data/collate.py``:
``pick_text_bucket``, ``wire_patch``, ``_maybe_patchify``, ``collate_clip``,
``collate_multi_positive``, ``collate_single_head`` and ``collate_mil``.
Videos are stacked with their ``video_mask``; ``collate_clip`` tokenizes
each sample's report to ``max_text_length`` (or to the smallest configured
bucket that fits the batch's longest report), ``collate_multi_positive``
and ``collate_single_head`` the batch's bank of unique texts, padded to
exactly ``max_texts``. With the
patch wire the uint8 videos leave as patch-major ``[B, N, L, K]``
(``data/patch_wire.py``). ``collate_mil`` (linear probing) stacks each
head's targets into a dict and carries the study ids and the view ids.
"""

from __future__ import annotations

import warnings
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from deepcoro_clip_tpu_torch.data.patch_wire import patchify_videos
from deepcoro_clip_tpu_torch.data.single_head_sampler import VideoEntry


def pick_text_bucket(
    texts: List[str], tokenizer, max_text_length: int,
    buckets: Optional[List[int]] = None,
) -> int:
    """Smallest configured bucket that fits the batch's longest report (+2
    special tokens); ``max_text_length`` without buckets."""
    if not buckets:
        return max_text_length
    need = max((len(tokenizer.tokenize_ids(t)) for t in texts), default=0) + 2
    for b in sorted(buckets):
        if b >= need:
            return min(b, max_text_length)
    return max_text_length


def wire_patch(cfg) -> Optional[tuple]:
    """Patch dims for ``collate_clip(..., patch=)`` when the config enables
    the patch-major wire (``patch_wire``, uint8 wire only), else None."""
    if not getattr(cfg, "patch_wire", False):
        return None
    if getattr(cfg, "wire_dtype", "uint8") != "uint8":
        return None
    from deepcoro_clip_tpu_torch.models.video_encoder import resolve_architecture

    return tuple(resolve_architecture(cfg)["vit_patch"])


def _maybe_patchify(videos: np.ndarray,
                    patch: Optional[Sequence[int]]) -> np.ndarray:
    """Host space-to-depth for the patch wire; a float wire keeps the
    spatial layout."""
    if patch is None or videos.dtype != np.uint8:
        return videos
    return patchify_videos(videos, tuple(patch))


def collate_clip(
    items: List[Dict[str, Any]],
    tokenizer,
    max_text_length: int = 512,
    length_buckets: Optional[List[int]] = None,
    patch: Optional[Sequence[int]] = None,
) -> Dict[str, Any]:
    """Stacked videos + the tokenized per-sample report."""
    videos = _maybe_patchify(np.stack([it["videos"] for it in items]), patch)
    mask = np.stack([it["video_mask"] for it in items])
    texts = [it["text"] for it in items]
    enc = tokenizer(
        texts,
        max_length=pick_text_bucket(texts, tokenizer, max_text_length,
                                    length_buckets),
        padding="max_length",
        truncation=True,
        return_tensors="np",
    )
    return {
        "videos": videos,
        "video_mask": mask,
        "input_ids": np.asarray(enc["input_ids"], np.int32),
        "attention_mask": np.asarray(enc["attention_mask"], np.int32),
        "texts": texts,
        "paths": [it["paths"] for it in items],
        "study_ids": [it.get("study_id", "") for it in items],
    }


def collate_multi_positive(
    items: List[Dict[str, Any]],
    tokenizer,
    max_text_length: int = 512,
    max_texts: int = 64,
    patch: Optional[Sequence[int]] = None,
) -> Dict[str, Any]:
    """SigLIP multi-positive mode: the texts of the items' ``positives`` and
    ``negatives`` (lists of ``(text, weight)``), deduplicated in order into
    a bank of at most ``max_texts``, padded with ``""`` to exactly
    ``max_texts`` (``text_valid`` marks the real slots; texts past a full
    bank are dropped and counted). ``positive_mask`` ``[B, M]`` marks each
    item's positives; ``positive_weights`` ``[B, M]`` holds the weight of
    each positive and sampled negative, 1 elsewhere."""
    B = len(items)
    text_to_idx: Dict[str, int] = {}
    bank: List[str] = []
    pos = np.zeros((B, max_texts), np.float32)
    w = np.ones((B, max_texts), np.float32)
    dropped = 0

    def slot(text):
        nonlocal dropped
        j = text_to_idx.get(text)
        if j is None:
            if len(bank) >= max_texts:
                dropped += 1
                return None
            j = text_to_idx[text] = len(bank)
            bank.append(text)
        return j

    for i, it in enumerate(items):
        for text, weight in it.get("positives", []):
            j = slot(text)
            if j is not None:
                pos[i, j] = 1.0
                w[i, j] = np.float32(weight)
        for text, weight in it.get("negatives", []):
            j = slot(text)
            if j is not None:  # a negative: its weight scales the negative term
                w[i, j] = np.float32(weight)

    M = len(bank)
    enc = tokenizer(bank + [""] * (max_texts - M), max_length=max_text_length,
                    padding="max_length", truncation=True, return_tensors="np")
    valid = np.zeros((max_texts,), np.float32)
    valid[:M] = 1.0
    return {
        "videos": _maybe_patchify(np.stack([it["videos"] for it in items]), patch),
        "video_mask": np.stack([it["video_mask"] for it in items]),
        "input_ids": np.asarray(enc["input_ids"], np.int32),
        "attention_mask": np.asarray(enc["attention_mask"], np.int32),
        "positive_mask": pos,
        "positive_weights": w,
        "text_valid": valid,
        "unique_texts": bank,
        "paths": [it.get("paths", []) for it in items],
        "n_dropped_texts": dropped,
    }


def collate_single_head(
    items: List[Dict[str, Any]],
    tokenizer,
    sampler,
    text_by_id: Dict[str, str],
    video_to_positives: Dict[str, List],
    epoch: int = 0,
    phase: str = "train",
    max_text_length: int = 512,
    max_texts: int = 64,
    patch: Optional[Sequence[int]] = None,
) -> Dict[str, Any]:
    """Batch assembly through ``SingleHeadRetrievalSampler``
    (``data/single_head_sampler.py``): the sampler builds the batch's
    deduplicated bank and dense (Y, W) matrices over it, padded here to
    ``max_texts``. The keys are ``collate_multi_positive``'s; the weights
    carry W semantics (``loss_name: siglip_single_head``): W weights every
    sampled pair and 0 excludes one.

    A bank past ``max_texts`` keeps every positive column and cuts
    negatives only (a stable sort on the is-negative key keeps each
    group's order), so that no row loses its positives to an earlier
    video's negatives; it warns when the positives alone overflow.

    The sampler carries round-robin coverage state from call to call, so
    one instance serves a run, called in batch order."""
    entries = [VideoEntry(video_id=str(it["video_id"]),
                          positive_pairs=video_to_positives.get(str(it["video_id"]), []))
               for it in items]
    out_s = sampler.prepare_batch(entries, epoch=epoch, phase=phase)
    B = len(items)
    n_bank = len(out_s.text_ids)
    order = np.arange(n_bank)
    if n_bank > max_texts:
        is_pos = np.asarray(out_s.labels).max(axis=0) > 0
        order = np.argsort(~is_pos, kind="stable")
        if int(is_pos.sum()) > max_texts:
            warnings.warn(
                f"collate_single_head: {int(is_pos.sum())} positive texts "
                f"exceed max_texts={max_texts}; some rows lose positives — "
                "raise max_texts or lower the sampler's positive budget.")
    M = min(n_bank, max_texts)
    sel = order[:M]
    pos = np.zeros((B, max_texts), np.float32)
    w = np.zeros((B, max_texts), np.float32)
    pos[:, :M] = np.asarray(out_s.labels)[:, sel]
    w[:, :M] = np.asarray(out_s.weights)[:, sel]
    bank = [text_by_id[out_s.text_ids[j]] for j in sel]
    enc = tokenizer(bank + [""] * (max_texts - M), max_length=max_text_length,
                    padding="max_length", truncation=True, return_tensors="np")
    valid = np.zeros((max_texts,), np.float32)
    valid[:M] = 1.0
    return {
        "videos": _maybe_patchify(np.stack([it["videos"] for it in items]), patch),
        "video_mask": np.stack([it["video_mask"] for it in items]),
        "input_ids": np.asarray(enc["input_ids"], np.int32),
        "attention_mask": np.asarray(enc["attention_mask"], np.int32),
        "positive_mask": pos,
        "positive_weights": w,
        "text_valid": valid,
        "unique_texts": bank,
        "paths": [it.get("paths", []) for it in items],
        "n_dropped_texts": n_bank - M,
    }


def collate_mil(
    items: List[Dict[str, Any]],
    head_names: Sequence[str],
    patch: Optional[Sequence[int]] = None,
) -> Dict[str, Any]:
    """Linear probing: the stacked videos and masks, ``targets`` (one
    ``[B]`` array a head), the study ids and paths, and ``view_ids`` when
    the items carry them."""
    out: Dict[str, Any] = {
        "videos": _maybe_patchify(np.stack([it["videos"] for it in items]), patch),
        "video_mask": np.stack([it["video_mask"] for it in items]),
        "targets": {h: np.stack([np.asarray(it["targets"][h]) for it in items])
                    for h in head_names},
        "study_ids": [it.get("study_id", "") for it in items],
        "paths": [it["paths"] for it in items],
    }
    if "view_ids" in items[0]:
        out["view_ids"] = np.stack([it["view_ids"] for it in items])
    return out
