"""Train state of the port (the JAX package's ``train/state.TrainState``)
and the partition rules of tensor parallelism over the ``model`` axis.

The JAX package places every parameter by ``nn.get_partition_spec`` of the
``nn.with_partitioning`` specs its ``dense`` layers carry: the kernel of a
column-parallel Dense (``qkv``, ``q``/``k``/``v``, ``query``/``key``/
``value``, ``fc1``, ``intermediate``) is ``(None, "model")``, that of a
row-parallel one (``proj`` of an attention, ``out``, ``fc2``, ``output``)
``("model", None)``; everything else is replicated. ``partition_rule``
reads those specs for the port's names and its ``[out, in]`` weights: a
column-parallel weight is cut along dim 0 (its bias with it), a
row-parallel weight along dim 1 (its bias stays whole and is added once,
after the sum over the model group).

The fused ``qkv`` is cut by head: GSPMD cuts the JAX spec's ``3·dim``
columns contiguously, which is not aligned to heads; the port cuts each of
the q, k and v blocks into ``M`` parts (``blocks`` 3), so rank ``r`` holds
``[q_r | k_r | v_r]``: the heads ``r·H/M .. (r+1)·H/M`` of each, which the
packed kernel reads at ``H/M`` heads. The function is the same.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Mapping, NamedTuple, Optional

import torch


@dataclasses.dataclass
class TrainState:
    """``params`` is the flat training dict (``video_encoder.*``,
    ``text_encoder.*``, ``log_temp``, ``logit_bias``) whose tensors are the
    models' own parameters; a train step updates them, and ``opt_state``,
    in place."""

    step: int
    params: Dict[str, torch.Tensor]
    opt_state: dict
    # scalars tracked across the run (kept in checkpoints)
    best_val_loss: float = float("inf")
    best_epoch: int = -1

    def replace(self, **changes) -> "TrainState":
        return dataclasses.replace(self, **changes)


class Split(NamedTuple):
    """How a tensor is cut over the model axis: along ``dim``, each of its
    ``blocks`` equal blocks of that dim into ``M`` parts (rank ``r`` keeps
    part ``r`` of every block, in block order)."""

    dim: int
    blocks: int = 1


COLUMN = Split(0, 1)
ROW = Split(1, 1)
QKV = Split(0, 3)

_ATTN = r"(?:^|\.)(?:attn|self_attn|cross_attn)\."
_RULES = (
    (re.compile(_ATTN + r"qkv\.(?:weight|bias)$"), QKV),
    (re.compile(_ATTN + r"[qkv]\.(?:weight|bias)$"), COLUMN),
    (re.compile(_ATTN + r"proj\.weight$"), ROW),
    (re.compile(r"(?:^|\.)attention\.(?:query|key|value)\.(?:weight|bias)$"), COLUMN),
    (re.compile(r"(?:^|\.)attention\.out\.weight$"), ROW),
    (re.compile(r"(?:^|\.)mlp\.fc1\.(?:weight|bias)$"), COLUMN),
    (re.compile(r"(?:^|\.)mlp\.fc2\.weight$"), ROW),
    (re.compile(r"(?:^|\.)layer\d+\.intermediate\.(?:weight|bias)$"), COLUMN),
    (re.compile(r"(?:^|\.)layer\d+\.output\.weight$"), ROW),
)


def partition_rule(name: str) -> Optional[Split]:
    """The cut over ``"model"`` of the parameter ``name`` (the port's
    ``.``-joined name, torch layout), or None where the JAX spec
    replicates it."""
    for pattern, split in _RULES:
        if pattern.search(name):
            return split
    return None


def take_shard(t: torch.Tensor, split: Split, n: int, i: int) -> torch.Tensor:
    """Part ``i`` of ``n`` of ``t`` by ``split``, as a tensor of its own."""
    size = t.shape[split.dim] // split.blocks
    part = size // n
    return torch.cat([t.narrow(split.dim, b * size + i * part, part)
                      for b in range(split.blocks)], dim=split.dim).contiguous()


def join_shards(parts: List[torch.Tensor], split: Split) -> torch.Tensor:
    """The inverse of ``take_shard`` over all ``n`` parts, in part order."""
    blocks = [p.chunk(split.blocks, dim=split.dim) for p in parts]
    return torch.cat([b[k] for k in range(split.blocks) for b in blocks], dim=split.dim)


def model_splits(params: Mapping[str, torch.Tensor]) -> Dict[str, Split]:
    """The parameters of ``params`` that this rank holds a part of, with
    their cut (the ``model_split`` that ``models/layers.Dense.shard_``
    leaves on them)."""
    return {k: p.model_split for k, p in params.items()
            if getattr(p, "model_split", None) is not None}
