"""Reference (torch) checkpoint -> the port's state dicts.

The port's counterpart of the JAX package's ``utils/torch_import.py``. The
reference saves monolithic ``torch.save`` dicts keyed by component
(``video_encoder`` / ``text_encoder`` / ``linear_probing`` /
``captioning_decoder`` ...). Every component except the mVIT video
backbone is weight-isomorphic to the port's modules, so a reference user
carries over:

- the whole text tower (BERT body and projection head);
- the video projection head, the attention pool and the
  ``EnhancedVideoAggregator``;
- the MIL / linear-probing heads (gated attention, view embeddings);
- the captioning decoder.

Each converter returns the state dict of the port's module (names as its
``state_dict()``, fp32 tensors, a linear weight in torch's own ``[out, in]``
layout). The mVIT backbone (under ``model.``) has no mapping: the port's
video tower is CoroViT; it is reported as skipped and counted, as is the
``WithCLS`` attention pool (a documented divergence) and the optimizer,
scheduler and scaler state. Scalar metadata passes through the report.

The converters take ``{name: tensor or array}``; ``numpy_state_dict`` is
the JAX module's helper, kept for callers that hold numpy arrays.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from deepcoro_clip_tpu_torch.utils.hf_import import bert_state_dict_to_port

__all__ = [
    "numpy_state_dict",
    "load_torch_checkpoint",
    "save_converted",
    "load_converted",
    "linear_to_port",
    "layernorm_to_port",
    "mha_to_port",
    "attention_pool_to_port",
    "aggregator_to_port",
    "mil_to_port",
    "captioning_decoder_to_port",
    "text_encoder_to_port",
    "video_encoder_partial_to_port",
    "convert_reference_checkpoint",
]

StateDict = Dict[str, torch.Tensor]


def numpy_state_dict(sd: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """A state dict of tensors -> plain numpy arrays."""
    return {k: v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)
            for k, v in sd.items()}


def load_torch_checkpoint(path: str) -> Dict[str, Any]:
    """``torch.load`` a reference checkpoint onto the CPU. It holds pickled
    Python objects beside the tensors, so only files of a trusted source."""
    return torch.load(path, map_location="cpu", weights_only=False)


def save_converted(states: Mapping[str, StateDict], path: str) -> None:
    """The converted components (``{component: state dict}``) in one
    ``torch.save`` file."""
    torch.save({c: {k: v.detach().cpu().contiguous() for k, v in sd.items()}
                for c, sd in states.items()}, path)


def load_converted(path: str) -> Dict[str, StateDict]:
    return torch.load(path, map_location="cpu", weights_only=True)


def _f32(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _sub(sd: Mapping[str, Any], prefix: str) -> Dict[str, Any]:
    """The entries under ``prefix``, without it."""
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def _under(prefix: str, sd: Mapping[str, torch.Tensor]) -> StateDict:
    return {f"{prefix}.{k}": v for k, v in sd.items()}


def _depth(sd: Mapping[str, Any], pattern: str) -> int:
    return 1 + max((int(m.group(1)) for k in sd if (m := re.search(pattern, k))),
                   default=-1)


def linear_to_port(sd: Mapping[str, Any], prefix: str) -> StateDict:
    """A torch ``Linear``'s ``weight`` (``[out, in]``, as the port's
    ``Dense``) and ``bias``."""
    out = {"weight": _f32(sd[f"{prefix}.weight"])}
    if f"{prefix}.bias" in sd:
        out["bias"] = _f32(sd[f"{prefix}.bias"])
    return out


def layernorm_to_port(sd: Mapping[str, Any], prefix: str) -> StateDict:
    return {"weight": _f32(sd[f"{prefix}.weight"]), "bias": _f32(sd[f"{prefix}.bias"])}


def mha_to_port(sd: Mapping[str, Any], prefix: str, fused: bool) -> StateDict:
    """torch ``nn.MultiheadAttention`` -> the port's ``layers.Attention``:
    ``fused`` the self-attention layer (one ``qkv`` projection, torch's
    ``in_proj_weight`` ``[3D, D]`` as it is), else the cross-attention
    layer (``q``/``k``/``v``, the row blocks of ``in_proj``)."""
    w = _f32(sd[f"{prefix}.in_proj_weight"])
    b = sd.get(f"{prefix}.in_proj_bias")
    out = _under("proj", linear_to_port(sd, f"{prefix}.out_proj"))
    if fused:
        out["qkv.weight"] = w
        if b is not None:
            out["qkv.bias"] = _f32(b)
        return out
    for name, wi in zip("qkv", w.chunk(3, dim=0)):
        out[f"{name}.weight"] = wi.contiguous()
    if b is not None:
        for name, bi in zip("qkv", _f32(b).chunk(3, dim=0)):
            out[f"{name}.bias"] = bi.contiguous()
    return out


def attention_pool_to_port(sd: Mapping[str, Any]) -> StateDict:
    """Reference ``AttentionPool`` -> the port's ``models.attention_pool.AttentionPool``."""
    out = {"query": _f32(sd["query"])}
    out.update(_under("attn", mha_to_port(sd, "attn", fused=False)))
    out.update(_under("norm", layernorm_to_port(sd, "norm")))
    if "proj.weight" in sd:  # output_dim != embed_dim (else nn.Identity)
        out.update(_under("out_proj", linear_to_port(sd, "proj")))
    return out


def aggregator_to_port(sd: Mapping[str, Any]) -> StateDict:
    """Reference ``EnhancedVideoAggregator`` -> the port's
    ``models.video_aggregator.EnhancedVideoAggregator``. The port scales the
    learned-query score by 1/sqrt(D) where the reference takes the bare dot
    product, so the query is multiplied by sqrt(D): an exact
    reparameterization."""
    query = sd["attn_query"]
    d = query.shape[-1]
    out = {"pos_embedding": _f32(sd["pos_encoding"]),
           "query": torch.from_numpy(np.asarray(_f32(query).numpy()[0, 0]
                                                * np.sqrt(float(d)), np.float32))}
    out.update(_under("norm", layernorm_to_port(sd, "final_ln")))
    for i in range(_depth(sd, r"^blocks\.(\d+)\.")):
        p, q = f"blocks.{i}", f"block{i}"
        out.update(_under(f"{q}.norm1", layernorm_to_port(sd, f"{p}.norm1")))
        out.update(_under(f"{q}.norm2", layernorm_to_port(sd, f"{p}.norm2")))
        out.update(_under(f"{q}.attn", mha_to_port(sd, f"{p}.attn", fused=True)))
        out.update(_under(f"{q}.mlp.fc1", linear_to_port(sd, f"{p}.mlp.0")))
        out.update(_under(f"{q}.mlp.fc2", linear_to_port(sd, f"{p}.mlp.3")))
    return out


def mil_to_port(sd: Mapping[str, Any], gated_scope: str = "shared") -> StateDict:
    """Reference ``MultiInstanceLinearProbing`` -> the port's
    ``models.mil.MultiInstanceLinearProbing``. The reference shares one
    ``attention_V/U/w`` across both hierarchy levels: load into a head built
    with ``separate_video_attention=False`` (the ``shared`` scope)."""
    heads = sorted({m.group(1) for k in sd
                    if (m := re.match(r"heads\.([^.]+)\.weight$", k))})
    out: StateDict = {}
    for h in heads:
        out.update(_under(f"head_{h}", linear_to_port(sd, f"heads.{h}")))
    if "attention_V.weight" in sd:
        for name in "VUw":
            out.update(_under(f"{gated_scope}_gated.{name}",
                              linear_to_port(sd, f"attention_{name}")))
    if "view_embedding.weight" in sd:
        out["view_embeddings.weight"] = _f32(sd["view_embedding.weight"])
    return out


def captioning_decoder_to_port(sd: Mapping[str, Any]) -> StateDict:
    """Reference ``CaptioningDecoder`` -> the port's
    ``models.captioning_decoder.CaptioningDecoder``. Two exact
    reparameterizations: the reference cross-attends to the video features
    directly (the port's ``memory_proj`` is set to the identity), and its
    ``lm_head`` has no bias (zeros here)."""
    d = sd["token_embeddings.weight"].shape[1]
    vocab = sd["lm_head.weight"].shape[0]
    out = {"token_emb.weight": _f32(sd["token_embeddings.weight"]),
           "pos_emb": _f32(sd["position_embeddings.weight"]),
           "lm_head.weight": _f32(sd["lm_head.weight"]),
           "lm_head.bias": torch.zeros(vocab, dtype=torch.float32),
           "memory_proj.weight": torch.eye(d, dtype=torch.float32),
           "memory_proj.bias": torch.zeros(d, dtype=torch.float32)}
    out.update(_under("embed_norm", layernorm_to_port(sd, "embedding_layer_norm")))
    out.update(_under("norm", layernorm_to_port(sd, "final_layer_norm")))
    for i in range(_depth(sd, r"^decoder_layers\.(\d+)\.")):
        p, q = f"decoder_layers.{i}", f"layer{i}"
        for dst, src in (("norm1", "self_attention_layer_norm"),
                         ("norm2", "cross_attention_layer_norm"),
                         ("norm3", "feed_forward_layer_norm")):
            out.update(_under(f"{q}.{dst}", layernorm_to_port(sd, f"{p}.{src}")))
        out.update(_under(f"{q}.self_attn", mha_to_port(sd, f"{p}.self_attention", True)))
        out.update(_under(f"{q}.cross_attn",
                          mha_to_port(sd, f"{p}.cross_attention", False)))
        out.update(_under(f"{q}.mlp.fc1", linear_to_port(sd, f"{p}.intermediate")))
        out.update(_under(f"{q}.mlp.fc2", linear_to_port(sd, f"{p}.output")))
    return out


def text_encoder_to_port(sd: Mapping[str, Any]) -> StateDict:
    """Reference ``TextEncoder`` (BERT and the Dropout/Linear/GELU/Dropout
    projection) -> the port's ``models.text_encoder.TextEncoder``."""
    out = bert_state_dict_to_port(sd, depth=_depth(sd, r"encoder\.layer\.(\d+)\."))
    if "proj.1.weight" in sd:
        out.update(_under("proj.proj", linear_to_port(sd, "proj.1")))
    return out


def video_encoder_partial_to_port(sd: Mapping[str, Any]) -> Tuple[StateDict, Dict[str, int]]:
    """The convertible parts of a reference ``VideoEncoder`` state dict, under
    the port's ``VideoEncoder`` names (``proj.proj``, ``aggregator``,
    ``pool``); returns ``(state, skipped)``, ``skipped`` counting the tensors
    with no mapping (the mVIT backbone under ``model.``)."""
    out: StateDict = {}
    if "proj.1.weight" in sd:
        out.update(_under("proj.proj", linear_to_port(sd, "proj.1")))
    agg = _sub(sd, "aggregator.")
    if agg:
        out.update(_under("aggregator", aggregator_to_port(agg)))
    pool = _sub(sd, "attention_pool.")
    if pool and "query" in pool:  # AttentionPool (not the WithCLS variant)
        out.update(_under("pool", attention_pool_to_port(pool)))
    skipped = {
        "model (mVIT backbone — no CoroViT mapping)": sum(
            1 for k in sd if k.startswith("model.")),
        "attention_pool (WithCLS variant — documented divergence)": (
            0 if (not pool or "query" in pool) else len(pool)),
    }
    return out, {k: v for k, v in skipped.items() if v}


def convert_reference_checkpoint(ckpt: Mapping[str, Any]
                                 ) -> Tuple[Dict[str, StateDict], Dict[str, Any]]:
    """A whole reference checkpoint dict -> ``(component state dicts,
    report)``. Handles the component keys the reference runners save:
    ``text_encoder``, ``video_encoder`` (partial: the mVIT backbone is
    skipped), ``linear_probing``, ``captioning_decoder``; scalar metadata
    (epoch, best metrics) passes through under ``report["meta"]``."""
    states: Dict[str, StateDict] = {}
    report: Dict[str, Any] = {"converted": [], "skipped": {}, "meta": {}}
    for key, val in ckpt.items():
        if not isinstance(val, Mapping) or not val:
            if isinstance(val, (int, float, str, bool)):
                report["meta"][key] = val
            continue
        if key == "text_encoder":
            states[key] = text_encoder_to_port(val)
            report["converted"].append(key)
        elif key == "video_encoder":
            state, skipped = video_encoder_partial_to_port(val)
            if state:
                states[key] = state
                report["converted"].append(f"{key} (partial)")
            report["skipped"].update({f"{key}.{k}": n for k, n in skipped.items()})
        elif key == "linear_probing":
            states[key] = mil_to_port(val)
            report["converted"].append(key)
        elif key == "captioning_decoder":
            states[key] = captioning_decoder_to_port(val)
            report["converted"].append(key)
        elif key in ("optimizer", "scheduler", "scaler"):
            report["skipped"][key] = len(val)  # GPU-runtime state, not weights
        else:
            report["skipped"][f"{key} (no mapping)"] = len(val)
    return states, report
