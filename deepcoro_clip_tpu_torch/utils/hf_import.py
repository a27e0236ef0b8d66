"""Import HuggingFace BERT (PubMedBERT) weights into the port's ``TextEncoder``.

The port's counterpart of the JAX package's ``utils/hf_import.py``. The
reference wraps HF PubMedBERT (pooler stripped); ``models/text_encoder.py``
is the same post-LN BERT-base architecture, so a checkpoint maps name for
name:

HF name                                          -> port parameter
embeddings.word_embeddings.weight                -> word_embeddings.weight
embeddings.position_embeddings.weight            -> position_embeddings
embeddings.LayerNorm.{weight,bias}               -> embeddings_norm.{weight,bias}
encoder.layer.N.attention.self.query.*           -> layerN.attention.query.*
encoder.layer.N.attention.self.{key,value}.*     -> layerN.attention.{key,value}.*
encoder.layer.N.attention.output.dense.*         -> layerN.attention.out.*
encoder.layer.N.attention.output.LayerNorm.*     -> layerN.attention_norm.*
encoder.layer.N.intermediate.dense.*             -> layerN.intermediate.*
encoder.layer.N.output.dense.*                   -> layerN.output.*
encoder.layer.N.output.LayerNorm.*               -> layerN.output_norm.*

The names may carry a ``bert.`` prefix. A linear weight keeps torch's
``[out, in]`` layout, the port's own (the JAX version transposes into
flax's ``[in, out]``). HF adds ``token_type_embeddings[0]`` to every
position (the reference never uses segment B), so that row is folded into
the position table. The pooler is dropped, as the reference strips it.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return torch.from_numpy(np.array(x, dtype=np.float32))


def bert_state_dict_to_port(sd: Mapping[str, Any], depth: int = 12) -> Dict[str, torch.Tensor]:
    """A BERT state dict (``BertModel``'s, optionally ``bert.``-prefixed;
    tensors or numpy arrays) -> the port ``TextEncoder``'s parameters, fp32,
    everything except the projection head (new, it keeps its init)."""

    def get(name):
        for prefix in ("", "bert."):
            key = prefix + name
            if key in sd:
                return _t(sd[key])
        raise KeyError(name)

    out: Dict[str, torch.Tensor] = {}
    pos = get("embeddings.position_embeddings.weight")
    try:
        pos = pos + get("embeddings.token_type_embeddings.weight")[0][None, :]
    except KeyError:
        pass
    out["word_embeddings.weight"] = get("embeddings.word_embeddings.weight")
    out["position_embeddings"] = pos
    out["embeddings_norm.weight"] = get("embeddings.LayerNorm.weight")
    out["embeddings_norm.bias"] = get("embeddings.LayerNorm.bias")
    for i in range(depth):
        b = f"encoder.layer.{i}"
        for dst, src in (("attention.query", "attention.self.query"),
                         ("attention.key", "attention.self.key"),
                         ("attention.value", "attention.self.value"),
                         ("attention.out", "attention.output.dense"),
                         ("attention_norm", "attention.output.LayerNorm"),
                         ("intermediate", "intermediate.dense"),
                         ("output", "output.dense"),
                         ("output_norm", "output.LayerNorm")):
            for leaf in ("weight", "bias"):
                out[f"layer{i}.{dst}.{leaf}"] = get(f"{b}.{src}.{leaf}")
    return out


def load_pubmedbert_into(state: Mapping[str, torch.Tensor], checkpoint_path: str,
                         depth: int = 12) -> Dict[str, torch.Tensor]:
    """A local torch BERT checkpoint merged into a text tower's state dict
    (``TextEncoder.state_dict()``): the imported entries replace the BERT
    body's, the projection head's stay."""
    sd = torch.load(checkpoint_path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    merged = dict(state)
    merged.update(bert_state_dict_to_port(sd, depth=depth))
    return merged
