"""Weight bridge between JAX parameter trees and the port's modules, both ways.

The JAX tree comes as nested dicts of numpy arrays (``flax`` is not
needed): ``backbone/{patch_embed/conv/{kernel,bias}, cls, block{i}/...,
pool{s}/..., norm}``, ``proj/proj/...``, ``aggregator/{pos_embedding,
query, block{i}/..., norm}``. The port's modules carry the same names, so
a path maps onto a state-dict key by joining with ``.``, with two renames:

- a dense ``kernel`` ``[in, out]`` becomes the transposed ``weight``
  ``[out, in]`` of a ``Linear``;
- a LayerNorm ``scale`` becomes ``weight``;
- an ``nn.Embed`` ``embedding`` becomes the ``weight`` of an ``Embedding``.

The patch ``kernel`` ``[pt, ph, pw, C, dim]`` stays a raw parameter. The
``TextEncoder`` tree (``word_embeddings/embedding``, ``position_embeddings``,
``embeddings_norm``, ``layer{i}/{attention/{query,key,value,out},
attention_norm, intermediate, output, output_norm}``, ``proj/proj``) maps
the same way. ``module_to_jax_tree`` goes back, and
``load_training_tree``/``training_tree`` carry the whole training tree
``{"video_encoder", "text_encoder", "log_temp", "logit_bias"}`` (and
``locca_decoder`` with the LocCa head: ``token_emb/embedding``,
``coord_emb``, ``layer{i}/{norm1, self_attn/{qkv,proj}, norm2,
cross_attn/{q,k,v,proj}, norm3, mlp/{fc1,fc2}}``, ``norm``, ``lm_head``)
into the port's models and scalars and back. The linear-probing tree
``{"video_encoder", "mil"}`` maps by the same rules
(``load_probe_tree``/``probe_tree``): the encoder's ``pool/{query,
attn/{q,k,v,proj}, norm}`` (``AttentionPool``), the head's
``{within,across,shared}_gated/{V,U,w}``, ``*_cls/{cls, block{i}/..., norm}``,
``hier_proj``, ``view_embeddings/embedding`` and ``head_<name>``. The
multitask tree ``{"video_encoder", "text_encoder", "decoder", "mvm",
"log_temp"}`` goes both ways through ``load_multitask_tree`` /
``multitask_tree``: the decoder's ``token_emb/embedding``, ``pos_emb``,
``embed_norm``, ``memory_proj``, ``layer{i}/{norm1, self_attn/{qkv,proj},
norm2, cross_attn/{q,k,v,proj}, norm3, mlp/{fc1,fc2}}``, ``norm``,
``lm_head``, and the MVM head's ``enc_proj``, ``mask_token``, ``pos_emb``,
``block{i}/...``, ``norm``, ``pred``. A CLIP
run's video tree goes into a probing encoder, where paths and shapes match,
through ``train/linear_probe.build_probe_bundle(encoder_params=...)``;
``state_dict_to_jax_tree`` renames a port checkpoint's parameters into
such a tree by a model's layer types.

Under tensor parallelism (``models/layers.shard_layers``) a rank's models
hold their parts of the cut leaves: the ``load_*`` functions take a whole
tree and load each rank's part, and ``module_to_jax_tree`` and the
``*_tree`` functions gather the parts over the model group (collective:
every rank of the group calls them) and return the whole tree.
``shard_tree`` cuts a whole tree into one rank's state dict by the
partition rules of ``train/state.py``, and ``gather_state_dicts`` joins the
ranks' state dicts back into the whole one, both without a process group.

``save_params_npz``/``load_params_npz`` store such a tree in one ``.npz``
with ``/``-joined keys, which is what ``serve.py --params`` reads. To
write one from a JAX checkpoint where JAX is installed::

    import flax.linen as nn, jax, numpy as np
    from deepcoro_clip_tpu_torch.convert import save_params_npz
    # video_params: state.params["video_encoder"] of a CLIP checkpoint
    tree = jax.tree_util.tree_map(np.asarray, nn.unbox(video_params))
    save_params_npz(tree, "video_params.npz")
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from deepcoro_clip_tpu_torch.parallel.distributed import gather_shard, grid
from deepcoro_clip_tpu_torch.parallel.mesh import MODEL_AXIS
from deepcoro_clip_tpu_torch.train.state import (
    join_shards,
    model_splits,
    partition_rule,
    take_shard,
)


def flatten_tree(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested mapping -> {"a/b/c": array}."""
    out = {}
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, Mapping):
            out.update(flatten_tree(val, path))
        else:
            out[path] = np.asarray(val)
    return out


def unflatten_tree(flat: Mapping[str, np.ndarray]) -> dict:
    """{"a/b/c": array} -> nested dict."""
    tree: dict = {}
    for path, val in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = np.asarray(val)
    return tree


def jax_tree_to_state_dict(tree: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``VideoEncoder``, ``TextEncoder`` or
    ``MultiInstanceLinearProbing`` params (nested dict, optionally under a
    ``"params"`` key) -> the state dict (fp32) of the port's module of the
    same name."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    sd = {}
    for path, arr in flatten_tree(tree).items():
        *mods, name = path.split("/")
        if name == "kernel" and arr.ndim == 2:
            name, arr = "weight", arr.T
        elif name == "scale":
            name = "weight"
        elif name == "embedding":
            name = "weight"
        sd[".".join(mods + [name])] = torch.tensor(np.asarray(arr, np.float32))
    return sd


def state_dict_to_jax_tree(state_dict: Mapping[str, torch.Tensor], module: nn.Module) -> dict:
    """Parameters named as ``module``'s (a flat ``{name: tensor}``, such as
    the ``video_encoder.*`` entries of a port checkpoint without their
    prefix) -> the JAX parameter tree, each leaf renamed by the type of the
    layer of ``module`` that holds it; names ``module`` lacks are left out."""
    flat = {}
    for mod_name, mod in module.named_modules():
        for name, _ in mod.named_parameters(recurse=False):
            key = f"{mod_name}.{name}" if mod_name else name
            if key not in state_dict:
                continue
            arr = state_dict[key].detach().cpu().numpy().astype(np.float32)
            if name == "weight" and isinstance(mod, nn.Linear):
                name, arr = "kernel", arr.T
            elif name == "weight" and isinstance(mod, nn.LayerNorm):
                name = "scale"
            elif name == "weight" and isinstance(mod, nn.Embedding):
                name = "embedding"
            flat["/".join(mod_name.split(".") + [name]) if mod_name else name] = arr.copy()
    return unflatten_tree(flat)


def module_to_jax_tree(module: nn.Module) -> dict:
    """One of the port's models -> the JAX parameter
    tree (nested dict of fp32 numpy arrays): the inverse of
    ``jax_tree_to_state_dict``; the whole tree under tensor parallelism."""
    params = dict(module.named_parameters(remove_duplicate=False))
    for k, split in model_splits(params).items():
        params[k] = gather_shard(params[k], split)
    return state_dict_to_jax_tree(params, module)


def _load(module: nn.Module, state_dict: Mapping[str, torch.Tensor]) -> None:
    """A whole state dict into ``module``, each cut parameter taking this
    rank's part (``strict``: names and shapes must match)."""
    g = grid()
    n, i = g.shape[MODEL_AXIS], g.index[MODEL_AXIS]
    sd = dict(state_dict)
    for k, split in model_splits(dict(module.named_parameters())).items():
        sd[k] = take_shard(sd[k], split, n, i)
    module.load_state_dict(sd, strict=True)


def shard_tree(tree: Mapping, n: int, i: int) -> Dict[str, torch.Tensor]:
    """A whole JAX tree (numpy leaves: one model's, or a training tree whose
    top keys prefix the names) -> rank ``i`` of ``n``'s state dict under the
    port's names, each leaf cut by ``train/state.partition_rule``."""
    sd = jax_tree_to_state_dict(tree)
    for k, t in sd.items():
        split = partition_rule(k)
        if split is not None:
            sd[k] = take_shard(t, split, n, i)
    return sd


def gather_state_dicts(parts: Sequence[Mapping[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """The ranks' state dicts (``shard_tree``'s, in model order) -> the
    whole state dict, which ``state_dict_to_jax_tree`` renames into the
    tree."""
    out = {}
    for k, t in parts[0].items():
        split = partition_rule(k)
        out[k] = t if split is None else join_shards([p[k] for p in parts], split)
    return out


@torch.no_grad()
def load_training_tree(tree: Mapping, video_model: nn.Module, text_model: nn.Module,
                       log_temp: torch.Tensor, logit_bias: torch.Tensor,
                       locca_decoder: Optional[nn.Module] = None) -> None:
    """The JAX training tree into the port's models and scalars, in place;
    a tree with a ``locca_decoder`` needs the decoder, and the decoder a
    tree that has one."""
    if ("locca_decoder" in tree) != (locca_decoder is not None):
        raise ValueError("the tree and the models disagree on the LocCa head: tree "
                         f"{'has' if 'locca_decoder' in tree else 'lacks'} locca_decoder")
    _load(video_model, jax_tree_to_state_dict(tree["video_encoder"]))
    _load(text_model, jax_tree_to_state_dict(tree["text_encoder"]))
    if locca_decoder is not None:
        _load(locca_decoder, jax_tree_to_state_dict(tree["locca_decoder"]))
    log_temp.fill_(float(np.asarray(tree["log_temp"])))
    logit_bias.fill_(float(np.asarray(tree["logit_bias"])))


def training_tree(video_model: nn.Module, text_model: nn.Module,
                  log_temp: torch.Tensor, logit_bias: torch.Tensor,
                  locca_decoder: Optional[nn.Module] = None) -> dict:
    """The port's models and scalars as the JAX training tree."""
    tree = {"video_encoder": module_to_jax_tree(video_model),
            "text_encoder": module_to_jax_tree(text_model),
            "log_temp": log_temp.detach().cpu().numpy().astype(np.float32),
            "logit_bias": logit_bias.detach().cpu().numpy().astype(np.float32)}
    if locca_decoder is not None:
        tree["locca_decoder"] = module_to_jax_tree(locca_decoder)
    return tree


@torch.no_grad()
def load_probe_tree(tree: Mapping, video_model: nn.Module, mil_model: nn.Module) -> None:
    """The JAX linear-probing tree into the port's encoder and head, in place."""
    _load(video_model, jax_tree_to_state_dict(tree["video_encoder"]))
    _load(mil_model, jax_tree_to_state_dict(tree["mil"]))


def probe_tree(video_model: nn.Module, mil_model: nn.Module) -> dict:
    """The port's encoder and probing head as the JAX linear-probing tree."""
    return {"video_encoder": module_to_jax_tree(video_model),
            "mil": module_to_jax_tree(mil_model)}


MULTITASK_MODELS = ("video_encoder", "text_encoder", "decoder", "mvm")


@torch.no_grad()
def load_multitask_tree(tree: Mapping, models: Mapping[str, nn.Module],
                        log_temp: torch.Tensor) -> None:
    """The JAX multitask tree into the port's four models (``models`` maps
    ``video_encoder``, ``text_encoder``, ``decoder``, ``mvm`` to them) and
    ``log_temp``, in place, name for name."""
    for key in MULTITASK_MODELS:
        _load(models[key], jax_tree_to_state_dict(tree[key]))
    log_temp.fill_(float(np.asarray(tree["log_temp"])))


def multitask_tree(models: Mapping[str, nn.Module], log_temp: torch.Tensor) -> dict:
    """The port's four multitask models and ``log_temp`` as the JAX tree."""
    out = {key: module_to_jax_tree(models[key]) for key in MULTITASK_MODELS}
    out["log_temp"] = log_temp.detach().cpu().numpy().astype(np.float32)
    return out


def save_params_npz(tree: Mapping, path) -> None:
    np.savez(path, **flatten_tree(tree))


def load_params_npz(path) -> dict:
    with np.load(path) as z:
        return unflatten_tree({k: z[k] for k in z.files})
