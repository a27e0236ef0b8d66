"""Weight bridge: the JAX ``VideoEncoder`` parameter tree -> the port's state dict.

The JAX tree comes as nested dicts of numpy arrays (``flax`` is not
needed): ``backbone/{patch_embed/conv/{kernel,bias}, cls, block{i}/...,
pool{s}/..., norm}``, ``proj/proj/...``, ``aggregator/{pos_embedding,
query, block{i}/..., norm}``. The port's modules carry the same names, so
a path maps onto a state-dict key by joining with ``.``, with two renames:

- a dense ``kernel`` ``[in, out]`` becomes the transposed ``weight``
  ``[out, in]`` of a ``Linear``;
- a LayerNorm ``scale`` becomes ``weight``.

The patch ``kernel`` ``[pt, ph, pw, C, dim]`` stays a raw parameter.

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

from typing import Dict, Mapping

import numpy as np
import torch


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
    """JAX ``VideoEncoder`` params (nested dict, optionally under a
    ``"params"`` key) -> the port's ``VideoEncoder`` state dict (fp32)."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    sd = {}
    for path, arr in flatten_tree(tree).items():
        *mods, name = path.split("/")
        if name == "kernel" and arr.ndim == 2:
            name, arr = "weight", arr.T
        elif name == "scale":
            name = "weight"
        sd[".".join(mods + [name])] = torch.tensor(np.asarray(arr, np.float32))
    return sd


def save_params_npz(tree: Mapping, path) -> None:
    np.savez(path, **flatten_tree(tree))


def load_params_npz(path) -> dict:
    with np.load(path) as z:
        return unflatten_tree({k: z[k] for k in z.files})
