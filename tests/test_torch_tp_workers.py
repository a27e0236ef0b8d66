"""Ranks of the tensor-parallel tests: ``torch.multiprocessing`` children on
the CPU, one ``gloo`` group through a file store
(``tests/test_torch_ddp_workers.start``).

This module imports the port and ``torch`` only, never ``jax``: the children
unpickle their function by this module's path. It holds no test of its own:
``tests/test_torch_tensor_parallel.py`` and
``tests/test_torch_tensor_parallel_steps.py`` call it.
"""

from __future__ import annotations

import contextlib
import io
import pickle
from typing import Any, Dict

import numpy as np
import torch

from deepcoro_clip_tpu_torch import configs as tconfigs
from deepcoro_clip_tpu_torch import convert
from deepcoro_clip_tpu_torch.models import layers as tl
from deepcoro_clip_tpu_torch.models.captioning_decoder import (
    CaptioningDecoder,
    greedy_generate,
    greedy_generate_kv,
)
from deepcoro_clip_tpu_torch.models.text_encoder import BertLayer
from deepcoro_clip_tpu_torch.models.video_encoder import init_params
from deepcoro_clip_tpu_torch.parallel import distributed
from deepcoro_clip_tpu_torch.parallel.mesh import MODEL_AXIS
from deepcoro_clip_tpu_torch.registry import register_all
from deepcoro_clip_tpu_torch.train.state import model_splits

from tests import test_torch_ddp_workers as ddp


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def build_layer(case: Dict[str, Any]) -> torch.nn.Module:
    """The port's module of a layer case (fp32)."""
    kind, dim, heads = case["kind"], case["dim"], case["heads"]
    f32 = torch.float32
    if kind == "mlp":
        return tl.MlpBlock(dim, case["hidden"], dim, case.get("dropout", 0.0), f32)
    if kind == "attention":
        return tl.Attention(dim, heads, dtype=f32, use_flash=True, cross=case["cross"],
                            fused_outproj=case.get("fused", False),
                            context_dim=case.get("context_dim"))
    if kind == "block":
        return tl.TransformerBlock(dim, heads, dtype=f32, use_flash=True)
    if kind == "bert":
        return BertLayer(dim, heads, case["hidden"], dropout=0.0, dtype=f32)
    raise ValueError(kind)


def call_layer(module, case: Dict[str, Any], x, context=None, generator=None):
    kw = {}
    if case.get("sin") is not None:
        kw.update(sin=torch.from_numpy(case["sin"]), cos=torch.from_numpy(case["cos"]))
    mask = None if case.get("mask") is None else torch.from_numpy(case["mask"])
    if case["kind"] == "mlp":
        return module(x, deterministic=generator is None, generator=generator)
    if case["kind"] == "attention":
        return module(x, context=context, kv_mask=mask, **kw)
    if case["kind"] == "block":
        return module(x, kv_mask=mask, **kw)
    return module(x, mask)


def whole_grads(module, grads: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Parameter gradients (this rank's parts of the cut ones) -> the flat
    JAX-named tree of the whole gradients."""
    splits = model_splits(dict(module.named_parameters()))
    whole = {k: (distributed.gather_shard(g, splits[k]) if k in splits else g)
             for k, g in grads.items()}
    return convert.flatten_tree(convert.state_dict_to_jax_tree(whole, module))


def layer_case(case: Dict[str, Any]) -> Dict[str, Any]:
    """One layer cut over the grid's model axis, loaded from the whole JAX
    tree: its output and the gradients of ``sum(out * dout)`` (the whole
    parameter gradients, the input's and the context's), the parameters'
    element counts against the whole ones; the uncut layer's output beside
    it where the case draws dropout."""
    grid = distributed.grid()
    module = build_layer(case)
    module.load_state_dict(convert.jax_tree_to_state_dict(case["params"]), strict=True)
    whole_numel = {k: p.numel() for k, p in module.named_parameters()}
    uncut = build_layer(case)
    uncut.load_state_dict(module.state_dict())
    kept = tl.shard_layers(module, grid)
    x = torch.from_numpy(case["x"]).requires_grad_()
    ctx = None if case.get("context") is None else torch.from_numpy(
        case["context"]).requires_grad_()
    gen = None
    if case.get("dropout"):
        gen = torch.Generator().manual_seed(11)
    out = call_layer(module, case, x, ctx, gen)
    names = [k for k, _ in module.named_parameters()]
    leaves = [p for _, p in module.named_parameters()] + [x] + ([ctx] if ctx is not None else [])
    got = torch.autograd.grad(out, leaves, torch.from_numpy(case["dout"]))
    res = {"out": _np(out), "grads": whole_grads(module, dict(zip(names, got))),
           "dx": _np(got[len(names)]),
           "dcontext": None if ctx is None else _np(got[len(names) + 1]),
           "numel": {k: (p.numel(), whole_numel[k]) for k, p in module.named_parameters()},
           "splits": {k: tuple(s) for k, s in
                      model_splits(dict(module.named_parameters())).items()},
           "kept": kept}
    if gen is not None:  # the same draws without the cut
        ref = call_layer(uncut, case, x.detach(), None, torch.Generator().manual_seed(11))
        res["uncut_out"] = _np(ref)
    return res


def odd_heads(_: Dict[str, Any]) -> Dict[str, Any]:
    """A layer whose heads the model axis does not divide: 3 heads over 2
    ranks. It stays whole (its log line on rank 0), and computes what the
    uncut layer does."""
    torch.manual_seed(5)
    module = tl.TransformerBlock(48, 3, dtype=torch.float32, use_flash=False)
    uncut = tl.TransformerBlock(48, 3, dtype=torch.float32, use_flash=False)
    init_params(module, 3)
    uncut.load_state_dict(module.state_dict())
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        kept = tl.shard_layers(module, distributed.grid())
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(2, 7, 48)).astype(np.float32))
    return {"kept": kept, "log": log.getvalue(), "out": _np(module(x)),
            "uncut_out": _np(uncut(x)),
            "shapes": {k: tuple(p.shape) for k, p in module.named_parameters()},
            "uncut_shapes": {k: tuple(p.shape) for k, p in uncut.named_parameters()}}


def greedy(case: Dict[str, Any]) -> Dict[str, Any]:
    """The captioning decoder's greedy generation with the K/V cache and by
    full recompute, cut over the grid's model axis, and the uncut
    decoder's K/V-cache ids."""
    def decoder():
        return CaptioningDecoder(vocab_size=64, dim=32, depth=2, num_heads=2, max_length=8,
                                 memory_dim=24, dropout=0.0, dtype=torch.float32,
                                 use_flash=True)

    cut = init_params(decoder(), 9)
    uncut = decoder()
    uncut.load_state_dict(cut.state_dict())
    tl.shard_layers(cut, distributed.grid())
    tokens = torch.from_numpy(case["tokens"])
    return {"kv": greedy_generate_kv(cut, tokens, 1, 2).numpy(),
            "full": greedy_generate(cut, tokens, 1, 2).numpy(),
            "uncut_kv": greedy_generate_kv(uncut, tokens, 1, 2).numpy(),
            "cache_heads": cut.layer0.self_attn.heads}


def layers(rank: int, world: int, spec_path: str) -> Dict[str, Any]:
    """The layer cases of the spec on the grid ``(world / M, M)``, then the
    odd-heads layer and the greedy generation."""
    register_all()
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    distributed.init_grid(spec["model"])
    out = {name: layer_case(case) for name, case in spec["layers"].items()}
    out["odd_heads"] = odd_heads({})
    out["greedy"] = greedy(spec["greedy"])
    out["index"] = dict(distributed.grid().index)
    return out


# --------------------------------------------------------------------------- #
# train steps on the grid


def _byte_counts(state) -> Dict[str, Any]:
    """Per cut parameter: its elements and its Adam moments' on this rank."""
    p = state.params
    opt = state.opt_state.get("inner", state.opt_state)
    return {k: (p[k].numel(), opt["mu"][k].numel(), opt["nu"][k].numel())
            for k in model_splits(p)}


def steps(rank: int, world: int, spec_path: str) -> Dict[str, Any]:
    """Each case of the spec (``tests/test_torch_ddp_workers.CASES``'
    kinds) on the grid its config's ``mesh_model`` makes: the loss and the
    averaged gradients, then one train step from the same weights, each
    through ``tests/test_torch_ddp_workers``' case functions on this rank's
    data index's rows; the cut parameters' element counts."""
    register_all()
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    out: Dict[str, Any] = {}
    for name, case in spec.items():
        grid = distributed.init_grid(case["config"]["mesh_model"])
        fn = ddp.CASES[case["kind"]]
        d, n = grid.index["data"], grid.shape["data"]
        res = {**fn(case, d, n, "grads"), **fn(case, d, n, "step")}
        res.update(grid=dict(grid.shape), index=dict(grid.index))
        out[name] = res
    return out


def cut_counts(rank: int, world: int, spec_path: str) -> Dict[str, Any]:
    """The CLIP bundle of the spec's config on its grid: every cut
    parameter's elements, its gradient's and its Adam moments' here, with
    the whole counts of the one-process bundle."""
    from deepcoro_clip_tpu_torch.parallel.batching import make_batch_sharding_fn
    from deepcoro_clip_tpu_torch.train import clip as tclip

    register_all()
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    cfg = tconfigs.ClipConfig.from_dict(spec["config"])
    cfg.set_device_info_in_place()
    bundle, state = tclip.build_clip_bundle(cfg, seed=0, steps_per_epoch=4, device="cpu")
    batch = make_batch_sharding_fn(distributed.data_size(), distributed.data_rank(),
                                   tclip.replicated_keys(cfg))(spec["batch"],
                                                               torch.device("cpu"))
    _, grads = tclip.loss_and_grads(bundle, state.params, batch)
    counts = _byte_counts(state)
    return {"counts": {k: (c[0], grads[k].numel(), c[1], c[2]) for k, c in counts.items()},
            "grad_split": {k: getattr(grads[k], "model_split", None) is not None
                           for k in counts},
            "M": distributed.grid().shape[MODEL_AXIS]}


def job(rank: int, world: int, spec_path: str) -> Dict[str, Any]:
    """The spec's parts on this rank, in order: ``layers``, ``steps``,
    ``counts`` (each a path to its own spec) and ``mains``
    (``tests/test_torch_ddp_workers.run_mains``)."""
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    out: Dict[str, Any] = {}
    for part, fn in (("layers", layers), ("steps", steps), ("counts", cut_counts)):
        if part in spec:
            out[part] = fn(rank, world, spec[part])
    if "mains" in spec:
        out["mains"] = ddp.run_mains(rank, world, spec["mains"], spec["audit_root"])
    return out
