"""Ranks of the process-group ring tests: ``torch.multiprocessing`` children
on the CPU, one ``gloo`` group through a file store
(``tests/test_torch_ddp_workers.start``).

This module imports the port and ``torch`` only, never ``jax``: the children
unpickle their function by this module's path. It holds no test of its own:
``tests/test_torch_ring_processes.py`` calls it.
"""

from __future__ import annotations

import pickle
from typing import Any, Dict, List

import numpy as np
import torch

from deepcoro_clip_tpu_torch import configs as tconfigs
from deepcoro_clip_tpu_torch import convert
from deepcoro_clip_tpu_torch.models import layers as tlayers
from deepcoro_clip_tpu_torch.parallel import distributed
from deepcoro_clip_tpu_torch.parallel.batching import make_batch_sharding_fn
from deepcoro_clip_tpu_torch.parallel.mesh import MODEL_AXIS, ProcessMesh
from deepcoro_clip_tpu_torch.parallel.ring_attention import ring_attention
from deepcoro_clip_tpu_torch.registry import register_all

from tests import test_torch_ddp_workers as ddp

DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def ring_cases(cases: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Each case (``n``, ``dtype``, ``backend``, full ``q``/``k``/``v``/``do``
    ``[B, H, L, Dh]``) on the grid ``(world / n, n)``: this rank's output
    chunk and the gradients of its q/k/v chunks; the K6 launch count
    (none on the CPU)."""
    out: Dict[str, Any] = {}
    ring_attention.launches = 0
    for case in sorted(cases, key=lambda c: c["n"]):
        mesh = distributed.init_grid(case["n"])
        m, n = mesh.index[MODEL_AXIS], mesh.shape[MODEL_AXIS]
        dt = DTYPES[case["dtype"]]
        L = case["q"].shape[2]
        c = slice(m * L // n, (m + 1) * L // n)
        leaves = [torch.from_numpy(case[k][:, :, c]).to(dt).requires_grad_()
                  for k in "qkv"]
        o = ring_attention(*leaves, mesh, backend=case["backend"])
        grads = torch.autograd.grad(o, leaves, torch.from_numpy(case["do"][:, :, c]).to(dt))
        out[case["name"]] = {"chunk": m, "data": mesh.index["data"], "dtype": str(o.dtype),
                             "out": _np(o), "grads": [_np(g) for g in grads]}
    out["launches"] = ring_attention.launches
    return out


def _count_rings(calls: List[int]) -> None:
    """Count the Attention layers' ring calls in ``calls``."""
    ring = tlayers.ring_attention

    def counted(*a, **kw):
        calls.append(1)
        return ring(*a, **kw)

    tlayers.ring_attention = counted


def ring_step(case: Dict[str, Any]) -> Dict[str, Any]:
    """One CLIP step with ``use_ring_attention`` on the grid the config asks
    for (``set_device_info_in_place`` builds it): loss and averaged
    gradients, then the train step from the same weights (as
    ``test_torch_ddp_workers`` does at data parallelism alone)."""
    from deepcoro_clip_tpu_torch.train import clip as tclip

    cfg = tconfigs.ClipConfig.from_dict(case["config"])
    cfg.set_device_info_in_place()
    bundle, state = tclip.build_clip_bundle(cfg, seed=0, steps_per_epoch=4, device="cpu")
    mesh = bundle.video_model.backbone.block0.attn.ring_mesh
    assert isinstance(mesh, ProcessMesh), mesh
    bundle.text_model.proj.dropout = 0.0
    p = state.params
    convert.load_training_tree(case["init"], bundle.video_model, bundle.text_model,
                               p["log_temp"], p["logit_bias"])
    batch = make_batch_sharding_fn(distributed.data_size(), distributed.data_rank(),
                                   tclip.replicated_keys(cfg))(case["batch"],
                                                               torch.device("cpu"))

    def tree():
        return convert.training_tree(bundle.video_model, bundle.text_model,
                                     p["log_temp"], p["logit_bias"])

    calls: List[int] = []
    _count_rings(calls)
    out, grads = tclip.loss_and_grads(bundle, p, batch)
    result = {"loss": float(out["loss"].detach()), "grads": ddp._grad_tree(p, grads, tree),
              "ring_calls": len(calls), "grid": dict(mesh.shape),
              "index": dict(mesh.index), "rows": len(batch["videos"])}
    state, metrics = tclip.make_train_step(bundle)(state, batch, None, 0.0, 0.0, -1.0)
    result.update(metrics=ddp._host(metrics), params=convert.flatten_tree(tree()))
    return result


def config_errors(configs: List[Dict[str, Any]]) -> List[str]:
    """``set_device_info_in_place`` of each config: the error it raises,
    ``""`` where it raises none (then the grid it made)."""
    errors = []
    for d in configs:
        cfg = tconfigs.ClipConfig.from_dict(d)
        try:
            cfg.set_device_info_in_place()
        except (ValueError, NotImplementedError) as e:
            errors.append(f"{type(e).__name__}: {e}")
        else:
            errors.append(f"{distributed.grid().shape}")
    return errors


def job(rank: int, world: int, spec_path: str) -> Dict[str, Any]:
    """The spec's parts on this rank, in order: ``rings`` (``ring_cases``),
    ``steps`` (``ring_step`` of each), ``errors`` (``config_errors``) and
    ``mains`` (``test_torch_ddp_workers.run_mains``)."""
    register_all()
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    out: Dict[str, Any] = {}
    if "rings" in spec:
        out["rings"] = ring_cases(spec["rings"])
    if "steps" in spec:
        out["steps"] = {name: ring_step(case) for name, case in spec["steps"].items()}
    if "errors" in spec:
        out["errors"] = config_errors(spec["errors"])
    if "mains" in spec:
        out["mains"] = ddp.run_mains(rank, world, spec["mains"], spec["audit_root"])
    return out
