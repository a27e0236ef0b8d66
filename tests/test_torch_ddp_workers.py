"""Ranks of the port's data-parallel tests: ``torch.multiprocessing`` children
on the CPU, one ``gloo`` group through a file store.

This module imports the port and ``torch`` only, never ``jax``: the children
unpickle their function by this module's path. Each child writes what it
computed to ``{out}/rank{r}.pkl``; ``spawn`` returns those, in rank order.
It holds no test of its own: ``tests/test_torch_distributed.py`` and
``tests/test_torch_ddp_runner.py`` call it.
"""

from __future__ import annotations

import os
import pickle
import uuid
from pathlib import Path
from typing import Any, Callable, Dict, List

import numpy as np
import torch

from deepcoro_clip_tpu_torch import configs as tconfigs
from deepcoro_clip_tpu_torch import convert
from deepcoro_clip_tpu_torch.parallel import distributed
from deepcoro_clip_tpu_torch.parallel.batching import make_batch_sharding_fn
from deepcoro_clip_tpu_torch.registry import register_all


def _child(rank: int, fn: Callable, world: int, out: str, store: str, args: tuple) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world))
    torch.set_num_threads(2)
    distributed.init_from_env("cpu", init_method=f"file://{store}")
    try:
        result = fn(rank, world, *args)
    finally:
        distributed.shutdown()
    with open(Path(out) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(result, f)


def start(fn: Callable, world: int, out, *args) -> Callable[[], List[Any]]:
    """Start ``fn(rank, world, *args)`` on ``world`` gloo ranks; returns the
    function that waits for them and returns their results in rank order.
    A rank that raises fails the wait (the others are terminated)."""
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    for r in range(world):
        (out / f"rank{r}.pkl").unlink(missing_ok=True)
    store = out / f"store_{uuid.uuid4().hex}"
    ctx = torch.multiprocessing.start_processes(
        _child, args=(fn, world, str(out), str(store), args), nprocs=world, join=False,
        start_method="spawn")

    def wait() -> List[Any]:
        while not ctx.join():
            pass
        results = []
        for r in range(world):
            with open(out / f"rank{r}.pkl", "rb") as f:
                results.append(pickle.load(f))
        return results

    return wait


def spawn(fn: Callable, world: int, out, *args) -> List[Any]:
    """``start`` and wait."""
    return start(fn, world, out, *args)()


# --------------------------------------------------------------------------- #
# the collectives


def collectives(rank: int, world: int) -> Dict[str, Any]:
    """The helpers of ``parallel/multihost.py`` and ``parallel/distributed.py``
    on fixed per-rank inputs."""
    from deepcoro_clip_tpu_torch.parallel import multihost

    out: Dict[str, Any] = {
        "objects": multihost.gather_objects([f"r{rank}", {"rank": rank}]),
        "arrays": multihost.gather_arrays(np.full((rank + 1, 2), rank, np.int64)),
        "broadcast": multihost.broadcast_from_host0({"from": rank}),
    }
    r = np.random.default_rng(0)
    x_all = r.normal(size=(world * 3, 4)).astype(np.float32)
    w = r.normal(size=(world * 3, 4)).astype(np.float32)
    x = torch.from_numpy(x_all[rank * 3:(rank + 1) * 3]).requires_grad_(True)
    g = distributed.gather_rows(x)
    # a loss of the gathered rows, and one that sums a local term over ranks
    loss = (g * torch.from_numpy(w)).sum() ** 2 / 10.0
    loss = loss + distributed.all_reduce_sum((x ** 3).sum()) * 0.5
    (gx,) = torch.autograd.grad(loss, [x])
    out.update(gathered=g.detach().numpy(), loss=float(loss.detach()), grad=gx.numpy(),
               x_all=x_all, w=w)
    grads = {"a": torch.full((3,), float(rank + 1)), "b": torch.full((2, 2), 10.0 * rank)}
    distributed.all_reduce_grads(grads)
    out["reduced"] = {k: v.numpy() for k, v in grads.items()}
    out["ratio"] = float(distributed.global_ratio(torch.tensor(float(rank + 1)),
                                                  torch.tensor(float(2 * rank + 1))))
    return out


# --------------------------------------------------------------------------- #
# one train step of each pipeline


def _grad_tree(params, grads, tree_of) -> Dict[str, np.ndarray]:
    """``grads`` as the flat JAX-shaped tree of the parameters they belong
    to (through the models' parameter names)."""
    saved = {k: p.detach().clone() for k, p in params.items()}
    with torch.no_grad():
        for k, g in grads.items():
            params[k].copy_(g)
    flat = convert.flatten_tree(tree_of())
    with torch.no_grad():
        for k, v in saved.items():
            params[k].copy_(v)
    return flat


def _host(metrics) -> Dict[str, float]:
    return {k: float(v) for k, v in metrics.items()}


def _clip_case(case, rank, world, mode):
    from deepcoro_clip_tpu_torch.train import clip as tclip

    cfg = tconfigs.ClipConfig.from_dict(case["config"])
    bundle, state = tclip.build_clip_bundle(cfg, seed=0, steps_per_epoch=4, device="cpu")
    bundle.text_model.proj.dropout = 0.0
    p = state.params
    convert.load_training_tree(case["init"], bundle.video_model, bundle.text_model,
                               p["log_temp"], p["logit_bias"])
    batch = make_batch_sharding_fn(world, rank, tclip.replicated_keys(cfg))(
        case["batch"], torch.device("cpu"))

    def tree():
        return convert.training_tree(bundle.video_model, bundle.text_model,
                                     p["log_temp"], p["logit_bias"])

    if mode == "grads":
        out, grads = tclip.loss_and_grads(bundle, p, batch)
        return {"loss": float(out["loss"].detach()), "grads": _grad_tree(p, grads, tree)}
    state, metrics = tclip.make_train_step(bundle)(state, batch, None, 0.0, 0.0, -1.0)
    return {"metrics": _host(metrics), "params": convert.flatten_tree(tree())}


def _multitask_case(case, rank, world, mode):
    from deepcoro_clip_tpu_torch.train import multitask as tmt

    cfg = tconfigs.MultitaskConfig.from_dict(case["config"])
    bundle, state = tmt.build_multitask_bundle(cfg, seed=0, steps_per_epoch=4, device="cpu")
    bundle.text_model.proj.dropout = 0.0
    models = {"video_encoder": bundle.video_model, "text_encoder": bundle.text_model,
              "decoder": bundle.decoder, "mvm": bundle.mvm}
    p = state.params
    convert.load_multitask_tree(case["init"], models, p["log_temp"])
    batch = make_batch_sharding_fn(world, rank)(case["batch"], torch.device("cpu"))
    # this rank's rows of the global [B*N, L] MVM mask
    per = len(case["mvm_mask"]) // world
    mask = torch.from_numpy(case["mvm_mask"][rank * per:(rank + 1) * per])
    w = case["weights"]

    def tree():
        return convert.multitask_tree(models, p["log_temp"])

    if mode == "grads":
        out, loss, grads = tmt.multitask_loss_and_grads(bundle, p, batch, p["log_temp"],
                                                        None, *w, mvm_mask=mask)
        terms = {k: float(out[k].detach()) for k in ("contrastive", "captioning", "mvm",
                                            "consistency")}
        return {"loss": float(loss.detach()), "terms": terms,
                "grads": _grad_tree(p, grads, tree)}
    state, metrics = tmt.make_multitask_train_step(bundle)(
        state, batch, None, *w, 0.0, 0.0, -1.0, mvm_mask=mask)
    return {"metrics": _host(metrics), "params": convert.flatten_tree(tree())}


def _probe_case(case, rank, world, mode):
    from deepcoro_clip_tpu_torch.train import linear_probe as tprobe

    cfg = tconfigs.LinearProbingConfig.from_dict(case["config"])
    bundle, state = tprobe.build_probe_bundle(cfg, seed=0, steps_per_epoch=4, device="cpu")
    convert.load_probe_tree(case["init"], bundle.video_model, bundle.mil_model)
    batch = make_batch_sharding_fn(world, rank)(case["batch"], torch.device("cpu"))
    ratio = case["ratio"]

    def tree():
        return convert.probe_tree(bundle.video_model, bundle.mil_model)

    if mode == "grads":
        losses, grads, _ = tprobe.probe_loss_and_grads(bundle, state.params, batch, None,
                                                        ratio)
        return {"loss": float(losses["main"].detach()),
                "grads": _grad_tree(state.params, grads, tree)}
    state, metrics = tprobe.make_probe_train_step(bundle)(state, batch, None, ratio)
    return {"metrics": _host(metrics), "params": convert.flatten_tree(tree())}


CASES = {"clip": _clip_case, "multitask": _multitask_case, "probe": _probe_case}


def steps(rank: int, world: int, spec_path: str) -> Dict[str, Any]:
    """Each case of the spec (``{name: {"kind", "config", "init", "batch",
    ...}}``): the loss and the averaged gradients of one step, then one
    train step from the same initial weights."""
    register_all()
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    out = {}
    for name, case in spec.items():
        fn = CASES[case["kind"]]
        out[name] = {**fn(case, rank, world, "grads"), **fn(case, rank, world, "step")}
    return out


# --------------------------------------------------------------------------- #
# runs through main


def _writes_under(root: Path, record: List[str]) -> None:
    """Record in ``record`` every file this process opens for writing, and
    every directory it makes, under ``root`` (an audit hook: it sees
    ``open``, ``io.open`` and ``os.open`` alike; ``torch.save``, which opens
    its file in C++, is wrapped)."""
    import sys

    save = torch.save

    def recorded_save(obj, f, *a, **kw):
        if isinstance(f, (str, os.PathLike)) and str(f).startswith(str(root)):
            record.append(str(f))
        return save(obj, f, *a, **kw)

    torch.save = recorded_save

    root = str(root)
    write_flags = os.O_WRONLY | os.O_RDWR | os.O_CREAT | os.O_APPEND

    def hook(event, args):
        if event == "open" and args and isinstance(args[0], (str, os.PathLike)):
            path, mode, flags = (list(args) + [None, 0])[:3]
            writes = (any(c in mode for c in "wax+") if isinstance(mode, str)
                      else bool((flags or 0) & write_flags))
            if writes and str(path).startswith(root):
                record.append(str(path))
        elif event == "os.mkdir" and str(args[0]).startswith(root):
            record.append(str(args[0]))

    sys.addaudithook(hook)


def _no_text_dropout(cls) -> None:
    """Make ``cls`` (a runner) build its text tower with the projection's
    dropout off."""
    init = cls.__init__

    def wrapped(self, *a, **kw):
        init(self, *a, **kw)
        self.bundle.text_model.proj.dropout = 0.0

    cls.__init__ = wrapped


def run_mains(rank: int, world: int, jobs: List[Dict[str, Any]], audit_root: str
              ) -> List[Dict[str, Any]]:
    """``main`` once a job, in order. A job: ``argv``; ``resume_from``: the
    index of an earlier job whose run it resumes (``--resume_training true
    --checkpoint <its run dir>``); ``cut``: stop after epoch 0, as a killed
    run would (``train`` cut at ``end_epoch=1``); ``expect_error``: return
    the error ``main`` raises; ``grid_only``: parse the config and make its
    process grid (``set_device_info_in_place``), and return the grid's shape
    instead of running. The text head's projection dropout, which no
    config field reaches, is off (as on the JAX side of the tests). Each
    result holds the history and the run directory; the last entry lists
    what this rank wrote under ``audit_root``."""
    from deepcoro_clip_tpu_torch.main import main
    from deepcoro_clip_tpu_torch.runners import contrastive as trun
    from deepcoro_clip_tpu_torch.runners import multitask as mrun

    written: List[str] = []
    _writes_under(Path(audit_root), written)
    runner = trun.VideoContrastiveLearningRunner
    train = runner.train
    for cls in (runner, mrun.MultitaskRunner):
        _no_text_dropout(cls)
    results: List[Dict[str, Any]] = []
    for job in jobs:
        argv = list(job["argv"])
        if "resume_from" in job:
            argv += ["--resume_training", "true", "--checkpoint",
                     results[job["resume_from"]]["output_dir"]]
        if job.get("grid_only"):
            from deepcoro_clip_tpu_torch.configs import parse_config

            parse_config(argv).set_device_info_in_place()
            results.append({"grid": dict(distributed.grid().shape)})
            continue
        runner.train = (
            (lambda self, start_epoch=0, end_epoch=None: train(self, start_epoch, 1))
            if job.get("cut") else train)
        if job.get("expect_error"):
            try:
                main(argv)
            except (ValueError, NotImplementedError) as e:
                results.append({"error": f"{type(e).__name__}: {e}"})
            else:
                results.append({"error": ""})
            continue
        out = main(argv)
        results.append({k: out.get(k) for k in ("history", "output_dir", "inference_rows")})
    results.append({"written": written})
    return results
