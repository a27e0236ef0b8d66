"""Linear-probing / multi-instance-learning training step assembly.

Port of the JAX package's ``train/linear_probe.py``: a (usually
frozen) video encoder that emits per-video embeddings ``[B, N, D]`` (or
``[B, N, L, D]`` tokens for hierarchical pooling), the
``MultiInstanceLinearProbing`` head in fp32, ``multi_head_loss``, and the
labelled-group AdamW. Encoder freezing is a mask on gradients and updates
by a ratio the step is given (1.0 = fully frozen); at 1.0 the step runs the
encoder without a graph, which leaves every number as it was: the masked
gradients and updates are zero either way.

A step updates the state it is given in place and returns it with
``step + 1``; PyTorch runs it eagerly, so ``make_probe_train_step`` returns
a plain function.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from deepcoro_clip_tpu_torch.convert import (
    flatten_tree,
    jax_tree_to_state_dict,
    module_to_jax_tree,
    state_dict_to_jax_tree,
)
from deepcoro_clip_tpu_torch.device import resolve_device
from deepcoro_clip_tpu_torch.losses.heads import multi_head_loss
from deepcoro_clip_tpu_torch.models.layers import shard_layers
from deepcoro_clip_tpu_torch.models.mil import MultiInstanceLinearProbing
from deepcoro_clip_tpu_torch.models.video_encoder import (
    init_params,
    video_encoder_from_config,
)
from deepcoro_clip_tpu_torch.parallel import distributed
from deepcoro_clip_tpu_torch.parallel.distributed import gather_rows
from deepcoro_clip_tpu_torch.train import optim as optim_lib
from deepcoro_clip_tpu_torch.train.schedulers import get_scheduler
from deepcoro_clip_tpu_torch.train.state import TrainState


class ProbeBundle(NamedTuple):
    """Everything static needed to run linear probing."""

    config: Any
    device: torch.device
    video_model: Any
    mil_model: Any
    tx: Any               # optim.GroupedOptimizer or optim.MultiSteps
    schedule: Callable
    video_fracs: Dict[str, float]   # freeze-order fractions per encoder leaf
    head_names: tuple


def mil_from_config(cfg) -> MultiInstanceLinearProbing:
    """The probing head of a ``LinearProbingConfig``: always fp32, its CLS
    transformer on the attention kernels when the config says so."""
    return MultiInstanceLinearProbing(
        embedding_dim=cfg.embedding_dim,
        head_structure=dict(cfg.head_structure),
        pooling_mode=cfg.pooling_mode,
        attention_hidden=cfg.attention_hidden,
        dropout=cfg.dropout,
        dropout_attention=cfg.dropout_attention,
        num_heads=cfg.num_heads,
        separate_video_attention=cfg.separate_video_attention,
        normalization_strategy=cfg.normalization_strategy,
        use_view_embeddings=cfg.use_view_embeddings,
        num_view_classes=cfg.num_view_classes,
        hierarchical=cfg.hierarchical_tokens,
        dtype=torch.float32,
        use_flash=cfg.use_pallas_attention,
    )


def merge_encoder_params(new: Any, old: Any) -> Any:
    """Partial weight transfer by matching key paths of two parameter trees
    (nested dicts of arrays, flax names): subtrees present in both transfer;
    what only the probing encoder has (its ``pool``) keeps its fresh values,
    what only the checkpoint has (a CLIP tree's ``aggregator`` may differ)
    is ignored, and so is a leaf whose shape differs."""
    if isinstance(new, Mapping) and isinstance(old, Mapping):
        return {k: (merge_encoder_params(v, old[k]) if k in old else v)
                for k, v in new.items()}
    if isinstance(new, Mapping) or isinstance(old, Mapping):
        return new  # structural mismatch below a shared key
    arr = np.asarray(old, np.asarray(new).dtype)
    return arr if arr.shape == np.asarray(new).shape else new


def encoder_tree(video_model, encoder_params: Mapping) -> Mapping:
    """``encoder_params`` as a JAX tree: a tree (under ``"params"`` or not)
    as it is, a flat dict of tensors named as ``video_model``'s parameters
    (a port checkpoint's ``video_encoder.*`` entries without the prefix)
    renamed by ``video_model``'s layer types."""
    if set(encoder_params) == {"params"}:
        encoder_params = encoder_params["params"]
    if encoder_params and all(isinstance(v, torch.Tensor) for v in encoder_params.values()):
        return state_dict_to_jax_tree(encoder_params, video_model)
    return encoder_params


def loaded_encoder_leaves(video_model, encoder_params: Mapping) -> list:
    """The paths of ``video_model``'s leaves that ``encoder_params`` (as
    ``build_probe_bundle`` takes it) replaces: same path, same shape."""
    have = flatten_tree(encoder_tree(video_model, encoder_params))
    return sorted(k for k, v in flatten_tree(module_to_jax_tree(video_model)).items()
                  if k in have and have[k].shape == v.shape)


def probe_params(video_model, mil_model) -> Dict[str, torch.Tensor]:
    """The flat training dict over the models' own parameters."""
    params = {f"video_encoder.{k}": p for k, p in video_model.named_parameters()}
    params.update({f"mil.{k}": p for k, p in mil_model.named_parameters()})
    return params


def build_probe_bundle(cfg, seed: int = 0, steps_per_epoch: int = 100,
                       encoder_params: Optional[Mapping] = None,
                       device: Optional[str] = None,
                       fused_outproj: Optional[bool] = None
                       ) -> Tuple[ProbeBundle, TrainState]:
    """Build encoder and head with seeded random weights, the optimizer and
    the initial ``TrainState`` on ``device`` (CUDA unless the caller passes
    ``"cpu"``). ``encoder_params``: a pretrained video-encoder tree (flax
    names, e.g. ``convert.module_to_jax_tree`` of a CLIP run's video model),
    or a flat dict of tensors under the port's names (``encoder_tree``),
    transplanted where paths and shapes match. ``fused_outproj``: see
    ``video_encoder_from_config``. A ``mesh_model`` above 1 under a process
    group cuts the layers of both models over the grid's model axis once
    their weights are set (``models/layers.shard_layers``)."""
    dev = resolve_device(device)
    # the encoder emits per-video embeddings [B, N, D] (aggregation forced
    # off), or patch tokens for hierarchical pooling
    video_model = init_params(video_encoder_from_config(
        cfg, aggregate=False, per_video=not cfg.hierarchical_tokens,
        fused_outproj=fused_outproj), seed)
    if encoder_params is not None:
        merged = merge_encoder_params(module_to_jax_tree(video_model),
                                      encoder_tree(video_model, encoder_params))
        video_model.load_state_dict(jax_tree_to_state_dict(merged), strict=True)
    mil_model = init_params(mil_from_config(cfg), seed + 1)
    tp = distributed.tensor_parallel_grid(cfg.mesh_model)
    for m in (video_model, mil_model):
        if tp is not None:
            shard_layers(m, tp)
        m.to(dev)
    params = probe_params(video_model, mil_model)

    schedule = get_scheduler(
        cfg.scheduler_name, cfg.lr, steps_per_epoch, cfg.epochs,
        num_warmup_percent=cfg.num_warmup_percent, factor=cfg.factor,
        lr_step_period=cfg.lr_step_period,
        num_hard_restarts_cycles=cfg.num_hard_restarts_cycles,
        warm_restart_tmult=cfg.warm_restart_tmult,
        gradient_accumulation_steps=cfg.gradient_accumulation_steps,
    )
    tx = optim_lib.make_probe_optimizer(cfg, schedule, params)
    if cfg.gradient_accumulation_steps > 1:
        tx = optim_lib.MultiSteps(tx, cfg.gradient_accumulation_steps)
    state = TrainState(step=0, params=params, opt_state=tx.init(params))
    bundle = ProbeBundle(
        config=cfg, device=dev, video_model=video_model, mil_model=mil_model,
        tx=tx, schedule=schedule,
        video_fracs=optim_lib.freeze_fractions(
            dict(video_model.named_parameters()), include=("backbone",)),
        head_names=tuple(cfg.head_structure),
    )
    return bundle, state


def _check_own_params(bundle: ProbeBundle, params: Mapping[str, torch.Tensor]) -> None:
    """The steps run the bundle's modules, so the dict they are handed must
    hold those modules' own parameters (as ``build_probe_bundle``'s state
    does): anything else would be ignored without a word. Other weights go
    in through ``load_state_dict`` on the bundle's models."""
    own = probe_params(bundle.video_model, bundle.mil_model)
    if set(params) != set(own) or any(params[n] is not p for n, p in own.items()):
        raise ValueError(
            "params are not the bundle's own parameters; load other weights into "
            "bundle.video_model / bundle.mil_model with load_state_dict")


def to_device_batch(bundle: ProbeBundle, batch: Mapping[str, Any]) -> Dict[str, Any]:
    """A host batch (numpy arrays or tensors; ``targets`` is a dict per
    head) onto the bundle's device."""
    def put(v):
        if isinstance(v, Mapping):
            return {k: put(x) for k, x in v.items()}
        return torch.as_tensor(v).to(bundle.device)
    return {k: put(v) for k, v in batch.items()}


def forward_heads(bundle: ProbeBundle, batch, generator=None,
                  deterministic: bool = True, encoder_grad: bool = True):
    """``(outputs, embeddings)``. Float videos come normalized from the host;
    integer (uint8) videos go raw into the encoder, whose patchify folds the
    dataset statistics into its weights. A fully frozen encoder
    (``video_freeze_ratio >= 1``) never drops."""
    cfg = bundle.config
    videos = batch["videos"]
    with torch.set_grad_enabled(encoder_grad and torch.is_grad_enabled()):
        emb = bundle.video_model(
            videos, deterministic=deterministic or cfg.video_freeze_ratio >= 1.0,
            generator=generator)
    if cfg.hierarchical_tokens:
        B, N = videos.shape[:2]
        emb = emb.reshape(B, N, emb.shape[1] // N, emb.shape[-1])
    outputs = bundle.mil_model(emb, mask=batch.get("video_mask"),
                               view_ids=batch.get("view_ids"),
                               deterministic=deterministic, generator=generator)
    return outputs, emb


def global_outputs(outputs, batch):
    """``(outputs, targets, sample_mask)`` of the global batch: under data
    parallelism each is gathered over the ranks (differentiably), in
    global order; with one rank they are this batch's own."""
    mask = batch.get("sample_mask")
    return ({h: gather_rows(o) for h, o in outputs.items()},
            {h: gather_rows(t) for h, t in batch["targets"].items()},
            None if mask is None else gather_rows(mask))


def _losses(bundle: ProbeBundle, outputs, batch):
    """The head losses of the global batch, and its gathered outputs."""
    cfg = bundle.config
    outputs, targets, mask = global_outputs(outputs, batch)
    return multi_head_loss(outputs, targets, dict(cfg.loss_structure),
                           head_weights=dict(cfg.head_weights),
                           sample_mask=mask), outputs


def probe_loss_and_grads(bundle: ProbeBundle, params, batch, generator=None,
                         encoder_freeze_ratio: float = 1.0):
    """``(head losses, gradients, keep)`` of the train step: ``keep`` maps
    each encoder leaf to whether the ratio leaves it trainable; a fully
    frozen encoder runs without a graph and gets zero gradients; averaged
    over the ranks under data parallelism."""
    pre = "video_encoder."
    names = list(params)
    keep = {pre + k: v for k, v in optim_lib.freeze_keep(
        bundle.video_fracs, encoder_freeze_ratio).items()}
    encoder_grad = any(keep.values())
    outputs, _ = forward_heads(bundle, batch, generator, deterministic=False,
                               encoder_grad=encoder_grad)
    losses, _ = _losses(bundle, outputs, batch)
    wanted = [n for n in names if params[n].requires_grad
              and (encoder_grad or not n.startswith(pre))]
    return losses, optim_lib.loss_grads(losses["main"], params, wanted), keep


def make_probe_train_step(bundle: ProbeBundle):
    """The train step.

    signature: ``(state, batch, generator, encoder_freeze_ratio) -> (state,
    metrics)``. ``generator`` is the ``torch.Generator`` (on the bundle's
    device) the dropout masks are drawn from; the ratio is a Python number.
    Metrics (``loss``, ``lr``, ``grad_norm``, ``loss_<head>``) are tensors
    on the device: reading one is the only time the host waits.
    """
    def step(state: TrainState, batch, generator=None, encoder_freeze_ratio=1.0):
        params = state.params
        _check_own_params(bundle, params)
        names = list(params)
        losses, grads, keep = probe_loss_and_grads(bundle, params, batch, generator,
                                                   encoder_freeze_ratio)
        loss = losses["main"]

        with torch.no_grad():
            # mask the gradients before the update (no moment builds up on a
            # frozen leaf) and the updates after it (no weight decay either)
            frozen = {n for n, k in keep.items() if not k}
            for n in frozen:
                grads[n].zero_()
            gate = optim_lib.finite_gate(loss)
            updates = bundle.tx.update(grads, state.opt_state, params, gate)
            moving = [n for n in names if n not in frozen]
            torch._foreach_add_([params[n] for n in moving],
                                [updates[n] for n in moving])
            metrics = {"loss": loss.detach(),
                       "lr": bundle.schedule(state.step),
                       "grad_norm": optim_lib.global_norm(grads)}
            metrics.update({f"loss_{h}": losses[h].detach() for h in bundle.head_names})
        return state.replace(step=state.step + 1), metrics

    return step


def make_probe_eval_step(bundle: ProbeBundle):
    """Deterministic forward: ``{"outputs", "loss", "embeddings"}``, the
    outputs and the loss the global batch's (gathered under data
    parallelism, padding rows included), the embeddings this rank's.
    ``params`` must be the bundle's own parameters (``state.params``)."""

    @torch.no_grad()
    def step(params: Dict[str, torch.Tensor], batch):
        _check_own_params(bundle, params)
        outputs, emb = forward_heads(bundle, batch, deterministic=True)
        losses, outputs = _losses(bundle, outputs, batch)
        return {"outputs": outputs, "loss": losses["main"], "embeddings": emb}

    return step
