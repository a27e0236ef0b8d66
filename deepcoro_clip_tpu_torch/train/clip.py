"""Contrastive (CLIP) training step assembly.

Port of the JAX package's ``train/clip.py``: video and text forward, the
batch contrastive loss, backward (through the CUDA attention kernels), the
per-group optimizer update with dynamic freeze masks. bf16 compute, fp32
parameters, no gradient scaler. Under data parallelism
(``parallel/distributed.py``) a rank holds its data index's rows of the
global batch, the loss is the global batch's and the gradients are
averaged over the data group before the freeze masks, the non-finite gate
and the clipping, so every rank takes the same update. With
``use_ring_attention`` under a process group the backbone's ring runs
across the ranks of each model group, which hold the same rows; without
it a ``mesh_model`` above 1 cuts every attention's heads and every MLP's
hidden width over the model group (tensor parallelism,
``models/layers.shard_layers``).

The loss is picked by ``loss_name`` as in the JAX module: the CLIP
losses, ``siglip`` (pairwise over the batch, with the learnable
``logit_bias``) and the multi-positive family (``MULTI_POSITIVE_LOSSES``),
which scores each video against the batch's bank of unique texts
(``positive_mask``, ``positive_weights``, ``text_valid`` from
``data/collate.collate_multi_positive``).

With ``locca_enabled`` the bundle carries the LocCa head
(``models/locca_decoder.LocCaDecoder``, the training tree's
``locca_decoder``): a batch with ``caption_ids`` takes one backbone pass
(``VideoEncoder.features``) for the study embedding and the unpooled
tokens, the decoder generates the batch's report from the tokens, and
``locca_weight`` times its ``locca_combined_loss`` joins the contrastive
loss ("relative to the SigLIP loss", as the JAX module weighs it). Its
parameters take the optimizer's ``video`` group, as in the JAX package,
and no freeze ratio masks them.

A step updates the state it is given in place (parameters, moments, counts)
and returns it with ``step + 1``; PyTorch runs it eagerly, so
``make_train_step`` returns a plain function.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple, Union

import torch

from deepcoro_clip_tpu_torch.device import resolve_device
from deepcoro_clip_tpu_torch.losses import contrastive as closs
from deepcoro_clip_tpu_torch.losses.locca import locca_combined_loss
from deepcoro_clip_tpu_torch.models.layers import shard_layers
from deepcoro_clip_tpu_torch.models.locca_decoder import (
    init_locca_decoder,
    locca_decoder_from_config,
)
from deepcoro_clip_tpu_torch.models.text_encoder import text_encoder_from_config
from deepcoro_clip_tpu_torch.models.video_encoder import (
    init_params,
    video_encoder_from_config,
)
from deepcoro_clip_tpu_torch.parallel import distributed
from deepcoro_clip_tpu_torch.parallel.distributed import gather_rows
from deepcoro_clip_tpu_torch.parallel.mesh import Mesh, MeshSpec, ProcessMesh, make_mesh
from deepcoro_clip_tpu_torch.registry import LossRegistry
from deepcoro_clip_tpu_torch.train import optim as optim_lib
from deepcoro_clip_tpu_torch.train.schedulers import get_scheduler
from deepcoro_clip_tpu_torch.train.state import TrainState

MULTI_POSITIVE_LOSSES = {
    "siglip_pairwise", "siglip2_bce", "siglip2_bce_ddp",
    "siglip2_multi_positive", "siglip_pairwise_ddp", "weighted_siglip",
    "multi_positive_infonce", "siglip_single_head",
}
CLIP_LOSSES = {"contrastive", "clip", "contrastive_ddp", "infonce_loss",
               "infonce_loss_ddp", "infonce"}
SIGLIP_LOSSES = {"siglip", "siglip_ddp"}
# the per-row masks the loss reads, gathered over the ranks with the
# embeddings
ROW_KEYS = ("sample_mask", "positive_mask", "positive_weights")


class ClipBundle(NamedTuple):
    """Everything static needed to run contrastive training."""

    config: Any
    device: torch.device
    video_model: Any
    text_model: Any
    tx: Any               # optim.ClipOptimizer or optim.MultiSteps
    schedule: Callable
    video_fracs: Dict[str, float]   # freeze-order fractions per leaf
    text_fracs: Dict[str, float]
    # the LocCa head; None unless config.locca_enabled
    locca_decoder: Any = None


def is_multi_positive(config) -> bool:
    """The loss scores each video against a bank of texts."""
    return config.loss_name.lower() in MULTI_POSITIVE_LOSSES


def replicated_keys(config) -> tuple:
    """The batch keys every rank holds whole (the JAX bundle's
    ``batch_sharding_fn``): the multi-positive bank and its ``text_valid``."""
    if is_multi_positive(config):
        return ("input_ids", "attention_mask", "text_valid")
    return ("text_valid",)


def _check_loss_name(config) -> None:
    name = config.loss_name.lower()
    if name not in CLIP_LOSSES | SIGLIP_LOSSES | MULTI_POSITIVE_LOSSES:
        raise ValueError(f"unknown loss_name {config.loss_name!r}")


def training_params(video_model, text_model, log_temp, logit_bias, locca_decoder=None
                    ) -> Dict[str, torch.Tensor]:
    """The flat training dict over the models' own parameters."""
    params = {f"video_encoder.{k}": p for k, p in video_model.named_parameters()}
    params.update({f"text_encoder.{k}": p for k, p in text_model.named_parameters()})
    params["log_temp"] = log_temp
    params["logit_bias"] = logit_bias
    if locca_decoder is not None:
        params.update({f"locca_decoder.{k}": p
                       for k, p in locca_decoder.named_parameters()})
    return params


def build_clip_bundle(config, seed: int = 0, steps_per_epoch: int = 100,
                      device: Optional[str] = None,
                      mesh: Optional[Union[Mesh, ProcessMesh]] = None
                      ) -> Tuple[ClipBundle, TrainState]:
    """Build the models with seeded random weights, the optimizer and the
    initial ``TrainState`` on ``device`` (CUDA unless the caller passes
    ``"cpu"``).

    With ``config.use_ring_attention`` the video backbone's attention runs
    as ring attention over ``mesh``: by default, where a process group runs,
    its ``(data, model)`` grid of ranks with ``config.mesh_model`` ranks a
    model group (``distributed.init_grid``; each rank takes its chunk of the
    tokens), else ``make_mesh(MeshSpec(config.mesh_data, config.mesh_model))``
    over the visible cards, or over ``device`` alone on the CPU (too few
    devices raise). A caller may pass a mesh whose device list repeats a
    device. Without the ring, ``config.mesh_model`` above 1 under a process
    group cuts the layers over the grid's model axis after the seeded init
    (the weights are the one-process run's, each rank keeping its part).
    With ``config.locca_enabled``
    the LocCa head is built over the video tower's ``embedding_dim`` tokens,
    with the token grid of ``locca_token_grid``."""
    _check_loss_name(config)
    dev = resolve_device(device)
    ring_mesh = None
    if config.use_ring_attention:
        ring_mesh = mesh
        if ring_mesh is None and distributed.is_active():
            ring_mesh = distributed.init_grid(config.mesh_model)
        elif ring_mesh is None:
            ring_mesh = make_mesh(MeshSpec(config.mesh_data, config.mesh_model),
                                  devices=[dev] if dev.type == "cpu" else None)
    tp = distributed.tensor_parallel_grid(config.mesh_model, config.use_ring_attention)
    video_model = init_params(video_encoder_from_config(config, ring_mesh=ring_mesh), seed)
    text_model = init_params(text_encoder_from_config(config), seed + 1)
    # learnable temperature and the SigLIP bias (read by the SigLIP losses;
    # unused by clip_loss, kept in the tree as in the JAX package)
    log_temp = torch.nn.Parameter(torch.tensor(
        math.log(config.temperature), dtype=torch.float32, device=dev))
    logit_bias = torch.nn.Parameter(torch.tensor(
        float(config.siglip_bias_init), dtype=torch.float32, device=dev))
    locca_decoder = None
    if config.locca_enabled:
        locca_decoder = init_locca_decoder(
            locca_decoder_from_config(config, memory_dim=config.embedding_dim), seed + 2)
    for m in (video_model, text_model, locca_decoder):
        if m is not None:
            if tp is not None:
                shard_layers(m, tp)
            m.to(dev)
    params = training_params(video_model, text_model, log_temp, logit_bias, locca_decoder)

    schedule = get_scheduler(
        config.scheduler_name, config.lr, steps_per_epoch, config.epochs,
        num_warmup_percent=config.num_warmup_percent,
        factor=config.factor,
        lr_step_period=config.lr_step_period,
        num_hard_restarts_cycles=config.num_hard_restarts_cycles,
        warm_restart_tmult=config.warm_restart_tmult,
        gradient_accumulation_steps=config.gradient_accumulation_steps,
    )
    tx = optim_lib.make_clip_optimizer(config, schedule, params)
    if config.gradient_accumulation_steps > 1:
        # the contrastive matrix spans each micro-batch only, as in the
        # JAX package
        tx = optim_lib.MultiSteps(tx, config.gradient_accumulation_steps)
    state = TrainState(step=0, params=params, opt_state=tx.init(params))

    # only the backbone (video) / the BERT body (text) is partially
    # freezable, never proj, aggregator or pools
    bundle = ClipBundle(
        config=config, device=dev, video_model=video_model, text_model=text_model,
        tx=tx, schedule=schedule,
        video_fracs=optim_lib.freeze_fractions(
            optim_lib.tower_params(params, "video_encoder"), include=("backbone",)),
        text_fracs=optim_lib.freeze_fractions(
            optim_lib.tower_params(params, "text_encoder"), exclude=("proj",)),
        locca_decoder=locca_decoder,
    )
    return bundle, state


def to_device_batch(bundle: ClipBundle, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A host batch (numpy arrays or tensors) onto the bundle's device."""
    return {k: torch.as_tensor(v).to(bundle.device) for k, v in batch.items()}


def _forward_embeddings(bundle: ClipBundle, batch, generator, deterministic):
    """(v_emb, t_emb, tokens); ``tokens`` ``[B, N*L, D]`` is None unless the
    LocCa head reads the unpooled video tokens (one backbone pass either
    way). Float batches come normalized from the host; integer (uint8)
    batches go raw into the model, whose patchify folds the dataset
    statistics into its weights."""
    tokens = None
    if bundle.locca_decoder is not None and "caption_ids" in batch:
        feats = bundle.video_model.features(batch["videos"],
                                            video_mask=batch.get("video_mask"),
                                            deterministic=deterministic, generator=generator)
        v_emb = feats["study"]
        B, N, L, D = feats["tokens"].shape
        tokens = feats["tokens"].reshape(B, N * L, D)
    else:
        v_emb = bundle.video_model(batch["videos"], video_mask=batch.get("video_mask"),
                                   deterministic=deterministic, generator=generator)
    t_emb = bundle.text_model(batch["input_ids"],
                              attention_mask=batch["attention_mask"],
                              deterministic=deterministic, generator=generator)
    return v_emb, t_emb, tokens


def compute_loss(bundle: ClipBundle, log_temp, batch, generator=None,
                 deterministic: bool = False, logit_bias=None) -> Dict[str, torch.Tensor]:
    """Forward both towers and the configured loss. The models read their
    own parameters; ``log_temp`` is passed so that a step can pin it, and
    ``logit_bias`` (the SigLIP losses') is the model's own scalar. With the
    LocCa head and ``caption_ids`` in the batch, ``locca_loss`` is its
    combined loss and ``loss`` adds ``locca_weight`` times it.

    Under data parallelism (``parallel/distributed.py``) ``batch`` holds this
    rank's rows; the loss is the global batch's, the same on every rank, and
    ``video_emb``, ``text_emb`` and the row masks of ``ROW_KEYS`` come out
    gathered, in global order."""
    cfg = bundle.config
    name = cfg.loss_name.lower()
    v_emb, t_emb, tokens = _forward_embeddings(bundle, batch, generator, deterministic)
    v_emb = torch.nan_to_num(v_emb)
    t_emb = torch.nan_to_num(t_emb)
    local_mask = batch.get("sample_mask")
    # the loss of the global batch: under data parallelism every rank
    # gathers the others' embeddings and per-row masks (the multi-positive
    # bank is replicated: every rank encodes it whole)
    v_emb = gather_rows(v_emb)
    if name not in MULTI_POSITIVE_LOSSES:
        t_emb = gather_rows(t_emb)
    rows = {k: gather_rows(batch[k]) for k in ROW_KEYS if k in batch}
    sample_mask = rows.get("sample_mask")
    if name == "multi_positive_infonce":
        out = closs.multi_positive_infonce_loss(
            v_emb, t_emb, rows["positive_mask"], log_temp,
            positive_weights=rows.get("positive_weights"),
            text_valid=batch.get("text_valid"), sample_mask=sample_mask)
    elif name in MULTI_POSITIVE_LOSSES:
        out = LossRegistry.get(name)(
            v_emb, t_emb, positive_mask=rows["positive_mask"], log_temp=log_temp,
            bias=logit_bias, positive_weights=rows.get("positive_weights"),
            text_valid=batch.get("text_valid"),
            positive_loss_weight=cfg.siglip_positive_loss_weight,
            negative_loss_weight=cfg.siglip_negative_loss_weight,
            logit_clamp=cfg.siglip_logit_clamp,
            entropy_reg_weight=cfg.siglip_entropy_reg_weight,
            auto_balance=cfg.siglip_auto_balance, sample_mask=sample_mask)
    elif name in SIGLIP_LOSSES:
        out = closs.siglip_pairwise_loss(v_emb, t_emb, log_temp, logit_bias,
                                         logit_clamp=cfg.siglip_logit_clamp,
                                         sample_mask=sample_mask)
    else:
        out = closs.clip_loss(v_emb, t_emb, log_temp, label_smoothing=cfg.label_smoothing,
                              sample_mask=sample_mask)
    if tokens is not None:
        # on this rank's rows; the token means are the global batch's
        logits = bundle.locca_decoder(batch["caption_ids"], tokens,
                                      attention_mask=batch.get("caption_mask"),
                                      deterministic=deterministic, generator=generator)
        locca = locca_combined_loss(
            logits, batch["caption_ids"], batch["caption_mask"],
            location_mask=batch.get("location_mask"),
            weights=dict(cfg.locca_task_weights) if cfg.locca_task_weights else None,
            label_smoothing=cfg.label_smoothing, sample_weights=local_mask)
        out["locca_loss"] = locca["total"]
        out["loss"] = out["loss"] + cfg.locca_weight * locca["total"]
    out["video_emb"] = v_emb
    out["text_emb"] = t_emb
    out.update(rows)
    return out


def alignment_score(v_emb, t_emb, positive_mask=None, sample_mask=None):
    """Mean matched-pair cosine similarity. Paired mode: the mean of the
    diagonal. Multi-positive mode (``positive_mask`` ``[B, M]`` given): the
    mean video-text cosine over each video's positives; ``sample_mask``
    excludes padding rows."""
    v = closs.l2_normalize(v_emb)
    t = closs.l2_normalize(t_emb)
    if positive_mask is None:
        n = min(v.shape[0], t.shape[0])
        diag = (v[:n] * t[:n]).sum(dim=-1)
        if sample_mask is None:
            return diag.mean()
        m = sample_mask.float()[:n]
        return (diag * m).sum() / m.sum().clamp_min(1.0)
    pos = positive_mask.float()
    if sample_mask is not None:
        pos = pos * sample_mask.float()[:, None]
    return ((v @ t.T) * pos).sum() / pos.sum().clamp_min(1.0)


def loss_and_grads(bundle: ClipBundle, params: Dict[str, torch.Tensor], batch,
                   generator=None, temp_override: float = -1.0):
    """``(compute_loss's outputs, gradients)`` of the train step: every
    parameter gets a gradient (zeros where the loss does not read it:
    ``logit_bias`` under ``clip_loss``, ``log_temp`` when ``temp_override``
    pins it), non-finite entries zeroed, averaged over the ranks under data
    parallelism (the same on every rank)."""
    names = list(params)
    pinned = temp_override > 0
    log_temp = (torch.full_like(params["log_temp"], math.log(max(temp_override, 1e-6)))
                if pinned else params["log_temp"])
    out = compute_loss(bundle, log_temp, batch, generator, deterministic=False,
                       logit_bias=params["logit_bias"])
    wanted = [n for n in names if params[n].requires_grad]
    return out, optim_lib.loss_grads(out["loss"], params, wanted)


def make_train_step(bundle: ClipBundle):
    """The train step.

    signature: ``(state, batch, generator, video_freeze_ratio,
    text_freeze_ratio, temp_override) -> (state, metrics)``. ``generator``
    is the ``torch.Generator`` (on the bundle's device) the dropout masks
    are drawn from. The ratios and ``temp_override`` are Python numbers;
    ``temp_override`` < 0 means "use the learnable temperature", otherwise
    log_temp is pinned to log(override). Metrics are tensors on the device:
    reading one is the only time the host waits. With the LocCa head they
    add ``locca_loss`` (which the JAX step leaves out) and
    ``grad_norm_locca_decoder``.
    """
    multi_positive = is_multi_positive(bundle.config)

    def step(state: TrainState, batch, generator=None, video_freeze_ratio=0.0,
             text_freeze_ratio=0.0, temp_override=-1.0):
        params = state.params
        names = list(params)
        pinned = temp_override > 0
        out, grads = loss_and_grads(bundle, params, batch, generator, temp_override)
        loss = out["loss"]

        with torch.no_grad():
            # dynamic partial freeze: mask the gradients before the update,
            # so the moments accumulate nothing for frozen leaves, then the
            # updates too, so weight decay cannot move them
            keep = optim_lib.towers_keep({
                "video_encoder": (bundle.video_fracs, video_freeze_ratio),
                "text_encoder": (bundle.text_fracs, text_freeze_ratio)})
            for n, k in keep.items():
                if not k:
                    grads[n].zero_()
            gate = optim_lib.finite_gate(loss)
            updates = bundle.tx.update(grads, state.opt_state, params, gate)
            frozen = [n for n, k in keep.items() if not k]
            if pinned:  # pinned temperature: no log_temp learning
                frozen.append("log_temp")
            still = set(frozen)
            moving = [n for n in names if n not in still]
            torch._foreach_add_([params[n] for n in moving],
                                [updates[n] for n in moving])

            towers = {t: [g for n, g in grads.items() if n.startswith(t + ".")]
                      for t in ("video_encoder", "text_encoder", "locca_decoder")}
            # per backbone child (block{i}, pool{s}, patch_embed, cls,
            # norm), under the JAX tree's names, when asked for
            blocks: Dict[str, list] = {}
            if getattr(bundle.config, "log_layer_grad_norms", False):
                for n, g in grads.items():
                    if n.startswith("video_encoder.backbone."):
                        blocks.setdefault(n.split(".")[2], []).append(g)
            metrics = {
                "loss": loss.detach(),
                "temperature": out["temperature"].detach(),
                "alignment": alignment_score(out["video_emb"], out["text_emb"],
                                             positive_mask=(out["positive_mask"]
                                                            if multi_positive else None),
                                             sample_mask=out.get("sample_mask")),
                "grad_norm": optim_lib.global_norm(grads),
                **{f"grad_norm_{t}": optim_lib.global_norm(g)
                   for t, g in towers.items() if g},
                **{f"grad_norm_video_{b}": optim_lib.global_norm(g)
                   for b, g in blocks.items()},
                "video_emb_norm": torch.linalg.vector_norm(
                    out["video_emb"].float(), dim=-1).mean(),
                "text_emb_norm": torch.linalg.vector_norm(
                    out["text_emb"].float(), dim=-1).mean(),
                "lr": bundle.schedule(optim_lib.optimizer_step_count(
                    state.opt_state, state.step)),
            }
            if "locca_loss" in out:
                metrics["locca_loss"] = out["locca_loss"].detach()
        return state.replace(step=state.step + 1), metrics

    return step


def make_eval_step(bundle: ClipBundle):
    """Embedding forward for validation and inference (deterministic); the
    loss includes the LocCa term where the train step's does, and
    ``locca_loss`` comes out beside it."""

    multi_positive = is_multi_positive(bundle.config)

    @torch.no_grad()
    def step(params: Dict[str, torch.Tensor], batch):
        out = compute_loss(bundle, params["log_temp"], batch, deterministic=True,
                           logit_bias=params["logit_bias"])
        extra = {"locca_loss": out["locca_loss"]} if "locca_loss" in out else {}
        return {
            **extra,
            "loss": out["loss"],
            "video_emb": out["video_emb"],
            "text_emb": out["text_emb"],
            "alignment": alignment_score(out["video_emb"], out["text_emb"],
                                         positive_mask=(out["positive_mask"]
                                                        if multi_positive else None),
                                         sample_mask=out.get("sample_mask")),
        }

    return step
