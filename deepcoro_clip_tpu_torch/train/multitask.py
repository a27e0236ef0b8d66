"""Multitask (contrastive + captioning + MVM) training step assembly.

Port of the JAX package's ``train/multitask.py``: a shared
``VideoEncoder`` and ``TextEncoder``, the ``CaptioningDecoder`` and
``MaskedVideoModeling``, trained jointly with per-task rates and scheduled
loss weights. One backbone pass (``VideoEncoder.features``) feeds every
task. bf16 compute, fp32 parameters, no gradient scaler.

The training dict is flat, with the top-level keys of the JAX tree:
``video_encoder.*``, ``text_encoder.*``, ``decoder.*``, ``mvm.*`` and
``log_temp``. The optimizer has the JAX bundle's five labelled groups
(``video``, ``text``, ``captioning``, ``mvm``, ``scalar``), each clipped by
its own global norm (``max_grad_norm or 1.0``) before its AdamW, under
``MultiSteps`` with gradient accumulation.

Random draws (dropout, the MVM mask, scheduled sampling) come from the
``torch.Generator`` a step is handed; the JAX step derives them from its
``rng`` (the MVM mask from ``fold_in(rng, 1)``), so the masks differ between
the packages while the arithmetic on a given mask does not. A step may be
handed the MVM mask (``mvm_mask``) instead. The eval forward draws nothing
but the MVM mask, from a generator seeded 0 at each call, as the JAX runner
hands every validation batch ``PRNGKey(0)``.

Under data parallelism (``parallel/distributed.py``) a rank holds its rows
of the global batch: the contrastive term runs on the gathered embeddings,
the captioning, LocCa, MVM and consistency means divide by the global
batch's counts, and the gradients are averaged over the ranks before the
freeze masks and the update.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from deepcoro_clip_tpu_torch.convert import MULTITASK_MODELS
from deepcoro_clip_tpu_torch.device import resolve_device
from deepcoro_clip_tpu_torch.losses.contrastive import clip_loss
from deepcoro_clip_tpu_torch.losses.locca import locca_combined_loss
from deepcoro_clip_tpu_torch.losses.multitask import captioning_loss
from deepcoro_clip_tpu_torch.models.captioning_decoder import CaptioningDecoder
from deepcoro_clip_tpu_torch.models.layers import shard_layers
from deepcoro_clip_tpu_torch.models.masked_video_modeling import (
    MaskedVideoModeling,
    random_token_mask,
)
from deepcoro_clip_tpu_torch.models.text_encoder import text_encoder_from_config
from deepcoro_clip_tpu_torch.models.video_encoder import (
    clip_token_count,
    init_params,
    video_encoder_from_config,
)
from deepcoro_clip_tpu_torch.parallel import distributed
from deepcoro_clip_tpu_torch.parallel.distributed import gather_rows, global_ratio
from deepcoro_clip_tpu_torch.train import optim as optim_lib
from deepcoro_clip_tpu_torch.train.schedulers import get_scheduler
from deepcoro_clip_tpu_torch.train.state import TrainState

GROUPS = {"video_encoder": "video", "text_encoder": "text", "decoder": "captioning",
          "mvm": "mvm"}


class MultitaskBundle(NamedTuple):
    config: Any
    device: torch.device
    video_model: Any
    text_model: Any
    decoder: Any
    mvm: Any
    tx: Any               # optim.GroupedOptimizer or optim.MultiSteps
    schedule: Callable
    video_fracs: Dict[str, float]   # freeze-order fractions per leaf
    text_fracs: Dict[str, float]


def multitask_params(video_model, text_model, decoder, mvm, log_temp
                     ) -> Dict[str, torch.Tensor]:
    """The flat training dict over the models' own parameters."""
    params = {}
    for tower, model in zip(MULTITASK_MODELS, (video_model, text_model, decoder, mvm)):
        params.update({f"{tower}.{k}": p for k, p in model.named_parameters()})
    params["log_temp"] = log_temp
    return params


def build_multitask_bundle(config, seed: int = 0, steps_per_epoch: int = 100,
                           device: Optional[str] = None
                           ) -> Tuple[MultitaskBundle, TrainState]:
    """The four models with seeded random weights, the optimizer and the
    initial ``TrainState`` on ``device`` (CUDA unless the caller passes
    ``"cpu"``). A ``mesh_model`` above 1 under a process group cuts the
    layers of the four over the grid's model axis after the seeded init
    (``models/layers.shard_layers``)."""
    cfg = config
    dev = resolve_device(device)
    dtype = torch.bfloat16 if cfg.precision == "bf16" else torch.float32
    video_model = init_params(video_encoder_from_config(cfg), seed)
    text_model = init_params(text_encoder_from_config(cfg), seed + 1)
    decoder = init_params(CaptioningDecoder(
        vocab_size=cfg.text_vocab_size, dim=cfg.decoder_dim, depth=cfg.decoder_depth,
        num_heads=cfg.decoder_heads, max_length=cfg.decoder_max_length,
        memory_dim=cfg.embedding_dim, dropout=cfg.dropout, dtype=dtype,
        use_flash=cfg.use_pallas_attention), seed + 2)
    mvm = init_params(MaskedVideoModeling(
        dim=cfg.embedding_dim, num_tokens=clip_token_count(cfg),
        decoder_dim=cfg.mvm_decoder_dim, decoder_depth=cfg.mvm_decoder_depth,
        num_heads=cfg.num_heads, mask_ratio=cfg.mask_ratio,
        norm_targets=cfg.mvm_norm_targets, dtype=dtype, use_flash=False), seed + 3)
    tp = distributed.tensor_parallel_grid(cfg.mesh_model)
    for m in (video_model, text_model, decoder, mvm):
        if tp is not None:
            shard_layers(m, tp)
        m.to(dev)
    log_temp = torch.nn.Parameter(torch.tensor(
        math.log(cfg.temperature), dtype=torch.float32, device=dev))
    params = multitask_params(video_model, text_model, decoder, mvm, log_temp)

    schedule = get_scheduler(
        cfg.scheduler_name, cfg.lr, steps_per_epoch, cfg.epochs,
        num_warmup_percent=cfg.num_warmup_percent, factor=cfg.factor,
        lr_step_period=cfg.lr_step_period,
        gradient_accumulation_steps=cfg.gradient_accumulation_steps,
    )
    clip = cfg.max_grad_norm or 1.0

    def rate(lr_value):
        return lr_value / max(cfg.lr, 1e-12)

    hyper = {
        "video": (rate(cfg.lr), cfg.video_weight_decay, clip),
        "text": (rate(cfg.text_lr), cfg.text_weight_decay, clip),
        "captioning": (rate(cfg.captioning_lr), cfg.video_weight_decay, clip),
        "mvm": (rate(cfg.mvm_lr), cfg.video_weight_decay, clip),
        "scalar": (rate(cfg.lr), 0.0, clip),
    }
    labels = {n: GROUPS.get(n.split(".", 1)[0], "scalar") for n in params}
    tx = optim_lib.GroupedOptimizer("adamw", schedule, hyper, labels)
    if cfg.gradient_accumulation_steps > 1:
        tx = optim_lib.MultiSteps(tx, cfg.gradient_accumulation_steps)
    state = TrainState(step=0, params=params, opt_state=tx.init(params))
    bundle = MultitaskBundle(
        config=cfg, device=dev, video_model=video_model, text_model=text_model,
        decoder=decoder, mvm=mvm, tx=tx, schedule=schedule,
        video_fracs=optim_lib.freeze_fractions(
            optim_lib.tower_params(params, "video_encoder"), include=("backbone",)),
        text_fracs=optim_lib.freeze_fractions(
            optim_lib.tower_params(params, "text_encoder"), exclude=("proj",)),
    )
    return bundle, state


def _normalize(x):
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(1e-8)


def multitask_forward(bundle: MultitaskBundle, log_temp, batch,
                      generator: Optional[torch.Generator] = None,
                      deterministic: bool = False, ss_prob: Optional[float] = None,
                      mvm_mask: Optional[torch.Tensor] = None) -> Dict[str, Any]:
    """Every task loss from one backbone pass.

    ``log_temp``: the contrastive temperature's log (a step may pin it).
    ``ss_prob`` (training only): with scheduled sampling on in the config,
    the decoder runs a second pass whose inputs at t > 0 are its own
    first-pass predictions with this probability (targets stay gold).
    ``mvm_mask``: ``[B*N, L]`` bool, True = masked; None draws it from
    ``generator``."""
    cfg = bundle.config
    videos = batch["videos"]
    feats = bundle.video_model.features(videos, video_mask=batch.get("video_mask"),
                                        deterministic=deterministic, generator=generator)
    B, N, L, D = feats["tokens"].shape
    t_emb = bundle.text_model(batch["input_ids"], attention_mask=batch["attention_mask"],
                              deterministic=deterministic, generator=generator)
    sample_mask = batch.get("sample_mask")
    # the contrastive term over the global batch (gathered embeddings); the
    # token and patch means below divide by the global batch's counts
    contrastive = clip_loss(gather_rows(torch.nan_to_num(feats["study"])),
                            gather_rows(torch.nan_to_num(t_emb)), log_temp,
                            label_smoothing=cfg.label_smoothing,
                            sample_mask=None if sample_mask is None
                            else gather_rows(sample_mask))

    toks_flat = feats["tokens"].reshape(B, N * L, D)
    cap_ids = batch["caption_ids"]
    cap_mask = batch.get("caption_mask")
    logits = bundle.decoder(cap_ids, toks_flat, attention_mask=cap_mask,
                            deterministic=deterministic, generator=generator)
    if ss_prob is not None and not deterministic and cfg.scheduled_sampling_prob > 0:
        # two-pass parallel scheduled sampling: the first pass's next-token
        # predictions replace gold inputs with probability ss_prob; BOS and
        # the targets stay gold
        with torch.no_grad():
            preds = logits.argmax(dim=-1).to(cap_ids.dtype)
            prev_pred = torch.cat([cap_ids[:, :1], preds[:, :-1]], dim=1)
            mix = torch.rand(cap_ids.shape, generator=generator,
                             device=cap_ids.device) < ss_prob
            mix[:, 0] = False
            mixed_ids = torch.where(mix, prev_pred, cap_ids)
        logits = bundle.decoder(mixed_ids, toks_flat, attention_mask=cap_mask,
                                deterministic=deterministic, generator=generator)
    cap_weights = batch.get("caption_weights")
    if sample_mask is not None:
        cap_weights = (cap_weights if cap_weights is not None else 1.0) * sample_mask
    locca_parts: Dict[str, torch.Tensor] = {}
    if cfg.locca_enabled and "location_mask" in batch:
        locca_parts = locca_combined_loss(
            logits, cap_ids, cap_mask, location_mask=batch["location_mask"],
            weights=(dict(cfg.locca_task_weights) if cfg.locca_task_weights
                     else {"captioning": 1.0, "referring": cfg.locca_weight,
                           "grounded": cfg.locca_weight}),
            label_smoothing=cfg.caption_label_smoothing, sample_weights=cap_weights)
        cap_loss = locca_parts.pop("total")
    else:
        cap_loss = captioning_loss(logits, cap_ids, cap_mask,
                                   label_smoothing=cfg.caption_label_smoothing,
                                   sample_weights=cap_weights)

    clip_toks = feats["tokens"].reshape(B * N, L, D)
    tok_mask = (mvm_mask if mvm_mask is not None else
                random_token_mask(generator, B * N, L, cfg.mask_ratio, clip_toks.device))
    if sample_mask is not None:
        # padded (duplicate) rows stay out of the masked-MSE average
        tok_mask = tok_mask & sample_mask.bool().repeat_interleave(N)[:, None]
    mvm_out = bundle.mvm(clip_toks, tok_mask, deterministic=deterministic,
                         generator=generator)

    if cfg.multi_video and cfg.consistency_weight > 0 and N > 1:
        # the study embedding stays close to the aggregator's output on the
        # first view alone (always a real clip)
        single = bundle.video_model.aggregate(
            feats["video"][:, :1], deterministic=deterministic,
            generator=generator).float()
        cos = (_normalize(feats["study"].float()) * _normalize(single)).sum(-1)
        if sample_mask is not None:
            sm = sample_mask.float()
            consistency = global_ratio(((1.0 - cos) * sm).sum(), sm.sum())
        else:
            consistency = (1.0 - cos).mean()
    else:
        consistency = torch.zeros((), device=logits.device)

    return {
        "contrastive": contrastive["loss"],
        "captioning": cap_loss,
        "mvm": mvm_out["loss"],
        "consistency": consistency,
        "temperature": contrastive["temperature"],
        "video_emb": feats["study"],
        "text_emb": t_emb,
        "caption_logits": logits,
        # the validation pass generates captions from these: one backbone
        # pass per batch
        "video_tokens": toks_flat,
        **{f"locca_{k}": v for k, v in locca_parts.items()},
    }


def multitask_loss_and_grads(bundle: MultitaskBundle, params, batch, log_temp,
                             generator=None, w_con=1.0, w_cap=1.0, w_mvm=1.0,
                             ss_prob=None, mvm_mask=None):
    """``(multitask_forward's outputs, weighted loss, gradients)`` of the
    train step: zeros for a leaf the loss does not reach (``log_temp`` when
    pinned), non-finite entries zeroed, averaged over the ranks under data
    parallelism."""
    cfg = bundle.config
    out = multitask_forward(bundle, log_temp, batch, generator, deterministic=False,
                            ss_prob=ss_prob, mvm_mask=mvm_mask)
    loss = (w_con * out["contrastive"] + w_cap * out["captioning"]
            + w_mvm * out["mvm"] + cfg.consistency_weight * out["consistency"])
    wanted = [n for n, p in params.items() if p.requires_grad]
    return out, loss, optim_lib.loss_grads(loss, params, wanted)


def make_multitask_train_step(bundle: MultitaskBundle):
    """The train step.

    signature: ``(state, batch, generator, w_con, w_cap, w_mvm,
    video_freeze_ratio, text_freeze_ratio, temp_override, mvm_mask=None)
    -> (state, metrics)``, the JAX step's arguments in its order with the
    ``torch.Generator`` (on the bundle's device) in place of its ``rng``.
    ``temp_override`` < 0 keeps the learnable temperature, otherwise
    log_temp is pinned to log(override). The state's parameters and
    moments are updated in place; metrics are tensors on the device.
    """
    cfg = bundle.config

    def step(state: TrainState, batch, generator=None, w_con=1.0, w_cap=1.0, w_mvm=1.0,
             video_freeze_ratio=0.0, text_freeze_ratio=0.0, temp_override=-1.0,
             mvm_mask=None):
        params = state.params
        names = list(params)
        ss_prob = None
        if cfg.scheduled_sampling_prob > 0:
            warm = max(1, int(cfg.scheduled_sampling_warmup_steps))
            ramp = min(state.step / warm, 1.0)
            ss_prob = cfg.scheduled_sampling_prob * (
                ramp if cfg.scheduled_sampling_warmup_steps > 0 else 1.0)
        pinned = temp_override > 0
        log_temp = (torch.full_like(params["log_temp"], math.log(max(temp_override, 1e-6)))
                    if pinned else params["log_temp"])
        out, loss, grads = multitask_loss_and_grads(
            bundle, params, batch, log_temp, generator, w_con, w_cap, w_mvm,
            ss_prob=ss_prob, mvm_mask=mvm_mask)

        with torch.no_grad():
            # dynamic partial freeze: gradients masked before the update (no
            # moments for frozen leaves), updates after it (no weight decay)
            keep = optim_lib.towers_keep({
                "video_encoder": (bundle.video_fracs, video_freeze_ratio),
                "text_encoder": (bundle.text_fracs, text_freeze_ratio)})
            for n, k in keep.items():
                if not k:
                    grads[n].zero_()
            gate = optim_lib.finite_gate(loss)
            updates = bundle.tx.update(grads, state.opt_state, params, gate)
            still = {n for n, k in keep.items() if not k}
            if pinned:
                still.add("log_temp")
            moving = [n for n in names if n not in still]
            torch._foreach_add_([params[n] for n in moving], [updates[n] for n in moving])
            metrics = {
                "loss": loss.detach(),
                "loss_contrastive": out["contrastive"].detach(),
                "loss_captioning": out["captioning"].detach(),
                "loss_mvm": out["mvm"].detach(),
                "loss_consistency": out["consistency"].detach(),
                "temperature": out["temperature"].detach(),
                "lr": bundle.schedule(optim_lib.optimizer_step_count(
                    state.opt_state, state.step)),
            }
            if ss_prob is not None:
                metrics["ss_prob"] = ss_prob
        return state.replace(step=state.step + 1), metrics

    return step


def make_multitask_eval_step(bundle: MultitaskBundle):
    """The deterministic forward of a validation batch; the MVM mask comes
    from a generator seeded 0 at every call."""

    @torch.no_grad()
    def step(params: Dict[str, torch.Tensor], batch):
        gen = torch.Generator(device=bundle.device).manual_seed(0)
        return multitask_forward(bundle, params["log_temp"], batch, gen,
                                 deterministic=True)

    return step
