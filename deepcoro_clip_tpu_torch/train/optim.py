"""Optimizer assembly: per-component parameter groups, clipping, freeze masks.

Port of the JAX package's ``train/optim.py`` (and of ``make_probe_optimizer``
of its ``train/linear_probe.py``). Parameters travel as one flat dict
``name -> tensor`` with ``.``-joined names under the top-level keys of the
training tree (``video_encoder.``, ``text_encoder.``, ``log_temp``,
``logit_bias``; for linear probing ``video_encoder.`` and ``mil.``).

What ``optax`` does there and this module does by hand:

- labelled groups as in ``optax.multi_transform`` (``GroupedOptimizer``);
  for the contrastive step four: ``video``, ``video_2x``
  (aggregator and pools, twice the rate), ``text`` (rate scaled by
  ``text_lr / lr``) and ``scalar`` (``log_temp``, ``logit_bias``: no decay,
  no clipping); the global-norm clip sits inside each group, so ``video``
  and ``video_2x`` are clipped apart, each by its own norm;
- AdamW as ``optax.adamw``: b1 0.9, b2 0.999, eps 1e-8 outside the square
  root, the config's weight decay added to the update before the rate, and
  the schedule read at the count *before* the update;
- the non-finite guard (``keep_old_if_nonfinite`` there) is a gate: every
  change to a moment, a count or a parameter is multiplied by
  ``finite_gate(loss)`` (1.0 or 0.0, a tensor on the device), so a blown
  step changes nothing at all and no step waits for the host.

The update works in place on the state it is given, with ``torch._foreach``
calls over each group's tensors.

Under tensor parallelism a parameter cut over the model group
(``model_split``, ``models/layers.Dense.shard_``) holds this rank's part of
the whole leaf, as do its gradient, its moments and its accumulator (the
gradient and the accumulator carry its ``model_split``): ``global_norm``
sums the squares of such parts over the model group and counts the
replicated leaves once, and the freeze fractions count the whole leaf, so
every rank clips, gates and freezes as the one-process run does.
"""

from __future__ import annotations

import re
from typing import Dict, List, Mapping, Optional, Tuple

import torch

from deepcoro_clip_tpu_torch.parallel import distributed
from deepcoro_clip_tpu_torch.parallel.distributed import all_reduce_grads
from deepcoro_clip_tpu_torch.parallel.mesh import MODEL_AXIS

# start-fraction of leaves outside the freezable subtree (proj, aggregator,
# pools): above any (1 - ratio) threshold, so a partial ratio never freezes them
_NEVER_FROZEN = 2.0

# depth order: embeddings / patchify first, numbered blocks next, trailing
# norms last
_BLOCK_PAT = re.compile(r"(?:block|layer)(\d+)")
_EMBED_PAT = re.compile(
    r"patch_embed|word_embeddings|position_embeddings|token_type|embeddings")

# optimizers of the JAX package's table that torch.optim has too, each
# with optax's arithmetic; the rest of the table is not ported
_OPTIMIZERS = ("adamw", "adam", "radam", "sgd")
_NOT_PORTED = ("lamb", "lion", "adafactor")
B1, B2, EPS, SGD_MOMENTUM, RADAM_THRESHOLD = 0.9, 0.999, 1e-8, 0.9, 5.0


def _freeze_order_key(name: str):
    m = _BLOCK_PAT.search(name)
    if m:
        return (1, int(m.group(1)), name)
    if _EMBED_PAT.search(name):
        return (0, 0, name)
    return (2, 0, name)  # final norm etc.: the top of the tower


def freeze_fractions(params: Mapping[str, torch.Tensor],
                     include: Optional[Tuple[str, ...]] = None,
                     exclude: Tuple[str, ...] = ()) -> Dict[str, float]:
    """Per-leaf cumulative start fraction of the freezable parameter count,
    in module order (patch_embed/embeddings -> block0..blockN -> norm).

    ``params`` is one tower's ``name -> tensor`` (names as in its
    ``named_parameters``). ``include`` restricts freezing to top-level
    submodules, ``exclude`` drops some; leaves outside the freezable set get
    ``_NEVER_FROZEN``. Within a module a ``bias`` sorts before its ``weight``
    as it does before the JAX tree's ``kernel``/``scale``, so both packages
    freeze the same leaves at the same ratio.
    """
    named = []
    cut = distributed.grid().shape[MODEL_AXIS]
    for name, t in params.items():
        top = name.split(".", 1)[0]
        freezable = (include is None or top in include) and top not in exclude
        size = t.numel() * (cut if _is_cut(t) else 1)  # the whole leaf's
        named.append((name, name.replace(".", "/"), size, freezable))
    ordered = sorted((n for n in named if n[3]), key=lambda n: _freeze_order_key(n[1]))
    total = sum(n[2] for n in ordered)
    fracs = {n[0]: _NEVER_FROZEN for n in named}
    cum = 0
    for name, _, size, _ in ordered:
        fracs[name] = cum / max(total, 1)
        cum += size
    return fracs


def _is_cut(t: torch.Tensor) -> bool:
    return getattr(t, "model_split", None) is not None


def _same_cut(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t`` marked with ``like``'s ``model_split``, where it has one."""
    if _is_cut(like):
        t.model_split = like.model_split
    return t


def freeze_keep(fracs: Mapping[str, float], ratio: float) -> Dict[str, bool]:
    """Which leaves stay trainable at ``ratio``: ``ratio <= 0`` trains all,
    ``0 < ratio < 1`` keeps the top fraction (a leaf is frozen when its start
    fraction is below ``1 - ratio``), ``ratio >= 1`` freezes the whole
    tower, heads included. Fractions and the threshold compare in fp32."""
    r = torch.tensor(float(ratio), dtype=torch.float32)
    if float(r) >= 1.0:
        return {k: False for k in fracs}
    if float(r) <= 0.0:
        return {k: True for k in fracs}
    thr = torch.tensor(1.0, dtype=torch.float32) - r
    return {k: bool(torch.tensor(f, dtype=torch.float32) >= thr)
            for k, f in fracs.items()}


def tower_params(params: Mapping[str, torch.Tensor], tower: str) -> Dict[str, torch.Tensor]:
    """One tower's leaves of the flat training dict, under their names in
    the tower (the ``tower.`` prefix dropped)."""
    pre = tower + "."
    return {k[len(pre):]: v for k, v in params.items() if k.startswith(pre)}


def towers_keep(fracs_and_ratios: Mapping[str, Tuple[Mapping[str, float], float]]
                ) -> Dict[str, bool]:
    """``freeze_keep`` of several towers of the flat training dict
    (``{tower: (fracs, ratio)}``), under the flat names."""
    return {f"{tower}.{k}": v for tower, (fracs, ratio) in fracs_and_ratios.items()
            for k, v in freeze_keep(fracs, ratio).items()}


def apply_freeze_mask(tree: Mapping[str, torch.Tensor], fracs: Mapping[str, float],
                      ratio: float) -> Dict[str, torch.Tensor]:
    """Zero the leaves that ``ratio`` freezes (others pass through)."""
    keep = freeze_keep(fracs, ratio)
    return {k: (t if keep[k] else torch.zeros_like(t)) for k, t in tree.items()}


def group_label(name: str) -> str:
    top = name.split(".", 1)[0]
    if top == "text_encoder":
        return "text"
    if top in ("log_temp", "logit_bias"):
        return "scalar"
    if "aggregator" in name or ("pool" in name and "patch" not in name):
        return "video_2x"
    return "video"


def loss_grads(loss: torch.Tensor, params: Mapping[str, torch.Tensor],
               wanted) -> Dict[str, torch.Tensor]:
    """The gradient of ``loss`` for every parameter in ``params``: taken for
    the names in ``wanted``, zeros where the loss does not reach a leaf (or
    ``wanted`` leaves it out), non-finite entries zeroed, then averaged over
    the ranks under data parallelism (``parallel/distributed.py``: the same
    on every rank)."""
    got = dict(zip(wanted, torch.autograd.grad(loss, [params[n] for n in wanted],
                                               allow_unused=True)))
    grads = {n: _same_cut(torch.nan_to_num_(got[n]) if got.get(n) is not None
                          else torch.zeros_like(p), p) for n, p in params.items()}
    all_reduce_grads(grads)
    return grads


def finite_gate(loss: torch.Tensor) -> torch.Tensor:
    """1.0 where ``loss`` is finite, else 0.0, as an fp32 tensor on the
    loss's device: the factor on every change an optimizer step makes."""
    return torch.isfinite(loss.detach()).to(torch.float32)


def global_norm(tensors) -> torch.Tensor:
    """L2 norm over all the tensors (a mapping's values or an iterable);
    a tensor cut over the model group (``model_split``) counts with the
    other ranks' parts, the same norm on every rank."""
    ts = list(tensors.values()) if isinstance(tensors, Mapping) else list(tensors)
    if not ts:
        return torch.zeros(())
    if ts[0].device.type == "cpu":
        # the CPU's fp32 norm sums a long tensor serially: 3e-4 off at the
        # LocCa head's [30522, 16] output projection; a float64 sum stays
        # within fp32 rounding, as XLA's pairwise sums do
        norms = torch.stack([torch.linalg.vector_norm(t, dtype=torch.float64) for t in ts])
    else:
        norms = torch.stack(torch._foreach_norm(ts))
    cut = [_is_cut(t) for t in ts]
    if not any(cut):
        return torch.linalg.vector_norm(norms).to(ts[0].dtype)
    squares = norms.square()
    mask = torch.tensor(cut, device=squares.device)
    parts = torch.stack([squares[~mask].sum(), squares[mask].sum()])
    parts[1] = distributed.sum_over_model(parts[1])
    return parts.sum().sqrt().to(ts[0].dtype)


class GroupedOptimizer:
    """One optimizer kind over labelled parameter groups, as
    ``optax.multi_transform`` of per-group ``clip_by_global_norm`` + update
    chains: ``hyper`` maps a label to (rate scale, weight decay, clip norm
    or None), ``labels`` a parameter name to its label."""

    def __init__(self, kind: str, schedule, hyper: Mapping[str, tuple],
                 labels: Mapping[str, str]):
        self.kind, self.schedule, self.hyper = kind, schedule, dict(hyper)
        self.groups: Dict[str, List[str]] = {label: [] for label in self.hyper}
        for name, label in labels.items():
            self.groups[label].append(name)

    def init(self, params: Mapping[str, torch.Tensor]) -> dict:
        device = next(iter(params.values())).device
        state = {"count": torch.zeros((), dtype=torch.int64, device=device),
                 "mu": {k: torch.zeros_like(p) for k, p in params.items()}}
        if self.kind != "sgd":
            state["nu"] = {k: torch.zeros_like(p) for k, p in params.items()}
        return state

    def update(self, grads: Mapping[str, torch.Tensor], state: dict,
               params: Mapping[str, torch.Tensor],
               gate: torch.Tensor) -> Dict[str, torch.Tensor]:
        """One optimizer step: moves the moments and the count in ``state``
        (by ``gate``) and returns the updates to add to ``params`` (times
        ``gate`` already)."""
        count = state["count"]
        lr = self.schedule(count)  # the count before this update
        after = (count + 1).to(torch.float32)
        updates: Dict[str, torch.Tensor] = {}
        for label, names in self.groups.items():
            if not names:
                continue
            scale, decay, clip = self.hyper[label]
            # the gate goes onto the gradients too: behind a non-finite loss
            # they may be huge (nan_to_num maps inf to 3.4e38), and their
            # squares would reach the moments as inf * 0
            factor = gate
            if clip and clip > 0:
                norm = global_norm([grads[n] for n in names])
                factor = torch.where(norm < clip, 1.0, clip / norm) * gate
            g = torch._foreach_mul([grads[n] for n in names], factor)
            mu = [state["mu"][n] for n in names]
            if self.kind == "sgd":  # trace = g + momentum * trace
                d = torch._foreach_add(g, mu, alpha=SGD_MOMENTUM - 1.0)
                torch._foreach_mul_(d, gate)
                torch._foreach_add_(mu, d)
                u = torch._foreach_mul(mu, 1.0)
            else:
                nu = [state["nu"][n] for n in names]
                d = torch._foreach_sub(g, mu)
                torch._foreach_mul_(d, (1.0 - B1) * gate)
                torch._foreach_add_(mu, d)
                d = torch._foreach_mul(g, g)
                torch._foreach_sub_(d, nu)
                torch._foreach_mul_(d, (1.0 - B2) * gate)
                torch._foreach_add_(nu, d)
                del d
                denom = torch._foreach_sqrt(nu)
                torch._foreach_div_(denom, torch.sqrt(1.0 - B2 ** after))
                torch._foreach_add_(denom, EPS)
                u = torch._foreach_div(mu, denom)
                torch._foreach_div_(u, 1.0 - B1 ** after)
                if self.kind == "radam":
                    # rectified while the variance estimate is usable, else
                    # the bias-corrected first moment alone
                    # (in fp64: ro is a small difference of numbers near 2000)
                    ro_inf = 2.0 / (1.0 - B2) - 1.0
                    b2t = B2 ** after.double()
                    ro = ro_inf - 2.0 * after.double() * b2t / (1.0 - b2t)
                    rect = torch.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf
                                      / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro)).float()
                    usable = ro >= RADAM_THRESHOLD
                    torch._foreach_mul_(u, torch.where(usable, rect, 0.0))
                    plain = torch._foreach_div(mu, 1.0 - B1 ** after)
                    torch._foreach_mul_(plain, torch.where(usable, 0.0, 1.0))
                    torch._foreach_add_(u, plain)
                if self.kind == "adamw" and decay:
                    torch._foreach_add_(u, [params[n] for n in names], alpha=decay)
            torch._foreach_mul_(u, -(lr * scale) * gate)
            updates.update(zip(names, u))
        count.add_(gate.to(torch.int64))
        return updates


class MultiSteps:
    """Gradient accumulation over ``every`` micro-steps, as
    ``optax.MultiSteps``: the running mean of the micro-batch gradients goes
    to the inner optimizer on the last micro-step of a window; before that
    the updates are zero. ``mini_step`` and ``gradient_step`` live on the
    device, so the window closes without the host reading a flag."""

    def __init__(self, inner: GroupedOptimizer, every: int):
        self.inner, self.every = inner, every

    def init(self, params: Mapping[str, torch.Tensor]) -> dict:
        inner = self.inner.init(params)
        zero = torch.zeros_like(inner["count"])
        return {"mini_step": zero.clone(), "gradient_step": zero.clone(),
                "acc_grads": {k: _same_cut(torch.zeros_like(p), p)
                              for k, p in params.items()},
                "inner": inner}

    def update(self, grads, state, params, gate):
        names = list(grads)
        acc = [state["acc_grads"][n] for n in names]
        mini = state["mini_step"]
        d = torch._foreach_sub(torch._foreach_mul([grads[n] for n in names], gate), acc)
        torch._foreach_mul_(d, gate / (mini + 1).to(torch.float32))
        torch._foreach_add_(acc, d)
        emit = (mini == self.every - 1).to(torch.float32) * gate
        updates = self.inner.update(dict(zip(names, acc)), state["inner"], params, emit)
        torch._foreach_mul_(acc, 1.0 - emit)
        closed = emit.to(torch.int64)
        mini.add_(gate.to(torch.int64) * (1 - closed) - closed * mini)
        state["gradient_step"].add_(closed)
        return updates


class ClipOptimizer(GroupedOptimizer):
    """The contrastive pipeline's optimizer over the flat training dict."""

    def __init__(self, config, schedule, params: Mapping[str, torch.Tensor]):
        kind = (config.optimizer or "AdamW").lower()
        if kind in _NOT_PORTED:
            raise NotImplementedError(
                f"optimizer {config.optimizer!r} is not ported yet "
                f"(ported: {', '.join(_OPTIMIZERS)})")
        if kind not in _OPTIMIZERS:
            raise ValueError(f"unknown optimizer {config.optimizer!r}; "
                             f"have {sorted(_OPTIMIZERS + _NOT_PORTED)}")
        video_clip = config.video_max_grad_norm or config.max_grad_norm
        text_clip = config.text_max_grad_norm or config.max_grad_norm
        hyper = {
            "video": (1.0, config.video_weight_decay, video_clip),
            "video_2x": (2.0, config.video_weight_decay, video_clip),
            "text": (config.text_lr / max(config.lr, 1e-12),
                     config.text_weight_decay, text_clip),
            "scalar": (1.0, 0.0, None),
        }
        super().__init__(kind, schedule, hyper, {n: group_label(n) for n in params})


def probe_group_label(name: str, head_structure) -> str:
    """The linear-probing group of a parameter of the flat training dict
    (``video_encoder.*``, ``mil.*``). The head test is a substring test in
    ``head_structure`` order, as in the JAX package: a head whose name starts
    with an earlier head's name (``stenosis_binary`` after ``stenosis``)
    lands in the earlier head's group."""
    if name.split(".", 1)[0] == "video_encoder":
        return "encoder"
    for head in head_structure:
        if f"head_{head}" in name:
            return f"head_{head}"
    if "view_embeddings" in name:
        return "view_embedding"
    if "within" in name:
        return "attention_within"
    if "across" in name or "shared" in name:
        return "attention_across"
    return "mil_other"


def make_probe_optimizer(config, schedule, params: Mapping[str, torch.Tensor]):
    """The linear-probing AdamW: groups ``encoder``, ``view_embedding``,
    ``attention_within``, ``attention_across``, ``mil_other`` and one per
    head, each clipped by its own global norm (``max_grad_norm or 1.0``),
    with its own rate (as a multiple of the schedule's) and weight decay."""
    c = config
    clip = c.max_grad_norm or 1.0

    def group(lr_value, decay):
        base = c.lr
        scale = (lr_value if lr_value is not None else base) / max(base, 1e-12)
        return (scale, decay, clip)

    hyper = {
        "encoder": group(c.lr, c.weight_decay),
        "view_embedding": group(c.view_embedding_lr, c.weight_decay),
        "attention_within": group(
            c.attention_within_lr or c.attention_lr,
            c.attention_within_weight_decay or c.attention_weight_decay
            or c.weight_decay),
        "attention_across": group(
            c.attention_across_lr or c.attention_lr,
            c.attention_across_weight_decay or c.attention_weight_decay
            or c.weight_decay),
        "mil_other": group(c.lr, c.weight_decay),
    }
    for head in c.head_structure:
        hyper[f"head_{head}"] = group(c.head_lr.get(head, c.lr),
                                      c.head_weight_decay.get(head, c.weight_decay))
    labels = {n: probe_group_label(n, c.head_structure) for n in params}
    return GroupedOptimizer("adamw", schedule, hyper, labels)


def make_clip_optimizer(config, schedule, params: Mapping[str, torch.Tensor]):
    """The optimizer for the flat training dict ``params``."""
    return ClipOptimizer(config, schedule, params)


def optimizer_step_count(opt_state: dict, fallback):
    """The count the schedule is read at: with accumulation the
    ``gradient_step`` (one per window), else the caller's step counter."""
    return opt_state.get("gradient_step", fallback)
