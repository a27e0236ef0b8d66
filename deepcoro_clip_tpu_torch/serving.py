"""Frozen serving artifacts: ``torch.export`` programs of the two deployables.

The port's counterpart of the JAX package's ``serving.py``. A program is
traced once with ``torch.export`` (``strict=False``, under
``torch.no_grad()``, the model in eval mode, dropout off) and written with
``torch.export.save`` beside its parameters into a self-describing
directory; serving it back needs no model classes and no config system:

- retrieval (``export_retrieval_artifact`` / ``RetrievalArtifact``): the
  video tower on the uint8 patch-major wire -> study embedding -> L2
  normalize -> similarity against the text bank -> top-k;
- probing (``export_probing_artifact`` / ``ProbingArtifact``): the video
  encoder's per-video embeddings (tokens with ``hierarchical_tokens``) ->
  the MIL head -> raw logits per head; ``predict`` applies each head's
  ``head_task`` on the host.

The attention of every block is the operator ``deepcoro::attention`` (or
``deepcoro::attention_proj`` with the fused output projection) of
``ops/library.py``: one opaque node a call, whose CUDA kernel launches the
hand-written kernel (K1, K3, K5) and counts it, so a loaded program runs the
kernels and the launch counters see it. Which kernels a program calls is
read from its graph and written into ``meta.json``.

Artifact layout:

    program.pt2   torch.export.save of the program (platform-specific: the
                  device it was traced on decides the head-dim padding and
                  where the operators' outputs live)
    params.pt     the parameters, a flat {name: tensor} dict, torch.save
                  (read with torch.load(weights_only=True))
    bank.npz      L2-normalized text embeddings [M, D] + texts [M] (retrieval)
    meta.json     wire shapes, patch geometry, platform, versions, kernels

Parameters and the bank are ARGUMENTS of the exported call (not baked
constants), so a fine-tuned checkpoint or a refreshed text bank of the same
shape is dropped into an existing artifact without re-export
(``swap_params``). The program is exported at a fixed ``max_batch``; a
short batch is padded with fully masked studies and cut from the reply.
"""

from __future__ import annotations

import json
from collections import Counter
from pathlib import Path
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
from torch.func import functional_call

from deepcoro_clip_tpu_torch.device import resolve_device
from deepcoro_clip_tpu_torch.ops import library  # noqa: F401 (the operators a program calls)

FORMAT_VERSION = 1
PROGRAM_FILE = "program.pt2"
PARAMS_FILE = "params.pt"
BANK_FILE = "bank.npz"
META_FILE = "meta.json"
# aten operators that would mean attention was decomposed into the graph
DECOMPOSED = ("scaled_dot_product", "_flash_attention", "_efficient_attention",
              "bmm", "baddbmm")


def _sub(params: Mapping[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    return {k[len(prefix):]: v for k, v in params.items() if k.startswith(prefix)}


class _Program(nn.Module):
    """A program over parameters given as its first argument: the models
    are held outside the module's own state, so the export lifts no
    parameter into ``program.pt2``."""

    def __init__(self, **models):
        super().__init__()
        self._models = models  # a plain dict: not submodules


class _RetrievalProgram(_Program):
    def __init__(self, model, k: int):
        super().__init__(video=model)
        self.k = k

    def forward(self, params, bank, studies, mask):
        emb = functional_call(self._models["video"], params, (studies,),
                              {"video_mask": mask, "deterministic": True}).float()
        emb = emb / emb.norm(dim=1, keepdim=True).clamp_min(1e-8)
        scores, idx = torch.topk(emb @ bank.T, self.k, dim=1)
        return emb, scores, idx  # a plain tuple: torch.return_types do not serialize


class _ProbingProgram(_Program):
    def __init__(self, video_model, mil_model, hierarchical: bool, use_view: bool):
        super().__init__(video=video_model, mil=mil_model)
        self.hierarchical, self.use_view = hierarchical, use_view

    def forward(self, params, studies, mask, *view):
        emb = functional_call(self._models["video"], _sub(params, "video_encoder."),
                              (studies,), {"deterministic": True})
        if self.hierarchical:
            B, N = studies.shape[:2]
            emb = emb.reshape(B, N, emb.shape[1] // N, emb.shape[-1])
        return functional_call(self._models["mil"], _sub(params, "mil."), (emb,),
                               {"mask": mask, "deterministic": True,
                                "view_ids": view[0] if self.use_view else None})


def _retrieval_fn(model, k: int) -> nn.Module:
    """The one serving program (mirrors ``serve.InferenceEngine``):
    ``(params, bank, studies, mask) -> (emb, scores, idx)``."""
    return _RetrievalProgram(model, k)


def _probing_fn(video_model, mil_model, hierarchical: bool, use_view: bool) -> nn.Module:
    """The frozen probing program: ``(params, studies, mask[, view_ids]) ->
    {head: raw logits}``, as ``train/linear_probe.forward_heads`` runs at
    inference settings; raw logits keep the artifact activation-agnostic
    (``meta.json`` records each head's task, ``ProbingArtifact.predict``
    applies it)."""
    return _ProbingProgram(video_model, mil_model, hierarchical, use_view)


def _geometry(cfg) -> dict:
    from deepcoro_clip_tpu_torch.data.patch_wire import patch_grid
    from deepcoro_clip_tpu_torch.models.video_encoder import resolve_architecture

    patch = tuple(resolve_architecture(cfg)["vit_patch"])
    N, T, R = int(cfg.num_videos), int(cfg.frames), int(cfg.resize)
    grid = patch_grid(T, R, R, patch)
    return {"num_videos": N, "frames": T, "resize": R, "patch": list(patch),
            "patch_grid": list(grid), "tokens_per_clip": grid[0] * grid[1] * grid[2],
            "patch_bytes": patch[0] * patch[1] * patch[2] * 3}


def program_ops(program) -> Counter:
    """Call counts of the operators in an exported program's graph, by
    name (``deepcoro::attention``, ``aten::softmax.int``, ...)."""
    names = Counter()
    for node in program.graph_module.graph.nodes:
        if node.op == "call_function" and hasattr(node.target, "name"):
            names[node.target.name()] += 1
    return names


def program_kernels(program) -> Dict[str, int]:
    """The hand-written kernels a program's graph calls, with their count a
    call of the program: K1 (``deepcoro::attention`` on a packed layout),
    K3 (on ``[B, H, L, Dh]``), K5 (``deepcoro::attention_proj``)."""
    out: Counter = Counter()
    for node in program.graph_module.graph.nodes:
        if node.op != "call_function" or not hasattr(node.target, "name"):
            continue
        name = node.target.name()
        if name == "deepcoro::attention":
            layout = node.args[8] if len(node.args) > 8 else node.kwargs["layout"]
            out["K3" if layout == "heads" else "K1"] += 1
        elif name == "deepcoro::attention_proj":
            out["K5"] += 1
    return dict(sorted(out.items()))


def decomposed_attention(program) -> list:
    """The operators of an exported graph that would be attention taken
    apart into aten (none in a program of the port's modules)."""
    return sorted(n for n in program_ops(program) if n.startswith("aten::")
                  and any(d in n.split("::")[1] for d in DECOMPOSED))


def _export(program: nn.Module, args: tuple):
    with torch.no_grad():
        return torch.export.export(program, args, strict=False)


def _platform_meta(device: torch.device) -> dict:
    arch = None
    if device.type == "cuda":
        major, minor = torch.cuda.get_device_capability(device)
        arch = f"sm_{major}{minor}"
    return {"platforms": [device.type], "torch_version": torch.__version__,
            "cuda_arch": arch}


def _write(out: Path, ep, params: Mapping[str, torch.Tensor], meta: dict) -> dict:
    # the trace's example inputs (the parameters, a batch of studies) would be
    # saved with the program: it keeps the graph and its constants only
    ep.example_inputs = None
    torch.export.save(ep, out / PROGRAM_FILE)
    torch.save({k: v.detach().cpu() for k, v in params.items()}, out / PARAMS_FILE)
    meta["ops"] = {k: v for k, v in sorted(program_ops(ep).items())
                   if k.startswith("deepcoro::")}
    meta["kernels"] = program_kernels(ep)
    (out / META_FILE).write_text(json.dumps(meta, indent=1))
    return meta


def _fill_caches(model, studies, **kw) -> None:
    """One eager call at the export shapes: the backbone's RoPE tables are
    built and cached as real tensors before the trace reads them."""
    with torch.no_grad():
        model(studies[:1], **kw)


def export_retrieval_artifact(cfg, out_dir, bank_emb: np.ndarray, bank_texts: Sequence[str],
                              *, max_batch: int = 4, top_k: int = 5, video_params=None,
                              device=None) -> dict:
    """Trace and save the retrieval program for ``cfg`` on ``device`` (CUDA
    unless the caller passes ``"cpu"``); returns the meta.

    ``video_params`` is the video tower's state dict (a contrastive
    checkpoint's ``video_encoder.*`` entries without the prefix, loaded
    strictly); ``None`` exports the seed-0 random init (wire and latency
    smoke artifacts)."""
    from deepcoro_clip_tpu_torch.models.video_encoder import (
        init_params,
        video_encoder_from_config,
    )

    dev = resolve_device(device)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    model = video_encoder_from_config(cfg)
    if video_params is None:
        init_params(model, seed=0)
    else:
        model.load_state_dict(video_params, strict=True)
    model = model.eval().to(dev)
    params = {k: p.detach() for k, p in model.named_parameters()}

    bank = np.asarray(bank_emb, np.float32).copy()
    bank /= np.maximum(np.linalg.norm(bank, axis=1, keepdims=True), 1e-8)
    k = min(int(top_k), bank.shape[0])
    geo = _geometry(cfg)
    B, N = int(max_batch), geo["num_videos"]
    studies = torch.zeros((B, N, geo["tokens_per_clip"], geo["patch_bytes"]),
                          dtype=torch.uint8, device=dev)
    mask = torch.ones((B, N), dtype=torch.bool, device=dev)
    bank_t = torch.from_numpy(bank).to(dev)
    _fill_caches(model, studies, video_mask=mask[:1], deterministic=True)
    ep = _export(_retrieval_fn(model, k), (params, bank_t, studies, mask))

    np.savez(out / BANK_FILE, text_embeddings=bank,
             texts=np.asarray([str(t) for t in bank_texts], dtype=np.str_))
    meta = {"format": FORMAT_VERSION, "kind": "retrieval", **_platform_meta(dev),
            "wire": "patch_u8", "max_batch": B, **geo, "top_k": k,
            "embedding_dim": int(bank.shape[1]), "bank_size": int(bank.shape[0])}
    return _write(out, ep, params, meta)


def export_probing_artifact(cfg, out_dir, *, max_batch: int = 4, probe_params=None,
                            device=None, fused_outproj: Optional[bool] = None) -> dict:
    """Freeze a linear-probing pipeline, studies -> per-head logits, on
    ``device`` (CUDA unless ``"cpu"``); returns the meta.

    ``probe_params`` is a probing checkpoint's flat parameter dict
    (``video_encoder.*`` and ``mil.*``, loaded strictly); ``None`` exports
    the seeded random init of ``build_probe_bundle`` at seed 0.
    ``fused_outproj`` (None: ``DEEPCORO_FUSED_OUTPROJ``, read now) decides
    whether the backbone's blocks call K5 or K1 + the projection; the
    program bakes the choice in and the meta records it. The patchify folds
    ``cfg``'s dataset statistics into its weights, as the runner's encoder
    does."""
    from deepcoro_clip_tpu_torch.models.video_encoder import (
        init_params,
        video_encoder_from_config,
    )
    from deepcoro_clip_tpu_torch.train.linear_probe import mil_from_config

    dev = resolve_device(device)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    hierarchical = bool(getattr(cfg, "hierarchical_tokens", False))
    use_view = bool(getattr(cfg, "use_view_embeddings", False))
    video_model = init_params(video_encoder_from_config(
        cfg, aggregate=False, per_video=not hierarchical, fused_outproj=fused_outproj), 0)
    mil_model = init_params(mil_from_config(cfg), 1)
    if probe_params is not None:
        video_model.load_state_dict(_sub(probe_params, "video_encoder."), strict=True)
        mil_model.load_state_dict(_sub(probe_params, "mil."), strict=True)
        extra = [k for k in probe_params if not k.startswith(("video_encoder.", "mil."))]
        if extra:
            raise ValueError(f"probing parameters outside video_encoder/mil: {extra[:3]}")
    video_model, mil_model = video_model.eval().to(dev), mil_model.eval().to(dev)
    params = {f"video_encoder.{k}": p.detach() for k, p in video_model.named_parameters()}
    params.update({f"mil.{k}": p.detach() for k, p in mil_model.named_parameters()})

    geo = _geometry(cfg)
    B, N = int(max_batch), geo["num_videos"]
    studies = torch.zeros((B, N, geo["tokens_per_clip"], geo["patch_bytes"]),
                          dtype=torch.uint8, device=dev)
    args = [params, studies, torch.ones((B, N), dtype=torch.bool, device=dev)]
    if use_view:
        args.append(torch.zeros((B, N), dtype=torch.int32, device=dev))
    _fill_caches(video_model, studies, deterministic=True)
    ep = _export(_probing_fn(video_model, mil_model, hierarchical, use_view), tuple(args))

    fused = any(getattr(m, "fused_outproj", False) for m in video_model.modules())
    meta = {"format": FORMAT_VERSION, "kind": "probing", **_platform_meta(dev),
            "wire": "patch_u8", "max_batch": B, **geo,
            "head_structure": {k: int(v) for k, v in cfg.head_structure.items()},
            "head_task": {k: str(cfg.head_task.get(k, "binary")) for k in cfg.head_structure},
            "has_view_ids": use_view, "hierarchical_tokens": hierarchical,
            "fused_outproj": fused}
    return _write(out, ep, params, meta)


class _Artifact:
    """Shared loader: meta, the format, kind and platform guards, the
    program and the parameters on the device."""

    KIND = ""

    def __init__(self, path, device=None):
        p = Path(path)
        self.path = p
        self.meta = json.loads((p / META_FILE).read_text())
        if self.meta.get("format") != FORMAT_VERSION:
            raise ValueError(f"artifact format {self.meta.get('format')} != "
                             f"{FORMAT_VERSION} (re-export with this build)")
        if self.meta.get("kind") != self.KIND:
            raise ValueError(
                f"artifact kind {self.meta.get('kind')!r} != {self.KIND!r} (use "
                f"{'RetrievalArtifact' if self.meta.get('kind') == 'retrieval' else 'ProbingArtifact'})")
        self.device = resolve_device(device)
        if self.device.type not in self.meta["platforms"]:
            raise ValueError(
                f"artifact was exported for {self.meta['platforms']}, the device is "
                f"{self.device.type} (the program's attention is traced for its device: "
                "re-export on this platform)")
        self.program = torch.export.load(p / PROGRAM_FILE)
        self._call = self.program.module()
        # the parameters go to the device once; per call only the studies move
        self._params = self._to_device(torch.load(p / PARAMS_FILE, map_location="cpu",
                                                  weights_only=True))
        self.max_batch = int(self.meta["max_batch"])
        self.num_videos = int(self.meta["num_videos"])

    def _to_device(self, params: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v).to(self.device) for k, v in params.items()}

    def swap_params(self, params: Mapping[str, torch.Tensor]) -> None:
        """Drop in same-named, same-shape parameters (a fine-tuned
        checkpoint's) without re-export."""
        old = self._params
        if set(params) != set(old):
            missing, extra = sorted(set(old) - set(params)), sorted(set(params) - set(old))
            raise ValueError(f"parameters do not fit the program: missing {missing[:3]}, "
                             f"unexpected {extra[:3]}")
        bad = [k for k, v in params.items()
               if tuple(v.shape) != tuple(old[k].shape) or v.dtype != old[k].dtype]
        if bad:
            raise ValueError(f"parameters shaped or typed otherwise than the program's: "
                             f"{bad[:3]}")
        # in the program's order: the call flattens the dict in its key order
        self._params = self._to_device({k: params[k] for k in old})

    def load_study(self, paths) -> tuple:
        """Paths -> ([num_videos, L, K] uint8 patch-major, [num_videos] mask)."""
        from deepcoro_clip_tpu_torch.data.patch_wire import patchify_videos
        from deepcoro_clip_tpu_torch.data.video_io import load_video

        m, N = self.meta, self.num_videos
        paths = list(paths)[:N]
        clips = np.zeros((1, N, m["frames"], m["resize"], m["resize"], 3), np.uint8)
        mask = np.zeros((N,), bool)
        for i, p in enumerate(paths):
            clips[0, i] = load_video(str(p), n_frames=m["frames"], resize=m["resize"],
                                     output_dtype="uint8")
            mask[i] = True
        return patchify_videos(clips, tuple(m["patch"]))[0], mask

    def _pad(self, studies: np.ndarray, masks: np.ndarray):
        b = studies.shape[0]
        if b > self.max_batch:
            raise ValueError(f"batch {b} > exported max_batch {self.max_batch}")
        if b < self.max_batch:
            pad = self.max_batch - b
            studies = np.concatenate(
                [studies, np.zeros((pad,) + studies.shape[1:], studies.dtype)])
            masks = np.concatenate([masks, np.zeros((pad,) + masks.shape[1:], bool)])
        return studies, masks, b

    def _tensor(self, a: np.ndarray, dtype) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(self.device)


class RetrievalArtifact(_Artifact):
    """Serve a frozen retrieval artifact. Duck-types ``serve.InferenceEngine``
    (``max_batch``, ``num_videos``, ``bank_texts``, ``load_study``,
    ``infer_batch``), so the micro-batching HTTP server runs straight off an
    artifact directory (``serve --artifact``)."""

    KIND = "retrieval"

    def __init__(self, path, device=None):
        super().__init__(path, device)
        with np.load(self.path / BANK_FILE) as z:
            bank = z["text_embeddings"]
            self.bank_texts = [str(t) for t in z["texts"]]
        self._bank = torch.from_numpy(np.asarray(bank, np.float32)).to(self.device)
        self.top_k = int(self.meta["top_k"])

    def infer_batch(self, studies: np.ndarray, masks: np.ndarray):
        """[B<=max_batch, N, L, K] u8 -> (emb [B,D], scores [B,k], idx [B,k])."""
        studies, masks, b = self._pad(studies, masks)
        with torch.no_grad():
            emb, scores, idx = self._call(self._params, self._bank,
                                          self._tensor(studies, np.uint8),
                                          self._tensor(masks, bool))
        return (emb[:b].cpu().numpy(), scores[:b].cpu().numpy(), idx[:b].cpu().numpy())

    def retrieve(self, paths) -> list:
        """One study's video paths -> top-k [{text, score}]."""
        study, mask = self.load_study(paths)
        _, scores, idx = self.infer_batch(study[None], mask[None])
        return [{"text": self.bank_texts[int(j)], "score": float(s)}
                for j, s in zip(idx[0], scores[0])]


class ProbingArtifact(_Artifact):
    """A frozen linear-probing pipeline: studies -> per-head predictions."""

    KIND = "probing"

    def infer_batch(self, studies: np.ndarray, masks: np.ndarray,
                    view_ids: Optional[np.ndarray] = None) -> dict:
        """[B<=max_batch, N, L, K] u8 -> {head: logits [B, C]} (raw)."""
        studies, masks, b = self._pad(studies, masks)
        args = [self._params, self._tensor(studies, np.uint8), self._tensor(masks, bool)]
        if self.meta["has_view_ids"]:
            if view_ids is None:
                view_ids = np.zeros(studies.shape[:2], np.int32)
            elif view_ids.shape[0] < self.max_batch:
                view_ids = np.concatenate([view_ids, np.zeros(
                    (self.max_batch - view_ids.shape[0],) + view_ids.shape[1:], np.int32)])
            args.append(self._tensor(view_ids, np.int32))
        with torch.no_grad():
            out = self._call(*args)
        return {h: v[:b].float().cpu().numpy() for h, v in out.items()}

    def predict(self, studies: np.ndarray, masks: np.ndarray,
                view_ids: Optional[np.ndarray] = None) -> dict:
        """Logits -> probabilities per meta ``head_task`` (sigmoid for
        binary, softmax for multiclass, identity for regression), on the
        host, as the JAX package's artifact does."""
        logits = self.infer_batch(studies, masks, view_ids)
        out = {}
        for h, x in logits.items():
            task = self.meta["head_task"].get(h, "binary")
            if task == "binary":
                out[h] = 1.0 / (1.0 + np.exp(-x))
            elif task == "multiclass":
                e = np.exp(x - x.max(-1, keepdims=True))
                out[h] = e / e.sum(-1, keepdims=True)
            else:  # regression
                out[h] = x
        return out
