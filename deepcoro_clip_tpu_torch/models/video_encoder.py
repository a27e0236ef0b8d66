"""Video encoder: CoroViT backbone + projection + pooling + study aggregation.

Port of the JAX package's ``models/video_encoder.py``. Input is
``[B, N, T, H, W, C]``, ``[B, T, H, W, C]``, or the patch-major wire
``[B, N, L, K]`` / ``[B, L, K]``; the encoder returns the study embedding
``[B, D]`` (``aggregate_videos_tokens``), per-video embeddings
``[B, N, D]`` (``per_video_pool``) or tokens ``[B, N*L, D]``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn

from deepcoro_clip_tpu_torch.configs import ClipConfig
from deepcoro_clip_tpu_torch.models.attention_pool import AttentionPool
from deepcoro_clip_tpu_torch.models.layers import (
    Dense,
    LayerNorm,
    PatchEmbed3D,
    ProjectionHead,
    TransformerBlock,
    _PatchProj,
)
from deepcoro_clip_tpu_torch.models.video_aggregator import EnhancedVideoAggregator
from deepcoro_clip_tpu_torch.ops.pixels import config_stats
from deepcoro_clip_tpu_torch.ops.rope3d import build_rope3d_tables


class CoroViT(nn.Module):
    """Per-clip backbone: [B*N, ...] -> tokens [B*N, n_special + L, dim].

    3D RoPE is fused into the attention; at each block index in
    ``pool_stages`` the tokens are merged 2x2 spatially and the RoPE tables
    are rebuilt for the new grid. With a ``ring_mesh`` every block's
    attention runs as ring attention over ``ring_axis`` where the token
    count divides by its size (sequence parallelism).
    """

    def __init__(self, dim: int = 512, depth: int = 12, num_heads: int = 4,
                 patch: Tuple[int, int, int] = (2, 16, 16),
                 pool_stages: Sequence[int] = (), dropout: float = 0.0,
                 use_cls_token: bool = True, rope_temporal_scale: float = 1.0,
                 dtype: torch.dtype = torch.bfloat16, use_flash: bool = True,
                 pixel_mean=None, pixel_std=None,
                 patch_grid: Optional[Tuple[int, int, int]] = None,
                 fused_outproj: Optional[bool] = None, ring_mesh=None,
                 ring_axis: str = "model"):
        super().__init__()
        self.dim, self.depth, self.num_heads = dim, depth, num_heads
        self.pool_stages = tuple(pool_stages)
        self.use_cls_token = use_cls_token
        self.rope_temporal_scale = rope_temporal_scale
        self.dtype = dtype
        self.patch_embed = PatchEmbed3D(dim, tuple(patch), dtype, pixel_mean,
                                        pixel_std, patch_grid)
        if use_cls_token:
            self.cls = nn.Parameter(torch.zeros(1, 1, dim))
        for i in range(depth):
            if i in self.pool_stages:
                self.add_module(f"pool{i}", Dense(dim, dim, dtype))
            self.add_module(f"block{i}", TransformerBlock(
                dim, num_heads, dropout=dropout, dtype=dtype, use_flash=use_flash,
                fused_outproj=fused_outproj, ring_mesh=ring_mesh, ring_axis=ring_axis))
        self.norm = LayerNorm(dim)
        self._rope_cache: dict = {}

    def _rope(self, T, H, W, n_special, device):
        key = (T, H, W, n_special, str(device))
        if key not in self._rope_cache:
            t = build_rope3d_tables(self.dim // self.num_heads, T, H, W,
                                    n_special=n_special,
                                    temporal_scale=self.rope_temporal_scale)
            self._rope_cache[key] = (torch.from_numpy(t.sin).to(device),
                                     torch.from_numpy(t.cos).to(device))
        return self._rope_cache[key]

    def forward(self, x, deterministic: bool = True, generator=None):
        x, (T, H, W) = self.patch_embed(x)
        B = x.shape[0]
        n_special = 1 if self.use_cls_token else 0
        if self.use_cls_token:
            x = torch.cat([self.cls.to(x.dtype).expand(B, 1, self.dim), x], dim=1)
        sin, cos = self._rope(T, H, W, n_special, x.device)
        for i in range(self.depth):
            if i in self.pool_stages:
                x, (T, H, W) = self._pool_tokens(x, T, H, W, n_special, i)
                sin, cos = self._rope(T, H, W, n_special, x.device)
            x = getattr(self, f"block{i}")(x, sin=sin, cos=cos,
                                           deterministic=deterministic,
                                           generator=generator)
        return self.norm(x).to(self.dtype)

    def _pool_tokens(self, x, T, H, W, n_special, idx):
        """2x2 spatial token merge (multiscale stage)."""
        B, L, D = x.shape
        special, toks = x[:, :n_special], x[:, n_special:]
        g = toks.reshape(B, T, H // 2, 2, W // 2, 2, D)
        merged = g.mean(dim=(3, 5)).reshape(B, T * (H // 2) * (W // 2), D)
        merged = getattr(self, f"pool{idx}")(merged)
        return torch.cat([special, merged], dim=1), (T, H // 2, W // 2)


class VideoEncoder(nn.Module):
    """Backbone + projection + per-video pooling + study aggregation."""

    def __init__(self, embedding_dim: int = 512, backbone_dim: int = 512,
                 depth: int = 12, backbone_heads: int = 4,
                 patch: Tuple[int, int, int] = (2, 16, 16),
                 pool_stages: Sequence[int] = (), num_heads: int = 8,
                 aggregator_depth: int = 2, dropout: float = 0.1,
                 aggregate_videos_tokens: bool = True,
                 per_video_pool: bool = False, pooling_mode: str = "mean",
                 use_cls_token: bool = True, rope_temporal_scale: float = 1.0,
                 dtype: torch.dtype = torch.bfloat16, use_flash: bool = True,
                 pixel_mean=None, pixel_std=None,
                 patch_grid: Optional[Tuple[int, int, int]] = None,
                 fused_outproj: Optional[bool] = None, ring_mesh=None,
                 ring_axis: str = "model"):
        super().__init__()
        self.embedding_dim = embedding_dim
        self.aggregate_videos_tokens = aggregate_videos_tokens
        self.per_video_pool = per_video_pool
        self.pooling_mode = pooling_mode
        self.use_cls_token = use_cls_token
        self.backbone = CoroViT(
            dim=backbone_dim, depth=depth, num_heads=backbone_heads,
            patch=tuple(patch), pool_stages=tuple(pool_stages), dropout=dropout,
            use_cls_token=use_cls_token, rope_temporal_scale=rope_temporal_scale,
            dtype=dtype, use_flash=use_flash, pixel_mean=pixel_mean,
            pixel_std=pixel_std, patch_grid=patch_grid, fused_outproj=fused_outproj,
            ring_mesh=ring_mesh, ring_axis=ring_axis)
        self.proj = ProjectionHead(backbone_dim, embedding_dim, dropout=dropout,
                                   dtype=dtype)
        # as a flax module creates parameters only for what its first call
        # reaches, build only what this configuration's forward reaches: the
        # parameter tree then is the JAX encoder's, name for name
        if pooling_mode == "attention" and (aggregate_videos_tokens or per_video_pool):
            self.pool = AttentionPool(embedding_dim, num_heads, dtype=dtype,
                                      use_flash=use_flash)
        if aggregate_videos_tokens:
            self.aggregator = EnhancedVideoAggregator(
                dim=embedding_dim, num_heads=num_heads, depth=aggregator_depth,
                dropout=dropout, dtype=dtype, use_flash=use_flash)

    @staticmethod
    def _with_video_axis(x):
        """Insert N=1 for spatial [B,T,H,W,C] or patch-major [B,L,K] input."""
        return x[:, None] if x.dim() in (3, 5) else x

    def _encode_clips(self, x, deterministic, generator=None):
        """[B, N, ...] -> projected tokens [B, N, L, D_emb]."""
        B, N = x.shape[:2]
        toks = self.backbone(x.reshape((B * N,) + tuple(x.shape[2:])),
                             deterministic=deterministic, generator=generator)
        toks = self.proj(toks, deterministic=deterministic, generator=generator)
        return toks.reshape(B, N, toks.shape[1], self.embedding_dim)

    def _pool_video(self, toks, deterministic: bool = True, generator=None):
        """[B, N, L, D] -> [B, N, D]. Only the exact modes ``cls_token`` and
        ``attention`` pool otherwise than by the token mean: a hybrid such as
        ``attention+cls_token`` is read by the probing head, not here."""
        B, N, L, D = toks.shape
        if self.pooling_mode == "cls_token" and self.use_cls_token:
            return toks[:, :, 0, :]
        if self.pooling_mode == "attention":
            pooled = self.pool(toks.reshape(B * N, L, D), deterministic=deterministic,
                               generator=generator)
            return pooled.reshape(B, N, D)
        return toks.mean(dim=2)

    def forward(self, x, video_mask: Optional[torch.Tensor] = None,
                deterministic: bool = True, generator=None):
        """x: [B, N, ...] or [B, ...]; video_mask: [B, N], True = real video;
        generator: the source of the dropout masks when not deterministic."""
        x = self._with_video_axis(x)
        toks = self._encode_clips(x, deterministic, generator)
        B, N, L, D = toks.shape
        if not self.aggregate_videos_tokens and not self.per_video_pool:
            return toks.reshape(B, N * L, D)
        per_video = self._pool_video(toks, deterministic, generator)
        if self.per_video_pool and not self.aggregate_videos_tokens:
            return per_video
        return self.aggregator(per_video, mask=video_mask,
                               deterministic=deterministic, generator=generator)

    def features(self, x, video_mask: Optional[torch.Tensor] = None,
                 deterministic: bool = True, generator=None):
        """One backbone pass -> {"tokens": [B,N,L,D], "video": [B,N,D],
        "study": [B,D]}."""
        x = self._with_video_axis(x)
        toks = self._encode_clips(x, deterministic, generator)
        per_video = self._pool_video(toks, deterministic, generator)
        study = self.aggregator(per_video, mask=video_mask,
                                deterministic=deterministic, generator=generator)
        return {"tokens": toks, "video": per_video, "study": study}

    def aggregate(self, per_video, video_mask: Optional[torch.Tensor] = None,
                  deterministic: bool = True, generator=None):
        """The aggregator on given per-video embeddings ``[B, N, D]`` ->
        ``[B, D]`` (the multitask consistency term's single-view target)."""
        return self.aggregator(per_video, mask=video_mask,
                               deterministic=deterministic, generator=generator)

    def get_tokens(self, x, mode: str = "patch", deterministic: bool = True):
        """'patch' -> [B, N, L, D]; 'video' -> [B, N, D]; 'study' -> [B, D]."""
        x = self._with_video_axis(x)
        toks = self._encode_clips(x, deterministic)
        if mode == "patch":
            return toks
        per_video = self._pool_video(toks, deterministic)
        if mode == "video":
            return per_video
        if mode == "study":
            return self.aggregator(per_video, deterministic=deterministic)
        raise ValueError(f"unknown token mode {mode!r}")


# CoroViT size presets for the reference's ``model_name`` values; explicit
# vit_* config fields override them
MODEL_PRESETS = {
    "mvit": dict(vit_dim=512, vit_depth=12, vit_heads=4,
                 vit_patch=(2, 16, 16), vit_pool_stages=(3,)),
    "mvit_rope": dict(vit_dim=512, vit_depth=12, vit_heads=4,
                      vit_patch=(2, 16, 16), vit_pool_stages=(3,)),
    "vit": dict(vit_dim=512, vit_depth=12, vit_heads=4,
                vit_patch=(2, 16, 16), vit_pool_stages=()),
    "x3d_s": dict(vit_dim=256, vit_depth=8, vit_heads=2,
                  vit_patch=(2, 16, 16), vit_pool_stages=(2,)),
    "x3d_m": dict(vit_dim=384, vit_depth=10, vit_heads=3,
                  vit_patch=(2, 16, 16), vit_pool_stages=(2,)),
    "r3d": dict(vit_dim=384, vit_depth=8, vit_heads=3,
                vit_patch=(4, 16, 16), vit_pool_stages=(2,)),
}


def resolve_architecture(cfg) -> dict:
    """model_name preset, overridden by vit_* fields that differ from the
    ClipConfig default."""
    preset = dict(MODEL_PRESETS.get(str(cfg.model_name).lower(), {}))
    defaults = ClipConfig()
    out = {}
    for key in ("vit_dim", "vit_depth", "vit_heads", "vit_patch",
                "vit_pool_stages"):
        explicit = getattr(cfg, key) != getattr(defaults, key)
        out[key] = getattr(cfg, key) if explicit or key not in preset else preset[key]
    return out


def _config_patch_grid(cfg, patch) -> Optional[Tuple[int, int, int]]:
    """Static token grid for patch-major inputs, or None when the clip
    dims are absent or do not tile."""
    frames = getattr(cfg, "frames", None)
    size = getattr(cfg, "resize", None)
    if not frames or not size:
        return None
    pt, ph, pw = patch
    if frames % pt or size % ph or size % pw:
        return None
    return (frames // pt, size // ph, size // pw)


def clip_token_count(cfg) -> int:
    """Tokens per clip at the backbone's output (CLS included): the patch
    grid of ``frames x resize x resize`` (padded right to whole patches),
    halved in height and width at each pool stage a block reaches."""
    arch = resolve_architecture(cfg)
    pt, ph, pw = arch["vit_patch"]
    T, H, W = (-(-cfg.frames // pt), -(-cfg.resize // ph), -(-cfg.resize // pw))
    for stage in arch["vit_pool_stages"]:
        if stage < arch["vit_depth"]:
            H, W = H // 2, W // 2
    return T * H * W + (1 if getattr(cfg, "use_cls_token", True) else 0)


def video_encoder_from_config(cfg, aggregate=None, per_video=None,
                              fused_outproj: Optional[bool] = None,
                              ring_mesh=None) -> VideoEncoder:
    """Build the module on the CPU (zero parameters: load a state dict or
    call ``init_params``). ``fused_outproj``: run the backbone's attention
    with the output projection inside the kernel; None reads
    ``DEEPCORO_FUSED_OUTPROJ``. ``ring_mesh``: run the backbone's attention
    as ring attention over the mesh's ``cfg.ring_axis`` (the parameters do
    not change)."""
    arch = resolve_architecture(cfg)
    mean, std = config_stats(cfg)
    return VideoEncoder(
        embedding_dim=cfg.embedding_dim,
        backbone_dim=arch["vit_dim"],
        depth=arch["vit_depth"],
        backbone_heads=arch["vit_heads"],
        patch=tuple(arch["vit_patch"]),
        pool_stages=tuple(arch["vit_pool_stages"]),
        num_heads=cfg.num_heads,
        aggregator_depth=cfg.aggregator_depth,
        dropout=cfg.dropout,
        aggregate_videos_tokens=(cfg.aggregate_videos_tokens
                                 if aggregate is None else aggregate),
        per_video_pool=cfg.per_video_pool if per_video is None else per_video,
        pooling_mode=getattr(cfg, "pooling_mode", "mean"),
        use_cls_token=getattr(cfg, "use_cls_token", True),
        rope_temporal_scale=getattr(cfg, "rope_temporal_scale", 1.0),
        dtype=torch.bfloat16 if cfg.precision == "bf16" else torch.float32,
        use_flash=cfg.use_pallas_attention,
        pixel_mean=tuple(mean) if mean else None,
        pixel_std=tuple(std) if std else None,
        patch_grid=_config_patch_grid(cfg, tuple(arch["vit_patch"])),
        fused_outproj=fused_outproj,
        ring_mesh=ring_mesh,
        ring_axis=getattr(cfg, "ring_axis", "model"),
    )


@torch.no_grad()
def init_params(model: nn.Module, seed: int = 0) -> nn.Module:
    """Random init from ``seed`` with the JAX package's initializers:
    xavier-uniform dense weights, lecun-normal patch kernel, zero biases,
    unit LayerNorm scales, N(0, 1/dim) token embeddings, N(0, 0.02) for
    cls, positions, query and the mask token."""
    g = torch.Generator().manual_seed(seed)
    for mod in model.modules():
        if isinstance(mod, Dense):
            nn.init.xavier_uniform_(mod.weight, generator=g)
            nn.init.zeros_(mod.bias)
        elif isinstance(mod, LayerNorm):
            nn.init.ones_(mod.weight)
            nn.init.zeros_(mod.bias)
        elif isinstance(mod, nn.Embedding):
            nn.init.normal_(mod.weight, std=mod.embedding_dim ** -0.5, generator=g)
        elif isinstance(mod, _PatchProj):
            fan_in = math.prod(mod.kernel.shape[:4])
            # truncated at +-2 std, rescaled to unit variance (flax lecun_normal)
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(mod.kernel, std=std, a=-2 * std, b=2 * std,
                                  generator=g)
            nn.init.zeros_(mod.bias)
    for name, p in model.named_parameters():
        if name.split(".")[-1] in ("cls", "pos_embedding", "position_embeddings",
                                   "query", "pos_emb", "mask_token"):
            nn.init.normal_(p, std=0.02, generator=g)
    return model
