"""Transformer building blocks, the port of the JAX package's ``models/layers.py``.

Precision follows the JAX package: parameters are fp32; a ``Dense`` casts
its input and its weights to the compute dtype (bf16 under
``precision="bf16"``) for the product; LayerNorm runs in fp32 (eps 1e-6,
flax's default); GELU is the tanh approximation (flax's default).
Dropout is the identity when ``deterministic`` (serving never drops); in
training mode (``deterministic=False``) every mask is drawn from the
``torch.Generator`` handed down the call (the global one when it is None),
so a train step is a function of its generator, as the JAX step is of its
``rng``.

Module and parameter names follow the flax tree (``block{i}``, ``attn``,
``qkv``, ``norm1`` ...), so ``convert.py`` maps one onto the other by name.

Tensor parallelism over the ``model`` axis of a process grid
(``shard_layers``, after the weights are set): each rank of a model group
keeps ``H/M`` heads of every attention and ``hidden/M`` of every MLP's
hidden width, by the cuts of ``train/state.partition_rule``. A layer takes
``distributed.copy_to_model`` of its input before its column-parallel
products and ends in ``distributed.reduce_from_model`` after its
row-parallel one, then adds that product's bias once. Activations between
layers stay replicated over the group.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from deepcoro_clip_tpu_torch.ops.attention import apply_rope, multi_head_attention
from deepcoro_clip_tpu_torch.ops.flash_attention import flash_attention
from deepcoro_clip_tpu_torch.ops.flash_attention_packed import flash_attention_packed
from deepcoro_clip_tpu_torch.parallel.distributed import (
    copy_to_model,
    gather_chunks,
    rank,
    reduce_from_model,
    take_chunk,
)
from deepcoro_clip_tpu_torch.parallel.mesh import MODEL_AXIS, ProcessMesh
from deepcoro_clip_tpu_torch.parallel.ring_attention import ring_attention
from deepcoro_clip_tpu_torch.train.state import COLUMN, QKV, ROW, Split, take_shard


def _dropout(x: torch.Tensor, rate: float, deterministic: bool,
             generator: Optional[torch.Generator] = None,
             part: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Inverted dropout; the keep mask comes from ``generator``, which must
    live on ``x``'s device. ``part`` ``(n, i)``: ``x`` is part ``i`` of ``n``
    of the last axis of a wider activation; the mask is drawn at the whole
    width and cut, so that it holds the bits the whole activation draws."""
    if deterministic or rate == 0.0:
        return x
    if part is None:
        keep = torch.empty_like(x).bernoulli_(1.0 - rate, generator=generator)
    else:
        n, i = part
        w = x.shape[-1]
        keep = x.new_empty(x.shape[:-1] + (w * n,)).bernoulli_(
            1.0 - rate, generator=generator).narrow(-1, i * w, w)
    return x * keep * (1.0 / (1.0 - rate))


def _model_axis(grid: ProcessMesh) -> Tuple[int, int]:
    return grid.shape[MODEL_AXIS], grid.index[MODEL_AXIS]


class Dense(nn.Linear):
    """Linear with fp32 parameters computed in ``compute_dtype``.

    After ``shard_`` it holds this rank's part of the weight: a
    column-parallel Dense (``split.dim`` 0) its rows of ``[out, in]`` and of
    the bias, and its input must be ``copy_to_model``'s; a row-parallel one
    (``split.dim`` 1) its columns, and its forward sums the partial
    products over the model group before it adds the whole bias."""

    model_split: Optional[Split] = None

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.bfloat16, bias: bool = True):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    @torch.no_grad()
    def shard_(self, split: Split, n: int, i: int) -> None:
        """Keep part ``i`` of ``n`` of the weight (and of a column-parallel
        bias); the parameters carry their cut as ``model_split``."""
        self.weight = nn.Parameter(take_shard(self.weight, split, n, i))
        self.weight.model_split = split
        if split.dim == 0 and self.bias is not None:
            self.bias = nn.Parameter(take_shard(self.bias, split, n, i))
            self.bias.model_split = split
        self.model_split = split

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear(x.to(self.compute_dtype), self.compute_dtype)

    def linear(self, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
        """``x @ weight.T + bias`` with the weights in ``dt``."""
        w = self.weight.to(dt)
        if self.model_split is not None and self.model_split.dim == 1:
            return self.add_bias(reduce_from_model(F.linear(x, w)), dt)
        return F.linear(x, w, None if self.bias is None else self.bias.to(dt))

    def add_bias(self, y: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
        """``y`` (a row-parallel product, summed) plus the bias, in ``dt``."""
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y.to(dt)


class LayerNorm(nn.LayerNorm):
    """fp32 LayerNorm with flax's eps; returns fp32."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__(dim, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps)


class MlpBlock(nn.Module):
    """Dense -> GELU(tanh) -> Dense."""

    part: Optional[Tuple[int, int]] = None  # (M, index) once cut

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 dropout: float = 0.0, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.fc1 = Dense(in_dim, hidden_dim, dtype)
        self.fc2 = Dense(hidden_dim, out_dim, dtype)
        self.dropout = dropout

    def shard_(self, grid: ProcessMesh) -> Optional[str]:
        """Keep this rank's ``hidden/M`` of the hidden width; returns why
        the layer stays whole, or None."""
        n, i = _model_axis(grid)
        if self.fc1.out_features % n:
            return f"hidden width {self.fc1.out_features}"
        self.fc1.shard_(COLUMN, n, i)
        self.fc2.shard_(ROW, n, i)
        self.part = (n, i)
        return None

    def forward(self, x, deterministic: bool = True, generator=None):
        if self.part is not None:
            x = copy_to_model(x)
        x = F.gelu(self.fc1(x), approximate="tanh")
        x = _dropout(x, self.dropout, deterministic, generator, self.part)
        return _dropout(self.fc2(x), self.dropout, deterministic, generator)


def fused_outproj_default() -> bool:
    """``DEEPCORO_FUSED_OUTPROJ=1`` in the environment, as the JAX layer
    reads it when it is traced; read here when a module is constructed."""
    return os.environ.get("DEEPCORO_FUSED_OUTPROJ", "0") == "1"


class Attention(nn.Module):
    """Multi-head self- or cross-attention.

    Self-attention goes through one fused q|k|v projection ``qkv``;
    ``cross=True`` builds the separate ``q``/``k``/``v`` projections of the
    JAX module's ``context`` path instead (a flax module creates whichever
    its first call uses; here the constructor says which), ``k`` and ``v``
    from a context of width ``context_dim`` (``dim`` unless given).

    Dispatch as in the JAX package: with ``use_flash`` and a head dim that
    is a multiple of 128, the packed kernel reads the projections directly;
    otherwise heads are split to ``[B, H, L, Dh]`` for the standard kernel
    (``use_flash``) or the plain attention. With ``fused_outproj`` (None:
    read ``DEEPCORO_FUSED_OUTPROJ`` now) the packed self-attention path
    hands ``proj.weight`` to the kernel and adds ``proj.bias`` itself; the
    parameters keep their names, so a state dict loads into either path.

    With a ``ring_mesh`` (sequence parallelism) the packed path is off, and
    self-attention without mask or causality whose length divides by the
    ``ring_axis`` size runs as ring attention over the mesh, after RoPE
    (``parallel/ring_attention.py``, its default backend); any other call
    takes the standard kernel or the plain attention as without a mesh.
    Over a ``ProcessMesh`` (the ranks of a process group) q/k/v are
    replicated over the axis's group: each rank cuts its chunk of the tokens
    (``distributed.take_chunk``), runs the ring on it and all-gathers the
    output chunks (``distributed.gather_chunks``), so the model ranks end
    with the same output and, through the two collectives' backwards, the
    same parameter gradients as one process.

    After ``shard_`` (tensor parallelism) the rank holds ``heads`` =
    ``num_heads / M`` of the heads: its ``[q_r | k_r | v_r]`` rows of
    ``qkv`` (or of ``q``/``k``/``v``), which the kernels read at ``heads``
    heads, and its columns of ``proj``, whose partial product (K5's too)
    is summed over the model group before ``proj.bias``.
    """

    def __init__(self, dim: int, num_heads: int, dropout: float = 0.0,
                 dtype: torch.dtype = torch.bfloat16, use_flash: bool = True,
                 cross: bool = False, fused_outproj: Optional[bool] = None,
                 ring_mesh=None, ring_axis: str = "model",
                 context_dim: Optional[int] = None):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.heads = num_heads  # this rank's
        self.dropout, self.use_flash = dropout, use_flash
        self.cross = cross
        self.ring_mesh, self.ring_axis = ring_mesh, ring_axis
        self.fused_outproj = (fused_outproj_default() if fused_outproj is None
                              else bool(fused_outproj))
        if cross:
            self.q = Dense(dim, dim, dtype)
            self.k = Dense(context_dim or dim, dim, dtype)
            self.v = Dense(context_dim or dim, dim, dtype)
        else:
            self.qkv = Dense(dim, 3 * dim, dtype)
        self.proj = Dense(dim, dim, dtype)

    def shard_(self, grid: ProcessMesh) -> Optional[str]:
        """Keep this rank's ``num_heads / M`` heads; returns why the layer
        stays whole, or None."""
        n, i = _model_axis(grid)
        if self.num_heads % n:
            return f"{self.num_heads} heads"
        for d in ((self.q, self.k, self.v) if self.cross else (self.qkv,)):
            d.shard_(COLUMN if self.cross else QKV, n, i)
        self.proj.shard_(ROW, n, i)
        self.heads = self.num_heads // n
        return None

    def forward(self, x, context=None, sin=None, cos=None, kv_mask=None,
                causal: bool = False, deterministic: bool = True, generator=None):
        if (context is not None) != self.cross:
            raise ValueError("an Attention built with cross=True takes a context, "
                             "one built without takes none")
        B, Lq, _ = x.shape
        H = self.heads
        head_dim = self.dim // self.num_heads
        width = H * head_dim
        use_packed = self.use_flash and head_dim % 128 == 0 and self.ring_mesh is None
        if self.proj.model_split is not None:
            x = copy_to_model(x)
            context = None if context is None else copy_to_model(context)
        if self.cross:
            q, k, v = self.q(x), self.k(context), self.v(context)
            packed_kw = dict(q=q, k=k, v=v)
        else:
            qkv = self.qkv(x)
            packed_kw = dict(qkv=qkv)
        if use_packed and self.fused_outproj and not self.cross:
            out = flash_attention_packed(**packed_kw, num_heads=H, sin=sin, cos=cos,
                                         kv_mask=kv_mask, causal=causal,
                                         wo=self.proj.weight.t())
            if self.proj.model_split is not None:  # this rank's heads' partial
                out = self.proj.add_bias(reduce_from_model(out), out.dtype)
            else:
                out = out + self.proj.bias.to(out.dtype)
            return _dropout(out, self.dropout, deterministic, generator)
        if use_packed:
            out = flash_attention_packed(**packed_kw, num_heads=H, sin=sin, cos=cos,
                                         kv_mask=kv_mask, causal=causal)
        else:
            if not self.cross:
                q, k, v = qkv.split(width, dim=-1)
            q, k, v = (t.reshape(B, t.shape[1], H, head_dim).transpose(1, 2)
                       for t in (q, k, v))
            use_ring = (self.ring_mesh is not None and not self.cross and not causal
                        and kv_mask is None
                        and Lq % self.ring_mesh.shape[self.ring_axis] == 0)
            if use_ring:
                if sin is not None:
                    q, k = apply_rope(q, sin, cos), apply_rope(k, sin, cos)
                if isinstance(self.ring_mesh, ProcessMesh):
                    q, k, v = (take_chunk(t, 2) for t in (q, k, v))
                    out = gather_chunks(ring_attention(q, k, v, self.ring_mesh,
                                                       axis=self.ring_axis), 2)
                else:
                    out = ring_attention(q, k, v, self.ring_mesh, axis=self.ring_axis)
            elif self.use_flash:
                out = flash_attention(q, k, v, sin=sin, cos=cos,
                                      kv_mask=kv_mask, causal=causal)
            else:
                m = None if kv_mask is None else kv_mask != 0
                out = multi_head_attention(q, k, v, sin=sin, cos=cos,
                                           kv_mask=m, causal=causal)
            out = out.transpose(1, 2).reshape(B, Lq, width)
        return _dropout(self.proj(out), self.dropout, deterministic, generator)


class TransformerBlock(nn.Module):
    """Pre-LN transformer block (LN in fp32)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 dropout: float = 0.0, dtype: torch.dtype = torch.bfloat16,
                 use_flash: bool = True, fused_outproj: Optional[bool] = None,
                 ring_mesh=None, ring_axis: str = "model"):
        super().__init__()
        self.dtype = dtype
        self.norm1 = LayerNorm(dim)
        self.attn = Attention(dim, num_heads, dropout, dtype, use_flash,
                              fused_outproj=fused_outproj, ring_mesh=ring_mesh,
                              ring_axis=ring_axis)
        self.norm2 = LayerNorm(dim)
        self.mlp = MlpBlock(dim, int(dim * mlp_ratio), dim, dropout, dtype)

    def forward(self, x, sin=None, cos=None, kv_mask=None,
                deterministic: bool = True, generator=None):
        h = self.norm1(x).to(self.dtype)
        x = x + self.attn(h, sin=sin, cos=cos, kv_mask=kv_mask,
                          deterministic=deterministic, generator=generator)
        h = self.norm2(x).to(self.dtype)
        return x + self.mlp(h, deterministic=deterministic, generator=generator)


def shard_layers(model: nn.Module, grid: ProcessMesh) -> Dict[str, str]:
    """Tensor parallelism over ``grid``'s model axis: every layer of
    ``model`` with a ``shard_`` (``Attention``, ``MlpBlock``,
    ``BertSelfAttention``, ``BertLayer``) keeps this rank's part of its
    weights. A layer whose heads or hidden width ``M`` does not divide
    stays whole on every rank (the same function, its parameters
    replicated); returns those layers' names with the reason, which rank 0
    prints once. Call it once, after the weights are set."""
    n, _ = _model_axis(grid)
    whole: Dict[str, str] = {}
    if n == 1:
        return whole
    for name, mod in model.named_modules():
        if hasattr(mod, "shard_") and not isinstance(mod, Dense):
            why = mod.shard_(grid)
            if why is not None:
                whole[name] = why
    if whole and rank() == 0:
        for name, why in whole.items():
            print(f"[deepcoro_clip_tpu_torch] tensor parallelism: {type(model).__name__}."
                  f"{name} stays whole on every rank ({why}; mesh_model {n} does not "
                  "divide it)", flush=True)
    return whole


class ProjectionHead(nn.Module):
    """Dropout -> Dense -> GELU(tanh) -> Dropout."""

    def __init__(self, in_dim: int, out_dim: int, dropout: float = 0.1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.proj = Dense(in_dim, out_dim, dtype)
        self.dropout = dropout

    def forward(self, x, deterministic: bool = True, generator=None):
        x = _dropout(x, self.dropout, deterministic, generator)
        x = F.gelu(self.proj(x), approximate="tanh")
        return _dropout(x, self.dropout, deterministic, generator)


class _PatchProj(nn.Module):
    """Patchify weights under nn.Conv's names and shapes (``kernel``
    ``[pt, ph, pw, C, dim]``, ``bias`` ``[dim]``), applied as one matmul
    over patch-major ``[B, L, K]`` patches.

    On raw integer pixels the per-channel normalization is folded into the
    weights, ``((x-m)/s)@W + b == x@(W/s) + (b - sum((m/s)·W))``, with
    mean 0 and std 1 when the config has no stats. A 1-channel input
    against a C-channel kernel (the mono wire) folds the channel
    replication too: the kernel summed over its channel axis.
    """

    def __init__(self, dim: int, patch: Tuple[int, int, int], in_channels: int,
                 dtype: torch.dtype, pixel_mean: Optional[Sequence[float]] = None,
                 pixel_std: Optional[Sequence[float]] = None):
        super().__init__()
        self.dim, self.patch, self.in_channels = dim, tuple(patch), in_channels
        self.dtype = dtype
        self.pixel_mean, self.pixel_std = pixel_mean, pixel_std
        pt, ph, pw = self.patch
        self.kernel = nn.Parameter(torch.zeros(pt, ph, pw, in_channels, dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, patches: torch.Tensor, fold_stats: bool = False):
        """patches: ``[B, L, pt*ph*pw*Cin]`` -> ``[B, L, dim]``."""
        pt, ph, pw = self.patch
        C = self.in_channels
        cin = patches.shape[-1] // (pt * ph * pw)
        mono = cin == 1 and C > 1
        w, b = self.kernel, self.bias
        if mono and not fold_stats:
            w = w.sum(dim=3, keepdim=True)
        if fold_stats:
            m = torch.tensor(self.pixel_mean if self.pixel_mean is not None
                             else (0.0,) * C, dtype=torch.float32, device=w.device)
            s = torch.tensor(self.pixel_std if self.pixel_std is not None
                             else (1.0,) * C, dtype=torch.float32, device=w.device)
            m, s = m.expand(C), s.clamp_min(1e-6).expand(C)
            b = b - torch.einsum("c,thwcd->d", m / s, w)
            w = w / s[None, None, None, :, None]
            if mono:
                w = w.sum(dim=3, keepdim=True)
        wk = w.reshape(pt * ph * pw * w.shape[3], self.dim).to(self.dtype)
        return torch.matmul(patches.to(self.dtype), wk) + b.to(self.dtype)


class PatchEmbed3D(nn.Module):
    """3D tubelet patchify: ``[B, T, H, W, C]`` or the patch-major wire
    ``[B, L, K]`` -> (``[B, T'·H'·W', dim]``, (T', H', W'))."""

    def __init__(self, dim: int, patch: Tuple[int, int, int] = (2, 16, 16),
                 dtype: torch.dtype = torch.bfloat16,
                 pixel_mean: Optional[Sequence[float]] = None,
                 pixel_std: Optional[Sequence[float]] = None,
                 patch_grid: Optional[Tuple[int, int, int]] = None,
                 in_channels: int = 3):
        super().__init__()
        self.patch = tuple(patch)
        self.patch_grid = patch_grid
        self.in_channels = in_channels
        self.pixel_mean, self.pixel_std = pixel_mean, pixel_std
        self.conv = _PatchProj(dim, self.patch, in_channels, dtype,
                               pixel_mean, pixel_std)

    def forward(self, x: torch.Tensor):
        pt, ph, pw = self.patch
        is_raw = not torch.is_floating_point(x)
        if x.dim() == 3:  # host patch-major wire [B, L, K]
            if self.patch_grid is None:
                raise ValueError("patch-major input requires patch_grid=(T', H', W')")
            Tn, Hn, Wn = self.patch_grid
            if x.shape[1] != Tn * Hn * Wn:
                raise ValueError(f"patch-wire token count {x.shape[1]} != "
                                 f"grid {self.patch_grid}")
            return self.conv(x, fold_stats=is_raw), (Tn, Hn, Wn)
        B, T, H, W, C = x.shape
        if T % pt or H % ph or W % pw:  # pad right to a whole patch grid
            if is_raw and self.pixel_mean is not None:
                # normalize BEFORE padding, so zero padding means "dataset
                # mean" on the uint8 wire as it does on the float wire
                m = torch.tensor(self.pixel_mean, dtype=torch.float32, device=x.device)
                s = torch.tensor(self.pixel_std, dtype=torch.float32,
                                 device=x.device).clamp_min(1e-6)
                if C == 1 and m.shape[0] > 1:
                    x = ((x.float() - m[:1]) / s[:1]).repeat_interleave(
                        self.in_channels, dim=-1)
                    C = self.in_channels
                else:
                    x = (x.float() - m) / s
                is_raw = False
            padded = x.new_zeros((B, T + (-T % pt), H + (-H % ph),
                                  W + (-W % pw), C))
            padded[:, :T, :H, :W] = x
            x = padded
            T, H, W = x.shape[1:4]
        Tn, Hn, Wn = T // pt, H // ph, W // pw
        p = (x.reshape(B, Tn, pt, Hn, ph, Wn, pw, C)
             .permute(0, 1, 3, 5, 2, 4, 6, 7)
             .reshape(B, Tn * Hn * Wn, pt * ph * pw * C))
        return self.conv(p, fold_stats=is_raw), (Tn, Hn, Wn)
