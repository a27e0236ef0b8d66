"""Text encoder: BERT-architecture transformer + projection head.

Port of the JAX package's ``models/text_encoder.py``: post-LN blocks,
learned positions, fp32 LayerNorm followed by a cast to the compute type,
exact-erf GELU (HF BERT's, unlike the video tower's tanh), separate
``query``/``key``/``value``/``out`` denses (HF BERT's tensor layout), the
CLS token into the ``ProjectionHead``. The key mask of the attention is the
tokenizer's ``attention_mask``. With ``use_flash`` the packed kernel runs
when the head dim is a multiple of 128, else the ``[B, H, L, Dh]`` one.

Module names follow the flax tree (``word_embeddings``, ``layer{i}``,
``attention``, ``attention_norm`` ...), so ``convert.py`` maps one onto the
other by name.

Under tensor parallelism (``models/layers.shard_layers``) a rank keeps
``H/M`` heads of each ``BertSelfAttention`` (its rows of ``query``/``key``/
``value``, its columns of ``out``) and ``mlp_dim/M`` of each ``BertLayer``'s
``intermediate`` width (its columns of ``output``), as the JAX specs shard
them.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from deepcoro_clip_tpu_torch.models.layers import (
    Dense,
    LayerNorm,
    ProjectionHead,
    _dropout,
    _model_axis,
)
from deepcoro_clip_tpu_torch.ops.attention import multi_head_attention
from deepcoro_clip_tpu_torch.ops.flash_attention import flash_attention
from deepcoro_clip_tpu_torch.ops.flash_attention_packed import flash_attention_packed
from deepcoro_clip_tpu_torch.parallel.distributed import copy_to_model
from deepcoro_clip_tpu_torch.parallel.mesh import ProcessMesh
from deepcoro_clip_tpu_torch.train.state import COLUMN, ROW


class BertSelfAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, dropout: float = 0.1,
                 dtype: torch.dtype = torch.bfloat16, use_flash: bool = True):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.heads = num_heads  # this rank's
        self.dropout, self.use_flash = dropout, use_flash
        self.query = Dense(dim, dim, dtype)
        self.key = Dense(dim, dim, dtype)
        self.value = Dense(dim, dim, dtype)
        self.out = Dense(dim, dim, dtype)

    def shard_(self, grid: ProcessMesh) -> Optional[str]:
        """Keep this rank's ``num_heads / M`` heads, or say why not."""
        n, i = _model_axis(grid)
        if self.num_heads % n:
            return f"{self.num_heads} heads"
        for d in (self.query, self.key, self.value):
            d.shard_(COLUMN, n, i)
        self.out.shard_(ROW, n, i)
        self.heads = self.num_heads // n
        return None

    def forward(self, x, attention_mask, deterministic: bool = True, generator=None):
        B, L, _ = x.shape
        H = self.heads
        hd = self.dim // self.num_heads
        if self.out.model_split is not None:
            x = copy_to_model(x)
        q, k, v = self.query(x), self.key(x), self.value(x)
        if self.use_flash and hd % 128 == 0:
            out = flash_attention_packed(q, k, v, num_heads=H, kv_mask=attention_mask)
        else:
            qh, kh, vh = (t.reshape(B, L, H, hd).transpose(1, 2) for t in (q, k, v))
            if self.use_flash:
                out = flash_attention(qh, kh, vh, kv_mask=attention_mask)
            else:
                m = None if attention_mask is None else attention_mask != 0
                out = multi_head_attention(qh, kh, vh, kv_mask=m)
            out = out.transpose(1, 2).reshape(B, L, H * hd)
        return _dropout(self.out(out), self.dropout, deterministic, generator)


class BertLayer(nn.Module):
    """Post-LN BERT block (HF ``BertLayer``'s tensor layout)."""

    def __init__(self, dim: int, num_heads: int, mlp_dim: int, dropout: float = 0.1,
                 dtype: torch.dtype = torch.bfloat16, use_flash: bool = True):
        super().__init__()
        self.dtype, self.dropout = dtype, dropout
        self.attention = BertSelfAttention(dim, num_heads, dropout, dtype, use_flash)
        self.attention_norm = LayerNorm(dim)
        self.intermediate = Dense(dim, mlp_dim, dtype)
        self.output = Dense(mlp_dim, dim, dtype)
        self.output_norm = LayerNorm(dim)

    def shard_(self, grid: ProcessMesh) -> Optional[str]:
        """Keep this rank's ``mlp_dim / M`` of the intermediate width, or
        say why not (the attention is cut on its own)."""
        n, i = _model_axis(grid)
        if self.intermediate.out_features % n:
            return f"intermediate width {self.intermediate.out_features}"
        self.intermediate.shard_(COLUMN, n, i)
        self.output.shard_(ROW, n, i)
        return None

    def forward(self, x, attention_mask, deterministic: bool = True, generator=None):
        attn = self.attention(x, attention_mask, deterministic, generator)
        x = self.attention_norm(x + attn).to(self.dtype)
        h = x if self.output.model_split is None else copy_to_model(x)
        h = F.gelu(self.intermediate(h))  # exact erf
        h = _dropout(self.output(h), self.dropout, deterministic, generator)
        return self.output_norm(x + h).to(self.dtype)


class TextEncoder(nn.Module):
    def __init__(self, embedding_dim: int = 512, vocab_size: int = 30522,
                 dim: int = 768, depth: int = 12, num_heads: int = 12,
                 mlp_dim: Optional[int] = None, max_positions: int = 512,
                 dropout: float = 0.1, proj_dropout: float = 0.1,
                 dtype: torch.dtype = torch.bfloat16, use_flash: bool = True):
        super().__init__()
        self.dim, self.depth, self.dropout, self.dtype = dim, depth, dropout, dtype
        self.word_embeddings = nn.Embedding(vocab_size, dim)
        self.position_embeddings = nn.Parameter(torch.zeros(max_positions, dim))
        self.embeddings_norm = LayerNorm(dim)
        for i in range(depth):
            self.add_module(f"layer{i}", BertLayer(
                dim, num_heads, mlp_dim or dim * 4, dropout, dtype, use_flash))
        self.proj = ProjectionHead(dim, embedding_dim, dropout=proj_dropout, dtype=dtype)

    def forward(self, input_ids, attention_mask=None, deterministic: bool = True,
                return_hidden: bool = False, generator=None):
        """input_ids: ``[B, L]`` integers; attention_mask: ``[B, L]``
        (nonzero = real token). Returns ``[B, embedding_dim]`` (CLS token ->
        projection head), or the hidden states ``[B, L, dim]`` when
        ``return_hidden``."""
        L = input_ids.shape[1]
        x = self.word_embeddings(input_ids) + self.position_embeddings[None, :L]
        x = self.embeddings_norm(x)
        x = _dropout(x, self.dropout, deterministic, generator).to(self.dtype)
        for i in range(self.depth):
            x = getattr(self, f"layer{i}")(x, attention_mask, deterministic, generator)
        if return_hidden:
            return x
        return self.proj(x[:, 0], deterministic=deterministic, generator=generator)


def text_encoder_from_config(cfg) -> TextEncoder:
    """Build the module on the CPU (zero parameters: load a state dict or
    call ``init_params``)."""
    return TextEncoder(
        embedding_dim=cfg.embedding_dim,
        vocab_size=cfg.text_vocab_size,
        dim=cfg.text_dim,
        depth=cfg.text_depth,
        num_heads=cfg.text_heads,
        max_positions=max(512, cfg.max_text_length),
        dropout=cfg.dropout,
        dtype=torch.bfloat16 if cfg.precision == "bf16" else torch.float32,
        use_flash=cfg.use_pallas_attention,
    )
