"""Location-aware captioning decoder (LocCa).

Port of the JAX package's ``models/locca_decoder.py``, the report decoder
that a ``DeepCORO_clip`` run with ``locca_enabled`` trains beside the
contrastive loss (``train/clip.py``):

- coordinate-conditioned cross-attention: each unpooled video token gets a
  learned embedding (``coord_emb``) of its normalized (t, h, w) grid
  coordinate, added in the vision space before the cross-attention's k/v
  projections, so that the keys carry their location; a multi-video
  memory ``[B, N*L, D]`` repeats the per-video grid N times;
- sinusoidal (not learned) text positions and a sqrt(dim) embedding scale;
- pre-LN layers (``captioning_decoder.DecoderLayer``): causal
  self-attention under the caption mask, cross-attention into the memory,
  a 4x GELU MLP; LayerNorm in fp32;
- an untied fp32 output projection, N(0, 0.02) like the token and
  coordinate embeddings.

Both attentions are the port's ``Attention``: at the LocCa widths (512 / 8
heads, Dh 64) they take the ``[B, H, L, Dh]`` entry, so on the card the
self-attention runs K3/K4 causal with the key mask and the cross-attention
runs them with Lq != Lk. The forward has ``CaptioningDecoder``'s signature,
so ``captioning_decoder.greedy_generate`` decodes with it too.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from deepcoro_clip_tpu_torch.models.captioning_decoder import DecoderLayer
from deepcoro_clip_tpu_torch.models.layers import Dense, LayerNorm, _dropout
from deepcoro_clip_tpu_torch.models.video_encoder import init_params
from deepcoro_clip_tpu_torch.registry import ModelRegistry


def sinusoidal_positions(max_len: int, dim: int) -> np.ndarray:
    """The standard transformer sinusoidal table ``[max_len, dim]``."""
    pos = np.arange(max_len, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, dim, 2, dtype=np.float32) * (-np.log(10000.0) / dim))
    pe = np.zeros((max_len, dim), np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div[: pe[:, 1::2].shape[1]])
    return pe


def grid_coordinates(grid: Tuple[int, int, int], n_special: int = 0) -> np.ndarray:
    """Normalized (t, h, w) in [0, 1] per vision token, zeros for the
    leading special (CLS) tokens: ``[n_special + T*H*W, 3]``."""
    T, H, W = grid
    t, h, w = np.meshgrid(np.arange(T), np.arange(H), np.arange(W), indexing="ij")
    coords = np.stack([t / max(T - 1, 1), h / max(H - 1, 1), w / max(W - 1, 1)],
                      axis=-1).reshape(-1, 3).astype(np.float32)
    if n_special:
        coords = np.concatenate([np.zeros((n_special, 3), np.float32), coords], 0)
    return coords


@ModelRegistry.register("locca_decoder")
class LocCaDecoder(nn.Module):
    def __init__(self, vocab_size: int = 30522, dim: int = 512, depth: int = 4,
                 num_heads: int = 8, max_length: int = 128, memory_dim: int = 512,
                 dropout: float = 0.1, dtype: torch.dtype = torch.bfloat16,
                 use_flash: bool = True,
                 token_grid: Optional[Tuple[int, int, int]] = None,
                 n_special_tokens: int = 0):
        """``token_grid``: the backbone's final token grid (T', H', W');
        None leaves the cross-attention unconditioned."""
        super().__init__()
        self.vocab_size, self.dim, self.depth = vocab_size, dim, depth
        self.num_heads, self.max_length = num_heads, max_length
        self.dropout, self.dtype = dropout, dtype
        self.token_grid, self.n_special_tokens = token_grid, n_special_tokens
        self.token_emb = nn.Embedding(vocab_size, dim)
        self.register_buffer("pe", torch.from_numpy(sinusoidal_positions(max_length, dim)),
                             persistent=False)
        if token_grid is not None:
            self.coord_emb = Dense(3, memory_dim, dtype)
            self.register_buffer(
                "coords", torch.from_numpy(grid_coordinates(token_grid, n_special_tokens)),
                persistent=False)
        for i in range(depth):
            self.add_module(f"layer{i}", DecoderLayer(dim, num_heads, dropout, dtype,
                                                      use_flash, memory_dim=memory_dim))
        self.norm = LayerNorm(dim)
        self.lm_head = Dense(dim, vocab_size, torch.float32)

    def forward(self, input_ids, video_tokens, attention_mask=None,
                deterministic: bool = True, generator=None):
        """input_ids: ``[B, L]``; video_tokens: ``[B, Lv, memory_dim]``;
        attention_mask: ``[B, L]``, nonzero = a real token. Returns the
        next-token logits ``[B, L, vocab]`` in fp32."""
        L = input_ids.shape[1]
        tok = self.token_emb(input_ids.long())
        x = (tok * math.sqrt(self.dim) + self.pe[None, :L]).to(self.dtype)
        x = _dropout(x, self.dropout, deterministic, generator)
        memory = video_tokens.to(self.dtype)
        if self.token_grid is not None:
            Lc, Lm = self.coords.shape[0], memory.shape[1]
            if Lm % Lc != 0:
                # location conditioning is the module's purpose: a silent
                # skip would train a plain decoder while the config says
                # LocCa is on
                raise ValueError(
                    f"LocCaDecoder token_grid {self.token_grid} (+"
                    f"{self.n_special_tokens} special) gives {Lc} coords, "
                    f"but memory has {Lm} tokens (not a multiple); check "
                    "locca_token_grid against the backbone's grid")
            loc = self.coord_emb(self.coords)
            if Lm != Lc:
                loc = loc.repeat(Lm // Lc, 1)
            memory = memory + loc[None]
        for i in range(self.depth):
            x = getattr(self, f"layer{i}")(x, memory, self_mask=attention_mask,
                                           deterministic=deterministic, generator=generator)
        return self.lm_head(self.norm(x))


def init_locca_decoder(decoder: LocCaDecoder, seed: int = 0) -> LocCaDecoder:
    """Random init from ``seed``: ``init_params``'s initializers, with the
    JAX module's N(0, 0.02) for the token embedding, the coordinate
    embedding's and the output projection's weights."""
    init_params(decoder, seed)
    g = torch.Generator().manual_seed(seed + 1)
    weights = [decoder.token_emb.weight, decoder.lm_head.weight]
    if decoder.token_grid is not None:
        weights.append(decoder.coord_emb.weight)
    with torch.no_grad():
        for w in weights:
            nn.init.normal_(w, std=0.02, generator=g)
    return decoder


def locca_token_grid(config) -> Tuple[Tuple[int, int, int], int]:
    """(T', H', W') of the backbone's final token grid and the special-token
    count, from the config: the patch grid rounded up (the patchify pads a
    partial patch), H and W halved at each pool stage."""
    pt, ph, pw = tuple(config.vit_patch)
    T = -(-config.frames // pt)
    H = -(-config.resize // ph)
    W = -(-config.resize // pw)
    for _ in tuple(config.vit_pool_stages or ()):
        H //= 2
        W //= 2
    n_special = 1 if getattr(config, "use_cls_token", True) else 0
    return (T, H, W), n_special


def locca_decoder_from_config(config, memory_dim: int) -> LocCaDecoder:
    """The contrastive run's LocCa head (on the CPU, parameters unset: call
    ``init_locca_decoder`` or load a state dict)."""
    grid, n_special = locca_token_grid(config)
    return LocCaDecoder(
        vocab_size=config.text_vocab_size, dim=config.locca_d_model,
        depth=config.locca_num_layers, num_heads=config.locca_num_heads,
        max_length=config.locca_max_seq_len, memory_dim=memory_dim,
        dropout=config.dropout,
        dtype=torch.bfloat16 if config.precision == "bf16" else torch.float32,
        use_flash=config.use_pallas_attention, token_grid=grid,
        n_special_tokens=n_special)
