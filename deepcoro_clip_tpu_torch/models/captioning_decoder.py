"""Autoregressive captioning decoder over video tokens.

Port of the JAX package's ``models/captioning_decoder.py``: pre-LN decoder
layers with causal self-attention under the captions' padding mask and
cross-attention into the projected video tokens, learned positions, an
embedding LayerNorm, an fp32 LM head, and greedy or temperature-sampled
generation.

The attention is the port's ``Attention`` (``models/layers.py``). At the
multitask widths (512 / 8 heads, Dh 64) both attentions take the
``[B, H, L, Dh]`` entry, so on the card the self-attention runs K3/K4 in
causal mode with the key mask and the cross-attention runs them with
Lq != Lk (``ops/flash_attention.py``).

Generation:

- ``greedy_generate``: each step re-runs the whole decoder under the causal
  mask (O(L^2) work; the reference the cached path is held to);
- ``greedy_generate_kv``: one token a step against a preallocated fp32 K/V
  cache per layer, the cross-attention K/V computed once per layer, written
  out in plain torch over the decoder's own parameters, in fp32 (the JAX
  version is plain ``jnp``; no kernel is involved).

Temperature sampling draws from a ``torch.Generator``; the JAX package draws
from ``jax.random``, so sampled captions differ between the two (greedy
ones do not).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from deepcoro_clip_tpu_torch.models.layers import (
    Attention,
    Dense,
    LayerNorm,
    MlpBlock,
    _dropout,
)


class DecoderLayer(nn.Module):
    """Pre-LN causal self-attention, cross-attention into ``memory`` (of
    width ``memory_dim``, ``dim`` unless given) and a 4x MLP; the layer of
    the captioning decoder and of ``models/locca_decoder.LocCaDecoder``."""

    def __init__(self, dim: int, num_heads: int, dropout: float = 0.0,
                 dtype: torch.dtype = torch.bfloat16, use_flash: bool = True,
                 memory_dim: Optional[int] = None):
        super().__init__()
        self.dtype = dtype
        self.norm1 = LayerNorm(dim)
        self.self_attn = Attention(dim, num_heads, dropout, dtype, use_flash)
        self.norm2 = LayerNorm(dim)
        self.cross_attn = Attention(dim, num_heads, dropout, dtype, use_flash, cross=True,
                                    context_dim=memory_dim)
        self.norm3 = LayerNorm(dim)
        self.mlp = MlpBlock(dim, dim * 4, dim, dropout, dtype)

    def forward(self, x, memory, self_mask=None, deterministic: bool = True,
                generator=None):
        h = self.norm1(x).to(self.dtype)
        x = x + self.self_attn(h, kv_mask=self_mask, causal=True,
                               deterministic=deterministic, generator=generator)
        h = self.norm2(x).to(self.dtype)
        x = x + self.cross_attn(h, context=memory, deterministic=deterministic,
                                generator=generator)
        h = self.norm3(x).to(self.dtype)
        return x + self.mlp(h, deterministic=deterministic, generator=generator)


class CaptioningDecoder(nn.Module):
    def __init__(self, vocab_size: int = 30522, dim: int = 512, depth: int = 4,
                 num_heads: int = 8, max_length: int = 128, memory_dim: int = 512,
                 dropout: float = 0.1, dtype: torch.dtype = torch.bfloat16,
                 use_flash: bool = True):
        super().__init__()
        self.vocab_size, self.dim, self.depth = vocab_size, dim, depth
        self.num_heads, self.max_length = num_heads, max_length
        self.dropout, self.dtype = dropout, dtype
        self.token_emb = nn.Embedding(vocab_size, dim)
        self.pos_emb = nn.Parameter(torch.zeros(max_length, dim))
        self.embed_norm = LayerNorm(dim)
        self.memory_proj = Dense(memory_dim, dim, dtype)
        for i in range(depth):
            self.add_module(f"layer{i}", DecoderLayer(dim, num_heads, dropout, dtype,
                                                      use_flash))
        self.norm = LayerNorm(dim)
        self.lm_head = Dense(dim, vocab_size, torch.float32)

    def forward(self, input_ids, video_tokens, attention_mask=None,
                deterministic: bool = True, generator=None):
        """input_ids: ``[B, L]``; video_tokens: ``[B, Lv, memory_dim]``;
        attention_mask: ``[B, L]``, nonzero = a real token. Returns the
        next-token logits ``[B, L, vocab]`` in fp32."""
        L = input_ids.shape[1]
        x = self.embed_norm(self.token_emb(input_ids.long()) + self.pos_emb[None, :L])
        x = _dropout(x, self.dropout, deterministic, generator).to(self.dtype)
        memory = self.memory_proj(video_tokens)
        for i in range(self.depth):
            x = getattr(self, f"layer{i}")(x, memory, self_mask=attention_mask,
                                           deterministic=deterministic,
                                           generator=generator)
        return self.lm_head(self.norm(x))


def _next_token(logits, temperature: float, generator):
    if temperature > 0.0:
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]
    return logits.argmax(dim=-1)


@torch.no_grad()
def greedy_generate(decoder: nn.Module, video_tokens, bos_id: int, eos_id: int,
                    max_length: Optional[int] = None, temperature: float = 0.0,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Static-shape greedy (or sampled) decoding by full recompute, with a
    ``CaptioningDecoder`` or a ``models/locca_decoder.LocCaDecoder``.
    Returns ``[B, max_length]`` int32 ids, BOS first, 0 after EOS."""
    max_length = max_length or decoder.max_length
    B = video_tokens.shape[0]
    dev = video_tokens.device
    ids = torch.zeros((B, max_length), dtype=torch.int32, device=dev)
    ids[:, 0] = bos_id
    finished = torch.zeros((B,), dtype=torch.bool, device=dev)
    for i in range(max_length - 1):
        logits = decoder(ids, video_tokens, deterministic=True)
        nxt = _next_token(logits[:, i], temperature, generator)
        nxt = torch.where(finished, 0, nxt).to(torch.int32)
        ids[:, i + 1] = nxt
        finished = finished | (nxt == eos_id)
    return ids


def _ln(norm: LayerNorm, x):
    return F.layer_norm(x, norm.normalized_shape, norm.weight, norm.bias, norm.eps)


def _d(dense: Dense, x):
    return dense.linear(x, x.dtype)


@torch.no_grad()
def greedy_generate_kv(decoder: CaptioningDecoder, video_tokens, bos_id: int,
                       eos_id: int, max_length: Optional[int] = None,
                       temperature: float = 0.0,
                       generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Incremental greedy (or sampled) decoding with a K/V cache.

    Same contract as ``greedy_generate``, O(L) work a step instead of
    O(L^2): a preallocated fp32 cache ``[depth, B, H, max_length, Dh]``,
    the cross-attention K/V computed once per layer, one token a step
    through the decoder's own parameters, all in fp32. Under tensor
    parallelism ``H`` is this rank's heads and the row-parallel products
    sum over the model group (``Dense.linear``)."""
    max_length = max_length or decoder.max_length
    Dh = decoder.dim // decoder.num_heads
    H = decoder.layer0.self_attn.heads if decoder.depth else decoder.num_heads
    D = H * Dh
    B = video_tokens.shape[0]
    dev = video_tokens.device
    layers = [getattr(decoder, f"layer{i}") for i in range(decoder.depth)]

    memory = _d(decoder.memory_proj, video_tokens.float())
    cross = []  # per layer: K and V [B, H, Lv, Dh]
    for lp in layers:
        ca = lp.cross_attn
        cross.append(tuple(_d(p, memory).reshape(B, -1, H, Dh).transpose(1, 2)
                           for p in (ca.k, ca.v)))
    scale = Dh ** -0.5
    cache_k = torch.zeros((decoder.depth, B, H, max_length, Dh), device=dev)
    cache_v = torch.zeros_like(cache_k)
    positions = torch.arange(max_length, device=dev)
    ids = torch.zeros((B, max_length), dtype=torch.int32, device=dev)
    ids[:, 0] = bos_id
    finished = torch.zeros((B,), dtype=torch.bool, device=dev)

    for t in range(max_length - 1):
        x = _ln(decoder.embed_norm,
                decoder.token_emb.weight[ids[:, t].long()] + decoder.pos_emb[t])
        for i, lp in enumerate(layers):
            h = _ln(lp.norm1, x)
            q, k, v = _d(lp.self_attn.qkv, h).split(D, dim=-1)
            cache_k[i, :, :, t] = k.reshape(B, H, Dh)
            cache_v[i, :, :, t] = v.reshape(B, H, Dh)
            att = torch.einsum("bhd,bhld->bhl", q.reshape(B, H, Dh), cache_k[i]) * scale
            att = att.masked_fill(positions[None, None, :] > t, -1e30)
            o = torch.einsum("bhl,bhld->bhd", att.softmax(-1), cache_v[i]).reshape(B, D)
            x = x + _d(lp.self_attn.proj, o)

            h = _ln(lp.norm2, x)
            kx, vx = cross[i]
            att = torch.einsum("bhd,bhld->bhl",
                               _d(lp.cross_attn.q, h).reshape(B, H, Dh), kx) * scale
            o = torch.einsum("bhl,bhld->bhd", att.softmax(-1), vx).reshape(B, D)
            x = x + _d(lp.cross_attn.proj, o)

            h = _ln(lp.norm3, x)
            x = x + _d(lp.mlp.fc2, F.gelu(_d(lp.mlp.fc1, h), approximate="tanh"))
        logits = _d(decoder.lm_head, _ln(decoder.norm, x))
        nxt = _next_token(logits, temperature, generator)
        nxt = torch.where(finished, 0, nxt).to(torch.int32)
        ids[:, t + 1] = nxt
        finished = finished | (nxt == eos_id)
    return ids
