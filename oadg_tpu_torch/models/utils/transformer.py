"""Transformer blocks of the DETR family (port of
``oadg_tpu/models/utils/transformer.py``): the JAX package has no Pallas
kernel here, so these are tensor ops.

- ``SinePositionalEncoding`` (``:19``): the (H, W, 2 * num_feats) map in
  numpy float64 as the JAX one forms it (positions ``1 .. H`` and ``1 .. W``
  over the last plus 1e-6, times 2 pi; sines and cosines interleaved; y's
  channels before x's), cast to float32 once and kept per (H, W, device).
- ``MultiheadAttention``: flax's ``MultiHeadDotProductAttention`` written
  out with ``nn.MultiheadAttention``'s parameters (``in_proj_weight`` rows
  ``[q; k; v]``, head ``h`` on rows ``h * D ..``, ``out_proj``): the query
  over ``sqrt(D)`` before the product, no mask (the JAX heads pass none,
  so a padded canvas's zero cells take part, as in JAX), the softmax in the
  compute dtype. ``Attention`` is mmcv's wrapper (the module under ``attn``).
- ``FFN`` (``:48``): ``fc1`` -> ReLU -> ``fc2`` with the residual inside,
  mmdet's keys ``layers.0.0`` and ``layers.1``.
- ``EncoderLayer`` / ``DecoderLayer`` (``:62``, ``:80``): post-norm, keys
  ``attentions.{0,1}``, ``ffns.0``, ``norms.{k}``; every LayerNorm has
  flax's epsilon 1e-6 and normalizes in float32, cast back to its input's
  dtype.
- ``Transformer`` (``:102``): ``encoder.layers.{i}`` and
  ``decoder.layers.{i}``; the decoder starts from zeros and returns every
  layer's output (L, B, Q, C) with no final norm (mmdet's
  ``decoder.post_norm`` has no JAX counterpart; ROADMAP C).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..layers import Linear, _reduced, lecun_normal_

LN_EPS = 1e-6                   # flax's LayerNorm epsilon


class SinePositionalEncoding:
    """``:19``: ``__call__(h, w, device)`` -> (H, W, 2 * num_feats) float32."""

    def __init__(self, num_feats: int = 128):
        self.num_feats = num_feats
        self._cache = {}

    def numpy(self, h: int, w: int) -> np.ndarray:
        y = np.arange(1, h + 1, dtype=np.float32)[:, None] * np.ones((1, w))
        x = np.arange(1, w + 1, dtype=np.float32)[None, :] * np.ones((h, 1))
        eps, scale = 1e-6, 2 * np.pi
        y = y / (y[-1:, :] + eps) * scale
        x = x / (x[:, -1:] + eps) * scale
        dim_t = 10000 ** (2 * (np.arange(self.num_feats) // 2) / self.num_feats)
        pos_x = x[..., None] / dim_t
        pos_y = y[..., None] / dim_t
        pos_x = np.stack([np.sin(pos_x[..., 0::2]), np.cos(pos_x[..., 1::2])],
                         axis=-1).reshape(h, w, -1)
        pos_y = np.stack([np.sin(pos_y[..., 0::2]), np.cos(pos_y[..., 1::2])],
                         axis=-1).reshape(h, w, -1)
        return np.concatenate([pos_y, pos_x], axis=-1).astype(np.float32)

    def __call__(self, h: int, w: int, device) -> torch.Tensor:
        key = (h, w, str(device))
        if key not in self._cache:
            self._cache[key] = torch.from_numpy(self.numpy(h, w)).to(device)
        return self._cache[key]


def layer_norm(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """flax's ``LayerNorm``: statistics in float32 (float64 for a float64
    input), the result in ``x``'s dtype."""
    return norm(x.to(torch.promote_types(x.dtype, torch.float32))).to(x.dtype)


def ln(channels: int, device=None) -> nn.LayerNorm:
    return nn.LayerNorm(channels, eps=LN_EPS, device=device)


class MultiheadAttention(nn.Module):
    """Attention of ``query`` (B, Q, E) over ``key`` (B, K, E) (``query``
    where None) and ``value`` (``key`` where None), computed as flax's
    ``MultiHeadDotProductAttention``: q, k, v and the output projection in
    the compute dtype (bias added in it), q over ``sqrt(D)`` cast to it, the
    logits and the softmax in it."""

    def __init__(self, embed_dims: int, num_heads: int, device=None, dtype=None):
        super().__init__()
        self.num_heads = num_heads
        self.compute_dtype = dtype
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dims, embed_dims,
                                                       device=device))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dims, device=device))
        self.out_proj = Linear(embed_dims, embed_dims, device=device, dtype=dtype)

    def init_weights(self, gen: torch.Generator):
        lecun_normal_(self.in_proj_weight, gen)
        nn.init.zeros_(self.in_proj_bias)

    def forward(self, query: torch.Tensor, key=None, value=None) -> torch.Tensor:
        """-> (B, Q, E) in the compute dtype (float32 without one)."""
        dt = self.compute_dtype if _reduced(self.compute_dtype) else torch.float32
        b, q, e = query.shape
        h = self.num_heads
        d = e // h
        key = query if key is None else key
        value = key if value is None else value
        w, bias = self.in_proj_weight.to(dt), self.in_proj_bias.to(dt)
        qh, kh, vh = (F.linear(x.to(dt), w[i * e:(i + 1) * e]) + bias[i * e:(i + 1) * e]
                      for i, x in enumerate((query, key, value)))
        qh = qh.reshape(b, q, h, d) / torch.tensor(math.sqrt(d), dtype=torch.float32).to(dt)
        kh, vh = kh.reshape(b, -1, h, d), vh.reshape(b, -1, h, d)
        logits = torch.einsum("bqhd,bkhd->bhqk", qh, kh)
        if dt == torch.float32:
            att = torch.softmax(logits, -1)
        else:                              # jax.nn.softmax in the compute dtype
            ex = torch.exp(logits - logits.amax(-1, keepdim=True))
            att = ex / ex.sum(-1, keepdim=True)
        out = torch.einsum("bhqk,bkhd->bqhd", att, vh).reshape(b, q, e)
        return self.out_proj(out)


class Attention(nn.Module):
    """mmcv's ``MultiheadAttention`` wrapper: the module under ``attn``."""

    def __init__(self, embed_dims: int, num_heads: int, device=None, dtype=None):
        super().__init__()
        self.attn = MultiheadAttention(embed_dims, num_heads, device=device, dtype=dtype)

    def forward(self, query, key=None, value=None):
        return self.attn(query, key, value)


class FFN(nn.Module):
    """``:48``: ``x + fc2(relu(fc1(x)))``; keys ``layers.0.0``, ``layers.1``."""

    def __init__(self, embed_dims: int, feedforward_channels: int, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.layers = nn.ModuleList([nn.ModuleList([Linear(embed_dims, feedforward_channels,
                                                           **kw)]),
                                     Linear(feedforward_channels, embed_dims, **kw)])

    def forward(self, x):
        return x + self.layers[1](torch.relu(self.layers[0][0](x)))


def init_attention(module: nn.Module, gen: torch.Generator):
    """Every ``MultiheadAttention`` under ``module``: its input projection
    LeCun-normal (the FCs are drawn by the detector's ``init_default_``)."""
    for m in module.modules():
        if isinstance(m, MultiheadAttention):
            m.init_weights(gen)


class EncoderLayer(nn.Module):
    """``:62``: self-attention with the positions on query and key, norm,
    FFN, norm."""

    def __init__(self, embed_dims: int, num_heads: int, feedforward_channels: int,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.attentions = nn.ModuleList([Attention(embed_dims, num_heads, **kw)])
        self.ffns = nn.ModuleList([FFN(embed_dims, feedforward_channels, **kw)])
        self.norms = nn.ModuleList([ln(embed_dims, device) for _ in range(2)])

    def forward(self, x, pos):
        q = x + pos
        x = layer_norm(self.norms[0], x + self.attentions[0](q, q, x))
        return layer_norm(self.norms[1], self.ffns[0](x))


class DecoderLayer(nn.Module):
    """``:80``: self-attention (query positions on query and key), norm,
    cross-attention (query positions on the query, the memory's on its
    key), norm, FFN, norm."""

    def __init__(self, embed_dims: int, num_heads: int, feedforward_channels: int,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.attentions = nn.ModuleList([Attention(embed_dims, num_heads, **kw)
                                         for _ in range(2)])
        self.ffns = nn.ModuleList([FFN(embed_dims, feedforward_channels, **kw)])
        self.norms = nn.ModuleList([ln(embed_dims, device) for _ in range(3)])

    def forward(self, tgt, memory, query_pos, mem_pos):
        q = tgt + query_pos
        tgt = layer_norm(self.norms[0], tgt + self.attentions[0](q, q, tgt))
        ca = self.attentions[1](tgt + query_pos, memory + mem_pos, memory)
        tgt = layer_norm(self.norms[1], tgt + ca)
        return layer_norm(self.norms[2], self.ffns[0](tgt))


class LayerStack(nn.Module):
    """mmdet's encoder or decoder module: its layers under ``layers``."""

    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class Transformer(nn.Module):
    """``:102``: ``forward(x (B, HW, C), pos (HW, C), query_embed (Q, C))``
    -> (L, B, Q, C), every decoder layer's output."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8, num_encoder_layers: int = 6,
                 num_decoder_layers: int = 6, feedforward_channels: int = 2048,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.embed_dims = embed_dims
        self.encoder = LayerStack([EncoderLayer(embed_dims, num_heads, feedforward_channels, **kw)
                               for _ in range(num_encoder_layers)])
        self.decoder = LayerStack([DecoderLayer(embed_dims, num_heads, feedforward_channels, **kw)
                               for _ in range(num_decoder_layers)])

    def forward(self, x, pos, query_embed):
        posb = pos[None]
        for layer in self.encoder.layers:
            x = layer(x, posb)
        b, q = x.shape[0], query_embed.shape[0]
        tgt = x.new_zeros((b, q, self.embed_dims))
        qpos = query_embed[None].expand(b, q, self.embed_dims)
        outs = []
        for layer in self.decoder.layers:
            tgt = layer(tgt, x, qpos, posb)
            outs.append(tgt)
        return torch.stack(outs)
