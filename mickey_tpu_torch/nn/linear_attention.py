"""Linear (ELU-kernel) self-attention transformer inside the heads
(``mickey_tpu/nn/linear_attention.py``): 3 LoFTR encoder layers, 8 heads,
optional 2-D sinusoidal position encoding. Also the reference's other
variants: softmax ``full_attention`` and the alternating self / cross
``self_cross_transformer`` (Transformer_att)."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .common import layernorm, linear


def sine_position_encoding(d_model: int, h: int, w: int) -> np.ndarray:
    """2-D sinusoidal PE (h, w, d_model) with 1-based cumsum positions."""
    pe = np.zeros((d_model, h, w), dtype=np.float32)
    y_pos = np.cumsum(np.ones((h, w), np.float32), axis=0)[None]
    x_pos = np.cumsum(np.ones((h, w), np.float32), axis=1)[None]
    div = np.exp(np.arange(0, d_model // 2, 2, dtype=np.float32) * (-math.log(10000.0) / (d_model // 2)))
    div = div[:, None, None]
    pe[0::4] = np.sin(x_pos * div)
    pe[1::4] = np.cos(x_pos * div)
    pe[2::4] = np.sin(y_pos * div)
    pe[3::4] = np.cos(y_pos * div)
    return np.transpose(pe, (1, 2, 0))


def linear_attention(q, k, v, eps: float = 1e-6):
    """O(N) attention with elu+1 feature maps; q, k, v (B, S, H, D)."""
    Q = F.elu(q) + 1.0
    K = F.elu(k) + 1.0
    v_length = v.shape[1]
    values = v / v_length  # fp16-overflow guard kept for parity (attention.py:59)
    KV = torch.einsum("nshd,nshv->nhdv", K, values)
    Z = 1.0 / (torch.einsum("nlhd,nhd->nlh", Q, K.sum(dim=1)) + eps)
    return torch.einsum("nlhd,nhdv,nlh->nlhv", Q, KV, Z) * v_length


def _encoder_layer(lp, x: torch.Tensor, source: torch.Tensor, attention, nheads: int = 8) -> torch.Tensor:
    """LoFTR encoder layer (transformer_utils.py:40-66): queries from x, keys
    and values from source; x, source (B, S, C)."""
    b, s, c = x.shape
    d = c // nheads
    q = linear(lp["q_proj"], x).reshape(b, -1, nheads, d)
    k = linear(lp["k_proj"], source).reshape(b, -1, nheads, d)
    v = linear(lp["v_proj"], source).reshape(b, -1, nheads, d)
    msg = linear(lp["merge"], attention(q, k, v).reshape(b, s, c))
    msg = layernorm(lp["norm1"], msg)
    msg = linear(lp["mlp_fc2"], torch.relu(linear(lp["mlp_fc1"], torch.cat([x, msg], dim=-1))))
    return x + layernorm(lp["norm2"], msg)


def _encoder_layer_apply(lp, x: torch.Tensor, source: torch.Tensor, nheads: int = 8) -> torch.Tensor:
    return _encoder_layer(lp, x, source, linear_attention, nheads)


def _encoder_layer_apply_full(lp, x: torch.Tensor, source: torch.Tensor, nheads: int = 8) -> torch.Tensor:
    """The encoder layer with softmax attention (attention='full')."""
    return _encoder_layer(lp, x, source, full_attention, nheads)


def _with_pos_enc(fmap: torch.Tensor) -> torch.Tensor:
    _, h, w, c = fmap.shape
    return fmap + torch.from_numpy(sine_position_encoding(c, h, w)).to(fmap)[None]


def self_attention_transformer(params, fmap: torch.Tensor, add_pos_enc: bool = False) -> torch.Tensor:
    """fmap (B, H, W, C) -> (B, H, W, C)."""
    b, h, w, c = fmap.shape
    if add_pos_enc:
        fmap = _with_pos_enc(fmap)
    x = fmap.reshape(b, h * w, c)
    for lp in params["layers"]:
        x = _encoder_layer_apply(lp, x, x)
    return x.reshape(b, h, w, c)


def full_attention(q, k, v):
    """O(N^2) softmax attention (att_layers/attention.py:23-44); q, k, v (B, S, H, D)."""
    logits = torch.einsum("nlhd,nshd->nlsh", q, k) / math.sqrt(q.shape[-1])
    return torch.einsum("nlsh,nshd->nlhd", torch.softmax(logits, dim=2), v)


def self_cross_transformer(params, fmap0: torch.Tensor, fmap1: torch.Tensor, add_pos_enc: bool = False):
    """Alternating self / cross attention over two (B, H, W, C) maps
    (Transformer_att.forward, transformer.py:135-172): even layers attend
    within each map, odd layers each map to the other."""
    b, h, w, c = fmap0.shape
    if add_pos_enc:
        fmap0, fmap1 = _with_pos_enc(fmap0), _with_pos_enc(fmap1)
    x0, x1 = fmap0.reshape(b, h * w, c), fmap1.reshape(b, h * w, c)
    for i, lp in enumerate(params["layers"]):
        if i % 2 == 0:
            x0, x1 = _encoder_layer_apply(lp, x0, x0), _encoder_layer_apply(lp, x1, x1)
        else:
            x0, x1 = _encoder_layer_apply(lp, x0, x1), _encoder_layer_apply(lp, x1, x0)
    return x0.reshape(b, h, w, c), x1.reshape(b, h, w, c)
