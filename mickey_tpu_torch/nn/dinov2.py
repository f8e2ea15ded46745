"""Frozen DINOv2 ViT backbone (``mickey_tpu/nn/dinov2.py``), inference only.

Patch-14 ViT with LayerScale, pre-norm blocks and an exact-GELU MLP
(``fc1``, ``fc2``) or, as DINOv2 ViT-g/14 has, a SwiGLU FFN (``w12``,
``w3``). Every block linear goes through ``quant.maybe_linear``: the int8
product where the tree was quantized (``MICKEY.DINOV2.INT8``), else the
dtype's. Compute
runs in the backbone dtype (bf16 by default; fp32 with
``MICKEY.DINOV2.FLOAT16=False``, the exact mode) with LayerNorm statistics in
fp32. Attention goes through ``ops.flash_attention.flash_attention_packed``
on the head-major packed qkv (``packed=True``, the default) or through
``flash_attention`` on its (B, H, S, D) views (``TPU.PACKED_ATTENTION=False``);
both pick their kernel by the dtype (bf16: K1 / K1b, fp32: K1f).
The sequence (1939 tokens for ViT-L at 714x532) is not padded: the attention
kernels mask their own ragged tile.

Tensor parallelism (``tp``, a ``parallel.TensorParallel`` of size > 1, on
the rank's tree from ``parallel.shard_backbone``): Megatron's pattern, as
``mickey_tpu``'s ``_block_apply`` on a (data, model) mesh. qkv is the rank's
column shard, so its output is the packed (B, S, 3C/tp) array of the rank's
num_heads / tp whole heads, which the attention kernels take unchanged;
proj is the rank's row shard, applied without its bias, its partial sums
summed over the model group in the compute dtype and the bias added after;
fc1 and fc2 likewise. LayerNorm, LayerScale, the embeddings and SwiGLU's
``w12`` / ``w3`` are whole on every rank, so every rank ends with the same
tokens.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.flash_attention import flash_attention, flash_attention_packed, qkv_heads
from .common import layernorm
from .quant import maybe_linear

VIT_CONFIGS = {
    "vit_small": dict(embed_dim=384, depth=12, num_heads=6),
    "vit_base": dict(embed_dim=768, depth=12, num_heads=12),
    "vit_large": dict(embed_dim=1024, depth=24, num_heads=16),
    "vit_giant2": dict(embed_dim=1536, depth=40, num_heads=24),
}


def swiglu_hidden_dim(dim: int, mlp_ratio: float = 4.0) -> int:
    """The SwiGLU FFN's hidden size: 2/3 of the MLP's, rounded up to a
    multiple of 8 (reference swiglu_ffn.py:56)."""
    return (int(dim * mlp_ratio * 2 / 3) + 7) // 8 * 8


def _torch_bicubic_matrix(n_src: int, n_dst: int, scale: float) -> np.ndarray:
    """1-D cubic-convolution resize matrix (a = -0.75, half-pixel centres,
    clamped borders) with the given scale factor: out = M @ src."""
    a = -0.75

    def k(x):
        x = abs(x)
        if x <= 1:
            return (a + 2) * x**3 - (a + 3) * x**2 + 1
        if x < 2:
            return a * x**3 - 5 * a * x**2 + 8 * a * x - 4 * a
        return 0.0

    M = np.zeros((n_dst, n_src), dtype=np.float64)
    for i in range(n_dst):
        x = (i + 0.5) / scale - 0.5
        x0 = math.floor(x)
        for tap in range(-1, 3):
            M[i, min(max(x0 + tap, 0), n_src - 1)] += k(x - (x0 + tap))
    return M.astype(np.float32)


@functools.lru_cache(maxsize=16)
def _pos_embed_matrices(n_side: int, h0: int, w0: int):
    # the reference's +0.1 scale-factor fudge (dinov2.py:179)
    return (_torch_bicubic_matrix(n_side, h0, (h0 + 0.1) / n_side),
            _torch_bicubic_matrix(n_side, w0, (w0 + 0.1) / n_side))


def interpolate_pos_encoding(pos_embed: torch.Tensor, h0: int, w0: int) -> torch.Tensor:
    """pos_embed (1, N+1, C) -> (1, h0*w0 + 1, C) by bicubic resize."""
    n_side = int(round(math.sqrt(pos_embed.shape[1] - 1)))
    if (h0, w0) == (n_side, n_side):
        return pos_embed
    patch_pe = pos_embed[:, 1:].reshape(1, n_side, n_side, -1).float()
    Wh, Ww = (torch.from_numpy(m).to(pos_embed.device) for m in _pos_embed_matrices(n_side, h0, w0))
    out = torch.einsum("hs,bstc->bhtc", Wh, patch_pe)
    out = torch.einsum("wt,bhtc->bhwc", Ww, out).reshape(1, h0 * w0, -1)
    return torch.cat([pos_embed[:, :1], out.to(pos_embed.dtype)], dim=1)


def _tp_size(tp) -> int:
    return 1 if tp is None else tp.size


def row_parallel_linear(p, x: torch.Tensor, tp) -> torch.Tensor:
    """A row-parallel linear: the rank's partial product, summed over the
    model group in x's dtype, then the whole bias. With no tensor
    parallelism the plain (or int8) linear."""
    if _tp_size(tp) == 1:
        return maybe_linear(p, x)
    if "w_q" in p:
        raise ValueError("tensor parallelism does not split an int8 backbone")
    out = tp.all_reduce_sum_(F.linear(x, p["w"].to(x.dtype)))
    return out if p.get("b") is None else out + p["b"].to(x.dtype)


def block_apply(x: torch.Tensor, bp, num_heads: int, packed: bool = True, tp=None) -> torch.Tensor:
    """One pre-norm ViT block with LayerScale; x (B, S, C) in the compute
    dtype. ``tp``: the model group whose rank's shard ``bp`` is (module
    docstring), or None."""
    if num_heads % _tp_size(tp):
        raise ValueError(f"tensor-parallel size {_tp_size(tp)} must divide num_heads={num_heads}")
    heads = num_heads // _tp_size(tp)
    h = layernorm(bp["norm1"], x.float(), eps=1e-6).to(x.dtype)
    qkv = maybe_linear(bp["attn"]["qkv"], h)  # (B, S, 3C / tp), head-major columns, in x's dtype under int8 too
    if qkv.shape[-1] * _tp_size(tp) != 3 * x.shape[-1]:
        raise ValueError(f"qkv gives {qkv.shape[-1]} columns for width {x.shape[-1]} at tp={_tp_size(tp)}: "
                         "the block is not this rank's shard (parallel.shard_backbone)")
    if packed:
        attn = flash_attention_packed(qkv, heads)
    else:
        b, s, c3 = qkv.shape
        attn = flash_attention(*qkv_heads(qkv, heads), s).transpose(1, 2).reshape(b, s, c3 // 3)
    x = x + bp["ls1"]["gamma"].to(x.dtype) * row_parallel_linear(bp["attn"]["proj"], attn, tp)
    h = layernorm(bp["norm2"], x.float(), eps=1e-6).to(x.dtype)
    mlp = bp["mlp"]
    if "fc1" in mlp:
        h = row_parallel_linear(mlp["fc2"], F.gelu(maybe_linear(mlp["fc1"], h), approximate="none"), tp)
    else:  # SwiGLU (swiglu_ffn.py:29-33), whole on every rank
        h1, h2 = maybe_linear(mlp["w12"], h).chunk(2, dim=-1)
        h = maybe_linear(mlp["w3"], F.silu(h1) * h2)
    return x + bp["ls2"]["gamma"].to(x.dtype) * h


def vit_forward_features(params, images: torch.Tensor, num_heads: int, patch_size: int = 14,
                         dtype: torch.dtype = torch.bfloat16, packed: bool = True, tp=None) -> torch.Tensor:
    """images (B, H, W, 3) in [0, 1] -> patch tokens (B, H/14 * W/14, C), fp32;
    ``tp`` as ``block_apply``'s."""
    b, h, w, c_in = images.shape
    h0, w0 = h // patch_size, w // patch_size
    x = images.to(dtype).reshape(b, h0, patch_size, w0, patch_size, c_in)
    x = torch.einsum("bipjqc,pqcd->bijd", x, params["patch_embed"]["w"].to(dtype))
    x = (x + params["patch_embed"]["b"].to(dtype)).reshape(b, h0 * w0, -1)
    cls = params["cls_token"].to(dtype).expand(b, 1, x.shape[-1])
    x = torch.cat([cls, x], dim=1)
    x = x + interpolate_pos_encoding(params["pos_embed"], h0, w0).to(dtype)
    for bp in params["blocks"]:
        x = block_apply(x, bp, num_heads, packed, tp)
    x = layernorm(params["norm"], x.float(), eps=1e-6)
    return x[:, 1:]


def vit_features_chw(params, images_nhwc: torch.Tensor, num_heads: int, patch_size: int = 14,
                     dtype: torch.dtype = torch.bfloat16, packed: bool = True, tp=None) -> torch.Tensor:
    """Patch tokens as a (B, H/14, W/14, C) fp32 feature map."""
    b, h, w, _ = images_nhwc.shape
    toks = vit_forward_features(params, images_nhwc, num_heads, patch_size, dtype, packed, tp)
    return toks.reshape(b, h // patch_size, w // patch_size, -1)
