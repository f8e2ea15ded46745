"""Attention for the frozen DINOv2 backbone, on its two layouts.

Counterparts of ``mickey_tpu/ops/flash_attention.py``:

``flash_attention_packed`` (K1): ``qkv`` is the fused qkv linear output,
(B, S, 3C) with its minor dim packed head-major as (H, 3, D) (the layout
``mickey_tpu``'s checkpoint converter writes); the result is head-concat
(B, S, C) for the proj linear.

``flash_attention`` (K1b): q, k, v of shape (B, H, S, D), keys at positions
>= ``seq_len`` masked; the result is (B, H, S, D). The kernel reads any
strides over (B, H, S), so the permuted views of the qkv output need no copy.

On a CUDA tensor each wrapper launches its hand-written kernel (both in
``csrc/flash_attention_packed.cu``, bf16, D = 64). On a CPU tensor it takes
the plain version, which upcasts to fp32 like ``attention_reference``. The
sequence is never padded: the kernel masks its ragged last key tile itself.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _cuda

NEG_INF = -1e30  # the TPU kernels' mask value


def qkv_heads(qkv: torch.Tensor, num_heads: int):
    """q, k, v (B, H, S, D): views, with no copy, of a head-major packed
    (B, S, 3C) qkv."""
    b, s, c3 = qkv.shape
    qkv5 = qkv.reshape(b, s, num_heads, 3, c3 // (3 * num_heads))
    return tuple(qkv5[:, :, :, i].transpose(1, 2) for i in range(3))


def attention_packed_plain(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Plain PyTorch version: fp32 softmax attention, output in qkv.dtype."""
    b, s, c3 = qkv.shape
    return attention_plain(*qkv_heads(qkv, num_heads), s).transpose(1, 2).reshape(b, s, c3 // 3)


def flash_attention_packed(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, S, 3C) head-major packed qkv -> (B, S, C) attention output."""
    if qkv.device.type == "cpu":
        return attention_packed_plain(qkv, num_heads)
    b, s, c3 = qkv.shape
    c = c3 // 3
    if c % num_heads or c // num_heads != 64:
        raise ValueError(f"flash_attention_packed: head dim must be 64, got C={c}, H={num_heads}")
    _cuda.require(qkv, "qkv", torch.bfloat16, (b, s, c3), qkv.device)
    if qkv.data_ptr() % 16:
        raise ValueError("flash_attention_packed: qkv must be 16-byte aligned (16-byte vector loads)")
    out = torch.empty((b, s, c), dtype=qkv.dtype, device=qkv.device)
    rc = _cuda.lib().mk_flash_attention_packed_bf16(
        qkv.data_ptr(), out.data_ptr(), b, s, num_heads, 1.0 / math.sqrt(64), _cuda.stream_ptr(qkv)
    )
    _cuda.check(rc, "flash_attention_packed")
    _cuda.LAUNCHES["flash_attention_packed"] += 1
    return out


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, seq_len: int) -> torch.Tensor:
    """Plain PyTorch version of ``flash_attention`` (``attention_reference``):
    fp32 softmax attention over the keys before ``seq_len``, output in q.dtype."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / math.sqrt(q.shape[-1]))
    masked = torch.arange(k.shape[2], device=q.device) >= seq_len
    logits = logits.masked_fill(masked, NEG_INF)
    return torch.matmul(torch.softmax(logits, dim=-1), v.float()).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, seq_len: int) -> torch.Tensor:
    """(B, H, S, D) q, k, v -> (B, H, S, D) attention output; keys at
    positions >= ``seq_len`` are masked."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, seq_len)
    b, h, s, d = q.shape
    if d != 64:
        raise ValueError(f"flash_attention: head dim must be 64, got {d}")
    if not 1 <= seq_len <= s:
        raise ValueError(f"flash_attention: seq_len {seq_len} outside [1, {s}]")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on {q.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash_attention: {name} must be bfloat16, got {t.dtype}")
        if tuple(t.shape) != (b, h, s, d):
            raise ValueError(f"flash_attention: {name} has shape {tuple(t.shape)}, q {(b, h, s, d)}")
        # 16-byte vector loads of each row
        if t.stride(3) != 1 or any(st % 8 for st in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} rows must be contiguous and 16-byte aligned, "
                             f"strides {t.stride()}")
    out = torch.empty((b, h, s, d), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 9)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    rc = _cuda.lib().mk_flash_attention_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides, b, h, s, seq_len,
        1.0 / math.sqrt(64), _cuda.stream_ptr(q),
    )
    _cuda.check(rc, "flash_attention")
    _cuda.LAUNCHES["flash_attention"] += 1
    return out
